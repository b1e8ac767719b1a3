"""``device_idle_pct``: the share of a steady step in which no kernel,
copy or set ran on the device. The device's busy seconds a step come
from the profiled steady steps (a trace of the device alone: kernel
times are the device's own); the step's length is the median period of
the traced run's window steps by their CUDA events
(``trace.StepClock``), start to next start, which no profiler
lengthens. (Under the profiler a host-paced step runs longer, so the
trace's own window would read the profiler's cost as idle time.)"""

import statistics


def read(ctx):
    periods = [s["period_ms"] for s in ctx.steps
               if s["period_ms"] is not None]
    if ctx.trace is None or not periods or not ctx.profiled_steps:
        return None
    busy_ms = 1e3 * ctx.trace["busy_s"] / len(ctx.profiled_steps)
    return 100.0 * (1.0 - busy_ms / statistics.median(periods))
