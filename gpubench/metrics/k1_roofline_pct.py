"""``k1_roofline_pct``: the fused select sweep (``ops/fused_select.py``,
``csrc/fused_select.cu``: the kernels ``fs_zero`` and ``fs_sweep``)
against its bytes over the card's HBM rate (``kernels.k1_bytes``: grad
and residual read, acc written, once each), by the profiler's device
time over the profiled steps. Nothing where the trace holds other than
one sweep a worker a step: the path has changed."""

from gpubench import kernels, peaks, trace
from gpubench.reference.exchange_oktopk import SparseConfig


def read(ctx):
    if ctx.trace is None or not isinstance(ctx.exchange, SparseConfig):
        return None
    secs, count = trace.kernel_time(ctx.trace, ("fs_zero", "fs_sweep"))
    calls = ctx.exchange.workers * len(ctx.profiled_steps)
    if secs <= 0 or count.get("fs_sweep") != calls:
        return None
    moved = sum(sum(kernels.oktopk_calls(ctx.exchange, s)[0])
                for s in ctx.profiled_steps) * ctx.exchange.workers
    return 100.0 * moved / peaks.HBM_BYTES_PER_S / secs
