"""``fwd_bwd_ms``: forward and backward of every stacked worker, with the
flat-gradient copy: from the step's start to the exchange's, by the CUDA
events of ``trace.StepClock``, the mean over the traced run's window
steps."""


def read(ctx):
    if not ctx.steps:
        return None
    return sum(s["fwd_bwd_ms"] for s in ctx.steps) / len(ctx.steps)
