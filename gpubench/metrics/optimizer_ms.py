"""``optimizer_ms``: the optimizer's update: from the exchange's end to the
step's, by the CUDA events of ``trace.StepClock``, the mean over the
traced run's window steps."""


def read(ctx):
    if not ctx.steps:
        return None
    return sum(s["optimizer_ms"] for s in ctx.steps) / len(ctx.steps)
