"""``collective_ms``: the gradient exchange, ``trainer.grad_step``, from
its call to its return, by the CUDA events of ``trace.StepClock``, the
mean over the traced run's window steps."""


def read(ctx):
    if not ctx.steps:
        return None
    return sum(s["collective_ms"] for s in ctx.steps) / len(ctx.steps)
