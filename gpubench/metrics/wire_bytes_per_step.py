"""``wire_bytes_per_step``: what one worker sends per step on the wire,
by the program's own counter (``wire_bytes`` of the exchange's step
metrics, worker 0's), summed over the traced run's window steps and
divided by their count. The correctness check holds the counter to the
reference's count in the compared steps."""


def read(ctx):
    return ctx.wire_bytes_per_step or None
