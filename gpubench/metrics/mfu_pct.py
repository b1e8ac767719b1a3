"""``mfu_pct``: the whole step's share of the card's peak in the
configuration's precision: model FLOPs per sample (``flops.py``, the
reference model's forward under ``FlopCounterMode``, backward twice
forward, nothing recomputed) times the traced run's ``samples_per_s``
(the window's samples over its time by the host's clock), over
``peaks.FLOPS_PER_S``. It is ``samples_per_s`` rescaled against the data
sheet's peak, so its source is the host's clock."""


def read(ctx):
    if not ctx.samples_per_s or not ctx.flops_per_sample:
        return None
    return 100.0 * ctx.flops_per_sample * ctx.samples_per_s / ctx.peak_flops
