"""``compaction_roofline_pct``: the threshold compaction
(``ops/compaction.py``, ``csrc/compaction.cu``: the kernels
``cp_prefill`` and ``cp_compact``), a pack by region and a whole-vector
select a worker a step, against their bytes over the card's HBM rate
(``kernels.compaction_bytes``), by the profiler's device time over the
profiled steps. Nothing where the trace holds another number of calls."""

from gpubench import kernels, peaks, trace
from gpubench.reference.exchange_oktopk import SparseConfig


def read(ctx):
    if ctx.trace is None or not isinstance(ctx.exchange, SparseConfig):
        return None
    secs, count = trace.kernel_time(ctx.trace, ("cp_prefill", "cp_compact"))
    calls = 2 * ctx.exchange.workers * len(ctx.profiled_steps)
    if secs <= 0 or count.get("cp_compact") != calls:
        return None
    moved = sum(sum(kernels.oktopk_calls(ctx.exchange, s)[1])
                for s in ctx.profiled_steps) * ctx.exchange.workers
    return 100.0 * moved / peaks.HBM_BYTES_PER_S / secs
