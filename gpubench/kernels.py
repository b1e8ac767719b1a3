"""The bytes each sparse-path kernel call must move, from its shapes.

Each input is read once and each output written once, whatever the
kernel reads again:
- the fused select sweep (K1): grad and residual read, acc written, n
  float32 each; the two thresholds read; the two counts and the
  256-bin histogram written;
- the compaction: x (n float32) and the threshold read, and the R + 1
  region boundaries where it packs by region; values and indices
  [R, cap] and the R counts written.

The calls of one oktopk step of each worker: one K1 sweep; one pack by
region (R = P, cap ``cap_pair``); one whole-vector select (R = 1, cap
``cap_exact`` on a global recompute step, else ``cap_gather``).
"""

from __future__ import annotations

from typing import List, Tuple

HIST_BINS = 256


def k1_bytes(n: int) -> int:
    return 12 * n + 8 + 4 * (2 + HIST_BINS)


def compaction_bytes(n: int, R: int, cap: int, bounds: bool) -> int:
    read = 4 * n + 4 + (4 * (R + 1) if bounds else 0)
    return read + 8 * R * cap + 4 * R


def oktopk_calls(sparse, host_step: int) -> Tuple[List[int], List[int]]:
    """(K1 bytes, compaction bytes) of each call one worker makes in the
    step with the allreduce counter ``host_step`` (``sparse`` a
    ``reference.exchange_oktopk.SparseConfig``)."""
    n, P = sparse.n, sparse.workers
    first = host_step == sparse.warmup_steps
    exact = host_step % sparse.global_recompute_every == 0 or first
    select_cap = min(sparse.cap_exact, n) if exact else sparse.cap_gather
    return ([k1_bytes(n)],
            [compaction_bytes(n, P, sparse.cap_pair, True),
             compaction_bytes(n, 1, select_cap, False)])
