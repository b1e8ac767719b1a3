"""The distributed gradient step: flat gradient -> sparse allreduce.

Counterpart of the part of ``oktopk_tpu/optim/distributed.py`` that the
VGG-16 slice runs: ``flat_size``, ``bucket_partition`` and
``bucket_sizes`` (:58-99), per-bucket ``SparseState``, and the
flat-or-bucketed collective of ``build_sparse_grad_step`` (:299-387).
Not ported yet (ROADMAP.md): the anomaly guard, fault plans, quality
taps, momentum correction, gradient clipping, microbatch accumulation and
``profile_norm``.

The flat gradient [W, n] is laid out in the JAX package's leaf order and
layout (the trainer builds it), so that buckets, region boundaries and
selections are the same as the reference's. Buckets are contiguous leaf
ranges, so each bucket is a column slice of the flat buffer.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from oktopk_tpu_torch.collectives.registry import get_algorithm
from oktopk_tpu_torch.collectives.state import SparseState, init_state
from oktopk_tpu_torch.config import OkTopkConfig


def _sizes(leaves) -> List[int]:
    return [int(x) if isinstance(x, int) else int(x.numel()) for x in leaves]


def flat_size(leaves) -> int:
    """Total element count of a sequence of tensors (or sizes)."""
    return sum(_sizes(leaves))


def bucket_partition(leaves, num_buckets: int):
    """Contiguous leaf-index buckets in REVERSE leaf order, greedily
    balanced by element count (bucket 0 holds the last layers). Returns a
    list of ascending leaf-index lists."""
    sizes = _sizes(leaves)
    total = sum(sizes)
    L = len(sizes)
    num_buckets = max(1, min(num_buckets, L))
    target = total / num_buckets
    buckets, cur, acc = [], [], 0
    for pos, i in enumerate(reversed(range(L))):
        cur.append(i)
        acc += sizes[i]
        leaves_left = L - pos - 1
        still_needed = num_buckets - len(buckets) - 1
        if len(buckets) < num_buckets - 1 and (
                acc >= target - 1e-9 or leaves_left == still_needed):
            buckets.append(sorted(cur))
            cur, acc = [], 0
    buckets.append(sorted(cur))
    assert len(buckets) == num_buckets and all(buckets), buckets
    return buckets


def bucket_sizes(leaves, buckets) -> List[int]:
    sizes = _sizes(leaves)
    return [int(sum(sizes[i] for i in b)) for b in buckets]


class SparseGradStep:
    """One sparse collective per bucket over a flat [W, n] gradient.

    ``__call__(flat)`` returns the reduced flat gradient [n] (every worker
    holds the same result; row 0 is returned) and the step's metrics, and
    advances ``self.states`` (one ``SparseState`` per bucket)."""

    def __init__(self, cfg: OkTopkConfig, comm, leaves: Sequence,
                 compressor: str = "oktopk", num_buckets: int = 1,
                 warmup: bool = True, device="cpu"):
        self.cfg = cfg
        self.comm = comm
        self.algo = get_algorithm(compressor, warmup=warmup)
        self.buckets = bucket_partition(leaves, num_buckets)
        sizes = _sizes(leaves)
        offs = [0]
        for s in sizes:
            offs.append(offs[-1] + s)
        if offs[-1] != cfg.n:
            raise ValueError(f"cfg.n={cfg.n} != flat size {offs[-1]}")
        self.ranges = [(offs[b[0]], offs[b[-1] + 1]) for b in self.buckets]
        single = len(self.buckets) == 1
        self.cfgs = [cfg if single else cfg.replace(n=e - s, bucket_index=i)
                     for i, (s, e) in enumerate(self.ranges)]
        self.states: List[SparseState] = [
            init_state(c, comm.local_workers, device) for c in self.cfgs]

    def __call__(self, flat: torch.Tensor):
        reduced = torch.empty(flat.shape[1], dtype=flat.dtype,
                              device=flat.device)
        vol = wbytes = lk = gk = 0.0
        for bi, (s, e) in enumerate(self.ranges):
            g = flat if (s, e) == (0, flat.shape[1]) else flat[:, s:e]
            out, st = self.algo(g, self.states[bi], self.cfgs[bi], self.comm)
            reduced[s:e] = out[0]
            self.states[bi] = st
            # metrics of worker 0 (the JAX step returns them replicated)
            vol = vol + st.last_volume[0]
            wbytes = wbytes + st.last_wire_bytes[0]
            lk = lk + st.last_local_count[0].to(torch.float32)
            gk = gk + st.last_global_count[0].to(torch.float32)
        return reduced, {"comm_volume": vol, "wire_bytes": wbytes,
                         "local_k": lk, "global_k": gk}
