"""topkA family: allgather-based sparse allreduces.

Counterpart of ``oktopk_tpu/collectives/topk_allgather.py:36-124``:
``topk_a`` (exact local top-k, allgather of [P, k], scatter-add, mean),
``topk_a2`` (topkA, then the exact top-k of the reduced result) and
``topk_a_opt`` (a predicted local threshold, recomputed exactly on a
cadence, and a fixed-capacity allgather through the compaction kernel).

Every per-worker tensor carries the comm's leading worker dimension
``[W, ...]``; the JAX ``lax.cond`` on the step counter is a Python ``if``
on ``state.host_step``. Gathered rows are added in rank order
(``ops/select.py::scatter_rows``), as the JAX scatter adds on the CPU.
"""

from __future__ import annotations

import torch

from oktopk_tpu_torch.collectives.state import SparseState, bump
from oktopk_tpu_torch.collectives.wire import (
    on_wire,
    pair_wire_bytes,
    residual_after_selection,
)
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.ops import compaction
from oktopk_tpu_torch.ops.select import index_mask, scatter_rows
from oktopk_tpu_torch.ops.topk import exact_topk, k2threshold_method


def adapt_threshold(thresh, count, k: int, cfg: OkTopkConfig):
    """Multiplicative feedback toward the [band_lo*k, band_hi*k] count
    band (``_adapt_threshold``; topkSA applies the same rule). Counts,
    bounds and scales compare and multiply in float32, as in JAX."""
    c = count.to(torch.float32)
    scale = torch.where(c > cfg.band_hi * k, cfg.local_adapt_scale,
                        torch.where(c < cfg.band_lo * k,
                                    1.0 / cfg.local_adapt_scale, 1.0))
    return thresh * scale


def local_threshold(acc, state: SparseState, cfg: OkTopkConfig, k: int):
    """The exact k-th magnitude on the recompute cadence (and on the first
    sparse step), else the carried threshold."""
    step = state.host_step
    if step % cfg.local_recompute_every == 0 or step == cfg.warmup_steps:
        a = acc.abs()
        return torch.stack([
            k2threshold_method(a[w], k, cfg.threshold_method,
                               cfg.bisect_iters)
            for w in range(acc.shape[0])]).to(acc.dtype)
    return state.local_threshold


def gather_mean(vals, idx, cfg: OkTopkConfig, comm, step, dtype):
    """Allgather [W, m] (values, indices) and scatter-add them in rank
    order, divided by P."""
    gv = comm.all_gather(on_wire(vals, cfg, step)).to(dtype)
    gi = comm.all_gather(idx)
    return scatter_rows(cfg.n, gv, gi) / cfg.num_workers


def topk_a(grad: torch.Tensor, state: SparseState, cfg: OkTopkConfig, comm):
    """topkA: exact local top-k, allgather, scatter-add, mean."""
    P, n, k = cfg.num_workers, cfg.n, cfg.k
    acc = grad + state.residual
    vals, idx = exact_topk(acc, k)
    residual = residual_after_selection(acc, index_mask(n, idx), cfg)
    result = gather_mean(vals, idx, cfg, comm, state.host_step, acc.dtype)
    vol = 2.0 * k + 2.0 * k * (P - 1)
    return result, bump(state, volume=vol,
                        wire_bytes=pair_wire_bytes(1.0 * k * P, cfg),
                        residual=residual, local_count=k, global_count=k * P)


def topk_a2(grad: torch.Tensor, state: SparseState, cfg: OkTopkConfig,
            comm):
    """topkA2: topkA, then the exact top-k of the reduced result."""
    result, new_state = topk_a(grad, state, cfg, comm)
    vals, idx = exact_topk(result, cfg.k)
    return scatter_rows(cfg.n, vals[:, None], idx[:, None]), new_state


def topk_a_opt(grad: torch.Tensor, state: SparseState, cfg: OkTopkConfig,
               comm):
    """topkAopt: predicted local threshold, fixed-capacity allgather."""
    n, k = cfg.n, cfg.k
    acc = grad + state.residual
    lt = local_threshold(acc, state, cfg, k)
    vals, idx, count = compaction.select_rows(acc, lt, cfg.cap_local)
    residual = residual_after_selection(acc, index_mask(n, idx), cfg)
    result = gather_mean(vals, idx, cfg, comm, state.host_step, acc.dtype)
    total = comm.psum(count)
    return result, bump(state, volume=2.0 * total,
                        wire_bytes=pair_wire_bytes(total, cfg),
                        residual=residual,
                        local_threshold=adapt_threshold(lt, count, k, cfg),
                        local_count=count, global_count=total)
