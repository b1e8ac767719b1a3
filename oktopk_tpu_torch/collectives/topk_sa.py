"""Split-allreduce baselines: topkSA ("topkDSA") and gaussiankSA.

Counterpart of ``oktopk_tpu/collectives/topk_sa.py:43-156``: oktopk's
phase (a) on the static equal regions of ``init_state`` (the compaction
kernel packs them), then a sparse allgather of each owner's nonzeros (the
compaction kernel at threshold 0) or, for topkSA when the reduced result
is at least ``sa_dense_fallback_ratio`` dense, a dense psum of the
disjoint regions, whose gather is not wire-rounded.

The JAX form chooses the branch with ``lax.cond`` on ``total_nnz``, a
value on the device, not the step counter. On the stacked comm the port
computes both branches and selects with ``torch.where`` (the
owner-rounding term as a 0/1 float32 tensor, as JAX does): one more
n-scale psum per step, which costs only a sum on one card, and no step
waits for the device. Across processes (``comm.branch_on_host``) that
psum would be an all_gather of (P-1)·n floats on every sparse step, so
the branch is taken on the host instead: ``total_nnz`` is an integer
psum, equal on every rank, so every rank takes the same branch, and
reading it costs one wait for phase (a). Both forms give the same bits.
"""

from __future__ import annotations

import torch

from oktopk_tpu_torch.collectives.state import SparseState, bump
from oktopk_tpu_torch.collectives.topk_allgather import (
    adapt_threshold,
    local_threshold,
)
from oktopk_tpu_torch.collectives.wire import (
    dense_wire_bytes,
    on_wire,
    pair_wire_bytes,
    residual_after_winners,
)
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.ops import compaction
from oktopk_tpu_torch.ops.gaussian import gaussian_threshold
from oktopk_tpu_torch.ops.select import scatter_rows


def _split_allreduce(acc, lt, state: SparseState, cfg: OkTopkConfig, comm,
                     dense_fallback: bool):
    """Threshold-select, all_to_all into the static regions, scatter-add,
    then the sparse allgather or the dense-fallback psum. Returns
    (result, residual, volume, wire bytes, local count, total nnz)."""
    P, n = cfg.num_workers, cfg.n
    step = state.host_step
    f32 = torch.float32
    rank = comm.rank(acc.device)
    mask = acc.abs() >= lt[:, None]
    local_count = mask.sum(1, dtype=torch.int32)
    s_vals, s_idx, s_counts = compaction.pack_rows(
        acc, lt, state.boundaries, P, cfg.cap_pair)
    r_vals = comm.all_to_all(on_wire(s_vals, cfg, step)).to(acc.dtype)
    r_idx = comm.all_to_all(s_idx)
    reduced = scatter_rows(n, r_vals, r_idx)

    sent_count = s_counts.sum(1, dtype=torch.int32)
    recv_count = (r_idx < n).sum((1, 2), dtype=torch.int32)
    own_count = s_counts.gather(1, rank.long()[:, None])[:, 0]
    vol_a = 2.0 * (sent_count - own_count) + 2.0 * (recv_count - own_count)
    total_nnz = comm.psum((reduced != 0.0).sum(1, dtype=torch.int32))
    dense = host_dense = None
    if dense_fallback:
        dense = total_nnz.to(f32) >= torch.full(
            (), cfg.sa_dense_fallback_ratio * n, dtype=f32,
            device=acc.device)
        if comm.branch_on_host:     # see the module docstring
            host_dense, dense = bool(dense[0]), None

    if host_dense:
        # dense fallback: a psum of the disjoint regions, not wire-rounded
        W = acc.shape[0]
        result = comm.psum(reduced)
        vol_b = torch.full((W,), 2.0 * n, dtype=f32, device=acc.device)
        wb_b = torch.full((W,), dense_wire_bytes(2.0 * n), dtype=f32,
                          device=acc.device)
        owner_scale = torch.zeros((W,), dtype=f32, device=acc.device)
    else:
        # sparse gather: each owner's nonzeros, allgathered
        gvals, gidx, gcount = compaction.select_nonzero_rows(reduced,
                                                             cfg.cap_local)
        gv = comm.all_gather(on_wire(gvals, cfg, step)).to(acc.dtype)
        result = scatter_rows(n, gv, comm.all_gather(gidx))
        total = comm.psum(gcount)
        vol_b = 2.0 * gcount + 2.0 * (total - gcount)
        wb_b = pair_wire_bytes(total, cfg)
        owner_scale = torch.ones_like(vol_b)
        if dense is not None:       # both branches, picked on the device
            result = torch.where(dense[:, None], comm.psum(reduced), result)
            vol_b = torch.where(dense, torch.full_like(vol_b, 2.0 * n),
                                vol_b)
            wb_b = torch.where(dense, torch.full_like(
                wb_b, dense_wire_bytes(2.0 * n)), wb_b)
            owner_scale = torch.where(dense, torch.zeros_like(owner_scale),
                                      owner_scale)

    result = result / P
    residual = residual_after_winners(acc, result != 0.0, mask, reduced,
                                      cfg, owner_scale=owner_scale[:, None])
    wb = pair_wire_bytes(0.5 * vol_a, cfg) + wb_b
    return result, residual, vol_a + vol_b, wb, local_count, total_nnz


def topk_sa(grad: torch.Tensor, state: SparseState, cfg: OkTopkConfig,
            comm):
    """topkSA / "topkDSA": predicted top-k threshold, static split
    allreduce, dense fallback."""
    acc = grad + state.residual
    lt = local_threshold(acc, state, cfg, cfg.k)
    result, residual, vol, wb, lc, gc = _split_allreduce(
        acc, lt, state, cfg, comm, dense_fallback=True)
    return result, bump(state, volume=vol, wire_bytes=wb, residual=residual,
                        local_threshold=adapt_threshold(lt, lc, cfg.k, cfg),
                        local_count=lc, global_count=gc)


def gaussian_k_sa(grad: torch.Tensor, state: SparseState,
                  cfg: OkTopkConfig, comm):
    """gaussiankSA: Gaussian per-step threshold, static split
    allreduce."""
    acc = grad + state.residual
    t = gaussian_threshold(acc, cfg.k, cfg.gaussian_refine_iters)
    result, residual, vol, wb, lc, gc = _split_allreduce(
        acc, t, state, cfg, comm, dense_fallback=False)
    return result, bump(state, volume=vol, wire_bytes=wb, residual=residual,
                        local_threshold=t, local_count=lc, global_count=gc)
