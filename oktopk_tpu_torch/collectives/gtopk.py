"""gTop-k: a symmetric XOR butterfly that merges top-k lists.

Counterpart of ``oktopk_tpu/collectives/gtopk.py:37-86``. Each of the
log2(P) rounds exchanges the worker's k (value, index) pairs with the
partner at XOR distance d (``StackedComm.ppermute_pair``); both sides add
the two lists into a dense staging vector and keep its exact top-k, so
every worker ends with the same list. Each worker rounds its own values
through the wire format before the exchange, so both partners merge the
same numbers. Originally selected values that lose a merge go back into
the error-feedback residual. P must be a power of two.

The merged sums hold many ties from round 2 on (bf16-rounded sums);
``exact_topk`` breaks them by lower index, as ``lax.top_k`` does, so the
card and the CPU keep the same winners.
"""

from __future__ import annotations

import torch

from oktopk_tpu_torch.collectives.state import SparseState, bump
from oktopk_tpu_torch.collectives.wire import (
    on_wire,
    pair_wire_bytes,
    residual_after_selection,
    wire_round,
)
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.ops.select import index_mask, scatter_rows
from oktopk_tpu_torch.ops.topk import exact_topk


def gtopk(grad: torch.Tensor, state: SparseState, cfg: OkTopkConfig, comm):
    P, n, k = cfg.num_workers, cfg.n, cfg.k
    if P & (P - 1):
        raise ValueError(f"gtopk requires power-of-two workers, got {P}")
    step = state.host_step
    acc = grad + state.residual
    vals, idx = exact_topk(acc, k)
    sel_mask = index_mask(n, idx)
    residual = residual_after_selection(acc, sel_mask, cfg)

    rounds = P.bit_length() - 1
    d = 1
    for _ in range(rounds):
        vals = wire_round(vals, cfg)
        pv = comm.ppermute_pair(on_wire(vals, cfg, step), d).to(acc.dtype)
        pi = comm.ppermute_pair(idx, d)
        merged = scatter_rows(n, torch.stack([vals, pv], 1),
                              torch.stack([idx, pi], 1))
        vals, idx = exact_topk(merged, k)
        d <<= 1

    lost = sel_mask & ~index_mask(n, idx)
    residual = torch.where(lost, acc, residual)
    result = scatter_rows(n, vals[:, None], idx[:, None]) / P
    return result, bump(state, volume=4.0 * k * rounds,
                        wire_bytes=pair_wire_bytes(2.0 * k * rounds, cfg),
                        residual=residual, local_count=k, global_count=k)
