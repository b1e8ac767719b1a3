"""gaussiank: a Gaussian-fit threshold every step, fixed-capacity
allgather.

Counterpart of ``oktopk_tpu/collectives/gaussiank.py:32-60``. The
threshold comes from ``ops/gaussian.py`` (a normal fit and a bounded
bisection, no sort); the selection goes through the compaction kernel at
``cap_local``. The phase scopes (``obs/anatomy.py``) are JAX's: the
threshold under ``select``, the selection and residual under ``stage``,
the gather under ``exchange``, the scatter under ``combine``.
``gaussiankconcat`` differs from it only in the
reference's wire layout, so the registry maps both names here.
"""

from __future__ import annotations

import torch

from oktopk_tpu_torch.collectives.state import SparseState, bump
from oktopk_tpu_torch.collectives.topk_allgather import gather_mean
from oktopk_tpu_torch.collectives.wire import (
    pair_wire_bytes,
    residual_after_selection,
)
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.obs.anatomy import phase_scope
from oktopk_tpu_torch.ops import compaction
from oktopk_tpu_torch.ops.gaussian import gaussian_threshold
from oktopk_tpu_torch.ops.select import index_mask


def gaussian_k(grad: torch.Tensor, state: SparseState, cfg: OkTopkConfig,
               comm):
    bkt = cfg.bucket_index
    with phase_scope("select", bkt):
        acc = grad + state.residual
        t = gaussian_threshold(acc, cfg.k, cfg.gaussian_refine_iters)
    with phase_scope("stage", bkt):
        vals, idx, count = compaction.select_rows(acc, t, cfg.cap_local)
        residual = residual_after_selection(acc, index_mask(cfg.n, idx),
                                            cfg)
    result = gather_mean(vals, idx, cfg, comm, state.host_step, acc.dtype)
    total = comm.psum(count)
    return result, bump(state, volume=2.0 * total,
                        wire_bytes=pair_wire_bytes(total, cfg),
                        residual=residual, local_threshold=t,
                        local_count=count, global_count=total)
