"""Dense allreduce baseline and the dense warmup wrapper.

Counterpart of ``oktopk_tpu/collectives/dense.py:22-50``. The JAX wrapper
branches with ``lax.cond`` on the device step counter; here the branch is
a Python ``if`` on the state's host mirror of it, so no step reads the
device. The pmean is the ``exchange`` phase (``obs/anatomy.py``), as in
JAX.
"""

from __future__ import annotations

from oktopk_tpu_torch.collectives.state import SparseState, bump
from oktopk_tpu_torch.collectives.wire import dense_wire_bytes
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.obs.anatomy import phase_scope


def dense_allreduce(grad, state: SparseState, cfg: OkTopkConfig, comm):
    """pmean over the workers (a ring allreduce moves ~2n per worker)."""
    with phase_scope("exchange", cfg.bucket_index):
        out = comm.pmean(grad)
    return out, bump(state, volume=2.0 * cfg.n,
                     wire_bytes=dense_wire_bytes(2.0 * cfg.n),
                     local_count=cfg.n, global_count=cfg.n)


def with_warmup(algo_fn):
    """Dense allreduce for the first ``cfg.warmup_steps`` steps, then
    ``algo_fn``."""

    def wrapped(grad, state: SparseState, cfg: OkTopkConfig, comm):
        if cfg.warmup_steps > 0 and state.host_step < cfg.warmup_steps:
            return dense_allreduce(grad, state, cfg, comm)
        return algo_fn(grad, state, cfg, comm)

    wrapped.__name__ = f"warmup({getattr(algo_fn, '__name__', 'algo')})"
    return wrapped
