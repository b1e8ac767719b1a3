"""Per-bucket algorithm state, as a dataclass of tensors.

Counterpart of ``oktopk_tpu/collectives/state.py:21-118``. Every field
carries the leading worker dimension ``[W, ...]`` of the comm (see
``comm/stacked.py``). ``host_step`` mirrors ``step`` on the host: every
branch of the algorithms depends only on the step counter, so they branch
on this integer instead of reading the device (no sync per step).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oktopk_tpu_torch.config import OkTopkConfig

TENSOR_FIELDS = (
    "step", "local_threshold", "global_threshold", "drift", "last_exact_lt",
    "boundaries", "residual", "volume_elems", "last_volume", "wire_bytes",
    "last_wire_bytes", "wire_bytes_intra", "last_wire_bytes_intra",
    "wire_bytes_inter", "last_wire_bytes_inter", "last_local_count",
    "last_global_count")


@dataclasses.dataclass
class SparseState:
    step: torch.Tensor                # [W] i32 — allreduce counter
    local_threshold: torch.Tensor     # [W] f32
    global_threshold: torch.Tensor    # [W] f32
    drift: torch.Tensor               # [W] f32
    last_exact_lt: torch.Tensor       # [W] f32
    boundaries: torch.Tensor          # [W, P+1] i32 — region offsets
    residual: torch.Tensor            # [W, n] f32 — error feedback
    volume_elems: torch.Tensor        # [W] f32 — cumulative
    last_volume: torch.Tensor         # [W] f32
    wire_bytes: torch.Tensor          # [W] f32 — cumulative
    last_wire_bytes: torch.Tensor     # [W] f32
    wire_bytes_intra: torch.Tensor    # [W] f32 (two-level algorithms only)
    last_wire_bytes_intra: torch.Tensor
    wire_bytes_inter: torch.Tensor
    last_wire_bytes_inter: torch.Tensor
    last_local_count: torch.Tensor    # [W] i32
    last_global_count: torch.Tensor   # [W] i32
    host_step: int = 0                # host mirror of step

    def replace(self, **kw) -> "SparseState":
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).cpu().numpy() for f in TENSOR_FIELDS}

    @classmethod
    def from_numpy(cls, arrays, device) -> "SparseState":
        """From per-field arrays (a dict, or any object with the fields as
        attributes, e.g. the JAX state after ``np.asarray``)."""
        get = (arrays.__getitem__ if isinstance(arrays, dict)
               else lambda f: getattr(arrays, f))
        kw = {f: torch.from_numpy(np.array(get(f))).to(device)
              for f in TENSOR_FIELDS}
        return cls(**kw, host_step=int(kw["step"].reshape(-1)[0]))


def init_state(cfg: OkTopkConfig, num_local: int, device,
               dtype=torch.float32) -> SparseState:
    """Fresh state for ``num_local`` workers: the equal static region
    split and zero thresholds (the first step always recomputes)."""
    P, n, W = cfg.num_workers, cfg.n, num_local
    base, rem = divmod(n, P)
    sizes = [base + (1 if i < rem else 0) for i in range(P)]
    bnd = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                       dtype=torch.int32, device=device)

    def full(v, dt):
        return torch.full((W,), v, dtype=dt, device=device)

    f32 = torch.float32
    return SparseState(
        step=full(0, torch.int32),
        local_threshold=full(0.0, dtype),
        global_threshold=full(0.0, dtype),
        drift=full(1.0, dtype),
        last_exact_lt=full(0.0, dtype),
        boundaries=bnd.unsqueeze(0).repeat(W, 1),
        residual=torch.zeros((W, n), dtype=dtype, device=device),
        volume_elems=full(0.0, f32), last_volume=full(0.0, f32),
        wire_bytes=full(0.0, f32), last_wire_bytes=full(0.0, f32),
        wire_bytes_intra=full(0.0, f32), last_wire_bytes_intra=full(0.0, f32),
        wire_bytes_inter=full(0.0, f32), last_wire_bytes_inter=full(0.0, f32),
        last_local_count=full(0, torch.int32),
        last_global_count=full(0, torch.int32),
        host_step=0)


def _per_worker(v, like: torch.Tensor, dtype) -> torch.Tensor:
    """[W] tensor of ``v``: a Python number is filled on the device (no
    host-to-device copy), a [W] tensor is cast."""
    if not isinstance(v, torch.Tensor):
        return torch.full(like.shape, v, dtype=dtype, device=like.device)
    return v.to(dtype).expand(like.shape).clone()


def bump(state: SparseState, *, volume, wire_bytes=None, local_count=None,
         global_count=None, **updates) -> SparseState:
    """Advance the step counter (device and host) and record the step's
    accounting. Scalars broadcast to every worker."""
    f32 = torch.float32
    vol = _per_worker(volume, state.step, f32)
    wb = _per_worker(0.0 if wire_bytes is None else wire_bytes, state.step,
                     f32)
    kw = dict(
        step=state.step + 1,
        volume_elems=state.volume_elems + vol,
        last_volume=vol,
        wire_bytes=state.wire_bytes + wb,
        last_wire_bytes=wb,
        host_step=state.host_step + 1,
    )
    if local_count is not None:
        kw["last_local_count"] = _per_worker(local_count, state.step,
                                             torch.int32)
    if global_count is not None:
        kw["last_global_count"] = _per_worker(global_count, state.step,
                                              torch.int32)
    kw.update(updates)
    return state.replace(**kw)
