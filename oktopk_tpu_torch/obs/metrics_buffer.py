"""Device-side metric ring for the quality taps.

Counterpart of ``oktopk_tpu/obs/metrics_buffer.py:34-92``. Each bucket
owns a :class:`QualityBuffer`, a fixed-capacity f32 ring on the device
that a step pushes one row into, so a step adds no host transfer; the
host drains the rows on its own cadence with :func:`rows_since`. Every
field carries the comm's leading worker dimension ``[W, ...]``.

The cursor is monotonic (total pushes); the ring slot is ``cursor %
capacity``. Rows are pushed unconditionally, guard-skipped steps
included (the ``skipped`` column marks them); only the step-over-step
baselines (``prev_res_norm``, ``prev_sig``) freeze across a skip.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ring columns, in order
COLUMNS = ("step", "comp_err", "res_norm", "res_growth", "eff_density",
           "thr_drift", "churn", "skipped")
NUM_COLS = len(COLUMNS)
FIELDS = ("ring", "cursor", "prev_res_norm", "prev_sig")


@dataclasses.dataclass
class QualityBuffer:
    """Per-bucket fidelity ring and step-over-step baselines."""
    ring: torch.Tensor           # [W, capacity, NUM_COLS] f32
    cursor: torch.Tensor         # [W] i32, monotonic push count
    prev_res_norm: torch.Tensor  # [W] f32, last committed residual norm
    prev_sig: torch.Tensor       # [W, sig_bins] f32, last committed sig

    def replace(self, **kw) -> "QualityBuffer":
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).cpu().numpy() for f in FIELDS}

    @classmethod
    def from_numpy(cls, arrays, device) -> "QualityBuffer":
        """From per-field arrays (a dict, or any object with the fields as
        attributes, e.g. the JAX buffer after ``device_get``)."""
        get = (arrays.__getitem__ if isinstance(arrays, dict)
               else lambda f: getattr(arrays, f))
        return cls(**{f: torch.from_numpy(np.array(get(f))).to(device)
                      for f in FIELDS})


def init_buffer(capacity: int, sig_bins: int, num_local: int, device,
                dtype=torch.float32) -> QualityBuffer:
    """An empty ring for ``num_local`` workers."""
    capacity, W = max(1, int(capacity)), int(num_local)
    return QualityBuffer(
        ring=torch.zeros((W, capacity, NUM_COLS), dtype=dtype,
                         device=device),
        cursor=torch.zeros((W,), dtype=torch.int32, device=device),
        prev_res_norm=torch.zeros((W,), dtype=dtype, device=device),
        prev_sig=torch.zeros((W, int(sig_bins)), dtype=dtype,
                             device=device))


def push_row(buf: QualityBuffer, row: torch.Tensor, sig: torch.Tensor,
             res_norm: torch.Tensor, skipped: torch.Tensor) -> QualityBuffer:
    """Append one row per worker (``row`` [W, NUM_COLS]). ``skipped`` [W]
    freezes the baselines but never the ring."""
    W, cap = buf.ring.shape[:2]
    idx = torch.remainder(buf.cursor, cap).long()
    ring = buf.ring.clone()
    ring[torch.arange(W, device=ring.device), idx] = row.to(ring.dtype)
    keep = skipped.to(torch.bool).expand(W)
    return buf.replace(
        ring=ring, cursor=buf.cursor + 1,
        prev_res_norm=torch.where(keep, buf.prev_res_norm,
                                  res_norm.to(buf.prev_res_norm.dtype)),
        prev_sig=torch.where(keep[:, None], buf.prev_sig,
                             sig.to(buf.prev_sig.dtype)))


def rows_since(ring: np.ndarray, cursor: int, prev_cursor: int) -> np.ndarray:
    """Host-side drain: the rows pushed in ``(prev_cursor, cursor]``,
    oldest first. A ring with a leading worker axis ([W, cap, C]) has its
    worker rows averaged."""
    ring = np.asarray(ring, np.float64)
    if ring.ndim == 3:
        ring = ring.mean(axis=0)
    cap = ring.shape[0]
    count = min(int(cursor) - int(prev_cursor), cap)
    if count <= 0:
        return np.zeros((0, ring.shape[1]), np.float64)
    idx = [(int(cursor) - count + i) % cap for i in range(count)]
    return ring[idx]
