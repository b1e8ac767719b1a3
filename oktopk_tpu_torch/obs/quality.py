"""Compression-quality taps: per-bucket fidelity scalars on the device.

Counterpart of ``oktopk_tpu/obs/quality.py:55-166``. One step's scalars
(the ring columns of ``obs/metrics_buffer.py``), per worker row:

- ``comp_err``: ``|r - g|^2 / |g|^2`` of the delivered reduced gradient
  r against the pre-selection dense gradient ``g = pmean(grad +
  residual)``;
- ``res_norm``: the residual's 2-norm after the step; ``res_growth``: its
  ratio to the last committed norm;
- ``eff_density``: the nonzero share of the delivered vector;
- ``thr_drift``: the predicted local threshold over the last exact one;
- ``churn``: 1 - the overlap of this step's selected positions with the
  last committed step's, through a hashed presence signature
  (:func:`winner_signature`).

``collectives/api.py::build_quality_allreduce_step`` threads them through
an allreduce step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from oktopk_tpu_torch.obs.metrics_buffer import (
    COLUMNS,
    QualityBuffer,
    push_row,
)

_TINY = 1e-30

# Knuth's multiplicative hash constant (2^32 / phi)
_HASH_MULT = 2654435761


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """``every``: the flush cadence and the ring capacity; ``sig_bins``:
    the churn signature's size, a power of two."""
    every: int = 32
    sig_bins: int = 512

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        b = int(self.sig_bins)
        if b < 2 or (b & (b - 1)) != 0:
            raise ValueError(
                f"sig_bins must be a power of two >= 2, got {self.sig_bins}")


# the positions are counted in this many contiguous chunks, each with its
# own buckets, so that few atomic adds meet on one address
_SIG_CHUNKS = 1024


def winner_signature(reduced: torch.Tensor, sig_bins: int) -> torch.Tensor:
    """[W, n] -> [W, sig_bins] f32: 1 in every bucket that a selected
    (nonzero) position hashes into (JAX's max-scatter of the 0/1 mask).
    The hash is the JAX uint32 one, ``(i * 2654435761) mod 2^32 >> (32 -
    log2 sig_bins)``, in int64. Each of ``_SIG_CHUNKS`` contiguous chunks
    of positions counts its selected positions per bucket with atomic
    adds; a bucket is 1 where its chunks' counts add to more than 0,
    which no order of the adds changes. One max-scatter into the W x
    sig_bins buckets contends on them: 13.6 ms a step at VGG-16's n, P =
    4 (H100 80GB HBM3 at 700 W, ``scripts/port_profile.py --obs-ab``)."""
    W, n = reduced.shape
    shift = 32 - int(math.log2(sig_bins))
    i = torch.arange(n, dtype=torch.int64, device=reduced.device)
    h = ((i * _HASH_MULT) & 0xFFFFFFFF) >> shift
    chunk = -(-n // _SIG_CHUNKS)
    slot = torch.div(i, chunk, rounding_mode="floor") * sig_bins + h
    mask = (reduced != 0).to(torch.float32)
    counts = torch.zeros((W, _SIG_CHUNKS * sig_bins), dtype=torch.float32,
                         device=reduced.device)
    counts.scatter_add_(1, slot.expand(W, n), mask)
    return (counts.view(W, _SIG_CHUNKS, sig_bins).sum(1) > 0).to(
        torch.float32)


def measure_bucket(reduced: torch.Tensor, dense: torch.Tensor, sp_new,
                   prev_sig: torch.Tensor,
                   prev_res_norm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All fidelity scalars of one bucket and step, [W] each, plus the new
    signature under ``"sig"``. ``dense`` is the pre-selection dense
    gradient: the pmean of what each worker handed the compressor plus
    its residual."""
    f32 = torch.float32
    n = reduced.shape[1]
    reduced = reduced.to(f32)
    dense = dense.to(f32)
    comp_err = (((reduced - dense) ** 2).sum(1)
                / ((dense ** 2).sum(1) + _TINY))
    res_norm = torch.sqrt((sp_new.residual.to(f32) ** 2).sum(1))
    one = torch.ones_like(res_norm)
    res_growth = torch.where(prev_res_norm > 0,
                             res_norm / prev_res_norm.clamp_min(_TINY), one)
    eff_density = (reduced != 0).sum(1).to(f32) / float(n)
    lt = sp_new.local_threshold.to(f32)
    le = sp_new.last_exact_lt.to(f32)
    thr_drift = torch.where(le > 0, lt / le.clamp_min(_TINY), one)
    sig = winner_signature(reduced, prev_sig.shape[1])
    inter = torch.minimum(sig, prev_sig).sum(1)
    union = torch.maximum(sig, prev_sig).sum(1).clamp_min(1.0)
    churn = 1.0 - inter / union
    return {"comp_err": comp_err, "res_norm": res_norm,
            "res_growth": res_growth, "eff_density": eff_density,
            "thr_drift": thr_drift, "churn": churn, "sig": sig}


def commit(buf: QualityBuffer, step: torch.Tensor,
           scalars: Dict[str, torch.Tensor], skipped) -> QualityBuffer:
    """Push one measured step into the ring. ``step`` [W] is the bucket's
    ``SparseState.step`` after the step; ``skipped`` (a bool, or [W]) the
    guard flag, which freezes the baselines, never the push."""
    f32 = torch.float32
    skipped = torch.as_tensor(skipped, device=step.device).expand(
        step.shape)
    row = torch.stack([
        step.to(f32), scalars["comp_err"], scalars["res_norm"],
        scalars["res_growth"], scalars["eff_density"], scalars["thr_drift"],
        scalars["churn"], skipped.to(f32)], 1)
    return push_row(buf, row, scalars["sig"], scalars["res_norm"], skipped)


# ---- host-side flush helpers -----------------------------------------

def _sanitize(v: float) -> Optional[float]:
    v = float(v)
    return v if math.isfinite(v) else None


def quality_event(step: int, bucket: int, algo: str,
                  rows) -> Dict[str, Any]:
    """A ``quality`` event payload from drained ring rows
    (``metrics_buffer.rows_since``); non-finite samples become None."""
    ev: Dict[str, Any] = {"step": int(step), "bucket": int(bucket),
                          "algo": str(algo), "count": int(len(rows))}
    cols: Dict[str, List[Any]] = {c: [] for c in COLUMNS}
    for row in rows:
        for c, v in zip(COLUMNS, row):
            if c == "step":
                cols[c].append(int(v))
            elif c == "skipped":
                cols[c].append(int(v > 0.5))
            else:
                cols[c].append(_sanitize(v))
    ev["steps"] = cols.pop("step")
    ev.update(cols)
    return ev
