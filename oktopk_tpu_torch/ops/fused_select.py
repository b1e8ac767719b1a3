"""Fused selection front-end: the Hopper kernel and its plain version.

Counterpart of ``oktopk_tpu/ops/fused_select.py``. The kernel
(``csrc/fused_select.cu``) replaces the TPU's ``_fused_kernel`` (K1, :64):
one sweep over (grad, residual) writes ``acc = grad + residual`` and
produces the survivor count of ``|acc| >= max(t, min_normal)`` (the
realised local count), the Newton probe count at the unclamped ``tp``,
and the 256-bin exponent histogram of the nonzero elements
(``ops/hist_threshold.py``). Region packing is a separate step
(``fused_pack_finalize``, the compaction kernel's one pass over ``acc``)
so that the caller can compute region boundaries from ``acc`` in
between.

``fused_select_plain`` is the counterpart of ``fused_select_reference``
(:276-296): the same outputs from separate plain passes. The wrapper
takes it only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. The sweep runs under the ``select`` phase scope and the
finalisation under ``stage`` (``obs/anatomy.py``), as JAX's (:204,
:251); inside a caller's scope of the same phase they open no range of
their own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from oktopk_tpu_torch.obs.anatomy import phase_scope
from oktopk_tpu_torch.ops import _build, compaction
from oktopk_tpu_torch.ops.hist_threshold import HIST_BINS, log2_hist

# kernel launches (one per call of the C entry point)
LAUNCHES = 0


class FusedStage(NamedTuple):
    """The sweep's outputs, plus what the region finalisation consumes."""
    acc: torch.Tensor           # [n] f32 — grad + residual
    local_count: torch.Tensor   # i32 — count(|acc| >= clamped t)
    probe_count: torch.Tensor   # i32 — count(|acc| >= tp)
    hist: torch.Tensor          # [HIST_BINS] i32 — log2_hist(acc)
    t: torch.Tensor             # 0-d f32: the threshold the stage used


def fused_select_plain(grad: torch.Tensor, residual: torch.Tensor, thresh,
                       probe_thresh) -> FusedStage:
    """The same outputs from separate plain passes."""
    acc = grad + residual
    t = compaction.threshold_tensor(thresh, acc)
    tp = compaction.threshold_tensor(probe_thresh, acc)
    abs_acc = acc.abs()
    mask = abs_acc >= compaction.clamp_min_normal(t)
    return FusedStage(
        acc=acc, local_count=mask.sum(dtype=torch.int32),
        probe_count=(abs_acc >= tp).sum(dtype=torch.int32),
        hist=log2_hist(acc), t=t)


def _fused_cuda(grad, residual, t, tp) -> FusedStage:
    global LAUNCHES
    dev = grad.device
    n = grad.numel()
    if n >= 2 ** 31:
        raise ValueError(f"n={n} does not fit the kernel's i32 indices")
    for name, a in (("grad", grad), ("residual", residual), ("thresh", t),
                    ("probe_thresh", tp)):
        compaction.check_f32(name, a, dev)
    acc = torch.empty((n,), dtype=torch.float32, device=dev)
    stats = torch.empty((2 + HIST_BINS,), dtype=torch.int32, device=dev)
    lib = _build.library("fused_select")
    with torch.cuda.device(dev):
        rc = lib.oktopk_fused_select(
            _build.ptr(grad), _build.ptr(residual), _build.ptr(acc), n,
            _build.ptr(t), _build.ptr(tp), _build.ptr(stats),
            _build.stream_handle(dev))
    _build.check(rc, "fused select kernel")
    LAUNCHES += 1
    return FusedStage(acc=acc, local_count=stats[0], probe_count=stats[1],
                      hist=stats[2:], t=t)


def fused_select_stage(grad: torch.Tensor, residual: torch.Tensor, thresh,
                       probe_thresh) -> FusedStage:
    """One sweep over 1-D (grad, residual): acc, local and probe counts,
    histogram."""
    if grad.dim() != 1 or grad.shape != residual.shape:
        raise ValueError(f"grad {tuple(grad.shape)} and residual "
                         f"{tuple(residual.shape)} must be equal 1-D")
    if grad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused select kernel for device {grad.device}")
    with phase_scope("select"):
        if grad.device.type == "cpu":
            return fused_select_plain(grad, residual, thresh, probe_thresh)
        return _fused_cuda(grad, residual,
                           compaction.threshold_tensor(thresh, grad),
                           compaction.threshold_tensor(probe_thresh, grad))


def fused_pack_finalize(st: FusedStage, boundaries: torch.Tensor,
                        num_regions: int, cap: int):
    """Per-region (values, indices, counts) of the stage's survivors."""
    with phase_scope("stage"):
        return compaction.pack_by_region(st.acc, st.t, boundaries,
                                         num_regions, cap)


def fused_select(grad, residual, thresh, probe_thresh, boundaries,
                 num_regions: int, cap: int):
    """One-call form (``fused_select_pallas``): ``(acc, values [R, cap],
    indices [R, cap], counts [R], local_count, probe_count, hist)``."""
    st = fused_select_stage(grad, residual, thresh, probe_thresh)
    values, indices, counts = fused_pack_finalize(st, boundaries,
                                                  num_regions, cap)
    return (st.acc, values, indices, counts, st.local_count,
            st.probe_count, st.hist)
