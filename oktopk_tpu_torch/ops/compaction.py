"""Threshold stream compaction: the Hopper kernel and its plain version.

Counterpart of ``oktopk_tpu/ops/compaction.py``: ``select_by_threshold``
(``select_by_threshold_pallas`` :435) and ``pack_by_region``
(``pack_by_region_pallas`` :506). The kernel (``csrc/compaction.cu``)
replaces the TPU's staging kernel K2 (``_stage_kernel`` :160), its
overflow repair kernel K3 (``_repair_kernel`` :229) and their cap-scale
XLA post-processing: each survivor writes its own output slot, so no tile
can overflow a staging row.

Contract (the JAX ``use_pallas=True`` one): survivors are
``|x| >= max(thresh, 1.17549435e-38)``; ascending index order;
lowest-index-first retention past ``cap``; empty slots hold value 0 and
index n; counts are clipped to cap.

The wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from oktopk_tpu_torch.ops import _build
from oktopk_tpu_torch.ops.select import pack_by_region as _pack_portable
from oktopk_tpu_torch.ops.select import select_mask

TILE = 1024
MAX_REGIONS = 64
MIN_NORMAL = 1.17549435e-38

# kernel launches (one per call of the C entry point)
LAUNCHES = 0


def num_tiles(n: int) -> int:
    return -(-n // TILE)


def threshold_tensor(thresh, x: torch.Tensor) -> torch.Tensor:
    """A threshold as a 0-d tensor on ``x``'s device: a tensor (e.g. one
    worker's entry of a [W] threshold vector, a view) is passed through,
    a Python number is filled on the device."""
    if isinstance(thresh, torch.Tensor):
        return thresh.to(dtype=x.dtype).reshape(())
    return torch.full((), float(thresh), dtype=x.dtype, device=x.device)


def clamp_min_normal(t: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(t, min_normal)``: NaN stays NaN."""
    mn = torch.full((), MIN_NORMAL, dtype=t.dtype, device=t.device)
    return torch.where(t < mn, mn, t)


# ---- plain versions --------------------------------------------------------

def select_by_threshold_plain(x: torch.Tensor, thresh, cap: int):
    """(values[cap], indices[cap], count) of |x| >= clamped thresh."""
    t = clamp_min_normal(threshold_tensor(thresh, x))
    return select_mask(x, x.abs() >= t, cap)


def pack_by_region_plain(x: torch.Tensor, thresh, boundaries: torch.Tensor,
                         num_regions: int, cap: int):
    """([R, cap], [R, cap], counts[R]) of |x| >= clamped thresh."""
    t = clamp_min_normal(threshold_tensor(thresh, x))
    return _pack_portable(x, x.abs() >= t, boundaries, num_regions, cap)


# ---- kernel wrapper --------------------------------------------------------

def check_f32(name: str, t: torch.Tensor, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _compact_cuda(x, t, boundaries, R, cap, tile_counts):
    global LAUNCHES
    dev = x.device
    n = x.numel()
    if not (1 <= R <= MAX_REGIONS):
        raise ValueError(f"num_regions must be in [1, {MAX_REGIONS}], "
                         f"got {R}")
    if n >= 2 ** 31:
        raise ValueError(f"n={n} does not fit the kernel's i32 indices")
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    check_f32("x", x, dev)
    check_f32("thresh", t, dev)
    nt = num_tiles(n)
    if boundaries is not None:
        if (boundaries.device != dev or boundaries.dtype != torch.int32
                or boundaries.numel() != R + 1
                or not boundaries.is_contiguous()):
            raise ValueError("boundaries must be a contiguous i32 [R+1] "
                             f"tensor on {dev}")
    if tile_counts is not None:
        if (tile_counts.device != dev or tile_counts.dtype != torch.int32
                or tile_counts.numel() != nt
                or not tile_counts.is_contiguous()):
            raise ValueError(f"tile_counts must be a contiguous i32 [{nt}] "
                             f"tensor on {dev}")
    values = torch.empty((R, cap), dtype=torch.float32, device=dev)
    indices = torch.empty((R, cap), dtype=torch.int32, device=dev)
    counts = torch.empty((R,), dtype=torch.int32, device=dev)
    scratch = torch.empty((2 * nt + 1 + R + 1,), dtype=torch.int32,
                          device=dev)
    own_counts = scratch[:nt]
    excl = scratch[nt:2 * nt + 1]
    before = scratch[2 * nt + 1:]
    lib = _build.library("compaction")
    with torch.cuda.device(dev):
        rc = lib.oktopk_compact(
            _build.ptr(x), n, _build.ptr(t), _build.ptr(boundaries), R, cap,
            _build.ptr(tile_counts), _build.ptr(own_counts),
            _build.ptr(excl), _build.ptr(before), _build.ptr(values),
            _build.ptr(indices), _build.ptr(counts),
            _build.stream_handle(dev))
    _build.check(rc, "compaction kernel")
    LAUNCHES += 1
    return values, indices, counts


def pack_by_region(x: torch.Tensor, thresh, boundaries: torch.Tensor,
                   num_regions: int, cap: int,
                   tile_counts: torch.Tensor | None = None):
    """Per-region fixed-capacity pack of |x| >= clamped thresh.

    ``boundaries``: i32 [num_regions + 1] spanning exactly [0, n].
    ``tile_counts``: the fused kernel's survivors per 1024-element tile of
    ``x`` at the same threshold (the kernel then skips its count pass); the
    plain version does not need them."""
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pack_by_region_plain(x, thresh, boundaries, num_regions, cap)
    if x.device.type != "cuda":
        raise ValueError(f"no compaction kernel for device {x.device}")
    return _compact_cuda(x, threshold_tensor(thresh, x), boundaries,
                         num_regions, cap, tile_counts)


def select_by_threshold(x: torch.Tensor, thresh, cap: int):
    """(values[cap], indices[cap], count) of |x| >= clamped thresh over the
    whole of ``x``."""
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return select_by_threshold_plain(x, thresh, cap)
    if x.device.type != "cuda":
        raise ValueError(f"no compaction kernel for device {x.device}")
    v, i, c = _compact_cuda(x, threshold_tensor(thresh, x), None, 1, cap,
                            None)
    return v[0], i[0], c[0]
