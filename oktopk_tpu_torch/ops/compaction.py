"""Threshold stream compaction: the Hopper kernel and its plain version.

Counterpart of ``oktopk_tpu/ops/compaction.py``: ``select_by_threshold``
(``select_by_threshold_pallas`` :435), ``select_nonzero`` (the same at
threshold 0, ``ops/select.py:389-401`` with ``use_pallas``) and
``pack_by_region`` (``pack_by_region_pallas`` :506). The kernel (``csrc/compaction.cu``)
replaces the TPU's staging kernel K2 (``_stage_kernel`` :160), its
overflow repair kernel K3 (``_repair_kernel`` :229) and their cap-scale
XLA post-processing: one pass over x with a decoupled look-back scan,
each survivor writing its own output slot, so no tile can overflow a
staging row.

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

TILE = 4096            # elements per block of the kernel's pass
MAX_REGIONS = 64
MIN_NORMAL = 1.17549435e-38

# calls of the C entry point (each launches the prefill and the pass)
LAUNCHES = 0


def tile_geometry(n: int, addr: int) -> tuple[int, int]:
    """``(shift, tiles)`` of the kernel's grid over ``n`` float32 at
    device address ``addr``: tiles are cut on 16-byte boundaries of
    memory, so ``x[0]`` sits ``shift`` elements into the first tile."""
    shift = (addr // 4) % 4
    return shift, -(-(n + shift) // TILE)


def scratch_words(n: int, addr: int, num_regions: int) -> int:
    """64-bit words of kernel scratch: a tile ticket, one flagged
    offset per region boundary, one look-back status word per tile."""
    return 2 + num_regions + tile_geometry(n, addr)[1]


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


def select_nonzero_plain(x: torch.Tensor, cap: int):
    """(values[cap], indices[cap], count) of |x| >= the smallest normal
    f32: the nonzeros, subnormals left out."""
    return select_by_threshold_plain(x, 0.0, cap)


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


def _compact_cuda(x, t, boundaries, R, cap):
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
    if boundaries is not None:
        if (boundaries.device != dev or boundaries.dtype != torch.int32
                or boundaries.numel() != R + 1
                or not boundaries.is_contiguous()):
            raise ValueError("boundaries must be a contiguous i32 [R+1] "
                             f"tensor on {dev}")
    values = torch.empty((R, cap), dtype=torch.float32, device=dev)
    indices = torch.empty((R, cap), dtype=torch.int32, device=dev)
    counts = torch.empty((R,), dtype=torch.int32, device=dev)
    words = scratch_words(n, x.data_ptr(), R)
    scratch = torch.empty((words,), dtype=torch.int64, device=dev)
    lib = _build.library("compaction")
    with torch.cuda.device(dev):
        rc = lib.oktopk_compact(
            _build.ptr(x), n, _build.ptr(t), _build.ptr(boundaries), R, cap,
            _build.ptr(scratch), words, _build.ptr(values),
            _build.ptr(indices), _build.ptr(counts),
            _build.stream_handle(dev))
    _build.check(rc, "compaction kernel")
    LAUNCHES += 1
    return values, indices, counts


def pack_by_region(x: torch.Tensor, thresh, boundaries: torch.Tensor,
                   num_regions: int, cap: int):
    """Per-region fixed-capacity pack of |x| >= clamped thresh.

    ``boundaries``: i32 [num_regions + 1] spanning exactly [0, n]."""
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pack_by_region_plain(x, thresh, boundaries, num_regions, cap)
    if x.device.type != "cuda":
        raise ValueError(f"no compaction kernel for device {x.device}")
    return _compact_cuda(x, threshold_tensor(thresh, x), boundaries,
                         num_regions, cap)


def select_by_threshold(x: torch.Tensor, thresh, cap: int):
    """(values[cap], indices[cap], count) of |x| >= clamped thresh over the
    whole of ``x``."""
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return select_by_threshold_plain(x, thresh, cap)
    if x.device.type != "cuda":
        raise ValueError(f"no compaction kernel for device {x.device}")
    v, i, c = _compact_cuda(x, threshold_tensor(thresh, x), None, 1, cap)
    return v[0], i[0], c[0]


def select_nonzero(x: torch.Tensor, cap: int):
    """The nonzeros of ``x`` (the kernel at threshold 0, which it clamps to
    the smallest normal f32, so subnormals are not selected)."""
    return select_by_threshold(x, 0.0, cap)


# ---- per-worker rows -------------------------------------------------------

def _row(thresh, w: int):
    return thresh[w] if isinstance(thresh, torch.Tensor) else thresh


def _stack(rows):
    return tuple(torch.stack(col) for col in zip(*rows))


def select_rows(x: torch.Tensor, thresh, cap: int):
    """``select_by_threshold`` of each row of ``x`` [W, n] at its entry of
    ``thresh`` ([W] tensor, or one number): ([W, cap], [W, cap], [W])."""
    return _stack(select_by_threshold(x[w], _row(thresh, w), cap)
                  for w in range(x.shape[0]))


def select_nonzero_rows(x: torch.Tensor, cap: int):
    """``select_nonzero`` of each row of ``x`` [W, n]."""
    return _stack(select_nonzero(x[w], cap) for w in range(x.shape[0]))


def pack_rows(x: torch.Tensor, thresh, boundaries: torch.Tensor,
              num_regions: int, cap: int):
    """``pack_by_region`` of each row of ``x`` [W, n] with its row of
    ``boundaries`` [W, R+1]: ([W, R, cap], [W, R, cap], [W, R])."""
    return _stack(pack_by_region(x[w], _row(thresh, w), boundaries[w],
                                 num_regions, cap)
                  for w in range(x.shape[0]))
