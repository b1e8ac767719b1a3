"""oktopk's combine phase: the Hopper kernels and their plain versions.

The kernels (``csrc/combine.cu``) replace no Pallas kernel: the JAX
package leaves this phase to XLA's scatter and elementwise ops. They do
oktopk's combine work in one pass each:

- ``scatter_rows``: [W, R, cap] (value, index) rows scatter-added into a
  contiguous [W, n], the sentinel n dropped. One memset, then one
  ``cb_scatter`` launch per source row, all W workers in it; rows are
  added in row (rank) order, so every sum is bit-equal to
  ``ops/select.py::scatter_rows`` (H2). The adds are the card's float
  atomics, as ``scatter_add_``'s are there: they flush subnormal sums to
  zero, which the plain version on the CPU does not.
- ``residual_after_winners``: the error-feedback residual after the
  global winners, from ``acc``, ``reduced``, ``result`` and the local
  thresholds ``lt`` in one ``cb_residual`` launch: the winner mask
  ``result != 0``, the sent mask ``|acc| >= lt`` (unclamped) and the bf16
  roundings stay in registers. Bit-equal to
  ``collectives/wire.py::residual_after_winners`` over those masks.

The plain versions are that composition. The wrappers take them only for
a tensor on the CPU; for a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from oktopk_tpu_torch.collectives import wire
from oktopk_tpu_torch.ops import _build, compaction
from oktopk_tpu_torch.ops import select as _select

# kernel launches: a scatter_rows call launches one per source row, a
# residual_after_winners call one
LAUNCHES = 0


# ---- plain versions --------------------------------------------------------

def scatter_rows_plain(n: int, values: torch.Tensor,
                       indices: torch.Tensor) -> torch.Tensor:
    """Per worker, scatter-add [W, R, cap] rows into [W, n] in row
    order; the sentinel n drops."""
    return _select.scatter_rows(n, values, indices)


def residual_after_winners_plain(acc: torch.Tensor, lt: torch.Tensor,
                                 reduced: torch.Tensor, result: torch.Tensor,
                                 cfg) -> torch.Tensor:
    """The residual: ``acc`` zeroed at the winners (``result != 0``);
    under the bf16 wire the rounding errors kept there, from the sent mask
    ``|acc| >= lt[w]``."""
    sent = (acc.abs() >= lt[:, None] if cfg.wire_dtype != "float32"
            else None)
    return wire.residual_after_winners(acc, result != 0.0, sent, reduced,
                                       cfg)


# ---- kernel wrappers -------------------------------------------------------

def _scatter_cuda(n, values, indices):
    global LAUNCHES
    dev = values.device
    W, R, cap = values.shape
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"n={n} does not fit the kernel's i32 indices")
    if values.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {values.dtype}")
    if indices.device != dev or indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32 on {dev}, got "
                        f"{indices.dtype} on {indices.device}")
    out = torch.empty((W, n), dtype=torch.float32, device=dev)
    lib = _build.library("combine")
    with torch.cuda.device(dev):
        rc = lib.oktopk_scatter_rows(
            _build.ptr(out), n, W, _build.ptr(values), _build.ptr(indices),
            R, cap, *values.stride(), *indices.stride(),
            _build.stream_handle(dev))
    _build.check(rc, "combine scatter kernel")
    if cap > 0:
        LAUNCHES += R
    return out


def scatter_rows(n: int, values: torch.Tensor,
                 indices: torch.Tensor) -> torch.Tensor:
    """Scatter-add ``values`` [W, R, cap] at ``indices`` [W, R, cap] into
    [W, n], one source row at a time in row order; the sentinel n drops.
    On the card the output is contiguous and the inputs may be strided
    views (the comm's transposes and broadcasts)."""
    if values.dim() != 3 or indices.shape != values.shape:
        raise ValueError(f"values {tuple(values.shape)} and indices "
                         f"{tuple(indices.shape)} must be equal [W, R, cap]")
    if values.device.type == "cpu":
        return scatter_rows_plain(n, values, indices)
    if values.device.type != "cuda":
        raise ValueError(f"no combine kernel for device {values.device}")
    return _scatter_cuda(n, values, indices)


def _residual_cuda(acc, lt, reduced, result, cfg):
    global LAUNCHES
    dev = acc.device
    W, n = acc.shape
    for name, t in (("acc", acc), ("lt", lt), ("reduced", reduced),
                    ("result", result)):
        compaction.check_f32(name, t, dev)
    out = torch.empty((W, n), dtype=torch.float32, device=dev)
    lib = _build.library("combine")
    with torch.cuda.device(dev):
        rc = lib.oktopk_residual(
            _build.ptr(acc), _build.ptr(result), _build.ptr(reduced),
            _build.ptr(lt), _build.ptr(out), n, W,
            int(cfg.wire_dtype != "float32"), _build.stream_handle(dev))
    _build.check(rc, "combine residual kernel")
    LAUNCHES += 1
    return out


def residual_after_winners(acc: torch.Tensor, lt: torch.Tensor,
                           reduced: torch.Tensor, result: torch.Tensor,
                           cfg) -> torch.Tensor:
    """oktopk's residual [W, n] after the global winners, under
    ``cfg.wire_dtype``: ``acc``, ``reduced`` (the owner's phase-(a) sums)
    and ``result`` [W, n], ``lt`` [W] the local thresholds the step sent
    at."""
    if (acc.dim() != 2 or reduced.shape != acc.shape
            or result.shape != acc.shape or lt.shape != acc.shape[:1]):
        raise ValueError(
            f"acc {tuple(acc.shape)}, reduced {tuple(reduced.shape)} and "
            f"result {tuple(result.shape)} must be equal [W, n], lt "
            f"{tuple(lt.shape)} [W]")
    if acc.device.type == "cpu":
        return residual_after_winners_plain(acc, lt, reduced, result, cfg)
    if acc.device.type != "cuda":
        raise ValueError(f"no combine kernel for device {acc.device}")
    return _residual_cuda(acc, lt, reduced, result, cfg)
