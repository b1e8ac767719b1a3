"""Fixed-capacity sparse selection and packing, in plain PyTorch.

Counterpart of ``oktopk_tpu/ops/select.py:25-159``. Every variable-length
(index, value) list becomes a static-shape ``(values[cap], indices[cap],
count)`` triple: elements in ascending index order, overflow past ``cap``
dropped lowest-index-first, empty slots holding value 0 and the sentinel
index ``n`` (== the source length), which every scatter drops.

These are the portable forms: a full-length cumsum and a scatter. The
threshold selections of the oktopk hot path go through the compaction
kernel instead (``ops/compaction.py``), whose plain version is built from
the functions here.
"""

from __future__ import annotations

import torch


def count_by_threshold(x: torch.Tensor, thresh) -> torch.Tensor:
    """Number of elements with |x| >= thresh."""
    return (x.abs() >= thresh).sum()


def select_mask(x: torch.Tensor, mask: torch.Tensor, cap: int):
    """Pack elements of the 1-D ``x`` where ``mask`` holds into
    ``(values[cap], indices[cap] i32, count i32)``."""
    n = x.numel()
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    pos = torch.where(mask & (pos < cap), pos, cap)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    values = torch.zeros(cap + 1, dtype=x.dtype, device=x.device)
    values.scatter_(0, pos, torch.where(mask, x, zero))
    indices = torch.full((cap + 1,), n, dtype=torch.int32, device=x.device)
    indices.scatter_(0, pos, torch.arange(n, dtype=torch.int32,
                                          device=x.device))
    count = torch.clamp(mask.sum(dtype=torch.int32), max=cap)
    return values[:cap], indices[:cap], count


def select_by_threshold(x: torch.Tensor, thresh, cap: int):
    """Pack ``|x| >= thresh`` (portable form, no threshold clamp)."""
    return select_mask(x, x.abs() >= thresh, cap)


def select_nonzero(x: torch.Tensor, cap: int):
    """Pack the nonzeros of ``x``."""
    return select_mask(x, x != 0.0, cap)


def scatter_sparse(n: int, values: torch.Tensor, indices: torch.Tensor,
                   base: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter-add (values, indices) into a dense length-n vector; the
    sentinel index n drops. Updates are added in row-major order of
    ``values`` (leading batch dims first), as the JAX scatter does on the
    CPU; within one row the indices are distinct, so the per-row adds
    need no ordering of their own."""
    buf = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    if base is not None:
        buf[:n] = base
    v = values.reshape(-1, values.shape[-1]) if values.dim() else values
    i = indices.reshape(-1, indices.shape[-1]) if indices.dim() else indices
    for r in range(v.shape[0]):
        buf.index_add_(0, i[r].long(), v[r])
    return buf[:n]


def scatter_rows(n: int, values: torch.Tensor,
                 indices: torch.Tensor) -> torch.Tensor:
    """Per worker, scatter-add [W, R, cap] (values, indices) into [W, n],
    one source row at a time in row order (rank order for gathered rows,
    as the JAX scatter adds on the CPU); the sentinel n drops."""
    W, R = values.shape[0], values.shape[1]
    buf = torch.zeros((W, n + 1), dtype=values.dtype, device=values.device)
    for r in range(R):
        buf.scatter_add_(1, indices[:, r].long(), values[:, r])
    return buf[:, :n]


def index_mask(n: int, indices: torch.Tensor) -> torch.Tensor:
    """[W, n] bool: True at each row's ``indices`` [W, m] (the sentinel n
    drops), ``zeros(n).at[idx].set(True, mode="drop")`` per row."""
    W = indices.shape[0]
    m = torch.zeros((W, n + 1), dtype=torch.bool, device=indices.device)
    return m.scatter_(1, indices.long(), True)[:, :n]


def region_ids(n: int, boundaries: torch.Tensor) -> torch.Tensor:
    """Region id of every element: the number of interior boundaries
    <= its index (searchsorted side="right")."""
    ids = torch.arange(n, dtype=torch.int32, device=boundaries.device)
    return torch.searchsorted(boundaries[1:-1].contiguous(), ids,
                              right=True).to(torch.int32)


def pack_by_region(x: torch.Tensor, mask: torch.Tensor,
                   boundaries: torch.Tensor, num_regions: int, cap: int):
    """Pack masked elements into per-region fixed-capacity buffers.

    ``boundaries``: i32 [num_regions + 1] with boundaries[0] == 0 and
    boundaries[-1] == n. Returns (values [R, cap], indices [R, cap] with
    global element ids, counts [R] clipped to cap)."""
    n = x.numel()
    R = num_regions
    dev = x.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    rid = region_ids(n, boundaries).long()
    csum = torch.cumsum(mask, 0, dtype=torch.int64)
    starts = boundaries[:-1].long()
    start_counts = torch.where(starts > 0, csum[torch.clamp(starts - 1,
                                                            min=0)], 0)
    pos_in_region = csum - 1 - start_counts[rid]
    pos = torch.where(mask & (pos_in_region < cap), pos_in_region, cap)
    flat = rid * (cap + 1) + pos
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    values = torch.zeros(R * (cap + 1), dtype=x.dtype, device=dev)
    values.scatter_(0, flat, torch.where(mask, x, zero))
    indices = torch.full((R * (cap + 1),), n, dtype=torch.int32, device=dev)
    indices.scatter_(0, flat, ids)
    ends = boundaries[1:].long()
    end_counts = torch.where(ends > 0, csum[torch.clamp(ends - 1, min=0)], 0)
    counts = torch.clamp(end_counts - start_counts, max=cap).to(torch.int32)
    return (values.view(R, cap + 1)[:, :cap],
            indices.view(R, cap + 1)[:, :cap], counts)


def region_mask(n: int, boundaries: torch.Tensor, region: int):
    """Boolean mask of the elements belonging to ``region``."""
    ids = torch.arange(n, dtype=torch.int32, device=boundaries.device)
    return (ids >= boundaries[region]) & (ids < boundaries[region + 1])
