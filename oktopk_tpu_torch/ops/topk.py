"""Exact top-k, k-th-value thresholds and the sort-free count bisection.

Counterparts: ``oktopk_tpu/ops/topk.py`` (``exact_topk``, ``k2threshold``,
``k2threshold_method``, ``ratio2threshold``) and
``oktopk_tpu/ops/pallas_topk.py:29-91`` (``k2threshold_bisect``, plain XLA
there, not a Pallas kernel).

The bisection's bracket arithmetic uses ``log2``/``exp2``, whose last bit
differs between XLA and PyTorch (and again on the card), so its threshold
is held to the JAX one within a few ulps, not bit-for-bit; the elements
it selects agree.
"""

from __future__ import annotations

import torch

from oktopk_tpu_torch.ops.hist_threshold import k2threshold_hist

_WAYS = 8                 # brackets per pass (3 bits per data pass)
_LOG_RANGE_BITS = 64.0    # dynamic range below max|x| the bracket covers


def cumsum_rows(m: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """Inclusive integer cumsum of each row of ``m`` [..., n], taken as
    one scan of the flattened tensor minus each row's start: CUDA scans a
    1-D tensor with one device-wide scan, but a few long rows with a
    row-wise kernel that is far slower (PERF.md, section 5). With
    ``dtype=torch.int32`` the whole tensor's count must fit int32."""
    if dtype == torch.int32 and m.numel() >= 2 ** 31:
        raise ValueError(f"{m.numel()} elements overflow an int32 scan")
    cs = torch.cumsum(m.reshape(-1), 0, dtype=dtype).view(m.shape)
    if m.dim() == 1:
        return cs
    rows = cs.reshape(-1, m.shape[-1])
    start = torch.cat([rows.new_zeros(1), rows[:-1, -1]])
    return (rows - start[:, None]).view(m.shape)


def exact_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest |x| along the last dimension;
    values keep their sign. ``lax.top_k``'s rule: among equal magnitudes
    the lower index wins, and the k come in descending order of |x|, ties
    in ascending index order. ``torch.topk`` promises no tie order (and
    the CPU and CUDA differ), so it gives only the k-th magnitude: the
    winners are every element above it and the lowest-index ties at it,
    packed in index order, then stably sorted by magnitude."""
    absx = x.abs()
    n = x.shape[-1]
    kth = torch.topk(absx, k, dim=-1, sorted=False).values.amin(
        -1, keepdim=True)
    above = (absx > kth) | torch.isnan(absx)    # NaN ranks highest
    ties = absx == kth
    need = k - above.sum(-1, keepdim=True)
    take = above | (ties & (cumsum_rows(ties) <= need))
    # pack the first k winners in index order (more only if k or more
    # NaNs); slot k catches the rest
    pos = cumsum_rows(take) - 1
    pos = torch.where(take & (pos < k), pos, k)
    ids = torch.arange(n, device=x.device).expand_as(pos)
    idx = torch.empty(pos.shape[:-1] + (k + 1,), dtype=torch.int64,
                      device=x.device).scatter_(-1, pos, ids)[..., :k]
    order = torch.sort(absx.gather(-1, idx), dim=-1, descending=True,
                       stable=True).indices
    idx = idx.gather(-1, order)
    return x.gather(-1, idx), idx


def k2threshold(x_abs: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest value of ``x_abs`` (a value of the input, so
    bit-equal to the JAX ``lax.top_k`` read)."""
    return torch.topk(x_abs, k).values[k - 1]


def k2threshold_bisect(x_abs: torch.Tensor, k, iters: int = 30):
    """Multi-way bisection in log2 space for the k-th largest value: each
    pass splits the bracket into 8 geometric sub-intervals, counts every
    cut in one sweep, and keeps the sub-interval where count(|x| > cut)
    crosses k. Returns the bracket's lower edge, clamped to 2^-126, or 0
    for an all-zero input."""
    f32 = torch.float32
    dev = x_abs.device
    flat = x_abs.reshape(-1)
    hi0 = torch.max(flat)
    bits_per_pass = max(1, int(_WAYS).bit_length() - 1)
    passes = -(-iters // bits_per_pass)

    e_hi = torch.log2(torch.clamp(hi0, min=1e-38)) + torch.full(
        (), 1e-3, dtype=f32, device=dev)
    e_lo = e_hi - torch.full((), _LOG_RANGE_BITS, dtype=f32, device=dev)
    frac = torch.arange(1, _WAYS, dtype=f32, device=dev) / _WAYS
    ways = torch.arange(_WAYS, device=dev)
    total = torch.full((1,), flat.numel(), dtype=torch.int64, device=dev)
    lo, hi = e_lo, e_hi
    for _ in range(passes):
        cuts_e = lo + (hi - lo) * frac
        cuts = torch.exp2(cuts_e).to(x_abs.dtype)
        # counts[0] = n; counts[j] = #{x > cuts[j-1]} — the JAX form's
        # searchsorted(side="left") bucket index b satisfies b >= j
        # exactly when x > cuts[j-1]
        above = [(flat > cuts[j]).sum().reshape(1)
                 for j in range(_WAYS - 1)]
        counts = torch.cat([total] + above)
        enough = counts >= k
        j = torch.max(torch.where(enough, ways, torch.zeros_like(ways)))
        edges = torch.cat([lo.reshape(1), cuts_e, hi.reshape(1)])
        lo, hi = edges[j], edges[j + 1]
    t = torch.exp2(torch.clamp(lo, min=-126.0)).to(x_abs.dtype)
    return torch.where(hi0 > 0, t, torch.zeros_like(t))


def k2threshold_method(x_abs: torch.Tensor, k, method: str = "sort",
                       bisect_iters: int = 30) -> torch.Tensor:
    """Dispatch on ``OkTopkConfig.threshold_method``."""
    if method == "bisect":
        return k2threshold_bisect(x_abs, k, iters=bisect_iters)
    if method == "hist":
        return k2threshold_hist(x_abs, k)
    return k2threshold(x_abs, k)


def ratio2threshold(x: torch.Tensor, density: float) -> torch.Tensor:
    """The exact threshold such that ``|x| >= t`` selects ~density·n
    elements (``oktopk_tpu/ops/topk.py:53-60``; the reference's
    ``TopKCompressor.ratio2threshold``, VGG/compression.py:86-106)."""
    k = max(1, int(density * x.numel()))
    return k2threshold(x.abs(), k)
