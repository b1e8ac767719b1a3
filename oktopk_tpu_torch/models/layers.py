"""Layers shared by the port's models, written out to match flax.

- flax's ``dtype`` field (mixed precision): the layers that flax gives a
  ``dtype`` derive from ``Mixed``, whose ``compute_dtype`` the model
  sets once (``set_compute_dtype``) from its ``dtype`` argument. None,
  the float32 model's, casts nothing: the layer computes in its
  tensors' own dtype (float32, or float64 after ``.double()``), as
  before. bfloat16 is flax's ``promote_dtype(x, kernel, bias,
  dtype=bf16)``: ``Conv2d``, ``Linear`` and ``Embedding`` cast the input
  and the float32 parameters to bfloat16 at every call, so the product
  runs and rounds in bfloat16, and the bias is added after it in
  bfloat16, as flax adds it (not fused into the product). The
  parameters, and the gradients that reach them through the casts,
  stay float32 (flax's ``param_dtype``). ``BatchNorm`` (and BERT's
  ``LayerNorm``) take flax's ``force_float32_reductions``: statistics
  and normalisation in float32 on the input promoted to float32, the
  result cast to bfloat16, the running statistics float32.
- ``BatchNorm``: flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over
  the ``axes`` it reduces (``(0, 2, 3)`` for NCHW feature maps, ``(0, 1)``
  for sequence features ``[B, T, F]``), the one axis left being the
  features:
  - batch variance E[x^2] - E[x]^2 (biased, clipped at 0), not the
    unbiased variance ``nn.BatchNorm2d`` puts into its running
    statistics;
  - running statistics ``m * running + (1 - m) * batch`` with flax's
    momentum m = 0.9 (torch's momentum 0.1), updated only where the
    caller asks (``update_stats``: worker 0's microbatches, H7);
  - y = (x - mean) * (rsqrt(var + eps) * scale) + bias, eps = 1e-5.
- ``dropout`` and ``attention_dropout``: flax's masks, bit for bit. A
  model lists its dropout sites (``dropout_sites``: the flax scope path
  and the count of that scope's ``make_rng`` calls, in the order the
  forward pass runs them); ``SiteKeys`` derives every site's key from the
  apply's dropout key in one host call (``ops/prng.py``), and each site
  draws ``keep_mask`` (the threefry kernel on the card) under its key.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from oktopk_tpu_torch.ops import prng

def resolve_dtype(dtype) -> Optional[torch.dtype]:
    """A model's ``dtype`` argument as a layer's ``compute_dtype``: None
    for float32 (no cast), else bfloat16, the one other compute dtype."""
    if dtype in (None, torch.float32):
        return None
    if dtype != torch.bfloat16:
        raise ValueError(f"compute dtype {dtype} is not float32 or "
                         "bfloat16")
    return dtype


class Mixed:
    """A layer with flax's ``dtype`` field (``compute_dtype``; None casts
    nothing)."""

    compute_dtype: Optional[torch.dtype] = None


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Give every ``Mixed`` layer of ``model`` (and the model) the compute
    dtype ``dtype`` (``resolve_dtype``), as a flax model hands its
    ``dtype`` to each submodule."""
    dt = resolve_dtype(dtype)
    model.compute_dtype = dt
    for m in model.modules():
        if isinstance(m, Mixed):
            m.compute_dtype = dt
    return model


def promote(dtype: Optional[torch.dtype], *xs):
    """flax's ``promote_dtype(*xs, dtype=dtype)``: each tensor (None
    kept) cast to ``dtype``; all as given when ``dtype`` is None."""
    if dtype is None:
        return xs
    return tuple(None if x is None else x.to(dtype) for x in xs)


class Conv2d(Mixed, nn.Conv2d):
    """``nn.Conv2d`` with flax ``nn.Conv``'s ``dtype``."""

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        x, w, b = promote(self.compute_dtype, x, self.weight, self.bias)
        y = self._conv_forward(x, w, None)
        return y if b is None else y + b.view(1, -1, 1, 1)


class Linear(Mixed, nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s ``dtype``."""

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        x, w, b = promote(self.compute_dtype, x, self.weight, self.bias)
        y = F.linear(x, w)
        return y if b is None else y + b


# CUDA's embedding backward adds the rows' gradients with a kernel that
# repeats bit for bit up to this many indices; above it, it takes a
# sort-based kernel whose sums differ from run to run (seen on the H100
# at BERT-base's 32 x 128 pipeline rows). ``embedding_grad`` keeps to the
# first: it adds chunks of at most this many indices in order.
EMBED_GRAD_CHUNK = 3072


def embedding_grad(g: torch.Tensor, ids: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """The table's gradient [rows, H] from the rows' gradients ``g`` [...,
    H] at ``ids`` [...]: one ``embedding_dense_backward`` on the CPU or
    for at most ``EMBED_GRAD_CHUNK`` indices; on a card above that, one a
    chunk of that many, the chunks added in order."""
    n = ids.numel()
    if g.device.type != "cuda" or n <= EMBED_GRAD_CHUNK:
        return torch.ops.aten.embedding_dense_backward(g, ids, rows, -1,
                                                       False)
    ids, g = ids.reshape(-1), g.reshape(n, -1)
    grad = None
    for s in range(0, n, EMBED_GRAD_CHUNK):
        part = torch.ops.aten.embedding_dense_backward(
            g[s:s + EMBED_GRAD_CHUNK], ids[s:s + EMBED_GRAD_CHUNK], rows,
            -1, False)
        grad = part if grad is None else grad.add_(part)
    return grad


class _Embed(torch.autograd.Function):
    """The rows ``ids`` of ``table`` (``F.embedding``), its backward
    ``embedding_grad``."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return None, embedding_grad(g, ids, ctx.rows)


class _CastEmbed(torch.autograd.Function):
    """The rows ``ids`` of ``table`` cast to ``dtype``, and its backward:
    flax's bfloat16 scatter-add of the rows' gradients into the table,
    summed in float32 and rounded to ``dtype`` once (CUDA's embedding
    backward sums so; the CPU's would add in bfloat16, one rounding per
    repeated id), then cast back to the table's float32."""

    @staticmethod
    def forward(ctx, ids, table, dtype):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], dtype
        return F.embedding(ids, table.to(dtype))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = embedding_grad(g.to(torch.float32), ids, ctx.rows)
        return None, grad.to(ctx.dtype).to(torch.float32), None


class Embedding(Mixed, nn.Embedding):
    """``nn.Embedding`` with flax ``nn.Embed``'s ``dtype``: the table is
    cast, then the rows are taken (``_CastEmbed``). Either way the
    table's gradient is ``embedding_grad``'s, which repeats bit for
    bit."""

    def forward(self, ids):
        if self.compute_dtype is None:
            return _Embed.apply(ids, self.weight)
        return _CastEmbed.apply(ids, self.weight, self.compute_dtype)


class BatchNorm(Mixed, nn.Module):
    """flax ``nn.BatchNorm`` over the ``axes`` of its input; the features
    lie on the one axis not in ``axes``."""

    def __init__(self, features: int, axes: Sequence[int] = (0, 2, 3),
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.axes = tuple(axes)
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        dt = self.compute_dtype
        if dt is not None:          # force_float32_reductions
            x = x.to(torch.float32)
        if train:
            mean = x.mean(self.axes)
            mean2 = (x * x).mean(self.axes)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        shape = [1 if d in self.axes else -1 for d in range(x.dim())]
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y if dt is None else y.to(dt)


class SiteKeys:
    """The keys of a model's dropout sites under one apply's dropout key
    ``rng`` ([2] uint32), handed out in the order the sites run:
    ``hashes`` are the sites' ``prng.site_hash`` values."""

    def __init__(self, rng, hashes: np.ndarray):
        if rng is None:
            raise ValueError("dropout in train mode needs a key (the "
                             "apply's dropout rng)")
        self.keys = prng.site_keys(rng, hashes)
        self.used = 0

    @classmethod
    def of(cls, keys: np.ndarray) -> "SiteKeys":
        """Hand out ``keys`` ([S, 2] uint32, already derived) in order: one
        per module apply, so a recomputed apply redraws the same masks."""
        out = cls.__new__(cls)
        out.keys, out.used = keys, 0
        return out

    def next(self) -> np.ndarray:
        key = self.keys[self.used]
        self.used += 1
        return key


def site_hashes(sites) -> np.ndarray:
    """[S] uint32: each ``make_rng`` suffix's hash (``prng.site_hash``)."""
    return np.array([prng.site_hash(s) for s in sites], dtype=np.uint32)


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype on its device, a
    divisor as JAX makes one (a Python number rounded to the operand's
    dtype): PyTorch divides a CUDA tensor by a Python number as a
    multiply by its reciprocal, and a bfloat16 tensor by the number in
    float32, either of which can differ from flax's division in the last
    bit. ``full`` fills it on the device, without a copy from the
    host."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def dropout(x: torch.Tensor, rate: float, train: bool,
            keys: SiteKeys) -> torch.Tensor:
    """flax ``nn.Dropout``: ``select(mask, x / keep_prob, 0)`` with the
    mask ``bernoulli(key, keep_prob, x.shape)`` of the next site's key."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = prng.keep_mask(keys.next(), x.shape, keep_prob, x.device)
    return torch.where(keep, x / scalar_like(keep_prob, x),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def attention_dropout(w: torch.Tensor, rate: float, train: bool,
                      keys: SiteKeys) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention``'s broadcast dropout on the
    weights [B, heads, Tq, Tk]: one mask over (Tq, Tk), and
    ``w * (mask / keep_prob)`` (a multiply, as flax does)."""
    if not train or rate == 0.0:
        return w
    keep_prob = 1.0 - rate
    keep = prng.keep_mask(keys.next(), (1, 1) + tuple(w.shape[-2:]),
                          keep_prob, w.device)
    return w * (keep.to(w.dtype) / scalar_like(keep_prob, w))


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW map flattened in NHWC order, as a flax model flattens."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def pad_bottom_right(x: torch.Tensor, value: float) -> torch.Tensor:
    """An NCHW map padded by one row below and one column right."""
    return torch.nn.functional.pad(x, (0, 1, 0, 1), value=value)
