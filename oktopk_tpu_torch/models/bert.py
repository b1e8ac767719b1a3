"""BERT for pretraining (masked LM + next-sentence prediction).

Counterpart of ``oktopk_tpu/models/bert.py:24-180``, module for module,
so that ``convert.py`` maps the flax parameters onto these and
``jax_leaves`` lists them in the JAX package's flat order. Submodules
carry the flax names (``encoder.layers[i]`` is ``layer_i``).

Numerics follow flax, not ``torch.nn``'s defaults:
- attention is flax's ``MultiHeadDotProductAttention``: separate query,
  key and value ``DenseGeneral`` kernels [hidden, heads, head_dim] with
  biases [heads, head_dim], kept in the flax shapes; the query scaled by
  1/sqrt(head_dim) before the product; masked logits filled with
  ``finfo(dtype).min`` (not -10000); softmax in float32 (in bfloat16,
  flax's own bfloat16 softmax, ``FlaxSoftmax``); dropout on the
  weights with one mask broadcast over batch and heads, multiplied by
  mask / keep_prob as flax does (``attention_dropout``); an out kernel
  [heads, head_dim, hidden]. Written as ``torch.matmul`` and softmax
  (``scaled_dot_product_attention`` masks and scales differently);
- ``gelu`` is exact (erf), LayerNorm uses flax's fast variance
  E[x^2] - E[x]^2 clipped at 0, eps 1e-12, written out by hand;
- the MLM decoder is tied to the word-embedding table (plus
  ``mlm_bias``), so that table gets gradient from both uses;
- dropout draws flax's own masks (``models/layers.py``): ``forward``
  takes the apply's dropout key ``rng``, and each site, in the order of
  ``dropout_sites(cfg)`` (the flax scope path and ``make_rng`` count:
  the embeddings' ``Dropout_0``, then per layer the attention's draw and
  the layer's ``Dropout_0`` twice), draws under its own key; it is off
  for ``train=False`` or ``dropout=0.0``.

``init_weights`` draws flax's default distributions: lecun-normal
(truncated normal, std sqrt(1/fan_in)/0.8796) kernels, zero biases,
normal(1/sqrt(hidden)) embedding tables (``default_embed_init``),
LayerNorm scale 1 and bias 0, ``mlm_bias`` 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import (Embedding, Linear, Mixed,
                                            SiteKeys, attention_dropout,
                                            dropout, promote, resolve_dtype,
                                            scalar_like, set_compute_dtype,
                                            site_hashes)

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        resolve_dtype(self.dtype)       # float32 or bfloat16

    @staticmethod
    def base(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def large(**kw) -> "BertConfig":
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096, **kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """For tests and dry runs (not in the reference)."""
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=2, intermediate_size=128,
                          max_position=128, **kw)


class LayerNorm(Mixed, nn.Module):
    """flax ``nn.LayerNorm(epsilon=eps)`` over the last axis; with a
    compute dtype, in float32 on the promoted input, the result cast
    (``force_float32_reductions``)."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dt = self.compute_dtype
        if dt is not None:
            x = x.to(torch.float32)
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x - mean) * mul + self.bias
        return y if dt is None else y.to(dt)


class DenseGeneral(Mixed, nn.Module):
    """flax ``DenseGeneral`` with its kernel and bias in the flax shapes:
    ``in_shape`` axes of the input contract with the kernel's leading
    axes; the output has ``out_shape`` trailing axes."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.zeros(self.in_shape
                                               + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def forward(self, x):
        fan_in, fan_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        x, kernel, bias = promote(self.compute_dtype, x, self.kernel,
                                  self.bias)
        y = torch.matmul(x.reshape(lead + (fan_in,)),
                         kernel.reshape(fan_in, fan_out))
        y = y + bias.reshape(fan_out)
        return y.reshape(lead + self.out_shape)


class SelfAttention(Mixed, nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv_features = out_features
    = hidden) applied to x as query, key and value."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        hd = h // nh
        self.head_dim, self.rate = hd, cfg.dropout
        self.query = DenseGeneral((h,), (nh, hd))
        self.key = DenseGeneral((h,), (nh, hd))
        self.value = DenseGeneral((h,), (nh, hd))
        self.out = DenseGeneral((nh, hd), (h,))

    def forward(self, x, mask, train: bool, keys):
        # [B, T, heads, head_dim] -> [B, heads, T, head_dim]
        q = self.query(x).transpose(1, 2)
        k = self.key(x).transpose(1, 2)
        v = self.value(x).transpose(1, 2)
        depth = math.sqrt(self.head_dim)
        # flax: query / sqrt(depth).astype(dtype)
        q = q / (depth if self.compute_dtype is None
                 else scalar_like(depth, q))
        logits = torch.matmul(q, k.transpose(-1, -2))     # [B, h, Tq, Tk]
        big_neg = torch.finfo(logits.dtype).min
        logits = torch.where(mask, logits,
                             torch.full((), big_neg, dtype=logits.dtype,
                                        device=logits.device))
        if self.compute_dtype is None:
            w = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        else:       # flax: jax.nn.softmax(w).astype(dtype), in bfloat16
            w = FlaxSoftmax.apply(logits)
        w = attention_dropout(w, self.rate, train, keys)
        y = torch.matmul(w, v).transpose(1, 2)            # [B, T, h, hd]
        return self.out(y)


class FlaxSoftmax(torch.autograd.Function):
    """``jax.nn.softmax`` over the last axis in the operand's dtype, op
    for op: ``exp(x - max) / sum``, and its custom JVP transposed,
    ``y * g - y * sum(y * g)``."""

    @staticmethod
    def forward(ctx, x):
        u = torch.exp(x - x.amax(-1, keepdim=True))
        y = u / u.sum(-1, keepdim=True)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        yg = y * g
        return yg + y * -yg.sum(-1, keepdim=True)


class FlaxErfc(torch.autograd.Function):
    """``lax.erfc`` and its JVP rule, ``-2/sqrt(pi) * (g * exp(-x^2))``,
    op for op in the operand's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.special.erfc(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c = scalar_like(-2.0 / math.sqrt(math.pi), x)
        return c * (g * torch.exp(-(x * x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's exact ``gelu``; in a compute dtype, as ``jax.nn.gelu``
    writes it, ``0.5 * x * erfc(-x * sqrt(0.5))`` op for op."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="none")
    return 0.5 * x * FlaxErfc.apply(-x * scalar_like(math.sqrt(0.5), x))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.rate = cfg.dropout
        h = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, h)
        self.position_embeddings = Embedding(cfg.max_position, h)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, h)
        self.LayerNorm_0 = LayerNorm(h, cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids, train: bool, keys):
        positions = torch.arange(input_ids.shape[1],
                                 device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions)
             + self.token_type_embeddings(token_type_ids))
        x = self.LayerNorm_0(x)
        return dropout(x, self.rate, train, keys)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.rate = cfg.dropout
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = SelfAttention(cfg)
        self.attention_ln = LayerNorm(h, eps)
        self.intermediate = Linear(h, cfg.intermediate_size)
        self.output = Linear(cfg.intermediate_size, h)
        self.output_ln = LayerNorm(h, eps)

    def forward(self, x, mask, train: bool, keys):
        y = self.attention(x, mask, train, keys)
        x = self.attention_ln(x + dropout(y, self.rate, train, keys))
        h = gelu(self.intermediate(x))
        h = self.output(h)
        return self.output_ln(x + dropout(h, self.rate, train, keys))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layers = nn.ModuleList(BertLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def forward(self, x, mask, train: bool, keys):
        for layer in self.layers:
            x = layer(x, mask, train, keys)
        return x


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                train: bool = True, keys=None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        # boolean attend-mask over the keys, [B, 1, 1, Tk]
        mask = attention_mask[:, None, None, :].to(torch.bool)
        x = self.embeddings(input_ids, token_type_ids, train, keys)
        x = self.encoder(x, mask, train, keys)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


def dropout_sites(cfg: BertConfig):
    """flax's ``make_rng("dropout")`` suffixes of one pretraining apply,
    in call order."""
    sites = [("bert", "embeddings", "Dropout_0", 1)]
    for i in range(cfg.num_layers):
        layer = ("bert", "encoder", f"layer_{i}")
        sites += [layer + ("attention", 1), layer + ("Dropout_0", 1),
                  layer + ("Dropout_0", 2)]
    return sites


class _FlaxInitMixin:
    """flax's default initialisers and the flax leaf order, shared by the
    pretraining and the classification models."""

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default initialisers, drawn on the CPU from
        ``generator`` module by module (the draws are not JAX's: parity
        runs start from carried-over weights)."""
        def lecun_(w, fan_in):
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), std=std,
                                          a=-2.0 * std, b=2.0 * std,
                                          generator=generator))

        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_(m.weight, m.in_features)
                m.bias.zero_()
            elif isinstance(m, DenseGeneral):
                lecun_(m.kernel, math.prod(m.in_shape))
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               / math.sqrt(m.embedding_dim))
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
        if hasattr(self, "mlm_bias"):
            self.mlm_bias.zero_()

    def jax_leaves(self) -> List[Tuple[str, nn.Parameter, str]]:
        """(flax path, parameter, layout) in ``jax.tree.flatten`` order:
        dict keys sorted as strings at every level, so the encoder runs
        layer_0, layer_1, layer_10, layer_11, layer_2, ..., and the
        embeddings LayerNorm_0, position_, token_type_, word_embeddings.
        The tied decoder has no leaf of its own."""
        return [("/".join(path), p, layout)
                for path, p, layout in sorted_leaves(self.named_parameters())]


class BertForPreTraining(_FlaxInitMixin, nn.Module):
    """MLM + NSP heads over ``BertModel``; the MLM decoder is the word
    embedding table. Returns float32 (mlm_logits [B, T, vocab],
    nsp_logits [B, 2])."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.bert = BertModel(cfg)
        self.mlm_dense = Linear(h, h)
        self.mlm_ln = LayerNorm(h, cfg.layer_norm_eps)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.nsp = Linear(h, 2)
        self.site_hashes = site_hashes(dropout_sites(cfg))
        set_compute_dtype(self, cfg.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                train: bool = True, rng=None):
        """``rng``: the apply's dropout key ([2] uint32), needed in train
        mode with dropout."""
        keys = (SiteKeys(rng, self.site_hashes)
                if train and self.cfg.dropout > 0.0 else None)
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                                train, keys)
        h = gelu(self.mlm_dense(seq))
        h = self.mlm_ln(h)
        # the tied decoder casts the table on its own (flax's
        # table.astype(dtype)); the float32 bias promotes the sum
        (table,) = promote(self.compute_dtype,
                           self.bert.embeddings.word_embeddings.weight)
        mlm_logits = torch.matmul(h, table.t()) + self.mlm_bias
        nsp_logits = self.nsp(pooled)
        return mlm_logits.to(torch.float32), nsp_logits.to(torch.float32)


class BertForSequenceClassification(_FlaxInitMixin, nn.Module):
    """The GLUE head over ``BertModel``, as the JAX package's
    ``BertForSequenceClassification`` (``oktopk_tpu/models/bert.py:
    135-149``): the pooled output, flax's ``Dropout_0`` and a
    ``Dense_0`` of ``num_labels`` outputs, flax-named ``bert/...``,
    ``Dense_0/...``, so a pretraining checkpoint's ``bert`` subtree
    grafts onto it (``train/checkpoint.py::load_encoder_params``).
    Returns float32 logits [B, num_labels]."""

    def __init__(self, cfg: BertConfig, num_labels: int = 2):
        super().__init__()
        self.cfg = cfg
        self.num_labels = num_labels
        self.bert = BertModel(cfg)
        self.Dense_0 = Linear(cfg.hidden_size, num_labels)
        self.site_hashes = site_hashes(dropout_sites(cfg)
                                       + [("Dropout_0", 1)])
        set_compute_dtype(self, cfg.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                train: bool = True, rng=None):
        keys = (SiteKeys(rng, self.site_hashes)
                if train and self.cfg.dropout > 0.0 else None)
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              train, keys)
        x = dropout(pooled, self.cfg.dropout, train, keys)
        return self.Dense_0(x).to(torch.float32)

def sorted_leaves(named_parameters
                  ) -> List[Tuple[Tuple[str, ...], nn.Parameter, str]]:
    """(flax path as a tuple, parameter, layout) of (state_dict key,
    parameter) pairs in ``jax.tree.flatten`` order (by the tuple of path
    components)."""
    leaves = []
    for key, p in named_parameters:
        path, layout = flax_path(key)
        leaves.append((tuple(path.split("/")), p, layout))
    leaves.sort(key=lambda t: t[0])
    return leaves


def flax_path(key: str) -> Tuple[str, str]:
    """(flax path, layout) of a ``state_dict`` key of
    ``BertForPreTraining``: ``encoder.layers.i`` is ``encoder/layer_i``;
    an ``nn.Linear`` weight is a Dense ``kernel`` ([in, out]); an
    ``nn.Embedding`` weight is an ``embedding``."""
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers":
            out.append(f"layer_{parts[i + 1]}")
            i += 2
            continue
        out.append(parts[i])
        i += 1
    layout = "same"
    if out[-1] == "weight":
        if out[-2].endswith("_embeddings"):
            out[-1] = "embedding"
        else:
            out[-1], layout = "kernel", "linear"
    return "/".join(out), layout


def torch_key(path: str) -> Tuple[str, str]:
    """Inverse of ``flax_path``: (state_dict key, layout) of a flax path."""
    parts = path.split("/")
    out = []
    for part in parts:
        if part.startswith("layer_") and part[6:].isdigit():
            out += ["layers", part[6:]]
        else:
            out.append(part)
    layout = "same"
    if out[-1] == "embedding":
        out[-1] = "weight"
    elif out[-1] == "kernel" and out[-2] not in ("query", "key", "value",
                                                "out"):
        out[-1], layout = "weight", "linear"
    return ".".join(out), layout
