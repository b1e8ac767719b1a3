"""BERT for pretraining (MLM + NSP), plain PyTorch.

Devlin et al. 2018 (arXiv:1810.04805): token, position and segment
embeddings, LayerNorm and dropout; per layer self-attention (query, key
and value projections, scaled dot products over the attention mask,
softmax, dropout on the probabilities, an output projection), residual,
LayerNorm, an exact-erf GELU feed-forward, dropout, residual, LayerNorm;
the pooler's tanh over the first token; the masked-LM head (dense, GELU,
LayerNorm, the decoder tied to the word embeddings plus a bias, over
every position) and the next-sentence head. The loss is the MLM cross
entropy over the labelled positions plus the NSP cross entropy.

The parameters are named and shaped as the flax model of the JAX package
(``DenseGeneral`` attention kernels [hidden, heads, head_dim] and
[heads, head_dim, hidden], ``Dense`` kernels [in, out]) and ordered as
``jax.tree.flatten`` orders them, so that one flat vector in that order
is what the gradient exchange partitions. Departures: dropout draws
flax's masks (``prng.py``; the attention's one mask broadcast over batch
and heads, as flax's ``broadcast_dropout``), so that the reference and
the program drop the same units; LayerNorm is ``F.layer_norm``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference import prng
from gpubench.reference.precision import dense, matmul


def _sizes(m: Dict) -> Tuple[int, ...]:
    return (m["vocab_size"], m["hidden_size"], m["num_hidden_layers"],
            m["num_attention_heads"], m["intermediate_size"],
            m["max_position_embeddings"], m["type_vocab_size"])


def leaf_table(m: Dict) -> List[Tuple[str, Tuple[int, ...], Tuple]]:
    """(flax path, JAX shape, init) in ``jax.tree.flatten`` order; init
    is ("normal", std), ("zeros",) or ("ones",): flax's lecun-normal
    kernels (std sqrt(1/fan_in)), normal(1/sqrt(hidden)) embeddings."""
    V, H, L, NH, FF, POS, TT = _sizes(m)
    hd = H // NH
    out = []

    def kernel(path, shape, fan_in):
        out.append((path, shape, ("normal", 1.0 / math.sqrt(fan_in))))

    def vec(path, n, kind="zeros"):
        out.append((path, (n,), (kind,)))

    def ln(prefix):
        vec(prefix + "/bias", H)
        vec(prefix + "/scale", H, "ones")

    def dense_leaf(prefix, fin, fout):
        vec(prefix + "/bias", fout)
        kernel(prefix + "/kernel", (fin, fout), fin)

    e = "bert/embeddings"
    ln(e + "/LayerNorm_0")
    for name, rows in (("position_embeddings", POS),
                       ("token_type_embeddings", TT),
                       ("word_embeddings", V)):
        out.append((f"{e}/{name}/embedding", (rows, H),
                    ("normal", 1.0 / math.sqrt(H))))
    for i in range(L):
        p = f"bert/encoder/layer_{i}"
        for proj in ("key", "query", "value"):
            out.append((f"{p}/attention/{proj}/bias", (NH, hd), ("zeros",)))
            kernel(f"{p}/attention/{proj}/kernel", (H, NH, hd), H)
        vec(f"{p}/attention/out/bias", H)
        kernel(f"{p}/attention/out/kernel", (NH, hd, H), H)
        ln(f"{p}/attention_ln")
        dense_leaf(f"{p}/intermediate", H, FF)
        dense_leaf(f"{p}/output", FF, H)
        ln(f"{p}/output_ln")
    dense_leaf("bert/pooler", H, H)
    vec("mlm_bias", V)
    dense_leaf("mlm_dense", H, H)
    ln("mlm_ln")
    dense_leaf("nsp", H, 2)
    out.sort(key=lambda t: tuple(t[0].split("/")))
    return out


def dropout_sites(m: Dict) -> List[Tuple]:
    """flax's ``make_rng("dropout")`` suffixes of one apply, in the order
    the forward pass draws them."""
    sites = [("bert", "embeddings", "Dropout_0", 1)]
    for i in range(m["num_hidden_layers"]):
        layer = ("bert", "encoder", f"layer_{i}")
        sites += [layer + ("attention", 1), layer + ("Dropout_0", 1),
                  layer + ("Dropout_0", 2)]
    return sites


class _Sites:
    """The dropout keys of one apply, handed out in site order."""

    def __init__(self, rng, sites):
        self.keys = [prng.site_key(rng, s) for s in sites]
        self.used = 0

    def next(self):
        self.used += 1
        return self.keys[self.used - 1]


def _dropout(x, rate, sites):
    if sites is None or rate == 0.0:
        return x
    keep = prng.keep_mask(sites.next(), x.shape, 1.0 - rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _ln(x, p, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], p[prefix + "/scale"],
                        p[prefix + "/bias"], eps)


def forward(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            m: Dict, rng, precision: str):
    """(mlm_logits [B, T, V], nsp_logits [B, 2]); ``rng`` the apply's
    dropout key, None for no dropout."""
    V, H, L, NH, FF, POS, TT = _sizes(m)
    hd, eps = H // NH, m["layer_norm_eps"]
    rate_h = m["hidden_dropout_prob"]
    rate_a = m["attention_probs_dropout_prob"]
    sites = None if rng is None else _Sites(rng, dropout_sites(m))
    ids = batch["input_ids"].long()
    B, T = ids.shape
    e = "bert/embeddings"
    x = (p[e + "/word_embeddings/embedding"][ids]
         + p[e + "/position_embeddings/embedding"][:T][None]
         + p[e + "/token_type_embeddings/embedding"][
             batch["token_type_ids"].long()])
    x = _dropout(_ln(x, p, e + "/LayerNorm_0", eps), rate_h, sites)
    attend = batch["attention_mask"][:, None, None, :].bool()
    for i in range(L):
        a = f"bert/encoder/layer_{i}/attention"

        def heads(proj):
            y = dense(x, p[f"{a}/{proj}/kernel"].reshape(H, H),
                      p[f"{a}/{proj}/bias"].reshape(H), precision)
            return y.reshape(B, T, NH, hd).transpose(1, 2)

        q = heads("query") / math.sqrt(hd)
        logits = matmul(q, heads("key").transpose(-1, -2), precision)
        logits = torch.where(attend, logits,
                             torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        if sites is not None and rate_a > 0.0:
            keep = prng.keep_mask(sites.next(), (1, 1, T, T), 1.0 - rate_a,
                                  w.device)
            w = w * (keep.to(w.dtype) / (1.0 - rate_a))
        ctxt = matmul(w, heads("value"), precision).transpose(1, 2)
        y = dense(ctxt.reshape(B, T, H), p[f"{a}/out/kernel"].reshape(H, H),
                  p[f"{a}/out/bias"], precision)
        lp = f"bert/encoder/layer_{i}"
        x = _ln(x + _dropout(y, rate_h, sites), p, lp + "/attention_ln", eps)
        h = F.gelu(dense(x, p[lp + "/intermediate/kernel"],
                         p[lp + "/intermediate/bias"], precision))
        h = dense(h, p[lp + "/output/kernel"], p[lp + "/output/bias"],
                  precision)
        x = _ln(x + _dropout(h, rate_h, sites), p, lp + "/output_ln", eps)
    pooled = torch.tanh(dense(x[:, 0], p["bert/pooler/kernel"],
                              p["bert/pooler/bias"], precision))
    h = F.gelu(dense(x, p["mlm_dense/kernel"], p["mlm_dense/bias"],
                     precision))
    h = _ln(h, p, "mlm_ln", eps)
    table = p[e + "/word_embeddings/embedding"]
    mlm = matmul(h.reshape(B * T, H), table.t(), precision).reshape(
        B, T, V) + p["mlm_bias"]
    nsp = dense(pooled, p["nsp/kernel"], p["nsp/bias"], precision)
    return mlm, nsp


def loss(p, batch, m: Dict, rng, precision: str) -> torch.Tensor:
    """MLM cross entropy over the positions labelled >= 0 (divided by
    max(count, 1)) plus the mean NSP cross entropy."""
    mlm, nsp = forward(p, batch, m, rng, precision)
    labels = batch["mlm_labels"].long()
    mask = (labels >= 0).to(mlm.dtype)
    per_tok = F.cross_entropy(mlm.reshape(-1, mlm.shape[-1]),
                              labels.clamp(min=0).reshape(-1),
                              reduction="none").view(labels.shape)
    mlm_loss = (per_tok * mask).sum() / mask.sum().clamp(min=1.0)
    return mlm_loss + F.cross_entropy(nsp, batch["nsp_labels"].long())


def uses_dropout(m: Dict) -> bool:
    return (m["hidden_dropout_prob"] > 0
            or m["attention_probs_dropout_prob"] > 0)
