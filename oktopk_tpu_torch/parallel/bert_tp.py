"""Tensor-parallel BERT: Megatron's head and FFN sharding over ``model``.

Counterpart of ``oktopk_tpu/parallel/bert_tp.py``, the two psums a
layer:

- attention: the head dimension is sharded, each model rank runs H/P
  whole heads (column-parallel QKV), then the row-parallel out
  projection and one psum;
- MLP: the column-parallel intermediate Dense, the row-parallel output
  Dense, one psum (the row-parallel biases are added after the psum, so
  once);
- LayerNorms, embeddings, the pooler and the MLM/NSP heads are
  replicated.

The math consumes a re-layout of the unchanged ``BertForPreTraining``
tree in the JAX layout (``split_tp`` / ``merge_tp``), so loss and
gradients hold against the single module and checkpoints interchange.
The attention is JAX's: ``q * d**-0.5``, masked scores filled with
-1e30, softmax; the MLM product ``h @ table.astype(dtype)``.

Workers. The grid (``make_tp_grid``) is dp data rows x tp model ranks;
worker ``d * tp + m`` holds its tp shard and its own copy of the shared
parameters, each a flat row in JAX's leaf order, and computes the
replicated part itself, as each process does across processes. The
layer input, which every model rank holds alike, enters a rank's shard
through ``pvary`` (its gradient the psum over model of the ranks'
cotangents), and the partial products leave through ``psum`` (each
row's gradient its own): Megatron's f and g (``parallel/transposes.py``).
A plain psum's autograd would count each cotangent once per model rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from oktopk_tpu_torch.models.bert import BertConfig
from oktopk_tpu_torch.models.layers import lookup
from oktopk_tpu_torch.optim.flat import apply_opt, init_opt
from oktopk_tpu_torch.parallel.bert_pipeline import row_batch
from oktopk_tpu_torch.parallel.bert_seq import (_dense, _layer_norm, gelu,
                                                mlm_table, out_proj, proj,
                                                token_ce)
from oktopk_tpu_torch.parallel.grid import TPGrid, make_grid
from oktopk_tpu_torch.parallel.ring_attention import NEG
from oktopk_tpu_torch.parallel.transposes import (first, psum, pvary,
                                                  replicate)
from oktopk_tpu_torch.utils.flatten import TreeLayout


def _shard(x: torch.Tensor, parts: int, axis: int) -> torch.Tensor:
    return torch.stack(torch.chunk(x, parts, dim=axis))


def _unshard(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.cat(list(x.unbind(0)), dim=axis)


def split_tp(params, num_shards: int):
    """Single-module JAX-layout tree -> (tp_stack, shared).

    ``tp_stack`` leaves carry a leading [P] shard axis: per layer the
    query/key/value kernels and biases split on the head dim, the out
    kernel on its head input dim, the MLP intermediate kernel and bias
    on the feature dim and the MLP output kernel on its feature input
    dim. ``shared`` holds everything else, the row-parallel output biases
    too (added once, after the psum)."""
    enc = params["bert"]["encoder"]
    tp_layers, sh_layers = {}, {}
    for name, lp in enc.items():
        a = lp["attention"]
        tp_layers[name] = {
            "attention": {
                **{k: {"kernel": _shard(a[k]["kernel"], num_shards, 1),
                       "bias": _shard(a[k]["bias"], num_shards, 0)}
                   for k in ("query", "key", "value")},
                "out": {"kernel": _shard(a["out"]["kernel"], num_shards,
                                         0)},
            },
            "intermediate": {
                "kernel": _shard(lp["intermediate"]["kernel"], num_shards,
                                 1),
                "bias": _shard(lp["intermediate"]["bias"], num_shards, 0)},
            "output": {"kernel": _shard(lp["output"]["kernel"], num_shards,
                                        0)},
        }
        sh_layers[name] = {
            "attention_out_bias": a["out"]["bias"],
            "output_bias": lp["output"]["bias"],
            "attention_ln": lp["attention_ln"],
            "output_ln": lp["output_ln"],
        }
    shared = {
        "embeddings": params["bert"]["embeddings"],
        "pooler": params["bert"]["pooler"],
        "mlm_dense": params["mlm_dense"],
        "mlm_ln": params["mlm_ln"],
        "mlm_bias": params["mlm_bias"],
        "nsp": params["nsp"],
        "layers": sh_layers,
    }
    return tp_layers, shared


def merge_tp(tp_layers, shared):
    """Inverse of :func:`split_tp`."""
    enc = {}
    for name, lp in tp_layers.items():
        a = lp["attention"]
        sh = shared["layers"][name]
        enc[name] = {
            "attention": {
                **{k: {"kernel": _unshard(a[k]["kernel"], 1),
                       "bias": _unshard(a[k]["bias"], 0)}
                   for k in ("query", "key", "value")},
                "out": {"kernel": _unshard(a["out"]["kernel"], 0),
                        "bias": sh["attention_out_bias"]},
            },
            "attention_ln": sh["attention_ln"],
            "intermediate": {
                "kernel": _unshard(lp["intermediate"]["kernel"], 1),
                "bias": _unshard(lp["intermediate"]["bias"], 0)},
            "output": {"kernel": _unshard(lp["output"]["kernel"], 0),
                       "bias": sh["output_bias"]},
            "output_ln": sh["output_ln"],
        }
    return {
        "bert": {"embeddings": shared["embeddings"], "encoder": enc,
                 "pooler": shared["pooler"]},
        "mlm_dense": shared["mlm_dense"],
        "mlm_ln": shared["mlm_ln"],
        "mlm_bias": shared["mlm_bias"],
        "nsp": shared["nsp"],
    }


# ---- the forward ------------------------------------------------------------

def _tp_attention(tps, out_bias, xs, attn_mask, comm):
    """Each row's H/P heads and its row-parallel out projection, one
    psum; ``xs`` [W, B, T, E] the layer input every rank holds alike."""
    xv = pvary(xs, comm)
    partial = []
    for w, tp in enumerate(tps):
        q, k, v = (proj(tp[name], xv[w]) for name in
                   ("query", "key", "value"))
        d = q.shape[-1]
        s = torch.einsum("bthd,bshd->bhts", q * d ** -0.5, k)
        s = torch.where(attn_mask, s, torch.full((), NEG, dtype=s.dtype,
                                                 device=s.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhts,bshd->bthd", p, v)
        partial.append(out_proj(tp["out"], o))
    return psum(torch.stack(partial), comm) + out_bias


def _tp_layer(tps, shs, xs, attn_mask, cfg: BertConfig, comm):
    eps = cfg.layer_norm_eps
    y = _tp_attention([t["attention"] for t in tps],
                      torch.stack([s["attention_out_bias"] for s in shs])
                      .unsqueeze(1).unsqueeze(1), xs, attn_mask, comm)
    xs = torch.stack([_layer_norm(s["attention_ln"], x + yy, eps)
                      for s, x, yy in zip(shs, xs, y)])
    xv = pvary(xs, comm)
    partial = [torch.matmul(gelu(_dense(t["intermediate"], xv[w])),
                            t["output"]["kernel"])
               for w, t in enumerate(tps)]
    h = psum(torch.stack(partial), comm)
    return torch.stack([_layer_norm(s["output_ln"],
                                    x + (hh + s["output_bias"]), eps)
                        for s, x, hh in zip(shs, xs, h)])


def tp_loss_local(tp_local: Sequence[dict], shared: Sequence[dict], batch,
                  cfg: BertConfig, comm) -> torch.Tensor:
    """The MLM + NSP loss with tensor-parallel layers: [W] rows, every row
    the same. ``tp_local``: the W held ranks' shard trees; ``shared``:
    their W copies of the shared tree; ``batch``: [B, T], the same on
    every model rank."""
    ids = batch["input_ids"]
    T = ids.shape[1]
    dev = ids.device
    eps = cfg.layer_norm_eps
    pos = torch.arange(T, device=dev)
    xs = []
    for s in shared:
        emb = s["embeddings"]
        x = (lookup(ids, emb["word_embeddings"]["embedding"])
             + lookup(pos, emb["position_embeddings"]["embedding"])
             + lookup(batch["token_type_ids"],
                      emb["token_type_embeddings"]["embedding"]))
        xs.append(_layer_norm(emb["LayerNorm_0"], x, eps))
    xs = torch.stack(xs)
    mask = batch["attention_mask"][:, None, None, :].to(torch.bool)
    for i in range(cfg.num_layers):
        xs = _tp_layer([t[f"layer_{i}"] for t in tp_local],
                       [s["layers"][f"layer_{i}"] for s in shared], xs,
                       mask, cfg, comm)
    labels = batch["mlm_labels"]
    lmask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0)
    losses = []
    for s, x in zip(shared, xs):
        pooled = torch.tanh(_dense(s["pooler"], x[:, 0]))
        h = _layer_norm(s["mlm_ln"], gelu(_dense(s["mlm_dense"], x)), eps)
        mlm = (torch.matmul(h, mlm_table(s["embeddings"], cfg).t())
               + s["mlm_bias"]).to(torch.float32)
        nsp = _dense(s["nsp"], pooled).to(torch.float32)
        mlm_loss = (torch.sum(token_ce(mlm, safe) * lmask)
                    / torch.clamp(torch.sum(lmask), min=1.0))
        losses.append(mlm_loss
                      + token_ce(nsp, batch["nsp_labels"]).mean())
    return torch.stack(losses)


def make_tp_grid(num_shards: int, data_size: int = 1) -> TPGrid:
    """The data x model grid (JAX's ``make_tp_mesh``): dp = ``data_size``
    rows of ``num_shards`` model ranks, stacked on one device, or one
    worker a process when a process group is up."""
    return make_grid(TPGrid, num_shards, num_shards * data_size,
                     "tensor-parallel ranks")


def _local_trees(tp_stack, grid: TPGrid):
    """This process's model ranks' shard trees (views of ``tp_stack``)."""
    def pick(t, m):
        return ({k: pick(v, m) for k, v in t.items()}
                if isinstance(t, dict) else t[m])
    return [pick(tp_stack, m) for m in grid.shards]


def build_tp_loss(cfg: BertConfig, grid: TPGrid):
    """``loss_fn(tp_stack, shared, batch) -> loss`` on the model axis
    (JAX's ``build_tp_loss``): ``tp_stack`` leaves [P, ...], ``shared``
    one copy, ``batch`` [B, T] on every rank; the same loss on every
    process, differentiable in the stacked grid."""

    def loss_fn(tp_stack, shared, batch):
        layout = TreeLayout(shared)
        flat = layout.flat(shared)
        dev = flat.device
        row = row_batch(batch, 0, 1, dev)
        reps = replicate(flat, grid.model.local_workers)
        sh = [layout.tree(r) for r in reps.unbind(0)]
        return first(tp_loss_local(_local_trees(tp_stack, grid), sh,
                                   row, cfg, grid.model))

    return loss_fn


# ---- the train steps --------------------------------------------------------

def init_tp_opt_states(optimizer, tp_rows, shared_rows):
    """Each held worker's optimizers (JAX's ``init_tp_opt_states``): one
    copy of ``optimizer`` on its tp shard's flat row, one on its shared
    row. ``tp_rows`` / ``shared_rows``: per data row, [W_m, n] rows."""
    return ([[init_opt(optimizer, r[m]) for m in range(r.shape[0])]
             for r in tp_rows],
            [[init_opt(optimizer, r[m]) for m in range(r.shape[0])]
             for r in shared_rows])


def init_tp_sparse_states(n_tp: int, n_shared: int, algo_cfg, grid: TPGrid,
                          device):
    """The composed step's sparse states (JAX's
    ``init_tp_sparse_states``): per held model rank one ``SparseState``
    of its tp shard and one of its shared copy, each with this process's
    data rows. ``split_tp``'s equal splits make every tp shard
    ``n_tp``."""
    from oktopk_tpu_torch.collectives.state import init_state
    W_d = grid.data.local_workers
    cfg_tp = algo_cfg.replace(n=n_tp, num_workers=grid.dp)
    cfg_sh = algo_cfg.replace(n=n_shared, num_workers=grid.dp)
    return ([init_state(cfg_tp, W_d, device) for _ in grid.shards],
            [init_state(cfg_sh, W_d, device) for _ in grid.shards])


class TPTrainStep:
    """One step over the data x model grid: each held data row's fwd/bwd
    through the tensor-parallel loss, then (sparse) each held worker's tp
    shard gradient and shared gradient through ``compressor`` over
    ``data``, two flat vectors with two ``SparseState``s, then each
    worker's optimizers (the tp bucket and the shared bucket, each its
    own BertAdam clip). Dense (``build_tp_train_step``, dp = 1): the
    gradients as they come. ``step(batch) -> metrics`` (``loss``;
    sparse: ``comm_volume``). ``tp[i]`` / ``shared[i]``: data row
    ``grid.data_rows[i]``'s [W_m, n] flat rows in JAX's leaf order
    (``tp_layout``, ``shared_layout``)."""

    def __init__(self, cfg: BertConfig, grid: TPGrid, tp_stack, shared,
                 optimizer, algo_cfg=None, compressor: Optional[str] = None,
                 warmup: bool = True, device=None):
        self.cfg, self.grid = cfg, grid
        tps = _local_trees(tp_stack, grid)
        self.tp_layout = TreeLayout(tps[0])
        self.shared_layout = TreeLayout(shared)
        tp_flat = torch.stack([self.tp_layout.flat(t) for t in tps]
                              ).detach().to(device)
        self.device = tp_flat.device
        sh_flat = self.shared_layout.flat(shared).detach().to(self.device)
        W_d, W_m = grid.data.local_workers, grid.model.local_workers
        self.tp = [tp_flat.clone().requires_grad_() for _ in range(W_d)]
        self.shared = [sh_flat.unsqueeze(0).expand(W_m, -1).clone()
                       .requires_grad_() for _ in range(W_d)]
        self.opt_tp, self.opt_sh = init_tp_opt_states(optimizer, self.tp,
                                                      self.shared)
        self.sparse = compressor is not None
        if not self.sparse and grid.dp != 1:
            raise ValueError("the dense tensor-parallel step has no data "
                             "axis: compose dp > 1 through a compressor")
        n_tp, n_sh = self.tp_layout.n, self.shared_layout.n
        self.g_tp = [torch.empty((W_d, n_tp), device=self.device)
                     for _ in range(W_m)]
        self.g_sh = [torch.empty((W_d, n_sh), device=self.device)
                     for _ in range(W_m)]
        if self.sparse:
            from oktopk_tpu_torch.collectives.registry import get_algorithm
            self.algo = get_algorithm(compressor, warmup=warmup)
            self.cfg_tp = algo_cfg.replace(n=n_tp, num_workers=grid.dp)
            self.cfg_sh = algo_cfg.replace(n=n_sh, num_workers=grid.dp)
            self.sstates = init_tp_sparse_states(n_tp, n_sh, algo_cfg, grid,
                                                 self.device)

    def fwd_bwd(self, batch) -> torch.Tensor:
        """Each held worker's flat gradients (into ``g_tp``, ``g_sh``:
        [W_m] of [W_d, n]) and its data row's loss [W_d]."""
        grid = self.grid
        terms = []
        for i, d in enumerate(grid.data_rows):
            row = row_batch(batch, d, grid.dp, self.device)
            tp, sh = self.tp[i], self.shared[i]
            tp.grad = sh.grad = None
            loss = tp_loss_local(
                [self.tp_layout.tree(r) for r in tp.unbind(0)],
                [self.shared_layout.tree(r) for r in sh.unbind(0)],
                row, self.cfg, grid.model)
            loss.backward(torch.ones_like(loss))
            for m in range(grid.model.local_workers):
                self.g_tp[m][i].copy_(tp.grad[m])
                self.g_sh[m][i].copy_(sh.grad[m])
            tp.grad = sh.grad = None
            terms.append(loss.detach()[0])
        return torch.stack(terms)

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        grid = self.grid
        terms = self.fwd_bwd(batch)
        red_tp, red_sh = self.g_tp, self.g_sh
        if self.sparse:
            tp_ss, sh_ss = self.sstates
            red_tp, red_sh = [], []
            for m in range(grid.model.local_workers):
                out, tp_ss[m] = self.algo(self.g_tp[m], tp_ss[m],
                                          self.cfg_tp, grid.data)
                red_tp.append(out)
                out, sh_ss[m] = self.algo(self.g_sh[m], sh_ss[m],
                                          self.cfg_sh, grid.data)
                red_sh.append(out)
        for i in range(grid.data.local_workers):
            for m in range(grid.model.local_workers):
                apply_opt(self.opt_tp[i][m], self.tp[i].data[m],
                          red_tp[m][i])
                apply_opt(self.opt_sh[i][m], self.shared[i].data[m],
                          red_sh[m][i])
        loss = grid.data.pmean(terms)[0]
        if not self.sparse:
            return {"loss": loss}
        tp_ss, sh_ss = self.sstates
        vol = torch.stack([a.last_volume + b.last_volume
                           for a, b in zip(tp_ss, sh_ss)])   # [W_m, W_d]
        vol = grid.data.psum(grid.model.psum(vol)[0])[0]
        return {"loss": loss, "comm_volume": vol / (grid.dp * grid.tp)}

    def trees(self):
        """(tp shard trees of the held model ranks, the first's shared
        tree) of the first held data row (views)."""
        return ([self.tp_layout.tree(r) for r in self.tp[0].data],
                self.shared_layout.tree(self.shared[0].data[0]))

    def shared_equal(self) -> bool:
        """Whether every held worker's shared copy is bit-identical."""
        first = self.shared[0].data[0]
        return all(torch.equal(first, r) for s in self.shared
                   for r in s.data)


def build_tp_train_step(cfg: BertConfig, grid: TPGrid, tp_stack, shared,
                        optimizer, device=None) -> TPTrainStep:
    """The model-axis step (JAX's ``build_tp_train_step``): the gradients
    of the tp shards and of the shared tree as the transposes complete
    them, each worker's optimizer (``optimizer``: ``BertAdam`` or
    ``SGD``, copied per bucket and worker) on its own copy."""
    return TPTrainStep(cfg, grid, tp_stack, shared, optimizer,
                       device=device)


def build_tp_sparse_train_step(cfg: BertConfig, grid: TPGrid, tp_stack,
                               shared, optimizer, algo_cfg,
                               compressor: str = "oktopk",
                               warmup: bool = True,
                               device=None) -> TPTrainStep:
    """Sparse data parallelism composed with tensor parallelism (JAX's
    :290-379): each worker's tp-shard gradient and its shared gradient
    through ``compressor`` over ``data``, two vectors with two
    ``SparseState``s. The split keeps the shared copies bit-identical
    across model ranks: compressed on its own, the shared vector's input
    is the same on every model rank, and so is its result; one mixed
    vector would let each rank's thresholds, driven by its own tp shard,
    select different shared elements."""
    return TPTrainStep(cfg, grid, tp_stack, shared, optimizer,
                       algo_cfg=algo_cfg, compressor=compressor,
                       warmup=warmup, device=device)
