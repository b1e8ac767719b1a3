"""Sequence-parallel BERT: long-context pretraining over a ``seq`` comm.

Counterpart of ``oktopk_tpu/parallel/bert_seq.py``. The whole
BertForPreTraining forward runs with the token dimension sharded:

- embeddings per shard, position ids ``shard * T_local + arange``;
- every layer's attention is exact ring attention
  (``parallel/ring_attention.py``): no [T, T] scores, so the activations
  a worker holds scale as T/P;
- LayerNorm, the MLP and the heads are position-local; the pooler's
  [CLS] vector lives on shard 0 and reaches every shard by a psum of
  ``where(shard == 0, x[:, 0], 0)``;
- the MLM loss is the global weighted mean: numerator and denominator
  summed over the shards (and over the data rows in the dense composed
  form).

The functional forward consumes the unchanged ``BertForPreTraining``
parameters in the JAX tree layout (``convert.bert_to_jax_params``; a
tree of torch tensors here), so losses, gradients and checkpoints
interchange with the single module and with the JAX package. Its
LayerNorm is ``jnp.var``'s two-pass variance then ``rsqrt`` (not the
module's fast variance); the MLM product is ``h @ table.astype(dtype)``
with ``h`` float32, so in bfloat16 the only rounding on this path is the
table's (and its gradient's through that product). The forward is
deterministic: no dropout.

Workers. The grid (``make_seq_grid``) is dp data rows x sp shards;
worker ``d * sp + s`` holds its own copy of the parameters as a flat
[n] row in JAX's leaf order, and a process holds rows ``[W_s, n]`` of
its data row(s) (``StackedComm``: every shard; one shard a process
across processes). Every row is computed on its own, so a stacked row
and the process of that worker agree bit for bit. The parameters'
``shard_map`` transposes (``parallel/transposes.py``): their
token-local use goes through ``pvary`` over ``seq`` (the gradient psums
over the shards), the pooler and NSP head, which read the replicated
[CLS] vector, take the rows as they are (their gradient is each
worker's own); the [CLS] vector and the loss's numerator meet the
shards through ``psum``, whose gradient is each row's own.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from oktopk_tpu_torch.models.bert import BertConfig
from oktopk_tpu_torch.models.layers import lookup
from oktopk_tpu_torch.optim.flat import apply_opt, init_opt
from oktopk_tpu_torch.parallel.bert_pipeline import (  # noqa: F401
    row_batch, stack_replicas)
from oktopk_tpu_torch.parallel.grid import SeqGrid, make_grid
from oktopk_tpu_torch.parallel.ring_attention import ring_attention
from oktopk_tpu_torch.parallel.transposes import (first, psum, pvary,
                                                  replicate)
from oktopk_tpu_torch.utils.flatten import TreeLayout

TOKEN_KEYS = ("input_ids", "token_type_ids", "attention_mask", "mlm_labels")


# ---- the functional forward -----------------------------------------------

def _layer_norm(p, x, eps):
    mu = torch.mean(x, -1, keepdim=True)
    c = x - mu
    var = torch.mean(c * c, -1, keepdim=True)
    return c * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _dense(p, x):
    return torch.matmul(x, p["kernel"]) + p["bias"]


def gelu(x):
    return F.gelu(x, approximate="none")


def proj(pp, x):
    """A ``DenseGeneral`` [E, H, D] projection: [..., E] -> [..., H, D]."""
    e, h, d = pp["kernel"].shape
    return torch.matmul(x, pp["kernel"].reshape(e, h * d)).unflatten(
        -1, (h, d)) + pp["bias"]


def out_proj(pp, o):
    """The out projection [H, D, E]: [..., H, D] -> [..., E]."""
    h, d, e = pp["kernel"].shape
    return torch.matmul(o.flatten(-2), pp["kernel"].reshape(h * d, e))


def _mha(ps, xs, kv_mask, comm):
    """flax ``MultiHeadDotProductAttention`` with ring attention inside;
    ``ps`` the W rows' attention params, ``xs`` their [B, T/P, E]."""
    q, k, v = (torch.stack([proj(p[name], x) for p, x in zip(ps, xs)])
               for name in ("query", "key", "value"))
    o = ring_attention(q, k, v, comm, kv_mask=kv_mask)
    return [out_proj(p["out"], o[w]) + p["out"]["bias"]
            for w, p in enumerate(ps)]


def _layer(ps, xs, kv_mask, cfg: BertConfig, comm):
    ys = _mha([p["attention"] for p in ps], xs, kv_mask, comm)
    out = []
    for p, x, y in zip(ps, xs, ys):
        x = _layer_norm(p["attention_ln"], x + y, cfg.layer_norm_eps)
        h = _dense(p["output"], gelu(_dense(p["intermediate"], x)))
        out.append(_layer_norm(p["output_ln"], x + h, cfg.layer_norm_eps))
    return out


def mlm_table(emb, cfg: BertConfig):
    """The tied decoder's table as ``table.astype(cfg.dtype)`` meets a
    float32 ``h``: rounded to the compute dtype, computed in float32."""
    t = emb["word_embeddings"]["embedding"]
    return t if cfg.dtype == torch.float32 else t.to(cfg.dtype).to(t.dtype)


def bert_seq_forward(params: Sequence[dict], input_ids, token_type_ids,
                     attention_mask, cfg: BertConfig, comm,
                     head: Optional[Sequence[dict]] = None):
    """Sequence-sharded BertForPreTraining forward (deterministic).

    ``params``: W per-worker trees (JAX layout) for the token-local
    computation; ``head``: W trees for the pooler and the NSP head, which
    read the replicated [CLS] vector (default ``params``). Tokens are
    [W, B, T/P] local slices. Returns (the local mlm logits [W, B, T/P,
    V], the nsp logits [W, B, 2], every row the same), float32.
    """
    head = params if head is None else head
    Tl = input_ids.shape[-1]
    dev = input_ids.device
    eps = cfg.layer_norm_eps
    xs = []
    for w, p in enumerate(params):
        emb = p["bert"]["embeddings"]
        pos = (comm.first_worker + w) * Tl + torch.arange(Tl, device=dev)
        x = (lookup(input_ids[w], emb["word_embeddings"]["embedding"])
             + lookup(pos, emb["position_embeddings"]["embedding"])
             + lookup(token_type_ids[w],
                      emb["token_type_embeddings"]["embedding"]))
        xs.append(_layer_norm(emb["LayerNorm_0"], x, eps))
    kv_mask = attention_mask.to(torch.bool)
    for i in range(cfg.num_layers):
        xs = _layer([p["bert"]["encoder"][f"layer_{i}"] for p in params],
                    xs, kv_mask, cfg, comm)
    # the pooler's input: the global [CLS] (position 0) lives on shard 0
    first = (comm.rank(dev) == 0).view(-1, 1, 1)
    x0 = torch.stack([x[:, 0] for x in xs])
    cls = psum(torch.where(first, x0, torch.zeros_like(x0)), comm)
    mlm, nsp = [], []
    for w, (p, hp, x) in enumerate(zip(params, head, xs)):
        pooled = torch.tanh(_dense(hp["bert"]["pooler"], cls[w]))
        h = gelu(_dense(p["mlm_dense"], x))
        h = _layer_norm(p["mlm_ln"], h, eps)
        table = mlm_table(p["bert"]["embeddings"], cfg)
        mlm.append(torch.matmul(h, table.t()) + p["mlm_bias"])
        nsp.append(_dense(hp["nsp"], pooled))
    return (torch.stack(mlm).to(torch.float32),
            torch.stack(nsp).to(torch.float32))


def token_ce(logits, labels):
    """Cross entropy of each position (``optax``'s integer-label form)."""
    return F.cross_entropy(logits.flatten(0, -2), labels.flatten().long(),
                           reduction="none").view(labels.shape)


def bert_seq_loss(params: Sequence[dict], batch: Dict[str, torch.Tensor],
                  cfg: BertConfig, comm, head=None, dens=None):
    """The MLM + NSP loss from local shards: [W] rows, every row the same.

    ``batch``: [W, B, T/P] token leaves, ``nsp_labels`` [W, B]. ``dens``
    None: the data row's own loss (JAX's ``data_axis=None``): the MLM
    numerator and denominator summed over the shards, the NSP mean. Else
    the (MLM, NSP) denominators summed over the data rows too, and the
    result is this data row's share of the global loss (the shares add up
    to JAX's loss with ``data_axis`` set)."""
    mlm, nsp = bert_seq_forward(params, batch["input_ids"],
                                batch["token_type_ids"],
                                batch["attention_mask"], cfg, comm, head)
    labels = batch["mlm_labels"]
    mask = (labels >= 0).to(torch.float32)
    per_tok = token_ce(mlm, torch.clamp(labels, min=0))
    num = psum(torch.sum(per_tok * mask, dim=(1, 2)), comm)
    nsp_ce = token_ce(nsp, batch["nsp_labels"])
    if dens is None:
        den = comm.psum(torch.sum(mask, dim=(1, 2)))
        return num / torch.clamp(den, min=1.0) + nsp_ce.mean(-1)
    return (num / torch.clamp(dens[0], min=1.0)
            + torch.sum(nsp_ce, -1) / dens[1])


# ---- the grid, the rows and the one-copy views ----------------------------

def make_seq_grid(num_shards: int, data_size: int = 1) -> SeqGrid:
    """The data x seq grid (JAX's ``make_seq_mesh``): dp = ``data_size``
    rows of ``num_shards`` shards, stacked on one device, or one worker a
    process when a process group is up (its world size must be
    ``num_shards * data_size``)."""
    return make_grid(SeqGrid, num_shards, num_shards * data_size,
                     "sequence shards")


def shard_batch(row: Dict[str, torch.Tensor], grid) -> Dict[str, torch.Tensor]:
    """A data row's [B, T] batch -> this process's shards' [W_s, B, T/P]
    token slices and [W_s, B] NSP labels."""
    sp = grid.sp
    out = {}
    for k in TOKEN_KEYS:
        x = row[k]
        if x.shape[-1] % sp:
            raise ValueError(f"sequence length {x.shape[-1]} does not "
                             f"divide by {sp} shards")
        x = x.reshape(x.shape[0], sp, x.shape[-1] // sp)
        out[k] = x[:, grid.shards.start:grid.shards.stop].permute(1, 0, 2)
    out["nsp_labels"] = row["nsp_labels"].unsqueeze(0).expand(
        (grid.seq.local_workers,) + tuple(row["nsp_labels"].shape))
    return out


def _dens(rows, grid, device) -> torch.Tensor:
    """The (MLM, NSP) denominators summed over the data rows."""
    c = torch.stack([torch.stack([
        torch.sum((r["mlm_labels"] >= 0).to(torch.float32)),
        torch.full((), len(r["nsp_labels"]), dtype=torch.float32,
                   device=device)]) for r in rows])
    return grid.data.psum(c)[0]


def _row_loss(flat_rows: torch.Tensor, layout: TreeLayout, batch, cfg,
              grid, dens=None) -> torch.Tensor:
    """[W_s] loss rows of one data row from the workers' flat parameter
    rows [W_s, n]: token-local use through ``pvary`` over seq, the
    pooler and NSP head on the rows as they are."""
    vary = pvary(flat_rows, grid.seq)
    params = [layout.tree(r) for r in vary.unbind(0)]
    head = [layout.tree(r) for r in flat_rows.unbind(0)]
    return bert_seq_loss(params, batch, cfg, grid.seq, head, dens)


def jax_tree(model) -> dict:
    """A ``BertForPreTraining``'s parameters as the JAX tree (views)."""
    from oktopk_tpu_torch.models.layout import to_jax_layout
    tree: dict = {}
    for path, p, layout in model.jax_leaves():
        node = tree
        parts = path.split("/")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = to_jax_layout(p.detach(), layout)
    return tree


def tree_to_torch(tree, device=None) -> dict:
    """A nested dict of arrays (numpy, JAX's host copies) -> float32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def tree_to_numpy(tree) -> dict:
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def build_seq_loss(cfg: BertConfig, grid: SeqGrid):
    """``loss_fn(params, batch) -> loss``: the global loss (JAX's
    ``build_seq_loss``, the data rows in it when dp > 1) of a global batch
    (numpy or tensors, [global_B, T], data row d its d-th slice) from one
    copy of the parameters (a JAX-layout tree); the same on every process,
    and differentiable in the stacked grid."""

    def loss_fn(params, batch):
        layout = TreeLayout(params)
        flat = layout.flat(params)
        rows = [row_batch(batch, d, grid.dp, flat.device)
                for d in grid.data_rows]
        dens = _dens(rows, grid, flat.device)
        shares = []
        for row in rows:
            reps = replicate(flat, grid.seq.local_workers)
            shares.append(first(_row_loss(
                reps, layout, shard_batch(row, grid), cfg, grid, dens)))
        return grid.data.psum(torch.stack(shares))[0]

    return loss_fn


# ---- the train steps --------------------------------------------------------

class SeqTrainStep:
    """One step over the data x seq grid: each held data row's fwd/bwd
    through the ring-attention loss, then the gradient over ``data``, then
    the optimizer. Build it with :func:`build_seq_train_step` or
    :func:`build_seq_sparse_train_step`; ``step(batch) -> metrics``
    (``loss``; sparse: ``comm_volume``) on the device.

    Sparse: every worker holds its own copy of the parameters (JAX's
    per-data-row replicas), ``params[i]`` data row ``grid.data_rows[i]``'s
    [W_s, n] flat rows (JAX leaf order, ``layout``); each worker's whole
    flat gradient goes through ``compressor`` over ``data`` (one
    ``SparseState`` per shard) and each applies its own reduced row.
    Dense: one copy, ``params[0]`` [n], replicated to the shards of each
    data row (its gradient, one row's: each is the whole gradient of that
    row's share of the global loss), the rows' gradients summed over
    ``data`` in rank order, one optimizer."""

    def __init__(self, cfg: BertConfig, grid: SeqGrid, params, optimizer,
                 algo_cfg=None, compressor: Optional[str] = None,
                 warmup: bool = True, accum_steps: int = 1, device=None):
        self.cfg, self.grid = cfg, grid
        self.layout = TreeLayout(params)
        flat = self.layout.flat(params).detach().to(device)
        self.device = flat.device
        W_d, W_s = grid.data.local_workers, grid.seq.local_workers
        self.sparse = compressor is not None
        if accum_steps != 1 and not self.sparse:
            raise ValueError("accumulation needs the sparse composed form")
        self.accum_steps = accum_steps
        n = self.layout.n
        if self.sparse:
            from oktopk_tpu_torch.collectives.registry import get_algorithm
            from oktopk_tpu_torch.collectives.state import init_state
            self.params = [flat.unsqueeze(0).expand(W_s, -1).clone()
                           .requires_grad_() for _ in range(W_d)]
            self.opts = [[init_opt(optimizer, p[s]) for s in range(W_s)]
                         for p in self.params]
            self.g = [torch.empty((W_d, n), device=self.device)
                      for _ in range(W_s)]
            self.algo = get_algorithm(compressor, warmup=warmup)
            self.algo_cfg = algo_cfg.replace(n=n, num_workers=grid.dp)
            self.sstates = [init_state(self.algo_cfg, W_d, self.device)
                            for _ in range(W_s)]
        else:
            self.params = [flat.clone().requires_grad_()]
            self.opts = [[init_opt(optimizer, self.params[0])]]
            self.g = [torch.empty((W_d, n), device=self.device)]

    def _rows(self, i: int) -> torch.Tensor:
        """Held data row i's [W_s, n] parameter rows."""
        if self.sparse:
            return self.params[i]
        return replicate(self.params[0], self.grid.seq.local_workers)

    def fwd_bwd(self, batch):
        """The flat gradients (into ``g``: sparse, each shard's [W_d, n];
        dense, [W_d, n] one row a data row) and each held data row's loss
        terms [W_d] (dense: its share of the global loss)."""
        grid = self.grid
        rows = [row_batch(batch, d, grid.dp, self.device)
                for d in grid.data_rows]
        dens = None if self.sparse else _dens(rows, grid, self.device)
        A = self.accum_steps
        terms = []
        for i, row in enumerate(rows):
            p = self.params[i if self.sparse else 0]
            p.grad = None
            b = len(row["input_ids"]) // A
            if b * A != len(row["input_ids"]):
                raise ValueError(f"data row batch {len(row['input_ids'])} "
                                 f"is not a multiple of {A} microsteps")
            total = None
            for a in range(A):
                mb = {k: v[a * b:(a + 1) * b] for k, v in row.items()}
                loss = _row_loss(self._rows(i), self.layout,
                                 shard_batch(mb, grid), self.cfg, grid,
                                 dens)
                loss.backward(torch.ones_like(loss))
                total = loss.detach() if total is None else \
                    total + loss.detach()
            grad = p.grad if A == 1 else p.grad / A
            if self.sparse:
                for s in range(grid.seq.local_workers):
                    self.g[s][i].copy_(grad[s])
            else:
                self.g[0][i].copy_(grad)
            terms.append(total[0] if A == 1 else total[0] / A)
            p.grad = None
        return torch.stack(terms)

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        grid = self.grid
        terms = self.fwd_bwd(batch)
        if not self.sparse:
            apply_opt(self.opts[0][0], self.params[0].data,
                      grid.data.psum(self.g[0])[0])
            return {"loss": grid.data.psum(terms)[0]}
        reduced = []
        for s, g in enumerate(self.g):
            out, self.sstates[s] = self.algo(g, self.sstates[s],
                                             self.algo_cfg, grid.data)
            reduced.append(out)
        for i, p in enumerate(self.params):
            for s in range(grid.seq.local_workers):
                apply_opt(self.opts[i][s], p.data[s], reduced[s][i])
        vol = torch.stack([st.last_volume for st in self.sstates])
        vol = grid.data.psum(grid.seq.psum(vol)[0])[0]
        return {"loss": grid.data.pmean(terms)[0],
                "comm_volume": vol / (grid.dp * grid.sp)}

    def replicas_equal(self) -> bool:
        """Whether every parameter copy this process holds is
        bit-identical."""
        first = self.params[0].data.reshape(-1, self.layout.n)[0]
        return all(torch.equal(first, r) for p in self.params
                   for r in p.data.reshape(-1, self.layout.n))

    def tree(self) -> dict:
        """The first held worker's parameters as the JAX-layout tree
        (views)."""
        p = self.params[0].data
        return self.layout.tree(p[0] if self.sparse else p)


def build_seq_train_step(cfg: BertConfig, grid: SeqGrid, params, optimizer,
                         device=None) -> SeqTrainStep:
    """The dense step (JAX's ``build_seq_train_step`` over the composed
    loss): the global weighted loss over every data row and shard, one
    copy of the parameters, its gradient summed over the data rows in
    rank order, one optimizer (``optimizer``: a ``BertAdam`` or
    ``SGD``)."""
    return SeqTrainStep(cfg, grid, params, optimizer, device=device)


def build_seq_sparse_train_step(cfg: BertConfig, grid: SeqGrid, params,
                                optimizer, algo_cfg,
                                compressor: str = "oktopk",
                                warmup: bool = True, accum_steps: int = 1,
                                device=None) -> SeqTrainStep:
    """Sparse data parallelism composed with sequence parallelism (JAX's
    :192-286): each data row's loss psums over ``seq`` only, every
    worker's whole flat gradient goes through ``compressor`` over
    ``data``, and every worker applies its reduced gradient.
    ``accum_steps`` > 1 runs that many microsteps of ``len(row) /
    accum_steps`` examples into one collective, gradient and loss divided
    by ``accum_steps``."""
    return SeqTrainStep(cfg, grid, params, optimizer, algo_cfg=algo_cfg,
                        compressor=compressor, warmup=warmup,
                        accum_steps=accum_steps, device=device)
