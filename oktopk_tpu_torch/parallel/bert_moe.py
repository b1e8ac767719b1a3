"""Expert-parallel Mixture-of-Experts BERT over an ``expert`` comm.

Counterpart of ``oktopk_tpu/parallel/bert_moe.py``. Every encoder layer's
FFN becomes a Switch-style top-1 MoE in the GShard form, with a fixed
capacity ``C`` per (expert, source rank) and overflow dropped (a dropped
token contributes 0 and rides the residual):

  tokens [n, H] -> softmax gate, argmax of the probs -> (expert, slot)
    -> dispatch [E, C, H] -> all_to_all over the expert ranks
    -> each rank's local experts on [E_local, P * C, H] (matmul, exact
       gelu, matmul) -> all_to_all back -> combine, times the gate prob.

JAX writes the dispatch and the combine as einsums with a one-hot [n, E,
C] tensor. Each output element of those einsums has exactly one nonzero
term, so for finite inputs a gather or a scatter of the rows gives the
same bits at O(n * H) work instead of O(n * E * C * H); the port uses
the index ops (``dispatch``, ``combine``).

The Switch load-balance loss ``E * sum_e f_e * p_e`` takes f (the share
of tokens routed to e) and p (the mean gate prob of e) averaged over the
stats axes before the product: the expert ranks, and the data rows too
in both composed forms.

``experts_from_dense`` tiles a dense ``BertForPreTraining`` FFN into E
identical experts (the oracle: with identical experts and no overflow,
any routing gives the dense forward) plus a gate per layer drawn with
JAX's normal (``ops/prng.py``). The forward consumes JAX-layout trees of
tensors (``convert.bert_to_jax_params``, ``moe_from_jax``): its
attention is JAX's replicated one (q scaled before the product, masked
scores filled with -1e30), its LayerNorm ``bert_seq``'s two-pass one,
and in bfloat16 only the tied MLM table rounds (as in the seq path).

Workers. The grid (``make_moe_grid``) is dp data rows x ep expert ranks;
worker ``d * ep + e`` holds expert shard e and takes chunk ``d * ep + e``
of the global batch. A process holds its workers' trees as [W_d][W_e]
lists (stacked: every worker; one a process across processes) and runs
them in one graph: a data row's expert ranks meet in the all_to_all, and
the routing statistics of every row meet in one psum. The transposes
(``parallel/transposes.py``) stand where JAX's ``check_vma`` puts them:
the dispatch and its way back through ``all_to_all``, the loss's sums
and the statistics through ``psum``, a replicated parameter's use on a
worker's own data through ``pvary``; in the sparse form the aux term,
invariant over data, enters each row's loss through ``pvary`` over data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from oktopk_tpu_torch.models.bert import BertConfig
from oktopk_tpu_torch.models.layers import lookup
from oktopk_tpu_torch.ops import prng
from oktopk_tpu_torch.optim.flat import apply_opt, init_opt
from oktopk_tpu_torch.parallel.bert_pipeline import row_batch
from oktopk_tpu_torch.parallel.bert_seq import (_dense, _layer_norm, gelu,
                                                mlm_table, out_proj, proj,
                                                token_ce)
from oktopk_tpu_torch.parallel.grid import ExpertGrid, make_grid
from oktopk_tpu_torch.parallel.ring_attention import NEG
from oktopk_tpu_torch.parallel.transposes import (all_to_all, first, psum,
                                                  pvary, replicate)
from oktopk_tpu_torch.utils.flatten import TreeLayout


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 4
    capacity_factor: float = 1.25   # C = ceil(n * factor / E) per rank
    aux_weight: float = 0.01        # Switch load-balance loss weight


def experts_from_dense(params, num_experts: int, gate_scale: float = 0.0,
                       seed: int = 0):
    """A single-module JAX-layout tree -> (moe_stack, shared).

    Every layer's intermediate/output FFN is tiled into ``num_experts``
    identical experts (leaves ``wi`` [E, H, F], ``bi`` [E, F], ``wo``
    [E, F, H], ``bo`` [E, H]); ``shared`` holds the rest plus a gate [H,
    E] per layer: ``gate_scale * normal(key)`` with one key split off
    ``PRNGKey(seed)`` a layer, in JAX's (sorted) layer order, or zeros
    when ``gate_scale`` is 0. Real training wants ``gate_scale > 0``: a
    zero gate ties every token to expert 0 and the capacity drops most
    of the batch."""
    E = num_experts
    gate_rng = prng.prng_key(seed)
    enc = params["bert"]["encoder"]
    moe_layers, sh_layers = {}, {}
    for name in sorted(enc, key=str):
        lp = enc[name]

        def tile(x):
            return x.unsqueeze(0).expand((E,) + tuple(x.shape)).clone()

        kernel = lp["intermediate"]["kernel"]
        hidden = kernel.shape[0]
        moe_layers[name] = {
            "wi": tile(kernel),
            "bi": tile(lp["intermediate"]["bias"]),
            "wo": tile(lp["output"]["kernel"]),
            "bo": tile(lp["output"]["bias"]),
        }
        gate_rng, sub = prng.split(gate_rng)
        gate = (gate_scale * prng.normal(sub, (hidden, E)) if gate_scale
                else torch.zeros((hidden, E), dtype=torch.float32))
        sh_layers[name] = {
            "attention": lp["attention"],
            "attention_ln": lp["attention_ln"],
            "output_ln": lp["output_ln"],
            "gate": gate.to(kernel.device),
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
    return moe_layers, shared


def expert_shard(moe_stack, shard: int, e_local: int):
    """Expert rank ``shard``'s experts of a [E, ...] stack: leaves [E_local,
    ...] (views)."""
    if isinstance(moe_stack, dict):
        return {k: expert_shard(v, shard, e_local)
                for k, v in moe_stack.items()}
    return moe_stack[shard * e_local:(shard + 1) * e_local]


# ---- routing, dispatch, combine --------------------------------------------

def capacity(n: int, mcfg: MoEConfig) -> int:
    """Tokens an expert takes from one source rank (JAX's expression)."""
    return max(1, int(-(-n * mcfg.capacity_factor // mcfg.num_experts)))


def route(xt: torch.Tensor, gate: torch.Tensor, C: int):
    """Top-1 routing of tokens ``xt`` [n, H] by ``gate`` [H, E]: (probs [n,
    E], expert [n] (the first index of the largest prob, as
    ``jnp.argmax``), slot [n] (the tokens before it on that expert), keep
    [n] (slot < C), g [n] (the chosen prob))."""
    probs = torch.softmax(torch.matmul(xt, gate), dim=-1)
    expert = torch.argmax(probs, dim=-1)
    g = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, gate.shape[1])
    slot = (torch.cumsum(onehot, 0) - onehot).gather(1, expert[:, None])[:, 0]
    return probs, expert, slot, slot < C, g


def dispatch(xt: torch.Tensor, expert, slot, keep, E: int, C: int):
    """[n, H] -> [E, C, H]: each kept token's row at (its expert, its
    slot), zeros elsewhere; JAX's ``einsum("nec,nh->ech", disp, xt)``
    bit for bit (one nonzero term an element). A dropped token is written
    to a spare row that is cut off."""
    H = xt.shape[1]
    at = torch.where(keep, expert * C + slot, E * C)
    out = xt.new_zeros((E * C + 1, H)).index_copy(0, at, xt)
    return out[:E * C].view(E, C, H)


def combine(y: torch.Tensor, expert, slot, keep, g) -> torch.Tensor:
    """[E, C, H] -> [n, H]: each kept token's row of the expert outputs,
    zeros for a dropped one, times its gate prob; JAX's
    ``einsum("nec,ech->nh", disp, y) * g[:, None]`` bit for bit."""
    E, C, H = y.shape
    at = torch.where(keep, expert * C + slot, 0)
    rows = y.reshape(E * C, H).index_select(0, at)
    return torch.where(keep[:, None], rows, 0.0) * g[:, None]


def moe_ffn(experts: Sequence[dict], gates: Sequence[torch.Tensor],
            xs: torch.Tensor, mcfg: MoEConfig, comm):
    """The top-1 MoE FFN of one data row's held expert ranks: ``experts``
    their trees (leaves [E_local, ...]), ``gates`` their [H, E] gates,
    ``xs`` [W, b, T, H] their tokens. Returns (y [W, b, T, H], each
    worker's local statistics [W, 2, E]: the share of its tokens routed
    to each expert and its mean gate probs, and the tokens it dropped
    [W])."""
    Pn, E = comm.size, mcfg.num_experts
    e_local = experts[0]["wi"].shape[0]
    if e_local * Pn != E:
        raise ValueError(f"{e_local} local experts x {Pn} ranks != {E}")
    W, b, T, H = xs.shape
    n = b * T
    C = capacity(n, mcfg)
    xin, routes, stats, dropped = [], [], [], []
    for w in range(W):
        xt = xs[w].reshape(n, H)
        probs, expert, slot, keep, g = route(xt, gates[w], C)
        onehot = F.one_hot(expert, E).to(xt.dtype)
        stats.append(torch.stack([onehot.mean(0), probs.mean(0)]))
        dropped.append((~keep).sum())
        xin.append(dispatch(xt, expert, slot, keep, E, C))
        routes.append((expert, slot, keep, g))
    xin = all_to_all_leading(torch.stack(xin), e_local, comm)
    ys = []
    for w, ex in enumerate(experts):
        xe = xin[w].transpose(0, 1).reshape(e_local, Pn * C, H)
        h = gelu(torch.bmm(xe, ex["wi"]) + ex["bi"][:, None])
        y = torch.bmm(h, ex["wo"]) + ex["bo"][:, None]
        ys.append(y.view(e_local, Pn, C, H).transpose(0, 1))
    y = all_to_all_leading_back(torch.stack(ys), comm)
    out = [combine(y[w], *routes[w]).view(b, T, H) for w in range(W)]
    return torch.stack(out), torch.stack(stats), torch.stack(dropped)


def all_to_all_leading(x: torch.Tensor, e_local: int, comm) -> torch.Tensor:
    """[W, E = P * E_local, C, H] -> [W, P, E_local, C, H]: row q of a
    worker holds rank q's capacity block for this rank's experts."""
    W, E = x.shape[:2]
    return all_to_all(x.reshape(W, E // e_local, e_local, *x.shape[2:]),
                      comm)


def all_to_all_leading_back(y: torch.Tensor, comm) -> torch.Tensor:
    """Inverse of :func:`all_to_all_leading`: [W, P, E_local, C, H] ->
    [W, E, C, H]."""
    y = all_to_all(y, comm)
    return y.reshape(y.shape[0], -1, *y.shape[3:])


# ---- the forward and the loss ----------------------------------------------

def _attention(p, x, attn_mask):
    """JAX's replicated multi-head attention (flax parameter layout)."""
    q, k, v = (proj(p[name], x) for name in ("query", "key", "value"))
    d = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q * d ** -0.5, k)
    s = torch.where(attn_mask, s, torch.full((), NEG, dtype=s.dtype,
                                             device=s.device))
    o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)
    return out_proj(p["out"], o) + p["out"]["bias"]


def _embed(s, batch, cfg: BertConfig):
    ids = batch["input_ids"]
    emb = s["embeddings"]
    pos = torch.arange(ids.shape[1], device=ids.device)
    x = (lookup(ids, emb["word_embeddings"]["embedding"])
         + lookup(pos, emb["position_embeddings"]["embedding"])
         + lookup(batch["token_type_ids"],
                  emb["token_type_embeddings"]["embedding"]))
    return _layer_norm(emb["LayerNorm_0"], x, cfg.layer_norm_eps)


def _heads(s, x, batch, cfg: BertConfig) -> torch.Tensor:
    """[3]: the MLM cross-entropy sum over the masked positions, their
    count, and the NSP mean of one worker."""
    eps = cfg.layer_norm_eps
    pooled = torch.tanh(_dense(s["pooler"], x[:, 0]))
    h = _layer_norm(s["mlm_ln"], gelu(_dense(s["mlm_dense"], x)), eps)
    mlm = (torch.matmul(h, mlm_table(s["embeddings"], cfg).t())
           + s["mlm_bias"]).to(torch.float32)
    nsp = _dense(s["nsp"], pooled).to(torch.float32)
    labels = batch["mlm_labels"]
    lmask = (labels >= 0).to(torch.float32)
    per_tok = token_ce(mlm, torch.clamp(labels, min=0))
    return torch.stack([torch.sum(per_tok * lmask), torch.sum(lmask),
                        token_ce(nsp, batch["nsp_labels"]).mean()])


def _sum_rows(rows: Sequence[torch.Tensor], grid: ExpertGrid,
              over_data: bool, fn=psum) -> torch.Tensor:
    """[W_d] rows of [W_e, ...] -> [W_d, W_e, ...]: summed over the expert
    ranks, then over the data rows when ``over_data`` (rank order on
    both, so stacked and per-process sums agree); ``fn`` the psum
    (``transposes.psum``, or the comms' own for a value without
    gradient)."""
    x = torch.stack([fn(r, grid.expert) for r in rows])
    if over_data:
        x = torch.stack([fn(x[:, j].contiguous(), grid.data)
                         for j in range(x.shape[1])], 1)
    return x


def bert_moe_loss(moe_trees, shared_trees, batches, cfg: BertConfig,
                  mcfg: MoEConfig, grid: ExpertGrid, data_axis: bool,
                  stats_data_axis: bool, routing: Optional[dict] = None):
    """The MLM + NSP + aux loss of every held worker (JAX's
    ``bert_moe_loss``): [W_d, W_e].

    ``moe_trees`` / ``shared_trees``: [W_d][W_e] trees (a worker's expert
    shard, its shared copy); ``batches``: [W_d][W_e] batches [b, T].
    ``data_axis`` (JAX's ``data_axis``): the MLM and NSP reductions span
    the data rows too, else each row's own; ``stats_data_axis``: the aux
    statistics span the data rows. ``routing``, when given, gets the
    step's ``dropped`` tokens [L, W_d, W_e] and global loads ``f`` [W_d,
    W_e, L, E] (detached, on the device)."""
    L, E = cfg.num_layers, mcfg.num_experts
    eps = cfg.layer_norm_eps
    stats_rows, head_rows, dropped = [], [], []
    for ex, sh, bs in zip(moe_trees, shared_trees, batches):
        xs = torch.stack([_embed(s, b, cfg) for s, b in zip(sh, bs)])
        masks = [b["attention_mask"][:, None, None, :].to(torch.bool)
                 for b in bs]
        layer_stats, layer_dropped = [], []
        for i in range(L):
            name = f"layer_{i}"
            lsh = [s["layers"][name] for s in sh]
            xs = torch.stack([
                _layer_norm(p["attention_ln"],
                            x + _attention(p["attention"], x, m), eps)
                for p, x, m in zip(lsh, xs, masks)])
            h, st, dr = moe_ffn([e[name] for e in ex],
                                [p["gate"] for p in lsh], xs, mcfg,
                                grid.expert)
            layer_stats.append(st)
            layer_dropped.append(dr)
            xs = torch.stack([_layer_norm(p["output_ln"], x + hh, eps)
                              for p, x, hh in zip(lsh, xs, h)])
        stats_rows.append(torch.stack(layer_stats, 1))     # [W_e, L, 2, E]
        dropped.append(torch.stack(layer_dropped))          # [L, W_e]
        head_rows.append(torch.stack([_heads(s, x, b, cfg)
                                      for s, x, b in zip(sh, xs, bs)]))
    # f and p averaged over the stats axes before the product (JAX's pmean)
    stats = _sum_rows(stats_rows, grid, stats_data_axis) / (
        grid.ep * (grid.dp if stats_data_axis else 1))
    W_d, W_e = stats.shape[:2]
    aux = torch.stack([torch.stack([_aux(stats[i, j], E)
                                    for j in range(W_e)])
                       for i in range(W_d)])
    if stats_data_axis and not data_axis:
        # invariant over data, added to each row's own loss
        aux = torch.stack([pvary(aux[:, j].contiguous(), grid.data)
                           for j in range(W_e)], 1)
    num = _sum_rows([h[:, 0] for h in head_rows], grid, data_axis)
    den = _sum_rows([h[:, 1].detach() for h in head_rows], grid, data_axis,
                    fn=lambda x, c: c.psum(x))
    nsp = _sum_rows([h[:, 2] for h in head_rows], grid, data_axis) / (
        grid.ep * (grid.dp if data_axis else 1))
    if routing is not None:
        routing["dropped"] = torch.stack(dropped, 1).detach()
        routing["f"] = stats[:, :, :, 0].detach()
    return (num / torch.clamp(den, min=1.0) + nsp
            + mcfg.aux_weight * aux / L)


def _aux(stats: torch.Tensor, E: int) -> torch.Tensor:
    """One worker's Switch aux summed over the layers from its global
    statistics [L, 2, E] (JAX's ``aux_total``, layer by layer)."""
    total = torch.zeros((), dtype=stats.dtype, device=stats.device)
    for f, p in stats.unbind(0):
        total = total + E * torch.sum(f * p)
    return total


def make_moe_grid(num_shards: int, data_size: int = 1) -> ExpertGrid:
    """The data x expert grid (JAX's ``make_moe_mesh``): dp =
    ``data_size`` rows of ``num_shards`` expert ranks, stacked on one
    device, or one worker a process when a process group is up (its world
    size must be ``num_shards * data_size``)."""
    return make_grid(ExpertGrid, num_shards, num_shards * data_size,
                     "expert shards")


def worker_batches(batch, grid: ExpertGrid, device):
    """The held workers' [W_d][W_e] batches: worker ``d * ep + e`` takes
    chunk ``d * ep + e`` of the global batch."""
    parts = grid.dp * grid.ep
    return [[row_batch(batch, d * grid.ep + e, parts, device)
             for e in grid.shards] for d in grid.data_rows]


def _dense_trees(moe_rows: torch.Tensor, shared_flat: torch.Tensor,
                 moe_layout: TreeLayout, shared_layout: TreeLayout,
                 grid: ExpertGrid):
    """[W_d][W_e] trees of one copy of the parameters: each held expert
    rank's shard ``moe_rows`` [W_e, n_m] replicated over the data rows
    (its gradient their psum), the shared ``shared_flat`` [n] over every
    worker (its gradient the psum over expert, then over data)."""
    W_d, W_e = grid.data.local_workers, grid.expert.local_workers
    moe_d = [pvary(replicate(r, W_d), grid.data) for r in moe_rows.unbind(0)]
    sh_d = pvary(replicate(shared_flat, W_d), grid.data)
    moe, shared = [], []
    for i in range(W_d):
        moe.append([moe_layout.tree(moe_d[j][i]) for j in range(W_e)])
        sh_e = pvary(replicate(sh_d[i], W_e), grid.expert)
        shared.append([shared_layout.tree(r) for r in sh_e.unbind(0)])
    return moe, shared


def build_moe_loss(cfg: BertConfig, mcfg: MoEConfig, grid: ExpertGrid):
    """``loss_fn(moe_stack, shared, batch) -> loss`` (JAX's
    ``build_moe_loss``): ``moe_stack`` leaves [E, ...], ``shared`` one
    copy, ``batch`` the global [B, T] batch sharded over data x expert;
    the global loss (the reductions over every data row and expert rank),
    the same on every process, its gradient the global one."""
    e_local = mcfg.num_experts // grid.ep

    def loss_fn(moe_stack, shared, batch):
        shards = [expert_shard(moe_stack, e, e_local) for e in grid.shards]
        moe_layout, shared_layout = TreeLayout(shards[0]), TreeLayout(shared)
        moe_rows = torch.stack([moe_layout.flat(t) for t in shards])
        sh = shared_layout.flat(shared)
        moe, shared_t = _dense_trees(moe_rows, sh, moe_layout,
                                     shared_layout, grid)
        rows = bert_moe_loss(moe, shared_t,
                             worker_batches(batch, grid, sh.device), cfg,
                             mcfg, grid, data_axis=True,
                             stats_data_axis=True)
        return first(rows.reshape(-1))

    return loss_fn


# ---- the train steps --------------------------------------------------------

class ExpertViews:
    """One local expert's parameters in a worker's flat expert-shard row:
    in every [E_local, ...] leaf, row l of its [E_local, k] view, which
    is a contiguous slice. The flat row keeps JAX's leaf order (oktopk's
    regions depend on positions); the optimizer sees each expert's own
    vector, as JAX's ``vmap`` over the expert dim does."""

    def __init__(self, layout: TreeLayout, e_local: int):
        self.e_local, self.sizes = e_local, layout.sizes
        self.k = [s // e_local for s in layout.sizes]

    def params(self, flat: torch.Tensor, l: int) -> List[torch.Tensor]:
        return [seg.view(self.e_local, -1)[l]
                for seg in flat.split(self.sizes)]

    def grad(self, flat: torch.Tensor, l: int) -> torch.Tensor:
        return torch.cat(self.params(flat, l))

    def views(self, u: torch.Tensor) -> List[torch.Tensor]:
        return list(u.split(self.k))

    @staticmethod
    def flat(ts: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(ts))


def init_moe_sparse_states(n_moe: int, n_shared: int, algo_cfg,
                           grid: ExpertGrid, device):
    """The composed step's sparse states (JAX's
    ``init_moe_sparse_states``): per held expert rank one ``SparseState``
    of its expert shard (``n_moe``, the local shard's flat size) and one
    of its shared copy, each with this process's data rows."""
    from oktopk_tpu_torch.collectives.state import init_state
    W_d = grid.data.local_workers
    cfg_m = algo_cfg.replace(n=n_moe, num_workers=grid.dp)
    cfg_s = algo_cfg.replace(n=n_shared, num_workers=grid.dp)
    return ([init_state(cfg_m, W_d, device) for _ in grid.shards],
            [init_state(cfg_s, W_d, device) for _ in grid.shards])


def init_moe_sparse_opt(optimizer, moe_rows, shared_rows,
                        views: ExpertViews):
    """Each held worker's optimizers (JAX's ``init_moe_sparse_opt``): one
    copy of ``optimizer`` per local expert on its views of the worker's
    flat expert row (its own step and its own BertAdam clip, JAX's
    ``vmap``), one on its shared row. ``moe_rows`` / ``shared_rows``:
    per data row, [W_e, n] rows."""
    return ([[[init_opt(optimizer, views.params(r[j], l))
               for l in range(views.e_local)] for j in range(r.shape[0])]
             for r in moe_rows],
            [[init_opt(optimizer, r[j]) for j in range(r.shape[0])]
             for r in shared_rows])


class MoETrainStep:
    """One step over the data x expert grid.

    Sparse (``build_moe_sparse_train_step``): every worker holds its own
    flat expert-shard row and shared row (JAX's leaf order,
    ``moe_layout``, ``shared_layout``): ``moe[i]`` / ``shared[i]`` data
    row ``grid.data_rows[i]``'s [W_e, n] rows. Each data row computes its
    own loss (the MLM and NSP reductions over its expert ranks, the aux
    statistics over every worker); then two compressor calls over
    ``data``, on the expert shard and on the shared copy, each with its
    own ``SparseState``; then each worker's optimizers, one a local
    expert and one on the shared row. The shared gradient reaches every
    expert rank complete through ``pvary``, so the shared copies stay
    bit-identical.

    Dense (``build_moe_train_step``): one copy, ``moe[0]`` [W_e, n_m] (the
    held expert ranks' shards) and ``shared[0]`` [n]; the global loss, the
    gradients as the transposes complete them (the experts' summed over
    the data rows), one optimizer over the whole tree: each bucket's
    update clipped by the norm of every expert of every shard and the
    shared tree once.

    ``step(batch) -> metrics``: ``loss`` (sparse: the pmean over data of
    the rows' losses) and, sparse, ``comm_volume`` (the pmean over data x
    expert of both states' ``last_volume``). ``routing`` holds the last
    step's dropped tokens and loads (``bert_moe_loss``)."""

    def __init__(self, cfg: BertConfig, mcfg: MoEConfig, grid: ExpertGrid,
                 moe_stack, shared, optimizer, algo_cfg=None,
                 compressor: Optional[str] = None, warmup: bool = True,
                 device=None):
        self.cfg, self.mcfg, self.grid = cfg, mcfg, grid
        if mcfg.num_experts % grid.ep:
            raise ValueError(f"{mcfg.num_experts} experts over {grid.ep} "
                             "expert shards")
        self.e_local = mcfg.num_experts // grid.ep
        shards = [expert_shard(moe_stack, e, self.e_local)
                  for e in grid.shards]
        self.moe_layout = TreeLayout(shards[0])
        self.shared_layout = TreeLayout(shared)
        self.views = ExpertViews(self.moe_layout, self.e_local)
        m_flat = torch.stack([self.moe_layout.flat(t) for t in shards]
                             ).detach().to(device)
        self.device = m_flat.device
        sh_flat = self.shared_layout.flat(shared).detach().to(self.device)
        W_d, W_e = grid.data.local_workers, grid.expert.local_workers
        self.sparse = compressor is not None
        n_m, n_sh = self.moe_layout.n, self.shared_layout.n
        self.routing: Dict[str, torch.Tensor] = {}
        if not self.sparse:
            self.moe = [m_flat.clone().requires_grad_()]
            self.shared = [sh_flat.clone().requires_grad_()]
            self.opt_moe = [init_opt(optimizer, r) for r in self.moe[0]]
            self.opt_sh = init_opt(optimizer, self.shared[0])
            return
        self.moe = [m_flat.clone().requires_grad_() for _ in range(W_d)]
        self.shared = [sh_flat.unsqueeze(0).expand(W_e, -1).clone()
                       .requires_grad_() for _ in range(W_d)]
        self.opt_moe, self.opt_sh = init_moe_sparse_opt(
            optimizer, self.moe, self.shared, self.views)
        self.g_moe = [torch.empty((W_d, n_m), device=self.device)
                      for _ in range(W_e)]
        self.g_sh = [torch.empty((W_d, n_sh), device=self.device)
                     for _ in range(W_e)]
        from oktopk_tpu_torch.collectives.registry import get_algorithm
        self.algo = get_algorithm(compressor, warmup=warmup)
        self.cfg_moe = algo_cfg.replace(n=n_m, num_workers=grid.dp)
        self.cfg_sh = algo_cfg.replace(n=n_sh, num_workers=grid.dp)
        self.sstates = init_moe_sparse_states(n_m, n_sh, algo_cfg, grid,
                                              self.device)

    def loss_rows(self, batch) -> torch.Tensor:
        """[W_d, W_e] losses of the held workers on the global ``batch``,
        differentiable in the parameter rows."""
        grid = self.grid
        batches = worker_batches(batch, grid, self.device)
        if self.sparse:
            moe = [[self.moe_layout.tree(r) for r in m.unbind(0)]
                   for m in self.moe]
            shared = [[self.shared_layout.tree(r)
                       for r in pvary(s, grid.expert).unbind(0)]
                      for s in self.shared]
        else:
            moe, shared = _dense_trees(self.moe[0], self.shared[0],
                                       self.moe_layout, self.shared_layout,
                                       grid)
        return bert_moe_loss(moe, shared, batches, self.cfg, self.mcfg,
                             grid, data_axis=not self.sparse,
                             stats_data_axis=True, routing=self.routing)

    def fwd_bwd(self, batch) -> torch.Tensor:
        """The gradients (sparse: into ``g_moe``, ``g_sh``, [W_e] of [W_d,
        n]; dense: the parameters' ``.grad``) and each held data row's
        loss [W_d]."""
        for p in self.moe + self.shared:
            p.grad = None
        loss = self.loss_rows(batch)
        loss.backward(torch.ones_like(loss))
        if self.sparse:
            for i in range(self.grid.data.local_workers):
                for j in range(self.grid.expert.local_workers):
                    self.g_moe[j][i].copy_(self.moe[i].grad[j])
                    self.g_sh[j][i].copy_(self.shared[i].grad[j])
                self.moe[i].grad = self.shared[i].grad = None
        return loss.detach()[:, 0]

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        grid = self.grid
        terms = self.fwd_bwd(batch)
        if not self.sparse:
            self._apply_dense()
            return {"loss": terms[0]}
        m_ss, sh_ss = self.sstates
        red_m, red_sh = [], []
        for j in range(grid.expert.local_workers):
            out, m_ss[j] = self.algo(self.g_moe[j], m_ss[j], self.cfg_moe,
                                     grid.data)
            red_m.append(out)
            out, sh_ss[j] = self.algo(self.g_sh[j], sh_ss[j], self.cfg_sh,
                                      grid.data)
            red_sh.append(out)
        v = self.views
        for i in range(grid.data.local_workers):
            for j in range(grid.expert.local_workers):
                row = self.moe[i].data[j]
                for l, opt in enumerate(self.opt_moe[i][j]):
                    apply_opt(opt, v.params(row, l), v.grad(red_m[j][i], l),
                              v.views, v.flat)
                apply_opt(self.opt_sh[i][j], self.shared[i].data[j],
                          red_sh[j][i])
        vol = torch.stack([a.last_volume + b.last_volume
                           for a, b in zip(m_ss, sh_ss)])   # [W_e, W_d]
        vol = grid.data.psum(grid.expert.psum(vol)[0])[0]
        return {"loss": grid.data.pmean(terms)[0],
                "comm_volume": vol / (grid.dp * grid.ep)}

    @torch.no_grad()
    def _apply_dense(self) -> None:
        """One optimizer over the whole tree: the clip norm of every
        expert shard (a psum over expert) and the shared tree once."""
        m, sh = self.moe[0], self.shared[0]
        sq = torch.stack([torch.sum(g * g) for g in m.grad])
        sq = self.grid.expert.psum(sq)[0] + torch.sum(sh.grad * sh.grad)
        gnorm = torch.sqrt(sq)
        for j, opt in enumerate(self.opt_moe):
            apply_opt(opt, m.data[j], m.grad[j], gnorm=gnorm)
        apply_opt(self.opt_sh, sh.data, sh.grad, gnorm=gnorm)
        m.grad = sh.grad = None

    def trees(self):
        """(expert-shard trees of the held expert ranks, the first's
        shared tree) of the first held data row (views)."""
        m, s = self.moe[0].data, self.shared[0].data
        return ([self.moe_layout.tree(r) for r in m],
                self.shared_layout.tree(s[0] if self.sparse else s))

    def shared_equal(self) -> bool:
        """Whether every held worker's shared copy is bit-identical."""
        first_row = self.shared[0].data.reshape(-1, self.shared_layout.n)[0]
        return all(torch.equal(first_row, r) for s in self.shared
                   for r in s.data.reshape(-1, self.shared_layout.n))

    def experts_equal(self) -> bool:
        """Whether each held expert shard is bit-identical across the held
        data rows."""
        return all(torch.equal(self.moe[0].data, m.data) for m in self.moe)

    def moe_stack(self):
        """The whole [E, ...] expert stack of the first held data row,
        gathered over ``expert`` (every process of that row takes part;
        views on a stacked grid)."""
        rows = self.grid.expert.all_gather(self.moe[0].data)[0]
        shards = [self.moe_layout.tree(r) for r in rows]

        def cat(ts):
            if isinstance(ts[0], dict):
                return {k: cat([t[k] for t in ts]) for k in ts[0]}
            return torch.cat(ts)
        return cat(shards)


def build_moe_train_step(cfg: BertConfig, mcfg: MoEConfig, grid: ExpertGrid,
                         moe_stack, shared, optimizer,
                         device=None) -> MoETrainStep:
    """The dense step (JAX's ``build_moe_train_step``): the global loss,
    expert shards trained in place, one optimizer (``BertAdam`` or
    ``SGD``) over the whole (moe, shared) tree."""
    return MoETrainStep(cfg, mcfg, grid, moe_stack, shared, optimizer,
                        device=device)


def build_moe_sparse_train_step(cfg: BertConfig, mcfg: MoEConfig,
                                grid: ExpertGrid, moe_stack, shared,
                                optimizer, algo_cfg,
                                compressor: str = "oktopk",
                                warmup: bool = True,
                                device=None) -> MoETrainStep:
    """Sparse data parallelism composed with expert parallelism (JAX's
    :288-364): each data row's gradient, each worker's expert shard and
    shared copy through ``compressor`` over ``data``, two flat vectors
    with two ``SparseState``s, then the per-expert and shared
    optimizers."""
    return MoETrainStep(cfg, mcfg, grid, moe_stack, shared, optimizer,
                        algo_cfg=algo_cfg, compressor=compressor,
                        warmup=warmup, device=device)
