"""BERT pretraining through the pipeline over a data x pipe grid.

Counterpart of ``oktopk_tpu/parallel/bert_pipeline.py``. The JAX package
runs the GPipe schedule of ``parallel/pipeline.py`` inside one
``shard_map`` over ``Mesh((dp, pp), ("data", "pipe"))``; the port's grid
is two comms:

- ``make_pipeline_grid(pp, num_workers)``: every worker stacked on one
  device, ``data = StackedComm(dp)`` and ``pipe = StackedComm(pp)``; one
  parameter copy (the JAX replicas are identical across data rows, as
  in the port's Trainer) and every stage;
- ``make_pipeline_grid(pp)`` across processes: worker ``d * pp + s`` (the
  JAX device order, ``devices.reshape(dp, pp)``) is data row d and stage
  s, its ``pipe`` comm the ``dist.new_group`` of its data row and its
  ``data`` comm the group of its stage; it holds stage s and the shared
  part.

Each data row's gradient is its own: the batch rows of row d, the
dropout key ``fold_in(step_key, d)`` handed unchanged to the embeddings
and to every stage, every microbatch and every tick (the JAX step's one
key, H27), the embeddings once at the row's batch shape before
the microbatch split. The gradients are completed as the JAX package's
``shard_map`` transposes complete them (H29):

- the stage grads of a data row are that row's (the pipeline's
  backward);
- the shared grads: the head's from the last stage's row (every process
  of the pipe group computes the head on the broadcast outputs, the same
  values), the embeddings' from stage 0's inject, whose cotangent the
  pipeline's ``to_rows`` psums over the stages;
- dense (``build_pipeline_train_step``): the loss is the global weighted
  mean (numerators and denominators summed over the data rows), so each
  row's gradient is its share of it and the rows are summed over
  ``data`` in rank order;
- sparse (``build_pipeline_sparse_train_step``): the loss is row-local,
  and one collective per stage bucket and one for the shared bucket,
  each over ``data`` with its own ``SparseState``, takes the mean.

Then the optimizer steps each stage bucket and the shared bucket on its
own, so BertAdam clips each by its own norm (H28). The flat
vector of a bucket is in the JAX leaf order (``utils/flatten.py``).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from oktopk_tpu_torch.comm import ProcessGroupComm, StackedComm
from oktopk_tpu_torch.models.bert_staged import StagedBertPretrain
from oktopk_tpu_torch.models.layout import from_jax_layout, to_jax_layout
from oktopk_tpu_torch.ops import prng
from oktopk_tpu_torch.optim.bert_adam import BertAdam
from oktopk_tpu_torch.parallel.pipeline import gpipe_apply

BATCH_KEYS = ("input_ids", "token_type_ids", "attention_mask", "mlm_labels",
              "nsp_labels")


# ---- the grid ------------------------------------------------------------

class PipelineGrid:
    """``dp`` data rows x ``pp`` stages: ``data`` spans this process's
    stage(s) over the data rows, ``pipe`` this process's data row(s) over
    the stages."""

    def __init__(self, dp: int, pp: int, data, pipe):
        self.dp, self.pp, self.data, self.pipe = dp, pp, data, pipe

    @property
    def distributed(self) -> bool:
        return self.pipe.local_workers < self.pp

    @property
    def data_rows(self) -> range:
        f = self.data.first_worker
        return range(f, f + self.data.local_workers)

    @property
    def stages(self) -> range:
        f = self.pipe.first_worker
        return range(f, f + self.pipe.local_workers)


def make_pipeline_grid(num_stages: int,
                       num_workers: Optional[int] = None) -> PipelineGrid:
    """The data x pipe grid of ``num_workers`` workers (dp = workers //
    pp): stacked on one device, or, when a process group is initialised,
    one worker per process over the world (``num_workers`` None or the
    world size). Across processes every rank creates every group in the
    same order: the pipe groups of data rows 0..dp-1, then the data
    groups of stages 0..pp-1."""
    import torch.distributed as dist

    procs = dist.is_initialized() and dist.get_world_size() > 1
    world = dist.get_world_size() if procs else (num_workers or num_stages)
    if procs and num_workers not in (None, world):
        raise ValueError(f"{num_workers} workers on a launch of {world} "
                         "processes: one worker per process")
    if world % num_stages != 0:
        raise ValueError(f"{world} workers not divisible by pipeline depth "
                         f"{num_stages}")
    dp, pp = world // num_stages, num_stages
    if not procs:
        return PipelineGrid(dp, pp, StackedComm(dp), StackedComm(pp))
    d, s = divmod(dist.get_rank(), pp)
    pipes = [dist.new_group([r * pp + j for j in range(pp)])
             for r in range(dp)]
    datas = [dist.new_group([r * pp + j for r in range(dp)])
             for j in range(pp)]
    return PipelineGrid(dp, pp, ProcessGroupComm(datas[s]),
                        ProcessGroupComm(pipes[d]))


def _microbatch(x: torch.Tensor, M: int) -> torch.Tensor:
    return x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))


def stack_replicas(tree, dp: int):
    """Each leaf of a dict tree broadcast to a leading [dp] (the JAX
    composed step's per-data-row replica layout; a view)."""
    if isinstance(tree, dict):
        return {k: stack_replicas(v, dp) for k, v in tree.items()}
    return tree.unsqueeze(0).expand((dp,) + tuple(tree.shape))


# ---- the loss ------------------------------------------------------------

def _pretrain_sums(mlm, nsp, batch):
    """(mlm numerator, mlm denominator, nsp numerator, nsp denominator) of
    one data row."""
    labels = batch["mlm_labels"]
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    per_tok = F.cross_entropy(mlm.flatten(0, -2), safe.flatten(),
                              reduction="none").view(labels.shape)
    nsp_ce = F.cross_entropy(nsp, batch["nsp_labels"].long(),
                             reduction="none")
    return (torch.sum(per_tok * mask), torch.sum(mask), torch.sum(nsp_ce),
            torch.full((), nsp_ce.shape[0], dtype=torch.float32,
                       device=nsp.device))


def _global_pretrain_loss(mlm, nsp, batch, dens=None):
    """The weighted pretraining loss of one data row (JAX's :42-63).
    ``dens`` None: row-local (the sparse composition's); else the
    (mlm, nsp) denominators summed over the data rows, and the result is
    this row's share of the global loss, whose rows add up to it (a mean
    of per-row means is not the global loss when rows carry different
    masked-token counts)."""
    mlm_num, mlm_den, nsp_num, nsp_den = _pretrain_sums(mlm, nsp, batch)
    if dens is not None:
        mlm_den, nsp_den = dens[0], dens[1]
    return (mlm_num / torch.clamp(mlm_den, min=1.0) + nsp_num / nsp_den,
            torch.stack([mlm_num.detach(), nsp_num.detach()]))


def _row_batch(batch, d: int, dp: int, device) -> Dict[str, torch.Tensor]:
    total = len(batch["input_ids"])
    b = total // dp
    if b * dp != total:
        raise ValueError(f"global batch {total} is not a multiple of "
                         f"{dp} data rows")
    out = {}
    for k in BATCH_KEYS:
        x = batch[k][d * b:(d + 1) * b]
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()            # a JAX array's host copy is read-only
        out[k] = torch.as_tensor(x).to(device)
    return out


def _row_logits(staged: StagedBertPretrain, grid: PipelineGrid, row, key,
                M: int, train: bool, remat: bool):
    """(mlm, nsp) logits of one data row through the pipeline."""
    ids = row["input_ids"]
    h0 = staged.embed(ids, row["token_type_ids"], train, key)
    mask_mb = _microbatch(staged.attn_mask(row["attention_mask"]), M)
    layer_keys = staged.layer_keys(train, key)

    def stage_fn(p, x, stage, mb_idx):
        return staged.apply_stage(p, x, mask_mb[mb_idx], train, layer_keys)

    outs = gpipe_apply(stage_fn, staged.stages, _microbatch(h0, M),
                       grid.pipe, M, remat=remat)
    # the last stage's row: the one whose cotangent the pipeline keeps
    h = outs[-1].reshape(ids.shape + (-1,))
    return staged.head_logits(h, train)


def _data_psum_row(grid: PipelineGrid, x: torch.Tensor) -> torch.Tensor:
    """[W_d, ...] rows of this process's data rows -> their psum over the
    data axis (rank order)."""
    return grid.data.psum(x)[0]


def build_pipeline_loss(staged: StagedBertPretrain, grid: PipelineGrid,
                        num_microbatches: int, train: bool = False,
                        remat: bool = False):
    """``loss_fn(batch, rng=None) -> loss``: the global weighted loss of a
    global batch (numpy or tensors, [global_B, ...], data row d its d-th
    slice) through the pipeline, the same on every process; ``rng`` is
    the step's dropout key ([2] uint32; each row folds in its index).
    In the stacked grid the loss is differentiable."""
    M = num_microbatches
    dev = staged.mlm_bias.device

    def loss_fn(batch, rng=None):
        sums = []
        for d in grid.data_rows:
            row = _row_batch(batch, d, grid.dp, dev)
            key = prng.fold_in(rng, d) if train else None
            mlm, nsp = _row_logits(staged, grid, row, key, M, train, remat)
            sums.append(torch.stack(_pretrain_sums(mlm, nsp, row)))
        s = _data_psum_row(grid, torch.stack(sums))
        return s[0] / torch.clamp(s[1], min=1.0) + s[2] / s[3]

    return loss_fn


# ---- flat buckets and optimizers -----------------------------------------

class Bucket:
    """One gradient bucket: its parameters in the JAX leaf order, their
    layouts, and the flat [n] vector in the JAX layout
    (``utils/flatten.py``'s order)."""

    def __init__(self, leaves):
        self.paths = [path for path, _, _ in leaves]
        self.params = [p for _, p, _ in leaves]
        self.layouts = [lay for _, _, lay in leaves]
        self.shapes = [to_jax_layout(p, lay).shape
                       for p, lay in zip(self.params, self.layouts)]
        self.sizes = [p.numel() for p in self.params]
        self.n = sum(self.sizes)

    def flat(self, tensors, out: Optional[torch.Tensor] = None):
        """``tensors`` (one per parameter, torch layout) as the flat
        vector; written into ``out`` when given."""
        parts = [to_jax_layout(t, lay).reshape(-1)
                 for t, lay in zip(tensors, self.layouts)]
        return torch.cat(parts) if out is None else torch.cat(parts, out=out)

    def jax_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each parameter's segment of ``flat`` in the JAX layout."""
        return [x.view(shape) for x, shape in
                zip(flat.split(self.sizes), self.shapes)]

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each parameter's segment of ``flat`` in the torch layout."""
        return [from_jax_layout(x, lay)
                for x, lay in zip(self.jax_views(flat), self.layouts)]

    def grads(self) -> List[torch.Tensor]:
        missing = [p for p, q in zip(self.paths, self.params)
                   if q.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        return [p.grad for p in self.params]


def _init_opt(optimizer, bucket: Bucket):
    opt = copy.deepcopy(optimizer)
    if isinstance(opt, BertAdam):
        opt.init(bucket.n, bucket.params[0].device)
    else:
        opt.init(bucket.params)
    return opt


@torch.no_grad()
def _apply(opt, bucket: Bucket, grad: torch.Tensor) -> None:
    """One optimizer step of ``bucket`` on its flat gradient ``grad``:
    BertAdam on flat buffers (it clips by this bucket's norm), SGD on the
    parameters."""
    if isinstance(opt, BertAdam):
        upd = opt.update(grad, bucket.flat(bucket.params))
        for p, u in zip(bucket.params, bucket.views(upd)):
            p.add_(u)
    else:
        opt.update(bucket.params, bucket.views(grad))


def init_pipeline_opt_state(optimizer, staged: StagedBertPretrain):
    """(one optimizer per held stage, one for the shared bucket), each a
    copy of ``optimizer`` initialised on its bucket (JAX's outer layout:
    stage states stacked [S], the shared state alone)."""
    stage = [_init_opt(optimizer, Bucket(staged.stage_leaves(w)))
             for w in range(len(staged.stages))]
    return stage, _init_opt(optimizer, Bucket(staged.shared_leaves()))


def init_pipeline_sparse_states(staged: StagedBertPretrain, algo_cfg,
                                grid: PipelineGrid, device=None):
    """Per-(data row, stage) sparse states: ``(stage_states, shared)``, a
    ``SparseState`` per held stage and one for the shared bucket, each
    with this process's data rows (JAX: [dp, S, ...] and [dp, ...]).
    Every stage must be the same size (each holds the same BertLayers)."""
    from oktopk_tpu_torch.collectives.state import init_state

    sizes = {Bucket(staged.stage_leaves(w)).n
             for w in range(len(staged.stages))}
    assert len(sizes) == 1, f"non-uniform stage sizes {sizes}"
    device = device or staged.mlm_bias.device
    cfg_stage = algo_cfg.replace(n=sizes.pop(), num_workers=grid.dp)
    cfg_shared = algo_cfg.replace(n=Bucket(staged.shared_leaves()).n,
                                  num_workers=grid.dp)
    W = grid.data.local_workers
    return ([init_state(cfg_stage, W, device) for _ in staged.stages],
            init_state(cfg_shared, W, device))


# ---- the train steps -----------------------------------------------------

class PipelineTrainStep:
    """One pipeline step: every data row's fwd/bwd through the pipeline
    (flushed), the gradient completion (dense) or the sparse collectives
    (sparse), then the optimizer on each bucket. Build it with
    :func:`build_pipeline_train_step` or
    :func:`build_pipeline_sparse_train_step`; ``step(batch, rng) ->
    metrics`` (``loss``; sparse: ``comm_volume``), metrics on the device.
    The parameters live in ``staged``; ``opt_states`` and ``sstates``
    hold the optimizers and the sparse states."""

    def __init__(self, staged: StagedBertPretrain, grid: PipelineGrid,
                 num_microbatches: int, optimizer, remat: bool = False,
                 grad_clip: Optional[float] = None, algo_cfg=None,
                 compressor: Optional[str] = None, warmup: bool = True):
        if len(staged.stages) != grid.pipe.local_workers or \
                list(staged.stage_ids) != list(grid.stages):
            raise ValueError(f"staged holds stages {staged.stage_ids}, the "
                             f"grid's pipe rows are {list(grid.stages)}")
        self.staged, self.grid = staged, grid
        self.M, self.remat, self.grad_clip = num_microbatches, remat, \
            grad_clip
        self.device = staged.mlm_bias.device
        self.stage_buckets = [Bucket(staged.stage_leaves(w))
                              for w in range(len(staged.stages))]
        self.shared_bucket = Bucket(staged.shared_leaves())
        self.opt_states = init_pipeline_opt_state(optimizer, staged)
        self.sparse = compressor is not None
        W_d = grid.data.local_workers
        self.g_stage = [torch.empty((W_d, b.n), device=self.device)
                        for b in self.stage_buckets]
        self.g_shared = torch.empty((W_d, self.shared_bucket.n),
                                    device=self.device)
        if self.sparse:
            from oktopk_tpu_torch.collectives.registry import get_algorithm
            self.algo = get_algorithm(compressor, warmup=warmup)
            self.sstates = init_pipeline_sparse_states(staged, algo_cfg,
                                                       grid, self.device)
            self.cfg_stage = algo_cfg.replace(
                n=self.stage_buckets[0].n, num_workers=grid.dp)
            self.cfg_shared = algo_cfg.replace(n=self.shared_bucket.n,
                                               num_workers=grid.dp)

    def _dens(self, rows) -> torch.Tensor:
        """The (mlm, nsp) denominators summed over the data rows."""
        c = torch.stack([torch.stack([
            torch.sum((r["mlm_labels"] >= 0).to(torch.float32)),
            torch.full((), len(r["nsp_labels"]), dtype=torch.float32,
                       device=self.device)]) for r in rows])
        return _data_psum_row(self.grid, c)

    def fwd_bwd(self, batch, rng):
        """Each held data row's flat stage and shared gradients (into
        ``g_stage`` and ``g_shared``) and its loss terms."""
        staged, grid = self.staged, self.grid
        rows = [_row_batch(batch, d, grid.dp, self.device)
                for d in grid.data_rows]
        dens = None if self.sparse else self._dens(rows)
        terms = []
        for i, (d, row) in enumerate(zip(grid.data_rows, rows)):
            for p in staged.parameters():
                p.grad = None
            key = prng.fold_in(rng, d)
            mlm, nsp = _row_logits(staged, grid, row, key, self.M, True,
                                   self.remat)
            loss, parts = _global_pretrain_loss(mlm, nsp, row, dens)
            loss.backward()
            for b, g in zip(self.stage_buckets, self.g_stage):
                b.flat(b.grads(), out=g[i])
            self.shared_bucket.flat(self.shared_bucket.grads(),
                                    out=self.g_shared[i])
            terms.append(loss.detach() if self.sparse else parts)
        for p in staged.parameters():
            p.grad = None
        return torch.stack(terms), dens

    def __call__(self, batch, rng) -> Dict[str, torch.Tensor]:
        grid = self.grid
        terms, dens = self.fwd_bwd(batch, rng)
        if self.sparse:
            red_s = []
            states, shared_state = self.sstates
            for w, g in enumerate(self.g_stage):
                out, states[w] = self.algo(g, states[w], self.cfg_stage,
                                           grid.data)
                red_s.append(out[0])
            out, shared_state = self.algo(self.g_shared, shared_state,
                                          self.cfg_shared, grid.data)
            red_h = out[0]
            self.sstates = (states, shared_state)
            vol = torch.stack([st.last_volume + shared_state.last_volume
                               for st in states])          # [W_p, W_d]
            vol = _data_psum_row(grid, grid.pipe.psum(vol)[0])
            metrics = {"loss": grid.data.pmean(terms)[0],
                       "comm_volume": vol / (grid.dp * grid.pp)}
        else:
            red_s = [_data_psum_row(grid, g) for g in self.g_stage]
            red_h = _data_psum_row(grid, self.g_shared)
            if self.grad_clip is not None:
                red_s, red_h = self._clip(red_s, red_h)
            s = _data_psum_row(grid, terms)
            metrics = {"loss": s[0] / torch.clamp(dens[0], min=1.0)
                       + s[1] / dens[1]}
        opt_stage, opt_shared = self.opt_states
        for opt, b, g in zip(opt_stage, self.stage_buckets, red_s):
            _apply(opt, b, g)
        _apply(opt_shared, self.shared_bucket, red_h)
        return metrics

    def _clip(self, red_s, red_h):
        """``grad_clip`` (JAX's :178-183): each stage's grads scaled by
        min(1, clip / norm) of that stage's and the shared grads together,
        as each pipe rank takes it; the shared grads by stage 0's scale,
        the one copy a replicated result can hold (the JAX step with
        ``grad_clip`` fails its replication check there: its shared
        result varies over the pipe axis)."""
        sh = torch.sum(red_h * red_h)
        scales = torch.stack([
            torch.clamp(self.grad_clip
                        / (torch.sqrt(torch.sum(g * g) + sh) + 1e-12),
                        max=1.0) for g in red_s])
        first = (self.grid.pipe.rank(scales.device) == 0).to(scales.dtype)
        scale0 = self.grid.pipe.psum(scales * first)[0]
        return [g * c for g, c in zip(red_s, scales)], red_h * scale0


def build_pipeline_train_step(staged: StagedBertPretrain, grid: PipelineGrid,
                              num_microbatches: int, optimizer,
                              remat: bool = False,
                              grad_clip: Optional[float] = None
                              ) -> PipelineTrainStep:
    """The dense pipeline step (JAX's :132-204): fwd/bwd + flush, the
    global-loss gradients summed over the data rows, the optimizer
    (``optimizer``: a ``BertAdam`` or ``SGD``, copied per bucket)."""
    return PipelineTrainStep(staged, grid, num_microbatches, optimizer,
                             remat=remat, grad_clip=grad_clip)


def build_pipeline_sparse_train_step(staged: StagedBertPretrain,
                                     grid: PipelineGrid,
                                     num_microbatches: int, optimizer,
                                     algo_cfg, compressor: str = "oktopk",
                                     warmup: bool = True,
                                     remat: bool = False
                                     ) -> PipelineTrainStep:
    """Sparse DP composed with the pipeline (JAX's :233-350): each data
    row's gradient is its own, and every stage bucket and the shared
    bucket go through ``compressor`` (any registry name) over ``data``
    with their own ``SparseState`` — the reference's PipeDream stages
    with a sparse allreduce inside each stage's data group, which it
    shipped disabled."""
    return PipelineTrainStep(staged, grid, num_microbatches, optimizer,
                             remat=remat, algo_cfg=algo_cfg,
                             compressor=compressor, warmup=warmup)


def gather_stage_stack(staged: StagedBertPretrain, grid: PipelineGrid):
    """Every stage's parameters as a ``stage_stack`` on the pipe group's
    first process (None on the others); the stacked grid holds them all.
    A collective over the pipe group."""
    if not grid.distributed:
        return staged.stage_stack()
    b = Bucket(staged.stage_leaves(0))
    rows = grid.pipe.gather(b.flat(b.params).unsqueeze(0))
    if rows is None:
        return None
    out = {}
    keys = list(staged.stages[0].state_dict())
    by_param = {id(p): k for k, p in staged.stages[0].named_parameters()}
    for s in range(grid.pp):
        for p, v in zip(b.params, b.views(rows[0, s])):
            out.setdefault(by_param[id(p)], []).append(v.clone())
    return {k: torch.stack(out[k]) for k in keys}
