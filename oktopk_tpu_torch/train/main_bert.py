"""Command-line entry point for BERT pretraining (MLM + NSP, BertAdam)
with a sparse allreduce: the data-parallel path.

Counterpart of ``oktopk_tpu/train/main_bert.py:22-182`` and
``_bert_algo_cfg`` (:290-299): the same flags and defaults (bs 8 per
worker, seq 128 (32 for ``bert_tiny``), BertAdam lr 2e-4 with a 1%
warmup-linear schedule over ``--num-minibatches``, oktopk at density
0.01 on the bf16 wire, no dense warmup; ``--compute-dtype
bfloat16`` computes the model in bfloat16 over float32 master weights),
plus ``--num-workers``,
``--device`` and ``--backend``. The data is ``make_dataset("wikipedia",
...)`` on ``--data-dir`` (default ``./data``): the sentence-per-line
corpus under ``wikipedia`` and its ``vocab.txt``, else the synthetic
MLM/NSP stream with a warning, as the JAX package falls back.
Checkpoints as :138-181: ``--resume DIR`` restores the newest verified
checkpoint (parameters, BertAdam's moments and step, the sparse state;
the data and the dropout key chain start again from ``--seed``, as in
the JAX package, H20); ``--handle-preemption`` stops between steps on a
signal, parks the state and exits with code 3, and resumes a parked
state on start; ``--ckpt-dir`` takes a checkpoint at the end, at step
``--num-minibatches`` (rank 0 writes; the state is gathered from every
rank first).

``--pipeline-stages N`` (N > 1) takes the pipeline path
(``run_pipeline``, JAX's :185-290): the encoder split into N stages over
a data x pipe grid of dp = workers / N data rows (``--num-workers``
stacked, default N; the world size across processes, worker ``d * N +
s`` data row d and stage s), GPipe with ``--num-microbatches`` M
(default 4) per flush and ``--remat``, a global batch of ``batch_size *
dp * M``; each stage bucket and the shared bucket (embeddings, pooler,
heads) through ``--compressor`` over its data group (dp >= 2;
``dense``: the JAX package's dense pipeline step), then BertAdam on each
bucket. It computes in float32, as the JAX path does
(``--compute-dtype`` is ignored there); ``--resume`` is a params-only
warm start from a single-module checkpoint, and ``--ckpt-dir`` takes one
at the end (rank 0 writes ``staged.merge``'s single-module layout).

``--seq-shards S`` (S > 1) takes the sequence-parallel path
(``run_seq_parallel``, JAX's :374-463): the token axis sharded over S
shards with ring attention, over a data x seq grid of ``--seq-data-shards``
D data rows (S x D workers stacked, or the world size across processes,
worker ``d * S + s`` data row d and shard s). A sparse ``--compressor``
needs D > 1 and reduces each worker's whole flat gradient over its data
group (``--gradient-accumulation-steps`` microsteps into one collective);
``dense`` is the global loss over every shard and data row, one copy of
the parameters. ``--batch-size`` is per data row and microstep;
``--max-seq-length`` must divide by S, and past the model's position
table (512) widens it; ``--compute-dtype bfloat16`` rounds the tied MLM
table (the rest of this path computes in float32, as JAX's does); no
dropout. ``--ckpt-dir`` writes the single-module layout, ``--resume``
warm-starts the parameters. ``--seq-data-shards`` without
``--seq-shards`` is refused, as in JAX.

``--expert-shards P`` (P > 1) takes the expert-parallel path
(``run_expert_parallel``, JAX's :466-566): every FFN a Switch top-1 MoE
of ``--num-experts`` E experts (default P; E must divide by P), P / E of
them a worker, with capacity ``--capacity-factor`` (1.25) times the even
share and overflow dropped, over a data x expert grid of
``--expert-data-shards`` D data rows (P x D workers stacked, or the
world size across processes, worker ``d * P + e`` data row d and expert
shard e). ``--batch-size`` is per worker. The experts are the seed's
dense FFN tiled E times, the gates JAX's normal at scale 0.02. A sparse
``--compressor`` needs D > 1 and reduces each worker's expert shard and
its shared copy over its data group, BertAdam per expert; ``dense`` is
the global loss, one BertAdam over the whole tree.
``--gradient-accumulation-steps`` is refused; ``--compute-dtype
bfloat16`` rounds the tied MLM table only; no dropout. ``--ckpt-dir``
writes JAX's ``moe_params`` layout (every expert, then the shared
tree), ``--resume`` warm-starts the parameters from one.

One process holds its P workers stacked on its device
(``--num-workers``, default 1); a multi-process launch runs one worker
per process over a ``torch.distributed`` group, as ``main_trainer``
does (``launch.data_parallel``), each with its own dropout stream
(``train/trainer.py``). Only rank 0 logs. ``--obs-spans PATH`` records
that path's steps with ``obs/anatomy.py``'s span recorder and writes
them as a Chrome trace at the end (``obs/tracing.py::export_spans``).

Examples:
    python -m oktopk_tpu_torch.train.main_bert --model bert_base \\
        --num-workers 4 --compressor oktopk --density 0.01 \\
        --num-minibatches 1024 --data-dir ./data --ckpt-dir ckpts \\
        --handle-preemption
    python -m oktopk_tpu_torch.train.main_bert --model bert_base \\
        --num-workers 4 --num-minibatches 2048 --resume ckpts
    python -m oktopk_tpu_torch.train.main_bert --model bert_base \\
        --num-workers 4 --compute-dtype bfloat16 --num-minibatches 100
    python -m oktopk_tpu_torch.train.main_bert --model bert_base \\
        --seq-shards 2 --seq-data-shards 2 --max-seq-length 2048 \\
        --batch-size 2 --compressor oktopk --density 0.01
    python -m oktopk_tpu_torch.train.main_bert --model bert_base \\
        --pipeline-stages 2 --num-workers 4 --num-microbatches 4 \\
        --batch-size 8 --compressor oktopk --density 0.01
    python -m oktopk_tpu_torch.train.main_bert --model bert_base \\
        --expert-shards 2 --expert-data-shards 2 --num-experts 4 \\
        --batch-size 8 --compressor oktopk --density 0.01
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from oktopk_tpu_torch.collectives.registry import (
    TWO_LEVEL_ONLY,
    list_algorithms,
)

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="bert_base",
                   choices=["bert_base", "bert_large", "bert_tiny"])
    p.add_argument("--batch-size", type=int, default=8,
                   help="per-worker microbatch (reference bs 8)")
    p.add_argument("--max-seq-length", type=int, default=None,
                   help="default: 128 (32 for bert_tiny)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup-proportion", type=float, default=0.01)
    p.add_argument("--num-minibatches", type=int, default=1024)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1)
    p.add_argument("--compressor", default="oktopk",
                   choices=list_algorithms())
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the model's computation dtype; parameters, "
                        "gradients, the collective and BertAdam stay "
                        "float32")
    p.add_argument("--wire-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--density", type=float, default=0.01)
    p.add_argument("--data-dir", default="./data",
                   help="the corpus (wikipedia) and vocab.txt; synthetic "
                        "batches where they are missing")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--num-workers", type=int, default=None,
                   help="data-parallel workers: stacked on the device in "
                        "one process (default 1); the world size across "
                        "processes")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, cuda:{local_rank} "
                        "across processes)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend across processes (default: "
                        "nccl on a card, gloo on the CPU)")
    p.add_argument("--pipeline-stages", type=int, default=1,
                   help="pipeline depth: split the encoder over a data x "
                        "pipe grid (run_pipeline); 1 = pure DP")
    p.add_argument("--num-microbatches", type=int, default=4,
                   help="GPipe microbatches per flush when pipelining")
    p.add_argument("--remat", action="store_true",
                   help="recompute stage activations in backward (the "
                        "pipeline path)")
    p.add_argument("--seq-shards", type=int, default=1,
                   help="sequence parallelism: shard the token axis over a "
                        "seq grid with ring attention (run_seq_parallel); "
                        "1 = off")
    p.add_argument("--seq-data-shards", type=int, default=1,
                   help="data axis of the composed data x seq grid: the "
                        "sparse allreduce (any --compressor) under sequence "
                        "parallelism; 1 = pure seq grid (dense only)")
    p.add_argument("--expert-shards", type=int, default=1,
                   help="expert parallelism: Switch top-1 MoE FFNs sharded "
                        "over an expert grid, all_to_all dispatch "
                        "(run_expert_parallel); 1 = off")
    p.add_argument("--num-experts", type=int, default=0,
                   help="experts per MoE layer (default: = expert-shards)")
    p.add_argument("--expert-data-shards", type=int, default=1,
                   help="data axis of the composed data x expert grid: the "
                        "sparse allreduce (any --compressor) with the MoE "
                        "dispatch; 1 = pure expert grid (dense only)")
    p.add_argument("--capacity-factor", type=float, default=1.25,
                   help="MoE token capacity per expert, a multiple of the "
                        "even-routing share")
    p.add_argument("--ckpt-dir", default=None,
                   help="write a checkpoint here at the end")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory (or file) to resume from")
    p.add_argument("--handle-preemption", action="store_true",
                   help="stop between steps on SIGINT/SIGTERM/SIGUSR2 "
                        "(SIGUSR1 also requeues), park the state and exit "
                        "with code 3; resume a parked state on start")
    p.add_argument("--obs-spans", default=None, metavar="PATH",
                   help="the data-parallel path: record the step's spans "
                        "(obs/anatomy.py's span recorder) over training "
                        "and write them as a Chrome trace to PATH at the "
                        "end (another rank: PATH.rank<r>)")
    args = p.parse_args(argv)
    if args.compressor == "hierarchical":
        p.error(TWO_LEVEL_ONLY)
    if args.max_seq_length is None:
        args.max_seq_length = 32 if args.model == "bert_tiny" else 128
    return args


def _bert_algo_cfg(args, **kw):
    """The BERT sparse-allreduce tuning: dense warmup off, recompute
    cadences 128, repartition every 64, Newton scales 1.025 / 1.036 (one
    definition for every BERT path, as in the JAX package)."""
    from oktopk_tpu_torch.config import OkTopkConfig
    return OkTopkConfig(
        warmup_steps=0, local_recompute_every=128,
        global_recompute_every=128, repartition_every=64,
        local_adapt_scale=1.025, global_adapt_scale=1.036,
        wire_dtype=args.wire_dtype, **kw)


def build_trainer(args, model_kwargs=None):
    """(Trainer, batch iterator) of the data-parallel path; joins the
    process group on a multi-process launch. The iterator is
    ``make_dataset("wikipedia", ...)``'s; ``args.data_meta`` holds its
    meta (``synthetic`` True without the corpus)."""
    from oktopk_tpu_torch.config import TrainConfig
    from oktopk_tpu_torch.data import make_dataset
    from oktopk_tpu_torch.launch import data_parallel
    from oktopk_tpu_torch.train.trainer import Trainer

    if (args.pipeline_stages > 1 or args.seq_shards > 1
            or args.expert_shards > 1):
        raise ValueError("--pipeline-stages, --seq-shards and "
                         "--expert-shards run their own paths "
                         "(build_pipeline, build_seq, build_moe), not the "
                         "data-parallel Trainer")
    _, dev, comm, workers = data_parallel(args.num_workers, args.device,
                                          args.backend)
    cfg = TrainConfig(
        dnn=args.model, dataset="wikipedia", batch_size=args.batch_size,
        lr=args.lr, compressor=args.compressor, density=args.density,
        nsteps_update=args.gradient_accumulation_steps, seed=args.seed,
        warmup_proportion=args.warmup_proportion,
        compute_dtype=args.compute_dtype,
        total_steps=args.num_minibatches, num_workers=workers)
    trainer = Trainer(cfg, algo_cfg=_bert_algo_cfg(args), device=dev,
                      model_kwargs=model_kwargs, comm=comm)
    global_bs = (args.batch_size * workers
                 * args.gradient_accumulation_steps)
    data, args.data_meta = make_dataset(
        "wikipedia", args.model, global_bs,
        path=getattr(args, "data_dir", None) or "./data", seed=args.seed,
        seq_len=args.max_seq_length)
    return trainer, data


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.obs_spans and max(args.pipeline_stages, args.seq_shards,
                              args.expert_shards) > 1:
        raise SystemExit("--obs-spans records the data-parallel path's "
                         "Trainer steps")
    # JAX's routing (:112-121): pipeline, seq, the refusal, expert
    if args.pipeline_stages > 1:
        return run_pipeline(args)
    if args.seq_shards > 1:
        return run_seq_parallel(args)
    if args.seq_data_shards > 1:
        raise SystemExit("--seq-data-shards composes with sequence "
                         "parallelism — it needs --seq-shards > 1 "
                         "(plain sparse DP is the default path)")
    if args.expert_shards > 1:
        return run_expert_parallel(args)
    trainer, data = build_trainer(args)
    rank = trainer.comm.first_worker if trainer.distributed else 0
    logger = (logging.getLogger("oktopk_tpu_torch.bert") if rank == 0
              else None)
    if logger:
        logger.info("BERT pretrain: %s, %d workers on %s%s, compressor=%s "
                    "density=%g", args.model, trainer.cfg.num_workers,
                    trainer.device,
                    f" ({trainer.comm.size} processes, "
                    f"{trainer.comm.backend})" if trainer.distributed
                    else "", args.compressor, args.density)
        if args.data_meta["synthetic"]:
            logger.warning("Wikipedia corpus not found under %s: synthetic "
                           "MLM/NSP data", args.data_dir)
    from oktopk_tpu_torch.obs.tracing import export_spans
    from oktopk_tpu_torch.train import preemption
    from oktopk_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)

    preempt = (preemption.PreemptionHandler() if args.handle_preemption
               else None)
    start = 0
    template = trainer.train_state(gather=False)
    if args.resume:
        tree, start = restore_checkpoint(args.resume, template)
        trainer.load_train_state(tree)
        if logger:
            logger.info("resumed at step %d", start)
    elif preempt is not None:
        parked = preemption.load_interrupted_state(template)
        if parked is not None:
            trainer.load_train_state(parked[0])
            start = parked[1]
            if logger:
                logger.info("resumed interrupted state at step %d", start)
    del template
    remaining = max(0, args.num_minibatches - start)
    with export_spans(args.obs_spans, trainer.device, rank):
        m = trainer.train(data, remaining, log_every=args.log_every,
                          logger=logger, start_step=start,
                          should_stop=(preempt.should_stop if preempt
                                       else None))
    if preempt is not None:
        done = trainer.last_step
        if done < args.num_minibatches:   # another rank may have stopped
            preempt.request_stop()
        rc = preemption.epilogue(
            trainer.train_state, done, preempt,
            logger or logging.getLogger("oktopk_tpu_torch.quiet"),
            rank=rank, completed=done >= args.num_minibatches)
        if rc:
            return rc
    if m and logger:
        logger.info("done: loss %r comm volume/step %d elems",
                    m["loss"], int(m["comm_volume"]))
    if args.ckpt_dir:
        t0 = time.perf_counter()
        state = trainer.train_state()         # every rank: gathers
        if rank == 0:
            path = save_checkpoint(args.ckpt_dir, state,
                                   args.num_minibatches)
            logger.info("checkpoint %s: %d B in %.3f s", path,
                        os.path.getsize(path), time.perf_counter() - t0)
    return 0


# ---- the pipeline path ---------------------------------------------------

class PipelineRun:
    """What ``build_pipeline`` builds: the grid, the staged model, the
    step and the batch iterator, and the step keys' chain (JAX's
    ``PRNGKey(seed + 1)``, split once a step, :258-260)."""

    def __init__(self, args, grid, staged, step, data, device, rank):
        from oktopk_tpu_torch.ops import prng
        self.args, self.grid, self.staged = args, grid, staged
        self.step, self.data, self.device, self.rank = step, data, \
            device, rank
        self._rng = prng.prng_key(args.seed + 1)

    def next_key(self):
        from oktopk_tpu_torch.ops import prng
        pair = prng.split(self._rng)
        self._rng = pair[0]
        return pair[1]

    def train_step(self):
        """One pipeline step on the next global batch; device metrics."""
        return self.step(next(self.data), self.next_key())

    def checkpoint_payload(self):
        """The single-module layout on rank 0, None elsewhere: data row
        0's pipe group gathers its stages to rank 0 (every process of that
        row takes part)."""
        from oktopk_tpu_torch.convert import bert_to_jax_params
        from oktopk_tpu_torch.parallel.bert_pipeline import \
            gather_stage_stack
        if self.grid.data_rows[0] != 0:
            return None
        stack = gather_stage_stack(self.staged, self.grid)
        if self.rank != 0:
            return None
        sd = self.staged.merge(stack, self.staged.shared_state())
        return {"params": bert_to_jax_params(sd), "model_state": {}}


def build_pipeline(args, logger=None) -> PipelineRun:
    """The pipeline path's pieces (JAX's ``run_pipeline`` :185-256); joins
    the process group on a multi-process launch. ``logger`` logs on rank 0
    only."""
    import torch

    from oktopk_tpu_torch.convert import (bert_from_jax_params,
                                          bert_to_jax_params)
    from oktopk_tpu_torch.data import make_dataset
    from oktopk_tpu_torch.launch import data_parallel
    from oktopk_tpu_torch.models.bert import BertConfig
    from oktopk_tpu_torch.models.bert_staged import StagedBertPretrain
    from oktopk_tpu_torch.optim import BertAdam
    from oktopk_tpu_torch.parallel.bert_pipeline import (
        build_pipeline_sparse_train_step, build_pipeline_train_step,
        make_pipeline_grid)

    pp = args.pipeline_stages
    _, dev, comm, workers = data_parallel(args.num_workers, args.device,
                                          args.backend)
    if comm is None:
        workers = args.num_workers or pp
    grid = make_pipeline_grid(pp, workers)
    rank = comm.first_worker if comm is not None else 0
    if rank != 0:
        logger = None               # only rank 0 logs
    if logger and args.compute_dtype != "float32":
        logger.warning("--compute-dtype %s is ignored on the pipeline "
                       "path: it computes in float32, as the JAX "
                       "package's does", args.compute_dtype)
    cfg = {"bert_base": BertConfig.base, "bert_large": BertConfig.large,
           "bert_tiny": BertConfig.tiny}[args.model]()
    if logger:
        logger.info("pipeline BERT: %s over data=%d x pipe=%d on %s%s, "
                    "M=%d", args.model, grid.dp, pp, dev,
                    f" ({workers} processes)" if grid.distributed else "",
                    args.num_microbatches)
    staged = StagedBertPretrain(cfg, pp, stages=grid.stages)
    sd = staged.init_weights(torch.Generator().manual_seed(args.seed))
    if args.resume:
        tree = _maybe_warm_start(
            args, logger, {"params": bert_to_jax_params(sd),
                           "model_state": {}})
        staged.load_split(*staged.split(bert_from_jax_params(
            tree["params"])))
    del sd
    staged.to(dev)
    opt = BertAdam(lr=args.lr, warmup=args.warmup_proportion,
                   t_total=args.num_minibatches)
    M = args.num_microbatches
    if args.compressor != "dense":
        if grid.dp < 2:
            raise SystemExit("sparse pipeline composition needs a data "
                             "axis (more workers than --pipeline-stages) "
                             "— or pass --compressor dense")
        step = build_pipeline_sparse_train_step(
            staged, grid, M, opt, _bert_algo_cfg(args, density=args.density),
            compressor=args.compressor, warmup=False, remat=args.remat)
        if logger:
            logger.info("sparse pipeline: compressor=%s density=%g",
                        args.compressor, args.density)
    else:
        step = build_pipeline_train_step(staged, grid, M, opt,
                                         remat=args.remat)
    global_bs = args.batch_size * grid.dp * M
    data, args.data_meta = make_dataset(
        "wikipedia", args.model, global_bs,
        path=getattr(args, "data_dir", None) or "./data", seed=args.seed,
        seq_len=args.max_seq_length)
    if logger and args.data_meta["synthetic"]:
        logger.warning("Wikipedia corpus not found under %s: synthetic "
                       "MLM/NSP data", args.data_dir)
    return PipelineRun(args, grid, staged, step, data, dev, rank)


def run_pipeline(args) -> int:
    """The pipeline-parallel pretraining path (JAX's :185-290): the
    reference StageRuntime's GPipe-with-flushes mode over a data x pipe
    grid, every stage's gradient through the sparse allreduce."""
    log = logging.getLogger("oktopk_tpu_torch.bert")
    run = build_pipeline(args, log)
    _pretrain_loop(args, log if run.rank == 0 else None, run.train_step,
                   run.checkpoint_payload)
    return 0


# ---- the sequence-parallel path -----------------------------------------

class SeqRun:
    """What ``build_seq`` builds: the grid, the config, the step and the
    batch iterator (the forward is deterministic: no keys)."""

    def __init__(self, args, grid, cfg, step, data, device, rank):
        self.args, self.grid, self.cfg, self.step = args, grid, cfg, step
        self.data, self.device, self.rank = data, device, rank

    def train_step(self):
        """One step on the next global batch; device metrics."""
        return self.step(next(self.data))

    def checkpoint_payload(self):
        """The single-module layout on rank 0 (its first worker's
        parameters; every worker holds the same), None elsewhere."""
        from oktopk_tpu_torch.parallel.bert_seq import tree_to_numpy
        if self.rank != 0:
            return None
        return {"params": tree_to_numpy(self.step.tree()),
                "model_state": {}}


def build_seq(args, logger=None) -> SeqRun:
    """The sequence-parallel path's pieces (JAX's ``run_seq_parallel``
    :374-452); joins the process group on a multi-process launch.
    ``logger`` logs on rank 0 only."""
    import dataclasses

    import torch

    from oktopk_tpu_torch.convert import bert_to_jax_params
    from oktopk_tpu_torch.data import make_dataset
    from oktopk_tpu_torch.launch import data_parallel
    from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from oktopk_tpu_torch.optim import BertAdam
    from oktopk_tpu_torch.parallel.bert_seq import (
        build_seq_sparse_train_step, build_seq_train_step, make_seq_grid,
        tree_to_torch)

    S, dp = args.seq_shards, args.seq_data_shards
    T = args.max_seq_length
    sparse = args.compressor != "dense"
    if T % S:
        raise SystemExit("--max-seq-length must divide by --seq-shards")
    if sparse and dp <= 1:
        raise SystemExit(
            "sparse collectives over a pure seq mesh have no data axis to "
            "reduce over — add --seq-data-shards N for the composed "
            "data x seq mesh, or pass --compressor dense")
    if args.gradient_accumulation_steps != 1 and not (dp > 1 and sparse):
        raise SystemExit("--gradient-accumulation-steps on the seq path "
                         "needs the composed sparse form "
                         "(--seq-data-shards N, sparse --compressor)")
    if args.num_workers not in (None, S * dp):
        raise SystemExit(f"--num-workers {args.num_workers}: the seq path "
                         f"runs --seq-shards x --seq-data-shards = {S * dp}")
    _, dev, comm, _ = data_parallel(None, args.device, args.backend)
    grid = make_seq_grid(S, dp)
    rank = comm.first_worker if comm is not None else 0
    if rank != 0:
        logger = None               # only rank 0 logs
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[args.compute_dtype]
    cfg = {"bert_base": BertConfig.base, "bert_large": BertConfig.large,
           "bert_tiny": BertConfig.tiny}[args.model](dtype=dtype)
    if cfg.max_position < T:
        # a position row for every global position (JAX's :405-408)
        cfg = dataclasses.replace(cfg, max_position=T)
    if logger:
        logger.info("seq-parallel BERT: %s, T=%d over %d shards (T/P=%d "
                    "per worker)%s on %s%s", args.model, T, S, T // S,
                    f", data axis dp={dp} compressor={args.compressor}"
                    if dp > 1 else "", dev,
                    f" ({S * dp} processes)" if grid.distributed else "")
    model = BertForPreTraining(cfg)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    tree = _maybe_warm_start(
        args, logger, {"params": bert_to_jax_params(model.state_dict()),
                       "model_state": {}})
    del model
    params = tree_to_torch(tree["params"])
    del tree
    opt = BertAdam(lr=args.lr, warmup=args.warmup_proportion,
                   t_total=args.num_minibatches)
    A = args.gradient_accumulation_steps
    if sparse:
        step = build_seq_sparse_train_step(
            cfg, grid, params, opt, _bert_algo_cfg(args,
                                                   density=args.density),
            compressor=args.compressor, warmup=False, accum_steps=A,
            device=dev)
    else:
        step = build_seq_train_step(cfg, grid, params, opt, device=dev)
    del params
    # --batch-size is per data row per microstep (JAX's :450-461)
    data, args.data_meta = make_dataset(
        "wikipedia", args.model, args.batch_size * dp * A,
        path=getattr(args, "data_dir", None) or "./data", seed=args.seed,
        seq_len=T)
    if logger and args.data_meta["synthetic"]:
        logger.warning("Wikipedia corpus not found under %s: synthetic "
                       "MLM/NSP data", args.data_dir)
    return SeqRun(args, grid, cfg, step, data, dev, rank)


def _pretrain_loop(args, logger, step_fn, checkpoint_payload):
    """The loop, log and checkpoint tail of the whole-model parallel paths
    (JAX's :340-371): ``step_fn() -> metrics`` once a step, ``iter %d loss
    %.4f %.3fs/it`` every ``--log-every`` steps and a ``done`` line; then,
    under ``--ckpt-dir``, every process calls ``checkpoint_payload()`` (a
    gather may need them all) and the one that gets a payload, rank 0,
    writes it."""
    from oktopk_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.time()
    m = None
    for i in range(args.num_minibatches):
        m = step_fn()
        if (i + 1) % args.log_every == 0 and logger:
            logger.info("iter %d loss %.4f %.3fs/it", i + 1,
                        float(m["loss"]), (time.time() - t0)
                        / args.log_every)
            t0 = time.time()
    if m is not None and logger:
        logger.info("done: loss %r%s", float(m["loss"]),
                    f" comm volume/step {float(m['comm_volume']):.0f} "
                    "elems" if "comm_volume" in m else "")
    payload = checkpoint_payload() if args.ckpt_dir else None
    if payload is not None:
        path = save_checkpoint(args.ckpt_dir, payload, args.num_minibatches)
        if logger:
            logger.info("saved %s checkpoint %s", "moe_params-layout"
                        if "moe_params" in payload else
                        "single-module-layout", path)
    return m


def run_seq_parallel(args) -> int:
    """Sequence-parallel pretraining (JAX's :374-463): the token axis
    sharded over a seq grid with ring attention, composed with the sparse
    allreduce over a data axis."""
    log = logging.getLogger("oktopk_tpu_torch.bert")
    run = build_seq(args, log)
    _pretrain_loop(args, log if run.rank == 0 else None, run.train_step,
                   run.checkpoint_payload)
    return 0


# ---- the expert-parallel path ---------------------------------------------

class MoERun:
    """What ``build_moe`` builds: the grid, the configs, the step and the
    batch iterator (the forward is deterministic: no keys)."""

    def __init__(self, args, grid, cfg, mcfg, step, data, device, rank):
        self.args, self.grid, self.cfg, self.mcfg = args, grid, cfg, mcfg
        self.step, self.data, self.device, self.rank = step, data, \
            device, rank

    def train_step(self):
        """One step on the next global batch; device metrics."""
        return self.step(next(self.data))

    def checkpoint_payload(self):
        """JAX's ``moe_params`` layout on rank 0 (``layers``: every expert,
        gathered over data row 0's expert group; ``shared``: its first
        worker's copy), None elsewhere."""
        from oktopk_tpu_torch.parallel.bert_seq import tree_to_numpy
        if self.grid.data_rows[0] != 0:
            return None
        stack = self.step.moe_stack()
        if self.rank != 0:
            return None
        return {"moe_params": {"layers": tree_to_numpy(stack),
                               "shared": tree_to_numpy(self.step.trees()[1])},
                "model_state": {}}


def build_moe(args, logger=None) -> MoERun:
    """The expert-parallel path's pieces (JAX's ``run_expert_parallel``
    :466-536); joins the process group on a multi-process launch.
    ``logger`` logs on rank 0 only."""
    import torch

    from oktopk_tpu_torch.convert import bert_to_jax_params
    from oktopk_tpu_torch.data import make_dataset
    from oktopk_tpu_torch.launch import data_parallel
    from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from oktopk_tpu_torch.optim import BertAdam
    from oktopk_tpu_torch.parallel.bert_moe import (
        MoEConfig, build_moe_sparse_train_step, build_moe_train_step,
        experts_from_dense, make_moe_grid)
    from oktopk_tpu_torch.parallel.bert_seq import (tree_to_numpy,
                                                    tree_to_torch)

    P, dpx = args.expert_shards, args.expert_data_shards
    E = args.num_experts or P
    sparse = args.compressor != "dense"
    if E % P:
        raise SystemExit("--num-experts must divide by --expert-shards")
    if sparse and dpx <= 1:
        raise SystemExit(
            "sparse collectives over a pure expert mesh have no data axis "
            "to reduce over — add --expert-data-shards N for the composed "
            "data x expert mesh, or pass --compressor dense")
    if args.gradient_accumulation_steps != 1:
        raise SystemExit("--gradient-accumulation-steps is not wired into "
                         "the expert-parallel path yet")
    if args.num_workers not in (None, P * dpx):
        raise SystemExit(f"--num-workers {args.num_workers}: the expert "
                         "path runs --expert-shards x --expert-data-shards "
                         f"= {P * dpx}")
    _, dev, comm, _ = data_parallel(None, args.device, args.backend)
    grid = make_moe_grid(P, dpx)
    rank = comm.first_worker if comm is not None else 0
    if rank != 0:
        logger = None               # only rank 0 logs
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[args.compute_dtype]
    cfg = {"bert_base": BertConfig.base, "bert_large": BertConfig.large,
           "bert_tiny": BertConfig.tiny}[args.model](dtype=dtype)
    mcfg = MoEConfig(num_experts=E, capacity_factor=args.capacity_factor)
    if logger:
        logger.info("expert-parallel MoE BERT: %s, %d experts over %d "
                    "shards (cap factor %.2f)%s on %s%s", args.model, E, P,
                    args.capacity_factor,
                    f", data axis dp={dpx} compressor={args.compressor}"
                    if dpx > 1 else "", dev,
                    f" ({P * dpx} processes)" if grid.distributed else "")
    model = BertForPreTraining(cfg)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    dense = tree_to_torch(bert_to_jax_params(model.state_dict()))
    del model
    # gate_scale > 0: a zero gate ties every token to expert 0 and the
    # capacity then drops most of the batch (bert_moe.py)
    moe, shared = experts_from_dense(dense, E, gate_scale=0.02,
                                     seed=args.seed)
    del dense
    if args.resume:
        tree = _maybe_warm_start(
            args, logger, {"moe_params": {"layers": tree_to_numpy(moe),
                                          "shared": tree_to_numpy(shared)},
                           "model_state": {}})
        moe = tree_to_torch(tree["moe_params"]["layers"])
        shared = tree_to_torch(tree["moe_params"]["shared"])
        del tree
    opt = BertAdam(lr=args.lr, warmup=args.warmup_proportion,
                   t_total=args.num_minibatches)
    if sparse:
        step = build_moe_sparse_train_step(
            cfg, mcfg, grid, moe, shared, opt,
            _bert_algo_cfg(args, density=args.density),
            compressor=args.compressor, warmup=False, device=dev)
    else:
        step = build_moe_train_step(cfg, mcfg, grid, moe, shared, opt,
                                    device=dev)
    del moe, shared
    # --batch-size is per worker: the global batch spans data x expert
    data, args.data_meta = make_dataset(
        "wikipedia", args.model, args.batch_size * P * dpx,
        path=getattr(args, "data_dir", None) or "./data", seed=args.seed,
        seq_len=args.max_seq_length)
    if logger and args.data_meta["synthetic"]:
        logger.warning("Wikipedia corpus not found under %s: synthetic "
                       "MLM/NSP data", args.data_dir)
    return MoERun(args, grid, cfg, mcfg, step, data, dev, rank)


def run_expert_parallel(args) -> int:
    """Expert-parallel MoE pretraining (JAX's :466-566): Switch top-1 MoE
    FFNs with all_to_all dispatch over an expert grid, composed with the
    sparse allreduce over a data axis."""
    log = logging.getLogger("oktopk_tpu_torch.bert")
    run = build_moe(args, log)
    _pretrain_loop(args, log if run.rank == 0 else None, run.train_step,
                   run.checkpoint_payload)
    return 0


def _maybe_warm_start(args, logger, template):
    """Params-only warm start (JAX's :302-338): the saved payload restored
    into ``template``; every leaf must keep its shape, and a file that
    restores nothing (another path's payload layout) is refused.
    Optimizer and sparse state start fresh."""
    if not args.resume:
        return template
    import numpy as np

    from oktopk_tpu_torch.train.checkpoint import restore_checkpoint
    from oktopk_tpu_torch.utils.flatten import tree_items
    try:
        restored, rstep = restore_checkpoint(args.resume, template)
    except ValueError as e:          # another path's payload layout
        raise SystemExit(f"--resume {args.resume}: {e}") from e
    changed = False
    for (pa, a), (_, b) in zip(tree_items(template), tree_items(restored)):
        if np.shape(a) != np.shape(b):
            raise SystemExit(
                f"--resume leaf {'/'.join(pa)} has shape {np.shape(b)} but "
                f"this model expects {np.shape(a)} (wrong --model for the "
                "checkpoint?)")
        if not changed and not np.array_equal(np.asarray(a),
                                              np.asarray(b)):
            changed = True
    if not changed:
        raise SystemExit(
            f"--resume {args.resume} restored nothing — its payload layout "
            "does not match this path's checkpoint format")
    if logger:
        logger.info("warm-started from %s (saved at step %d; optimizer "
                    "and sparse state start fresh)", args.resume, rstep)
    return restored


if __name__ == "__main__":
    sys.exit(main())
