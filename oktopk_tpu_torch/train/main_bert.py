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
rank first). The sequence- and expert-parallel paths are not ported
yet: their flags raise ``NotImplementedError`` unless left at their
defaults (ROADMAP.md).

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

One process holds its P workers stacked on its device
(``--num-workers``, default 1); a multi-process launch runs one worker
per process over a ``torch.distributed`` group, as ``main_trainer``
does (``launch.data_parallel``), each with its own dropout stream
(``train/trainer.py``). Only rank 0 logs.

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
        --pipeline-stages 2 --num-workers 4 --num-microbatches 4 \\
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

# flag: its default; any other value needs a path the port lacks
UNPORTED = {"seq_shards": 1, "expert_shards": 1}


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
    # the JAX package's other paths, not ported yet
    p.add_argument("--seq-shards", type=int, default=1)
    p.add_argument("--expert-shards", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None,
                   help="write a checkpoint here at the end")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory (or file) to resume from")
    p.add_argument("--handle-preemption", action="store_true",
                   help="stop between steps on SIGINT/SIGTERM/SIGUSR2 "
                        "(SIGUSR1 also requeues), park the state and exit "
                        "with code 3; resume a parked state on start")
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


def _refuse_unported(args) -> None:
    for flag, default in UNPORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to "
                "oktopk_tpu_torch yet (ROADMAP.md)")


def build_trainer(args, model_kwargs=None):
    """(Trainer, batch iterator) of the data-parallel path; joins the
    process group on a multi-process launch. The iterator is
    ``make_dataset("wikipedia", ...)``'s; ``args.data_meta`` holds its
    meta (``synthetic`` True without the corpus)."""
    from oktopk_tpu_torch.config import TrainConfig
    from oktopk_tpu_torch.data import make_dataset
    from oktopk_tpu_torch.launch import data_parallel
    from oktopk_tpu_torch.train.trainer import Trainer

    _refuse_unported(args)
    if args.pipeline_stages > 1:
        raise ValueError("--pipeline-stages runs the pipeline path "
                         "(build_pipeline / run_pipeline), not the "
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
    _refuse_unported(args)
    if args.pipeline_stages > 1:
        return run_pipeline(args)
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

    _refuse_unported(args)
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
    from oktopk_tpu_torch.convert import bert_to_jax_params
    from oktopk_tpu_torch.parallel.bert_pipeline import gather_stage_stack
    from oktopk_tpu_torch.train.checkpoint import save_checkpoint

    log = logging.getLogger("oktopk_tpu_torch.bert")
    run = build_pipeline(args, log)
    logger = log if run.rank == 0 else None
    t0 = time.time()
    m = None
    for i in range(args.num_minibatches):
        m = run.train_step()
        if (i + 1) % args.log_every == 0 and logger:
            logger.info("iter %d loss %.4f %.3fs/it", i + 1,
                        float(m["loss"]), (time.time() - t0)
                        / args.log_every)
            t0 = time.time()
    if m is not None and logger:
        logger.info("done: loss %r%s", float(m["loss"]),
                    f" comm volume/step {float(m['comm_volume']):.0f} "
                    "elems" if "comm_volume" in m else "")
    if args.ckpt_dir and run.grid.data_rows[0] == 0:
        # data row 0's pipe group gathers its stages to rank 0, which
        # writes the single-module layout
        stack = gather_stage_stack(run.staged, run.grid)
        if run.rank == 0:
            sd = run.staged.merge(stack, run.staged.shared_state())
            path = save_checkpoint(
                args.ckpt_dir, {"params": bert_to_jax_params(sd),
                                "model_state": {}}, args.num_minibatches)
            logger.info("saved single-module-layout checkpoint %s", path)
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
