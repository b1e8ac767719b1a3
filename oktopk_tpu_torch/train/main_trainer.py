"""Command-line entry point for data-parallel training with a sparse
allreduce: the CNN zoo on CIFAR-10, MNIST and ImageNet, DeepSpeech on
AN4 (CTC) and the PTB LSTM.

Counterpart of ``oktopk_tpu/train/main_trainer.py``: the flags of its
:25-50, :130-135 that the port serves, under the same names
(``--compressor`` takes every registry name but ``hierarchical``;
``--compute-dtype float32|bfloat16``), the
checkpoint and preemption flags of :148-169 (``--ckpt-dir``,
``--ckpt-every``, ``--ckpt-async``, ``--ckpt-keep``, ``--ckpt-force``,
``--resume``, ``--handle-preemption``), the run journal's of :95-139
(``--obs``, ``--obs-journal``, ``--obs-trace-on-anomaly``,
``--obs-trace-steps``, ``--obs-quality``,
``--obs-quality-every``, ``--obs-regress-key``, ``--sigma-scale``,
``--logdir``, ``--trace-at``, ``--trace-steps``, ``--phase-timers``),
the resilience flags of :63-105 (``--resilience``,
``--resilience-strikes``, ``--resilience-abs-limit``,
``--resilience-journal``, ``--resilience-density-backoff`` and its
five knobs, ``--resilience-feedback`` and its three knobs: the fault ->
autotune loop, which needs ``--obs``), the autotuner's of :51-62
(``--autotune``, ``--autotune-candidates``, ``--autotune-trial-steps``,
``--autotune-retune-every``, ``--autotune-journal``; rank 0 alone writes
the decision journal, every rank runs the same trials and takes the
same plan), plus ``--num-workers``, ``--device`` and ``--backend``.
``--dataset`` is ``cifar10``, ``mnist`` or ``imagenet`` for the image
models, ``an4`` (``lstman4``, ``lstman4_tiny``) or ``ptb`` (``lstm``,
``lstm_tiny``).
The batches come from ``data.make_dataset`` and the files under
``--data-dir`` (default ``$OKTOPK_DATA_DIR``, else ``./data``): the
CIFAR-10 pickle batches, the MNIST idx files, the ImageNet HDF5 file or
the PTB text or the AN4 manifests and WAV files; without them, the
synthetic iterator of the model's family (201 spectrogram frames, 35
tokens), with a warning, as the JAX package's command line falls back.
An epoch is the dataset's examples (50,000 for the synthetic data, 948
for AN4) over the global batch. Any other dataset raises.

The loop is the JAX command line's (:320-387): chunks of at most an
epoch; after a chunk that ends on a multiple of ``--ckpt-every``, a
checkpoint in the JAX package's format (``train/checkpoint.py``; written
by rank 0, the state gathered from every rank first), on a background
thread with ``--ckpt-async`` and pruned to the newest ``--ckpt-keep``;
with ``--resilience`` each checkpoint carries the supervisor's state
(``extra``), is marked qualified or not, and is registered as a restore
target (JAX :272-285, :350-367, :380).
``--resume DIR`` restores the newest verified checkpoint (the step
counter, parameters, optimizer and sparse state; the data iterator and
the dropout key chain start again from ``--seed``, as in the JAX
package, H20). ``--handle-preemption`` stops between steps on SIGINT,
SIGTERM, SIGUSR2 or SIGUSR1, parks the state (``train/preemption.py``),
and exits with code 3; a later run with the flag resumes from it.
With ``OKTOPK_PROFILING_GRAD=1`` (``settings.PROFILING_GRAD``) each
chunk ends with a dump of the gradient stream's state, as the JAX
command line's (:332-345): ``<logdir>/<slug>/grad_dumps/iter_<step>.npz``
with ``residual`` [P, n], ``local_threshold`` and ``global_threshold``
[P] (every rank's rows gathered to rank 0, which writes it; over several
buckets the residual in the flat layout and the thresholds [P, buckets]).

One process holds its P workers stacked on its device
(``--num-workers``, default 1). A multi-process launch (``torchrun``,
SLURM, OpenMPI or the ``OKTOPK_*`` variables, ``launch.py``) runs one
worker per process over a ``torch.distributed`` group: ``--num-workers``
is then the world size, the device ``cuda:{local_rank}`` unless
``--device`` names one, and the backend nccl on a card, gloo on the CPU,
unless ``--backend`` names one (gloo on CUDA tensors only when named).

The run writes under ``<logdir>/<slug>/`` (the slug is
``TrainConfig.experiment_slug``), as the JAX command line does
(:241-251, :300-315): every rank its log ``rank{i}.log`` (rank 0 also
logs to the console, the others to their file alone); rank 0 the
per-step metrics ``scalars.csv``, with ``--obs`` the run journal
``run_journal.jsonl`` (or ``--obs-journal``; the other ranks keep theirs
in memory), and with ``--trace-at S`` a ``torch.profiler`` Chrome trace
of steps S to S + ``--trace-steps`` - 1 under ``trace/``.
``--phase-timers`` splits each step into data wait and the step (the
card synchronised) and logs the table every ``--log-every`` steps.
``--obs-regress-key`` baselines the step time against the
``BENCH_r*.json`` records at the repository root, which are the JAX
package's measurements, not the card's.

Examples:
    python -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 \\
        --batch-size 16 --num-workers 4 --density 0.02 --max-iters 20 \\
        --compressor topkA --nsteps-update 2 --grad-clip 5.0
    python -m oktopk_tpu_torch.train.main_trainer --dnn resnet50 \\
        --dataset imagenet --batch-size 32 --num-workers 4 --density 0.02
    python -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 \\
        --num-workers 4 --compute-dtype bfloat16 --max-iters 20
    python -m oktopk_tpu_torch.train.main_trainer --dnn resnet20 \\
        --dataset cifar10 --data-dir /path/to/data --num-workers 4
    python -m oktopk_tpu_torch.train.main_trainer --dnn lstman4 \\
        --dataset an4 --batch-size 2 --num-workers 4 --grad-clip 400 \\
        --lr 3e-4 --max-iters 20
    python -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 \\
        --num-workers 4 --max-iters 64 --obs --obs-quality \\
        --phase-timers --trace-at 10 --logdir logs
    torchrun --standalone --nproc-per-node 4 \\
        -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 --max-iters 20
    python -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 \\
        --num-workers 4 --max-iters 100 --ckpt-dir ckpts --ckpt-every 50 \\
        --handle-preemption
    python -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 \\
        --num-workers 4 --max-iters 100 --resilience \\
        --resilience-density-backoff --ckpt-dir ckpts --ckpt-every 50
    python -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 \\
        --num-workers 4 --num-buckets 2 --max-iters 20 --autotune \\
        --autotune-candidates dense,oktopk --obs --resilience-feedback
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

from oktopk_tpu_torch.collectives.registry import (
    TWO_LEVEL_ONLY,
    list_algorithms,
)
from oktopk_tpu_torch.data.loaders import SYNTHETIC_EXAMPLES

# the workload family each dataset trains
DATASETS = {"cifar10": "image", "mnist": "image", "imagenet": "image",
            "an4": "ctc", "ptb": "lm"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dnn", default="vgg16")
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--data-dir", default=None,
                   help="dataset files (default: $OKTOPK_DATA_DIR, else "
                        "./data); synthetic batches where they are missing")
    p.add_argument("--batch-size", type=int, default=16,
                   help="per-worker batch size")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--nesterov", action="store_true")
    p.add_argument("--max-epochs", type=int, default=161)
    p.add_argument("--max-iters", type=int, default=0,
                   help="if set, run exactly this many iterations")
    p.add_argument("--nsteps-update", type=int, default=1,
                   help="local microbatches accumulated per allreduce")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the model's computation dtype; parameters, "
                        "gradients, the collective and the optimizer stay "
                        "float32")
    p.add_argument("--wire-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num-buckets", type=int, default=1)
    p.add_argument("--compressor", default="oktopk",
                   choices=list_algorithms(),
                   help="every bucket's collective; with --autotune the "
                        "fallback of buckets not planned yet")
    p.add_argument("--autotune", action="store_true",
                   help="pick each bucket's collective and density at run "
                        "time (autotune/: calibrated cost-model prior -> "
                        "timed trial posterior, with hysteresis)")
    p.add_argument("--autotune-candidates", default="dense,oktopk",
                   help="comma-separated registry names to trial")
    p.add_argument("--autotune-trial-steps", type=int, default=3,
                   help="timed steps per candidate per bucket")
    p.add_argument("--autotune-retune-every", type=int, default=0,
                   help="steps between re-tunes (0 = tune once)")
    p.add_argument("--autotune-journal", default=None,
                   help="JSONL decision-journal path (rank 0 writes it)")
    p.add_argument("--density", type=float, default=0.02)
    p.add_argument("--sigma-scale", type=float, default=2.5,
                   help="the reference's sigma scale (no collective reads "
                        "it)")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="global-norm clip of each worker's local gradient")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="dense warmup iterations (default: reference's 512)")
    p.add_argument("--log-every", type=int, default=50)
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
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="checkpoint every N iterations (0 = off)")
    p.add_argument("--ckpt-async", action="store_true",
                   help="write checkpoints on a background thread: the "
                        "step loop pays the copy to host memory only")
    p.add_argument("--ckpt-keep", type=int, default=0,
                   help="retention: keep the newest N checkpoints plus "
                        "the newest qualified one (0 = keep everything)")
    p.add_argument("--ckpt-force", action="store_true",
                   help="restore a checkpoint even when most of its "
                        "leaves mismatch the model")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory (or file) to resume from")
    p.add_argument("--handle-preemption", action="store_true",
                   help="stop between steps on SIGINT/SIGTERM/SIGUSR2 "
                        "(SIGUSR1 also requeues), park the state and exit "
                        "with code 3; resume a parked state on start")
    p.add_argument("--obs", action="store_true",
                   help="the run journal (obs/): per-step metrics, phase "
                        "timings, quality flushes and volume reports in "
                        "one JSONL file")
    p.add_argument("--obs-journal", default=None,
                   help="run-journal path (default: "
                        "<logdir>/<slug>/run_journal.jsonl, rank 0 only)")
    p.add_argument("--obs-trace-on-anomaly", action="store_true",
                   help="arm a bounded torch.profiler window on "
                        "guard_trip/fallback events and breached quality "
                        "rollups (obs/tracing.py): a Chrome trace per "
                        "rank under traces/ beside the journal")
    p.add_argument("--obs-trace-steps", type=int, default=3,
                   help="steps per anomaly-triggered trace window")
    p.add_argument("--obs-regress-key", default=None,
                   help="BENCH_r*.json key (e.g. oktopk_ms; the JAX "
                        "package's records) to baseline step-time "
                        "regression checks against")
    p.add_argument("--obs-quality", action="store_true",
                   help="the step's quality taps: per-bucket compression "
                        "error, residual growth, effective density, "
                        "threshold drift and index churn in device-side "
                        "rings, journalled every --obs-quality-every "
                        "steps")
    p.add_argument("--obs-quality-every", type=int, default=32,
                   help="quality ring capacity and flush cadence (steps)")
    p.add_argument("--resilience", action="store_true",
                   help="the numeric-health guard and supervisor "
                        "(resilience/): a psum-agreed skip of anomalous "
                        "steps with every state rolled back, per-bucket "
                        "dense fallback after repeated strikes, restore "
                        "from the last good checkpoint on divergence")
    p.add_argument("--resilience-strikes", type=int, default=3,
                   help="guard trips on a bucket before it falls back "
                        "to the dense collective")
    p.add_argument("--resilience-abs-limit", type=float, default=1e18,
                   help="reduced-gradient magnitude treated as anomalous "
                        "even while finite (wire bit-flips land ~1e38)")
    p.add_argument("--resilience-journal", default=None,
                   help="JSONL health-journal path (rank 0 writes it)")
    p.add_argument("--resilience-feedback", action="store_true",
                   help="fault->autotune feedback: a sustained stream of "
                        "regression/guard_trip events forces an autotune "
                        "re-calibrate + re-tune against the degraded "
                        "fabric (resilience/feedback.py; needs --obs)")
    p.add_argument("--resilience-feedback-window", type=int, default=32,
                   help="steps a feedback signal stays live in the vote")
    p.add_argument("--resilience-feedback-signals", type=int, default=3,
                   help="signals within the window needed to force a "
                        "re-tune")
    p.add_argument("--resilience-feedback-cooldown", type=int, default=64,
                   help="steps between forced re-tunes")
    p.add_argument("--resilience-density-backoff", action="store_true",
                   help="guard-aware density backoff: repeated "
                        "near-abs-limit/guard-skip steps back the "
                        "effective density off (bounded, hysteretic, "
                        "journalled)")
    p.add_argument("--resilience-near-ratio", type=float, default=0.1,
                   help="fraction of abs-limit counted as guard pressure")
    p.add_argument("--resilience-backoff-steps", type=int, default=3,
                   help="pressured steps before one backoff level")
    p.add_argument("--resilience-backoff-factor", type=float, default=0.5,
                   help="density multiplier per backoff level")
    p.add_argument("--resilience-backoff-max-level", type=int, default=3,
                   help="deepest backoff level")
    p.add_argument("--resilience-clean-streak", type=int, default=8,
                   help="clean steps before re-advancing one level")
    p.add_argument("--logdir", default="./logs",
                   help="run directory root: <logdir>/<slug>/ holds the "
                        "rank logs, scalars.csv, the journal and traces")
    p.add_argument("--trace-at", type=int, default=0,
                   help="capture a torch.profiler Chrome trace from this "
                        "step (0 = off)")
    p.add_argument("--trace-steps", type=int, default=3)
    p.add_argument("--phase-timers", action="store_true",
                   help="log the data-wait vs step phase table every "
                        "--log-every steps")
    args = p.parse_args(argv)
    if args.compressor == "hierarchical":
        p.error(TWO_LEVEL_ONLY)
    return args


def configs(args, workers: int):
    """(TrainConfig, OkTopkConfig) of the parsed flags for ``workers``
    workers, as the JAX command line builds them (:199-236, :253-256)."""
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig

    cfg = TrainConfig(
        dnn=args.dnn, dataset=args.dataset, batch_size=args.batch_size,
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        nesterov=args.nesterov, max_epochs=args.max_epochs,
        nsteps_update=args.nsteps_update, compressor=args.compressor,
        density=args.density, seed=args.seed, num_workers=workers,
        grad_clip=args.grad_clip, num_buckets=args.num_buckets,
        compute_dtype=args.compute_dtype, sigma_scale=args.sigma_scale,
        autotune=args.autotune,
        autotune_candidates=tuple(
            s for s in args.autotune_candidates.split(",") if s),
        autotune_trial_steps=args.autotune_trial_steps,
        autotune_retune_every=args.autotune_retune_every,
        autotune_journal=args.autotune_journal,
        obs=args.obs, obs_regress_key=args.obs_regress_key,
        obs_trace_on_anomaly=args.obs_trace_on_anomaly,
        obs_trace_steps=args.obs_trace_steps,
        obs_quality=args.obs_quality,
        obs_quality_every=args.obs_quality_every,
        resilience=args.resilience,
        resilience_strikes=args.resilience_strikes,
        resilience_abs_limit=args.resilience_abs_limit,
        resilience_journal=args.resilience_journal,
        resilience_feedback=args.resilience_feedback,
        resilience_feedback_window=args.resilience_feedback_window,
        resilience_feedback_signals=args.resilience_feedback_signals,
        resilience_feedback_cooldown=args.resilience_feedback_cooldown,
        resilience_density_backoff=args.resilience_density_backoff,
        resilience_near_ratio=args.resilience_near_ratio,
        resilience_backoff_steps=args.resilience_backoff_steps,
        resilience_backoff_factor=args.resilience_backoff_factor,
        resilience_backoff_max_level=args.resilience_backoff_max_level,
        resilience_clean_streak=args.resilience_clean_streak)
    algo_cfg = OkTopkConfig(sigma_scale=args.sigma_scale,
                            wire_dtype=args.wire_dtype)
    if args.warmup_steps is not None:
        algo_cfg = algo_cfg.replace(warmup_steps=args.warmup_steps)
    return cfg, algo_cfg


def build_trainer(args, config_overrides=None, algo_overrides=None,
                  fault_plan=None):
    """(Trainer, batch iterator, ProcessEnv, data meta): joins the process
    group on a multi-process launch (``launch.maybe_initialize``) and puts
    the trainer on ``ProcessGroupComm`` there, else on its stacked
    workers; the batches are ``make_dataset``'s (``meta["synthetic"]``
    True without the files). With ``--obs`` rank 0's journal is
    ``--obs-journal``, else ``<logdir>/<slug>/run_journal.jsonl``; the
    health journal (``--resilience-journal``) is rank 0's alone too.
    So is the decision journal (``--autotune-journal``). The anomaly
    traces of every rank go to ``traces/`` beside rank 0's journal, one
    file a rank.
    ``config_overrides`` / ``algo_overrides`` replace fields of the
    ``TrainConfig`` / ``OkTopkConfig`` the flags give (a drill's
    cadences), and ``fault_plan`` goes to the Trainer."""
    from oktopk_tpu_torch import launch
    from oktopk_tpu_torch.data import make_dataset
    from oktopk_tpu_torch.train.trainer import Trainer, workload

    if args.dataset not in DATASETS:
        raise NotImplementedError(
            f"dataset {args.dataset!r} is not ported yet (ROADMAP.md)")
    if DATASETS[args.dataset] != workload(args.dnn):
        raise ValueError(f"--dnn {args.dnn} does not train on "
                         f"--dataset {args.dataset}")
    penv, dev, comm, workers = launch.data_parallel(
        args.num_workers, args.device, args.backend)
    cfg, algo_cfg = configs(args, workers)
    cfg = dataclasses.replace(cfg, **(config_overrides or {}))
    algo_cfg = algo_cfg.replace(**(algo_overrides or {}))
    journal = args.obs_journal or os.path.join(run_dir(args, cfg),
                                               "run_journal.jsonl")
    if args.obs and penv.is_coordinator:
        cfg = dataclasses.replace(cfg, obs_journal=journal)
    if args.obs_trace_on_anomaly and cfg.obs_trace_dir is None:
        cfg = dataclasses.replace(cfg, obs_trace_dir=os.path.join(
            os.path.dirname(os.path.abspath(journal)), "traces"))
    if not penv.is_coordinator:
        cfg = dataclasses.replace(cfg, resilience_journal=None,
                                  autotune_journal=None)
    trainer = Trainer(cfg, algo_cfg=algo_cfg, device=dev, comm=comm,
                      fault_plan=fault_plan)
    global_bs = args.batch_size * workers * args.nsteps_update
    data, meta = make_dataset(args.dataset, args.dnn, global_bs,
                              path=args.data_dir, seed=args.seed)
    return trainer, data, penv, meta


def run_dir(args, cfg) -> str:
    """``<logdir>/<slug>``: the run's logs, scalars, journal and traces."""
    return os.path.join(args.logdir, cfg.experiment_slug())


def run_logger(rundir: str, rank: int):
    """(logger, the handlers added to it): rank 0's logs to the console
    and ``rank0.log``, any other rank's to its ``rank{i}.log`` alone
    (``utils.logging.get_logger``). The caller removes the handlers when
    the run ends."""
    from oktopk_tpu_torch.utils.logging import get_logger

    name = "oktopk_tpu_torch" if rank == 0 else f"oktopk_tpu_torch.rank{rank}"
    before = list(logging.getLogger(name).handlers)
    logger = get_logger(name, os.path.join(rundir, f"rank{rank}.log"),
                        console=rank == 0)
    return logger, [h for h in logger.handlers if h not in before]


def iterations(args, workers: int,
               num_examples: int = SYNTHETIC_EXAMPLES) -> int:
    """``--max-iters``, else ``--max-epochs`` epochs of ``num_examples``
    at the global batch."""
    global_bs = args.batch_size * workers * args.nsteps_update
    return args.max_iters or args.max_epochs * max(
        1, num_examples // global_bs)


def resume(trainer, args, logger) -> int:
    """The step to start from: ``--resume``'s newest verified checkpoint,
    else (with ``--handle-preemption``) a parked state, else 0; the
    state goes into the trainer, and the supervisor re-arms from the
    same file's ``extra`` (its strikes and dense fallbacks)."""
    from oktopk_tpu_torch.train.checkpoint import restore_checkpoint
    from oktopk_tpu_torch.train.preemption import (interrupted_state_path,
                                                   load_interrupted_state)

    template = trainer.train_state(gather=False)
    if args.resume:
        tree, start = restore_checkpoint(args.resume, template,
                                         bus=trainer.bus,
                                         force=args.ckpt_force)
        what = f"resumed from {args.resume}"
        source = args.resume
    else:
        parked = (load_interrupted_state(template)
                  if args.handle_preemption else None)
        if parked is None:
            return 0
        tree, start = parked
        what = "resumed interrupted state"
        source = interrupted_state_path() + ".d"
    trainer.load_train_state(tree)
    trainer.restore_supervisor(source)
    if logger:
        logger.info("%s at iter %d", what, start)
    return start


def main(argv=None) -> int:
    args = parse_args(argv)
    # cuBLAS repeats its sums only with this set before the CUDA context
    # exists (the Trainer makes cuDNN deterministic)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    trainer, data, penv, meta = build_trainer(args)
    rundir = run_dir(args, trainer.cfg)
    logger, handlers = run_logger(rundir, penv.process_id)
    try:
        return _run(args, trainer, data, penv, meta, logger, rundir)
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()


def save_and_register(trainer, args, step: int, rank0: bool,
                      checkpointer=None, logger=None) -> str:
    """Save the train state at ``step`` under ``args.ckpt_dir`` (through
    ``checkpointer`` when given, else written here with ``--ckpt-keep``'s
    retention) with the supervisor's ``extra`` and ``qualified`` bit, and
    register it as a restore candidate. Every rank calls it: the export
    gathers every rank's rows and rank 0 writes them, and every rank
    registers the same file (its path is the directory's and the step's),
    so every rank's supervisor holds the same restore target."""
    from oktopk_tpu_torch.train.checkpoint import (checkpoint_path,
                                                   save_checkpoint)
    from oktopk_tpu_torch.train.durable import apply_retention

    t0 = time.perf_counter()
    state = trainer.train_state()       # every rank: gathers
    extra = trainer.supervisor_extra()
    qualified = trainer.checkpoint_qualified
    path = checkpoint_path(args.ckpt_dir, step)
    if checkpointer is not None:
        checkpointer.save(state, step, extra=extra, qualified=qualified)
    elif rank0:
        save_checkpoint(args.ckpt_dir, state, step, extra=extra,
                        qualified=qualified)
        if args.ckpt_keep:
            apply_retention(args.ckpt_dir, keep_last=args.ckpt_keep)
        if logger is not None:
            logger.info("checkpoint %s: %d B in %.3f s", path,
                        os.path.getsize(path), time.perf_counter() - t0)
    trainer.note_checkpoint(path, step)
    return path


def dump_grad_stream(trainer, rundir: str, step: int, rank0: bool):
    """The JAX command line's ``PROFILING_GRAD`` snapshot (:332-345):
    the gradient stream's residual (the untransmitted gradient mass) and
    thresholds, every worker's rows, to
    ``<rundir>/grad_dumps/iter_<step>.npz`` in its layout (``residual``
    [P, n], ``local_threshold`` and ``global_threshold`` [P], float32;
    over several buckets the residual in the flat layout, the thresholds
    [P, buckets]). Every rank calls it (the rows are gathered to rank 0,
    a collective); rank 0 writes and returns the path, the others None."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.convert import _rows

    gs = trainer.grad_step
    flat_order = sorted(range(len(gs.states)), key=lambda b: gs.ranges[b][0])
    residual = torch.cat([gs.states[b].residual for b in flat_order], 1)
    lt = torch.stack([s.local_threshold for s in gs.states], 1)
    gt = torch.stack([s.global_threshold for s in gs.states], 1)
    nb = lt.shape[1]
    packed = _rows(trainer, torch.cat([residual, lt, gt], 1), gather=True)
    if not rank0:
        return None
    host = packed.cpu().numpy()
    n = residual.shape[1]
    fields = {"residual": host[:, :n], "local_threshold": host[:, n:n + nb],
              "global_threshold": host[:, n + nb:]}
    if nb == 1:
        for k in ("local_threshold", "global_threshold"):
            fields[k] = fields[k][:, 0]
    dump_dir = os.path.join(rundir, "grad_dumps")
    os.makedirs(dump_dir, exist_ok=True)
    path = os.path.join(dump_dir, f"iter_{step}.npz")
    np.savez_compressed(path, **{k: np.ascontiguousarray(v)
                                 for k, v in fields.items()})
    return path


def _run(args, trainer, data, penv, meta, logger, rundir) -> int:
    from oktopk_tpu_torch import settings
    from oktopk_tpu_torch.train import preemption
    from oktopk_tpu_torch.train.durable import AsyncCheckpointer
    from oktopk_tpu_torch.utils.profiling import (MetricWriter, PhaseTimers,
                                                  TraceWindow,
                                                  device_memory_stats)

    rank0 = penv.is_coordinator
    cfg = trainer.cfg
    logger.info("experiment %s: %d workers, %s on %s",
                cfg.experiment_slug(), cfg.num_workers,
                f"{penv.num_processes} processes ({penv.source}, "
                f"{trainer.comm.backend})" if trainer.distributed
                else "one process", trainer.device)
    if meta["synthetic"]:
        logger.warning("dataset %s not found on disk: using synthetic data",
                       args.dataset)
    preempt = (preemption.PreemptionHandler() if args.handle_preemption
               else None)
    done = resume(trainer, args, logger)
    global_bs = args.batch_size * cfg.num_workers * args.nsteps_update
    per_epoch = max(1, meta["num_examples"] // global_bs)
    total = iterations(args, cfg.num_workers, meta["num_examples"])
    saving = bool(args.ckpt_dir and args.ckpt_every)
    checkpointer = None
    if rank0 and saving and args.ckpt_async:
        checkpointer = AsyncCheckpointer(
            args.ckpt_dir, keep_last=args.ckpt_keep, bus=trainer.bus,
            journal=(trainer.supervisor.journal if trainer.supervisor
                     else None), on_failure=trainer.note_ckpt_failure)
    writer = MetricWriter(rundir) if rank0 else None
    timers = PhaseTimers(every=args.log_every) if args.phase_timers else None
    trace = (TraceWindow(os.path.join(rundir, "trace"), args.trace_at,
                         args.trace_steps)
             if args.trace_at and rank0 else None)
    m = {}
    try:
        while done < total:
            chunk = min(total - done, per_epoch)
            start = done
            m = trainer.train(data, chunk, log_every=args.log_every,
                              logger=logger, metric_writer=writer,
                              timers=timers, trace=trace, start_step=done,
                              should_stop=(preempt.should_stop if preempt
                                           else None))
            done = trainer.last_step
            if done == start:       # stopped before the chunk's first step
                break
            if settings.PROFILING_GRAD:
                dump_grad_stream(trainer, rundir, done, rank0)
            mem = device_memory_stats(trainer.device)
            logger.info("epoch done @ iter %d: loss %.4f vol/step %.0f "
                        "hbm %.0fMiB", done, m["loss"], m["comm_volume"],
                        mem.get("bytes_in_use", 0) / 2**20)
            if saving and done % args.ckpt_every == 0:
                save_and_register(trainer, args, done, rank0, checkpointer,
                                  logger)
            if done < start + chunk:  # stopped (every rank agreed)
                break
    finally:
        if writer is not None:
            writer.close()
        if trace is not None:
            trace.close()
        if checkpointer is not None and preempt is None:
            checkpointer.close(timeout=300.0)
    if m and done >= total:
        logger.info("done: %d iterations, loss %r, vol/step %d", total,
                    m["loss"], int(m["comm_volume"]))
    if preempt is not None:
        if done < total:               # another rank may have been signalled
            preempt.request_stop()
        return preemption.epilogue(
            trainer.train_state, done, preempt, logger,
            rank=penv.process_id, completed=done >= total,
            extra=trainer.supervisor_extra(), checkpointer=checkpointer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
