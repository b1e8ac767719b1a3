"""CLI driver for data-parallel training with a sparse allreduce: VGG on
CIFAR-10, DeepSpeech on AN4 (CTC) and the PTB LSTM.

Counterpart of ``oktopk_tpu/train/main_trainer.py``: the flags of its
:25-50, :130-135 that the port serves, under the same names
(``--compressor`` takes every registry name but ``hierarchical``), plus
``--num-workers``, ``--device`` and ``--backend``. ``--dataset`` is
``cifar10`` (``--dnn vgg*``), ``an4`` (``lstman4``, ``lstman4_tiny``) or
``ptb`` (``lstm``, ``lstm_tiny``); the data is the synthetic iterator of
the model's family at its default sequence lengths (201 spectrogram
frames, 35 tokens), 50,000 examples an epoch, as the JAX package's
``make_dataset`` falls back to without files (the real loaders are not
ported yet, ROADMAP.md). Any other dataset raises.

One process holds its P workers stacked on its device
(``--num-workers``, default 1). A multi-process launch (``torchrun``,
SLURM, OpenMPI or the ``OKTOPK_*`` variables, ``launch.py``) runs one
worker per process over a ``torch.distributed`` group: ``--num-workers``
is then the world size, the device ``cuda:{local_rank}`` unless
``--device`` names one, and the backend nccl on a card, gloo on the CPU,
unless ``--backend`` names one (gloo on CUDA tensors only when named).
Only rank 0 logs.

Examples:
    python -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 \\
        --batch-size 16 --num-workers 4 --density 0.02 --max-iters 20 \\
        --compressor topkA --nsteps-update 2 --grad-clip 5.0
    python -m oktopk_tpu_torch.train.main_trainer --dnn lstman4 \\
        --dataset an4 --batch-size 2 --num-workers 4 --grad-clip 400 \\
        --lr 3e-4 --max-iters 20
    torchrun --standalone --nproc-per-node 4 \\
        -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 --max-iters 20
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from oktopk_tpu_torch.collectives.registry import (
    TWO_LEVEL_ONLY,
    list_algorithms,
)

# examples an epoch: CIFAR-10's training set, and the JAX package's
# synthetic fallback for every dataset
SYNTHETIC_EXAMPLES = 50000
# the models each dataset trains
DATASETS = {"cifar10": "image", "an4": "ctc", "ptb": "lm"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dnn", default="vgg16")
    p.add_argument("--dataset", default="cifar10")
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
    p.add_argument("--wire-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num-buckets", type=int, default=1)
    p.add_argument("--compressor", default="oktopk",
                   choices=list_algorithms())
    p.add_argument("--density", type=float, default=0.02)
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
    args = p.parse_args(argv)
    if args.compressor == "hierarchical":
        p.error(TWO_LEVEL_ONLY)
    return args


def build_trainer(args):
    """(Trainer, synthetic batch iterator, ProcessEnv): joins the process
    group on a multi-process launch (``launch.maybe_initialize``) and puts
    the trainer on ``ProcessGroupComm`` there, else on its stacked
    workers."""
    from oktopk_tpu_torch import launch
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.data import synthetic_iterator
    from oktopk_tpu_torch.train.trainer import Trainer, workload

    if args.dataset not in DATASETS:
        raise NotImplementedError(
            f"dataset {args.dataset!r} is not ported yet (ROADMAP.md)")
    if DATASETS[args.dataset] != workload(args.dnn):
        raise ValueError(f"--dnn {args.dnn} does not train on "
                         f"--dataset {args.dataset}")
    penv, dev, comm, workers = launch.data_parallel(
        args.num_workers, args.device, args.backend)
    cfg = TrainConfig(
        dnn=args.dnn, dataset=args.dataset, batch_size=args.batch_size,
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        nesterov=args.nesterov, max_epochs=args.max_epochs,
        nsteps_update=args.nsteps_update, compressor=args.compressor,
        density=args.density, seed=args.seed, num_workers=workers,
        grad_clip=args.grad_clip, num_buckets=args.num_buckets)
    algo_cfg = OkTopkConfig(wire_dtype=args.wire_dtype)
    if args.warmup_steps is not None:
        algo_cfg = algo_cfg.replace(warmup_steps=args.warmup_steps)
    trainer = Trainer(cfg, algo_cfg=algo_cfg, device=dev, comm=comm)
    global_bs = args.batch_size * workers * args.nsteps_update
    data = synthetic_iterator(args.dnn, global_bs, seed=args.seed)
    return trainer, data, penv


def iterations(args, workers: int) -> int:
    """``--max-iters``, else ``--max-epochs`` epochs of
    ``SYNTHETIC_EXAMPLES`` examples at the global batch."""
    global_bs = args.batch_size * workers * args.nsteps_update
    return args.max_iters or args.max_epochs * max(
        1, SYNTHETIC_EXAMPLES // global_bs)


def main(argv=None) -> int:
    args = parse_args(argv)
    # cuBLAS repeats its sums only with this set before the CUDA context
    # exists (the Trainer makes cuDNN deterministic)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    trainer, data, penv = build_trainer(args)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = (logging.getLogger("oktopk_tpu_torch") if penv.is_coordinator
              else None)
    cfg = trainer.cfg
    if logger:
        logger.info("experiment %s: %d workers, %s on %s",
                    cfg.experiment_slug(), cfg.num_workers,
                    f"{penv.num_processes} processes ({penv.source}, "
                    f"{trainer.comm.backend})" if trainer.distributed
                    else "one process", trainer.device)
    total = iterations(args, cfg.num_workers)
    m = trainer.train(data, total, log_every=args.log_every, logger=logger)
    if logger:
        logger.info("done: %d iterations, loss %r, vol/step %d", total,
                    m["loss"], int(m["comm_volume"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
