"""CLI driver for VGG data-parallel training with a sparse allreduce.

Counterpart of ``oktopk_tpu/train/main_trainer.py``: the flags of its
:25-50 that this slice serves, under the same names, plus
``--num-workers`` (the P workers stacked on one device) and ``--device``.
The data is the synthetic CIFAR iterator (the real loaders are not ported
yet, ROADMAP.md).

Example:
    python -m oktopk_tpu_torch.train.main_trainer --dnn vgg16 \\
        --batch-size 16 --num-workers 4 --density 0.02 --max-iters 20
"""

from __future__ import annotations

import argparse
import logging
import sys

CIFAR10_TRAIN_EXAMPLES = 50000


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
    p.add_argument("--wire-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num-buckets", type=int, default=1)
    p.add_argument("--compressor", default="oktopk")
    p.add_argument("--density", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="dense warmup iterations (default: reference's 512)")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--num-workers", type=int, default=1,
                   help="data-parallel workers stacked on the device")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dataset != "cifar10":
        raise NotImplementedError(
            f"dataset {args.dataset!r} is not ported yet (ROADMAP.md)")
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.data import synthetic_iterator
    from oktopk_tpu_torch.train.trainer import Trainer

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("oktopk_tpu_torch")
    cfg = TrainConfig(
        dnn=args.dnn, dataset=args.dataset, batch_size=args.batch_size,
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        nesterov=args.nesterov, max_epochs=args.max_epochs,
        compressor=args.compressor, density=args.density, seed=args.seed,
        num_workers=args.num_workers, num_buckets=args.num_buckets)
    algo_cfg = OkTopkConfig(wire_dtype=args.wire_dtype)
    if args.warmup_steps is not None:
        algo_cfg = algo_cfg.replace(warmup_steps=args.warmup_steps)
    trainer = Trainer(cfg, algo_cfg=algo_cfg, device=args.device)
    logger.info("experiment %s on %s", cfg.experiment_slug(), trainer.device)

    global_bs = args.batch_size * args.num_workers
    data = synthetic_iterator(args.dnn, global_bs, seed=args.seed)
    iters_per_epoch = max(1, CIFAR10_TRAIN_EXAMPLES // global_bs)
    total = args.max_iters or args.max_epochs * iters_per_epoch
    m = trainer.train(data, total, log_every=args.log_every, logger=logger)
    logger.info("done: %d iterations, loss %.4f, vol/step %.0f", total,
                m["loss"], m["comm_volume"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
