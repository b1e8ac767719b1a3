"""Checkpoint evaluation (the reference's VGG/evaluate.py:20).

Counterpart of ``oktopk_tpu/train/evaluate.py``: a checkpoint (either
package's file, ``train/checkpoint.py``) is restored into a
``Trainer(warmup=False)`` and ``Trainer.eval_step`` is averaged over
the ``test`` split's batches (``--num-batches``; 16 on synthetic data,
else one pass). For DeepSpeech (``lstman4*``) each batch is scored with
the CTC loss and the greedy-decoded WER and CER. The JAX command line's
``--fake-devices`` is ``--num-workers`` and ``--device`` here; the model
alone is loaded (the per-worker sparse state plays no part in an
evaluation, so the worker count need not be the training run's).

Usage:
    python -m oktopk_tpu_torch.train.evaluate --dnn vgg16 \\
        --dataset cifar10 --ckpt ./ckpts
    python -m oktopk_tpu_torch.train.evaluate --dnn lstman4 \\
        --dataset an4 --data-dir ./data --ckpt ./ckpts
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Dict, List, Tuple


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dnn", default="vgg16")
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-batches", type=int, default=0,
                   help="0 = one pass over the eval split (synthetic: 16)")
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def evaluate(args, logger=None) -> Tuple[Dict[str, float], List[str]]:
    """The metrics of ``eval_step`` averaged over the eval batches, and
    the greedy hypotheses of every utterance (DeepSpeech; else empty)."""
    from oktopk_tpu_torch.config import TrainConfig
    from oktopk_tpu_torch.data import make_dataset
    from oktopk_tpu_torch.train.checkpoint import restore_checkpoint
    from oktopk_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(dnn=args.dnn, dataset=args.dataset,
                      batch_size=args.batch_size,
                      num_workers=args.num_workers)
    trainer = Trainer(cfg, warmup=False, device=args.device)
    tree, step = restore_checkpoint(args.ckpt,
                                    trainer.train_state(gather=False))
    trainer.load_train_state(tree, parts=("params", "model_state"))
    if logger:
        logger.info("evaluating %s checkpoint @ step %d", args.dnn, step)
    data, meta = make_dataset(args.dataset, args.dnn, args.batch_size,
                              path=args.data_dir, split="test")
    nb = args.num_batches or (
        16 if meta.get("synthetic")
        else max(1, meta["num_examples"] // args.batch_size))
    totals: Dict[str, list] = {}
    hyps: List[str] = []
    for _ in range(nb):
        trainer.last_hypotheses = []
        m = trainer.eval_step(next(data))
        for k, v in m.items():
            totals.setdefault(k, []).append(float(v))
        hyps += trainer.last_hypotheses
    out = {k: sum(vs) / len(vs) for k, vs in totals.items()}
    if logger:
        for k, v in out.items():
            logger.info("%s: %.4f", k, v)
    return out, hyps


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    evaluate(args, logging.getLogger("oktopk_tpu_torch.eval"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
