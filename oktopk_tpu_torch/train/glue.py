"""GLUE fine-tuning and evaluation.

Counterpart of ``oktopk_tpu/train/glue.py`` (the reference's
BERT/bert/compute_glue_scores.py): the TSV column map of each task
(``TASKS``), ``read_examples``, ``featurize`` (``FullTokenizer.
encode_pair``), the metrics (accuracy, F1, Matthews correlation,
Pearson and Spearman), and the fine-tune loop: ``BertForSequenceClassification``
(``models/bert.py``) with its encoder grafted from a pretraining
checkpoint (``--ckpt``, ``train/checkpoint.py::load_encoder_params``:
the ``bert`` subtree, shape-checked), BertAdam with a 10% warmup over
every step, the JAX loop's dropout keys (``PRNGKey(0)``, split once a
step, flax's site keys through ``ops/prng.py``) and its
``RandomState(0)`` epoch order. It runs on one device, without the
sparse allreduce, as the JAX package's does. Without the task's TSVs it
exits with 1.

Usage:
    python -m oktopk_tpu_torch.train.glue --task mrpc \
        --data-dir ./data/glue/MRPC --vocab-file ./data/vocab.txt \
        --ckpt pretrain_ckpt_dir --epochs 3
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import logging
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class GlueTask:
    name: str
    train_file: str
    dev_file: str
    text_a: int                  # column indices
    text_b: Optional[int]
    label: int
    labels: Optional[Tuple[str, ...]]   # None => regression (STS-B)
    skip_header: bool = True
    metric: str = "accuracy"


TASKS = {
    "cola": GlueTask("cola", "train.tsv", "dev.tsv", 3, None, 1,
                     ("0", "1"), skip_header=False, metric="matthews"),
    "sst-2": GlueTask("sst-2", "train.tsv", "dev.tsv", 0, None, 1,
                      ("0", "1")),
    "mrpc": GlueTask("mrpc", "train.tsv", "dev.tsv", 3, 4, 0,
                     ("0", "1"), metric="acc_f1"),
    "sts-b": GlueTask("sts-b", "train.tsv", "dev.tsv", 7, 8, 9, None,
                      metric="pearson_spearman"),
    "qqp": GlueTask("qqp", "train.tsv", "dev.tsv", 3, 4, 5,
                    ("0", "1"), metric="acc_f1"),
    "mnli": GlueTask("mnli", "train.tsv", "dev_matched.tsv", 8, 9, -1,
                     ("contradiction", "entailment", "neutral")),
    "qnli": GlueTask("qnli", "train.tsv", "dev.tsv", 1, 2, -1,
                     ("entailment", "not_entailment")),
    "rte": GlueTask("rte", "train.tsv", "dev.tsv", 1, 2, -1,
                    ("entailment", "not_entailment")),
    "wnli": GlueTask("wnli", "train.tsv", "dev.tsv", 1, 2, -1,
                     ("0", "1")),
}


def read_examples(task: GlueTask, path: str, split: str):
    fname = task.train_file if split == "train" else task.dev_file
    rows = []
    with open(os.path.join(path, fname), encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t", quotechar=None)
        for i, line in enumerate(reader):
            if task.skip_header and i == 0:
                continue
            try:
                a = line[task.text_a]
                b = line[task.text_b] if task.text_b is not None else None
                lab = line[task.label]
            except IndexError:
                continue
            if task.labels is None:
                y = float(lab)
            else:
                if lab not in task.labels:
                    continue
                y = task.labels.index(lab)
            rows.append((a, b, y))
    return rows


def featurize(rows, tokenizer, max_len: int, regression: bool):
    ids, types, masks, ys = [], [], [], []
    for a, b, y in rows:
        i, t, m = tokenizer.encode_pair(a, b, max_len)
        ids.append(i); types.append(t); masks.append(m); ys.append(y)
    return {
        "input_ids": np.asarray(ids, np.int32),
        "token_type_ids": np.asarray(types, np.int32),
        "attention_mask": np.asarray(masks, np.int32),
        "label": np.asarray(ys, np.float32 if regression else np.int32),
    }


# ---- metrics (reference compute_glue_scores.py metric map) ---------------

def matthews_corr(y_true, y_pred):
    tp = np.sum((y_pred == 1) & (y_true == 1))
    tn = np.sum((y_pred == 0) & (y_true == 0))
    fp = np.sum((y_pred == 1) & (y_true == 0))
    fn = np.sum((y_pred == 0) & (y_true == 1))
    denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
    return float((tp * tn - fp * fn) / denom) if denom else 0.0


def f1_score(y_true, y_pred):
    tp = np.sum((y_pred == 1) & (y_true == 1))
    fp = np.sum((y_pred == 1) & (y_true == 0))
    fn = np.sum((y_pred == 0) & (y_true == 1))
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return float(2 * prec * rec / max(prec + rec, 1e-12))


def pearson(a, b):
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum()
                 / max(np.sqrt((a * a).sum() * (b * b).sum()), 1e-12))


def spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return pearson(ra, rb)


def task_metrics(task: GlueTask, y_true, y_pred):
    if task.metric == "matthews":
        return {"matthews": matthews_corr(y_true, y_pred)}
    if task.metric == "acc_f1":
        return {"accuracy": float(np.mean(y_true == y_pred)),
                "f1": f1_score(y_true, y_pred)}
    if task.metric == "pearson_spearman":
        return {"pearson": pearson(y_true, y_pred),
                "spearman": spearman(y_true, y_pred)}
    return {"accuracy": float(np.mean(y_true == y_pred))}


def build_model(args, tokenizer):
    """The classifier for ``args.model`` and the task, its vocabulary
    sized to the tokenizer's (a vocab file dictates it), initialised
    with flax's default distributions from ``torch.Generator(0)``."""
    from oktopk_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    task = TASKS[args.task]
    num_labels = 1 if task.labels is None else len(task.labels)
    cfg = {"bert_base": BertConfig.base, "bert_large": BertConfig.large,
           "bert_tiny": BertConfig.tiny}[args.model]()
    if tokenizer.vocab_size != cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=tokenizer.vocab_size)
    model = BertForSequenceClassification(cfg, num_labels=num_labels)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def graft_encoder(model, ckpt: str) -> None:
    """Load a pretraining checkpoint's ``bert`` subtree into ``model``
    (``load_encoder_params``: the head stays as it is)."""
    from oktopk_tpu_torch.convert import (bert_from_jax_params,
                                          bert_to_jax_params)
    from oktopk_tpu_torch.train.checkpoint import load_encoder_params
    params = load_encoder_params(ckpt, bert_to_jax_params(
        model.state_dict()))
    model.load_state_dict(bert_from_jax_params(params), strict=True)


def _flat(leaves, tensors) -> torch.Tensor:
    """The tensors (one per leaf, torch layout) in one flat buffer in the
    JAX leaf order and layout."""
    from oktopk_tpu_torch.models.layout import to_jax_layout
    return torch.cat([to_jax_layout(t, lay).reshape(-1)
                      for (_, _, lay), t in zip(leaves, tensors)])


def fine_tune(model, train: Dict[str, np.ndarray],
              dev: Dict[str, np.ndarray], task: GlueTask, epochs: int,
              batch_size: int, lr: float, device,
              logger: Optional[logging.Logger] = None) -> Dict:
    """The JAX fine-tune loop on ``model`` (on ``device``); returns each
    step's loss (``losses``), each epoch's dev predictions (``preds``)
    and scores (``scores``)."""
    from oktopk_tpu_torch.models.layout import from_jax_layout, to_jax_layout
    from oktopk_tpu_torch.ops import prng
    from oktopk_tpu_torch.optim import BertAdam

    regression = task.labels is None
    leaves = model.jax_leaves()
    params = [p for _, p, _ in leaves]
    shapes = [tuple(to_jax_layout(p, lay).shape) for _, p, lay in leaves]
    sizes = [p.numel() for p in params]
    n = sum(sizes)
    steps_per_epoch = max(1, len(train["label"]) // batch_size)
    opt = BertAdam(lr=lr, warmup=0.1, t_total=steps_per_epoch * epochs)
    opt.init(n, device)
    rng = prng.prng_key(0)
    nrng = np.random.RandomState(0)

    def on_dev(b):
        return {k: torch.as_tensor(v).to(device) for k, v in b.items()}

    def loss_fn(logits, label):
        if regression:
            return torch.mean((logits[:, 0] - label) ** 2)
        return torch.nn.functional.cross_entropy(logits, label.long())

    out = {"losses": [], "preds": [], "scores": []}
    for epoch in range(epochs):
        order = nrng.permutation(len(train["label"]))
        losses: List[float] = []
        for i in range(steps_per_epoch):
            sel = order[i * batch_size:(i + 1) * batch_size]
            b = on_dev({k: v[sel] for k, v in train.items()})
            pair = prng.split(rng)
            rng = pair[0]
            logits = model(b["input_ids"], b["token_type_ids"],
                           b["attention_mask"], train=True, rng=pair[1])
            loss = loss_fn(logits, b["label"])
            for p in params:
                p.grad = None
            loss.backward()
            with torch.no_grad():
                upd = opt.update(_flat(leaves, [p.grad for p in params]),
                                 _flat(leaves, params))
                for p, u, (_, _, lay), shp in zip(
                        params, torch.split(upd, sizes), leaves, shapes):
                    p.add_(from_jax_layout(u.view(shp), lay))
            losses.append(float(loss.detach()))
        with torch.no_grad():
            preds = []
            for i in range(0, len(dev["label"]), batch_size):
                b = on_dev({k: v[i:i + batch_size] for k, v in dev.items()})
                logits = model(b["input_ids"], b["token_type_ids"],
                               b["attention_mask"], train=False)
                preds.append((logits[:, 0] if regression
                              else torch.argmax(logits, -1)).cpu().numpy())
        preds = np.concatenate(preds)
        scores = task_metrics(task, dev["label"], preds)
        out["losses"] += losses
        out["preds"].append(preds)
        out["scores"].append(scores)
        if logger:
            logger.info("epoch %d: train loss %.4f  %s", epoch,
                        float(np.mean(losses)),
                        "  ".join(f"{k}={v:.4f}" for k, v in scores.items()))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", required=True, choices=sorted(TASKS))
    p.add_argument("--data-dir", required=True)
    p.add_argument("--vocab-file", default=None)
    p.add_argument("--ckpt", default=None,
                   help="pretraining checkpoint to warm-start the encoder")
    p.add_argument("--model", default="bert_base",
                   choices=["bert_base", "bert_large", "bert_tiny"])
    p.add_argument("--max-seq-length", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from oktopk_tpu_torch import resolve_device
    from oktopk_tpu_torch.data.tokenization import FullTokenizer

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("oktopk_tpu_torch.glue")
    task = TASKS[args.task]
    if not os.path.exists(os.path.join(args.data_dir, task.train_file)):
        logger.error("GLUE data not found at %s: the task's TSVs are needed "
                     "(fine-tuning on synthetic text is meaningless)",
                     args.data_dir)
        return 1
    device = resolve_device(args.device)
    fallback = 1024 if args.model == "bert_tiny" else 30522
    tokenizer = FullTokenizer(args.vocab_file, fallback_size=fallback)
    train = featurize(read_examples(task, args.data_dir, "train"),
                      tokenizer, args.max_seq_length, task.labels is None)
    dev = featurize(read_examples(task, args.data_dir, "dev"),
                    tokenizer, args.max_seq_length, task.labels is None)
    logger.info("%s: %d train / %d dev", args.task,
                len(train["label"]), len(dev["label"]))
    model = build_model(args, tokenizer)
    if args.ckpt:
        graft_encoder(model, args.ckpt)
        logger.info("warm-started the encoder from %s", args.ckpt)
    model.to(device)
    fine_tune(model, train, dev, task, args.epochs, args.batch_size,
              args.lr, device, logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
