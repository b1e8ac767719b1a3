#!/usr/bin/env python3
"""What the port's chunked embedding backward costs a BERT step.

``models/layers.py::embedding_grad`` adds a lookup's table gradient
``EMBED_GRAD_CHUNK`` (3,072) ids at a time on a card, because CUDA's own
``embedding_dense_backward`` above that many ids takes a sort-based
kernel whose sums differ from run to run. Every lookup of more than
3,072 ids takes the chunks: a pipeline data row (32 x 128), a GLUE step
at its default batch (32 x 128), and any data-parallel BERT step above
3,072 ids a worker.

This script times, on one card, float32 BERT forward + backward steps
(no dropout, no optimizer; the Trainer's TF32-off matmuls) with the
chunks (``chunked``) and with one ``embedding_dense_backward`` per
lookup (``single``: the path before the chunks, which ``F.embedding``'s
own backward takes), in the order A B B A for ``--rounds`` rounds, for
the pretraining model and the GLUE classifier. It counts the distinct
gradients of the three embedding tables each way gives over the timed
steps of the same inputs, and times the word table's gradient alone
both ways.

Run from the repository root::

    python3 scripts/port_embed_grad_ab.py [--batch-size 32] \
        [--seq-len 128] [--rounds 5] [--out chiprun_out/embed_grad_ab.json]

It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SINGLE = 1 << 62        # a chunk larger than any lookup: one call


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _batch(B: int, T: int, vocab: int, dev, torch):
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, vocab, (B, T), generator=gen, device=dev)
    ids[:, ::7] = 103                              # [MASK], repeated ids
    mlm = torch.where(torch.rand((B, T), generator=gen, device=dev) < 0.15,
                      ids, torch.full_like(ids, -1))
    return {"input_ids": ids,
            "token_type_ids": (torch.arange(T, device=dev) >= T // 2)
            .long().expand(B, T).contiguous(),
            "attention_mask": torch.ones((B, T), dtype=torch.long,
                                         device=dev),
            "mlm_labels": mlm,
            "labels": torch.randint(0, 2, (B,), generator=gen, device=dev)}


def ab(model, loss_fn, rounds: int, torch, layers) -> dict:
    """Step times (ms, CUDA events) and the distinct gradients of the
    three embedding tables of each variant, A B B A a round after one
    warm step each."""
    tables = [m.weight for m in model.bert.embeddings.modules()
              if isinstance(m, layers.Embedding)]

    def step(chunk):
        layers.EMBED_GRAD_CHUNK = chunk
        for p in model.parameters():
            p.grad = None
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        loss_fn(model).backward()
        t1.record()
        torch.cuda.synchronize()
        h = hashlib.sha1()
        for t in tables:
            h.update(t.grad.cpu().numpy().tobytes())
        digest = h.hexdigest()
        return t0.elapsed_time(t1), digest

    variants = {"chunked": layers.EMBED_GRAD_CHUNK, "single": SINGLE}
    for chunk in variants.values():
        step(chunk)
    ms = {k: [] for k in variants}
    digests = {k: set() for k in variants}
    for _ in range(rounds):
        for k in ("chunked", "single", "single", "chunked"):
            t, d = step(variants[k])
            ms[k].append(t)
            digests[k].add(d)
    layers.EMBED_GRAD_CHUNK = variants["chunked"]
    return {k: {"median_ms": statistics.median(v), "ms": v,
                "distinct_embedding_grads": len(digests[k])}
            for k, v in ms.items()}


def op_ab(dev, B: int, T: int, H: int, vocab: int, reps: int, torch,
          layers) -> dict:
    """The word table's gradient alone, chunked and single, median ms."""
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, vocab, (B, T), generator=gen, device=dev)
    ids[:, ::7] = 103
    g = torch.randn((B, T, H), generator=gen, device=dev)
    chunk = layers.EMBED_GRAD_CHUNK
    out = {}
    for name, c in (("chunked", chunk), ("single", SINGLE),
                    ("single", SINGLE), ("chunked", chunk)):
        layers.EMBED_GRAD_CHUNK = c
        layers.embedding_grad(g, ids, vocab)
        times = []
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            layers.embedding_grad(g, ids, vocab)
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        out.setdefault(name, []).extend(times)
    layers.EMBED_GRAD_CHUNK = chunk
    return {k: statistics.median(v) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--op-reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from oktopk_tpu_torch.models import layers
    from oktopk_tpu_torch.models.bert import (BertConfig,
                                              BertForPreTraining,
                                              BertForSequenceClassification)
    from oktopk_tpu_torch.train.losses import bert_pretrain_loss

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    cfg = BertConfig.base()
    B, T = args.batch_size, args.seq_len
    batch = _batch(B, T, cfg.vocab_size, dev, torch)

    def pretrain_loss(m):
        mlm, nsp = m(batch["input_ids"], batch["token_type_ids"],
                     batch["attention_mask"], train=False)
        return bert_pretrain_loss(mlm, nsp, batch["mlm_labels"],
                                  batch["labels"])[0]

    def glue_loss(m):
        logits = m(batch["input_ids"], batch["token_type_ids"],
                   batch["attention_mask"], train=False)
        return torch.nn.functional.cross_entropy(logits, batch["labels"])

    out = {"card": card, "batch": [B, T], "ids": B * T,
           "chunk": layers.EMBED_GRAD_CHUNK}
    for name, cls, fn in (("pretrain", BertForPreTraining, pretrain_loss),
                          ("glue", BertForSequenceClassification,
                           glue_loss)):
        model = cls(cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        model.to(dev)
        out[name] = ab(model, fn, args.rounds, torch, layers)
        del model
        torch.cuda.empty_cache()
    out["word_grad_op"] = op_ab(dev, B, T, cfg.hidden_size, cfg.vocab_size,
                                args.op_reps, torch, layers)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
