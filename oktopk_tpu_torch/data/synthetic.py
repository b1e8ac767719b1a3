"""Deterministic synthetic batches.

Counterpart of ``oktopk_tpu/data/synthetic.py::synthetic_batch``
(:13-89), every branch: made with
numpy from a ``RandomState``, with the same draws in the same order, so
both packages see the same batch from the same seed. The BERT branch is
the synthetic MLM/NSP data the JAX package falls back to without
Wikipedia shards (``oktopk_tpu/data/loaders.py:221-243``): token ids,
then the 15% MLM mask, then the NSP labels. The PTB branch is a bigram
chain over a fixed successor table (drawn from its own
``RandomState(vocab + 17)``, not from ``rng``) with 10% uniform noise;
the AN4 branch tone-codes each character as 8 frames of energy in its
own 5-bin band over a noise floor. The JAX package falls back to both
without the PTB corpus or the AN4 manifests
(``oktopk_tpu/data/loaders.py:283-284``). Images are MNIST's [28, 28, 1]
for ``mnistnet``, ImageNet's [224, 224, 3] and 1,000 classes for
``resnet50``, and CIFAR's [32, 32, 3] for every other name, as in the JAX
package.

``finite_pool_iterator`` and ``teacher_iterator`` (:98-149) are copied:
the convergence data, a finite pool recycled in a seeded order, the
teacher's labels ``argmax(W @ flatten(image))`` from a fixed random
linear map, so a dense-versus-sparse gap measures the compression.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_batch(dnn: str, batch_size: int, rng: np.random.RandomState,
                    seq_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    if dnn in ("lstm", "lstm_tiny"):
        t = seq_len or 35
        vocab = 1024 if dnn == "lstm_tiny" else 10000
        trans = np.random.RandomState(vocab + 17).randint(
            0, vocab, size=(vocab,))
        toks = np.empty((batch_size, t + 1), np.int64)
        toks[:, 0] = rng.randint(0, vocab, size=(batch_size,))
        for i in range(t):
            noise = rng.rand(batch_size) < 0.1
            toks[:, i + 1] = np.where(
                noise, rng.randint(0, vocab, size=(batch_size,)),
                trans[toks[:, i]])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}
    if dnn.startswith("bert"):
        t = seq_len or (32 if dnn == "bert_tiny" else 128)
        vocab = 1024 if dnn == "bert_tiny" else 30522
        ids = rng.randint(0, vocab, size=(batch_size, t)).astype(np.int32)
        mlm = np.full((batch_size, t), -1, np.int32)
        mask_pos = rng.rand(batch_size, t) < 0.15
        mlm[mask_pos] = ids[mask_pos]
        return {"input_ids": ids,
                "token_type_ids": np.zeros((batch_size, t), np.int32),
                "attention_mask": np.ones((batch_size, t), np.int32),
                "mlm_labels": mlm,
                "nsp_labels": rng.randint(0, 2, size=(batch_size,))
                .astype(np.int32)}
    if dnn.startswith("lstman4"):
        f, t = 161, seq_len or 201
        fpc = 8                           # frames per character
        max_len = max(1, min(20, (t - 1) // fpc))
        min_len = min(5, max_len)
        spect = (0.3 * rng.randn(batch_size, f, t, 1)).astype(np.float32)
        label_lengths = rng.randint(min_len, max_len + 1,
                                    size=(batch_size,)).astype(np.int32)
        labels = np.zeros((batch_size, 40), np.int32)
        for b in range(batch_size):
            ln = int(label_lengths[b])
            seq = rng.randint(1, 29, size=(ln,))
            labels[b, :ln] = seq
            for i, c in enumerate(seq):
                spect[b, c * 5:c * 5 + 5, i * fpc:(i + 1) * fpc, 0] += 1.0
        return {"spect": spect,
                "spect_lengths": (label_lengths * fpc).astype(np.int32),
                "labels": labels,
                "label_lengths": label_lengths}
    if dnn == "mnistnet":
        return {"image": rng.randn(batch_size, 28, 28, 1).astype(np.float32),
                "label": rng.randint(0, 10, size=(batch_size,))
                .astype(np.int32)}
    if dnn == "resnet50":
        return {"image": rng.randn(batch_size, 224, 224, 3)
                .astype(np.float32),
                "label": rng.randint(0, 1000, size=(batch_size,))
                .astype(np.int32)}
    return {"image": rng.randn(batch_size, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, size=(batch_size,)).astype(np.int32)}


def synthetic_iterator(dnn: str, batch_size: int, seed: int = 0,
                       seq_len: Optional[int] = None
                       ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    while True:
        yield synthetic_batch(dnn, batch_size, rng, seq_len)


def finite_pool_iterator(dnn: str, batch_size: int, num_examples: int = 256,
                         seed: int = 0, seq_len: Optional[int] = None
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Finite synthetic dataset, shuffled and recycled forever: the
    convergence data of the token workloads (BERT, LSTM, CTC), where a
    linear teacher over pixels does not apply. A finite pool is
    memorizable, so the loss trend is an optimization signal."""
    if batch_size > num_examples:
        raise ValueError(f"batch_size {batch_size} > pool size "
                         f"{num_examples}: the cycle would never yield")
    rng = np.random.RandomState(seed)
    pool = synthetic_batch(dnn, num_examples, rng, seq_len)
    order_rng = np.random.RandomState(seed + 1)
    while True:
        order = order_rng.permutation(num_examples)
        for i in range(0, num_examples - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            yield {k: v[sel] for k, v in pool.items()}


def teacher_iterator(dnn: str, batch_size: int, num_examples: int = 512,
                     seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Finite image dataset with *learnable* labels from a fixed random
    linear teacher (label = argmax(W @ flatten(image))): random labels
    are unfittable in expectation, so every optimizer gets the same
    structured task and a dense-vs-sparse gap measures the compression
    (the stand-in for the reference's accuracy-log runs,
    VGG/dl_trainer.py:606-616)."""
    rng = np.random.RandomState(seed)
    proto = synthetic_batch(dnn, num_examples, rng)
    if "image" not in proto:
        raise ValueError(f"teacher_iterator supports image workloads, "
                         f"not {dnn}")
    images = proto["image"]
    nclass = int(proto["label"].max()) + 1
    w = rng.randn(images[0].size, nclass).astype(np.float32)
    logits = images.reshape(num_examples, -1) @ w
    labels = np.argmax(logits, axis=1).astype(np.int32)
    order_rng = np.random.RandomState(seed + 1)
    while True:
        order = order_rng.permutation(num_examples)
        for i in range(0, num_examples - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            yield {"image": images[sel], "label": labels[sel]}
