"""Deterministic synthetic batches.

Counterpart of the CIFAR and BERT branches of
``oktopk_tpu/data/synthetic.py::synthetic_batch`` (:37-49, :87-88): made
with numpy from a ``RandomState``, with the same draws in the same order,
so both packages see the same batch from the same seed. The BERT branch
is the synthetic MLM/NSP data the JAX package falls back to without
Wikipedia shards (``oktopk_tpu/data/loaders.py:221-243``): token ids,
then the 15% MLM mask, then the NSP labels.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_batch(dnn: str, batch_size: int, rng: np.random.RandomState,
                    seq_len: Optional[int] = None) -> Dict[str, np.ndarray]:
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
    if not dnn.startswith("vgg"):
        raise NotImplementedError(
            f"synthetic data for {dnn!r} is not ported yet (ROADMAP.md)")
    return {"image": rng.randn(batch_size, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, size=(batch_size,)).astype(np.int32)}


def synthetic_iterator(dnn: str, batch_size: int, seed: int = 0,
                       seq_len: Optional[int] = None
                       ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    while True:
        yield synthetic_batch(dnn, batch_size, rng, seq_len)
