"""Deterministic synthetic CIFAR batches.

Counterpart of the CIFAR branch of
``oktopk_tpu/data/synthetic.py::synthetic_batch`` (:87-88): made with
numpy from a ``RandomState``, so both packages see the same batch from
the same seed.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_batch(dnn: str, batch_size: int,
                    rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    if not dnn.startswith("vgg"):
        raise NotImplementedError(
            f"synthetic data for {dnn!r} is not ported yet (ROADMAP.md)")
    return {"image": rng.randn(batch_size, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, size=(batch_size,)).astype(np.int32)}


def synthetic_iterator(dnn: str, batch_size: int,
                       seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    while True:
        yield synthetic_batch(dnn, batch_size, rng)
