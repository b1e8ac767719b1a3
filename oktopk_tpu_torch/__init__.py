"""oktopk_tpu_torch: the PyTorch + CUDA port of ``oktopk_tpu`` for an
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference. This package imports
``torch`` and ``numpy`` only, never ``jax`` or ``oktopk_tpu``. Its entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default. Raises when
    no GPU is present and the caller did not ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "oktopk_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
