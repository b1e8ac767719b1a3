"""How a torch parameter relates to its flax leaf.

Every model of the port lists its parameters with ``jax_leaves()`` as
(flax path, parameter, layout) in ``jax.tree.flatten`` order; the trainer
writes gradients into the flat buffer, and reads the reduced gradient
back, through these layouts, so buckets, regions and selections are the
reference's. Layouts:

- ``"same"``: the torch tensor is the flax leaf (biases, LayerNorm and
  BatchNorm parameters, embedding tables, flax-shaped ``DenseGeneral``
  kernels);
- ``"linear"``: ``nn.Linear`` weight [out, in] <-> flax Dense kernel
  [in, out];
- ``"oihw"``: ``nn.Conv2d`` weight OIHW <-> flax Conv kernel HWIO.
"""

from __future__ import annotations

import torch


def to_jax_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A torch parameter (or its gradient) in the flax leaf's layout (a
    view)."""
    if layout == "oihw":
        return t.permute(2, 3, 1, 0)          # OIHW -> HWIO
    if layout == "linear":
        return t.t()                          # [out, in] -> [in, out]
    if layout != "same":
        raise ValueError(f"unknown layout {layout!r}")
    return t


def from_jax_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """Inverse of ``to_jax_layout`` (a view)."""
    if layout == "oihw":
        return t.permute(3, 2, 0, 1)          # HWIO -> OIHW
    if layout == "linear":
        return t.t()
    if layout != "same":
        raise ValueError(f"unknown layout {layout!r}")
    return t
