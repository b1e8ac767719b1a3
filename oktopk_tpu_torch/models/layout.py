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

DeepSpeech, the PTB LSTM and the CNN zoo (the CIFAR ResNets, ResNet-50,
PreResNet, ResNeXt, DenseNet, AlexNet, CaffeCifar, MnistNet) name their
submodules after the flax modules and derive from ``FlaxNamedModule``;
``flax_named_key``, ``flax_named_path`` and ``flax_named_leaves`` map
their state_dict keys, flax paths and leaves onto each other.
"""

from __future__ import annotations

import torch
import torch.nn as nn


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


# ---- models whose submodules carry the flax names ----------------------
# DeepSpeech and the PTB LSTM name every submodule after its flax module
# (``Conv_0``, ``BatchRNN_1``, ``OptimizedLSTMCell_0``, ``hf``, ...), so a
# state_dict key is the flax path with "." for "/", but for the leaf names
# of torch's own layers: a Conv or Dense ``kernel`` is the ``weight`` of
# ``nn.Conv2d`` / ``nn.Linear``, an Embed ``embedding`` the ``weight`` of
# ``nn.Embedding``.

def _kind(module: str) -> str:
    return module.rsplit("_", 1)[0] if module[-1:].isdigit() else module


def flax_named_key(path: str):
    """(state_dict key, layout) of a flax path (params or batch_stats)."""
    parts = path.split("/")
    kind, leaf = _kind(parts[-2]), parts[-1]
    layout = "same"
    if leaf == "kernel":
        layout = {"Conv": "oihw"}.get(kind, "linear")
        if kind in ("Conv", "Dense"):
            leaf = "weight"
    elif leaf == "embedding" and kind == "Embed":
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf]), layout


def flax_named_path(key: str):
    """Inverse of ``flax_named_key``: (flax path, layout)."""
    parts = key.split(".")
    kind, leaf = _kind(parts[-2]), parts[-1]
    layout = "same"
    if leaf == "weight":
        leaf, layout = {"Conv": ("kernel", "oihw"),
                        "Dense": ("kernel", "linear"),
                        "Embed": ("embedding", "same")}[kind]
    elif leaf == "kernel":
        layout = "linear"
    return "/".join(parts[:-1] + [leaf]), layout


def flax_named_leaves(module):
    """``jax_leaves()`` of a flax-named module: (flax path, parameter,
    layout) sorted as ``jax.tree.flatten`` sorts the nested dicts (by
    the tuple of path components)."""
    leaves = []
    for key, p in module.named_parameters():
        path, layout = flax_named_path(key)
        leaves.append((tuple(path.split("/")), path, p, layout))
    leaves.sort(key=lambda t: t[0])
    return [(path, p, layout) for _, path, p, layout in leaves]


class FlaxNamedModule(nn.Module):
    """A model whose submodules carry the flax names: its leaves come from
    its state_dict keys (``flax_named_leaves``), and ``convert.py`` maps
    its flax trees by name."""

    def jax_leaves(self):
        return flax_named_leaves(self)
