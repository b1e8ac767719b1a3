"""Flat-vector <-> tree helpers for the sparse-allreduce seam.

Counterpart of ``oktopk_tpu/utils/flatten.py:14-27``. A tree is a nested
dict of tensors. Its leaves are taken in ``jax.tree.flatten`` order:
dict keys sorted as strings at every level, so ``sub_0, sub_1, sub_10,
sub_11, sub_2, ...``. That order decides which elements fall in which
region of the sparse collective, and so its selections and volumes; the
flat vector of a pipeline stage or of the shared bucket is the JAX
package's element for element.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import List, Tuple

import torch

Path = Tuple[str, ...]


def tree_items(tree, prefix: Path = ()) -> List[Tuple[Path, object]]:
    """(key path, leaf) of a nested dict, keys sorted as strings at every
    level (``jax.tree.flatten``'s order)."""
    out = []
    for key in sorted(tree, key=str):
        sub = tree[key]
        if isinstance(sub, Mapping):
            out += tree_items(sub, prefix + (key,))
        else:
            out.append((prefix + (key,), sub))
    return out


def flatten_tree(tree):
    """-> (flat [n], leaves, treedef): the leaves concatenated in JAX's
    order; ``treedef`` is their key paths."""
    layout = TreeLayout(tree)
    return layout.flat(tree), [x for _, x in tree_items(tree)], layout.paths


def unflatten_tree(flat: torch.Tensor, leaves, treedef) -> dict:
    """Inverse of :func:`flatten_tree` (shapes from ``leaves``): a nested
    dict of views of ``flat``."""
    return TreeLayout.of(treedef, [tuple(x.shape) for x in leaves]).tree(
        flat)


class TreeLayout:
    """The key paths and shapes of a tree's leaves in JAX's order: a flat
    [n] vector <-> a tree of views. It holds shapes only, not the
    leaves."""

    def __init__(self, tree):
        items = tree_items(tree)
        self._set([p for p, _ in items], [tuple(x.shape) for _, x in items])

    @classmethod
    def of(cls, paths, shapes) -> "TreeLayout":
        """The layout of leaves of ``shapes`` at key ``paths``."""
        layout = cls.__new__(cls)
        layout._set(list(paths), [tuple(s) for s in shapes])
        return layout

    def _set(self, paths, shapes) -> None:
        self.paths, self.shapes = paths, shapes
        self.sizes = [int(torch.Size(s).numel()) for s in shapes]
        self.n = sum(self.sizes)

    def flat(self, tree) -> torch.Tensor:
        """The leaves of ``tree`` concatenated in JAX's order."""
        return torch.cat([x.reshape(-1) for _, x in tree_items(tree)])

    def tree(self, flat: torch.Tensor) -> dict:
        """A nested dict of views of ``flat`` [n]."""
        out = {}
        for path, shape, x in zip(self.paths, self.shapes,
                                  flat.split(self.sizes)):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = x.view(shape)
        return out
