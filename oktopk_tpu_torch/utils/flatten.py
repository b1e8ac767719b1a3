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
    items = tree_items(tree)
    leaves = [x for _, x in items]
    flat = torch.cat([x.reshape(-1) for x in leaves])
    return flat, leaves, [p for p, _ in items]


def unflatten_tree(flat: torch.Tensor, leaves, treedef) -> dict:
    """Inverse of :func:`flatten_tree` (shapes from ``leaves``): a nested
    dict of views of ``flat``."""
    out, off = {}, 0
    for path, x in zip(treedef, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[off:off + x.numel()].view(x.shape)
        off += x.numel()
    return out
