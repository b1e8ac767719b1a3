"""Collectives over P data-parallel workers stacked on one device.

Counterpart of ``oktopk_tpu/comm/primitives.py:19-68`` and the virtual
mesh of ``oktopk_tpu/comm/mesh.py``: where the JAX package runs P shards
of a ``shard_map`` (one per virtual CPU device or TPU core), this comm
keeps the P workers as the leading dimension of every per-worker tensor
on a single device, and each collective is an exact tensor operation on
that dimension.

Every per-worker tensor has a leading ``[W, ...]`` dimension, W being the
number of workers this process holds (``local_workers``): all P of them
here. A ``torch.distributed`` backend for a multi-card cell keeps the
same interface with W = 1.
"""

from __future__ import annotations

import torch


class StackedComm:
    """P workers as dimension 0 of every tensor on one device."""

    def __init__(self, num_workers: int):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.size = int(num_workers)
        self.local_workers = self.size

    def rank(self, device) -> torch.Tensor:
        """[W] i32: each worker's rank (``lax.axis_index``)."""
        return torch.arange(self.size, dtype=torch.int32, device=device)

    def _check(self, x: torch.Tensor):
        if x.shape[0] != self.size:
            raise ValueError(
                f"leading worker dimension {x.shape[0]} != {self.size}")

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Allreduce-sum, added in rank order (0 + 1 + ... + P-1) as the
        JAX CPU mesh does, so float sums agree bit-for-bit; the result is
        broadcast back to every worker row."""
        self._check(x)
        s = x[0].clone()
        for p in range(1, self.size):
            s = s + x[p]
        return s.unsqueeze(0).expand_as(x)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """psum then divide by P (``lax.pmean``)."""
        return self.psum(x) / self.size

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[W, ...] -> [W, P, ...]: every worker receives every row."""
        self._check(x)
        return x.unsqueeze(0).expand((self.size,) + tuple(x.shape))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """[W, P, ...] -> [W, P, ...]: row q of worker p is what worker q
        addressed to p (``lax.all_to_all`` with split and concat axis 0)."""
        self._check(x)
        if x.shape[1] != self.size:
            raise ValueError(
                f"all_to_all wants [P, P, ...], got {tuple(x.shape)}")
        return x.transpose(0, 1)
