"""Collectives over P data-parallel workers stacked on one device.

Counterpart of ``oktopk_tpu/comm/primitives.py:19-114`` and the virtual
mesh of ``oktopk_tpu/comm/mesh.py``: where the JAX package runs P shards
of a ``shard_map`` (one per virtual CPU device or TPU core), this comm
keeps the P workers as the leading dimension of every per-worker tensor
on a single device, and each collective is an exact tensor operation on
that dimension.

Every per-worker tensor has a leading ``[W, ...]`` dimension, W being the
number of workers this process holds (``local_workers``): all P of them
here, the first being worker 0 (``first_worker``).
``comm/process_group.py::ProcessGroupComm`` keeps the same interface with
W = 1 worker per process.

``hierarchical_comm`` is the two-level counterpart of
``oktopk_tpu/comm/mesh.py:52-83`` (``hierarchical_mesh``): ``num_pods``
pods of ``pod_size`` consecutive workers, for
``collectives/hierarchical.py``.
"""

from __future__ import annotations

import torch


class StackedComm:
    """P workers as dimension 0 of every tensor on one device."""

    first_worker = 0
    # a branch on a device value is taken by ``torch.where`` on the device
    # (collectives/topk_sa.py): no step waits for the card
    branch_on_host = False

    def __init__(self, num_workers: int):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.size = int(num_workers)
        self.local_workers = self.size

    def axis_size(self) -> int:
        """World size P (``compat.axis_size``)."""
        return self.size

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

    def ppermute_pair(self, x: torch.Tensor, distance: int) -> torch.Tensor:
        """Butterfly exchange: row i receives row ``i ^ distance``
        (``primitives.ppermute_pair``, gtopk's XOR partner)."""
        self._check(x)
        src = [i ^ distance for i in range(self.size)]
        if distance <= 0 or max(src) >= self.size:
            raise ValueError(f"XOR distance {distance} does not pair the "
                             f"{self.size} workers")
        return x[src]

    def ppermute_ring(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Ring shift: row i receives row ``(i - shift) mod P``
        (``lax.ppermute`` with the permutation ``[(i, (i + shift) % P)]``,
        the pipeline's hop)."""
        self._check(x)
        return torch.roll(x, shift, 0)


class HierarchicalStackedComm:
    """``num_pods`` pods of ``pod_size`` workers, all stacked on one device:
    worker w is member ``w % pod_size`` of pod ``w // pod_size``, as in
    the JAX package's ``hierarchical_mesh``, whose consecutive devices
    share a pod.

    ``intra`` is the pod level (``pod_size`` members), ``inter`` the level
    across pods (``num_pods`` workers). After ``pod_mean`` every member of
    a pod holds identical rows, so the level across pods runs once per
    pod, on the pod leaders' rows (``leaders``), and its results go back
    to every member's row (``spread``): bit-equal to the JAX emulation,
    where every member runs the identical exchange, with ``num_pods``
    kernel calls a step instead of ``num_pods * pod_size``.
    """

    first_worker = 0
    branch_on_host = False

    def __init__(self, num_pods: int, pod_size: int):
        if num_pods < 1 or pod_size < 1:
            raise ValueError("need num_pods >= 1 and pod_size >= 1, got "
                             f"{num_pods}x{pod_size}")
        self.num_pods, self.pod_size = int(num_pods), int(pod_size)
        self.size = self.num_pods * self.pod_size
        self.local_workers = self.size
        self.intra = StackedComm(self.pod_size)
        self.inter = StackedComm(self.num_pods)

    def pod_mean(self, x: torch.Tensor) -> torch.Tensor:
        """[W, ...] -> [W, ...]: each row its pod's mean, the members added
        in index order and the sum divided by ``pod_size``
        (``lax.pmean`` over the pod axis)."""
        if x.shape[0] != self.size:
            raise ValueError(
                f"leading worker dimension {x.shape[0]} != {self.size}")
        v = x.reshape((self.num_pods, self.pod_size) + tuple(x.shape[1:]))
        return self.spread(self.intra.psum(v.transpose(0, 1))[0]
                           / self.pod_size)

    def leaders(self, x: torch.Tensor) -> torch.Tensor:
        """[W, ...] -> [num_pods, ...]: the first member's row of each
        pod."""
        return x[::self.pod_size]

    def spread(self, x: torch.Tensor) -> torch.Tensor:
        """[num_pods, ...] -> [W, ...]: each pod's row to every member, as
        its own copy."""
        return x.repeat_interleave(self.pod_size, 0)


def hierarchical_comm(num_pods: int, pod_size: int) -> HierarchicalStackedComm:
    """Two-level comm of ``num_pods * pod_size`` workers stacked on one
    device (``hierarchical_mesh``)."""
    return HierarchicalStackedComm(num_pods, pod_size)
