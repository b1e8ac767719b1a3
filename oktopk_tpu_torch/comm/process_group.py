"""Collectives over a ``torch.distributed`` process group: one worker per
process.

Counterpart of ``oktopk_tpu/comm/primitives.py:19-114`` over the mesh of
``comm/mesh.py`` when it spans processes: the same interface as
``StackedComm`` (``comm/stacked.py``) with ``local_workers = 1``, so every
per-worker tensor is ``[1, ...]`` and holds this rank's row.

Every result is bit-equal to ``StackedComm``'s row for this rank:

- ``psum`` of floats adds in rank order (0 + 1 + ... + P-1), as the JAX
  CPU mesh does (H6). NCCL's and gloo's ``all_reduce`` add in ring or
  tree order, which is not bit-equal to that, so a float ``psum`` is a
  reduce-scatter in rank order: the n elements, padded to a multiple of
  P, go out as P chunks in one ``all_to_all_single``; rank r adds the P
  copies of its chunk r in rank order; one ``all_gather`` of the summed
  chunks gives every rank the whole sum. Every element is the same sum
  in the same order as ``StackedComm.psum``'s, and each rank sends and
  receives 2(P-1)/P·n floats, a ring allreduce's volume. An integer
  ``psum`` is one ``all_reduce``: integer sums are exact in any order.
- ``all_to_all`` is one ``all_to_all_single`` on the ``[P, ...]`` buffer;
  row q of the result is what rank q addressed here, in source-rank
  order (``ops/select.py::scatter_rows`` adds them in that order, H2).
- ``ppermute_pair`` (gtopk's XOR butterfly) and ``ppermute_ring`` (the
  pipeline's hop) are one ``all_to_all_single`` whose split sizes are
  nonzero only for the partners: gloo has no send/recv of CUDA tensors.
- ``gather`` is one ``dist.gather`` to the group's rank 0 (a
  checkpoint's per-worker rows, which rank 0 alone writes).
- The data-moving verbs carry bf16 values as they are; no verb does
  arithmetic on bf16.

The gloo backend takes CUDA tensors for these verbs and stages them
through the host itself; NCCL moves them card to card.

A comm may span a subgroup (``dist.new_group``): then its size, its
ranks and the rank order of its sums are those of the group.
``hierarchical_process_comm`` builds the two levels of
``collectives/hierarchical.py`` that way, one group per pod and one per
member index across the pods.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


class ProcessGroupComm:
    """This process's one worker in a ``torch.distributed`` group (the
    default group unless ``group`` is given); ``first_worker`` is its rank
    in that group."""

    local_workers = 1
    # a branch on a value every rank holds equal is taken on the host
    # (collectives/topk_sa.py); see that module for why
    branch_on_host = True

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs an initialised "
                               "process group (launch.maybe_initialize)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.first_worker = dist.get_rank(group)
        self.backend = dist.get_backend(group)

    def axis_size(self) -> int:
        """World size P (``compat.axis_size``)."""
        return self.size

    def rank(self, device) -> torch.Tensor:
        """[1] i32: this worker's rank (``lax.axis_index``)."""
        return torch.full((1,), self.first_worker, dtype=torch.int32,
                          device=device)

    @staticmethod
    def _check(x: torch.Tensor):
        if x.shape[0] != 1:
            raise ValueError(
                f"leading worker dimension {x.shape[0]} != 1")

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Allreduce-sum; floats added in rank order (see the module
        docstring), integers by ``all_reduce``."""
        self._check(x)
        if not x.is_floating_point():
            out = x.clone()
            dist.all_reduce(out, group=self.group)
            return out
        if x.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"psum adds float32 or float64, not {x.dtype}")
        P, n = self.size, x[0].numel()
        c = -(-n // P)                       # chunk length
        flat = torch.nn.functional.pad(x.reshape(-1), (0, c * P - n))
        got = torch.empty_like(flat)
        dist.all_to_all_single(got, flat,    # row q: rank q's chunk r
                               group=self.group)
        g = got.view(P, c)
        s = g[0].clone()
        for p in range(1, P):
            s = s + g[p]
        return self.all_gather(s.unsqueeze(0))[0].reshape(-1)[:n].view(
            x.shape)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """psum then divide by P (``lax.pmean``)."""
        return self.psum(x) / self.size

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[1, ...] -> [1, P, ...]: every rank's row, in rank order."""
        self._check(x)
        out = torch.empty((1, self.size) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather(list(out[0].unbind(0)), x[0].contiguous(),
                        group=self.group)
        return out

    def gather(self, x: torch.Tensor):
        """[1, ...] -> [1, P, ...] on the group's rank 0: every rank's row,
        in rank order; None on the other ranks (a checkpoint's rows,
        which rank 0 alone writes)."""
        self._check(x)
        dst = 0 if self.group is None else dist.get_global_rank(self.group,
                                                                0)
        if self.first_worker != 0:
            dist.gather(x[0].contiguous(), None, dst=dst, group=self.group)
            return None
        out = torch.empty((1, self.size) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.gather(x[0].contiguous(), list(out[0].unbind(0)), dst=dst,
                    group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """[1, P, ...] -> [1, P, ...]: row q is what rank q addressed to
        this rank (``lax.all_to_all`` with split and concat axis 0)."""
        self._check(x)
        if x.shape[1] != self.size:
            raise ValueError(
                f"all_to_all wants [1, P, ...], got {tuple(x.shape)}")
        out = torch.empty_like(x)
        dist.all_to_all_single(out[0], x[0].contiguous(), group=self.group)
        return out

    def ppermute_pair(self, x: torch.Tensor, distance: int) -> torch.Tensor:
        """Butterfly exchange: receive the row of rank ``rank ^ distance``
        (``primitives.ppermute_pair``, gtopk's XOR partner)."""
        self._check(x)
        if distance <= 0 or max(i ^ distance
                                for i in range(self.size)) >= self.size:
            raise ValueError(f"XOR distance {distance} does not pair the "
                             f"{self.size} workers")
        splits = [0] * self.size
        splits[self.first_worker ^ distance] = 1
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(),
                               output_split_sizes=splits,
                               input_split_sizes=splits,
                               group=self.group)
        return out

    def ppermute_ring(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Ring shift: receive the row of rank ``(rank - shift) mod P``
        while this rank's row goes to ``(rank + shift) mod P`` (the
        pipeline's hop). One ``all_to_all_single`` whose split sizes are
        nonzero only for those two partners, as ``ppermute_pair``: gloo
        has no send/recv of CUDA tensors, and the one code path serves
        both backends."""
        self._check(x)
        P, r = self.size, self.first_worker
        dst, src = (r + shift) % P, (r - shift) % P
        if dst == r:
            return x.clone()
        send, recv = [0] * P, [0] * P
        send[dst], recv[src] = 1, 1
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(),
                               output_split_sizes=recv,
                               input_split_sizes=send, group=self.group)
        return out

    def replicate_(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Overwrite ``tensors`` with the group's rank 0's, in place, by one
        broadcast of their concatenation (the trainer's initial weights
        and BatchNorm statistics); returns how many of this rank's
        elements it changed (a 0-d int64 on their device)."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        mine = flat.clone()
        # ``src`` is a rank of the default group
        src = 0 if self.group is None else dist.get_global_rank(self.group,
                                                                0)
        dist.broadcast(flat, src=src, group=self.group)
        changed = (flat != mine).sum()
        off = 0
        with torch.no_grad():
            for t in tensors:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
        return changed

    def broadcast_object(self, obj, src: int = 0):
        """The group's rank ``src``'s ``obj`` (a picklable host value), on
        every rank: a host-side decision that one rank alone can make,
        such as which checkpoint file a restore loads (rank 0's) or the
        descriptor of a feedback vote that rank passed."""
        box = [obj]
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]


class HierarchicalProcessComm:
    """Two levels of one worker per process: ``num_pods`` pods of
    ``pod_size`` consecutive ranks of the default group, rank r member
    ``r % pod_size`` of pod ``r // pod_size`` (the layout of
    ``comm/stacked.py::HierarchicalStackedComm``).

    ``intra`` spans this rank's pod; ``inter`` the ranks of this member
    index in every pod, in pod order. Every rank runs the level across
    pods over its own ``inter`` group, so ``pod_size`` such exchanges run
    side by side on identical data, as in the JAX emulation, and each
    rank's row equals the stacked comm's row for it.
    """

    local_workers = 1
    branch_on_host = True

    def __init__(self, num_pods: int, pod_size: int):
        if not dist.is_initialized():
            raise RuntimeError("HierarchicalProcessComm needs an "
                               "initialised process group")
        world = dist.get_world_size()
        if num_pods < 1 or pod_size < 1 or num_pods * pod_size != world:
            raise ValueError(f"{num_pods} pods x {pod_size} need "
                             f"{num_pods * pod_size} processes, have {world}")
        self.num_pods, self.pod_size = int(num_pods), int(pod_size)
        self.size = world
        self.first_worker = dist.get_rank()
        pod, member = divmod(self.first_worker, self.pod_size)
        # every rank creates every group, in the same order, including the
        # groups it is not in: ``new_group`` is collective over the world
        intra = [dist.new_group([p * pod_size + m for m in range(pod_size)])
                 for p in range(num_pods)]
        inter = [dist.new_group([p * pod_size + m for p in range(num_pods)])
                 for m in range(pod_size)]
        self.intra = ProcessGroupComm(intra[pod])
        self.inter = ProcessGroupComm(inter[member])
        self.backend = self.intra.backend

    def pod_mean(self, x: torch.Tensor) -> torch.Tensor:
        """[1, ...]: the pod's mean, added in member order, then divided by
        ``pod_size`` (``lax.pmean`` over the pod axis)."""
        return self.intra.pmean(x)

    @staticmethod
    def leaders(x: torch.Tensor) -> torch.Tensor:
        """This rank's row: every rank takes part in the level across
        pods."""
        return x

    @staticmethod
    def spread(x: torch.Tensor) -> torch.Tensor:
        return x


def hierarchical_process_comm(num_pods: int,
                              pod_size: int) -> HierarchicalProcessComm:
    """The two-level comm over the default group's processes, one worker
    each; every rank must call it, in the same order as its other
    ``new_group`` calls."""
    return HierarchicalProcessComm(num_pods, pod_size)
