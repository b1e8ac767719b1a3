"""The data x inner grid that the pipeline, sequence and tensor parallel
paths share.

Counterpart of the two-axis meshes of ``oktopk_tpu/parallel/``
(``make_pipeline_mesh``, ``make_seq_mesh``, ``make_tp_mesh``,
``make_moe_mesh``):
``Mesh(devices.reshape(dp, size), ("data", inner))``. The port's grid is
two comms:

- stacked on one device: ``data = StackedComm(dp)`` and ``inner =
  StackedComm(size)``;
- across processes: worker ``d * size + i`` (the JAX device order) is data
  row d and inner rank i; its ``inner`` comm is the ``dist.new_group`` of
  its data row and its ``data`` comm the group of its inner rank. Every
  rank creates every group in the same order: the inner groups of data
  rows 0..dp-1, then the data groups of inner ranks 0..size-1
  (``new_group`` is collective over the world).

``PipelineGrid``, ``SeqGrid``, ``TPGrid`` and ``ExpertGrid`` name the
inner axis ``pipe``, ``seq``, ``model`` and ``expert``.
"""

from __future__ import annotations

from typing import Optional

from oktopk_tpu_torch.comm import ProcessGroupComm, StackedComm


class DataGrid:
    """``dp`` data rows x ``size`` inner ranks: ``data`` spans this
    process's inner rank(s) over the data rows, ``inner`` this process's
    data row(s) over the inner ranks."""

    def __init__(self, dp: int, size: int, data, inner):
        self.dp, self.size, self.data, self.inner = dp, size, data, inner

    @property
    def distributed(self) -> bool:
        return self.inner.local_workers < self.size

    @property
    def data_rows(self) -> range:
        f = self.data.first_worker
        return range(f, f + self.data.local_workers)

    @property
    def inner_ranks(self) -> range:
        f = self.inner.first_worker
        return range(f, f + self.inner.local_workers)


class PipelineGrid(DataGrid):
    """Data rows x pipeline stages (``pipe``)."""

    pp = property(lambda self: self.size)
    pipe = property(lambda self: self.inner)
    stages = property(lambda self: self.inner_ranks)


class SeqGrid(DataGrid):
    """Data rows x sequence shards (``seq``)."""

    sp = property(lambda self: self.size)
    seq = property(lambda self: self.inner)
    shards = property(lambda self: self.inner_ranks)


class TPGrid(DataGrid):
    """Data rows x tensor-parallel ranks (``model``)."""

    tp = property(lambda self: self.size)
    model = property(lambda self: self.inner)
    shards = property(lambda self: self.inner_ranks)


class ExpertGrid(DataGrid):
    """Data rows x expert shards (``expert``): worker ``d * ep + e`` holds
    expert shard e and takes chunk ``d * ep + e`` of the global batch
    (JAX's ``P((data, expert))``)."""

    ep = property(lambda self: self.size)
    expert = property(lambda self: self.inner)
    shards = property(lambda self: self.inner_ranks)


def make_grid(cls, size: int, num_workers: Optional[int] = None,
              what: str = "inner size"):
    """A ``cls`` grid of ``num_workers`` workers (dp = workers // size):
    stacked on one device, or, when a process group of more than one
    process is up, one worker per process over the world (``num_workers``
    None or the world size)."""
    import torch.distributed as dist

    procs = dist.is_initialized() and dist.get_world_size() > 1
    world = dist.get_world_size() if procs else (num_workers or size)
    if procs and num_workers not in (None, world):
        raise ValueError(f"{num_workers} workers on a launch of {world} "
                         "processes: one worker per process")
    if world % size != 0:
        raise ValueError(f"{world} workers not divisible by {what} {size}")
    dp = world // size
    if not procs:
        return cls(dp, size, StackedComm(dp), StackedComm(size))
    d, i = divmod(dist.get_rank(), size)
    inners = [dist.new_group([r * size + j for j in range(size)])
              for r in range(dp)]
    datas = [dist.new_group([r * size + j for r in range(dp)])
             for j in range(size)]
    return cls(dp, size, ProcessGroupComm(datas[i]),
               ProcessGroupComm(inners[d]))
