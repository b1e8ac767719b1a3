"""Megatron's f/g pair: the ``shard_map`` transposes of a value replicated
over an axis, as autograd Functions over a comm.

Under ``check_vma=True`` JAX tracks which values vary over a mesh axis
and which every rank holds alike (invariant), and transposes the two
crossings between them:

- ``psum`` (g): per-rank terms -> their sum, a value every rank holds
  alike. Its transpose hands each rank its own cotangent: the ranks'
  cotangents of an invariant value are equal, and summing them would
  count that cotangent once per rank;
- ``pvary`` (f): an invariant value (a replicated parameter, a layer
  input every rank holds alike) -> a value each rank uses on its own
  data. Its transpose is the psum of the ranks' cotangents.

``all_to_all`` (the MoE dispatch, split and concat axis 0) is its own
transpose: the cotangent of what rank q sent to rank p is what p hands
back to q.

Between one copy of a value and rows of it (the one-copy losses of the
dense steps) stand ``replicate`` (one copy -> rows; the gradient is one
row's) and ``first`` (rows every worker holds alike -> one copy; the
cotangent goes to every row).

Plain autograd through ``comm.psum`` (the sum, expanded to every row)
returns the sum of the rows' cotangents to every row: right for g only
when a single row's output is read, and P times too much when every
rank goes on with its own copy, as each rank of a tensor- or
sequence-parallel layer does. Tensors are ``[W, ...]`` rows, W being the
ranks this process holds (``comm.local_workers``); every row of an
invariant value is one rank's own copy. Both comms add a psum in rank
order, so the stacked rows and the ranks across processes agree bit for
bit.
"""

from __future__ import annotations

import torch


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.psum(x).contiguous()

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def psum(x: torch.Tensor, comm) -> torch.Tensor:
    """[W, ...] per-rank terms -> [W, ...], every row their sum (rank
    order); the gradient of each row is that row's cotangent."""
    return _Psum.apply(x, comm)


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm.psum(ct.contiguous()).contiguous(), None


def pvary(x: torch.Tensor, comm) -> torch.Tensor:
    """[W, ...] rows every rank holds alike, to be used by each rank on its
    own data: the value unchanged, the gradient of each row the psum
    (rank order) of every rank's cotangent."""
    return _Pvary.apply(x, comm)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W):
        return x.unsqueeze(0).expand((W,) + tuple(x.shape)).clone()

    @staticmethod
    def backward(ctx, ct):
        return ct[0], None


def replicate(x: torch.Tensor, W: int) -> torch.Tensor:
    """One copy -> [W, ...] rows of it; the gradient is row 0's (the rows'
    cotangents of a replicated value are equal: each is the whole
    gradient)."""
    return _Replicate.apply(x, W)


class _First(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.W = x.shape[0]
        return x[0].clone()

    @staticmethod
    def backward(ctx, ct):
        return ct.unsqueeze(0).expand((ctx.W,) + tuple(ct.shape))


def first(x: torch.Tensor) -> torch.Tensor:
    """[W, ...] rows every worker holds alike -> the value; the cotangent
    goes to every row (each worker seeds its own copy)."""
    return _First.apply(x)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_to_all(x).contiguous()

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm.all_to_all(ct.contiguous()).contiguous(), None


def all_to_all(x: torch.Tensor, comm) -> torch.Tensor:
    """[W, P, ...] -> [W, P, ...]: row q of rank p is what rank q
    addressed to p (``lax.all_to_all``, split and concat axis 0); the
    gradient is the all_to_all of the cotangent (a ``ProcessGroupComm``'s
    ``all_to_all_single`` has no autograd of its own)."""
    return _AllToAll.apply(x, comm)
