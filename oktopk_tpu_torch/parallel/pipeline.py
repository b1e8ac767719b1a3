"""GPipe and 1F1B pipeline parallelism over a pipe comm.

Counterpart of ``oktopk_tpu/parallel/pipeline.py``: every stage runs the
same program on its own stage's weights, microbatches hop stage to stage
on a ring, and the GPipe schedule (P + M - 1 ticks, bubble included)
runs all M microbatches before the optimizer step (a flush, so no weight
stashing is needed). Where the JAX package runs one ``shard_map`` rank
per stage, the port's ``comm`` is the pipe axis: ``StackedComm(P)``
holds every stage as a row of each tensor on one device,
``ProcessGroupComm`` one stage per process. A per-stage tensor is
``[W, ...]``, W being the stages this process holds
(``comm.local_workers``), the first being stage ``comm.first_worker``;
``stage_params`` is a sequence of W per-stage parameter sets.

The JAX pipeline's collectives and their transposes are three
``torch.autograd.Function``s here:

- ``ring_hop``: ``lax.ppermute`` along the ring (stage i -> i + 1); its
  backward is the inverse hop;
- ``bcast_from_last`` (JAX's ``_bcast_from_last``, :40-66): the psum of
  the last stage's masked value; its backward delivers the cotangent to
  the last stage only (a psum transpose would overcount it by P);
- ``to_rows``: a pipe-invariant value handed to every stage (the input
  microbatches); its backward is the psum over the stages of their
  cotangents, in stage order, as ``shard_map``'s transpose of the
  implicit broadcast. Only stage 0 reads it, so that sum is stage 0's.

Every stage takes part in every tick's hop. A stage's idle ticks (the
bubble: before its first microbatch and after its last) do not run the
stage: the JAX package runs them on clipped indices, but their outputs
are never banked and their cotangents are zero, so skipping them changes
no result. The stage's input passes through in their place, which keeps
every hop in the graph on every process, so the backward's hops run in
the same order everywhere (descending ticks) and a stage's gradient adds
its microbatches' terms in that order in both comms.

``remat`` recomputes a stage's activations in its backward
(``jax.checkpoint``, the reference's recompute flag) through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``; a stage that
draws dropout masks from keys redraws the same masks.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint


def _rank_mask(comm, x: torch.Tensor, stage: int) -> torch.Tensor:
    """[W, 1, ...] bool: which of this process's rows is ``stage``."""
    ranks = comm.rank(x.device)
    return (ranks == stage).view((-1,) + (1,) * (x.dim() - 1))


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, shift):
        ctx.comm, ctx.shift = comm, shift
        return comm.ppermute_ring(x, shift)

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm.ppermute_ring(ct.contiguous(), -ctx.shift), None, None


def ring_hop(x: torch.Tensor, comm, shift: int = 1) -> torch.Tensor:
    """[W, ...] -> [W, ...]: stage i's row to stage ``(i + shift) mod P``
    (``lax.ppermute``); the gradient hops back."""
    return _RingHop.apply(x, comm, shift)


class _BcastFromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        last = _rank_mask(comm, x, comm.size - 1)
        ctx.save_for_backward(last)
        return comm.psum(torch.where(last, x, torch.zeros_like(x))
                         ).contiguous()

    @staticmethod
    def backward(ctx, ct):
        (last,) = ctx.saved_tensors
        return torch.where(last, ct, torch.zeros_like(ct)), None


def bcast_from_last(x: torch.Tensor, comm) -> torch.Tensor:
    """Replicate the LAST stage's row of ``x`` [W, ...] to every stage.
    Value: the psum of a last-stage-masked buffer; gradient: the
    cotangent of the last stage's row alone."""
    return _BcastFromLast.apply(x, comm)


class _ToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.unsqueeze(0).expand(
            (comm.local_workers,) + tuple(x.shape)).clone()

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm.psum(ct.contiguous())[0], None


def to_rows(x: torch.Tensor, comm) -> torch.Tensor:
    """A value every stage holds alike -> [W, ...] rows; the gradient is
    the psum of the rows' cotangents over the stages."""
    return _ToRows.apply(x, comm)


def _params(p):
    """The tensors of one stage's parameter set."""
    if isinstance(p, nn.Module):
        return list(p.parameters())
    if isinstance(p, torch.Tensor):
        return [p]
    return list(p)


def gpipe_apply(stage_fn: Callable, stage_params: Sequence,
                microbatches: torch.Tensor, comm, num_microbatches: int,
                remat: bool = False) -> torch.Tensor:
    """Run the pipeline forward over all microbatches (differentiable).

    Args:
      stage_fn: ``(params, x, stage_index, mb_index) -> y``, one stage on
        one microbatch; ``x`` and ``y`` share their shape and dtype.
        ``mb_index`` is the microbatch the stage processes this tick, so
        the stage can index per-microbatch side inputs (attention masks).
      stage_params: W per-stage parameter sets, row w being stage
        ``comm.first_worker + w`` (a sequence, or a [W, ...] tensor).
      microbatches: [M, mb, ...], the same on every stage; only stage 0
        reads it.
      comm: the pipe comm.
      num_microbatches: M.
      remat: recompute stage activations in backward.

    Returns: [W, M, mb, ...], every row the LAST stage's outputs.
    """
    P, W, first = comm.size, comm.local_workers, comm.first_worker
    M = num_microbatches
    if remat:
        def fn(p, x, s, m):
            return checkpoint(stage_fn, p, x, s, m, use_reentrant=False,
                              preserve_rng_state=False)
    else:
        fn = stage_fn
    rows = to_rows(microbatches, comm)              # [W, M, mb, ...]
    injects = rows.unbind(1)
    is_first = _rank_mask(comm, rows[:, 0], 0)
    incoming = torch.zeros_like(rows[:, 0])
    banked = []
    for t in range(M + P - 1):
        # stage 0 injects microbatch t (while t < M); the others take
        # the wire
        x = torch.where(is_first, injects[min(t, M - 1)], incoming)
        ys = []
        for w in range(W):
            s = first + w
            m = t - s               # the microbatch stage s runs this tick
            ys.append(fn(stage_params[w], x[w], s, m) if 0 <= m < M
                      else x[w])
        y = torch.stack(ys)
        if t >= P - 1:              # the last stage's microbatch t - (P-1)
            banked.append(y)
        if t < M + P - 2:           # the last tick's hop feeds nothing
            incoming = ring_hop(y, comm)
    return bcast_from_last(torch.stack(banked, 1), comm)


def gpipe_loss(stage_fn: Callable, loss_fn: Callable, stage_params,
               microbatches: torch.Tensor, targets, comm,
               num_microbatches: int, remat: bool = False) -> torch.Tensor:
    """Mean of ``loss_fn(outputs[m], targets[m])`` over the microbatches
    through the pipeline; a 0-d tensor, the same on every stage (taken
    from the last stage's row, whose cotangent the pipeline keeps).
    ``backward`` of it is the pipeline's backward."""
    outs = gpipe_apply(stage_fn, stage_params, microbatches, comm,
                       num_microbatches, remat)[-1]
    return torch.stack([loss_fn(outs[m], targets[m])
                        for m in range(num_microbatches)]).mean()


def one_f_one_b(stage_fn: Callable, loss_fn: Callable, stage_params,
                microbatches: torch.Tensor, targets, comm,
                num_microbatches: int):
    """The 1F1B-with-flushes schedule: ``(mean_loss [W], stage_grads)``.

    Numerically the gradient of ``gpipe_loss`` (one set of weights for
    every microbatch, a flush), with O(P) stashed stage inputs instead of
    GPipe's O(M). Tick t of stage s runs the forward of microbatch
    ``t - s`` and the backward of microbatch ``t - 2(P - 1) + s`` (the
    last stage back-props a microbatch the tick it forwards it); the
    backward recomputes the stage from its stashed input (the
    reference's recompute). Activations hop up the ring, cotangents down.
    ``stage_grads`` is a list of W per-stage gradients, each a tensor or
    a list of tensors as its parameter set (a module's: its
    ``parameters()`` order); the loss is the same on every row.
    """
    P, W, first = comm.size, comm.local_workers, comm.first_worker
    M = num_microbatches
    Wn = 2 * P - 1          # microbatches in flight at stage 0, inclusive
    x_shape = microbatches.shape[1:]
    dev, dtype = microbatches.device, microbatches.dtype
    fwd_wire = torch.zeros((W,) + tuple(x_shape), dtype=dtype, device=dev)
    bwd_wire = torch.zeros_like(fwd_wire)
    stash = [[None] * Wn for _ in range(W)]
    gacc = [[torch.zeros_like(t) for t in _params(p)]
            for p in list(stage_params)[:W]]
    lacc = torch.zeros(W, dtype=torch.float32, device=dev)
    for t in range(M + 2 * P - 2):
        ys, cts = [], []
        for w in range(W):
            s, p = first + w, stage_params[w]
            m_f = t - s
            y = torch.zeros(x_shape, dtype=dtype, device=dev)
            if 0 <= m_f < M:
                x = microbatches[m_f] if s == 0 else fwd_wire[w]
                with torch.no_grad():
                    y = stage_fn(p, x, s, m_f)
                stash[w][m_f % Wn] = x
            ys.append(y)
            m_b = t - 2 * (P - 1) + s
            ct_in = torch.zeros(x_shape, dtype=dtype, device=dev)
            if 0 <= m_b < M:
                ps = _params(p)
                leaves = ps if isinstance(p, nn.Module) else [
                    q.detach().requires_grad_() for q in ps]
                arg = p if isinstance(p, nn.Module) else (
                    leaves[0] if isinstance(p, torch.Tensor) else leaves)
                with torch.enable_grad():
                    xx = stash[w][m_b % Wn].detach().requires_grad_()
                    y_b = stage_fn(arg, xx, s, m_b)
                    if s == P - 1:
                        yy = y_b.detach().requires_grad_()
                        loss = loss_fn(yy, targets[m_b])
                        (ct_out,) = torch.autograd.grad(loss, yy)
                        lacc[w] += loss.detach().to(torch.float32)
                    else:
                        ct_out = bwd_wire[w]
                    *gp, ct_in = torch.autograd.grad(
                        y_b, leaves + [xx], ct_out, allow_unused=True)
                gacc[w] = [a + (torch.zeros_like(a) if g is None else g)
                           for a, g in zip(gacc[w], gp)]
                stash[w][m_b % Wn] = None
            cts.append(ct_in)
        fwd_wire = comm.ppermute_ring(torch.stack(ys), 1)
        bwd_wire = comm.ppermute_ring(torch.stack(cts), -1)
    loss = comm.psum(lacc) / M
    grads = []
    for p, g in zip(list(stage_params)[:W], gacc):
        g = [x / M for x in g]
        grads.append(g[0] if isinstance(p, torch.Tensor) else g)
    return loss, grads
