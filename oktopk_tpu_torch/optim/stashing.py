"""Weight stashing for pipeline-parallel training (PipeDream-style).

Counterpart of ``oktopk_tpu/optim/stashing.py:50-172`` (the reference's
``OptimizerWithStashing`` and ``OptimizerWithStashingAndAggregation``),
as transforms of dicts of tensors: state in, state out.

- The queue holds the last ``num_versions`` parameter versions, each
  leaf stacked [V, ...], ``leaf[0]`` the oldest; it starts as
  ``num_versions`` copies of the initial parameters.
- ``backward_params``: the oldest version, the weights a delayed
  backward pass must see; ``forward_params``: the newest, what new
  microbatches enter the pipe with and what the step updates.
- ``stash_step``: grads divided by ``update_interval``, the base update
  applied to the newest version, the version counter bumped, the result
  pushed into the ring (the oldest evicted).

With ``num_versions == 1`` forward == backward == latest: plain SGD. The
aggregating variant keeps two versions and picks one by
``max(counter // update_interval - 1, 0)``, stepping once per window.
The pipelines of ``parallel/pipeline.py`` flush, so they need no stash;
this is the no-flush PipeDream mode's optimizer.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class StashState(NamedTuple):
    """``queue``: a dict tree whose leaves are [num_versions, ...];
    ``latest_version``: the number of optimizer steps taken (an int32
    0-d tensor)."""
    queue: Any
    latest_version: torch.Tensor


def stash_init(params, num_versions: int) -> StashState:
    """The queue as ``num_versions`` copies of ``params``."""
    if num_versions < 1:
        raise ValueError(f"num_versions must be >= 1, got {num_versions}")
    queue = _map(lambda p: p.unsqueeze(0).repeat(
        (num_versions,) + (1,) * p.dim()), params)
    leaf = next(iter(_leaves(params)))
    return StashState(queue=queue, latest_version=torch.zeros(
        (), dtype=torch.int32, device=leaf.device))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def backward_params(state: StashState):
    """The oldest stashed version (reference ``load_backward_params``)."""
    return _map(lambda q: q[0], state.queue)


def forward_params(state: StashState):
    """The newest version (reference ``load_forward_params``)."""
    return _map(lambda q: q[-1], state.queue)


def stash_step(state: StashState, grads, update_fn: Callable, opt_state,
               update_interval: int = 1):
    """One optimizer step with weight stashing: ``update_fn(params, grads,
    opt_state) -> (new_params, new_opt_state)`` on the newest version,
    ``grads`` divided by ``update_interval`` first. Returns
    ``(new_stash_state, new_opt_state)``."""
    params = forward_params(state)
    if update_interval != 1:
        grads = _map(lambda g: g / update_interval, grads)
    new_params, new_opt_state = update_fn(params, grads, opt_state)
    queue = _map(lambda q, p: torch.cat([q[1:], p.unsqueeze(0)], 0),
                 state.queue, new_params)
    return (StashState(queue=queue,
                       latest_version=state.latest_version + 1),
            new_opt_state)


class AggregatingStashState(NamedTuple):
    """Two stashed versions and the forward/backward counters."""
    stash: StashState
    forward_counter: torch.Tensor
    backward_counter: torch.Tensor


def aggregating_init(params, update_interval: int) -> AggregatingStashState:
    del update_interval
    stash = stash_init(params, num_versions=2)
    zero = torch.zeros_like(stash.latest_version)
    return AggregatingStashState(stash=stash, forward_counter=zero,
                                 backward_counter=zero.clone())


def _select_version(state: AggregatingStashState, counter,
                    update_interval: int):
    """The version ``max(counter // update_interval - 1, 0)``: the newest
    if it is at least the latest, else the older one."""
    desired = torch.clamp(counter // update_interval - 1, min=0)
    take_newest = desired >= state.stash.latest_version
    return _map(lambda new, old: torch.where(take_newest, new, old),
                forward_params(state.stash), backward_params(state.stash))


def aggregating_forward_params(state: AggregatingStashState,
                               update_interval: int):
    """Params for the next forward pass; bumps the forward counter."""
    params = _select_version(state, state.forward_counter, update_interval)
    return params, state._replace(forward_counter=state.forward_counter + 1)


def aggregating_backward_params(state: AggregatingStashState,
                                update_interval: int):
    """Params for the next backward pass; bumps the backward counter."""
    params = _select_version(state, state.backward_counter,
                             update_interval)
    return params, state._replace(
        backward_counter=state.backward_counter + 1)


def aggregating_step(state: AggregatingStashState, grads,
                     update_fn: Callable, opt_state, update_interval: int):
    """Step once per aggregation window: ``grads`` (summed over the
    window by the caller) divided by ``update_interval``, applied to the
    newest version, the ring rotated."""
    new_stash, new_opt_state = stash_step(
        state.stash, grads, update_fn, opt_state,
        update_interval=update_interval)
    return state._replace(stash=new_stash), new_opt_state
