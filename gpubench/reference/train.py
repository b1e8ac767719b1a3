"""A few data-parallel training steps, plain PyTorch.

P workers hold the same parameters (one flat float32 vector in JAX's
leaf order). Each step, worker w takes rows [w b, (w + 1) b) of the
global batch, computes its loss and its gradient of the flat vector, the
exchange reduces the P gradients, and the optimizer updates the vector.
Dropout keys follow the JAX training step: the run's key is
PRNGKey(seed + 1), split every step into the next key and the step's
key; worker w folds its index into the step's key and splits that once,
the second half being its apply's dropout key.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from gpubench.reference import optim, prng
from gpubench.reference.precision import PRECISIONS, use_float32


def family(name: str):
    """The reference module of a model family (``reference/<name>.py``)."""
    return importlib.import_module(f"gpubench.reference.{name}")


def exchange(name: str):
    """The reference of a gradient exchange, by the cell's compressor
    (``reference/exchange_<name>.py``: ``context``, ``program_settings``,
    ``steady``, ``init_state``, ``allreduce``)."""
    try:
        return importlib.import_module(f"gpubench.reference.exchange_{name}")
    except ModuleNotFoundError as e:
        if e.name != f"gpubench.reference.exchange_{name}":
            raise
        raise ValueError(f"no reference exchange {name!r}") from None


def views(flat: torch.Tensor, table) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for path, shape, _ in table:
        size = 1
        for s in shape:
            size *= s
        out[path] = flat[off:off + size].view(shape)
        off += size
    return out


def run(config: Dict, compressor: str, density: float, w0: torch.Tensor,
        batches: List[Dict[str, torch.Tensor]], seed: int,
        precision: str = "float32") -> Dict:
    """Train ``len(batches)`` steps from ``w0``; returns each step's mean
    loss over the workers and worker 0's wire bytes, the gradient the
    optimizer received in step 1 (worked out from its state, as from the
    program's), and the parameters after the last step."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}")
    use_float32()
    fam = family(config["family"])
    model = config["model"]
    table = fam.leaf_table(model)
    P = config["data_parallel_workers"]
    n = w0.numel()
    opt = optim.build(config["training"])
    ex = exchange(compressor)
    ctx = ex.context(n, P, density, config)
    state = ex.init_state(ctx, w0.device)
    rng = prng.prng_key(seed + 1)
    dropout = fam.uses_dropout(model)
    p = w0.clone()
    out = {"losses": [], "wire_bytes": []}
    for s, batch in enumerate(batches):
        rng, step_key = prng.split(rng)
        rows = batch[next(iter(batch))].shape[0]
        b = rows // P
        grads = torch.empty((P, n), dtype=torch.float32, device=w0.device)
        total = None
        for w in range(P):
            key = (prng.split(prng.fold_in(step_key, w))[1] if dropout
                   else None)
            leaf = p.detach().clone().requires_grad_(True)
            part = {k: v[w * b:(w + 1) * b] for k, v in batch.items()}
            loss = fam.loss(views(leaf, table), part, model, key, precision)
            loss.backward()
            grads[w] = leaf.grad
            total = loss.detach() if total is None else total + loss.detach()
            del leaf, loss
        reduced, state, wire = ex.allreduce(grads, state, ctx)
        del grads
        p = opt.step(p, reduced)
        if s == 0:
            out["received"] = optim.received_gradient(
                config["training"], opt.state(), w0)
        out["losses"].append(float(total / P))
        out["wire_bytes"].append(float(wire))
    out["params"] = p
    return out
