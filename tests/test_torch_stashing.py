"""Weight stashing (``oktopk_tpu_torch/optim/stashing.py``) against the
JAX package's ``optim/stashing.py``, through ``tests/test_stashing.py``'s
cases (the reference's only true unit tests,
``BERT/tests/backprop/sgd_with_stashing.py:28-107``, ``sgd_vanilla.py``
and the aggregating variant).

Both packages get the same numpy MLP, inputs and SGD. The input
gradients are held to the JAX package's at rtol 1e-6 (a float32 ReLU
MLP; oneDNN and Eigen round its matmuls differently), and each package
to the reference's ground truth, which is about bit-equality within one
package; the aggregating cases compare the stashed versions exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oktopk_tpu.optim import stashing as jstash
from oktopk_tpu_torch.optim import stashing as tstash


def mlp(seed, d=4):
    rng = np.random.RandomState(seed)
    p = {"w1": (rng.randn(d, d) * 0.5).astype(np.float32),
         "w2": (rng.randn(d, d) * 0.5).astype(np.float32)}
    x = rng.randn(4, d).astype(np.float32)
    y = rng.randn(4, d).astype(np.float32)
    return p, x, y


def torch_loss(p, x, y):
    return torch.mean((torch.relu(x @ p["w1"]) @ p["w2"] - y) ** 2)


def jax_loss(p, x, y):
    return jnp.mean((jax.nn.relu(x @ p["w1"]) @ p["w2"] - y) ** 2)


def torch_sgd(params, grads, opt_state, lr=0.1):
    return {k: params[k] - lr * grads[k] for k in params}, opt_state


def jax_sgd(params, grads, opt_state, lr=0.1):
    return jax.tree.map(lambda p, g: p - lr * g, params, grads), opt_state


def torch_grad(fn, *args, wrt):
    args = list(args)
    if isinstance(args[wrt], dict):
        args[wrt] = {k: v.detach().requires_grad_()
                     for k, v in args[wrt].items()}
        leaves = list(args[wrt].values())
    else:
        args[wrt] = args[wrt].detach().requires_grad_()
        leaves = [args[wrt]]
    g = torch.autograd.grad(fn(*args), leaves)
    return (dict(zip(args[wrt], g)) if isinstance(args[wrt], dict)
            else g[0])


def delayed_x_grads_torch(num_versions, seed):
    """The reference loop: three delayed backward passes, each against
    the stashed (oldest) weights, each followed by a step."""
    p, x, y = mlp(seed)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    state = tstash.stash_init(p, num_versions)
    out, opt = [], ()
    preds0 = torch.relu(x @ tstash.forward_params(state)["w1"]) @ \
        tstash.forward_params(state)["w2"]
    for _ in range(3):
        bw = tstash.backward_params(state)
        out.append(torch_grad(lambda xx: torch_loss(bw, xx, y), x, wrt=0))
        gp = torch_grad(lambda q: torch_loss(q, x, y),
                        tstash.forward_params(state), wrt=0)
        state, opt = tstash.stash_step(state, gp, torch_sgd, opt)
    after = torch.relu(x @ tstash.forward_params(state)["w1"]) @ \
        tstash.forward_params(state)["w2"]
    assert not torch.allclose(preds0, after)
    assert int(state.latest_version) == 3
    return [g.numpy() for g in out]


def delayed_x_grads_jax(num_versions, seed):
    p, x, y = mlp(seed)
    p = jax.tree.map(jnp.asarray, p)
    state = jstash.stash_init(p, num_versions)
    out, opt = [], ()
    for _ in range(3):
        bw = jstash.backward_params(state)
        out.append(np.asarray(jax.grad(lambda xx: jax_loss(bw, xx, y))(x)))
        gp = jax.grad(lambda q: jax_loss(q, x, y))(
            jstash.forward_params(state))
        state, opt = jstash.stash_step(state, gp, jax_sgd, opt)
    return out


@pytest.mark.parametrize("num_versions,ground_truth", [
    (1, [False, False]), (2, [True, False]), (3, [True, True])])
def test_stashing_delayed_backward(num_versions, ground_truth):
    got = delayed_x_grads_torch(num_versions, seed=42)
    want = delayed_x_grads_jax(num_versions, seed=42)
    assert np.array_equal(got[0], got[1]) == ground_truth[0]
    assert np.array_equal(got[0], got[2]) == ground_truth[1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_vanilla_sgd_hazard():
    """Without stashing a delayed backward sees updated weights
    (``sgd_vanilla.py:26-40``)."""
    g = delayed_x_grads_torch(1, seed=7)
    assert not np.array_equal(g[0], g[1])


def test_stash_init_rejects_zero_versions():
    with pytest.raises(ValueError):
        tstash.stash_init({"w": torch.ones(2)}, 0)
    with pytest.raises(ValueError):
        jstash.stash_init({"w": jnp.ones(2)}, 0)


def test_aggregating_version_selection_by_counter():
    """``..._and_aggregation.py:117-147``: the desired version is
    max(counter // interval - 1, 0), in both packages alike."""
    p, _, _ = mlp(3)
    interval = 2
    ts = tstash.aggregating_init({k: torch.from_numpy(v)
                                  for k, v in p.items()}, interval)
    jp0 = jax.tree.map(jnp.asarray, p)
    js = jstash.aggregating_init(jp0, interval)

    def same(t, j):
        return all(np.array_equal(t[k].numpy(), np.asarray(j[k]))
                   for k in t)

    p0 = tstash.forward_params(ts.stash)
    seen = []
    for kind in ("f", "f", "step", "b", "f", "f", "f", "b", "b"):
        if kind == "step":
            ts, _ = tstash.aggregating_step(
                ts, {k: torch.ones_like(v) for k, v in p0.items()},
                torch_sgd, (), interval)
            js, _ = jstash.aggregating_step(
                js, jax.tree.map(jnp.ones_like, jp0),
                jax_sgd, (), interval)
            continue
        tf = (tstash.aggregating_forward_params if kind == "f"
              else tstash.aggregating_backward_params)
        jf = (jstash.aggregating_forward_params if kind == "f"
              else jstash.aggregating_backward_params)
        tp, ts = tf(ts, interval)
        jp, js = jf(js, interval)
        assert same(tp, jp), kind
        seen.append(same(tp, p0))
    # window 0 and the stashed old version, then counter 4 reads v1
    assert seen == [True, True, True, True, True, False, True, True]
    assert int(ts.forward_counter) == int(js.forward_counter) == 5
    assert int(ts.backward_counter) == int(js.backward_counter) == 3


def test_aggregating_grad_scaling():
    """Grads divided by ``update_interval`` at the step
    (``optimizer_with_stashing.py:144-146``)."""
    ts = tstash.aggregating_init({"w": torch.ones(2)}, 4)
    ts, _ = tstash.aggregating_step(ts, {"w": torch.full((2,), 4.0)},
                                    torch_sgd, (), 4)
    js = jstash.aggregating_init({"w": jnp.ones(2)}, 4)
    js, _ = jstash.aggregating_step(js, {"w": jnp.full((2,), 4.0)},
                                    jax_sgd, (), 4)
    got = tstash.forward_params(ts.stash)["w"]
    assert np.array_equal(got.numpy(),
                          np.asarray(jstash.forward_params(js.stash)["w"]))
    np.testing.assert_allclose(got.numpy(), 0.9, atol=1e-7)
    assert torch.equal(tstash.backward_params(ts.stash)["w"],
                       torch.ones(2))
