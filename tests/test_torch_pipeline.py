"""The pipeline runtime (``oktopk_tpu_torch/parallel/pipeline.py``), the
flat layout (``utils/flatten.py``) and ``multistep_lr``, against the JAX
package.

The toy stages are ``tests/test_parallel.py::TestGPipe``'s: a tanh
layer per stage, four stages on the 4-device CPU mesh for JAX, the
port's ``StackedComm(4)`` for the pipe comm. Inputs come from a numpy
seed.

Tolerances, and why: the port's stage computes the same float32 matmul
and tanh as XLA's, but not bit for bit (oneDNN against Eigen), so the
outputs are held to atol 1e-6 (they are O(1)); the gradients to atol
1e-6 as well: the sum over the ticks of a stage's gradient runs in
descending ticks in both, but XLA's scan transpose and the port's
autograd round each term differently. JAX's own GPipe test holds its
pipeline to the sequential ground truth at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from oktopk_tpu.comm import compat
from oktopk_tpu.parallel import pipeline as jpipe
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.parallel import pipeline as tpipe

MB, DIM = 2, 8


def jax_stage(w, h, stage, mb):
    return jnp.tanh(h @ w)


def torch_stage(w, h, stage, mb):
    return torch.tanh(h @ w)


def jax_sq(o, t):
    return jnp.mean((o - t) ** 2)


def torch_sq(o, t):
    return torch.mean((o - t) ** 2)


def toy(M, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, MB, DIM).astype(np.float32)
    y = rng.randn(M, MB, DIM).astype(np.float32)
    ws = (rng.randn(4, DIM, DIM) * 0.3).astype(np.float32)
    return x, y, ws


def jax_value_and_grad(mesh4, ws, x, y, M):
    return jax.jit(compat.shard_map(
        jax.value_and_grad(lambda w, x_, y_: jpipe.gpipe_loss(
            jax_stage, jax_sq, w[0], x_, y_, "data", num_microbatches=M)),
        mesh=mesh4, in_specs=(PS("data"), PS(), PS()),
        out_specs=(PS(), PS("data")), check_vma=False))(ws, x, y)


@pytest.mark.parametrize("M", [1, 6])
def test_gpipe_apply_matches_jax(mesh4, M):
    x, _, ws = toy(M)
    want = jax.jit(compat.shard_map(
        lambda w, x_: jpipe.gpipe_apply(jax_stage, w[0], x_, "data",
                                        num_microbatches=M),
        mesh=mesh4, in_specs=(PS("data"), PS()), out_specs=PS(),
        check_vma=False))(ws, x)
    got = tpipe.gpipe_apply(torch_stage, torch.from_numpy(ws),
                            torch.from_numpy(x), StackedComm(4), M)
    assert got.shape == (4, M, MB, DIM)
    for row in got:          # every stage's row is the last stage's
        np.testing.assert_allclose(row.numpy(), np.asarray(want),
                                   atol=1e-6)
    seq = x
    for i in range(4):
        seq = np.tanh(seq @ ws[i])
    np.testing.assert_allclose(got[0].numpy(), seq, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_gpipe_grads_flow_to_every_stage(mesh4, remat):
    M = 4
    x, y, ws = toy(M, seed=1)
    want_loss, want_g = jax_value_and_grad(mesh4, ws, x, y, M)
    w = torch.from_numpy(ws).requires_grad_()
    loss = tpipe.gpipe_loss(torch_stage, torch_sq, w, torch.from_numpy(x),
                            torch.from_numpy(y), StackedComm(4), M,
                            remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    assert all(float(g.abs().sum()) > 0 for g in w.grad)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_g),
                               atol=1e-6)


def test_remat_is_bit_identical():
    M = 4
    x, y, ws = toy(M, seed=2)
    out = {}
    for remat in (False, True):
        w = torch.from_numpy(ws).requires_grad_()
        loss = tpipe.gpipe_loss(torch_stage, torch_sq, w,
                                torch.from_numpy(x), torch.from_numpy(y),
                                StackedComm(4), M, remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), w.grad)
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])


@pytest.mark.parametrize("M", [4, 6])
def test_one_f_one_b_matches_jax(mesh4, M):
    x, y, ws = toy(M, seed=3)
    want_loss, want_g = jax_value_and_grad(mesh4, ws, x, y, M)

    def f(w, x_, y_):
        loss, g = jpipe.one_f_one_b(jax_stage, jax_sq, w[0], x_, y_, "data",
                                    num_microbatches=M)
        return loss, g[None]

    jl, jg = jax.jit(compat.shard_map(
        f, mesh=mesh4, in_specs=(PS("data"), PS(), PS()),
        out_specs=(PS(), PS("data")), check_vma=False))(ws, x, y)
    loss, grads = tpipe.one_f_one_b(torch_stage, torch_sq,
                                    torch.from_numpy(ws),
                                    torch.from_numpy(x),
                                    torch.from_numpy(y), StackedComm(4), M)
    assert loss.shape == (4,) and len(set(loss.tolist())) == 1
    np.testing.assert_allclose(float(loss[0]), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(loss[0]), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(torch.stack(grads).numpy(), np.asarray(jg),
                               atol=1e-6)
    np.testing.assert_allclose(torch.stack(grads).numpy(),
                               np.asarray(want_g), atol=1e-6)


# ---- the verbs and their gradients on the stacked comm -------------------

def test_ring_hop_and_its_gradient():
    comm = StackedComm(4)
    x = torch.arange(12.0).view(4, 3).requires_grad_()
    y = tpipe.ring_hop(x, comm)
    assert torch.equal(y.detach(), x.detach()[[3, 0, 1, 2]])
    ct = torch.randn(4, 3)
    y.backward(ct)
    assert torch.equal(x.grad, ct[[1, 2, 3, 0]])        # the inverse hop
    assert torch.equal(comm.ppermute_ring(x.detach(), -1),
                       x.detach()[[1, 2, 3, 0]])


def test_bcast_from_last_and_its_gradient():
    comm = StackedComm(4)
    x = torch.randn(4, 5, requires_grad=True)
    y = tpipe.bcast_from_last(x, comm)
    for row in y:
        assert torch.equal(row, x.detach()[3])
    ct = torch.randn(4, 5)
    y.backward(ct)
    # the cotangent reaches the last stage alone: a psum transpose would
    # hand every stage the sum (an overcount by P)
    assert torch.equal(x.grad[3], ct[3])
    assert not x.grad[:3].any()


def test_to_rows_psums_the_cotangent_in_stage_order():
    comm = StackedComm(4)
    x = torch.randn(3, requires_grad=True)
    rows = tpipe.to_rows(x, comm)
    assert rows.shape == (4, 3) and all(torch.equal(r, x.detach())
                                        for r in rows)
    ct = torch.tensor([[1e8] * 3, [1.0] * 3, [-1e8] * 3, [1.0] * 3])
    rows.backward(ct)
    assert torch.equal(x.grad, ((ct[0] + ct[1]) + ct[2]) + ct[3])
    assert float(x.grad[0]) == 1.0


# ---- the flat layout and multistep_lr ------------------------------------

def test_flatten_tree_has_jax_order_on_a_twelve_layer_stage():
    """``sub_10`` sorts before ``sub_2`` as a string, as
    ``jax.tree.flatten`` sorts; at bert_large with pp = 2 a stage holds 12
    layers, where this order differs from the numeric one."""
    from oktopk_tpu.utils.flatten import flatten_tree as jflat
    from oktopk_tpu.utils.flatten import unflatten_tree as junflat
    from oktopk_tpu_torch.utils.flatten import flatten_tree, unflatten_tree

    rng = np.random.RandomState(4)
    tree = {f"sub_{j}": {"b": rng.randn(2).astype(np.float32),
                         "a": rng.randn(3, 2).astype(np.float32)}
            for j in range(12)}
    want, wl, wdef = jflat(jax.tree.map(jnp.asarray, tree))
    got, leaves, paths = flatten_tree(jax.tree.map(torch.from_numpy, tree))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert [p[0] for p in paths[::2]] == sorted(tree)
    assert paths[:6] == [("sub_0", "a"), ("sub_0", "b"), ("sub_1", "a"),
                         ("sub_1", "b"), ("sub_10", "a"), ("sub_10", "b")]
    back = unflatten_tree(got * 2, leaves, paths)
    jback = junflat(want * 2, wl, wdef)
    for j in range(12):
        for k in "ab":
            assert np.array_equal(back[f"sub_{j}"][k].numpy(),
                                  np.asarray(jback[f"sub_{j}"][k]))


def test_staged_stage_leaves_are_the_jax_stage_tree_order():
    """A bert_large stage at pp = 2 (12 BertLayers): the port's flat
    order is ``jax.tree.flatten``'s of the JAX stage tree."""
    from oktopk_tpu_torch.models.bert import BertConfig
    from oktopk_tpu_torch.models.bert_staged import StagedBertPretrain

    with torch.device("meta"):
        st = StagedBertPretrain(BertConfig.large(), 2, stages=[0])
    paths = [p for p, _, _ in st.stage_leaves(0)]
    assert paths == sorted(paths)
    firsts = list(dict.fromkeys(p[0] for p in paths))
    assert firsts == sorted(f"sub_{j}" for j in range(12))
    assert firsts[:4] == ["sub_0", "sub_1", "sub_10", "sub_11"]


@pytest.mark.parametrize("milestones,gamma", [([10, 20], 0.1),
                                              ([3, 5, 7], 0.5)])
def test_multistep_lr_matches_jax(milestones, gamma):
    from oktopk_tpu.optim.schedules import multistep_lr as jax_ms
    from oktopk_tpu_torch.optim.schedules import multistep_lr

    want, got = jax_ms(0.1, milestones, gamma), multistep_lr(0.1, milestones,
                                                            gamma)
    for epoch in range(0, 25):
        a = np.float32(got(epoch))
        b = np.float32(want(epoch))
        assert a == b, (epoch, a, b)
    assert float(got(torch.tensor(21))) == float(want(21))
