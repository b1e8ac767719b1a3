"""Expert parallelism: the Switch top-1 MoE BERT over a data x expert grid
(``parallel/bert_moe.py``) against the JAX package's on the CPU mesh.

``bert_tiny``, B = 8, T = 16, E = 4 (``tests/test_bert_moe.py``'s sizes,
batches and cases, each mirrored here on the port), the JAX weights
carried across as JAX-layout trees (``convert.moe_from_jax``), the gates
taken from JAX's converted state so that an ulp of the normal sampler
cannot flip a route. The JAX side runs ``use_pallas=False``, the port its
kernels' plain versions; each JAX program is compiled once per module
(the fixtures).

Tolerances, and why:

- the routing decisions (expert, slot, kept) equal, the chosen gate
  probs at rtol 1e-6 (seen 5 ulps); the index-op dispatch and combine,
  and their gradients, bit-equal to the one-hot einsums (one nonzero
  term an output element);
- ``prng.normal`` within ``NORMAL_ULPS`` of ``jax.random.normal`` (its
  ``log1p`` and ``sqrt`` are torch's, seen 3 ulps apart), the uniform
  draw bit-equal;
- losses at rtol 1e-6 and gradients at atol 2e-6 (seen 6.6e-7): the
  port's matmuls (MKL), softmaxes and psums add in their own orders;
- parameters after SGD at atol 1e-6, after BertAdam at 2e-6;
- the oracle (identical experts, no overflow) at rtol 2e-4, JAX's own
  bound (``experts * (ffn / E)`` is not the dense FFN's bits);
- three composed oktopk steps: losses at rtol 1e-6, each bucket's
  reduction bit-equal to JAX's oktopk fed the port's own gradient of it,
  thresholds within 8 ulps (H1);
- the shared copies across every worker, and each expert shard across
  the data rows, bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oktopk_tpu.models.bert import BertConfig as JaxBertConfig
from oktopk_tpu.models.bert import BertForPreTraining as JaxBert
from oktopk_tpu.parallel import bert_moe as jm
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.convert import moe_from_jax, moe_to_jax
from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
from oktopk_tpu_torch.ops import prng
from oktopk_tpu_torch.optim import SGD, BertAdam
from oktopk_tpu_torch.optim.flat import apply_opt
from oktopk_tpu_torch.parallel import bert_moe as pm
from oktopk_tpu_torch.parallel import bert_seq as bs
from oktopk_tpu_torch.utils.flatten import TreeLayout, tree_items

B, T = 8, 16
E = 4
LOSS_RTOL = 1e-6
GRAD_ATOL = 2e-6
ULPS = 8
NORMAL_ULPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def make_batch(seed, vocab=1024):
    """``tests/test_bert_moe.py``'s batches, as numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(B, T)).astype(np.int32)
    mlm = np.full((B, T), -1, np.int32)
    pos = rng.rand(B, T) < 0.2
    mlm[pos] = ids[pos]
    return {"input_ids": ids, "token_type_ids": np.zeros((B, T), np.int32),
            "attention_mask": np.ones((B, T), np.int32), "mlm_labels": mlm,
            "nsp_labels": rng.randint(0, 2, size=(B,)).astype(np.int32)}


def make_equal_mask_batch(seed, vocab=1024, masked_per_example=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(B, T)).astype(np.int32)
    mlm = np.full((B, T), -1, np.int32)
    for b in range(B):
        cols = rng.choice(T, size=masked_per_example, replace=False)
        mlm[b, cols] = ids[b, cols]
    return {"input_ids": ids, "token_type_ids": np.zeros((B, T), np.int32),
            "attention_mask": np.ones((B, T), np.int32), "mlm_labels": mlm,
            "nsp_labels": rng.randint(0, 2, size=(B,)).astype(np.int32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def perturb(moe, scale=0.05):
    """``tests/test_bert_moe.py``'s: each expert scaled by its own
    factor."""
    leaves, treedef = jax.tree.flatten(moe)
    rng = np.random.RandomState(3)
    out = [np.asarray(x) * (1.0 + scale * rng.randn(x.shape[0])
                            .astype(np.float32).reshape((-1,) + (1,) *
                                                        (x.ndim - 1)))
           for x in leaves]
    return jax.tree.unflatten(treedef, out)


def assert_trees(want, got, atol, what):
    wl, gl = tree_items(want), tree_items(got)
    assert [p for p, _ in wl] == [p for p, _ in gl], what
    for (path, w), (_, g) in zip(wl, gl):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        if atol == 0:
            assert np.array_equal(g, np.asarray(w)), f"{what} {path}"
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                       err_msg=f"{what} {'/'.join(path)}")


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.sign(a), np.sign(b))
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def requires_grad(tree):
    return {k: requires_grad(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.requires_grad_()


def grad_tree(tree):
    return {k: grad_tree(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.grad


@pytest.fixture(scope="module")
def jparams():
    ex = jnp.zeros((2, T), jnp.int32)
    rng = jax.random.PRNGKey(0)
    return jax.device_get(JaxBert(JaxBertConfig.tiny()).init(
        {"params": rng, "dropout": rng}, ex, ex, jnp.ones_like(ex),
        train=False)["params"])


def jax_pair(jparams, **kw):
    return jax.device_get(jm.experts_from_dense(jparams, E, **kw))


def mcfgs(**kw):
    return jm.MoEConfig(num_experts=E, **kw), pm.MoEConfig(num_experts=E,
                                                            **kw)


def port_loss(pair, mcfg, ep, dp, batch):
    return float(pm.build_moe_loss(BertConfig.tiny(), mcfg,
                                   pm.make_moe_grid(ep, dp))(
        *moe_from_jax(*pair), batch))


def jax_loss(pair, mcfg, ep, dp, batch):
    return float(jm.build_moe_loss(JaxBertConfig.tiny(), mcfg,
                                   jm.make_moe_mesh(ep, data_size=dp))(
        *pair, jbatch(batch)))


# ---- the gate's sampler and the layout ---------------------------------------

def test_normal_matches_jax_within_ulps():
    """``prng.normal`` against ``jax.random.normal`` over 60 keys and three
    shapes (the gate's [H, E] among them): the uniform draw under it bit
    for bit, the normal within ``NORMAL_ULPS``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    worst = 0
    for seed in range(20):
        for sub in jax.random.split(jax.random.PRNGKey(seed), 3):
            for shape in ((128, 4), (768, 4), (1000, 7)):
                k = np.asarray(sub)
                np.testing.assert_array_equal(
                    prng.uniform(k, shape, lo, 1.0).numpy(),
                    np.asarray(jax.random.uniform(sub, shape, jnp.float32,
                                                  lo, 1.0)))
                worst = max(worst, ulps(prng.normal(k, shape).numpy(),
                                        jax.random.normal(sub, shape,
                                                          jnp.float32)))
    assert worst <= NORMAL_ULPS, worst


def test_experts_from_dense_matches_jax(jparams):
    """The tiling exact, every other leaf exact, the gates (seeded, scale
    0.02) within ``NORMAL_ULPS`` of JAX's; the round trip through
    ``moe_from_jax`` / ``moe_to_jax`` exact."""
    jmoe, jsh = jax_pair(jparams, gate_scale=0.02, seed=42)
    moe, shared = pm.experts_from_dense(bs.tree_to_torch(jparams), E,
                                        gate_scale=0.02, seed=42)
    assert_trees(jmoe, moe, 0, "moe")
    for (path, w), (_, g) in zip(tree_items(jsh), tree_items(shared)):
        if path[-1] == "gate":
            assert ulps(g.numpy(), w) <= NORMAL_ULPS, path
            assert np.any(np.asarray(w) != 0)
        else:
            assert np.array_equal(g.numpy(), np.asarray(w)), path
    back = moe_to_jax(*moe_from_jax(jmoe, jsh))
    assert_trees(jmoe, back[0], 0, "moe round trip")
    assert_trees(jsh, back[1], 0, "shared round trip")
    zero = pm.experts_from_dense(bs.tree_to_torch(jparams), E)[1]
    assert not torch.any(zero["layers"]["layer_0"]["gate"])


@pytest.mark.parametrize("E_,n_moe,n_shared", [(4, 113338368, 53474108),
                                              (2, 56669184, 53455676)])
def test_bert_base_buckets_at_ep2(E_, n_moe, n_shared):
    """BERT-base at ep = 2: the expert-shard bucket E/2 x 12 x (768 x 3072
    + 3072 + 3072 x 768 + 768), the shared bucket 110,106,428 less the
    FFNs plus 12 gates of 768 x E."""
    with torch.device("meta"):
        m = BertForPreTraining(BertConfig.base())
        moe, shared = pm.experts_from_dense(bs.jax_tree(m), E_,
                                            gate_scale=0.02)
    shard = pm.expert_shard(moe, 0, E_ // 2)
    assert sum(x.numel() for _, x in tree_items(shard)) == n_moe
    assert sum(x.numel() for _, x in tree_items(shared)) == n_shared


# ---- routing, dispatch, combine ----------------------------------------------

def jax_route(xt, gate, C):
    """``moe_ffn``'s routing lines (oktopk_tpu/parallel/bert_moe.py:131-158)
    on their own: (e_star, pos, keep, g, disp)."""
    probs = jax.nn.softmax(jnp.einsum("nh,he->ne", xt, gate), axis=-1)
    e_star = jnp.argmax(probs, axis=-1)
    g = jnp.take_along_axis(probs, e_star[:, None], 1)[:, 0]
    onehot = jax.nn.one_hot(e_star, E, dtype=xt.dtype)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.sum(pos * onehot, axis=-1).astype(jnp.int32)
    keep = pos < C
    disp = (onehot * keep[:, None])[:, :, None] \
        * jax.nn.one_hot(pos, C, dtype=xt.dtype)[:, None, :]
    return e_star, pos, keep, g, disp


@pytest.mark.parametrize("gate_scale,factor", [(0.5, 1.25), (0.5, 0.3),
                                               (0.0, 1.25)])
def test_routing_dispatch_combine_match_jax(gate_scale, factor):
    """Expert, slot and kept equal to JAX's (the zero gate: every prob
    tied, the first index taken, most tokens dropped); the index-op
    dispatch and combine bit-equal to JAX's one-hot einsums and to the
    port's own einsums of the same one-hot."""
    rng = np.random.RandomState(11)
    n, H = 128, 32
    xt = rng.randn(n, H).astype(np.float32)
    gate = (gate_scale * rng.randn(H, E)).astype(np.float32)
    C = pm.capacity(n, pm.MoEConfig(num_experts=E, capacity_factor=factor))
    assert C == max(1, int(-(-n * factor // E)))
    e_star, pos, keep, g, disp = jax_route(jnp.asarray(xt),
                                           jnp.asarray(gate), C)
    _, expert, slot, pkeep, pg = pm.route(torch.from_numpy(xt),
                                          torch.from_numpy(gate), C)
    np.testing.assert_array_equal(expert.numpy(), np.asarray(e_star))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(pkeep.numpy(), np.asarray(keep))
    # the logits' products and the softmax add in their own orders
    np.testing.assert_allclose(pg.numpy(), np.asarray(g), rtol=1e-6)
    if gate_scale == 0:
        assert not expert.any() and int(pkeep.sum()) == C
    xin = pm.dispatch(torch.from_numpy(xt), expert, slot, pkeep, E, C)
    assert np.array_equal(xin.numpy(), np.asarray(
        jnp.einsum("nec,nh->ech", disp, jnp.asarray(xt))))
    d = torch.from_numpy(np.array(disp))
    assert torch.equal(xin, torch.einsum("nec,nh->ech", d,
                                         torch.from_numpy(xt)))
    y = rng.randn(E, C, H).astype(np.float32)
    out = pm.combine(torch.from_numpy(y), expert, slot, pkeep, pg)
    want = jnp.einsum("nec,ech->nh", disp, jnp.asarray(y)) \
        * jnp.asarray(pg.numpy())[:, None]
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert torch.equal(out, torch.einsum("nec,ech->nh", d,
                                         torch.from_numpy(y)) * pg[:, None])
    # the gradients too: the transposes of the einsums
    xg = torch.from_numpy(xt).requires_grad_()
    yg = torch.from_numpy(y).requires_grad_()
    ct = torch.from_numpy(rng.randn(n, H).astype(np.float32))
    (pm.combine(yg, expert, slot, pkeep, pg.detach()) * ct).sum().backward()
    (pm.dispatch(xg, expert, slot, pkeep, E, C) * yg.grad).sum().backward()
    jy = jax.grad(lambda v: jnp.sum(jnp.einsum("nec,ech->nh", disp, v)
                                    * jnp.asarray(pg.numpy())[:, None]
                                    * jnp.asarray(ct.numpy())))(
        jnp.asarray(y))
    assert np.array_equal(yg.grad.numpy(), np.asarray(jy))
    jx = jax.grad(lambda v: jnp.sum(jnp.einsum("nec,nh->ech", disp, v)
                                    * jy))(jnp.asarray(xt))
    assert np.array_equal(xg.grad.numpy(), np.asarray(jx))


# ---- the loss: tests/test_bert_moe.py's five cases ---------------------------

def test_identical_experts_match_dense_oracle(jparams):
    """Identical experts, the zero gate (g = 1/E, so wo and bo times E),
    capacity E, no aux: the MoE loss equals the single module's, on the
    port's and on JAX's side, and the two sides agree."""
    jmoe, jsh = jax_pair(jparams)
    jmoe = {k: {**v, "wo": v["wo"] * E, "bo": v["bo"] * E}
            for k, v in jmoe.items()}
    jc, pc = mcfgs(capacity_factor=float(E), aux_weight=0.0)
    batch = make_batch(1)
    got = port_loss((jmoe, jsh), pc, 4, 1, batch)
    np.testing.assert_allclose(got, jax_loss((jmoe, jsh), jc, 4, 1, batch),
                               rtol=LOSS_RTOL)
    oracle = float(bs.build_seq_loss(BertConfig.tiny(), bs.make_seq_grid(1))(
        bs.tree_to_torch(jparams), batch))
    np.testing.assert_allclose(got, oracle, rtol=2e-4)


def test_ep4_matches_ep1_dispatch(jparams):
    """Different experts and a real gate: four expert ranks (two
    all_to_all hops) against all experts local, and against JAX's."""
    jmoe, jsh = jax_pair(jparams)
    jmoe = perturb(jmoe)
    rng = np.random.RandomState(5)
    for name in jsh["layers"]:
        g = jsh["layers"][name]["gate"]
        jsh["layers"][name]["gate"] = (0.5 * rng.randn(*g.shape)
                                       ).astype(np.float32)
    jc, pc = mcfgs(capacity_factor=float(E))
    batch = make_batch(2)
    got = {p: port_loss((jmoe, jsh), pc, p, 1, batch) for p in (1, 4)}
    np.testing.assert_allclose(got[4], got[1], rtol=1e-5)
    np.testing.assert_allclose(got[4], jax_loss((jmoe, jsh), jc, 4, 1,
                                                batch), rtol=LOSS_RTOL)


def test_composed_data_x_expert_matches_ep1(jparams):
    """dp 2 x ep 4 (the batch over both axes, the experts replicated over
    data, the dispatch within each data row) against ep 1, and dp 2 x ep
    4 against JAX's."""
    jmoe, jsh = jax_pair(jparams, gate_scale=0.5, seed=9)
    jmoe = perturb(jmoe)
    jc, pc = mcfgs(capacity_factor=float(E))
    batch = make_batch(7)
    want = port_loss((jmoe, jsh), pc, 1, 1, batch)
    got = port_loss((jmoe, jsh), pc, 4, 2, batch)
    np.testing.assert_allclose(got, want, rtol=5e-5)
    np.testing.assert_allclose(got, jax_loss((jmoe, jsh), jc, 4, 2, batch),
                               rtol=LOSS_RTOL)


def test_bfloat16_rounds_the_table_only(jparams):
    """``--compute-dtype bfloat16`` on the expert path (H32's rule): only
    the tied MLM table rounds, everything else computes in float32; the
    loss JAX's at ep 4, and not the float32 one."""
    pair = jax_pair(jparams, gate_scale=0.5, seed=9)
    jc, pc = mcfgs(capacity_factor=float(E))
    batch = make_batch(3)
    want = float(jm.build_moe_loss(JaxBertConfig.tiny(dtype=jnp.bfloat16),
                                   jc, jm.make_moe_mesh(4))(
        *pair, jbatch(batch)))
    got = float(pm.build_moe_loss(BertConfig.tiny(dtype=torch.bfloat16),
                                  pc, pm.make_moe_grid(4))(
        *moe_from_jax(*pair), batch))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got != port_loss(pair, pc, 4, 1, batch)


def test_gradients_match_jax(jparams):
    """Gradients reach every expert and the gate, finite, and equal JAX's
    at ep 4 (the all_to_all's transpose, the loss psums' own cotangents,
    the shared tree's psum over the expert ranks)."""
    jmoe, jsh = jax_pair(jparams)
    jmoe = perturb(jmoe)
    jc, pc = mcfgs(capacity_factor=2.0)
    batch = make_batch(4)
    lf = jm.build_moe_loss(JaxBertConfig.tiny(), jc, jm.make_moe_mesh(4))
    jg = jax.device_get(jax.grad(lambda m, s: lf(m, s, jbatch(batch)),
                                 argnums=(0, 1))(jmoe, jsh))
    moe, shared = (requires_grad(t) for t in moe_from_jax(jmoe, jsh))
    pm.build_moe_loss(BertConfig.tiny(), pc, pm.make_moe_grid(4))(
        moe, shared, batch).backward()
    gm, gs = grad_tree(moe), grad_tree(shared)
    assert all(torch.isfinite(x).all() for _, x in tree_items(gm))
    assert any(torch.any(x != 0) for _, x in tree_items(gm))
    assert torch.any(gs["layers"]["layer_0"]["gate"] != 0)
    assert_trees(jg[0], gm, GRAD_ATOL, "moe grads")
    assert_trees(jg[1], gs, GRAD_ATOL, "shared grads")


def test_capacity_overflow_drops_but_stays_finite(jparams):
    """Capacity factor 0.1: most tokens drop (the routing record counts
    them), the loss stays finite, repeats bit for bit and equals JAX's."""
    jmoe, jsh = jax_pair(jparams)
    jc, pc = mcfgs(capacity_factor=0.1)
    batch = make_batch(6)
    l1 = port_loss((jmoe, jsh), pc, 4, 1, batch)
    l2 = port_loss((jmoe, jsh), pc, 4, 1, batch)
    assert np.isfinite(l1) and l1 == l2
    np.testing.assert_allclose(l1, jax_loss((jmoe, jsh), jc, 4, 1, batch),
                               rtol=LOSS_RTOL)
    step = pm.build_moe_train_step(BertConfig.tiny(), pc,
                                   pm.make_moe_grid(4),
                                   *moe_from_jax(jmoe, jsh), SGD(0.1))
    step.loss_rows(batch)
    # 32 tokens a worker, C = 1: the zero gate sends all to expert 0
    C = pm.capacity(2 * T, pc)
    assert C == 1
    assert step.routing["dropped"].shape == (BertConfig.tiny().num_layers,
                                             1, 4)
    assert torch.all(step.routing["dropped"] == 2 * T - C)
    assert torch.equal(step.routing["f"][0, 0, 0],
                       torch.tensor([1.0, 0.0, 0.0, 0.0]))


# ---- the train steps -----------------------------------------------------------

def jax_dense_run(opt, pair, batches):
    step = jm.build_moe_train_step(JaxBertConfig.tiny(),
                                   jm.MoEConfig(num_experts=E,
                                                capacity_factor=float(E)),
                                   jm.make_moe_mesh(4), opt)
    params = jax.tree.map(jnp.asarray, pair)
    st = opt.init(params)
    losses = []
    for b in batches:
        params, st, loss = step(params, st, jbatch(b))
        losses.append(float(loss))
    return jax.device_get(params), losses


def port_moe_stack(step):
    return bs.tree_to_numpy(step.moe_stack())


@pytest.mark.parametrize("which", ["sgd", "bert_adam"])
def test_dense_step_matches_jax(jparams, which):
    """Two dense steps over ep 4 (``build_moe_train_step``) against JAX's:
    SGD with momentum, and BertAdam (lr 4e-4, as the repo's other BertAdam
    parities) whose one clip norm spans every expert of every shard and
    the shared tree once (clipping engaged: the global norm is above
    1)."""
    from oktopk_tpu.optim import bert_adam
    from oktopk_tpu.optim.sgd import sgd
    pair = jax_pair(jparams, gate_scale=0.5, seed=3)
    pair = (perturb(pair[0]), pair[1])
    jopt, popt, atol = {
        "sgd": (sgd(0.1), SGD(0.1), 1e-6),
        "bert_adam": (bert_adam(lr=4e-4, warmup=0.0, t_total=-1),
                      BertAdam(lr=4e-4, warmup=0.0, t_total=-1), 2e-6),
    }[which]
    batches = [make_batch(12 + i) for i in range(2)]
    (jmoe, jsh), jl = jax_dense_run(jopt, pair, batches)
    mcfg = pm.MoEConfig(num_experts=E, capacity_factor=float(E))
    step = pm.build_moe_train_step(BertConfig.tiny(), mcfg,
                                   pm.make_moe_grid(4), *moe_from_jax(*pair),
                                   popt)
    for b, want in zip(batches, jl):
        np.testing.assert_allclose(float(step(b)["loss"]), want,
                                   rtol=LOSS_RTOL)
    assert_trees(jmoe, port_moe_stack(step), atol, f"{which} moe")
    assert_trees(jsh, step.trees()[1], atol, f"{which} shared")
    if which == "bert_adam":
        assert int(step.opt_sh.step) == 2
        moe, shared = (requires_grad(t) for t in moe_from_jax(*pair))
        pm.build_moe_loss(BertConfig.tiny(), mcfg, pm.make_moe_grid(4))(
            moe, shared, batches[0]).backward()
        sq = sum(float(torch.sum(x.grad ** 2))
                 for t in (moe, shared) for _, x in tree_items(t))
        assert sq > 1.0


def test_dense_composition_matches_expert_only_step(jparams):
    """Equal mask counts a row: the composed dp 2 x ep 4 step with the
    ``dense`` compressor (each row's gradient, the mean over data) lands
    on the expert-only dense step's parameters, the aux statistics being
    global over data in both."""
    pair = moe_from_jax(*[bs.tree_to_numpy(t) for t in pm.experts_from_dense(
        bs.tree_to_torch(jparams), E, gate_scale=0.5, seed=3)])
    mcfg = pm.MoEConfig(num_experts=E, capacity_factor=float(E))
    batch = make_equal_mask_batch(31)
    comp = pm.build_moe_sparse_train_step(
        BertConfig.tiny(), mcfg, pm.make_moe_grid(4, 2), *pair, SGD(0.1),
        OkTopkConfig(density=0.05, warmup_steps=0), compressor="dense",
        warmup=False)
    m = comp(batch)
    assert np.isfinite(float(m["loss"]))
    ref = pm.build_moe_train_step(BertConfig.tiny(), mcfg,
                                  pm.make_moe_grid(4), *pair, SGD(0.1))
    ref(batch)
    assert_trees(port_moe_stack(ref), port_moe_stack(comp), 2e-6, "moe")
    assert_trees(bs.tree_to_numpy(ref.trees()[1]), comp.trees()[1], 2e-6,
                 "shared")
    assert comp.shared_equal() and comp.experts_equal()


def test_per_expert_bert_adam_matches_jax_vmap():
    """The sparse step's expert optimizers against JAX's
    ``jax.vmap(optimizer.update)`` over the expert dim: each local expert
    its own step and its own clip norm (the two experts' norms 0.5 and 3
    here, so one clips and one does not), on the strided views of a flat
    row in JAX's leaf order."""
    from oktopk_tpu.optim import bert_adam
    rng = np.random.RandomState(8)
    El = 2
    shapes = {"layer_0": {"bi": (El, 6), "bo": (El, 4), "wi": (El, 4, 6),
                          "wo": (El, 6, 4)},
              "layer_1": {"bi": (El, 6), "bo": (El, 4), "wi": (El, 4, 6),
                          "wo": (El, 6, 4)}}
    tree = lambda: {k: {n: rng.randn(*s).astype(np.float32)
                        for n, s in v.items()} for k, v in shapes.items()}
    params, g1, g2 = tree(), tree(), tree()
    for g in (g1, g2):
        for v in g.values():
            for n in v:
                v[n][0] *= 0.5 / 8.0
                v[n][1] *= 3.0 / 8.0
    opt = bert_adam(lr=1e-2, warmup=0.0, t_total=-1)
    p = jax.tree.map(jnp.asarray, params)
    st = jax.vmap(opt.init)(p)
    for g in (g1, g2):
        u, st = jax.vmap(opt.update)(jax.tree.map(jnp.asarray, g), st, p)
        p = jax.tree.map(jnp.add, p, u)
    layout = TreeLayout(bs.tree_to_torch(params))
    views = pm.ExpertViews(layout, El)
    row = layout.flat(bs.tree_to_torch(params))
    (opts,), _ = pm.init_moe_sparse_opt(
        BertAdam(lr=1e-2, warmup=0.0, t_total=-1), [row[None]], [row[None]],
        views)
    norms = []
    for g in (g1, g2):
        flat = layout.flat(bs.tree_to_torch(g))
        for l, o in enumerate(opts[0]):
            norms.append(float(torch.linalg.vector_norm(views.grad(flat, l))))
            apply_opt(o, views.params(row, l), views.grad(flat, l),
                         views.views, views.flat)
    assert norms[0] < 1.0 < norms[1]
    assert [int(o.step) for o in opts[0]] == [2, 2]
    assert_trees(jax.device_get(p), layout.tree(row), 2e-6, "per expert")


@pytest.fixture(scope="module")
def sparse_runs(jparams):
    """``tests/test_bert_moe.py``'s composed oktopk setup (dp 2 x ep 4,
    gate 0.5 from seed 3, perturbed experts, SGD 0.1, density 0.05) on
    JAX's side: three steps' metrics."""
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.optim.sgd import sgd
    from oktopk_tpu.parallel.bert_seq import stack_replicas
    moe, shared = jax_pair(jparams, gate_scale=0.5, seed=3)
    moe = perturb(moe)
    mcfg = jm.MoEConfig(num_experts=E, capacity_factor=float(E))
    acfg = JCfg(density=0.05, warmup_steps=0, use_pallas=False)
    opt = sgd(lr=0.1)
    step = jm.build_moe_sparse_train_step(
        JaxBertConfig.tiny(), mcfg, jm.make_moe_mesh(4, data_size=2), opt,
        acfg, compressor="oktopk", warmup=False)
    ss = jm.init_moe_sparse_states(moe, shared, acfg, 2, 4)
    opts = jm.init_moe_sparse_opt(opt, moe, shared, 2)
    p = (stack_replicas(moe, 2), stack_replicas(shared, 2))
    batch = make_batch(32)
    ms = []
    for _ in range(3):
        p, ss, opts, m = step(p, ss, opts, jbatch(batch))
        ms.append({k: float(v) for k, v in m.items()})
    return (moe, shared), batch, ms


def test_oktopk_composition_trains(sparse_runs):
    """Three oktopk steps over dp 2 x ep 4: the losses JAX's, every
    bucket's reduction JAX's oktopk on the port's own gradient of it
    (thresholds within 8 ulps); after every step the shared copies of all
    eight workers bit-identical and each expert shard across the data
    rows; the step counters 3, the volume within (0, 2 n)."""
    from oktopk_tpu.collectives.api import (batched_init_state,
                                            build_allreduce_step)
    from oktopk_tpu.comm import get_mesh
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu_torch.collectives.state import SparseState
    pair, batch, ms = sparse_runs
    step = pm.build_moe_sparse_train_step(
        BertConfig.tiny(), pm.MoEConfig(num_experts=E,
                                        capacity_factor=float(E)),
        pm.make_moe_grid(4, 2), *moe_from_jax(*pair), SGD(0.1),
        OkTopkConfig(density=0.05, warmup_steps=0), compressor="oktopk",
        warmup=False)
    mesh2 = get_mesh((2,), ("data",), devices=jax.devices()[:2])
    jsteps, jstates = {}, {}
    for name, n in (("moe", step.moe_layout.n),
                    ("shared", step.shared_layout.n)):
        jcfg = JCfg(n=n, num_workers=2, density=0.05, warmup_steps=0,
                    use_pallas=False)
        jsteps[name] = build_allreduce_step("oktopk", jcfg, mesh2,
                                            warmup=False)
        jstates[name] = [batched_init_state(jcfg) for _ in range(4)]
    n_total = step.moe_layout.n * 4 + step.shared_layout.n
    for i, want in enumerate(ms):
        before = [[SparseState.from_numpy(s.to_numpy(), "cpu") for s in ss]
                  for ss in step.sstates]
        m = step(batch)
        np.testing.assert_allclose(float(m["loss"]), want["loss"],
                                   rtol=LOSS_RTOL)
        assert 0 < float(m["comm_volume"]) < 2.0 * n_total
        assert step.shared_equal() and step.experts_equal(), i
        for b, (name, grads, cfg) in enumerate((
                ("moe", step.g_moe, step.cfg_moe),
                ("shared", step.g_sh, step.cfg_sh))):
            for j in range(4):
                jout, jstates[name][j] = jsteps[name](
                    jnp.asarray(grads[j].numpy()), jstates[name][j])
                out, _ = step.algo(grads[j].clone(), before[b][j], cfg,
                                   step.grid.data)
                np.testing.assert_array_equal(out.numpy(), np.asarray(jout),
                                              err_msg=f"{name} {j} {i}")
                after = step.sstates[b][j]
                for f in ("local_threshold", "global_threshold"):
                    assert ulps(getattr(after, f).numpy(), np.asarray(
                        getattr(jstates[name][j], f))) <= ULPS, (name, f)
    assert all(int(s.step[0]) == 3 for s in step.sstates[0])
    sh0 = step.sstates[1][0].to_numpy()
    for s in step.sstates[1][1:]:
        assert all(np.array_equal(a, sh0[k]) for k, a in
                   s.to_numpy().items())


# ---- the CLI and checkpoints --------------------------------------------------

EXPERT_ARGV = ["--model", "bert_tiny", "--device", "cpu", "--expert-shards",
               "2", "--expert-data-shards", "2", "--num-experts", "4",
               "--batch-size", "2", "--log-every", "1"]


def test_main_bert_expert_checkpoint_restores_in_jax(tmp_path):
    """Two oktopk steps through the CLI, then its ``moe_params`` checkpoint
    restores in JAX's ``restore_checkpoint`` template (every expert, the
    shared tree), and holds the trained parameters: each expert shard
    from its rank, the shared tree of the first worker."""
    from oktopk_tpu.train.checkpoint import restore_checkpoint as jrestore
    from oktopk_tpu_torch.train import main_bert
    ck = tmp_path / "ck"
    args = main_bert.parse_args(EXPERT_ARGV + ["--num-minibatches", "2",
                                               "--ckpt-dir", str(ck)])
    run = main_bert.build_moe(args)
    for _ in range(2):
        m = run.train_step()
    assert np.isfinite(float(m["loss"])) and float(m["comm_volume"]) > 0
    from oktopk_tpu_torch.train.checkpoint import save_checkpoint
    save_checkpoint(str(ck), run.checkpoint_payload(), 2)
    template = jax_template(42)
    tree, step = jrestore(str(ck), template)
    assert step == 2
    assert_trees(tree["moe_params"]["layers"], run.step.moe_stack(), 0,
                 "layers")
    assert_trees(tree["moe_params"]["shared"], run.step.trees()[1], 0,
                 "shared")
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for (_, a), (_, b) in zip(tree_items(tree["moe_params"]),
                                         tree_items(
                                             template["moe_params"])))


def jax_template(seed):
    ex = jnp.zeros((2, 32), jnp.int32)
    rng = jax.random.PRNGKey(seed)
    p = JaxBert(JaxBertConfig.tiny()).init(
        {"params": rng, "dropout": rng}, ex, ex, jnp.ones_like(ex),
        train=False)["params"]
    moe, shared = jax.device_get(jm.experts_from_dense(
        p, E, gate_scale=0.02, seed=seed))
    return {"moe_params": {"layers": moe, "shared": shared},
            "model_state": {}}


@pytest.mark.parametrize("compressor", ["oktopk", "dense"])
def test_main_bert_expert_warm_starts_from_jax(tmp_path, compressor):
    """A checkpoint the JAX package writes (``moe_params`` of perturbed
    experts) warm-starts the port's expert route bit for bit, on the
    sparse and on the dense step; the CLI then trains from it."""
    from oktopk_tpu.train.checkpoint import save_checkpoint as jsave
    from oktopk_tpu_torch.train import main_bert
    payload = jax_template(7)
    payload["moe_params"]["layers"] = perturb(
        payload["moe_params"]["layers"])
    ck = tmp_path / "jax_ck"
    jsave(str(ck), payload, 5)
    argv = EXPERT_ARGV + ["--num-minibatches", "1", "--compressor",
                          compressor, "--resume", str(ck)]
    run = main_bert.build_moe(main_bert.parse_args(argv))
    assert run.step.sparse == (compressor != "dense")
    assert_trees(payload["moe_params"]["layers"], run.step.moe_stack(), 0,
                 "layers")
    assert_trees(payload["moe_params"]["shared"], run.step.trees()[1], 0,
                 "shared")
    assert main_bert.main(argv) == 0
