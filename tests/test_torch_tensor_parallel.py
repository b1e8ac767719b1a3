"""Tensor parallelism: BERT over a data x model grid
(``parallel/bert_tp.py``) against the JAX package's on the CPU mesh.

``bert_tiny`` (2 heads, so tp = 2 at most), B = 4, T = 16
(``tests/test_bert_tp.py``'s sizes and batches), the JAX weights carried
across as the JAX-layout tree, JAX's ``(tp_stack, shared)`` pair by
``convert.tp_from_jax``. The JAX side runs ``use_pallas=False``, the port
its kernels' plain versions; each JAX program is compiled once per
module (the fixtures).

Tolerances, and why:

- ``split_tp`` / ``merge_tp`` and the JAX pair: exact (``np.array_equal``);
- losses at rtol 1e-6 (seen equal) and gradients at atol 2e-6 (seen
  6.0e-7): the port's matmuls (MKL), softmax and the model ranks' psums
  add in their own orders, XLA's in its own (the seq path's bounds);
- parameters after SGD steps at atol 1e-6 (seen 1.2e-7);
- three composed oktopk steps: losses at rtol 1e-6, and each step's
  reduction of a bucket held bit-equal to JAX's oktopk fed the port's
  own gradient of that bucket, thresholds within 8 ulps (H1);
- the shared copies across model ranks and data replicas, and the tp
  shards across data replicas, bit-identical (``np.array_equal``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oktopk_tpu.models.bert import BertConfig as JaxBertConfig
from oktopk_tpu.models.bert import BertForPreTraining as JaxBert
from oktopk_tpu.parallel import bert_tp as jbt
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.convert import tp_from_jax, tp_to_jax
from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
from oktopk_tpu_torch.optim import SGD
from oktopk_tpu_torch.parallel import bert_seq as bs
from oktopk_tpu_torch.parallel import bert_tp as bt
from oktopk_tpu_torch.utils.flatten import tree_items

B, T = 4, 16
LOSS_RTOL = 1e-6
GRAD_ATOL = 2e-6
ULPS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def make_batch(seed, vocab=1024):
    """``tests/test_bert_tp.py``'s batches, as numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(B, T)).astype(np.int32)
    mlm = np.full((B, T), -1, np.int32)
    pos = rng.rand(B, T) < 0.2
    mlm[pos] = ids[pos]
    amask = np.ones((B, T), np.int32)
    amask[:, -3:] = 0
    return {"input_ids": ids, "token_type_ids": np.zeros((B, T), np.int32),
            "attention_mask": amask, "mlm_labels": mlm,
            "nsp_labels": rng.randint(0, 2, size=(B,)).astype(np.int32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jparams():
    ex = jnp.zeros((2, T), jnp.int32)
    rng = jax.random.PRNGKey(0)
    return jax.device_get(JaxBert(JaxBertConfig.tiny()).init(
        {"params": rng, "dropout": rng}, ex, ex, jnp.ones_like(ex),
        train=False)["params"])


def port_pair(jparams, P=2):
    return tp_from_jax(*jax.device_get(jbt.split_tp(jparams, P)))


def requires_grad(tree):
    return {k: requires_grad(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.requires_grad_()


def grad_tree(tree):
    return {k: grad_tree(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.grad


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


def assert_ulps(a, b, ulps, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.sign(a), np.sign(b)), what
    d = np.abs(a.view(np.int32).astype(np.int64)
               - b.view(np.int32).astype(np.int64))
    assert d.max() <= ulps, f"{what}: {d.max()} ulps apart"


def oracle_grads(jparams, batch):
    """The port's seq path at one shard (the single module's loss, held to
    it in ``test_torch_seq_parallel.py``): loss and gradient tree."""
    tree = requires_grad(bs.tree_to_torch(jparams))
    loss = bs.build_seq_loss(BertConfig.tiny(), bs.make_seq_grid(1))(
        tree, batch)
    loss.backward()
    return float(loss.detach()), grad_tree(tree)


# ---- the layout --------------------------------------------------------------

def test_split_merge_round_trip_equals_jax(jparams):
    tree = bs.tree_to_torch(jparams)
    tp, shared = bt.split_tp(tree, 2)
    jtp, jsh = jax.device_get(jbt.split_tp(jparams, 2))
    assert_trees(jtp, tp, 0, "tp_stack")
    assert_trees(jsh, shared, 0, "shared")
    assert_trees(jparams, bt.merge_tp(tp, shared), 0, "merged")
    back = tp_to_jax(*port_pair(jparams))
    assert_trees(jtp, back[0], 0, "tp_from_jax tp")
    assert_trees(jsh, back[1], 0, "tp_from_jax shared")


def test_bert_base_buckets_at_tp2():
    """BERT-base at tp = 2: the tp-shard bucket 12 x 7,083,264 / 2 =
    42,499,584 and the shared bucket 25,107,260 (the pipeline's shared
    bucket, 25,051,964, plus 12 x 4,608 out and output biases and
    LayerNorms)."""
    with torch.device("meta"):
        m = BertForPreTraining(BertConfig.base())
    tp, shared = bt.split_tp(bs.jax_tree(m), 2)
    n_tp = sum(x[0].numel() for _, x in tree_items(tp))
    n_sh = sum(x.numel() for _, x in tree_items(shared))
    assert (n_tp, n_sh) == (42499584, 25107260)
    assert 2 * n_tp + n_sh == 110106428


# ---- the loss and its gradients --------------------------------------------

@pytest.fixture(scope="module")
def jax_loss_grads(jparams):
    loss_fn = jbt.build_tp_loss(JaxBertConfig.tiny(), jbt.make_tp_mesh(2))
    tp, shared = jbt.split_tp(jparams, 2)
    b1, b2 = jbatch(make_batch(1)), jbatch(make_batch(2))
    loss = float(loss_fn(tp, shared, b1))
    g = jax.device_get(jax.grad(lambda t, s: loss_fn(t, s, b2),
                                argnums=(0, 1))(tp, shared))
    return loss, g


def test_loss_matches_jax_and_the_single_module(jparams, jax_loss_grads):
    tp, shared = port_pair(jparams)
    got = float(bt.build_tp_loss(BertConfig.tiny(), bt.make_tp_grid(2))(
        tp, shared, make_batch(1)))
    np.testing.assert_allclose(got, jax_loss_grads[0], rtol=LOSS_RTOL)
    want, _ = oracle_grads(jparams, make_batch(1))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_gradients_match_jax_and_the_single_module(jparams, jax_loss_grads):
    """The transposes: the layer input's gradient psums over the model
    ranks (``pvary``), each partial product's is its own (``psum``), the
    replicated parameters' once."""
    tp, shared = port_pair(jparams)
    requires_grad(tp)
    requires_grad(shared)
    bt.build_tp_loss(BertConfig.tiny(), bt.make_tp_grid(2))(
        tp, shared, make_batch(2)).backward()
    g_tp, g_sh = grad_tree(tp), grad_tree(shared)
    assert_trees(jax_loss_grads[1][0], g_tp, GRAD_ATOL, "tp grads")
    assert_trees(jax_loss_grads[1][1], g_sh, GRAD_ATOL, "shared grads")
    _, want = oracle_grads(jparams, make_batch(2))
    assert_trees(bs.tree_to_numpy(want), bt.merge_tp(g_tp, g_sh),
                 GRAD_ATOL, "merged grads")


def test_train_step_matches_jax(jparams):
    """Two SGD-momentum steps of the model-axis step against JAX's
    ``build_tp_train_step`` (the sharded moments are the merged moments
    re-split)."""
    from oktopk_tpu.optim.sgd import sgd
    opt = sgd(0.05, momentum=0.9)
    jstep = jbt.build_tp_train_step(JaxBertConfig.tiny(),
                                    jbt.make_tp_mesh(2), opt)
    tp, shared = jax.tree.map(jnp.array, jbt.split_tp(jparams, 2))
    o_tp, o_sh = jbt.init_tp_opt_states(opt, tp, shared)
    step = bt.build_tp_train_step(BertConfig.tiny(), bt.make_tp_grid(2),
                                  *port_pair(jparams),
                                  SGD(0.05, momentum=0.9))
    for i in range(2):
        b = make_batch(10 + i)
        tp, shared, o_tp, o_sh, jloss = jstep(tp, shared, o_tp, o_sh,
                                              jbatch(b))
        m = step(b)
        np.testing.assert_allclose(float(m["loss"]), float(jloss),
                                   rtol=LOSS_RTOL)
    got_tp, got_sh = step.trees()
    jtp, jsh = jax.device_get((tp, shared))
    for m_ in range(2):
        assert_trees(jax.tree.map(lambda x, m_=m_: x[m_], jtp), got_tp[m_],
                     1e-6, f"tp shard {m_}")
    assert_trees(jsh, got_sh, 1e-6, "shared")
    assert step.shared_equal()


# ---- the composed dp x tp step ------------------------------------------------

def jax_sparse_run(jparams, density, wire, batches):
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.optim.sgd import sgd
    dp = 2
    opt = sgd(0.05, momentum=0.9)
    acfg = JCfg(density=density, wire_dtype=wire, warmup_steps=0,
                num_workers=dp, use_pallas=False)
    step = jbt.build_tp_sparse_train_step(
        JaxBertConfig.tiny(), jbt.make_tp_mesh(2, data_size=dp), opt, acfg,
        compressor="oktopk", warmup=False)
    tp, shared = jbt.split_tp(jparams, 2)

    def stack(t):
        return jax.tree.map(lambda x: jnp.broadcast_to(x, (dp,) + x.shape),
                            t)

    ss = jbt.init_tp_sparse_states(tp, shared, acfg, dp)
    o_tp, o_sh = jbt.init_tp_opt_states(opt, tp, shared)
    p, opts = (stack(tp), stack(shared)), (stack(o_tp), stack(o_sh))
    ms = []
    for b in batches:
        p, ss, opts, m = step(p, ss, opts, jbatch(b))
        ms.append({k: float(v) for k, v in m.items()})
    return jax.device_get(p), ms


def port_sparse(jparams, density, wire):
    return bt.build_tp_sparse_train_step(
        BertConfig.tiny(), bt.make_tp_grid(2, 2), *port_pair(jparams),
        SGD(0.05, momentum=0.9),
        OkTopkConfig(density=density, wire_dtype=wire, warmup_steps=0),
        compressor="oktopk", warmup=False)


def test_sparse_dp_tp_full_density_matches_dense_oracle(jparams):
    """At density 1 on a float32 wire oktopk returns the dense data mean,
    so one composed dp 2 x tp 2 step equals JAX's and the oracle: the mean
    of the per-half gradients, one SGD step on the merged tree."""
    b = make_batch(3)
    (jtp, jsh), ms = jax_sparse_run(jparams, 1.0, "float32", [b])
    step = port_sparse(jparams, 1.0, "float32")
    m = step(b)
    np.testing.assert_allclose(float(m["loss"]), ms[0]["loss"],
                               rtol=LOSS_RTOL)
    assert float(m["comm_volume"]) > 0
    got_tp, got_sh = step.trees()
    for m_ in range(2):
        assert_trees(jax.tree.map(lambda x, m_=m_: x[0, m_], jtp),
                     got_tp[m_], 1e-6, f"tp shard {m_}")
    assert_trees(jax.tree.map(lambda x: x[0], jsh), got_sh, 1e-6, "shared")
    halves = [oracle_grads(jparams, {k: v[h * 2:(h + 1) * 2]
                                     for k, v in b.items()})[1]
              for h in (0, 1)]
    flat = [np.concatenate([x.numpy().reshape(-1)
                            for _, x in tree_items(g)]) for g in halves]
    p0 = np.concatenate([np.asarray(x).reshape(-1)
                         for _, x in tree_items(jparams)])
    got = np.concatenate([np.asarray(x).reshape(-1) for _, x in tree_items(
        bs.tree_to_numpy(bt.merge_tp(_stack_shards(got_tp), got_sh)))])
    np.testing.assert_allclose(got, p0 - 0.05 * (flat[0] + flat[1]) / 2,
                               rtol=0, atol=1e-6)


def _stack_shards(trees):
    """W per-rank shard trees -> one tree of [W, ...] leaves."""
    def go(ts):
        if isinstance(ts[0], dict):
            return {k: go([t[k] for t in ts]) for k in ts[0]}
        return torch.stack(ts)
    return go(trees)


@pytest.fixture(scope="module")
def jax_oktopk(jparams):
    batches = [make_batch(20 + i) for i in range(3)]
    return batches, jax_sparse_run(jparams, 0.05, "bfloat16", batches)[1]


def test_oktopk_composition_keeps_shared_copies_identical(jparams,
                                                          jax_oktopk):
    """Three oktopk steps over dp 2 x tp 2: after every step the shared
    copies of every worker (both model ranks of both data rows) are
    bit-identical, and so are the tp shards of the two data rows; the
    losses are JAX's, and each bucket's reduction is JAX's oktopk on the
    port's own gradient of it."""
    from oktopk_tpu.collectives.api import batched_init_state, \
        build_allreduce_step
    from oktopk_tpu.comm import get_mesh
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu_torch.collectives.state import SparseState
    batches, ms = jax_oktopk
    step = port_sparse(jparams, 0.05, "bfloat16")
    mesh2 = get_mesh((2,), ("data",), devices=jax.devices()[:2])
    jsteps, jstates = {}, {}
    for name, n in (("tp", step.tp_layout.n), ("shared",
                                               step.shared_layout.n)):
        jcfg = JCfg(n=n, num_workers=2, density=0.05, warmup_steps=0,
                    use_pallas=False)
        jsteps[name] = build_allreduce_step("oktopk", jcfg, mesh2,
                                            warmup=False)
        jstates[name] = [batched_init_state(jcfg) for _ in range(2)]
    sh0 = step.shared[0].detach()[0].clone()
    for i, b in enumerate(batches):
        tp_ss, sh_ss = step.sstates
        before = {"tp": [SparseState.from_numpy(s.to_numpy(), "cpu")
                         for s in tp_ss],
                  "shared": [SparseState.from_numpy(s.to_numpy(), "cpu")
                             for s in sh_ss]}
        m = step(b)
        np.testing.assert_allclose(float(m["loss"]), ms[i]["loss"],
                                   rtol=LOSS_RTOL)
        assert float(m["comm_volume"]) > 0
        assert step.shared_equal(), i
        assert torch.equal(step.tp[0].detach(), step.tp[1].detach()), i
        for name, grads, cfg, after in (
                ("tp", step.g_tp, step.cfg_tp, step.sstates[0]),
                ("shared", step.g_sh, step.cfg_sh, step.sstates[1])):
            for m_ in range(2):
                jout, jstates[name][m_] = jsteps[name](
                    jnp.asarray(grads[m_].numpy()), jstates[name][m_])
                out, _ = step.algo(grads[m_].clone(), before[name][m_], cfg,
                                   step.grid.data)
                np.testing.assert_array_equal(out.numpy(), np.asarray(jout),
                                              err_msg=f"{name} {m_} {i}")
                for f in ("local_threshold", "global_threshold"):
                    assert_ulps(getattr(after[m_], f).numpy(),
                                np.asarray(getattr(jstates[name][m_], f)),
                                ULPS, f"{name} {m_} {f}")
    # the shared gradient is the same on both model ranks, so its state is
    assert all(np.array_equal(a, b) for a, b in zip(
        step.sstates[1][0].to_numpy().values(),
        step.sstates[1][1].to_numpy().values()))
    assert not torch.equal(step.shared[0].detach()[0], sh0)
