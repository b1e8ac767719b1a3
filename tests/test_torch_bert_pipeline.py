"""The pipeline slice as a whole: staged BERT (``models/bert_staged.py``)
through the port's data x pipe grid (``parallel/bert_pipeline.py``)
against the JAX package's on the CPU mesh, and ``main_bert
--pipeline-stages``.

``bert_tiny`` (2 layers, one a stage at pp = 2), B = 8, T = 16, the
grids (dp, pp, M) of ``tests/test_bert_pipeline.py``; inputs from numpy
seeds, the JAX weights carried across by ``convert.staged_from_jax``.
The JAX side runs ``use_pallas=False``, the port its kernels' plain
versions. Each JAX step is compiled once per module (the fixtures).

Tolerances, and why:

- losses at rtol 1e-5 (the Trainer's BERT parity): the forward is the
  port's BERT layer for layer, float32 rounding apart (H12 holds the
  LayerNorm at rtol 1e-4; these losses land within 2e-7);
- parameters after an SGD step (lr 0.1) at atol 1e-6: a stage's gradient
  adds its microbatches in descending ticks in both packages, but XLA's
  scan transpose and the port's autograd round each term differently,
  and the data rows and the tied word table add in their own orders;
- after a BertAdam step at atol 2e-6 (``test_torch_bert_trainer.py``'s
  bound; lr 4e-4): Adam's m / sqrt(v) turns a rounding difference in a
  near-zero gradient into up to 3.2 lr, which this lr keeps inside it;
- three composed oktopk steps: losses at rtol 1e-5 and volumes equal
  (every selection agrees on these inputs), parameters at atol 1e-4: a
  selected value whose float32 gradient differs in its last bits can
  round to the next bfloat16 on the wire (a relative 2^-8), which SGD's
  lr 0.1 turns into up to ~1e-4 on gradients of ~0.03 (2.3e-5 seen);
- the oktopk reduction of a bucket, given JAX's own per-row bucket
  gradients, bit-equal, thresholds within 8 ulps (H1);
- the dropout masks bit-equal (H27).
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oktopk_tpu.models.bert import BertConfig as JaxBertConfig
from oktopk_tpu.models.bert_staged import StagedBertPretrain as JaxStaged
from oktopk_tpu.parallel import bert_pipeline as jbp
from oktopk_tpu_torch.convert import (bert_from_jax_params,
                                      bert_to_jax_params, staged_from_jax,
                                      staged_to_jax)
from oktopk_tpu_torch.models.bert import BertConfig
from oktopk_tpu_torch.models.bert_staged import StagedBertPretrain
from oktopk_tpu_torch.optim import SGD, BertAdam
from oktopk_tpu_torch.optim.flat import apply_opt
from oktopk_tpu_torch.parallel import bert_pipeline as tbp
from oktopk_tpu_torch.train import main_bert

B, T = 8, 16
ULPS = 8
EXACT = ("step", "boundaries", "residual", "volume_elems", "last_volume",
         "wire_bytes", "last_wire_bytes", "last_local_count",
         "last_global_count")
THRESHOLDS = ("local_threshold", "global_threshold", "drift",
              "last_exact_lt")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """bert_tiny's matrices are too small to share among threads."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def make_batch(seed, vocab=1024, equal_masks=False):
    """``tests/test_bert_pipeline.py``'s batches, as numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(B, T)).astype(np.int32)
    mlm = np.full((B, T), -1, np.int32)
    amask = np.ones((B, T), np.int32)
    if equal_masks:
        for b in range(B):
            cols = rng.choice(T, size=3, replace=False)
            mlm[b, cols] = ids[b, cols]
    else:
        pos = rng.rand(B, T) < 0.2
        mlm[pos] = ids[pos]
        amask[:, -3:] = 0                  # ragged tail: mask must matter
    return {"input_ids": ids, "token_type_ids": np.zeros((B, T), np.int32),
            "attention_mask": amask, "mlm_labels": mlm,
            "nsp_labels": rng.randint(0, 2, size=(B,)).astype(np.int32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jstaged():
    return JaxStaged(JaxBertConfig.tiny(), num_stages=2)


@pytest.fixture(scope="module")
def jparams(jstaged):
    return jax.device_get(jstaged.init(jax.random.PRNGKey(0), 2, T))


def port_staged(jstaged, jparams, stages=None):
    stack, shared = jstaged.split(jparams)
    st = StagedBertPretrain(BertConfig.tiny(), 2, stages=stages)
    st.load_split(*staged_from_jax(jax.device_get(stack),
                                   jax.device_get(shared)))
    return st


def mesh(dp, pp):
    return jbp.make_pipeline_mesh(pp, devices=jax.devices()[:dp * pp])


def assert_trees_close(want, got, atol, what):
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree.leaves(got)
    assert len(wl) == len(gl), what
    for (path, w), g in zip(wl, gl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=atol, err_msg=f"{what} "
                                   f"{jax.tree_util.keystr(path)}")


def port_trees(st):
    return staged_to_jax(st.stage_stack(), st.shared_state())


def assert_ulps(a, b, ulps, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.sign(a), np.sign(b)), what
    d = np.abs(a.view(np.int32).astype(np.int64)
               - b.view(np.int32).astype(np.int64))
    assert d.max() <= ulps, f"{what}: {d.max()} ulps apart"


# ---- the layout ------------------------------------------------------------

def test_split_merge_round_trip_equals_jax_trees(jstaged, jparams):
    stack, shared = jstaged.split(jparams)
    full = bert_from_jax_params(jparams)
    st = StagedBertPretrain(BertConfig.tiny(), 2)
    t_stack, t_shared = st.split(full)
    got_stack, got_shared = staged_to_jax(t_stack, t_shared)
    for want, got in ((stack, got_stack), (shared, got_shared)):
        wl = jax.tree_util.tree_leaves_with_path(want)
        gl = jax.tree_util.tree_leaves_with_path(got)
        assert [jax.tree_util.keystr(p) for p, _ in wl] == \
            [jax.tree_util.keystr(p) for p, _ in gl]
        for (_, w), (_, g) in zip(wl, gl):
            assert np.array_equal(np.asarray(w), g)
    merged = st.merge(t_stack, t_shared)
    assert set(merged) == set(full)
    assert all(torch.equal(merged[k], full[k]) for k in full)
    # the staged module takes them, and its buckets are JAX's flat vectors
    st.load_split(t_stack, t_shared)
    from oktopk_tpu.utils.flatten import flatten_tree as jflat
    for w in range(2):
        b = tbp.Bucket(st.stage_leaves(w))
        want = jflat(jax.tree.map(lambda x: x[w], stack))[0]
        assert np.array_equal(b.flat(b.params).detach().numpy(),
                              np.asarray(want))
    b = tbp.Bucket(st.shared_leaves())
    assert np.array_equal(b.flat(b.params).detach().numpy(),
                          np.asarray(jflat(shared)[0]))


def test_staged_refuses_bfloat16_and_uneven_stages():
    with pytest.raises(ValueError, match="float32"):
        StagedBertPretrain(BertConfig.tiny(dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="divisible"):
        StagedBertPretrain(BertConfig.tiny(), 3)


# ---- the loss and the masks ------------------------------------------------

@pytest.mark.parametrize("dp,pp,M", [(2, 2, 2), (1, 2, 4), (4, 2, 1)])
@pytest.mark.parametrize("train", [False, True])
def test_pipeline_loss_matches_jax(jstaged, jparams, dp, pp, M, train):
    batch = make_batch(1)
    rng = jax.random.PRNGKey(5)
    stack, shared = jstaged.split(jparams)
    want = float(jbp.build_pipeline_loss(jstaged, mesh(dp, pp), M,
                                         train=train)(
        stack, shared, jbatch(batch), rng))
    st = port_staged(jstaged, jparams)
    loss_fn = tbp.build_pipeline_loss(st, tbp.make_pipeline_grid(pp, dp * pp),
                                      M, train=train)
    with torch.no_grad():
        got = float(loss_fn(batch, np.asarray(rng)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if not train and dp == 2:   # the single module, as JAX's test holds it
        ref = st.reference_loss(st.merge(st.stage_stack(),
                                         st.shared_state()),
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        np.testing.assert_allclose(float(ref.detach()), got, rtol=2e-5)


def test_dropout_masks_are_jax_masks(jstaged, jparams, monkeypatch):
    """H27: the embeddings and every layer of a stage drawn under
    the step's one key, as top-level modules: the masks flax draws in
    ``embed`` (the local batch's shape) and ``apply_stage`` (a
    microbatch's) are the port's, bit for bit, and each layer of a stage
    draws the same three."""
    import oktopk_tpu_torch.ops.prng as tprng

    key = jax.random.fold_in(jax.random.PRNGKey(9), 1)
    batch = make_batch(2)
    drawn = {"jax": [], "torch": []}
    bern = jax.random.bernoulli

    def record_jax(k, p=0.5, shape=None, **kw):
        m = bern(k, p, shape, **kw)
        drawn["jax"].append(np.asarray(m))
        return m

    keep = tprng.keep_mask

    def record_torch(*a, **kw):
        m = keep(*a, **kw)
        drawn["torch"].append(m.numpy())
        return m

    monkeypatch.setattr(jax.random, "bernoulli", record_jax)
    monkeypatch.setattr(tprng, "keep_mask", record_torch)
    stack, shared = jstaged.split(jparams)
    rngs = {"dropout": key}
    h0 = jstaged.embed(shared, batch["input_ids"], batch["token_type_ids"],
                       True, rngs=rngs)
    mask = jstaged.attn_mask(jnp.asarray(batch["attention_mask"]))[:4]
    big = JaxStaged(dataclasses.replace(JaxBertConfig.tiny(), num_layers=4),
                    num_stages=2)
    bp = big.split(big.init(jax.random.PRNGKey(1), 2, T))[0]
    jy = big.apply_stage(jax.tree.map(lambda x: x[1], bp), h0[:4], mask,
                         True, rngs=rngs)

    st = port_staged(jstaged, jparams)
    tbig = StagedBertPretrain(
        dataclasses.replace(BertConfig.tiny(), num_layers=4), 2, stages=[1])
    tbig.load_split(*staged_from_jax(
        jax.device_get(bp), jax.device_get(shared)))
    k = np.asarray(key)
    th0 = st.embed(torch.from_numpy(batch["input_ids"]),
                   torch.from_numpy(batch["token_type_ids"]), True, k)
    ty = tbig.apply_stage(tbig.stages[0], th0[:4], st.attn_mask(
        torch.from_numpy(batch["attention_mask"]))[:4], True,
        tbig.layer_keys(True, k))
    assert len(drawn["jax"]) == len(drawn["torch"]) == 1 + 2 * 3
    for i, (a, b) in enumerate(zip(drawn["jax"], drawn["torch"])):
        assert a.shape == b.shape and np.array_equal(a, b), i
    assert drawn["torch"][0].shape == (B, T, 64)        # the whole batch
    for i in range(3):                   # the two layers draw alike
        assert np.array_equal(drawn["torch"][1 + i], drawn["torch"][4 + i])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)


# ---- the dense step ---------------------------------------------------------

@pytest.fixture(scope="module")
def dense_runs(jstaged, jparams):
    """JAX's dense pipeline step from the same weights, SGD and BertAdam."""
    from oktopk_tpu.optim.bert_adam import bert_adam
    from oktopk_tpu.optim.sgd import sgd
    batch = make_batch(21)
    rng = jax.random.PRNGKey(7)
    stack, shared = jstaged.split(jparams)
    out = {}
    for name, opt in (("sgd", sgd(lr=0.1)),
                      ("adam", bert_adam(lr=4e-4, warmup=0.0, t_total=-1))):
        step = jbp.build_pipeline_train_step(jstaged, mesh(2, 2), 2, opt)
        s, h, o, m = step(stack, shared,
                          jbp.init_pipeline_opt_state(opt, stack, shared),
                          jbatch(batch), rng)
        out[name] = (jax.device_get((s, h)), jax.device_get(o),
                     float(m["loss"]))
    return batch, np.asarray(rng), out


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_dense_train_step_matches_jax(jstaged, jparams, dense_runs, name):
    batch, rng, out = dense_runs
    (want_s, want_h), want_opt, want_loss = out[name]
    st = port_staged(jstaged, jparams)
    opt = SGD(0.1) if name == "sgd" else BertAdam(lr=4e-4, warmup=0.0,
                                                  t_total=-1)
    step = tbp.build_pipeline_train_step(st, tbp.make_pipeline_grid(2, 4),
                                         2, opt)
    m = step(batch, rng)
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=1e-5)
    got_s, got_h = port_trees(st)
    atol = 1e-6 if name == "sgd" else 2e-6
    assert_trees_close(want_s, got_s, atol, "stage")
    assert_trees_close(want_h, got_h, atol, "shared")
    if name == "adam":
        from oktopk_tpu_torch.convert import pipeline_opt_to_jax
        stage_opt, shared_opt = pipeline_opt_to_jax(st, step.opt_states)
        assert list(stage_opt["step"]) == [1, 1]
        assert int(shared_opt["step"]) == 1
        js, jh = want_opt
        assert_trees_close(js.m, stage_opt["m"], 1e-6, "stage m")
        assert_trees_close(jh.m, shared_opt["m"], 1e-6, "shared m")
        # and JAX's states into the port's optimizers, bit for bit
        from oktopk_tpu_torch.convert import pipeline_opt_from_jax
        pipeline_opt_from_jax(st, step.opt_states,
                              {"step": js.step, "m": js.m, "v": js.v},
                              {"step": jh.step, "m": jh.m, "v": jh.v})
        back_s, back_h = pipeline_opt_to_jax(st, step.opt_states)
        for want, got in ((js, back_s), (jh, back_h)):
            for f in ("step", "m", "v"):
                for a, b in zip(jax.tree.leaves(getattr(want, f)),
                                jax.tree.leaves(got[f])):
                    assert np.array_equal(np.asarray(a), np.asarray(b)), f


def test_bert_adam_clips_each_bucket_by_its_own_norm(jstaged, jparams,
                                                     dense_runs):
    """H28: BertAdam clips the stage grads and the shared grads
    by their own norms (two calls on a pipe rank), not by one norm over
    both. Both norms exceed max_grad_norm = 1 here, so both clips bind;
    one clip over both buckets would miss JAX's parameters by far more
    than the tolerance."""
    batch, rng, out = dense_runs
    (want_s, want_h), _, _ = out["adam"]
    st = port_staged(jstaged, jparams)
    step = tbp.build_pipeline_train_step(
        st, tbp.make_pipeline_grid(2, 4), 2,
        BertAdam(lr=4e-4, warmup=0.0, t_total=-1))
    step.fwd_bwd(batch, rng)
    g_s = [tbp._data_psum_row(step.grid, g) for g in step.g_stage]
    g_h = tbp._data_psum_row(step.grid, step.g_shared)
    norms = [float(torch.linalg.vector_norm(g)) for g in g_s + [g_h]]
    assert min(norms) > 1.0, norms
    # the same step with one norm over every bucket
    one = torch.sqrt(sum(torch.sum(g * g) for g in g_s + [g_h]))
    scale = float(torch.clamp(1.0 / (one + 1e-12), max=1.0))
    st1 = port_staged(jstaged, jparams)
    for b, g in zip([tbp.Bucket(st1.stage_leaves(w)) for w in range(2)]
                    + [tbp.Bucket(st1.shared_leaves())], g_s + [g_h]):
        o = BertAdam(lr=4e-4, warmup=0.0, t_total=-1, max_grad_norm=0.0)
        o.init(b.n, "cpu")
        apply_opt(o, b.params, g * scale, b.views, b.flat)
    one_s, _ = port_trees(st1)
    gap = max(float(np.abs(np.asarray(w) - np.asarray(g)).max())
              for w, g in zip(jax.tree.leaves(want_s),
                              jax.tree.leaves(one_s)))
    assert gap > 1e-5, gap


def test_grad_clip_norm_is_per_pipe_rank(jstaged, jparams):
    """``grad_clip`` (JAX's :178-183): stage s scaled by the norm of its
    own and the shared grads together, the shared grads by stage 0's
    scale (JAX's build fails its replication check with ``grad_clip``:
    its shared result varies over pipe). Held to the completed gradients
    (JAX's within atol 1e-6, ``test_dense_train_step_matches_jax``),
    clipped in float64 numpy."""
    batch = make_batch(23)
    rng = np.asarray(jax.random.PRNGKey(3))
    clip = 0.5
    st = port_staged(jstaged, jparams)
    probe = tbp.build_pipeline_train_step(
        st, tbp.make_pipeline_grid(2, 4), 2, SGD(0.1, momentum=0.0))
    probe.fwd_bwd(batch, rng)
    g_s = [tbp._data_psum_row(probe.grid, g).numpy().astype(np.float64)
           for g in probe.g_stage]
    g_h = tbp._data_psum_row(probe.grid, probe.g_shared).numpy().astype(
        np.float64)
    scales = [min(1.0, clip / (np.sqrt(np.sum(g ** 2) + np.sum(g_h ** 2))
                               + 1e-12)) for g in g_s]
    assert max(scales) < 1.0 and scales[0] != scales[1]
    before = [tbp.Bucket(st.stage_leaves(w)) for w in range(2)] + \
        [tbp.Bucket(st.shared_leaves())]
    p0 = [b.flat(b.params).detach().numpy().astype(np.float64)
          for b in before]
    step = tbp.build_pipeline_train_step(
        st, tbp.make_pipeline_grid(2, 4), 2, SGD(0.1, momentum=0.0),
        grad_clip=clip)
    step(batch, rng)
    want = [p0[0] - 0.1 * scales[0] * g_s[0],
            p0[1] - 0.1 * scales[1] * g_s[1],
            p0[2] - 0.1 * scales[0] * g_h]
    for b, w in zip(before, want):
        np.testing.assert_allclose(b.flat(b.params).detach().numpy(), w,
                                   rtol=0, atol=1e-6)


# ---- the sparse composition -------------------------------------------------

def jax_sparse_run(jstaged, jparams, compressor, batch, steps, density):
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.optim.sgd import sgd
    dp = 2
    stack, shared = jstaged.split(jparams)
    acfg = JCfg(density=density, warmup_steps=0, use_pallas=False)
    opt = sgd(lr=0.1)

    def rep(t):
        return jax.tree.map(lambda x: jnp.broadcast_to(x, (dp,) + x.shape),
                            t)

    p = (rep(stack), rep(shared))
    ss = jbp.init_pipeline_sparse_states(stack, shared, acfg, dp)
    opts = (rep(jax.vmap(opt.init)(stack)), rep(opt.init(shared)))
    step = jbp.build_pipeline_sparse_train_step(
        jstaged, mesh(dp, 2), 2, opt, acfg, compressor=compressor,
        warmup=False)
    rng = jax.random.PRNGKey(8)
    ms = []
    for _ in range(steps):
        p, ss, opts, m = step(p, ss, opts, jbatch(batch), rng)
        ms.append({k: float(v) for k, v in m.items()})
    return jax.device_get(p), jax.device_get(ss), ms, np.asarray(rng)


def port_sparse_step(jstaged, jparams, compressor, density, remat=False):
    from oktopk_tpu_torch.config import OkTopkConfig
    st = port_staged(jstaged, jparams)
    return st, tbp.build_pipeline_sparse_train_step(
        st, tbp.make_pipeline_grid(2, 4), 2, SGD(0.1),
        OkTopkConfig(density=density, warmup_steps=0),
        compressor=compressor, warmup=False, remat=remat)


def test_dense_composition_matches_jax(jstaged, jparams):
    """The sparse composition with ``dense``: each data row's gradient
    its own, the collective's mean, against JAX's composed step (equal
    per-example mask counts, as JAX's own oracle)."""
    batch = make_equal_mask_batch()
    (js, jh), _, ms, rng = jax_sparse_run(jstaged, jparams, "dense", batch,
                                          1, 0.05)
    st, step = port_sparse_step(jstaged, jparams, "dense", 0.05)
    m = step(batch, rng)
    np.testing.assert_allclose(float(m["loss"]), ms[0]["loss"], rtol=1e-5)
    assert float(m["comm_volume"]) == ms[0]["comm_volume"]
    got_s, got_h = port_trees(st)
    assert_trees_close(jax.tree.map(lambda x: x[0], js), got_s, 1e-6,
                       "stage")
    assert_trees_close(jax.tree.map(lambda x: x[0], jh), got_h, 1e-6,
                       "shared")


def make_equal_mask_batch():
    return make_batch(21, equal_masks=True)


@pytest.fixture(scope="module")
def oktopk_runs(jstaged, jparams):
    batch = make_batch(22)
    return batch, jax_sparse_run(jstaged, jparams, "oktopk", batch, 3, 0.05)


def test_oktopk_composition_three_steps(jstaged, jparams, oktopk_runs):
    batch, (jp, jss, ms, rng) = oktopk_runs
    st, step = port_sparse_step(jstaged, jparams, "oktopk", 0.05)
    n_total = sum(x.size for x in jax.tree.leaves(jparams))
    for i in range(3):
        m = step(batch, rng)
        assert np.isfinite(float(m["loss"]))
        np.testing.assert_allclose(float(m["loss"]), ms[i]["loss"],
                                   rtol=1e-5)
        vol = float(m["comm_volume"])
        assert 0 < vol < 2.0 * n_total, vol
        # every selection agrees on these inputs
        assert vol == ms[i]["comm_volume"], i
    states, shared_state = step.sstates
    assert [int(s.step[0]) for s in states] == [3, 3]
    assert int(jss[0].step[0, 0]) == 3
    # JAX's replicas are identical across the data rows; the port keeps
    # the one copy
    for leaf in jax.tree.leaves(jp):
        assert np.array_equal(leaf[0], leaf[1])
    got_s, got_h = port_trees(st)
    assert_trees_close(jax.tree.map(lambda x: x[0], jp[0]), got_s, 1e-4,
                       "stage")
    assert_trees_close(jax.tree.map(lambda x: x[0], jp[1]), got_h, 1e-4,
                       "shared")
    rep = tbp.stack_replicas(st.shared_state(), 2)
    assert all(v.shape[0] == 2 and torch.equal(v[0], v[1])
               for v in rep.values())


def test_oktopk_bucket_reduction_given_jax_gradients(jstaged, jparams):
    """Each bucket's reduction (stage 0, stage 1, shared) fed JAX's own
    per-row bucket gradients: the port's oktopk over ``StackedComm(2)``
    against JAX's over a 2-device mesh, bit-equal, thresholds within
    ulps (H1). The per-row gradients: JAX's pipeline loss of each data
    row (a dp = 1 mesh), held to the port's at atol 1e-6 first."""
    from oktopk_tpu.collectives.api import batched_init_state, \
        build_allreduce_step
    from oktopk_tpu.comm import get_mesh
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.utils.flatten import flatten_tree as jflat
    from oktopk_tpu_torch.collectives.registry import get_algorithm
    from oktopk_tpu_torch.collectives.state import init_state
    from oktopk_tpu_torch.comm import StackedComm
    from oktopk_tpu_torch.config import OkTopkConfig

    batch = make_batch(24)
    stack, shared = jstaged.split(jparams)
    loss = jbp.build_pipeline_loss(jstaged, mesh(1, 2), 2)
    st = port_staged(jstaged, jparams)
    tloss = tbp.build_pipeline_loss(st, tbp.make_pipeline_grid(2, 2), 2)
    rows = {"stage0": [], "stage1": [], "shared": []}
    for d in range(2):
        rb = {k: v[d * 4:(d + 1) * 4] for k, v in batch.items()}
        gs, gh = jax.grad(lambda a, b: loss(a, b, jbatch(rb), None),
                          argnums=(0, 1))(stack, shared)
        for s in range(2):
            rows[f"stage{s}"].append(np.asarray(
                jflat(jax.tree.map(lambda x: x[s], gs))[0]))
        rows["shared"].append(np.asarray(jflat(gh)[0]))
        st.zero_grad()
        tloss(rb).backward()
        for s in range(2):
            b = tbp.Bucket(st.stage_leaves(s))
            np.testing.assert_allclose(b.flat(b.grads()).numpy(),
                                       rows[f"stage{s}"][-1], atol=1e-6)
        b = tbp.Bucket(st.shared_leaves())
        np.testing.assert_allclose(b.flat(b.grads()).numpy(),
                                   rows["shared"][-1], atol=1e-6)
    mesh2 = get_mesh((2,), ("data",), devices=jax.devices()[:2])
    for name, g in rows.items():
        g = np.stack(g)
        kw = dict(n=g.shape[1], num_workers=2, density=0.05,
                  warmup_steps=0)
        jcfg = JCfg(**kw, use_pallas=False)
        jout, jstate = build_allreduce_step("oktopk", jcfg, mesh2,
                                            warmup=False)(
            jnp.asarray(g), batched_init_state(jcfg))
        out, state = get_algorithm("oktopk", warmup=False)(
            torch.from_numpy(g), init_state(OkTopkConfig(**kw), 2, "cpu"),
            OkTopkConfig(**kw), StackedComm(2))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout),
                                      err_msg=name)
        got = state.to_numpy()
        for f in EXACT:
            np.testing.assert_array_equal(got[f],
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f"{name} {f}")
        for f in THRESHOLDS:
            assert_ulps(got[f], np.asarray(getattr(jstate, f)), ULPS,
                        f"{name} {f}")


def test_remat_is_bit_identical_on_bert(jstaged, jparams):
    """With ``remat`` the stages recompute in backward and
    redraw the same masks from the same keys: two oktopk steps with
    dropout give the same losses, volumes and parameters bit for bit."""
    batch = make_batch(25)
    rng = np.asarray(jax.random.PRNGKey(4))
    runs = []
    for remat in (False, True):
        st, step = port_sparse_step(jstaged, jparams, "oktopk", 0.05,
                                    remat=remat)
        ms = [step(batch, rng) for _ in range(2)]
        runs.append(([float(m["loss"]) for m in ms],
                     [float(m["comm_volume"]) for m in ms],
                     {k: v.clone() for k, v in st.state_dict().items()}))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert all(torch.equal(v, runs[1][2][k]) for k, v in runs[0][2].items())


# ---- the CLI -----------------------------------------------------------------

def test_main_bert_pipeline_on_cpu(tmp_path):
    """``main_bert --pipeline-stages 2 --num-workers 4``: the sparse
    composition, then the dense step with ``--remat``, each a few steps;
    the checkpoint holds the single-module layout."""
    base = ["--model", "bert_tiny", "--device", "cpu", "--pipeline-stages",
            "2", "--num-workers", "4", "--num-microbatches", "2",
            "--batch-size", "2", "--num-minibatches", "3", "--log-every",
            "1"]
    assert main_bert.main(base + ["--ckpt-dir", str(tmp_path / "a")]) == 0
    assert main_bert.main(base + ["--compressor", "dense", "--remat"]) == 0
    from oktopk_tpu_torch.train.checkpoint import restore_checkpoint
    full = bert_to_jax_params(
        __import__("oktopk_tpu_torch.models.bert", fromlist=["x"])
        .BertForPreTraining(BertConfig.tiny()).state_dict())
    tree, step = restore_checkpoint(str(tmp_path / "a"),
                                    {"params": full, "model_state": {}})
    assert step == 3
    assert {k for k in tree["params"]} == set(full)


def test_main_bert_pipeline_needs_a_data_axis():
    with pytest.raises(SystemExit, match="data axis"):
        main_bert.main(["--model", "bert_tiny", "--device", "cpu",
                        "--pipeline-stages", "2", "--num-minibatches", "1"])


def test_compute_dtype_is_float32_on_the_pipeline_path():
    """The JAX pipeline builds its config without a dtype,
    so ``--compute-dtype bfloat16`` computes in float32 there too."""
    args = main_bert.parse_args(
        ["--model", "bert_tiny", "--device", "cpu", "--pipeline-stages", "2",
         "--num-workers", "4", "--num-microbatches", "2", "--batch-size",
         "2", "--compute-dtype", "bfloat16", "--num-minibatches", "1"])
    run = main_bert.build_pipeline(args)
    assert run.staged.cfg.dtype == torch.float32
    assert {p.dtype for p in run.staged.parameters()} == {torch.float32}
    seen = set()
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda mod, inp, out: seen.update(
            t.dtype for t in (out if isinstance(out, tuple) else (out,))
            if isinstance(t, torch.Tensor) and t.is_floating_point()))
    try:
        m = run.train_step()
    finally:
        hook.remove()
    assert seen == {torch.float32}
    assert np.isfinite(float(m["loss"]))


def test_checkpoints_interchange_with_jax(jstaged, jparams, tmp_path):
    """The port's pipeline checkpoint (single-module layout) is accepted
    by JAX's ``_maybe_warm_start`` template, and a JAX one by the
    port's; a payload of another layout restores nothing and is
    refused."""
    from oktopk_tpu.models.bert import BertForPreTraining as JaxBert
    from oktopk_tpu.train.checkpoint import save_checkpoint as jax_save
    from oktopk_tpu.train.main_bert import _maybe_warm_start as jax_warm
    assert main_bert.main([
        "--model", "bert_tiny", "--device", "cpu", "--pipeline-stages", "2",
        "--num-workers", "4", "--num-microbatches", "2", "--batch-size",
        "2", "--num-minibatches", "2", "--log-every", "1", "--ckpt-dir",
        str(tmp_path / "port")]) == 0
    ex = jnp.zeros((2, T), jnp.int32)
    template = {"params": JaxBert(JaxBertConfig.tiny()).init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(3)},
        ex, ex, jnp.ones_like(ex), train=False)["params"],
        "model_state": {}}
    args = argparse.Namespace(resume=str(tmp_path / "port"))
    got = jax_warm(args, __import__("logging").getLogger("t"), template)
    from oktopk_tpu_torch.train.checkpoint import restore_checkpoint
    want, _ = restore_checkpoint(str(tmp_path / "port"), {
        "params": jax.device_get(template["params"]), "model_state": {}})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    moved = [not np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
             zip(jax.tree.leaves(template), jax.tree.leaves(got))]
    assert sum(moved) > len(moved) // 2

    # JAX's file, as its run_pipeline writes it, into the port
    stack, shared = jstaged.split(jparams)
    jax_save(str(tmp_path / "jax"),
             {"params": jstaged.merge(stack, shared), "model_state": {}}, 5)
    targs = argparse.Namespace(resume=str(tmp_path / "jax"))
    full = bert_to_jax_params(bert_from_jax_params(jax.device_get(
        template["params"])))
    tree = main_bert._maybe_warm_start(targs, None, {"params": full,
                                                     "model_state": {}})
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jparams),
                            jax.tree.leaves(tree["params"])):
        assert np.array_equal(np.asarray(w), np.asarray(g)), path
    # a template the file leaves as it is: nothing restored, refused
    with pytest.raises(SystemExit, match="restored nothing"):
        main_bert._maybe_warm_start(targs, None, tree)
    # another path's payload: refused by the restore's layout check
    with pytest.raises(SystemExit, match="does not fully match"):
        main_bert._maybe_warm_start(
            targs, None, {"moe_params": {"w": np.zeros(3, np.float32)},
                          "model_state": {}})
