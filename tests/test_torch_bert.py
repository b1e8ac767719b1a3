"""The port's BERT pretraining pieces against the JAX package, on the
same weights (``convert.from_jax_params``) and the same numpy inputs:
config, leaf order and layouts, conversion, forward, loss, flat
gradient, BertAdam and its schedules, and the synthetic Wikipedia batch.

Tolerances, and why:
- forward logits: rtol 1e-4 / atol 2e-5 of the largest logit. XLA's CPU
  matmuls and PyTorch's add in different orders, and LayerNorm's mean and
  mean-square, the softmax sums and the MLM decoder's vocab-wide products
  all round differently in the last bits;
- loss: rtol 1e-5 (float32 log-sum-exp over the same logits);
- flat gradient: atol 2e-5 of the largest gradient element (the tied
  word-embedding gradient adds its two uses in a different order);
- BertAdam: the global norm is a sum over leaves in JAX and over one flat
  buffer here, and XLA contracts ``b * m + (1 - b) * g`` into fused
  multiply-adds (ROADMAP H11); updates agree within 1e-6 relative to the
  largest update (a few ulps), the moments within 1e-6 of their largest
  entry;
- schedules: the piecewise-linear ones bit-equal; the cosine one within
  2 ulps of 1.0 (2^-22) absolute: ``cos`` differs in its last bit between
  the two libraries, and near x = 1 the 1 + cos cancellation turns that
  into many ulps of a tiny result; the learning rate the same relative to
  lr;
- config, leaf order, shapes, conversion and synthetic batches:
  bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oktopk_tpu.models.bert as jax_bert
from oktopk_tpu.data.synthetic import synthetic_batch as jax_batch
from oktopk_tpu.optim.bert_adam import BertAdam as JaxBertAdam
from oktopk_tpu.optim import schedules as jax_sched
from oktopk_tpu.train.losses import bert_pretrain_loss as jax_loss

import oktopk_tpu_torch.models.bert as torch_bert
from oktopk_tpu_torch.convert import from_jax_params, to_jax_params
from oktopk_tpu_torch.data.synthetic import synthetic_batch
from oktopk_tpu_torch.models.layout import to_jax_layout
from oktopk_tpu_torch.optim import BertAdam
from oktopk_tpu_torch.optim import schedules
from oktopk_tpu_torch.train.losses import bert_pretrain_loss

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """bert_tiny's matrices are far too small to share among threads: on
    a loaded machine torch's thread pool makes each step tens of times
    slower. One thread for these tests, the old count restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# 12 layers (so the string sort puts layer_10 and layer_11 after
# layer_1), narrow widths
NARROW = dict(vocab_size=64, hidden_size=16, num_layers=12, num_heads=2,
              intermediate_size=32, max_position=64)
CONFIGS = {"tiny": lambda m, **kw: m.BertConfig.tiny(**kw),
           "narrow12": lambda m, **kw: m.BertConfig(**NARROW, **kw)}


def flax_init(which="tiny", seed=0, seq=16):
    cfg = CONFIGS[which](jax_bert, dropout=0.0)
    model = jax_bert.BertForPreTraining(cfg)
    ex = jnp.zeros((2, seq), jnp.int32)
    v = model.init({"params": jax.random.PRNGKey(seed),
                    "dropout": jax.random.PRNGKey(seed + 1)}, ex, ex,
                   jnp.ones_like(ex), train=False)
    return model, jax.device_get(v["params"])


def port_model(which="tiny", params=None):
    m = torch_bert.BertForPreTraining(CONFIGS[which](torch_bert,
                                                     dropout=0.0))
    if params is not None:
        m.load_state_dict(from_jax_params(params))
    return m


def inputs(vocab, bs=3, seq=16, seed=1):
    """A batch with a padded attention mask (rows 1 and 2 end in zeros)
    and 15% masked tokens."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (bs, seq)).astype(np.int32)
    tt = rng.randint(0, 2, (bs, seq)).astype(np.int32)
    am = np.ones((bs, seq), np.int32)
    am[1, seq * 2 // 3:] = 0
    am[2, 3:] = 0
    mlm = np.where(rng.rand(bs, seq) < 0.15, ids, -1).astype(np.int32)
    nsp = rng.randint(0, 2, (bs,)).astype(np.int32)
    return ids, tt, am, mlm, nsp


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", ["base", "large", "tiny"])
def test_config_fields_match(name):
    jc = getattr(jax_bert.BertConfig, name)()
    tc = getattr(torch_bert.BertConfig, name)()
    jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    assert np.dtype(jf.pop("dtype")).name == str(tf.pop("dtype")).split(
        ".")[-1]
    assert jf == tf


def test_config_rejects_bfloat16():
    """bfloat16 is a compute dtype now (``tests/test_torch_bf16.py``);
    the config rejects the dtypes the port has no path for."""
    assert torch_bert.BertConfig.tiny(dtype=torch.bfloat16).dtype \
        == torch.bfloat16
    with pytest.raises(ValueError):
        torch_bert.BertConfig.tiny(dtype=torch.float16)


@pytest.mark.parametrize("which", ["tiny", "narrow12"])
def test_jax_leaf_order_shapes_and_round_trip(which):
    _, params = flax_init(which)
    paths = ["/".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    m = port_model(which, params)
    leaves = m.jax_leaves()
    assert [nm for nm, _, _ in leaves] == paths
    want = jax.tree.leaves(params)
    for (nm, p, lay), w in zip(leaves, want):
        got = to_jax_layout(p, lay).detach().numpy()
        assert got.shape == np.asarray(w).shape, nm
        np.testing.assert_array_equal(got, np.asarray(w), err_msg=nm)
    p2, stats = to_jax_params(m.state_dict())
    assert stats == {}
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), b)
    if which == "narrow12":
        enc = [nm.split("/")[2] for nm in paths if "/encoder/" in nm]
        assert list(dict.fromkeys(enc))[:4] == ["layer_0", "layer_1",
                                                "layer_10", "layer_11"]


def test_bert_base_size_and_leaf_count():
    m = torch_bert.BertForPreTraining(torch_bert.BertConfig.base())
    leaves = m.jax_leaves()
    assert len(leaves) == 206
    assert sum(p.numel() for _, p, _ in leaves) == 110106428
    assert [nm for nm, _, _ in leaves[:4]] == [
        "bert/embeddings/LayerNorm_0/bias",
        "bert/embeddings/LayerNorm_0/scale",
        "bert/embeddings/position_embeddings/embedding",
        "bert/embeddings/token_type_embeddings/embedding"]


def test_init_weights_has_flax_distributions():
    """Each leaf's init has the spread of flax's initialiser: the two
    sample stds within 10% (4 standard errors for small leaves), zeros and
    ones exactly, truncated kernels inside two of their stds."""
    _, params = flax_init("narrow12")
    m = port_model("narrow12")
    m.init_weights(torch.Generator().manual_seed(0))
    for (nm, p, lay), w in zip(m.jax_leaves(), jax.tree.leaves(params)):
        got = to_jax_layout(p, lay).detach().numpy()
        w = np.asarray(w)
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(got, w, err_msg=nm)
        else:
            tol = max(0.1, 4.0 / np.sqrt(w.size))
            assert abs(got.std() / w.std() - 1) < tol, nm
            if nm.endswith("kernel"):
                qkv = nm.split("/")[-2] in ("query", "key", "value")
                fan_in = w.shape[0] if qkv else np.prod(w.shape[:-1])
                bound = 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
                assert np.abs(got).max() <= bound * (1 + 1e-6), nm


@pytest.mark.parametrize("which", ["tiny", "narrow12"])
def test_forward_logits_with_padded_mask(which):
    model, params = flax_init(which)
    vocab = CONFIGS[which](jax_bert).vocab_size
    ids, tt, am, _, _ = inputs(vocab)
    mj, nj = model.apply({"params": params}, ids, tt, am, train=False)
    m = port_model(which, params)
    with torch.no_grad():
        mt, nt = m(t(ids), t(tt), t(am), train=False)
    for got, want in ((mt, mj), (nt, nj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=2e-5 * np.abs(want).max())


def test_dropout_draws_from_the_generator():
    """train=True with dropout 0.1: the port draws flax's own masks from
    the apply's dropout key (the key contract that replaced the
    per-worker torch generators), so its logits equal flax's train-mode
    apply under the same key within the forward tolerance; the same key
    repeats bit for bit, another key gives others, and without a key it
    raises."""
    _, params = flax_init("tiny")
    fm = jax_bert.BertForPreTraining(jax_bert.BertConfig.tiny(dropout=0.1))
    m = torch_bert.BertForPreTraining(torch_bert.BertConfig.tiny())
    m.load_state_dict(from_jax_params(params))
    ids, tt, am, _, _ = inputs(1024)
    key = jax.random.PRNGKey(11)
    mj, nj = fm.apply({"params": params}, ids, tt, am, train=True,
                      rngs={"dropout": key})

    def run(k):
        with torch.no_grad():
            return m(t(ids), t(tt), t(am), train=True,
                     rng=np.asarray(k))

    mt, nt = run(key)
    for got, want in ((mt, mj), (nt, nj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=2e-5 * np.abs(want).max())
    assert torch.equal(run(key)[0], mt)
    assert not torch.equal(run(jax.random.PRNGKey(12))[0], mt)
    with torch.no_grad():
        off = m(t(ids), t(tt), t(am), train=False)[0]
    assert not torch.equal(mt, off)
    with pytest.raises(ValueError, match="key"):
        m(t(ids), t(tt), t(am), train=True)


@pytest.mark.parametrize("masked", ["some", "none", "all"])
def test_pretrain_loss(masked):
    rng = np.random.RandomState(5)
    B, T, V = 4, 8, 50
    mlm_logits = (3 * rng.randn(B, T, V)).astype(np.float32)
    nsp_logits = rng.randn(B, 2).astype(np.float32)
    labels = rng.randint(0, V, (B, T)).astype(np.int32)
    if masked == "some":
        labels = np.where(rng.rand(B, T) < 0.3, labels, -1).astype(np.int32)
    elif masked == "none":
        labels[:] = -1
    nsp = rng.randint(0, 2, (B,)).astype(np.int32)
    lj, auxj = jax_loss(mlm_logits, nsp_logits, labels, nsp)
    lt, auxt = bert_pretrain_loss(t(mlm_logits), t(nsp_logits), t(labels),
                                  t(nsp))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for k in ("mlm_loss", "nsp_loss"):
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]),
                                   rtol=1e-5)
    if masked == "none":
        assert float(auxt["mlm_loss"]) == 0.0


def test_flat_gradient_in_jax_order():
    """The flat gradient in the JAX leaf order and layout against
    ``jax.grad`` flattened by ``jax.tree.leaves``, padded mask and all."""
    model, params = flax_init("tiny")
    ids, tt, am, mlm, nsp = inputs(1024, bs=4, seq=16, seed=2)

    def loss_fn(p):
        a, b = model.apply({"params": p}, ids, tt, am, train=False)
        return jax_loss(a, b, mlm, nsp)[0]

    want = np.concatenate([np.asarray(g).reshape(-1) for g in
                           jax.tree.leaves(jax.grad(loss_fn)(params))])
    m = port_model("tiny", params)
    a, b = m(t(ids), t(tt), t(am), train=True)
    bert_pretrain_loss(a, b, t(mlm), t(nsp))[0].backward()
    got = torch.cat([to_jax_layout(p.grad, lay).reshape(-1)
                     for _, p, lay in m.jax_leaves()]).numpy()
    assert got.shape == want.shape == (sum(
        p.numel() for p in m.parameters()),)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("name", sorted(schedules.SCHEDULES))
def test_schedules_match(name):
    x = np.concatenate([np.linspace(0, 1.2, 241),
                        [0.0, 0.001, 0.002, 0.0021, 0.5, 1.0]]) \
        .astype(np.float32)
    for warmup in (0.002, 0.01, 0.1):
        want = np.asarray(jax_sched.SCHEDULES[name](jnp.asarray(x), warmup))
        got = schedules.SCHEDULES[name](torch.from_numpy(x), warmup).numpy()
        assert got.dtype == np.float32
        if name == "warmup_cosine":
            np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -22)
        else:
            assert ulps(got, want) == 0, (name, warmup)


ADAM_CASES = {
    # name: (BertAdam kwargs, gradient scale)
    "clip binds, warmup then linear decay": (
        dict(t_total=6, warmup=0.34), 10.0),
    "clip loose": (dict(t_total=6, warmup=0.2, max_grad_norm=1e4), 1.0),
    "no schedule (t_total <= 0)": (dict(t_total=-1), 1.0),
    "cosine, no weight decay": (dict(t_total=5, warmup=0.2,
                                     schedule="warmup_cosine",
                                     weight_decay=0.0), 1.0),
    "constant, no clip": (dict(t_total=4, warmup=0.3,
                               schedule="warmup_constant",
                               max_grad_norm=0.0), 0.1),
}


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_bert_adam_matches_jax(case):
    """Five updates from the same flat params and gradients, the update
    applied as the JAX step does (params + update)."""
    kw, scale = ADAM_CASES[case]
    n = 3000
    rng = np.random.RandomState(11)
    p = rng.randn(n).astype(np.float32)
    grads = [(scale * rng.randn(n) * (rng.rand(n) < 0.3)).astype(np.float32)
             for _ in range(5)]
    jopt = JaxBertAdam(lr=1e-2, **kw)
    topt = BertAdam(lr=1e-2, **kw)
    jp, jst = jnp.asarray(p), jopt.init(jnp.asarray(p))
    tp = torch.from_numpy(p.copy())
    topt.init(n, "cpu")
    for i, g in enumerate(grads):
        lr_want = float(jopt.lr_t(jst.step))
        assert abs(float(topt.lr_t()) - lr_want) <= 1e-2 * 2.0 ** -22, i
        upd_j, jst = jopt.update(jnp.asarray(g), jst, jp)
        jp = jp + upd_j
        upd_t = topt.update(torch.from_numpy(g), tp)
        tp = tp + upd_t
        upd_j = np.asarray(upd_j)
        np.testing.assert_allclose(upd_t.numpy(), upd_j, rtol=0,
                                   atol=1e-6 * np.abs(upd_j).max() + 1e-30,
                                   err_msg=f"update {i}")
        for got, want in ((topt.m, jst.m), (topt.v, jst.v)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    assert int(topt.step) == int(jst.step) == 5
    assert topt.step.dtype == torch.int32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_bert_adam_clip_scale():
    """With a gradient of norm 10 the first moment is clipped to norm
    max_grad_norm * (1 - b1)."""
    g = torch.zeros(100)
    g[:4] = 5.0                                       # norm 10
    opt = BertAdam(max_grad_norm=1.0, weight_decay=0.0)
    opt.init(100, "cpu")
    opt.update(g)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(opt.m)), 0.1,
                               rtol=1e-6)


@pytest.mark.parametrize("dnn,bs,seq", [("bert_tiny", 8, None),
                                        ("bert_base", 3, None),
                                        ("bert_tiny", 2, 48)])
def test_synthetic_batch_bit_equal(dnn, bs, seq):
    a = synthetic_batch(dnn, bs, np.random.RandomState(3), seq)
    b = jax_batch(dnn, bs, np.random.RandomState(3), seq)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
