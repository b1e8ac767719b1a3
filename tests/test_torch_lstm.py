"""The port's LSTM workload pieces against the JAX package, on the same
weights (``convert.from_jax_params``) and the same numpy inputs: the
LSTM cell and ``BatchRNN``, DeepSpeech (``lstman4_tiny``) and the PTB
LSTM (``lstm_tiny``, a narrow 2-layer ``lstm``) in train and eval mode,
the full-width leaf order and n, the conversion both ways, the CTC and
language-model losses, and the synthetic PTB and AN4 batches.

Tolerances, and why:
- outputs and logits: atol 2e-5 of the largest |value| (``REL``). Each
  LSTM step is a [B, in] x [in, 4H] product whose adds XLA's CPU dot and
  PyTorch's order differently, and the recurrence carries that rounding
  through up to 101 steps; the BatchNorm means and mean-squares round
  differently too;
- gradients (parameters in JAX leaf order, and the input's): atol 5e-5
  of the largest element: the backward adds the same products through
  the time steps in reverse, in the two libraries' own orders;
- BatchNorm running statistics: rtol 1e-5, atol 1e-6 (a mean and a
  mean-square of the same float32 features, summed in different orders;
  the variances reach 3.6 at the frontend, where 1e-6 is a few ulps);
- losses: rtol 1e-5 (a float32 log-sum-exp, and CTC's forward recursion
  in log space, over the same logits). The cross entropy's gradient
  atol 1e-6 of the largest element; CTC's 1e-4 (6.1e-5 measured): each
  element is a softmax probability less a posterior occupancy from the
  alpha and beta recursions, two terms of the same size whose difference
  keeps the rounding of 30 log-space steps (optax differentiates its own
  scan, ``F.ctc_loss`` evaluates the closed form);
- leaf order, shapes, n, conversions and synthetic batches: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn

from oktopk_tpu.data.synthetic import synthetic_batch as jax_batch
from oktopk_tpu.models import deepspeech as jax_ds
from oktopk_tpu.models.registry import create_model as jax_create
from oktopk_tpu.train import losses as jax_losses

from oktopk_tpu_torch.convert import (flax_named_from_jax, from_jax_params,
                                      to_jax_params)
from oktopk_tpu_torch.data.synthetic import synthetic_batch
from oktopk_tpu_torch.models import create_model
from oktopk_tpu_torch.models.deepspeech import BatchRNN
from oktopk_tpu_torch.models.layers import SiteKeys, dropout, site_hashes
from oktopk_tpu_torch.models.layout import flax_named_leaves, to_jax_layout
from oktopk_tpu_torch.models.lstm import PTBLSTM
from oktopk_tpu_torch.models.rnn import LSTMCell, lstm
from oktopk_tpu_torch.train.losses import ctc_loss, lm_cross_entropy

REL = 2e-5
GRAD_REL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are narrow: on a loaded machine torch's thread
    pool makes them many times slower. One thread for these tests, the
    old count restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err} (largest {scale})"


def flat_grad(model):
    return np.concatenate([to_jax_layout(p.grad, lay).reshape(-1).numpy()
                           for _, p, lay in model.jax_leaves()])


def jax_flat(tree):
    return np.concatenate([np.asarray(a).reshape(-1)
                           for a in jax.tree.leaves(tree)])


def perturbed(params, seed):
    """The flax params with every leaf moved by a seeded normal draw, so
    zero-initialised biases and unit scales are not special."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(
        *np.shape(a)).astype(np.float32), params)


# ---- the cell and BatchRNN --------------------------------------------

class Holder(torch.nn.Module):
    """One port module under its flax name, as the top of a flax tree."""

    def __init__(self, name, module):
        super().__init__()
        self.add_module(name, module)

    def jax_leaves(self):
        return flax_named_leaves(self)


class FlaxBatchRNN(fnn.Module):
    """``BatchRNN`` wrapped so its parameters sit at the top of the tree
    (the port's ``BatchRNN`` is held against the JAX one)."""
    hidden: int
    batch_norm: bool

    @fnn.compact
    def __call__(self, x, train=True):
        return jax_ds.BatchRNN(self.hidden, batch_norm=self.batch_norm,
                               name="BatchRNN_0")(x, train)


class FlaxUni(fnn.Module):
    """One forward ``nn.RNN(OptimizedLSTMCell)`` from a zero carry."""
    hidden: int

    @fnn.compact
    def __call__(self, x):
        return fnn.RNN(fnn.OptimizedLSTMCell(self.hidden))(x)


def test_one_direction_matches_flax():
    """A forward LSTM layer: outputs and the gradients of a weighted sum
    with respect to the eight kernels, the four biases and the input."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 9, 5).astype(np.float32)
    w = rng.randn(3, 9, 6).astype(np.float32)
    fm = FlaxUni(6)
    params = perturbed(fm.init(jax.random.PRNGKey(1), x)["params"], 2)
    def fwd(p, x):
        out = fm.apply({"params": p}, x)
        return jnp.sum(out * w), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        fwd, argnums=(0, 1), has_aux=True))(params, x)

    m = Holder("OptimizedLSTMCell_0", LSTMCell(5, 6))
    m.load_state_dict(flax_named_from_jax(params))
    xt = torch.from_numpy(x).requires_grad_()
    y = lstm(xt, (m.OptimizedLSTMCell_0,))
    (y * torch.from_numpy(w)).sum().backward()
    close(y.detach(), out, REL, "outputs")
    close(xt.grad, gx, GRAD_REL, "input gradient")
    close(flat_grad(m), jax_flat(gp), GRAD_REL, "parameter gradient")


@pytest.mark.parametrize("batch_norm", [False, True])
def test_batch_rnn_matches_flax(batch_norm):
    """Bidirectional with summed directions (``OptimizedLSTMCell_0``
    forward, ``_1`` backward over the whole padded axis), with and
    without the sequence-wise BatchNorm: outputs, gradients, and the
    BatchNorm's running statistics."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 11, 7).astype(np.float32)
    w = rng.randn(4, 11, 8).astype(np.float32)
    fm = FlaxBatchRNN(8, batch_norm)
    v = fm.init(jax.random.PRNGKey(4), x, train=False)
    params = perturbed(v["params"], 5)
    stats = v.get("batch_stats", {})

    def fwd(p, x):
        out, new = fm.apply({"params": p, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, new)

    (_, (out, new)), (gp, gx) = jax.jit(jax.value_and_grad(
        fwd, argnums=(0, 1), has_aux=True))(params, x)
    m = Holder("BatchRNN_0", BatchRNN(7, 8, batch_norm=batch_norm))
    m.load_state_dict(flax_named_from_jax(params, stats))
    xt = torch.from_numpy(x).requires_grad_()
    y = m.BatchRNN_0(xt, train=True)
    (y * torch.from_numpy(w)).sum().backward()
    close(y.detach(), out, REL, "outputs")
    close(xt.grad, gx, GRAD_REL, "input gradient")
    close(flat_grad(m), jax_flat(gp), GRAD_REL, "parameter gradient")
    if batch_norm:
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(m.BatchRNN_0.BatchNorm_0, leaf).numpy(),
                np.asarray(new["batch_stats"]["BatchRNN_0"]["BatchNorm_0"]
                           [leaf]), rtol=1e-5, atol=1e-6)


# ---- the models --------------------------------------------------------

def jax_model(dnn, seed, **kw):
    """(flax module, params, batch_stats) from a seed, the params and
    statistics perturbed away from their initial values."""
    m, ex = jax_create(dnn, **kw)
    x = ex(2)
    v = jax.device_get(m.init({"params": jax.random.PRNGKey(seed),
                               "dropout": jax.random.PRNGKey(seed + 1)}, x,
                              train=False))
    stats = v.get("batch_stats", {})
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(lambda a: np.asarray(a) + np.abs(
        0.2 * rng.randn(*np.shape(a))).astype(np.float32), stats)
    return m, perturbed(v["params"], seed + 2), stats


@pytest.mark.parametrize("train", [True, False])
def test_deepspeech_matches_flax(train):
    """``lstman4_tiny`` (2 x 128) on 101 spectrogram frames (T' = 51):
    logits, the flat gradient of a weighted sum of the logits and the
    spectrogram's gradient; in train mode also every BatchNorm's new
    running statistics."""
    fm, params, stats = jax_model("lstman4_tiny", 0)
    b = synthetic_batch("lstman4_tiny", 3, np.random.RandomState(1),
                        seq_len=101)
    x = b["spect"]
    w = np.random.RandomState(2).randn(3, 51, 29).astype(np.float32)

    def fwd(p, x):
        out, new = fm.apply({"params": p, "batch_stats": stats}, x,
                            train=train, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, new)

    (_, (logits, new)), (gp, gx) = jax.jit(jax.value_and_grad(
        fwd, argnums=(0, 1), has_aux=True))(params, x)
    m = create_model("lstman4_tiny")
    m.load_state_dict(from_jax_params(params, stats))
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt, train=train)
    (y * torch.from_numpy(w)).sum().backward()
    close(y.detach(), logits, REL, "logits")
    close(xt.grad, gx, GRAD_REL, "spectrogram gradient")
    close(flat_grad(m), jax_flat(gp), GRAD_REL, "flat gradient")
    _, got_stats = to_jax_params(m.state_dict())
    want = new["batch_stats"] if train else stats
    for (path, a), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got_stats)):
        np.testing.assert_allclose(g, np.asarray(a), rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


PTB_NARROW = dict(vocab_size=50, hidden_size=24)


@pytest.mark.parametrize("dnn,kw,train", [
    ("lstm_tiny", {}, True),
    ("lstm_tiny", {}, False),
    # the narrow 2-layer lstm keeps the reference's keep 0.35: in eval
    # mode its dropout is off on both sides, in train mode both draw
    # flax's masks from one dropout key
    ("lstm", PTB_NARROW, False),
    ("lstm", PTB_NARROW, True),
])
def test_ptb_lstm_matches_flax(dnn, kw, train):
    """Logits and the flat gradient of the mean cross entropy, from a
    zero carry (the JAX Trainer never passes one)."""
    fm, params, _ = jax_model(dnn, 3, **kw)
    b = synthetic_batch("lstm_tiny", 3, np.random.RandomState(4))
    vocab = kw.get("vocab_size", 1024)
    toks, tgts = b["tokens"] % vocab, b["targets"] % vocab

    key = jax.random.PRNGKey(9)

    def loss(p):
        logits, _ = fm.apply({"params": p}, toks, train=train,
                             rngs={"dropout": key})
        return jax_losses.lm_cross_entropy(logits, tgts), logits

    (jl, jlogits), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    m = create_model(dnn, **kw)
    m.load_state_dict(from_jax_params(params))
    logits = m(torch.from_numpy(toks), train=train, rng=np.asarray(key))
    tl = lm_cross_entropy(logits, torch.from_numpy(tgts))
    tl.backward()
    close(logits.detach(), jlogits, REL, "logits")
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    close(flat_grad(m), jax_flat(gp), GRAD_REL, "flat gradient")


@pytest.mark.parametrize("dnn,n", [("lstman4", 54791168), ("lstm", 66022000)])
def test_full_width_leaf_order_and_n(dnn, n):
    """The full-width models' leaves in JAX order, in the flax shapes,
    counted without running either model (``jax.eval_shape``; the port's
    model on the meta device)."""
    jm, ex = jax_create(dnn)
    v = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(1)}, ex(2), train=False))
    want = [(jax.tree_util.keystr(p, simple=True, separator="/"), a.shape)
            for p, a in jax.tree_util.tree_leaves_with_path(v["params"])]
    with torch.device("meta"):
        m = create_model(dnn)
    got = [(path, tuple(to_jax_layout(p, lay).shape))
           for path, p, lay in m.jax_leaves()]
    assert got == want
    assert sum(int(np.prod(s)) for _, s in got) == n


@pytest.mark.parametrize("dnn", ["lstman4_tiny", "lstm_tiny"])
def test_convert_round_trip(dnn):
    """flax -> state_dict -> flax gives back every array, params and
    batch statistics, bit for bit; and the state_dict is the model's."""
    _, params, stats = jax_model(dnn, 7)
    sd = from_jax_params(params, stats or None)
    m = create_model(dnn)
    m.load_state_dict(sd)                              # strict: every key
    p2, s2 = to_jax_params(m.state_dict())
    for want, got in ((params, p2), (stats, s2)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), b)


# ---- losses -------------------------------------------------------------

def test_ctc_loss_matches_optax():
    """Per-batch mean CTC over varied logit and label lengths, blank 0,
    with repeated labels, and its gradient with respect to the logits.
    Premise: every sequence can align (frames >= 2 * labels + 1), where
    optax's log-epsilon and ``F.ctc_loss``'s -inf agree."""
    rng = np.random.RandomState(5)
    B, T, C, S = 6, 30, 29, 12
    logits = (2.0 * rng.randn(B, T, C)).astype(np.float32)
    logit_len = np.array([30, 25, 30, 17, 9, 30], np.int32)
    label_len = np.array([12, 5, 1, 8, 4, 10], np.int32)
    labels = rng.randint(1, C, size=(B, S)).astype(np.int32)
    labels[0, 3] = labels[0, 2]                     # a repeat
    for b in range(B):
        labels[b, label_len[b]:] = 0
    assert np.all(logit_len >= 2 * label_len + 1)
    want, gwant = jax.value_and_grad(
        lambda lg: jax_losses.ctc_loss(lg, logit_len, labels, label_len))(
        logits)
    lt = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(lt, torch.from_numpy(logit_len), torch.from_numpy(labels),
                   torch.from_numpy(label_len))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    close(lt.grad, gwant, 1e-4, "gradient")


def test_lm_cross_entropy_matches_optax():
    rng = np.random.RandomState(6)
    logits = (3.0 * rng.randn(4, 7, 33)).astype(np.float32)
    tgts = rng.randint(0, 33, size=(4, 7)).astype(np.int32)
    want, gwant = jax.value_and_grad(
        lambda lg: jax_losses.lm_cross_entropy(lg, tgts))(logits)
    lt = torch.from_numpy(logits).requires_grad_()
    got = lm_cross_entropy(lt, torch.from_numpy(tgts))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    close(lt.grad, gwant, 1e-6, "gradient")


# ---- dropout and synthetic data ----------------------------------------

def test_ptb_dropout_rate_and_scale():
    """The reference's keep 0.35 through flax's ``nn.Dropout``: the port's
    ``dropout`` under a site's key equals flax's under the same key bit
    for bit (so about 35% of the entries survive, each divided by 0.35);
    the same key repeats the model's masks, and without a key it
    raises."""
    m = PTBLSTM(vocab_size=64, hidden_size=32)
    key = jax.random.PRNGKey(5)
    x = np.ones(20000, np.float32)
    want = np.asarray(fnn.Dropout(m.rate, deterministic=False).apply(
        {}, x, rngs={"dropout": key}))
    # applied as the root module, its one draw's suffix is the count alone
    keys = SiteKeys(np.asarray(key), site_hashes([(1,)]))
    got = dropout(torch.from_numpy(x), m.rate, True, keys).numpy()
    np.testing.assert_array_equal(got, want)
    kept = got != 0
    assert abs(float(kept.mean()) - 0.35) < 0.015
    np.testing.assert_allclose(got[kept], 1.0 / 0.35, rtol=1e-6)
    toks = torch.randint(0, 64, (2, 5), generator=torch.Generator()
                         .manual_seed(1))
    a = m(toks, train=True, rng=np.asarray(key))
    b = m(toks, train=True, rng=np.asarray(key))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="key"):
        m(toks, train=True)


@pytest.mark.parametrize("dnn,seq_len", [
    ("lstm", None), ("lstm_tiny", None), ("lstm_tiny", 9),
    ("lstman4", None), ("lstman4_tiny", 101), ("lstman4_tiny", 17)])
def test_synthetic_batches_equal_jax(dnn, seq_len):
    """Same seed, same draws: two batches in a row equal, key for key,
    dtype for dtype."""
    r1, r2 = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(2):
        got = synthetic_batch(dnn, 3, r1, seq_len)
        want = jax_batch(dnn, 3, r2, seq_len)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
