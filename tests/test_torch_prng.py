"""JAX's random keys and dropout masks in the port (``ops/prng.py``)
against ``jax.random`` and flax, on the CPU (the keep mask's plain
version; the kernel is held to it on the card by ``chip_smoke.py`` and
``test_torch_kernels.py``).

Everything here is bit-equal: keys are integers, and the mask compares a
float32 exactly made from the bits with the float32 keep probability.
"""

import flax.core.scope as flax_scope
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oktopk_tpu.models.registry import create_model as jax_create

from oktopk_tpu_torch.config import TrainConfig
from oktopk_tpu_torch.models import bert as torch_bert
from oktopk_tpu_torch.models import lstm as torch_lstm
from oktopk_tpu_torch.models.layers import SiteKeys, dropout, site_hashes
from oktopk_tpu_torch.ops import prng
from oktopk_tpu_torch.train.trainer import Trainer

# Random123's known-answer vectors of threefry2x32_20: key, counter, out
KAT = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
        (0x6b200159, 0x99ba4efe)),
       ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
        (0x1cb996fc, 0xbb002be7)),
       ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
        (0xc4923a9c, 0x483df7a0))]
SEEDS = [0, 1, 42, 2 ** 31 + 7]


@pytest.mark.parametrize("key,ctr,out", KAT)
def test_known_answers(key, ctr, out):
    got = prng._threefry_np(*(np.uint64(w) for w in key + ctr))
    assert tuple(int(w) for w in got) == out


@pytest.mark.parametrize("seed", SEEDS)
def test_key_algebra_matches_jax(seed):
    k, jk = prng.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(k, np.asarray(jk))
    data = [0, 1, 7, 2 ** 31 + 3, 2 ** 32 - 1]
    np.testing.assert_array_equal(
        prng.fold_in(k[None, :], np.array(data, np.uint32)),
        np.stack([np.asarray(jax.random.fold_in(jk, d)) for d in data]))
    for num in (2, 5):
        np.testing.assert_array_equal(prng.split(k, num),
                                      np.asarray(jax.random.split(jk, num)))
    # vectorised over a batch of keys
    ks = prng.split(k, 3)
    np.testing.assert_array_equal(
        prng.split(ks), np.stack([np.asarray(jax.random.split(j))
                                  for j in jax.random.split(jk, 3)]))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape,p", [((64, 33), 0.9), ((7,), 0.35),
                                     ((1, 1, 5, 9), 0.5), ((3, 4, 11), 0.1),
                                     ((1,), 0.9)])
def test_keep_mask_matches_bernoulli(seed, shape, p):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.bernoulli(key, p, shape))
    got = prng.keep_mask(np.asarray(key), shape, p)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_mask_offset_continues_the_counters():
    """Counters past 2^32 (the high word of the counter pair nonzero): an
    offset mask is the tail of the whole one, and reaches past 2^32."""
    key = prng.prng_key(3)
    whole = prng.keep_mask(key, (300,), 0.5)
    np.testing.assert_array_equal(
        prng.keep_mask(key, (100,), 0.5, offset=200).numpy(),
        whole[200:].numpy())
    hi = prng.keep_mask(key, (64,), 0.5, offset=2 ** 32 - 32)
    lo = prng.keep_mask(key, (32,), 0.5, offset=2 ** 32)
    np.testing.assert_array_equal(hi[32:].numpy(), lo.numpy())
    assert 0 < int(hi.sum()) < 64
    with pytest.raises(ValueError):
        prng.keep_mask(key, (4,), 0.5, offset=-1)


class Inner(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        k = self.make_rng("dropout")
        return fnn.Dropout(0.3, deterministic=False)(x), k


class Outer(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return Inner()(x)


def test_flax_site_key_on_a_nested_module():
    """``Inner_0``'s own draw and its ``Dropout_0``'s: the port's keys
    from the suffixes, and its mask, equal flax's."""
    rng = jax.random.PRNGKey(17)
    x = np.linspace(1.0, 2.0, 257, dtype=np.float32)
    y, k = Outer().apply({}, x, rngs={"dropout": rng})
    r = np.asarray(rng)
    np.testing.assert_array_equal(prng.flax_site_key(r, ("Inner_0", 1)),
                                  np.asarray(k))
    keys = SiteKeys(r, site_hashes([("Inner_0", "Dropout_0", 1)]))
    got = dropout(torch.from_numpy(x), 0.3, True, keys)
    np.testing.assert_array_equal(got.numpy(), np.asarray(y))


def record_sites(model, *args, **kw):
    """Every ``make_rng("dropout")`` suffix of one train-mode apply, in
    call order (``Scope.make_rng`` wrapped), through ``jax.eval_shape``:
    shapes only."""
    seen = []
    orig = flax_scope.Scope.make_rng

    def make_rng(self, name="params"):
        key = orig(self, name)
        if name == "dropout":
            lazy = flax_scope.LazyRng.create(self.rngs[name],
                                             self.rng_counters[name])
            seen.append(tuple(lazy.suffix))
        return key

    flax_scope.Scope.make_rng = make_rng
    try:
        v = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, *args, train=False))
        seen.clear()
        jax.eval_shape(lambda v: model.apply(
            v, *args, train=True, rngs={"dropout": jax.random.PRNGKey(2)},
            **kw), v)
    finally:
        flax_scope.Scope.make_rng = orig
    return seen


@pytest.mark.parametrize("dnn", ["bert_tiny", "bert_base"])
def test_bert_dropout_sites_are_flax_calls(dnn):
    m, ex = jax_create(dnn)
    x = ex(2)
    got = record_sites(m, x, x, jnp.ones_like(x))
    cfg = getattr(torch_bert.BertConfig, dnn.split("_")[1])()
    assert torch_bert.dropout_sites(cfg) == got
    assert len(got) == 1 + 3 * cfg.num_layers


def test_lstm_dropout_sites_are_flax_calls():
    m, ex = jax_create("lstm")
    got = record_sites(m, ex(2))
    assert torch_lstm.dropout_sites() == got == [
        ("Dropout_0", 1), ("Dropout_0", 2), ("Dropout_0", 3)]


# ---- the Trainer's key chain against the JAX Trainer's -----------------

class _RecordingModel:
    """The JAX Trainer's flax model with its ``apply`` wrapped: each
    train-mode apply reports (worker index, the microbatch's first
    example, the dropout key) through ``jax.debug.callback``."""

    def __init__(self, model, seen):
        self._model, self._seen = model, seen

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply(self, variables, x, *args, rngs=None, **kw):
        if rngs is not None:
            def rec(w, first, key):
                self._seen.append((int(w), np.asarray(first).tobytes(),
                                   np.asarray(key)))
            jax.debug.callback(rec, jax.lax.axis_index("data"), x[0],
                               rngs["dropout"])
        return self._model.apply(variables, x, *args, rngs=rngs, **kw)


@pytest.mark.parametrize("P", [2, 4])
def test_trainer_key_chain_matches_jax(P, devices):
    """Two steps with two microbatches a worker: the port's Trainer key
    after each step equals the JAX Trainer's, and the dropout key of every
    (worker, microbatch) equals the key the JAX step handed that worker's
    apply. The JAX step hands every model a dropout key whether it draws
    from it or not, and the chain does not depend on the model or the
    compressor, so the cheapest to build serve: CaffeCifar on the dense
    allreduce."""
    from oktopk_tpu.comm import get_mesh
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    common = dict(dnn="caffe_cifar", batch_size=2, num_workers=P, seed=5,
                  nsteps_update=2, lr=0.1, compressor="dense")
    mesh = get_mesh((P,), ("data",), devices=devices[:P])
    jt = JTrainer(JTrain(**common), mesh=mesh, profile_norm=False)
    seen = []
    jt.model = _RecordingModel(jt.model, seen)
    tt = Trainer(TrainConfig(**common), device="cpu")
    rng = np.random.RandomState(1)
    b, ns = common["batch_size"], common["nsteps_update"]
    for _ in range(2):
        batch = {"image": rng.randn(P * ns * b, 32, 32, 3).astype(
                     np.float32),
                 "label": rng.randint(0, 10, P * ns * b).astype(np.int32)}
        want = tt.microbatch_keys(prng.split(tt._rng)[1])
        seen.clear()
        jt.train_step(batch)
        tt.train_step(batch)
        jax.effects_barrier()
        np.testing.assert_array_equal(tt._rng, np.asarray(jt._rng))
        got = {(w, first): key for w, first, key in seen}
        assert len(got) == P * ns
        for p in range(P):
            for j in range(ns):
                first = batch["image"][(p * ns + j) * b].tobytes()
                np.testing.assert_array_equal(want[p, j], got[(p, first)],
                                              err_msg=f"worker {p} mb {j}")


# ---- the kernel's device contract ----------------------------------------

def test_keep_mask_device_contract():
    """A CPU tensor takes the plain version (no launch); a device without
    a kernel raises."""
    before = prng.LAUNCHES
    prng.keep_mask(prng.prng_key(0), (5, 3), 0.9, "cpu")
    assert prng.LAUNCHES == before
    with pytest.raises(ValueError):
        prng.keep_mask(prng.prng_key(0), (5, 3), 0.9, "meta")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_threefry_kernel_matches_plain_on_the_card(cuda_device):
    """``csrc/threefry.cu`` bit-equal to the plain version at odd lengths
    and at counters past 2^32, and to ``jax.random.bernoulli``; one launch
    a mask."""
    key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(7), 2))
    for shape, p, offset in (((1,), 0.9, 0), ((1000003,), 0.9, 0),
                             ((8, 128, 768), 0.9, 0), ((333,), 0.35,
                                                       2 ** 32 - 100),
                             ((4097,), 0.5, 3 * 2 ** 32 + 5)):
        before = prng.LAUNCHES
        got = prng.keep_mask(key, shape, p, cuda_device, offset=offset)
        assert prng.LAUNCHES == before + 1
        want = prng.keep_mask_plain(key, shape, p, offset=offset)
        assert torch.equal(got.cpu(), want), (shape, offset)
    np.testing.assert_array_equal(
        prng.keep_mask(key, (64, 33), 0.9, cuda_device).cpu().numpy(),
        np.asarray(jax.random.bernoulli(jnp.asarray(key), 0.9, (64, 33))))
