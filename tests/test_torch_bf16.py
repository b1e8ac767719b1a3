"""bfloat16 compute in the port (``--compute-dtype bfloat16``, flax's
``dtype=jnp.bfloat16``) against the JAX package's, from one set of
float32 weights carried over by ``convert.py`` and the same numpy
inputs.

Bit-equality with XLA is not on offer in bfloat16. The port rounds to
bfloat16 wherever flax's program does (each Dense, Conv and Embed's
product, its bias add, the gates, the residual adds; float32 inside the
norms; ``models/layers.py``), but XLA's CPU backend runs with
``--xla_allow_excess_precision`` on by default, which drops the
bfloat16 rounding between the ops it fuses (ROADMAP.md, H21). With the
flag off, mnistnet's logits are flax's bit for bit
(``test_op_for_op_without_excess_precision``). Each family is held
instead to a yardstick, on its logits and on the float32 flat parameter
gradient of a weighted sum of its logits:

- ``d_ref = max|JAX_bf16 - JAX_f32| / max|JAX_f32|``: how far flax's own
  bfloat16 lies from its float32;
- ``d_port = max|port_bf16 - JAX_bf16| / max|JAX_f32|``.

``LIMITS`` holds each family's ``d_port`` to a multiple of its ``d_ref``;
the numbers beside them are this machine's (CPU, one torch thread). The
port's side is ``scripts/bf16_card_yardstick.py``, which also runs on the
card from the files ``write_references`` makes.

Also here: BatchNorm's and LayerNorm's float32 promotion, dropout in
bfloat16 bit-equal to flax's, the attention softmax chosen by
measurement, the hidden activations' dtype in every family, and the
master weights through ``convert.py`` and a checkpoint.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn

from oktopk_tpu.models.registry import create_model as jax_create

from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.convert import from_jax_params, to_jax_params
from oktopk_tpu_torch.models import create_model
from oktopk_tpu_torch.models.bert import FlaxSoftmax, LayerNorm
from oktopk_tpu_torch.models.layers import (BatchNorm, SiteKeys,
                                            attention_dropout, dropout,
                                            set_compute_dtype, site_hashes)
from oktopk_tpu_torch.models.registry import IMAGE_SHAPES

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Narrow models: one torch thread (the CPU convolutions' weight
    gradients also add in a thread-count-dependent order), the old count
    restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_flat(tree):
    return np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in jax.tree.leaves(tree)])


def perturb(tree, seed):
    """A flax tree of the given shapes drawn from a seed: kernels and
    tables lecun-normal, BatchNorm variances near 1, scales near 1, the
    rest small."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        leaf = path[-1].key
        z = rng.randn(*np.shape(a))
        if leaf in ("kernel", "embedding"):
            z /= np.sqrt(np.prod(np.shape(a)[:-1]))
        elif leaf == "var":
            z = 1.0 + np.abs(0.2 * z)
        elif leaf == "scale":
            z = 1.0 + 0.1 * z
        else:
            z *= 0.1
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


# family: (registry name, fields, input kind, batch, train). The two
# families with BatchNorm run twice: in train mode, on the batch's
# statistics, and (``_running``) on the running statistics, flax's
# ``train=False``. In train mode the gradient passes through the batch
# statistics' backward, where it cancels (the float32 gradient is the
# small remainder of large terms): there flax's own bfloat16 gradient
# lies 0.35 (resnet20) and 0.20 (lstman4_tiny) of its largest element
# from its float32, at any batch (resnet20 at 4, 16 and 64 images: 0.35,
# 0.33, 0.28), a yardstick too wide to tell much apart. On the running
# statistics it does not cancel, and d_ref is 0.017 and 0.042.
# ``lstman4_tiny_long`` is DeepSpeech at a full AN4 utterance's length
# (801 frames, T' = 401).
FAMILIES = {
    "mnistnet": ("mnistnet", {}, "image", 4, True),
    "resnet20": ("resnet20", {}, "image", 4, True),
    "resnet20_running": ("resnet20", {}, "image", 4, False),
    "bert_tiny": ("bert_tiny", {"dropout": 0.0}, "bert", 3, True),
    "lstman4_tiny": ("lstman4_tiny", {}, "spect", 2, True),
    "lstman4_tiny_running": ("lstman4_tiny", {}, "spect", 2, False),
    "lstman4_tiny_long": ("lstman4_tiny", {}, "spect_long", 2, True),
    "lstm_tiny": ("lstm_tiny", {}, "tokens", 3, True),
}

# family: (logits, gradient) multiples of d_ref that d_port may reach,
# each between the sound port's reading and that of a port with a
# planted fault (``test_planted_faults_fail_the_yardstick``). Measured
# (seed 0), d_ref / d_port:
# - mnistnet: logits 5.30e-3 / 1.61e-3, gradient 0.104 / 1.03e-2;
# - resnet20: logits 8.36e-3 / 1.33e-2 (1.59), gradient 0.354 / 0.483
#   (1.36; BatchNorm's backward halved 2.92, its statistics taken in
#   bfloat16 1.88);
# - resnet20_running: logits 5.70e-3 / 6.50e-3 (1.14), gradient
#   1.67e-2 / 2.43e-2 (1.45; BatchNorm's backward halved 18.6);
# - bert_tiny: logits 1.01e-2 / 1.27e-2, gradient 7.86e-3 / 8.14e-3;
# - lstman4_tiny (torch.lstm, a bfloat16 carry): logits 1.10e-2 /
#   1.25e-2 (1.14), gradient 0.196 / 0.196 (1.00; BatchNorm's backward
#   halved 4.92);
# - lstman4_tiny_running: logits 6.03e-3 / 6.13e-3 (1.02), gradient
#   4.22e-2 / 2.80e-2 (0.66; BatchNorm's backward halved 8.57);
# - lstman4_tiny_long: logits 1.37e-2 / 1.43e-2 (1.04), gradient 0.208 /
#   0.214 (1.03);
# - lstm_tiny (the written-out cell): logits 5.47e-3 / 2.33e-3, gradient
#   1.14e-2 / 1.22e-2 (1.07).
LIMITS = {
    "mnistnet": (1.0, 1.0),
    "resnet20": (2.0, 1.5),
    "resnet20_running": (1.5, 1.6),
    "bert_tiny": (1.5, 1.5),
    "lstman4_tiny": (1.5, 1.1),
    "lstman4_tiny_running": (1.5, 1.0),
    "lstman4_tiny_long": (1.5, 1.1),
    "lstm_tiny": (1.0, 1.5),
}


def family_inputs(kind, dnn, bs, rng):
    if kind == "image":
        h, w, c = IMAGE_SHAPES[dnn]
        return (rng.randn(bs, h, w, c).astype(np.float32),)
    if kind == "bert":
        ids = rng.randint(0, 1024, (bs, 32)).astype(np.int32)
        tt = rng.randint(0, 2, (bs, 32)).astype(np.int32)
        am = np.ones((bs, 32), np.int32)
        am[1, 20:] = 0
        return ids, tt, am
    if kind in ("spect", "spect_long"):
        frames = 801 if kind == "spect_long" else 101
        return (rng.randn(bs, 161, frames, 1).astype(np.float32),)
    return (rng.randint(0, 1024, (bs, 35)).astype(np.int32),)


def jax_apply(fm, kind, variables, xs, train=True):
    """The flax model's outputs (no dropout), a tuple; ``train`` False
    runs BatchNorm on its running statistics."""
    if kind == "bert":
        return tuple(fm.apply(variables, *xs, train=True))
    if kind == "tokens":
        return (fm.apply(variables, xs[0], train=True)[0],)
    if not train:
        return (fm.apply(variables, xs[0], train=False),)
    mut = ["batch_stats"] if "batch_stats" in variables else False
    out = fm.apply(variables, xs[0], train=True, mutable=mut)
    return (out[0] if mut else out,)


def yardstick_script():
    """``scripts/bf16_card_yardstick.py``, the port's side of the
    yardstick (it runs on the card from files this module writes)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "bf16_card_yardstick.py")
    spec = importlib.util.spec_from_file_location("bf16_card_yardstick",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(case, seed=0):
    """flax's side of ``case``: inputs, output weights, parameters and
    batch statistics from a seed, and flax's float32 and bfloat16 logits
    and flat gradient (``o32``, ``g32``, ``o16``, ``g16``); made once per
    process."""
    return _reference(case, seed)


@functools.lru_cache(maxsize=None)
def _reference(case, seed):
    dnn, kw, kind, bs, train = FAMILIES[case]
    rng = np.random.RandomState(seed)
    xs = family_inputs(kind, dnn, bs, rng)
    f32m, _ = jax_create(dnn, **kw)
    bfm, _ = jax_create(dnn, dtype=jnp.bfloat16, **kw)
    v = jax.eval_shape(lambda: f32m.init(
        {"params": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(1)}, *xs, train=False))
    params = perturb(v["params"], seed + 1)
    stats = perturb(v.get("batch_stats", {}), seed + 2)
    extra = {"batch_stats": stats} if stats else {}
    outs = jax.eval_shape(lambda: jax_apply(
        f32m, kind, {"params": params, **extra}, xs, train))
    ws = [rng.randn(*o.shape).astype(np.float32) for o in outs]

    def run(fm):
        def f(p):
            o = jax_apply(fm, kind, {"params": p, **extra}, xs, train)
            return sum(jnp.sum(a * w) for a, w in zip(o, ws)), o
        (_, o), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        return np.concatenate([np.asarray(a).reshape(-1) for a in o]), \
            jax_flat(g)

    ref = {"dnn": dnn, "kw": kw, "train": train, "xs": list(xs), "ws": ws,
           "params": params, "stats": stats}
    (ref["o32"], ref["g32"]), (ref["o16"], ref["g16"]) = run(f32m), \
        run(bfm)
    return ref


def write_references(directory, seed=0):
    """Each family's ``reference`` as ``<case>.npz`` under ``directory``,
    the files ``scripts/bf16_card_yardstick.py`` reads."""
    os.makedirs(directory, exist_ok=True)

    def flat(tree):
        return {jax.tree_util.keystr(p, simple=True, separator="/"):
                np.asarray(a) for p, a in
                jax.tree_util.tree_leaves_with_path(tree)}

    for case in FAMILIES:
        ref = reference(case, seed)
        meta = {"dnn": ref["dnn"], "kw": ref["kw"], "train": ref["train"],
                "n_xs": len(ref["xs"]), "n_ws": len(ref["ws"])}
        np.savez(os.path.join(directory, f"{case}.npz"),
                 meta=json.dumps(meta),
                 **{f"x{i}": a for i, a in enumerate(ref["xs"])},
                 **{f"w{i}": a for i, a in enumerate(ref["ws"])},
                 **{f"p:{k}": a for k, a in flat(ref["params"]).items()},
                 **{f"s:{k}": a for k, a in flat(ref["stats"]).items()},
                 **{k: ref[k] for k in ("o32", "g32", "o16", "g16")})


def measure(case, seed=0):
    """{"logits": (d_ref, d_port), "grad": (d_ref, d_port)} on the CPU."""
    return yardstick_script().port_distance(reference(case, seed), "cpu")


@pytest.mark.parametrize("case", list(FAMILIES))
def test_family_within_yardstick(case):
    d = measure(case)
    for what, limit in zip(("logits", "grad"), LIMITS[case]):
        d_ref, d_port = d[what]
        assert 0 < d_ref < 1, (what, d_ref)
        assert d_port <= limit * d_ref, (
            f"{case} {what}: d_port {d_port:.3g} > {limit} x d_ref "
            f"{d_ref:.3g}")


def _half_grad(x):
    """``x`` whose gradient is halved on the way back."""
    class Half(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a.view_as(a)

        @staticmethod
        def backward(ctx, g):
            return 0.5 * g
    return Half.apply(x)


def _bfloat16_statistics(self, x, train=True, update_stats=True):
    """BatchNorm with its batch statistics taken in bfloat16 (the mean
    and the mean square of the bfloat16 input, in bfloat16), the rest as
    the port's."""
    if not train or self.compute_dtype is None:
        return BatchNorm.forward(self, x, train, update_stats)
    mean, mean2 = x.mean(self.axes), (x * x).mean(self.axes)
    var = torch.clamp(mean2 - mean * mean, min=0.0).float()
    shape = [1 if d in self.axes else -1 for d in range(x.dim())]
    mul = torch.rsqrt(var + self.eps) * self.scale
    y = (x.float() - mean.float().view(shape)) * mul.view(shape) + \
        self.bias.view(shape)
    return y.to(self.compute_dtype)


FAULTS = {
    "batchnorm_backward_halved":
        lambda self, x, train=True, update_stats=True: BatchNorm.forward(
            self, _half_grad(x), train, update_stats),
    "batchnorm_statistics_in_bfloat16": _bfloat16_statistics,
}


@pytest.mark.parametrize("fault, case", [
    ("batchnorm_backward_halved", "resnet20"),
    ("batchnorm_backward_halved", "resnet20_running"),
    ("batchnorm_backward_halved", "lstman4_tiny"),
    ("batchnorm_backward_halved", "lstman4_tiny_running"),
    ("batchnorm_statistics_in_bfloat16", "resnet20"),
])
def test_planted_faults_fail_the_yardstick(fault, case, monkeypatch):
    """The yardstick tells a port with a planted BatchNorm fault from the
    sound one: the same family's ``d_port`` passes ``LIMITS`` sound and
    fails them with the fault (measured beside ``LIMITS``)."""
    script = yardstick_script()
    ref = reference(case)

    def within(d):
        return all(d[w][1] <= limit * d[w][0]
                   for w, limit in zip(("logits", "grad"), LIMITS[case]))
    assert within(script.port_distance(ref, "cpu"))
    monkeypatch.setattr(BatchNorm, "__call__", FAULTS[fault])
    assert not within(script.port_distance(ref, "cpu"))


def test_deepspeech_carry_dtype_is_below_the_yardstick(monkeypatch):
    """flax's DeepSpeech keeps its LSTM carry in float32
    (``initialize_carry``'s ``param_dtype``); the port runs
    ``torch.lstm``, whose carry is bfloat16 (cuDNN's on the card). At a
    full AN4 utterance's length (801 frames, T' = 401), the cell written
    out with flax's float32 carry comes no closer to flax. Measured:
    logits d_port 1.43e-2 both (d_ref 1.37e-2); gradients 0.2141 and
    0.2147 (d_ref 0.2077); on the LSTM cells' 48 leaves, each leaf's
    d_port over its own d_ref, median 1.067 (``torch.lstm``) against
    1.142 (written out), the worst 1.76 against 1.57. The carry moves
    nothing beyond the spread from leaf to leaf; both held to
    ``LIMITS``, the worst leaf to 2 d_ref."""
    from oktopk_tpu_torch.models import deepspeech, rnn

    def f32_carry(x, cells):
        (x,) = rnn.promote(cells[0].compute_dtype, x)
        outs = [rnn.lstm_written_out(x, c, torch.float32, reverse=d == 1)
                for d, c in enumerate(cells)]
        return outs[0] + outs[1]

    def lstm_leaves(d):
        return np.array([v[1] / v[0] for k, v in d["leaves"].items()
                         if "LSTMCell" in k])

    script = yardstick_script()
    ref = reference("lstman4_tiny_long")
    shipped = script.port_distance(ref, "cpu")
    monkeypatch.setattr(deepspeech, "lstm", f32_carry)
    written = script.port_distance(ref, "cpu")
    for d in (shipped, written):
        for what, limit in zip(("logits", "grad"),
                               LIMITS["lstman4_tiny_long"]):
            assert d[what][1] <= limit * d[what][0], (what, d[what])
    assert shipped["logits"][1] <= 1.05 * written["logits"][1]
    a, b = lstm_leaves(shipped), lstm_leaves(written)
    assert len(a) == 48 and a.max() <= 2.0, a.max()
    assert np.median(a) <= np.median(b), (np.median(a), np.median(b))


def test_ptb_cell_is_written_out(monkeypatch):
    """The PTB model's carry is bfloat16, as flax's (its zeros are in the
    compute dtype); ``torch.lstm``'s fused step lands further from
    flax's cell than flax's own bfloat16 from float32 (logits d_port
    6.40e-3 against d_ref 5.47e-3, 1.17 d_ref), the cell written out
    (``rnn.lstm_written_out``) at 2.33e-3 (0.43 d_ref); the gradients
    1.07 d_ref both. On an H100 the same (logits 0.85
    against 1.06 d_ref, ``scripts/bf16_card_yardstick.py --ptb-cell``):
    the PTB model runs it."""
    from oktopk_tpu_torch.models import lstm as ptb
    from oktopk_tpu_torch.models import rnn

    script = yardstick_script()
    ref = reference("lstm_tiny")
    written = script.port_distance(ref, "cpu")
    monkeypatch.setattr(ptb, "lstm_written_out",
                        lambda x, cell: rnn.lstm(x, (cell,)))
    fused = script.port_distance(ref, "cpu")
    assert written["logits"][1] <= LIMITS["lstm_tiny"][0] * \
        written["logits"][0]
    assert written["logits"][1] < 0.5 * fused["logits"][1], (written,
                                                             fused)


def test_lstm_sigmoid_is_xlas():
    """flax's ``sigmoid`` in bfloat16 is ``lax.logistic``, which XLA's CPU
    backend expands into ``1 / (1 + exp(-x))``, each op rounded to
    bfloat16: ``rnn.sigmoid`` writes it so (measured: 4 of 196,608
    values differ, in ``exp``'s last bit), a sigmoid rounded once
    (``torch.sigmoid``) differs in 63,846."""
    from oktopk_tpu_torch.models.rnn import sigmoid

    x = jnp.asarray(2.0 * np.random.RandomState(0).randn(64, 3072)
                    .astype(np.float32), jnp.bfloat16)
    want = np.asarray(jax.jit(jax.nn.sigmoid)(x).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(BF16)
    n_ours = int((sigmoid(xt).float().numpy() != want).sum())
    n_once = int((torch.sigmoid(xt).float().numpy() != want).sum())
    assert n_ours <= 16 and n_once > 0.2 * want.size, (n_ours, n_once)


def test_embedding_gradient_sums_in_float32():
    """flax's bfloat16 ``Embed`` scatter-adds its rows' gradients in
    bfloat16; CUDA's embedding backward sums them in float32 and rounds
    once, PyTorch's CPU one adds them in bfloat16 one id at a time. The
    port's ``Embedding`` sums in float32 on both (``_CastEmbed``), bit
    for bit the float32 sum rounded once; the CPU's own backward is off
    it by 0.37 on a table whose largest gradient is 24.3 (128 ids on two
    rows)."""
    from oktopk_tpu_torch.models.layers import Embedding

    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 2, (4, 32), generator=g)
    dy = torch.randn(4, 32, 64, generator=g).to(BF16)
    want = torch.zeros(2, 64).index_add_(0, ids.reshape(-1),
                                         dy.float().reshape(-1, 64))
    emb = set_compute_dtype(Embedding(2, 64), BF16)
    emb(ids).backward(dy)
    assert emb.weight.grad.dtype == torch.float32
    assert torch.equal(emb.weight.grad, want.to(BF16).float())
    table = torch.zeros(2, 64, dtype=BF16, requires_grad=True)
    torch.nn.functional.embedding(ids, table).backward(dy)
    assert float((table.grad.float() - want).abs().max()) > 0.1


CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
import test_torch_bf16 as t
for case in sys.argv[2:]:
    d = t.measure(case)
    print(case, d["logits"][0], d["logits"][1], d["grad"][0], d["grad"][1])
print("gelu", *t.gelu_mismatches())
"""


def gelu_mismatches():
    """(the port's bfloat16 ``gelu``, ``F.gelu``): how many of 196,608
    bfloat16 values differ from ``jax.nn.gelu``'s."""
    from oktopk_tpu_torch.models.bert import gelu
    x = jnp.asarray(2.0 * np.random.RandomState(0).randn(64, 3072)
                    .astype(np.float32), jnp.bfloat16)
    want = np.asarray(jax.jit(lambda a: jax.nn.gelu(a, approximate=False))(
        x).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(BF16)
    return (int((gelu(xt).float().numpy() != want).sum()),
            int((torch.nn.functional.gelu(xt).float().numpy() != want)
                .sum()))


def test_op_for_op_without_excess_precision():
    """With XLA's excess precision off (a process of its own), XLA rounds
    every op to bfloat16 as flax's program says, and the port's rounding
    points are flax's: mnistnet's logits are bit-equal; bert_tiny's
    logits come within 0.73 d_ref (measured 8.15e-3 against 1.12e-2);
    the port's bfloat16 ``gelu`` is ``jax.nn.gelu`` bit for bit, where
    ``F.gelu`` differs in 74,480 of 196,608 values. The gradients stay a
    backward's summation order apart (mnistnet's 1.03e-2 of its largest
    element: one bfloat16 ulp on a few elements)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    out = subprocess.run(
        [sys.executable, "-c", CHILD, os.path.dirname(__file__),
         "mnistnet", "bert_tiny"], env=env, capture_output=True,
        text=True, timeout=300, check=True).stdout.split("\n")
    got = {ln.split()[0]: [float(v) for v in ln.split()[1:]]
           for ln in out if ln.strip()}
    assert got["mnistnet"][1] == 0.0
    assert got["mnistnet"][3] <= 0.2 * got["mnistnet"][2]
    assert got["bert_tiny"][1] <= got["bert_tiny"][0]
    assert got["gelu"][0] == 0 and got["gelu"][1] > 0.2 * 196608


# ---- the layers --------------------------------------------------------

def bf16_ulps(a, b):
    """|a - b| in bfloat16 ulps of b (both bfloat16 values)."""
    ia = torch.as_tensor(a).view(torch.int16).to(torch.int32)
    ib = torch.as_tensor(b).view(torch.int16).to(torch.int32)
    return (ia - ib).abs()


def test_batchnorm_reduces_in_float32():
    """flax ``nn.BatchNorm(dtype=bf16)`` on a bfloat16 map: statistics
    and normalisation in float32 on the promoted input, the result
    bfloat16, the running statistics float32. The port's output is the
    float32 computation cast once (bit-equal to BatchNorm on the float32
    input, then cast) and within one bfloat16 ulp of flax's; the running
    statistics within float32 rounding (the sums' order)."""
    rng = np.random.RandomState(0)
    x = (3.0 + 2.0 * rng.randn(4, 6, 6, 8)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    fm = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       dtype=jnp.bfloat16)
    v = fm.init(jax.random.PRNGKey(0), xb)
    params = {"scale": 1.0 + 0.1 * rng.randn(8).astype(np.float32),
              "bias": 0.1 * rng.randn(8).astype(np.float32)}
    y, new = fm.apply({**v, "params": params}, xb, mutable=["batch_stats"])
    assert y.dtype == jnp.bfloat16
    bn = BatchNorm(8)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
    ref = BatchNorm(8)
    ref.load_state_dict(bn.state_dict())
    set_compute_dtype(bn, BF16)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(BF16)
    xt = xt.permute(0, 3, 1, 2)
    got = bn(xt)
    assert got.dtype == BF16 and bn.mean.dtype == torch.float32
    assert torch.equal(got, ref(xt.float()).to(BF16))
    want = torch.from_numpy(np.asarray(y.astype(jnp.float32))).to(BF16)
    assert int(bf16_ulps(got.permute(0, 2, 3, 1), want).max()) <= 1
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(new["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-7)


def test_layernorm_reduces_in_float32():
    """flax ``nn.LayerNorm(epsilon=1e-12, dtype=bf16)``: as BatchNorm,
    the float32 computation cast once, within one bfloat16 ulp of
    flax's."""
    rng = np.random.RandomState(1)
    x = (0.5 + rng.randn(3, 7, 64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    fm = fnn.LayerNorm(epsilon=1e-12, dtype=jnp.bfloat16)
    params = {"scale": 1.0 + 0.1 * rng.randn(64).astype(np.float32),
              "bias": 0.1 * rng.randn(64).astype(np.float32)}
    y = fm.apply({"params": params}, xb)
    ln, ref = LayerNorm(64, 1e-12), LayerNorm(64, 1e-12)
    with torch.no_grad():
        for m in (ln, ref):
            m.scale.copy_(torch.from_numpy(params["scale"]))
            m.bias.copy_(torch.from_numpy(params["bias"]))
    set_compute_dtype(ln, BF16)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(BF16)
    got = ln(xt)
    assert got.dtype == BF16
    assert torch.equal(got, ref(xt.float()).to(BF16))
    want = torch.from_numpy(np.asarray(y.astype(jnp.float32))).to(BF16)
    assert int(bf16_ulps(got, want).max()) <= 1


def test_dropout_in_bfloat16_is_flaxs():
    """flax's ``nn.Dropout`` on a bfloat16 input divides by the keep
    probability rounded to bfloat16 (0.9 -> 0.8984375), and the
    attention's multiplier is ``keep.astype(bf16) / keep_prob`` in
    bfloat16: the port's ``dropout`` and ``attention_dropout`` under the
    same key are flax's bit for bit (the masks are JAX's whatever the
    dtype)."""
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(4, 16, 32).astype(np.float32), jnp.bfloat16)
    key = jax.random.PRNGKey(7)
    want = fnn.Dropout(0.1, deterministic=False).apply(
        {}, x, rngs={"dropout": key})
    keys = SiteKeys(np.asarray(key), site_hashes([(1,)]))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(BF16)
    got = dropout(xt, 0.1, True, keys)
    assert got.dtype == BF16
    assert torch.equal(got.float(), torch.from_numpy(
        np.asarray(want.astype(jnp.float32))))
    # the attention weights' broadcast mask and multiplier
    w = jnp.asarray(rng.rand(2, 2, 8, 8).astype(np.float32), jnp.bfloat16)
    keep = jax.random.bernoulli(key, 0.9, (1, 1, 8, 8))
    want = w * (keep.astype(jnp.bfloat16) / jnp.asarray(0.9, jnp.bfloat16))
    wt = torch.from_numpy(np.asarray(w.astype(jnp.float32))).to(BF16)
    keys = SiteKeys(np.asarray(key), site_hashes([(1,)]))
    keys.keys = np.asarray(key)[None]        # the site's key is this key
    got = attention_dropout(wt, 0.1, True, keys)
    assert torch.equal(got.float(), torch.from_numpy(
        np.asarray(want.astype(jnp.float32))))


def test_attention_softmax_is_flaxs():
    """flax's bfloat16 attention takes ``jax.nn.softmax`` of bfloat16
    logits (``exp(x - max) / sum``, each op rounded to bfloat16); the
    float32 softmax cast once is the other choice. Measured on one 4 x 2
    x 64 x 64 product, flax's weights against each: ``FlaxSoftmax``
    differs in 1,207 of 32,768 weights (largest 9.8e-4), the float32
    softmax in 16,648 (largest 3.9e-3). The port takes ``FlaxSoftmax``."""
    rng = np.random.RandomState(0)
    B, T, H, D = 4, 64, 2, 32
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, T, H, D).astype(np.float32)
    mask = np.ones((B, 1, T, T), bool)
    mask[1, :, :, 40:] = False
    want = np.asarray(fnn.dot_product_attention_weights(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        mask=mask, dtype=jnp.bfloat16).astype(jnp.float32))
    tq = torch.from_numpy(q).to(BF16).transpose(1, 2)
    tk = torch.from_numpy(k).to(BF16).transpose(1, 2)
    lg = torch.matmul(tq / torch.full((), np.sqrt(D), dtype=BF16),
                      tk.transpose(-1, -2))
    lg = torch.where(torch.from_numpy(mask), lg,
                     torch.full((), torch.finfo(BF16).min, dtype=BF16))
    flax_like = FlaxSoftmax.apply(lg).float().numpy()
    f32 = torch.softmax(lg.float(), -1).to(BF16).float().numpy()
    n_flax, n_f32 = (flax_like != want).sum(), (f32 != want).sum()
    assert n_flax <= 0.05 * want.size and n_flax < n_f32 / 5, (n_flax,
                                                                n_f32)


# ---- every family computes in bfloat16 --------------------------------

# name: (registry name, fields, input maker)
HOOKED = {
    "vgg16": ("vgg16", {}),
    "resnet20": ("resnet20", {}),
    "resnet50_1111": ("resnet50", {"stage_sizes": (1, 1, 1, 1)}),
    "preresnet20": ("preresnet110", {"depth": 20}),
    "densenet22": ("densenet100", {"depth": 22}),
    "resnext11_c2": ("resnext29", {"depth": 11, "cardinality": 2}),
    "alexnet": ("alexnet", {}),
    "caffe_cifar": ("caffe_cifar", {}),
    "mnistnet": ("mnistnet", {}),
    "bert_tiny": ("bert_tiny", {}),
    "lstman4_tiny": ("lstman4_tiny", {}),
    "lstm_tiny": ("lstm_tiny", {}),
}


def hooked_inputs(dnn):
    rng = np.random.RandomState(3)
    if dnn.startswith("bert"):
        return [torch.from_numpy(a) for a in family_inputs("bert", dnn, 2,
                                                           rng)]
    if dnn == "lstman4_tiny":
        return [torch.from_numpy(family_inputs("spect", dnn, 2, rng)[0])]
    if dnn == "lstm_tiny":
        return [torch.from_numpy(family_inputs("tokens", dnn, 2, rng)[0])]
    h, w, c = IMAGE_SHAPES[dnn]
    side = 64 if dnn == "resnet50" else h
    return [torch.randn(2, side, side, c, generator=torch.Generator()
                        .manual_seed(3))]


@pytest.mark.parametrize("name", list(HOOKED))
def test_hidden_activations_are_bfloat16(name):
    """No quiet float32: under ``dtype=torch.bfloat16`` every layer with
    flax's ``dtype`` (Conv, Dense, Embed, the norms, the LSTM) returns
    bfloat16, the logits are float32, and the parameters and their
    gradients float32."""
    dnn, kw = HOOKED[name]
    m = create_model(dnn, dtype=BF16, **kw)
    seen = []
    for mod in m.modules():
        if hasattr(type(mod), "compute_dtype") and mod is not m:
            mod.register_forward_hook(
                lambda mod, i, o: seen.append((type(mod).__name__, o.dtype
                                               if torch.is_tensor(o)
                                               else None)))
    kwargs = {"rng": np.asarray(jax.random.PRNGKey(0))} if \
        dnn.startswith("bert") or dnn == "lstm_tiny" else {}
    out = m(*hooked_inputs(dnn), train=True, **kwargs)
    out = out if isinstance(out, tuple) else (out,)
    assert all(o.dtype == torch.float32 for o in out)
    sum(o.float().sum() for o in out).backward()
    kinds = {k for k, _ in seen}
    assert len(seen) >= 2 and {d for _, d in seen} <= {BF16, None}, seen
    assert kinds & {"Conv2d", "Linear", "Embedding"}, kinds
    for _, p, _ in m.jax_leaves():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


def test_lstm_cells_run_in_bfloat16(monkeypatch):
    """The LSTM layers themselves (not hooked above: functions, not
    modules): DeepSpeech's ``torch.lstm`` and the PTB model's written-out
    cell both return bfloat16."""
    import oktopk_tpu_torch.models.deepspeech as ds
    import oktopk_tpu_torch.models.lstm as lm
    seen = []

    def spy(mod, name):
        orig = getattr(mod, name)

        def f(*args, **kw):
            y = orig(*args, **kw)
            seen.append((name, y.dtype))
            return y
        monkeypatch.setattr(mod, name, f)

    spy(ds, "lstm")
    spy(lm, "lstm_written_out")
    for dnn in ("lstman4_tiny", "lstm_tiny"):
        m = create_model(dnn, dtype=BF16)
        m(*hooked_inputs(dnn), train=False)
    assert {n for n, _ in seen} == {"lstm", "lstm_written_out"}
    assert {d for _, d in seen} == {BF16}


# ---- master weights: convert and checkpoints ---------------------------

@pytest.mark.parametrize("dnn", ["resnet20", "bert_tiny", "lstm_tiny"])
def test_convert_round_trip_under_bfloat16(dnn):
    """The flax float32 tree into a bfloat16 model and back, bit for
    bit: the model's parameters are the float32 master weights."""
    kind = {"bert_tiny": "bert", "lstm_tiny": "tokens"}.get(dnn, "image")
    xs = family_inputs(kind, dnn, 2, np.random.RandomState(0))
    fm, _ = jax_create(dnn)
    v = jax.eval_shape(lambda: fm.init(
        {"params": jax.random.PRNGKey(0)}, *xs, train=False))
    params = perturb(v["params"], 5)
    stats = perturb(v.get("batch_stats", {}), 6)
    m = create_model(dnn, dtype=BF16)
    m.load_state_dict(from_jax_params(params, stats or None, model=m))
    assert {t.dtype for t in m.state_dict().values()} == {torch.float32}
    p2, s2 = to_jax_params(m.state_dict(), model=m)
    for want, got in ((params, p2), (stats, s2)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(b, np.asarray(a))


def test_checkpoint_is_the_float32_one(tmp_path):
    """A bfloat16 Trainer's train state has the float32 Trainer's tree,
    shapes and dtypes; its checkpoint restores into the float32 Trainer
    bit for bit, and back."""
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.train import checkpoint as ckpt
    from oktopk_tpu_torch.train.trainer import Trainer

    def trainer(dt):
        return Trainer(TrainConfig(dnn="mnistnet", num_workers=2,
                                   batch_size=2, compute_dtype=dt),
                       algo_cfg=OkTopkConfig(warmup_steps=1),
                       device="cpu")

    tb, tf = trainer("bfloat16"), trainer("float32")
    tb.train_step(synthetic_batch("mnistnet", 4, np.random.RandomState(0)))
    sb = tb.train_state(host=True)
    sf = tf.train_state(host=True)
    lb, lf = jax.tree.leaves(sb), jax.tree.leaves(sf)
    assert jax.tree.structure(sb) == jax.tree.structure(sf)
    assert [(np.asarray(a).dtype, np.shape(a)) for a in lb] == \
        [(np.asarray(a).dtype, np.shape(a)) for a in lf]
    ckpt.save_checkpoint(str(tmp_path), tb.train_state(), 1)
    tree, step = ckpt.restore_checkpoint(str(tmp_path),
                                         tf.train_state(gather=False))
    tf.load_train_state(tree)
    assert step == 1
    for a, b in zip(jax.tree.leaves(tf.train_state(host=True)), lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
