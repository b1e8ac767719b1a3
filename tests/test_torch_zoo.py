"""The CNN zoo in the port (the CIFAR ResNets, ResNet-50, PreResNet,
ResNeXt, DenseNet, AlexNet, CaffeCifar, MnistNet) against the flax models
of the JAX package, on the same weights (``convert.from_jax_params``)
and the same numpy batches, and the resnet20 Trainer against the JAX
Trainer.

- Full depth, shapes only (``jax.eval_shape``, the port's model on the
  meta device): every registry name's ``jax_leaves()`` paths and shapes
  equal ``jax.tree.flatten``'s, and its BatchNorm statistics the flax
  ``batch_stats``. Flax names a module by its creation order per type in
  its scope, and sorts the names as strings (``BasicBlock_10`` before
  ``BasicBlock_2``): these hold the port's names to that.
- The convert round trip, bit for bit.
- Narrow configs, as the JAX package's own tests cut them (densenet
  depth 22, preresnet depth 20, resnext depth 11 with cardinality 2,
  resnet50 with one block a stage at 64 x 64; resnet20, AlexNet,
  CaffeCifar and MnistNet whole), in train mode: logits, the flat
  gradient of a weighted sum of the logits in JAX leaf order, and the
  new BatchNorm statistics, the port in float64 against the flax model
  in float64 (its ``dtype`` field, 64-bit types on for the call), from
  the same float32 weights and inputs. In float32 both models take
  BatchNorm's variance as E[x^2] - E[x]^2, which cancels where a channel
  has few samples or a large mean: at resnet50's 2 x 2 last stage with
  batch 2 the port's float32 gradient is up to 2.4 off the float64 one
  at a few elements, and XLA's float32 gradient of resnet20 at batch 4
  is 0.073 off its own float64 (1.1e-5 with flax's two-pass variance;
  the port's float32, with PyTorch's pairwise sums, 1.6e-5): a float32
  comparison would measure that conditioning, not the port (ROADMAP.md,
  H19). In float64 the two differ only by summation order, amplified by
  the same cancellation: logits rtol 1e-9 / atol 1e-9 of the largest,
  the flat gradient atol 1e-8 of its largest element, statistics rtol
  1e-9 / atol 1e-12. The float32 models are held to each other by the
  Trainer test below and, card against CPU, by ``chip_smoke.py``.
- Three resnet20 Trainer steps (one dense warmup, then oktopk), P = 4,
  against the JAX Trainer on the 4-device mesh, which computes in float32
  (the JAX package does not run under 64-bit types). The step-0 losses
  agree to 2e-7 and the counts within the VGG test's 1% + 2 (0.4%
  measured), but the dense step moves each parameter by its float32
  gradient, and XLA's is off by the cancellation above: parameters 1.2e-4
  apart after it, and the later steps' selections and losses follow
  (losses 9.3e-5 and 4.2e-4 relative on steps 1 and 2, parameters 5.0e-3
  and statistics 2.2e-3 apart after three steps). Held: losses rtol
  1e-3, counts 1% + 2, parameters atol 1e-2, statistics atol 5e-3 / rtol
  1e-4, step 0's loss rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from oktopk_tpu.models.registry import create_model as jax_create

from oktopk_tpu_torch.convert import from_jax_params, to_jax_params
from oktopk_tpu_torch.models import create_model
from oktopk_tpu_torch.models.layout import to_jax_layout
from oktopk_tpu_torch.models.registry import IMAGE_SHAPES

ZOO = ["resnet20", "resnet56", "resnet110", "resnet50", "alexnet",
       "densenet100", "preresnet110", "resnext29", "caffe_cifar",
       "mnistnet"]
# id: (registry name, fields, image side)
NARROW = {
    "resnet20": ("resnet20", {}, 32),
    "resnet50_1111": ("resnet50", {"stage_sizes": (1, 1, 1, 1)}, 64),
    "preresnet20": ("preresnet110", {"depth": 20}, 32),
    "densenet22": ("densenet100", {"depth": 22}, 32),
    "resnext11_c2": ("resnext29", {"depth": 11, "cardinality": 2}, 32),
    "alexnet": ("alexnet", {}, 32),
    "caffe_cifar": ("caffe_cifar", {}, 32),
    "mnistnet": ("mnistnet", {}, 28),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU convolutions' weight gradients add in an order that depends
    on the thread count; one thread, the old count restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def paths(tree):
    return [(jax.tree_util.keystr(p, simple=True, separator="/"),
             tuple(a.shape))
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("dnn", ZOO)
def test_full_depth_leaves_match_flax(dnn):
    jm, ex = jax_create(dnn)
    assert ex(1).shape[1:] == IMAGE_SHAPES[dnn]
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ex(2),
                                       train=False))
    with torch.device("meta"):
        m = create_model(dnn)
    got = [(path, tuple(to_jax_layout(p, lay).shape))
           for path, p, lay in m.jax_leaves()]
    assert got == paths(v["params"])
    stats = sorted((k.replace(".", "/"), tuple(b.shape))
                   for k, b in m.named_buffers())
    assert stats == sorted(paths(v.get("batch_stats", {})))
    if dnn == "resnet50":
        assert sum(int(np.prod(s)) for _, s in got) == 25557032
        assert (len(got), len(stats)) == (161, 106)


def flax_vars(dnn, kw, side, seed=0):
    """(flax module, params, batch_stats) of flax's shapes
    (``jax.eval_shape``, nothing compiled), drawn from a seed:
    lecun-normal kernels, biases and BatchNorm parameters and statistics
    moved off their initial values, so that every leaf and train mode's
    statistics update are seen."""
    jm, _ = jax_create(dnn, **kw)
    x = np.zeros((2, side, side, IMAGE_SHAPES[dnn][2]), np.float32)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                       train=False))
    rng = np.random.RandomState(seed)

    def draw(path, a):
        leaf = path[-1].key
        z = rng.randn(*a.shape)
        if leaf == "kernel":
            z /= np.sqrt(np.prod(a.shape[:-1]))
        elif leaf in ("scale", "var"):
            z = 1.0 + np.abs(0.2 * z) if leaf == "var" else 1.0 + 0.1 * z
        else:
            z *= 0.1
        return z.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, v["params"])
    stats = jax.tree_util.tree_map_with_path(draw,
                                             v.get("batch_stats", {}))
    return jm, params, stats


def port(dnn, kw, params, stats):
    m = create_model(dnn, **kw)
    m.load_state_dict(from_jax_params(params, stats or None, model=m))
    return m


@pytest.mark.parametrize("case", ["resnet20", "preresnet20", "densenet22",
                                  "alexnet", "caffe_cifar"])
def test_convert_round_trip(case):
    dnn, kw, side = NARROW[case]
    _, params, stats = flax_vars(dnn, kw, side, seed=3)
    m = port(dnn, kw, params, stats)
    p2, s2 = to_jax_params(m.state_dict(), model=m)
    for want, got in ((params, p2), (stats, s2)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(b, np.asarray(a))


def test_vgg_shaped_trees_need_the_model():
    """AlexNet's flax roots (``Conv_*``, ``Dense_0``) are also VGG's: the
    model, not the tree, picks the mapping."""
    dnn, kw, side = NARROW["alexnet"]
    _, params, _ = flax_vars(dnn, kw, side)
    assert "convs.0.weight" in from_jax_params(params)
    m = port(dnn, kw, params, {})
    assert "Conv_0.weight" in from_jax_params(params, model=m)


@pytest.mark.parametrize("case", list(NARROW))
def test_train_forward_gradient_and_stats_match_flax(case):
    dnn, kw, side = NARROW[case]
    _, params, stats = flax_vars(dnn, kw, side, seed=1)
    rng = np.random.RandomState(2)
    x = rng.randn(2, side, side, IMAGE_SHAPES[dnn][2]).astype(np.float32)
    classes = 1000 if dnn == "resnet50" else 10
    w = rng.randn(2, classes).astype(np.float32)
    mutable = ["batch_stats"] if stats else []

    m = port(dnn, kw, params, stats).double()
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    with jax.enable_x64(True):
        fm64, _ = jax_create(dnn, dtype=jnp.float64, **kw)

        def fwd(p):
            out, new = fm64.apply({"params": p, "batch_stats": f64(stats)},
                                  f64(x), train=True, mutable=mutable)
            return jnp.sum(out * f64(w)), (out, new)

        (_, (logits, new)), gp = jax.jit(jax.value_and_grad(
            fwd, has_aux=True))(f64(params))
        logits, new, gp = jax.device_get((logits, new, gp))
    y = m(torch.from_numpy(x).double(), train=True)
    (y * torch.from_numpy(w).double()).sum().backward()
    logits = np.asarray(logits)
    np.testing.assert_allclose(y.detach().numpy(), logits, rtol=1e-9,
                               atol=1e-9 * np.abs(logits).max())
    want = np.concatenate([np.asarray(g).reshape(-1)
                           for g in jax.tree.leaves(gp)])
    got = torch.cat([to_jax_layout(p.grad, lay).reshape(-1)
                     for _, p, lay in m.jax_leaves()]).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())
    if stats:
        _, got_stats = to_jax_params(m.state_dict(), model=m)
        for (path, a), g in zip(
                jax.tree_util.tree_leaves_with_path(new["batch_stats"]),
                jax.tree.leaves(got_stats)):
            np.testing.assert_allclose(g, np.asarray(a), rtol=1e-9,
                                       atol=1e-12,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("side", [224, 56, 28, 14, 32, 16, 8])
def test_flax_same_padding_of_a_strided_1x1_is_none(side):
    """flax's 1x1 convolutions take 'SAME' padding; at stride 2 on the
    sizes where ResNet-50 and the CIFAR nets stride, that pads nothing,
    PyTorch's padding 0."""
    import flax.linen as fnn
    rng = np.random.RandomState(side)
    x = rng.randn(1, side, side, 3).astype(np.float32)
    conv = fnn.Conv(4, (1, 1), strides=2, use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(v, x))
    k = torch.from_numpy(np.asarray(v["params"]["kernel"])).permute(
        3, 2, 0, 1)
    got = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), k, stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_trainer_init_takes_bias_free_and_grouped_convs():
    """flax's default init through the Trainer: lecun-normal kernels
    (fan-in in/groups x kh x kw), zero biases where there are any."""
    from oktopk_tpu_torch.config import TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer

    tr = Trainer(TrainConfig(dnn="resnext29", num_workers=1),
                 device="cpu", model_kwargs={"depth": 11,
                                             "cardinality": 2})
    conv = tr.model.ResNeXtBlock_0.Conv_1
    assert conv.bias is None and conv.groups == 2
    std = float(conv.weight.std())
    assert abs(std / np.sqrt(1.0 / conv.weight[0].numel()) - 1) < 0.05
    assert float(tr.model.Dense_0.bias.abs().max()) == 0.0


def test_resnet20_trainer_three_steps_match_jax(mesh4):
    """P = 4 workers, global batch 16, one dense warmup step then two
    oktopk steps (an exact and a predicted global step)."""
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer

    algo = dict(warmup_steps=1, local_recompute_every=1,
                global_recompute_every=2)
    common = dict(dnn="resnet20", batch_size=4, lr=0.05, density=0.05,
                  num_workers=4)
    jt = JTrainer(JTrain(**common), mesh=mesh4, algo_cfg=JCfg(**algo),
                  profile_norm=False)
    tt = Trainer(TrainConfig(**common), algo_cfg=OkTopkConfig(**algo),
                 device="cpu")
    tt.load_jax_variables(jax.device_get(jt.state.params),
                          jax.device_get(jt.state.model_state[
                              "batch_stats"]))
    assert tt.algo_cfg.n == jt.algo_cfg.n == 272474
    for s in range(3):
        rng = np.random.RandomState(10 + s)
        b = {"image": rng.randn(16, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, 10, size=(16,)).astype(np.int32)}
        jm = jt.train_step(b)
        tm = tt.train_step(b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if s == 0 else 1e-3)
        for key in ("comm_volume", "local_k", "global_k"):
            assert abs(float(tm[key]) - float(jm[key])) <= 0.01 * abs(
                float(jm[key])) + 2, (s, key)
    params, stats = to_jax_params(tt.model.state_dict(), model=tt.model)
    for want, got, rtol, atol in (
            (jt.state.params, params, 0, 1e-2),
            (jt.state.model_state["batch_stats"], stats, 1e-4, 5e-3)):
        want = jax.device_get(want)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for (path, a), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(got)):
            np.testing.assert_allclose(g, np.asarray(a), rtol=rtol,
                                       atol=atol,
                                       err_msg=jax.tree_util.keystr(path))
