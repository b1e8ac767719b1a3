"""The port's VGG and the whole slice against the flax VGG and the JAX
Trainer, on the same weights (``convert.from_jax_params``) and the same
numpy batches.

A narrow config (``vgg_narrow``: 8 and 16 channels, final map 4x4x16, so
the head's NHWC flatten order matters) is added to both packages' CFG
and model registries with ``monkeypatch.setitem``; nothing in either
package is edited.

Tolerances, and why: XLA's CPU convolutions and PyTorch's (oneDNN) add in
different orders, so logits and gradients agree to float32 rounding
(rtol 1e-4 / atol 1e-5 on logits, atol 2e-5 relative to the largest
gradient). Over three Trainer steps the sparse selection sees those
gradients; an element whose |acc| lies within rounding of a threshold can
be selected on one side only, moving one parameter by about lr*|g|/P.
Losses are held to rtol 1e-5 and parameters to atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oktopk_tpu.models.registry as jax_registry
import oktopk_tpu.models.vgg as jax_vgg
import oktopk_tpu_torch.models.registry as torch_registry
import oktopk_tpu_torch.models.vgg as torch_vgg
from oktopk_tpu_torch.convert import from_jax_params, to_jax_params

NARROW = [8, "M", 16, "M", 16, "M"]


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setitem(jax_vgg.CFG, "vgg_narrow", NARROW)
    monkeypatch.setitem(torch_vgg.CFG, "vgg_narrow", NARROW)
    monkeypatch.setitem(
        jax_registry.MODELS, "vgg_narrow",
        lambda **kw: (jax_vgg.VGG(name_cfg="vgg_narrow", **kw),
                      lambda bs: jnp.zeros((bs, 32, 32, 3), jnp.float32)))
    monkeypatch.setitem(
        torch_registry.MODELS, "vgg_narrow",
        lambda **kw: torch_vgg.VGG(name_cfg="vgg_narrow", **kw))
    return "vgg_narrow"


def flax_init(seed=0):
    model = jax_vgg.VGG(name_cfg="vgg_narrow")
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3)),
                   train=False)
    return model, jax.device_get(v["params"]), jax.device_get(
        v["batch_stats"])


def batch(bs, seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(bs, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, size=(bs,)).astype(np.int32)}


def test_convert_round_trip(narrow):
    _, params, stats = flax_init()
    sd = from_jax_params(params, stats)
    model = torch_vgg.VGG(name_cfg="vgg_narrow")
    model.load_state_dict(sd)
    p2, s2 = to_jax_params(model.state_dict())
    for tree_a, tree_b in ((params, p2), (stats, s2)):
        for mod in tree_a:
            for leaf in tree_a[mod]:
                np.testing.assert_array_equal(np.asarray(tree_a[mod][leaf]),
                                              tree_b[mod][leaf])


@pytest.mark.parametrize("num_buckets", [1, 2, 3, 7, 40])
def test_bucket_partition_matches_jax(num_buckets):
    from oktopk_tpu.optim.distributed import bucket_partition as jbp
    from oktopk_tpu.optim.distributed import bucket_sizes as jbs
    from oktopk_tpu_torch.optim.distributed import (bucket_partition,
                                                    bucket_sizes)
    model = torch_vgg.VGG(name_cfg="vgg16")
    leaves = [torch_vgg.to_jax_layout(p, lay) for _, p, lay in
              model.jax_leaves()]
    tree = {str(i).zfill(3): np.zeros(tuple(t.shape), np.float32)
            for i, t in enumerate(leaves)}
    b = bucket_partition(leaves, num_buckets)
    assert b == jbp(tree, num_buckets)
    assert bucket_sizes(leaves, b) == jbs(tree, b)


def test_jax_leaf_order_matches_tree_flatten(narrow):
    _, params, _ = flax_init()
    paths = ["/".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    model = torch_vgg.VGG(name_cfg="vgg_narrow")
    got = [name for name, _, _ in model.jax_leaves()]
    assert got == paths
    shapes = [tuple(torch_vgg.to_jax_layout(p, lay).shape)
              for _, p, lay in model.jax_leaves()]
    assert shapes == [np.asarray(x).shape for x in jax.tree.leaves(params)]
    full = torch_vgg.VGG(name_cfg="vgg16")
    assert sum(p.numel() for _, p, _ in full.jax_leaves()) == 14728266


@pytest.mark.parametrize("train", [True, False])
def test_forward_logits_and_batch_stats(narrow, train):
    model, params, stats = flax_init()
    b = batch(6, seed=1)
    tm = torch_vgg.VGG(name_cfg="vgg_narrow")
    tm.load_state_dict(from_jax_params(params, stats))
    if train:
        logits, mut = model.apply({"params": params, "batch_stats": stats},
                                  b["image"], train=True,
                                  mutable=["batch_stats"])
    else:
        logits = model.apply({"params": params, "batch_stats": stats},
                             b["image"], train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(b["image"]), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=1e-4,
                               atol=1e-5)
    if train:
        _, s2 = to_jax_params(tm.state_dict())
        for mod, leaves in jax.device_get(mut["batch_stats"]).items():
            for leaf, v in leaves.items():
                np.testing.assert_allclose(s2[mod][leaf], np.asarray(v),
                                           rtol=1e-5, atol=1e-6)


def test_flat_gradient_in_jax_order(narrow):
    """The flat gradient the trainer builds (JAX leaf order and layout)
    against ``jax.grad`` flattened by ``jax.tree.leaves``."""
    from oktopk_tpu.train.losses import softmax_cross_entropy as jax_ce
    from oktopk_tpu_torch.train.losses import softmax_cross_entropy

    model, params, stats = flax_init()
    b = batch(8, seed=2)

    def loss_fn(p):
        logits, _ = model.apply({"params": p, "batch_stats": stats},
                                b["image"], train=True,
                                mutable=["batch_stats"])
        return jax_ce(logits, b["label"])

    want = np.concatenate([np.asarray(g).reshape(-1) for g in
                           jax.tree.leaves(jax.grad(loss_fn)(params))])
    tm = torch_vgg.VGG(name_cfg="vgg_narrow")
    tm.load_state_dict(from_jax_params(params, stats))
    loss = softmax_cross_entropy(tm(torch.from_numpy(b["image"])),
                                 torch.from_numpy(b["label"]))
    loss.backward()
    got = torch.cat([torch_vgg.to_jax_layout(p.grad, lay).reshape(-1)
                     for _, p, lay in tm.jax_leaves()]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("num_buckets", [1, 3])
def test_trainer_three_steps_match_jax(narrow, mesh4, num_buckets):
    """The whole slice: P=4 workers, global batch 16, one dense warmup
    step then two oktopk steps (an exact and a predicted global step),
    flat and in reverse-layer-order buckets, against the JAX Trainer on
    the 4-device mesh."""
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer

    algo = dict(warmup_steps=1, local_recompute_every=1,
                global_recompute_every=2)
    common = dict(dnn="vgg_narrow", batch_size=4, lr=0.05, density=0.05,
                  num_workers=4, num_buckets=num_buckets)
    jt = JTrainer(JTrain(**common), mesh=mesh4, algo_cfg=JCfg(**algo),
                  profile_norm=False)
    tt = Trainer(TrainConfig(**common), algo_cfg=OkTopkConfig(**algo),
                 device="cpu")
    p0 = jax.device_get(jt.state.params)
    tt.load_jax_variables(p0, jax.device_get(jt.state.model_state[
        "batch_stats"]))
    assert tt.algo_cfg.n == jt.algo_cfg.n
    for s in range(3):
        b = batch(16, seed=10 + s)
        jm = jt.train_step(b)
        tm = tt.train_step(b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for key in ("comm_volume", "local_k", "global_k"):
            assert abs(float(tm[key]) - float(jm[key])) <= 0.01 * abs(
                float(jm[key])) + 2, (s, key)
    params, stats = to_jax_params(tt.model.state_dict())
    want_p = jax.device_get(jt.state.params)
    for mod in want_p:
        for leaf in want_p[mod]:
            np.testing.assert_allclose(params[mod][leaf],
                                       np.asarray(want_p[mod][leaf]),
                                       rtol=0, atol=1e-4,
                                       err_msg=f"{mod}/{leaf}")
    want_s = jax.device_get(jt.state.model_state["batch_stats"])
    for mod in want_s:
        for leaf in want_s[mod]:
            np.testing.assert_allclose(stats[mod][leaf],
                                       np.asarray(want_s[mod][leaf]),
                                       rtol=1e-4, atol=1e-5)


def test_entry_points_default_to_cuda(narrow, monkeypatch):
    """Without a GPU the Trainer and the CLI raise unless the CPU is
    asked for."""
    from oktopk_tpu_torch.config import TrainConfig
    from oktopk_tpu_torch.train import main_trainer
    from oktopk_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(dnn="vgg_narrow", num_workers=2, batch_size=2)
    with pytest.raises(RuntimeError):
        Trainer(cfg)
    with pytest.raises(RuntimeError):
        main_trainer.main(["--dnn", "vgg_narrow", "--max-iters", "1"])
    assert Trainer(cfg, device="cpu").device.type == "cpu"


def test_main_trainer_cli_on_cpu(narrow):
    from oktopk_tpu_torch.train import main_trainer
    assert main_trainer.main([
        "--dnn", "vgg_narrow", "--device", "cpu", "--num-workers", "2",
        "--batch-size", "2", "--max-iters", "3", "--warmup-steps", "1",
        "--log-every", "1", "--density", "0.05"]) == 0
