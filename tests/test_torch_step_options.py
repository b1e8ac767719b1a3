"""The step options of the port's Trainer (``nsteps_update``,
``grad_clip``, momentum correction, ``profile_norm``, a per-bucket
compressor plan with per-bucket densities) against the JAX Trainer on the
4-device mesh, at the narrow VGG of ``test_torch_vgg.py``, and every
ported compressor through the port's Trainer and CLI.

Tolerances, and why:
- losses rtol 1e-5 and parameters atol 1e-4, BatchNorm statistics rtol
  1e-4 / atol 1e-5, volume and counts within 1% + 2: as in
  ``test_torch_vgg.py`` (XLA's and oneDNN's convolutions add in different
  orders, so gradients agree to float32 rounding, and an element within
  rounding of a threshold can be selected on one side only);
- a binding ``grad_clip`` scales by min(1, clip / ||g||), a norm whose sum
  order differs (one float32 sum of the flat row against XLA's per-leaf
  sums): a relative difference of a few ulps in the scale, inside the
  tolerances above;
- momentum correction: XLA's CPU backend contracts ``m * mom + flat`` into
  a fused multiply-add, PyTorch does not (``scripts/port_parity_probe.py``
  counts the results that differ), so the corrected gradient differs in
  its last bit, again inside the tolerances above;
- ``eps_vs_dense`` is a ratio of two norms, rtol 1e-4;
- a ``grad_clip`` that does not bind scales by exactly 1.0: bit-equal to
  the run without a clip.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from oktopk_tpu_torch.collectives.registry import list_algorithms
from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.convert import to_jax_params
from oktopk_tpu_torch.optim.distributed import SparseGradStep
from oktopk_tpu_torch.train import main_trainer
from oktopk_tpu_torch.train.trainer import Trainer

from test_torch_vgg import batch, narrow  # noqa: F401  (fixture)

ALGO = dict(warmup_steps=1, local_recompute_every=1,
            global_recompute_every=2)
COMMON = dict(dnn="vgg_narrow", batch_size=4, lr=0.05, density=0.05,
              num_workers=4)
CASES = {
    # two microbatches per worker, a clip that binds, the EPS metric
    "microbatches+clip+eps": dict(
        train=dict(nsteps_update=2, grad_clip=5.0), plan=None,
        profile_norm=True),
    # momentum folded in before compression, a two-bucket plan of two
    # compressors with their own densities, a clip that does not bind
    "momentum+plan": dict(
        train=dict(momentum_correction=True, grad_clip=1e6, num_buckets=2),
        plan=(["topkA", "gaussiank"], [0.05, 0.1]), profile_norm=True),
}


def make_pair(mesh, case):
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    kw = dict(COMMON, **case["train"])
    jt = JTrainer(JTrain(**kw), mesh=mesh, algo_cfg=JCfg(**ALGO),
                  profile_norm=case["profile_norm"])
    tt = Trainer(TrainConfig(**kw), algo_cfg=OkTopkConfig(**ALGO),
                 device="cpu", profile_norm=case["profile_norm"])
    if case["plan"] is not None:
        names, dens = case["plan"]
        jt._plans = [SimpleNamespace(algo=a, density=d)
                     for a, d in zip(names, dens)]
        jt.step_fn = jt._build_step()
        tt.grad_step = SparseGradStep(
            tt.algo_cfg, tt.comm, tt.params, names, kw["num_buckets"],
            device="cpu", bucket_densities=dens,
            momentum_correction=tt.grad_step.momentum_correction,
            profile_norm=case["profile_norm"])
    tt.load_jax_variables(jax.device_get(jt.state.params), jax.device_get(
        jt.state.model_state["batch_stats"]))
    return jt, tt


@pytest.mark.parametrize("name", list(CASES))
def test_step_options_match_jax(narrow, mesh4, name):  # noqa: F811
    case = CASES[name]
    jt, tt = make_pair(mesh4, case)
    ns = case["train"].get("nsteps_update", 1)
    for s in range(3):
        b = batch(4 * 4 * ns, seed=20 + s)
        jm = jt.train_step(b)
        tm = tt.train_step(b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {s}")
        for key in ("comm_volume", "local_k", "global_k"):
            assert abs(float(tm[key]) - float(jm[key])) <= 0.01 * abs(
                float(jm[key])) + 2, (s, key)
        np.testing.assert_allclose(float(tm["eps_vs_dense"]),
                                   float(jm["eps_vs_dense"]), rtol=1e-4,
                                   err_msg=f"eps_vs_dense, step {s}")
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
    if case["train"].get("momentum_correction"):
        assert tt.optimizer.momentum == 0.0
        assert tt.grad_step.momenta is not None


def run_port(cfg_kw, steps=3, **algo):
    tt = Trainer(TrainConfig(**dict(COMMON, **cfg_kw)),
                 algo_cfg=OkTopkConfig(**dict(ALGO, **algo)), device="cpu")
    ns = tt.cfg.nsteps_update
    ms = [tt.train_step(batch(4 * 4 * ns, seed=30 + s))
          for s in range(steps)]
    return tt, ms


def test_loose_clip_is_bit_equal(narrow):  # noqa: F811
    """A clip far above the gradient norm scales by exactly 1.0."""
    a, ma = run_port({})
    b, mb = run_port({"grad_clip": 1e6})
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)
    assert [float(m["loss"]) for m in ma] == [float(m["loss"]) for m in mb]


# ``hierarchical`` needs a HierarchicalConfig and a two-level comm, which
# the Trainer's flat step has not (nor has the JAX Trainer's): it runs
# through ``collectives.api`` (tests/test_torch_hierarchical.py)
FLAT_NAMES = [n for n in list_algorithms() if n != "hierarchical"]


@pytest.mark.parametrize("compressor", FLAT_NAMES)
def test_trainer_runs_every_compressor(narrow, compressor):  # noqa: F811
    """Every flat registry name through the port's Trainer: a dense warmup
    step, then sparse steps with finite losses and parameters."""
    tt, ms = run_port({"compressor": compressor}, steps=3)
    assert all(np.isfinite(float(m["loss"])) for m in ms)
    assert all(bool(torch.isfinite(p).all()) for p in tt.params)
    assert float(ms[-1]["comm_volume"]) > 0


def test_main_trainer_flags(narrow, capsys):  # noqa: F811
    """Every flat name is a ``--compressor``; ``hierarchical`` is refused
    with the reason (see ``FLAT_NAMES``), by the CLI and by the Trainer's
    step."""
    for name in FLAT_NAMES:
        assert main_trainer.parse_args(["--compressor", name]).compressor \
            == name
    with pytest.raises(SystemExit):
        main_trainer.parse_args(["--compressor", "hierarchical"])
    assert "two-level comm" in capsys.readouterr().err
    with pytest.raises(ValueError, match="HierarchicalConfig"):
        run_port({"compressor": "hierarchical"}, steps=1)
    a = main_trainer.parse_args(["--nsteps-update", "2", "--grad-clip",
                                 "0.5"])
    assert (a.nsteps_update, a.grad_clip) == (2, 0.5)
    assert main_trainer.main([
        "--dnn", "vgg_narrow", "--device", "cpu", "--num-workers", "2",
        "--batch-size", "2", "--max-iters", "2", "--warmup-steps", "1",
        "--log-every", "1", "--density", "0.05", "--compressor", "gtopk",
        "--nsteps-update", "2", "--grad-clip", "5.0"]) == 0


def test_experiment_slug_names_nsteps():
    from oktopk_tpu.config import TrainConfig as JTrain
    kw = dict(compressor="topkSA", nsteps_update=3, num_workers=4)
    assert TrainConfig(**kw).experiment_slug() == \
        JTrain(**kw).experiment_slug()


def test_grad_step_device_defaults_to_cuda(narrow, monkeypatch):  # noqa: F811
    """``SparseGradStep`` follows the entry points: CUDA unless the CPU is
    asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt, _ = run_port({}, steps=0)
    with pytest.raises(RuntimeError):
        SparseGradStep(tt.algo_cfg, tt.comm, tt.params)
    with pytest.raises(ValueError, match="plan"):
        SparseGradStep(tt.algo_cfg, tt.comm, tt.params, ["topkA"] * 3,
                       num_buckets=2, device="cpu")
