"""The port's autotuner (``oktopk_tpu_torch/autotune/``) against the JAX
package's (``oktopk_tpu/autotune/``), on the same inputs.

- the alpha-beta fit (``fit_alpha_beta``) and ``probe_fabric`` with an
  injected measure: coefficients bit-equal to JAX's (both sides are
  numpy's ``lstsq`` on the same design matrix);
- ``predict_ms``: every algorithm at P in {1, 4, 8}, and the hierarchical
  candidates on the ``dcn`` preset with ``num_pods``: equal;
- ``AutotunePolicy.decide`` and ``Autotuner.tune``: the same plans and
  the same journal entries (the header's environment keys aside) in
  JAX's cases: the crossover, a hysteresis hold, a re-tune switch, the
  prior pruning that still measures the incumbent, and plan mode;
- the autotuned mnistnet Trainer (2 buckets, P = 8, JAX's
  ``TestTrainerIntegration`` config, the fake-timing seam): JAX's plans;
  its first planned step against the JAX Trainer's with the tolerances
  ``tests/test_torch_step_options.py`` uses for a per-bucket plan (losses
  rtol 1e-5, parameters atol 1e-4, volumes within 1% + 2: XLA's and
  oneDNN's convolutions add in other orders); a re-tune on the same
  timings does not re-plan;
- a real trial pass on ``StackedComm`` on the CPU: coefficients
  ``measured``, trial medians positive, a finite planned step; every
  re-measure starts from the cached step's untouched initial state; a
  failing trial raises; without a GPU the device paths raise unless
  given ``device="cpu"``;
- the command line's ``--autotune*`` parse to JAX's ``TrainConfig``
  fields; ``OKTOPK_PROFILING_NORM`` sets the Trainer's ``profile_norm``;
  ``OKTOPK_PROFILING_GRAD`` writes JAX's dump keys, shapes and dtypes;
- ``utils/flops.py``: ``param_count`` equals JAX's for mnistnet, and one
  matmul's flops equal XLA's ``cost_analysis``;
- the benchmark CLI (``oktopk_tpu_torch.benchmarks.collectives``) with
  ``--device cpu``: its steps' volumes are the in-process step's.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oktopk_tpu import autotune as jtune
from oktopk_tpu.autotune import policy as jpolicy
from oktopk_tpu.config import OkTopkConfig as JCfg
from oktopk_tpu.utils.cost_model import allreduce_cost
from oktopk_tpu_torch import autotune as ttune
from oktopk_tpu_torch.autotune import calibrate, policy
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.train import main_trainer
from oktopk_tpu_torch.train.trainer import Trainer

SMALL, LARGE = 10_000, 4_000_000
ENV_KEYS = ("jax", "jaxlib", "torch", "cuda", "device_kind", "platform",
            "world_size")


def crossover_fake_ms(algo, n, density):
    """JAX's synthetic fabric (``tests/test_autotune.py:27-33``): dense
    wins small buckets, oktopk wins large ones."""
    if algo == "dense":
        return 0.5 + n * 1e-6
    return 2.0 + density * n * 2e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread_jitted_init():
    """Torch on one thread, and the JAX Trainer's model init under
    ``jax.jit`` (op by op it takes seconds; ``tests/test_torch_
    checkpoint.py`` does the same)."""
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    eager = JTrainer._init_variables
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_init_variables", lambda self, r, b: jax.jit(
            lambda rr, bb: eager(self, rr, bb))(r, b))
        yield
    torch.set_num_threads(old)


# ---- calibration ------------------------------------------------------------

FITS = {
    "planted_p8": ([1 << 14, 1 << 16, 1 << 18, 1 << 20], 8,
                   lambda n: allreduce_cost(n, 8, 5e-6, 2e-9)),
    "single_worker": ([1 << 12, 1 << 16, 1 << 20], 1,
                      lambda n: 3e-3 + 1e-9 * n),
    "noise_negative": ([1000, 2000, 4000], 8,
                       dict(zip([1000, 2000, 4000],
                                [5e-3, 3e-3, 1e-3])).get),
}


@pytest.mark.parametrize("name", list(FITS))
def test_fit_alpha_beta_is_jax(name):
    sizes, p, law = FITS[name]
    times = [law(n) for n in sizes]
    got = calibrate.fit_alpha_beta(sizes, times, p)
    want = jtune.fit_alpha_beta(sizes, times, p)
    assert got.as_dict() == want.as_dict()
    assert got.alpha > 0 and got.beta > 0
    with pytest.raises(ValueError):
        calibrate.fit_alpha_beta(sizes[:1], times[:1], p)


def test_probe_with_injected_measure_is_jax():
    alpha, beta, p = 1e-5, 5e-9, 8
    sizes = (1 << 14, 1 << 18, 1 << 20)

    def measure(n):
        return [allreduce_cost(n, p, alpha, beta) * f for f in (1.1, 1, .9)]

    got = calibrate.probe_fabric(measure=measure, num_workers=p, sizes=sizes)
    want = jtune.probe_fabric(measure=measure, num_workers=p, sizes=sizes)
    assert got.as_dict() == want.as_dict() and got.source == "injected"
    assert got.alpha == pytest.approx(alpha, rel=1e-5)
    assert calibrate.default_coefficients() == policy.FabricCoefficients(
        **jtune.calibrate.default_coefficients().as_dict())
    with pytest.raises(ValueError):
        calibrate.probe_fabric(measure=measure, sizes=sizes)
    with pytest.raises(ValueError):
        calibrate.probe_fabric()


def test_probe_real_comm_on_the_cpu(monkeypatch):
    c = calibrate.probe_fabric(StackedComm(4), sizes=(1 << 10, 1 << 14),
                               repeats=2, device="cpu")
    assert c.source == "measured" and c.nsamples == 2
    assert c.alpha > 0 and c.beta > 0 and np.isfinite(c.residual)
    # the device path runs on the card unless the CPU is asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate.probe_fabric(StackedComm(4), sizes=(1 << 10, 1 << 14))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttune.TrialRunner(comm=StackedComm(4))


# ---- the cost-model prior ---------------------------------------------------

ALGOS = ("dense", "oktopk", "topkA", "topkA2", "topkAopt", "gtopk",
         "gaussiank", "gaussiankconcat", "gaussiankSA", "topkSA", "topkDSA")


@pytest.mark.parametrize("p", [1, 4, 8])
def test_predict_ms_is_jax(p):
    coeffs = [policy.FabricCoefficients(1e-6, 1e-9),
              policy.FabricCoefficients(3e-5, 4e-10, source="measured")]
    for c in coeffs:
        jc = jtune.FabricCoefficients(**c.as_dict())
        for algo in ALGOS:
            for d in (0.001, 0.02, 0.3):
                for n in (SMALL, LARGE, 14728266):
                    got = policy.predict_ms(algo, d, n, p, c)
                    assert got == jpolicy.predict_ms(algo, d, n, p, jc), (
                        algo, d, n)
                    g = policy.predict_ms(algo, d, n, p, c,
                                          select_gamma=2e-10)
                    assert g == jpolicy.predict_ms(algo, d, n, p, jc,
                                                   select_gamma=2e-10)
    with pytest.raises(ValueError):
        policy.predict_ms("nosuch", 0.1, 100, p, coeffs[0])


@pytest.mark.parametrize("outer", ["oktopk", "topkA", "dense"])
@pytest.mark.parametrize("pods", [1, 2, 4])
def test_predict_ms_hierarchical_is_jax(outer, pods):
    c = policy.FabricCoefficients(1e-6, 1e-9)
    jc = jtune.FabricCoefficients(1e-6, 1e-9)
    for n in (SMALL, LARGE):
        for d in (0.01, 1.0):
            got = policy.predict_ms("hierarchical", d, n, 8, c,
                                    fabric="dcn", num_pods=pods,
                                    outer=outer)
            want = jpolicy.predict_ms("hierarchical", d, n, 8, jc,
                                      fabric="dcn", num_pods=pods,
                                      outer=outer)
            assert got == want
            flat = policy.predict_ms(outer, d, n, 8, c, fabric="dcn")
            assert flat == jpolicy.predict_ms(outer, d, n, 8, jc,
                                              fabric="dcn")
    with pytest.raises(ValueError, match="fabric"):
        policy.predict_ms("hierarchical", 0.01, SMALL, 8, c)


# ---- the policy and the tuner -----------------------------------------------

def journal_body(journal):
    """The journal's entries, the header's environment keys aside."""
    return [{k: v for k, v in e.items() if k not in ENV_KEYS}
            for e in journal.entries]


def tuner_pair(sizes, fake, cands=("dense", "oktopk"), densities=(0.02,),
               **policy_kw):
    """The same tuner in both packages: the injected coefficients, the
    fake fabric ``fake`` and JAX's ``_tuner`` policy defaults."""
    kw = dict(hysteresis=0.15, retune_every=100, **policy_kw)
    out = []
    for mod, runner in ((policy, ttune.TrialRunner(
            fake_ms=fake, base_cfg=OkTopkConfig(num_workers=8))),
            (jpolicy, jtune.TrialRunner(
                fake_ms=fake, base_cfg=JCfg(num_workers=8)))):
        pol = mod.AutotunePolicy(
            candidates=mod.make_candidates(cands, densities), **kw)
        journal = (ttune if mod is policy else jtune).DecisionJournal()
        out.append(mod.Autotuner(
            sizes, 8, pol, runner,
            coeffs=mod.FabricCoefficients(1e-6, 1e-11, source="injected"),
            journal=journal))
    return out


def same_tuners(port, jax_t, plans, jplans):
    assert [p.as_dict() for p in plans] == [p.as_dict() for p in jplans]
    assert journal_body(port.journal) == journal_body(jax_t.journal)
    assert port.last_tune_step == jax_t.last_tune_step


def test_crossover_is_jax():
    port, jt = tuner_pair([SMALL, LARGE], crossover_fake_ms)
    port.calibrate(step=0)
    jt.calibrate(step=0)
    plans, jplans = port.tune(step=0), jt.tune(step=0)
    assert [p.algo for p in plans] == ["dense", "oktopk"]
    same_tuners(port, jt, plans, jplans)
    dec = [e for e in port.journal.entries if e["event"] == "decision"]
    assert [d["reason"] for d in dec] == ["trial", "trial"]


def test_hysteresis_hold_is_jax():
    timings = {"scale": 1.0}

    def fake(algo, n, density):
        if timings["scale"] != 1.0 and algo == "dense" and n == LARGE:
            return crossover_fake_ms("oktopk", n, density) * 0.95
        return crossover_fake_ms(algo, n, density)

    port, jt = tuner_pair([LARGE], fake)
    first, jfirst = port.tune(step=0), jt.tune(step=0)
    timings["scale"] = 0.95
    second, jsecond = port.tune(step=100), jt.tune(step=100)
    assert second[0].algo == "oktopk"
    assert not policy.Autotuner.plans_changed(second, first)
    assert port.journal.entries[-1]["reason"] == "hold"
    same_tuners(port, jt, first + second, jfirst + jsecond)


def test_retune_switch_is_jax():
    flipped = {"on": False}

    def fake(algo, n, density):
        if flipped["on"] and algo == "dense":
            return 0.01
        return crossover_fake_ms(algo, n, density)

    port, jt = tuner_pair([LARGE], fake)
    first, jfirst = port.tune(step=0), jt.tune(step=0)
    assert not port.should_retune(50) and port.should_retune(100)
    flipped["on"] = True
    second, jsecond = port.tune(step=100), jt.tune(step=100)
    assert second[0].algo == "dense"
    assert policy.Autotuner.plans_changed(second, first)
    assert port.journal.entries[-1]["reason"] == "trial"
    same_tuners(port, jt, first + second, jfirst + jsecond)


def test_prior_pruning_measures_the_incumbent_as_jax():
    calls = {"port": [], "jax": []}

    def fake_for(side):
        def fake(algo, n, density):
            calls[side].append(algo)
            return crossover_fake_ms(algo, n, density)
        return fake

    port, jt = tuner_pair([LARGE], crossover_fake_ms,
                          cands=("dense", "oktopk", "topkA"), max_trials=1)
    port.runner.fake_ms, jt.runner.fake_ms = fake_for("port"), fake_for("jax")
    for t, mod in ((port, policy), (jt, jpolicy)):
        t.policy = dataclasses.replace(t.policy, retune_every=1)
        t.plans = [mod.BucketPlan(bucket=0, n=LARGE, algo="oktopk",
                                  density=0.02, predicted_ms=1.0,
                                  measured_ms=1.0)]
        t.last_tune_step = 0
    plans, jplans = port.tune(step=1), jt.tune(step=1)
    assert set(calls["port"]) == {"dense", "oktopk"}
    assert calls["port"] == calls["jax"]
    same_tuners(port, jt, plans, jplans)
    dec = port.journal.entries[-1]
    assert [c["measured_ms"] is None for c in dec["candidates"]].count(
        True) == 1


def test_plan_mode_is_jax():
    """Plan mode: no trials, the ``dcn`` preset's inter edge as the
    coefficients, hierarchical candidates priced per level."""
    sizes = [SMALL, LARGE, 14728266]
    out = []
    for mod, jmod in ((policy, ttune), (jpolicy, jtune)):
        pol = mod.AutotunePolicy(candidates=mod.make_candidates(
            ("dense", "oktopk", "topkA"), (0.01, 0.05),
            hierarchical_outers=("oktopk", "dense")))
        t = mod.Autotuner(sizes, 8, pol, None, fabric="dcn", num_pods=2,
                          journal=jmod.DecisionJournal())
        out.append((t, t.tune(step=3)))
    (port, plans), (jt, jplans) = out
    assert port.coeffs.as_dict() == jt.coeffs.as_dict()
    assert port.coeffs.source == "preset:dcn"
    same_tuners(port, jt, plans, jplans)
    dec = [e for e in port.journal.entries if e["event"] == "decision"]
    assert {d["reason"] for d in dec} == {"plan"}
    assert all(d["fabric"] == "ici+dcn" and d["num_pods"] == 2
               for d in dec)
    with pytest.raises(ValueError, match="trial runner"):
        policy.Autotuner(sizes, 8, port.policy, None)


def test_policy_validation_is_jax():
    for mod in (policy, jpolicy):
        with pytest.raises(ValueError):
            mod.AutotunePolicy(candidates=())
        with pytest.raises(ValueError):
            mod.AutotunePolicy(candidates=(mod.Candidate("dense"),),
                               hysteresis=1.5)
    assert policy.make_candidates(("dense", "oktopk"), (0.01, 0.02), (
        "topkA",)) == tuple(policy.Candidate(**dataclasses.asdict(c))
                            for c in jpolicy.make_candidates(
                                ("dense", "oktopk"), (0.01, 0.02),
                                ("topkA",)))


def test_journal_file_is_jax(tmp_path):
    port, jt = tuner_pair([SMALL, LARGE], crossover_fake_ms)
    port.journal = ttune.DecisionJournal(str(tmp_path / "port.jsonl"))
    jt.journal = jtune.DecisionJournal(str(tmp_path / "jax.jsonl"))
    for t in (port, jt):
        t.calibrate(step=0)
        t.tune(step=0)
    got = ttune.read_journal(str(tmp_path / "port.jsonl"))
    want = jtune.read_journal(str(tmp_path / "jax.jsonl"))
    strip = [[{k: v for k, v in e.items() if k not in ENV_KEYS}
              for e in j] for j in (got, want)]
    assert strip[0] == strip[1]
    assert [e["event"] for e in got] == ["header", "calibration",
                                         "decision", "decision"]


# ---- the Trainer ------------------------------------------------------------

MNIST = dict(dnn="mnistnet", dataset="mnist", batch_size=8, lr=0.1,
             compressor="oktopk", density=0.02, num_workers=8,
             num_buckets=2, autotune=True,
             autotune_candidates=("dense", "oktopk"),
             autotune_trial_steps=1, autotune_retune_every=50)


@pytest.fixture(scope="module")
def fake_seam_pair(mesh8):
    """JAX's ``TestTrainerIntegration`` Trainer and the port's from its
    weights, both tuned through the fake seam."""
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    jt = JTrainer(JTrain(**MNIST), mesh=mesh8, warmup=False)
    tt = Trainer(TrainConfig(**MNIST), warmup=False, device="cpu")
    tt.load_jax_variables(jax.device_get(jt.state.params))
    jplans = jt.autotune(step=0, fake_ms=crossover_fake_ms)
    plans = tt.autotune(step=0, fake_ms=crossover_fake_ms)
    return jt, tt, jplans, plans


def test_fake_seam_plans_are_jax(fake_seam_pair):
    jt, tt, jplans, plans = fake_seam_pair
    key = [(p.bucket, p.n, p.algo, p.density, p.measured_ms)
           for p in plans]
    assert key == [(p.bucket, p.n, p.algo, p.density, p.measured_ms)
                   for p in jplans]
    assert len({p.algo for p in plans}) == 2, "expected a mixed plan"
    assert tt.grad_step.names == [p.algo for p in plans]
    assert [c.density for c in tt.grad_step.cfgs] == [p.density
                                                      for p in plans]
    assert tt.autotuner.coeffs.source == "measured"
    assert tt._bucket_plan() == jt._bucket_plan()


def test_first_planned_step_is_jax(fake_seam_pair):
    from oktopk_tpu.data.synthetic import synthetic_batch
    from oktopk_tpu_torch.convert import to_jax_params

    jt, tt, _, _ = fake_seam_pair
    batch = synthetic_batch("mnistnet", 8, np.random.RandomState(42))
    jm = jt.train_step(batch)
    tm = tt.train_step(batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for key in ("comm_volume", "local_k", "global_k"):
        want = float(np.asarray(jm[key]))
        assert abs(float(tm[key]) - want) <= 0.01 * abs(want) + 2, key
    params, _ = to_jax_params(tt.model.state_dict())
    want_p = jax.device_get(jt.state.params)
    for mod in want_p:
        for leaf in want_p[mod]:
            np.testing.assert_allclose(params[mod][leaf],
                                       np.asarray(want_p[mod][leaf]),
                                       rtol=0, atol=1e-4,
                                       err_msg=f"{mod}/{leaf}")


def test_retune_on_the_same_timings_does_not_replan(fake_seam_pair,
                                                    monkeypatch):
    jt, tt, _, plans = fake_seam_pair
    replans = []
    real = tt._replan
    monkeypatch.setattr(tt, "_replan", lambda: replans.append(1) or real())
    algos = tt.grad_step.algos
    again = tt.autotune(step=50, fake_ms=crossover_fake_ms)
    fn = jt.step_fn
    jt.autotune(step=50, fake_ms=crossover_fake_ms)
    assert jt.step_fn is fn
    assert replans == [] and tt.grad_step.algos is algos
    assert [p.key() for p in again] == [p.key() for p in plans]
    assert tt.autotuner.journal.entries[-1]["reason"] in ("trial", "hold")


def test_real_trial_pass_on_the_cpu():
    """Real (not injected) timings over ``StackedComm`` on the CPU: the
    calibration is measured, every candidate's median is positive, and
    the planned step trains."""
    from oktopk_tpu_torch.data import synthetic_batch

    cfg = TrainConfig(**dict(MNIST, num_workers=4, num_buckets=1,
                             autotune_retune_every=0))
    tt = Trainer(cfg, warmup=False, device="cpu")
    m = tt.train(iter([synthetic_batch("mnistnet", 8,
                                       np.random.RandomState(0))]), 1)
    plans = tt._plans
    assert len(plans) == 1 and plans[0].algo in ("dense", "oktopk")
    assert tt.autotuner.coeffs.source == "measured"
    assert tt.autotuner.coeffs.nsamples == 4
    dec = tt.autotuner.journal.entries[-1]
    assert all(c["measured_ms"] > 0 for c in dec["candidates"])
    assert np.isfinite(m["loss"])
    assert tt.grad_step.names == [plans[0].algo]
    assert not tt.autotuner.should_retune(10_000)


def test_trial_retimes_the_same_work():
    """Every measure re-times the cached step from its untouched initial
    state; a failing trial raises."""
    runner = ttune.TrialRunner(comm=StackedComm(4), trial_steps=2,
                               base_cfg=OkTopkConfig(num_workers=4),
                               device="cpu")
    runner.measure("oktopk", 4096, 0.05)
    step, state = runner._cache[("oktopk", 4096, 0.05)]
    before = {k: v.clone() for k, v in vars(state).items()
              if isinstance(v, torch.Tensor)}
    assert runner.measure("oktopk", 4096, 0.05) > 0
    assert runner.measure("dense", 4096, 0.3) > 0
    assert ("dense", 4096, 1.0) in runner._cache
    assert all(torch.equal(v, getattr(state, k)) for k, v in before.items())
    assert int(state.step[0]) == 0
    assert runner._grads[4096].shape == (4, 4096)
    np.testing.assert_array_equal(
        runner._grads[4096].numpy(),
        np.random.RandomState(0).randn(4, 4096).astype(np.float32))
    runner.invalidate()
    assert not runner._cache and not runner._grads
    with pytest.raises((KeyError, ValueError)):
        runner.measure("nosuch", 4096, 0.05)


# ---- the command line, settings, flops, the benchmark -----------------------

AUTOTUNE_FLAGS = ["--autotune", "--autotune-candidates", "dense,topkA,oktopk",
                  "--autotune-trial-steps", "5", "--autotune-retune-every",
                  "7", "--autotune-journal", "d.jsonl"]


def test_autotune_flags_parse_as_jax():
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train import main_trainer as jmain

    names = [f.name for f in dataclasses.fields(JTrain)
             if f.name.startswith("autotune")]
    assert len(names) == 8
    jargs = jmain.parse_args(AUTOTUNE_FLAGS)
    cfg, _ = main_trainer.configs(main_trainer.parse_args(AUTOTUNE_FLAGS), 4)
    want = {"autotune": jargs.autotune,
            "autotune_candidates": tuple(
                jargs.autotune_candidates.split(",")),
            "autotune_trial_steps": jargs.autotune_trial_steps,
            "autotune_retune_every": jargs.autotune_retune_every,
            "autotune_journal": jargs.autotune_journal}
    assert {k: getattr(cfg, k) for k in want} == want
    default, _ = main_trainer.configs(main_trainer.parse_args([]), 4)
    for f in names:
        assert getattr(default, f) == getattr(JTrain(), f), f


def test_profiling_norm_sets_profile_norm(monkeypatch):
    from oktopk_tpu_torch import settings

    monkeypatch.setenv("OKTOPK_PROFILING_NORM", "1")
    try:
        importlib.reload(settings)
        assert settings.PROFILING_NORM is True
        tt = Trainer(TrainConfig(dnn="mnistnet", dataset="mnist",
                                 num_workers=2), device="cpu")
        assert tt._profile_norm and tt.grad_step.profile_norm
        off = Trainer(TrainConfig(dnn="mnistnet", dataset="mnist",
                                  num_workers=2), device="cpu",
                      profile_norm=False)
        assert not off.grad_step.profile_norm
    finally:
        monkeypatch.delenv("OKTOPK_PROFILING_NORM")
        importlib.reload(settings)
    assert settings.PROFILING_NORM is False
    assert not Trainer(TrainConfig(dnn="mnistnet", dataset="mnist",
                                   num_workers=2),
                       device="cpu").grad_step.profile_norm


def test_profiling_grad_dump_is_jax(tmp_path, monkeypatch):
    """``OKTOPK_PROFILING_GRAD``: each chunk's dump holds the JAX dump's
    keys, shapes and dtypes (``jax.device_get`` of the sparse state the
    JAX command line saves), and the port's rows."""
    from oktopk_tpu.collectives.api import batched_init_state
    from oktopk_tpu_torch import settings

    monkeypatch.setattr(settings, "PROFILING_GRAD", True)
    argv = ["--dnn", "mnistnet", "--dataset", "mnist", "--data-dir",
            str(tmp_path / "none"), "--device", "cpu", "--num-workers",
            "2", "--batch-size", "2", "--max-iters", "2",
            "--warmup-steps", "0", "--logdir", str(tmp_path / "logs")]
    assert main_trainer.main(argv) == 0
    dumps = list((tmp_path / "logs").rglob("grad_dumps/iter_2.npz"))
    assert len(dumps) == 1
    got = np.load(dumps[0])
    args = main_trainer.parse_args(argv)
    tt, _, _, _ = main_trainer.build_trainer(args)
    want = jax.device_get(batched_init_state(JCfg(n=tt.algo_cfg.n,
                                                  num_workers=2)))
    assert sorted(got.files) == ["global_threshold", "local_threshold",
                                 "residual"]
    for k in got.files:
        w = np.asarray(getattr(want, k))
        assert (got[k].shape, got[k].dtype) == (w.shape, w.dtype), k
    assert np.any(got["residual"] != 0)


def test_param_count_and_flops_are_jax():
    from oktopk_tpu.models import create_model as jcreate
    from oktopk_tpu.utils import flops as jflops
    from oktopk_tpu_torch.models import create_model
    from oktopk_tpu_torch.utils import flops

    jmodel, example = jcreate("mnistnet")
    jparams = jax.jit(lambda x: jmodel.init(
        jax.random.PRNGKey(0), x, train=False))(example(2))["params"]
    model = create_model("mnistnet")
    assert flops.param_count(model) == jflops.param_count(jparams)
    assert flops.param_count(list(model.parameters())) == \
        jflops.param_count(jparams)
    a = np.random.RandomState(0).randn(64, 128).astype(np.float32)
    b = np.random.RandomState(1).randn(128, 32).astype(np.float32)
    got = flops.model_complexity(torch.matmul, torch.from_numpy(a),
                                 torch.from_numpy(b))
    want = jflops.model_complexity(jnp.matmul, jnp.asarray(a),
                                   jnp.asarray(b))
    assert got["flops"] == want["flops"] == 2 * 64 * 128 * 32
    assert got["bytes_accessed"] == -1.0
    assert set(got) == set(want)


def test_benchmark_cli_on_the_cpu(capsys):
    from oktopk_tpu_torch.benchmarks import collectives as bench
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)

    n, P = 1 << 14, 4
    assert bench.main(["--algo", "oktopk", "--n", str(n), "--density",
                       "0.01", "--steps", "3", "--device", "cpu",
                       "--num-workers", str(P)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"algo=oktopk n={n} P={P} k=163 device=cpu"
    vols = [float(ln.split("volume")[1].split()[0]) for ln in lines[1:]]
    # the same steps in this process
    cfg = OkTopkConfig(n=n, num_workers=P, density=0.01, warmup_steps=0,
                       local_recompute_every=1, global_recompute_every=4)
    step = build_allreduce_step("oktopk", cfg, StackedComm(P),
                                warmup=False)
    state = batched_init_state(cfg, "cpu")
    rng = np.random.RandomState(0)
    base = rng.randn(P, n).astype(np.float32)
    _, state = step(torch.from_numpy(base), state)
    want = []
    for _ in range(3):
        g = base + 0.3 * rng.randn(P, n).astype(np.float32)
        _, state = step(torch.from_numpy(g), state)
        want.append(float(state.last_volume[0]))
    assert vols == want
    assert all(0 < float(ln.rsplit(" ", 1)[1]) for ln in lines[1:])
