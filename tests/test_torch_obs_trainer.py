"""The port's Trainer with the run journal and the quality taps against
the JAX Trainer's, from the same weights (``load_jax_variables``) and
batches, and the CLI's run directory, the ``--sigma-scale`` repair (H25)
and the quality ring in checkpoints across the two packages.

One run of each Trainer (``vgg_narrow``, P = 4, global batch 16, one
dense warmup step then three oktopk steps, ``obs_quality_every=2``, log
every 2 steps, ``PhaseTimers`` and ``MetricWriter`` given) is shared by
the tests of this file.

Held equal: the journals' event sequence; each event's ``step``,
``bucket``, ``algo``, ``count``, ``steps`` and ``skipped``; the rollups'
``window``, ``skipped``, ``target_density`` and breach lists; the
volume reports' ``n``, ``density``, ``steps`` and budgets; the
``scalars.csv`` columns. Within tolerances, and why:

- ``RTOL`` = 1e-5 (as ``tests/test_torch_quality.py``): the losses, the
  reduced gradient's norm and the quality columns ``comp_err``,
  ``res_norm``, ``res_growth``, ``thr_drift`` and ``churn`` (and their
  rollups). Each is a float32 sum over n elements, or a ratio of such
  sums, which XLA and PyTorch add in different orders;
- volumes within 1% + 2 (as ``tests/test_torch_vgg.py``):
  ``comm_volume``, ``wire_bytes``, ``local_k``, ``global_k``, the mean
  wire bytes of the volume report, and ``eff_density`` (a nonzero count
  over n). An element whose accumulated gradient lies within float32
  rounding of a threshold may be selected on one side only (H1).

The taps only read the step: the port's losses, parameters and residuals
are bit-identical with the journal and taps on and off.
"""

from __future__ import annotations

import csv
import dataclasses
import importlib.util
import json
import logging
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

import oktopk_tpu.models.registry as jax_registry
import oktopk_tpu.models.vgg as jax_vgg
import oktopk_tpu_torch.models.registry as torch_registry
import oktopk_tpu_torch.models.vgg as torch_vgg
from oktopk_tpu.obs.events import validate_journal as jax_validate
from oktopk_tpu_torch.autotune.journal import read_journal
from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.obs.events import validate_journal
from oktopk_tpu_torch.train import checkpoint as ckpt
from oktopk_tpu_torch.train import main_trainer
from oktopk_tpu_torch.train.trainer import Trainer
from oktopk_tpu_torch.utils.profiling import MetricWriter, PhaseTimers

from test_torch_vgg import NARROW, batch, narrow  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
ALGO = dict(warmup_steps=1, local_recompute_every=1,
            global_recompute_every=2)
COMMON = dict(dnn="vgg_narrow", batch_size=4, lr=0.05, density=0.05,
              num_workers=4)
OBS = dict(obs=True, obs_quality=True, obs_quality_every=2)
STEPS = 4
CLOSE_COLS = ("comp_err", "res_norm", "res_growth", "thr_drift", "churn")
VOLUMES = ("comm_volume", "wire_bytes", "local_k", "global_k")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _register_narrow(mp):
    mp.setitem(jax_vgg.CFG, "vgg_narrow", NARROW)
    mp.setitem(torch_vgg.CFG, "vgg_narrow", NARROW)
    mp.setitem(jax_registry.MODELS, "vgg_narrow",
               lambda **kw: (jax_vgg.VGG(name_cfg="vgg_narrow", **kw),
                             lambda bs: jax.numpy.zeros((bs, 32, 32, 3))))
    mp.setitem(torch_registry.MODELS, "vgg_narrow",
               lambda **kw: torch_vgg.VGG(name_cfg="vgg_narrow", **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4):
    """The JAX Trainer's and the port's journalled runs, the port's run
    without the journal, and their states."""
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train import checkpoint as jckpt
    from oktopk_tpu.train.trainer import Trainer as JTrainer
    from oktopk_tpu.utils.profiling import MetricWriter as JWriter
    from oktopk_tpu.utils.profiling import PhaseTimers as JTimers

    d = tmp_path_factory.mktemp("obs_trainer")
    batches = [batch(16, seed=10 + s) for s in range(STEPS)]
    with pytest.MonkeyPatch.context() as mp:
        _register_narrow(mp)
        jt = JTrainer(JTrain(**COMMON, **OBS,
                             obs_journal=str(d / "jax.jsonl")),
                      mesh=mesh4, algo_cfg=JCfg(**ALGO), profile_norm=False)
        params = jax.device_get(jt.state.params)
        stats = jax.device_get(jt.state.model_state["batch_stats"])
        with JWriter(str(d / "jax_csv")) as w:
            jt.train(iter(batches), STEPS, log_every=2, metric_writer=w,
                     timers=JTimers(every=2))
        jckpt.save_checkpoint(str(d / "jax_ckpt"), jt.state, STEPS)

        def port(obs: dict):
            t = Trainer(TrainConfig(**COMMON, **obs),
                        algo_cfg=OkTopkConfig(**ALGO), device="cpu")
            t.load_jax_variables(params, stats)
            return t

        tt = port(dict(OBS, obs_journal=str(d / "port.jsonl")))
        with MetricWriter(str(d / "port_csv")) as w:
            tt.train(iter(batches), STEPS, log_every=2, metric_writer=w,
                     timers=PhaseTimers(every=2))
        off = port({})
        off_losses = [float(off.train_step(b)["loss"]) for b in batches]
        fresh = port(dict(OBS))
        yield {"dir": d, "jt": jt, "tt": tt, "off": off,
               "off_losses": off_losses, "fresh": fresh,
               "jax": read_journal(str(d / "jax.jsonl")),
               "port": read_journal(str(d / "port.jsonl"))}


def _pairs(runs, event):
    got = [e for e in runs["port"] if e["event"] == event]
    want = [e for e in runs["jax"] if e["event"] == event]
    assert len(got) == len(want) > 0, event
    return list(zip(got, want))


def _close(got, want, what):
    if want is None:
        assert got is None, what
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                   err_msg=what)


def _volume_close(got, want, what):
    assert abs(got - want) <= 0.01 * abs(want) + 2, (what, got, want)


def test_journals_validate_and_render(runs):
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(ROOT, "scripts", "obs_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    for name in ("port", "jax"):
        assert jax_validate(runs[name]) == [], name
        assert validate_journal(runs[name]) == [], name
    hdr = runs["port"][0]
    assert hdr["jax"] is None and hdr["platform"] == "cpu"
    text = report.render_report(runs["port"])
    assert "schema: OK" in text and "signal fidelity" in text, text


def test_event_sequence_matches_jax(runs):
    seq = [e["event"] for e in runs["port"][1:]]
    assert seq == [e["event"] for e in runs["jax"][1:]]
    assert seq.count("step") == STEPS
    assert seq.count("quality") == seq.count("quality_rollup") == 2
    for i, ev in enumerate(seq):
        if ev == "quality":
            assert seq[i + 1] == "quality_rollup"


def test_step_events_match_jax(runs):
    for got, want in _pairs(runs, "step"):
        assert got.keys() == want.keys()
        assert got["step"] == want["step"]
        assert got["grad_nonfinite"] == want["grad_nonfinite"] == 0
        for k in ("loss", "grad_norm"):
            _close(got[k], want[k], (got["step"], k))
        for k in VOLUMES:
            _volume_close(got[k], want[k], (got["step"], k))
        assert got["wire_bytes"] > 0


def test_quality_events_match_jax(runs):
    n = runs["tt"].algo_cfg.n
    for got, want in _pairs(runs, "quality"):
        for k in ("step", "bucket", "algo", "count", "steps", "skipped"):
            assert got[k] == want[k], k
        for c in CLOSE_COLS:
            for g, w in zip(got[c], want[c]):
                _close(g, w, (got["step"], c))
        for g, w in zip(got["eff_density"], want["eff_density"]):
            _volume_close(g * n, w * n, (got["step"], "eff_density"))
    assert sum(e["count"] for e, _ in _pairs(runs, "quality")) == STEPS


def test_rollups_match_jax(runs):
    for got, want in _pairs(runs, "quality_rollup"):
        assert got.keys() == want.keys()
        for k in ("step", "bucket", "algo", "window", "skipped",
                  "breaches", "target_density"):
            assert got[k] == want[k], k
        for k in got:
            if k.startswith(CLOSE_COLS):
                _close(got[k], want[k], k)


def test_volume_report_matches_jax(runs):
    for got, want in _pairs(runs, "volume_report"):
        for k in ("step", "bucket", "algo", "n", "density", "steps",
                  "budget_bytes", "capacity_bytes"):
            assert got[k] == want[k], k
        _volume_close(got["mean_wire_bytes"], want["mean_wire_bytes"],
                      "mean_wire_bytes")
        assert got["budget_bytes"] > 0


def test_phase_events_and_scalars_match_jax(runs):
    for got, want in _pairs(runs, "phase"):
        assert got["step"] == want["step"]
        assert got["phases"].keys() == want["phases"].keys() == {"data",
                                                                 "step"}
        for ph in got["phases"]:
            assert got["phases"][ph]["count"] == want["phases"][ph]["count"]
    rows = {}
    for name in ("port", "jax"):
        with open(runs["dir"] / f"{name}_csv" / "scalars.csv") as f:
            rows[name] = list(csv.reader(f))
    assert rows["port"][0] == rows["jax"][0]
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]
    assert len(rows["port"]) == STEPS + 1


def test_taps_leave_the_step_bit_identical(runs):
    """Journal and taps on against off: the same losses, parameters,
    residuals and volumes, bit for bit."""
    tt, off = runs["tt"], runs["off"]
    losses = [e["loss"] for e in runs["port"] if e["event"] == "step"]
    assert losses == runs["off_losses"]
    for a, b in zip(tt.params, off.params):
        assert torch.equal(a, b)
    for sa, sb in zip(tt.grad_step.states, off.grad_step.states):
        assert torch.equal(sa.residual, sb.residual)
        assert torch.equal(sa.wire_bytes, sb.wire_bytes)
    assert off.grad_step.qualities is None and off.bus is None
    # two on the cadence and the tail's, as the JAX Trainer counts them
    assert tt.quality_flushes == runs["jt"].quality_flushes == 3


def test_quality_ring_crosses_checkpoints(runs, caplog):
    """JAX's file restores into a fresh port Trainer with the taps, the
    ring and cursor included, bit for bit; the port's file restores into
    the JAX state with every quality leaf the port's."""
    from oktopk_tpu.train import checkpoint as jckpt

    d, jt, fresh = runs["dir"], runs["jt"], runs["fresh"]
    with caplog.at_level(logging.WARNING):
        tree, step = ckpt.restore_checkpoint(str(d / "jax_ckpt"),
                                             fresh.train_state(gather=False))
    assert step == STEPS and "does not fully match" not in caplog.text
    fresh.load_train_state(tree)
    got = fresh.train_state(host=True)["quality"]
    want = jax.device_get(jt.state.quality)
    for f in ("ring", "cursor", "prev_res_norm", "prev_sig"):
        w = np.asarray(getattr(want, f))
        assert got[f].dtype == w.dtype and got[f].shape == w.shape, f
        np.testing.assert_array_equal(got[f], w, err_msg=f)
    assert int(got["cursor"][0]) == STEPS

    ckpt.save_checkpoint(str(d / "port_ckpt"), runs["tt"].train_state(),
                         STEPS)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jstate, jstep = jckpt.restore_checkpoint(str(d / "port_ckpt"),
                                                 jt.state)
    assert jstep == STEPS and "does not fully match" not in caplog.text
    mine = runs["tt"].train_state(host=True)["quality"]
    for f in ("ring", "cursor", "prev_res_norm", "prev_sig"):
        r = np.asarray(getattr(jstate.quality, f))
        assert r.dtype == np.asarray(getattr(jt.state.quality, f)).dtype
        np.testing.assert_array_equal(r, mine[f], err_msg=f)


def test_cli_writes_the_run_directory(narrow, tmp_path, caplog):  # noqa: F811
    argv = ["--dnn", "vgg_narrow", "--device", "cpu", "--num-workers", "2",
            "--batch-size", "2", "--max-iters", "3", "--warmup-steps", "1",
            "--log-every", "1", "--density", "0.05", "--obs",
            "--obs-quality", "--obs-quality-every", "2", "--phase-timers",
            "--trace-at", "2", "--trace-steps", "1", "--logdir",
            str(tmp_path)]
    with caplog.at_level(logging.INFO, logger="oktopk_tpu_torch"):
        assert main_trainer.main(argv) == 0
    assert "done: 3 iterations" in caplog.text
    cfg, _ = main_trainer.configs(main_trainer.parse_args(argv), 2)
    rundir = tmp_path / cfg.experiment_slug()
    journal = read_journal(str(rundir / "run_journal.jsonl"))
    assert jax_validate(journal) == []
    kinds = [e["event"] for e in journal]
    assert kinds.count("step") == 3 and kinds.count("quality") == 2
    assert kinds[-1] == "volume_report"
    log = (rundir / "rank0.log").read_text()
    assert "iter 3 loss" in log and "epoch done @ iter 3" in log
    assert "phase timing @ step" in log
    with open(rundir / "scalars.csv") as f:
        assert len(list(csv.reader(f))) == 4
    trace = rundir / "trace" / "trace_steps2-2.json"
    assert "traceEvents" in json.loads(trace.read_text())
    # the handlers this run attached are gone
    assert not any(isinstance(h, logging.FileHandler) for h in
                   logging.getLogger("oktopk_tpu_torch").handlers)


# ---- H25: the reference's launch lines --------------------------------------

def _launch_argv(script: str):
    """The argv that ``scripts/<script>`` passes to ``main_trainer``, its
    shell variables expanded by bash (``srun python -m ...`` replaced by
    ``printf``)."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        text = f.read()
    head = "srun python -m oktopk_tpu.train.main_trainer"
    assert text.count(head) == 1, script
    env = dict(os.environ, SLURM_SUBMIT_DIR=ROOT)
    out = subprocess.run(["bash", "-c", text.replace(
        head, "printf '%s\\n'")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=60, check=True).stdout
    return out.splitlines()


def _jax_configs(args, workers: int):
    """The JAX command line's TrainConfig and OkTopkConfig of its parsed
    flags (``oktopk_tpu/train/main_trainer.py:199-256``, the fields the
    port has)."""
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain

    cfg = JTrain(
        dnn=args.dnn, dataset=args.dataset, batch_size=args.batch_size,
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        nesterov=args.nesterov, max_epochs=args.max_epochs,
        nsteps_update=args.nsteps_update, compressor=args.compressor,
        num_buckets=args.num_buckets, compute_dtype=args.compute_dtype,
        density=args.density, sigma_scale=args.sigma_scale,
        grad_clip=args.grad_clip, seed=args.seed, num_workers=workers,
        obs=args.obs, obs_regress_key=args.obs_regress_key,
        obs_quality=args.obs_quality,
        obs_quality_every=args.obs_quality_every)
    algo = JCfg(sigma_scale=args.sigma_scale, wire_dtype=args.wire_dtype)
    if args.warmup_steps is not None:
        algo = algo.replace(warmup_steps=args.warmup_steps)
    return cfg, algo


@pytest.mark.parametrize("script,extra", [
    ("vgg16_oktopk.sh", []), ("lstm_oktopk.sh", []),
    ("vgg16_oktopk.sh", ["--sigma-scale", "3.0", "--obs", "--obs-quality",
                         "--obs-quality-every", "8", "--obs-regress-key",
                         "oktopk_ms", "--trace-at", "5", "--trace-steps",
                         "2", "--phase-timers", "--logdir", "runs",
                         "--obs-journal", "j.jsonl"])])
def test_launch_lines_parse_as_jax(script, extra):
    from oktopk_tpu.train.main_trainer import parse_args as jax_parse

    argv = _launch_argv(script) + extra
    assert "--sigma-scale" in argv
    mine, theirs = main_trainer.parse_args(argv), jax_parse(argv)
    shared = set(vars(mine)) & set(vars(theirs))
    assert {"sigma_scale", "obs", "obs_journal", "obs_quality",
            "obs_quality_every", "obs_regress_key", "logdir", "trace_at",
            "trace_steps", "phase_timers"} <= shared
    for k in shared - {"data_dir"}:
        assert getattr(mine, k) == getattr(theirs, k), k
    assert mine.data_dir == theirs.data_dir     # given by the script
    cfg, algo = main_trainer.configs(mine, 4)
    jcfg, jalgo = _jax_configs(theirs, 4)
    assert cfg.sigma_scale == algo.sigma_scale == (3.0 if extra else 2.5)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert dataclasses.asdict(algo) == dataclasses.asdict(jalgo)


# ---- the anomaly tracer (obs/tracing.py) -----------------------------------

def _tracer_pair(tmp_path, **kw):
    """The port's AnomalyTracer and JAX's, each on its own bus and
    journal (JAX's profiler seam stubbed: a CPU jax.profiler capture is
    not what is held here)."""
    from oktopk_tpu.obs.journal import EventBus as JBus
    from oktopk_tpu.obs.journal import RunJournal as JJournal
    from oktopk_tpu.obs.tracing import AnomalyTracer as JTracer
    from oktopk_tpu_torch.obs.journal import EventBus, RunJournal
    from oktopk_tpu_torch.obs.tracing import AnomalyTracer
    bus, jbus = EventBus(), JBus()
    journals = RunJournal(None, bus), JJournal(None, jbus)
    tracers = (AnomalyTracer(str(tmp_path / "port"), bus=bus, **kw),
               JTracer(str(tmp_path / "jax"), bus=jbus, **kw))
    return (bus, jbus), journals, tracers


def _captures(journal):
    return [dict(e, logdir=e["logdir"] and os.path.basename(e["logdir"]))
            for e in journal.entries if e["event"] == "trace_captured"]


def test_tracer_arms_on_breached_rollup_only(tmp_path):
    buses, _, tracers = _tracer_pair(tmp_path)
    for b in buses:
        b.emit("quality_rollup", step=8, bucket=0, breaches=[])
    assert [t._armed for t in tracers] == [None, None]
    for b in buses:
        b.emit("quality_rollup", step=16, bucket=0,
               breaches=["residual_growth"])
    assert [t._armed for t in tracers] == ["quality_rollup@step16"] * 2


def test_tracer_windows_journal_like_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    buses, journals, tracers = _tracer_pair(tmp_path, num_steps=2,
                                            max_captures=2)
    for step in range(1, 16):
        for b in buses:
            if step in (3, 4, 9, 12):      # 4 and 10 land inside windows
                b.emit("guard_trip", step=step, buckets=[0],
                       consecutive_skips=1, strikes=[1])
            if step == 10:
                b.emit("fallback", step=step, bucket=0, algo="dense",
                       strikes=3)
        for t in tracers:
            t.on_step(step)
    for t in tracers:
        t.finish(16)
    got, want = (_captures(j) for j in journals)
    assert got == want
    assert [c["trigger"] for c in got] == ["guard_trip@step3",
                                           "guard_trip@step9"]
    assert [c["logdir"] for c in got] == ["anomaly_step3",
                                          "anomaly_step9"]
    for j in journals:
        assert jax_validate(j.entries) == []
        assert validate_journal(j.entries) == []
    # the port's window wrote a real Chrome trace, named by rank
    for c in got:
        path = tmp_path / "port" / c["logdir"] / "rank0.pt.trace.json"
        assert json.load(open(path))["traceEvents"]


def test_tracer_profiler_busy_journals_null_logdir(tmp_path):
    from oktopk_tpu_torch.obs.journal import EventBus, RunJournal
    from oktopk_tpu_torch.obs.tracing import AnomalyTracer
    from oktopk_tpu_torch.utils.profiling import TraceWindow
    bus = EventBus()
    journal = RunJournal(None, bus)
    tracer = AnomalyTracer(str(tmp_path), bus=bus, num_steps=1, rank=3)
    window = TraceWindow(str(tmp_path / "trace"), start_step=1,
                         num_steps=3)
    window.on_step(1)                     # --trace-at's window is open
    bus.emit("fallback", step=1, bucket=0, algo="dense", strikes=3)
    tracer.on_step(2)
    tracer.on_step(3)
    window.close()
    cap = [e for e in journal.entries if e["event"] == "trace_captured"]
    assert len(cap) == 1 and cap[0]["logdir"] is None
    assert cap[0]["trigger"] == "fallback@step1"
    assert jax_validate(journal.entries) == []
    assert window.path is not None


# ---- the unified journal (tests/test_obs.py:159-235) in both packages ------

UNIFIED_STEPS = 30


@pytest.fixture(scope="module")
def unified_runs(mesh4, tmp_path_factory):
    """JAX's ``test_unified_journal_end_to_end`` run and the port's: the
    same config, fault plan (a wire bit-flip from worker 2 at step 5 for
    two steps), fake trial timings and batches; each package's profiler
    seam stubbed."""
    from oktopk_tpu.autotune.journal import read_journal as jread
    from oktopk_tpu.collectives import wire as jwire
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.data.synthetic import synthetic_batch as jbatch
    from oktopk_tpu.resilience import faults as jfaults
    from oktopk_tpu.train.trainer import Trainer as JTrainer
    from oktopk_tpu_torch.collectives import wire
    from oktopk_tpu_torch.data.synthetic import synthetic_batch
    from oktopk_tpu_torch.resilience import faults
    from oktopk_tpu_torch.utils import profiling

    d = tmp_path_factory.mktemp("unified")
    common = dict(dnn="mnistnet", dataset="mnist", batch_size=8, lr=0.05,
                  compressor="oktopk", density=0.05, resilience=True,
                  resilience_cooldown=0, autotune=True, obs=True,
                  obs_quality=True, obs_quality_every=8,
                  obs_trace_on_anomaly=True, obs_trace_steps=2,
                  obs_regress_key="oktopk_ms")
    algo = dict(warmup_steps=0, local_recompute_every=2,
                global_recompute_every=4, repartition_every=4)
    spec = dict(step=5, duration=2, worker=2)

    def fake(algo_name, n, density):
        return 5.0 if algo_name == "dense" else 1.0

    out = {"prof": [], "jprof": []}
    jplan = jfaults.FaultPlan((jfaults.FaultSpec("wire_bitflip", **spec),))
    prev = jwire.install_wire_fault(jfaults.make_wire_hook(jplan))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.profiler, "start_trace",
                   lambda t: out["jprof"].append(("start", t)))
        mp.setattr(jax.profiler, "stop_trace",
                   lambda: out["jprof"].append(("stop", None)))
        try:
            jt = JTrainer(JTrain(**common,
                                 obs_journal=str(d / "jax.jsonl"),
                                 obs_trace_dir=str(d / "jax_traces")),
                          mesh=mesh4, warmup=False, algo_cfg=JCfg(**algo),
                          fault_plan=jplan)
            jt.autotune(step=0, fake_ms=fake)
            rng = np.random.RandomState(9)
            jt.train(iter([jbatch("mnistnet", 8, rng)
                           for _ in range(UNIFIED_STEPS)]), UNIFIED_STEPS,
                     log_every=10)
        finally:
            jwire.install_wire_fault(prev)

        mp.setattr(profiling, "_start_profiler",
                   lambda: out["prof"].append("start") or "prof")
        mp.setattr(profiling, "_stop_profiler",
                   lambda prof, path: out["prof"].append(path) or path)
        plan = faults.FaultPlan((faults.FaultSpec("wire_bitflip", **spec),))
        tt = Trainer(TrainConfig(**common, num_workers=4,
                                 obs_journal=str(d / "port.jsonl"),
                                 obs_trace_dir=str(d / "port_traces")),
                     warmup=False, algo_cfg=OkTopkConfig(**algo),
                     fault_plan=plan, device="cpu")
        prev = wire.install_wire_fault(faults.make_wire_hook(plan, tt.comm))
        try:
            tt.autotune(step=0, fake_ms=fake)
            rng = np.random.RandomState(9)
            tt.train(iter([synthetic_batch("mnistnet", 8, rng)
                           for _ in range(UNIFIED_STEPS)]), UNIFIED_STEPS,
                     log_every=10)
        finally:
            wire.install_wire_fault(prev)
    out.update(port=read_journal(str(d / "port.jsonl")),
               jax=jread(str(d / "jax.jsonl")), dir=d)
    return out


def test_unified_journal_matches_jax(unified_runs):
    r = unified_runs
    port, jx = r["port"], r["jax"]
    events = [e["event"] for e in port]
    assert events == [e["event"] for e in jx]
    assert events[0] == "header" and events.count("header") == 1
    for name in ("autotune_decision", "step", "fault_seen", "guard_trip",
                 "volume_report", "trace_captured"):
        assert name in events, name
    trips = [e["step"] for e in port if e["event"] == "guard_trip"]
    assert trips == [e["step"] for e in jx if e["event"] == "guard_trip"]
    assert trips
    # the trip armed a window that closed in the same journal, after it
    assert events.index("guard_trip") < events.index("trace_captured")
    cap = [e for e in port if e["event"] == "trace_captured"]
    jcap = [e for e in jx if e["event"] == "trace_captured"]
    assert [(c["trigger"], c["start_step"], c["step"]) for c in cap] == \
        [(c["trigger"], c["start_step"], c["step"]) for c in jcap]
    assert cap[0]["trigger"].startswith("guard_trip@")
    assert cap[0]["logdir"] == os.path.join(
        str(r["dir"] / "port_traces"), f"anomaly_step{cap[0]['start_step']}")
    assert r["prof"][0] == "start" and r["prof"][-1] == os.path.join(
        cap[0]["logdir"], "rank0.pt.trace.json")
    assert r["jprof"][0][0] == "start" and r["jprof"][-1][0] == "stop"
    assert sum(e["event"] == "step" for e in port) == UNIFIED_STEPS
    assert all(e.get("wire_bytes", 0) > 0 for e in port
               if e["event"] == "step")
    assert jax_validate(port) == [] and validate_journal(port) == []


def test_unified_journal_renders(unified_runs):
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(ROOT, "scripts", "obs_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    text = report.render_report(unified_runs["port"])
    assert "schema: OK" in text, text
