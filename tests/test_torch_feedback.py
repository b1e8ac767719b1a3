"""The fault -> autotune feedback loop of the port
(``oktopk_tpu_torch/resilience/feedback.py`` and the Trainer's
``force_retune``, ``check_feedback``) against the JAX package's.

- ``AutotuneFeedback``: one event stream replayed onto both packages'
  buses fires on the same steps with the same descriptors and leaves the
  same state, through the window's ageing, the cooldown, events without a
  step, and the clean ``quality_rollup`` filter; ``note_peer_fire`` is
  the firing's own bookkeeping;
- the autotuned Trainer with the loop on (``cfg.autotune``,
  ``cfg.resilience_feedback``, ``cfg.obs``): it builds, trains, and a
  stream of regressions forces the chain ``retune`` -> ``calibration``
  -> ``autotune_decision`` in the run journal, JAX's Trainer's chain
  event for event; ``quality_rollup`` votes under ``cfg.obs_quality``;
  without the autotuner a re-tune is still journalled;
- an elastic resize drops the tuner and keeps the plan, as JAX's;
- ``main_trainer --autotune --resilience-feedback --obs`` trains on the
  CPU and journals the tuner's events.

Every Trainer here is mnistnet on two to four stacked CPU workers
through the fake-timing seam (``tests/test_autotune.py``'s
``crossover_fake_ms``), torch on one thread.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from oktopk_tpu.obs.journal import EventBus as JBus
from oktopk_tpu.resilience.feedback import AutotuneFeedback as JFeedback
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.data import synthetic_batch
from oktopk_tpu_torch.obs.journal import EventBus
from oktopk_tpu_torch.resilience import AutotuneFeedback
from oktopk_tpu_torch.train import main_trainer
from oktopk_tpu_torch.train.trainer import Trainer

from test_torch_autotune import crossover_fake_ms


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---- the policy -------------------------------------------------------------

def reg(step):
    return ("regression", dict(step=step, ms=20.0, baseline_ms=10.0,
                               ratio=2.0))


def trip(step):
    return ("guard_trip", dict(step=step, buckets=[0], consecutive_skips=1,
                               strikes=[1]))


def rollup(step, breaches):
    return ("quality_rollup", dict(step=step, bucket=0, breaches=breaches))


# (AutotuneFeedback kwargs, stream of (poll step, events emitted before))
STREAMS = {
    "sustained": (dict(window_steps=10, min_signals=3, cooldown_steps=20),
                  [(4, [reg(4)]), (5, [reg(5)]), (6, [reg(6)])]),
    "ageing": (dict(window_steps=10, min_signals=3, cooldown_steps=20),
               [(1, [reg(1)]), (2, [reg(2)]), (30, [reg(30)]),
                (31, [reg(31)]), (32, [reg(32)])]),
    "cooldown": (dict(window_steps=10, min_signals=3, cooldown_steps=20),
                 [(3, [trip(1), trip(2), trip(3)]),
                  (6, [trip(4), trip(5), trip(6)]),
                  (23, [trip(21), trip(22), trip(23)]),
                  (24, [trip(24)])]),
    "other_events": (dict(window_steps=10, min_signals=1, cooldown_steps=0),
                     [(2, [("step", dict(step=1, loss=1.0)),
                           ("fallback", dict(step=2, bucket=0, algo="dense",
                                             strikes=3)),
                           ("regression", dict(ms=3.0))])]),
    "quality_rollups": (dict(window_steps=32, min_signals=2,
                             cooldown_steps=0,
                             kinds=("regression", "guard_trip",
                                    "quality_rollup")),
                        [(8, [rollup(8, [])]),
                         (17, [rollup(8, ["comp_err"]),
                               rollup(16, ["churn_spike"])]),
                         (40, [rollup(32, []), reg(39), trip(40)])]),
}


def replay(cls, bus_cls, kw, stream):
    bus = bus_cls()
    fb = cls(bus, **kw)
    out = []
    for step, events in stream:
        for name, fields in events:
            bus.emit(name, **fields)
        out.append(fb.should_retune(step))
    return out + [(fb.signals, fb.fired, fb._cooldown_until)]


@pytest.mark.parametrize("name", list(STREAMS))
def test_feedback_fires_as_jax(name):
    kw, stream = STREAMS[name]
    got = replay(AutotuneFeedback, EventBus, kw, stream)
    assert got == replay(JFeedback, JBus, kw, stream)
    if name in ("sustained", "cooldown", "quality_rollups"):
        assert any(t is not None for t in got[:-1])


def test_peer_fire_is_the_firing_bookkeeping():
    kw, stream = STREAMS["sustained"]
    fired = replay(AutotuneFeedback, EventBus, kw, stream)[-1]
    peer = AutotuneFeedback(EventBus(), **kw)
    peer.signals = [(5, "regression")]
    peer.note_peer_fire(6)
    assert (peer.signals, peer.fired, peer._cooldown_until) == fired
    assert peer.should_retune(7) is None          # in cooldown


# ---- the Trainer ------------------------------------------------------------

LOOP = dict(dnn="mnistnet", dataset="mnist", batch_size=2, lr=0.05,
            compressor="oktopk", density=0.05, num_workers=2, num_buckets=2,
            autotune=True, autotune_candidates=("dense", "oktopk"),
            autotune_trial_steps=1, resilience_feedback=True,
            resilience_feedback_window=8, resilience_feedback_signals=3,
            resilience_feedback_cooldown=50, obs=True)
ALGO = dict(warmup_steps=0, local_recompute_every=1,
            global_recompute_every=1, repartition_every=1)


def loop_trainer(**over):
    return Trainer(TrainConfig(**dict(LOOP, **over)),
                   algo_cfg=OkTopkConfig(**ALGO), warmup=False,
                   device="cpu")


def batches(P, seed=3):
    rng = np.random.RandomState(seed)
    while True:
        yield synthetic_batch("mnistnet", 2 * P, rng)


def chain(journal):
    """(event, step, chosen algos) of the tuner's events, in order."""
    return [(e["event"], e.get("step"),
             e["chosen"]["algo"] if "chosen" in e else None)
            for e in journal
            if e["event"] in ("retune", "calibration", "autotune_decision")]


def test_trainer_retunes_on_a_regression_stream_as_jax(mesh4):
    """A regression at each of steps 1-3 forces a re-tune at step 3's
    poll: the port's chain is the JAX Trainer's."""
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    tt = loop_trainer(num_workers=4)
    assert tt.feedback is not None
    assert tt.feedback.kinds == ("regression", "guard_trip")
    jt = JTrainer(JTrain(**dict(LOOP, num_workers=4)), mesh=mesh4,
                  algo_cfg=JCfg(**ALGO), warmup=False)
    out = {}
    for name, t in (("port", tt), ("jax", jt)):
        t.autotune(step=0, fake_ms=crossover_fake_ms)
        fired = []
        for step in (1, 2, 3, 4):
            if step < 4:
                t.bus.emit("regression", step=step, ms=30.0,
                           baseline_ms=10.0, ratio=3.0)
            fired.append(t.check_feedback(step))
        out[name] = (fired, t.retune_events, chain(t.run_journal.entries),
                     [(p.algo, p.density) for p in t._plans])
    assert out["port"] == out["jax"]
    fired, events, ch, _ = out["port"]
    assert fired == [None, None, {"trigger": "regression",
                                  "signals": [1, 2, 3]}, None]
    assert events == 1 and tt.autotuner.last_tune_step == 3
    assert [c[0] for c in ch] == ["calibration", "autotune_decision",
                                  "autotune_decision", "retune",
                                  "calibration", "autotune_decision",
                                  "autotune_decision"]
    m = tt.train(batches(4), 2, log_every=1, start_step=4)
    assert np.isfinite(m["loss"])


def test_trainer_builds_and_trains_with_the_loop():
    tt = loop_trainer(obs_quality=True, obs_quality_every=2)
    assert tt.feedback.kinds == ("regression", "guard_trip",
                                 "quality_rollup")
    # the tuner runs on the first step, through the real trial seam
    m = tt.train(batches(2), 3, log_every=1)
    assert np.isfinite(m["loss"]) and tt._plans is not None
    assert tt.autotuner.coeffs.source == "measured"
    assert tt.grad_step.names == [p.algo for p in tt._plans]
    kinds = [e["event"] for e in tt.run_journal.entries]
    assert kinds.count("calibration") == 1
    assert kinds.count("autotune_decision") == 2
    assert kinds.index("autotune_decision") < kinds.index("step")
    assert tt.retune_events == 0
    # a retune without the tuner is still journalled
    off = loop_trainer(autotune=False)
    assert off.force_retune(5, trigger="manual") is None
    ev = [e for e in off.run_journal.entries if e["event"] == "retune"]
    assert ev == [{"event": "retune", "step": 5, "trigger": "manual",
                   "signals": [], "cleared": "autotuner"}]
    assert off.autotuner is None and off._plans is None


def test_resize_drops_the_tuner_keeps_the_plan():
    tt = loop_trainer(num_workers=4)
    plans = tt.autotune(step=0, fake_ms=crossover_fake_ms)
    tt.resize_workers(StackedComm(2), trigger="manual", step=1)
    assert tt.autotuner is None and tt._plans is plans
    assert tt.grad_step.names == [p.algo for p in plans]
    ev = [e for e in tt.run_journal.entries if e["event"] == "remesh"]
    assert ev[0]["reinitialised"] == ["sparse_state", "local_momentum",
                                      "autotuner"]
    # the next cadence point re-tunes on the new topology, through the
    # remembered seam
    tt.maybe_autotune(2)
    assert tt.autotuner is not None and tt.autotuner.num_workers == 2
    assert [p.key() for p in tt._plans] == [p.key() for p in plans]


def test_cli_trains_with_autotune_and_feedback(tmp_path):
    journal = tmp_path / "run.jsonl"
    decisions = tmp_path / "decisions.jsonl"
    argv = ["--dnn", "mnistnet", "--dataset", "mnist", "--data-dir",
            str(tmp_path / "none"), "--device", "cpu", "--num-workers", "2",
            "--batch-size", "2", "--max-iters", "3", "--warmup-steps", "0",
            "--num-buckets", "2", "--autotune", "--autotune-trial-steps",
            "1", "--autotune-journal", str(decisions),
            "--resilience-feedback", "--obs", "--obs-journal", str(journal),
            "--logdir", str(tmp_path / "logs"), "--log-every", "1"]
    assert main_trainer.main(argv) == 0
    events = [json.loads(ln)["event"] for ln in journal.read_text()
              .splitlines()]
    assert events.count("autotune_decision") == 2
    assert events.count("calibration") == 1 and events.count("step") == 3
    own = [json.loads(ln)["event"] for ln in decisions.read_text()
           .splitlines()]
    assert own == ["header", "calibration", "decision", "decision"]
