"""The port's chaos drills and density backoff against the JAX
package's.

- ``DensityBackoff``: one pressure script replayed through both
  packages' controllers gives the same level changes and state;
- the catalog names JAX's four drills, and ``latency_retune`` passes
  every check on two stacked workers;
- the drills ``chip_loss`` (8 -> 7 stacked workers), ``density_backoff``
  (4 workers), ``ckpt_corruption`` (8 workers) and ``latency_retune`` (4
  workers), each on both packages: every check of the port's report
  holds, and its journal is JAX's drill's event for event — the same
  events in the same order with the same steps, skips, strikes, buckets,
  levels, scales, worlds, re-initialised states, checkpoint names,
  restore depths, regressions, re-tune triggers and evidence, and the
  autotune decisions (bucket, n, the candidates, chosen, incumbent,
  reason, their fake-seam times). The values that are not decisions are
  left out: losses and ``reduced_absmax`` (H1), file sizes, digests and
  timings, directory names, and what the calibration measured (the
  fitted alpha, beta and residual, each package's own host clock over
  its own pmean) with the cost-model prior priced from it
  (``predicted_ms``, which also orders the journal's candidate list: the
  candidates are compared as a set sorted by name).

Both packages' drills run on the narrow VGG of ``test_torch_vgg.py``
(their model is the module constant ``DEFAULT_DNN``): mnistnet's oktopk
step with every cadence at 1 takes seconds on one CPU thread at P = 8,
and the drills' decisions come from their fault plans, not the model.
"""

from __future__ import annotations

import os

import pytest
import torch

from oktopk_tpu.resilience import DensityBackoff as JBackoff
from oktopk_tpu.resilience import drills as jdrills
from oktopk_tpu_torch.resilience import DensityBackoff
from oktopk_tpu_torch.resilience import drills

from test_torch_dist import narrow_models

DROP = {"loss", "reduced_absmax", "bytes", "digest", "duration_ms", "jax",
        "jaxlib", "torch", "cuda", "device_kind", "platform", "world_size",
        "alpha", "beta", "residual", "predicted_ms"}


@pytest.fixture(autouse=True, scope="module")
def narrow_one_thread_jitted_init():
    """The narrow VGG in both packages' registries and as both drill
    modules' ``DEFAULT_DNN``, torch on one thread, and the JAX Trainer's
    model init under ``jax.jit`` (op by op it takes seconds;
    ``tests/test_torch_checkpoint.py`` does the same)."""
    import jax

    from oktopk_tpu.train.trainer import Trainer as JTrainer

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    eager = JTrainer._init_variables
    with pytest.MonkeyPatch.context() as mp:
        narrow_models(mp)
        for mod in (jdrills, drills):
            mp.setattr(mod, "DEFAULT_DNN", "vgg_narrow")
        mp.setattr(JTrainer, "_init_variables", lambda self, r, b: jax.jit(
            lambda rr, bb: eager(self, rr, bb))(r, b))
        yield
    torch.set_num_threads(old)


# ---- the density backoff ----------------------------------------------------

# (DensityBackoff kwargs, script of (method, step, value, skipped))
SCRIPTS = {
    "near_band": (dict(abs_limit=100.0, near_ratio=0.5, backoff_steps=2,
                       factor=0.5, max_level=2, clean_streak=3),
                  [("observe", s, v, 0) for s, v in enumerate(
                      [90, 90, 90, 90, 90, 90, 1, 1, 1, 1, 90, 1, 1, 1],
                      start=1)]),
    "skips_and_nan": (dict(abs_limit=100.0, backoff_steps=2),
                      [("observe", 1, float("nan"), 1),
                       ("observe", 2, float("nan"), 1),
                       ("observe", 3, 5.0, 0)]),
    "quality_breaches": (dict(abs_limit=100.0, backoff_steps=2,
                              max_level=3, clean_streak=50),
                         [("observe", s, 95.0, 0) for s in range(1, 7)]
                         + [("note_quality_breach", 7, "churn_spike", 0),
                            ("note_quality_breach", 8, "comp_err", 0),
                            ("note_quality_breach", 9, "residual_growth",
                             0),
                            ("note_quality_breach", 10, "comp_err", 0),
                            ("observe", 11, 1.0, 0)]),
}


def _replay(db, script):
    out = []
    for name, step, v, skipped in script:
        if name == "observe":
            out.append(db.observe(step, absmax=v, skipped=skipped))
        else:
            out.append(db.note_quality_breach(step, v))
    return out + [(db.level, db.scale, db._near, db._clean, db._fidelity)]


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_density_backoff_matches_jax(name):
    kw, script = SCRIPTS[name]
    got = _replay(DensityBackoff(**kw), script)
    assert got == _replay(JBackoff(**kw), script)
    assert any(c is not None for c in got[:-1])


@pytest.mark.parametrize("kw", [dict(factor=1.5), dict(factor=0.0),
                                dict(backoff_steps=0), dict(max_level=0),
                                dict(clean_streak=0)])
def test_density_backoff_validation_matches_jax(kw):
    for cls in (DensityBackoff, JBackoff):
        with pytest.raises(ValueError):
            cls(abs_limit=100.0, **kw)


# ---- the catalog ---------------------------------------------------------

def test_catalog_names_jax_drills():
    """The catalog is JAX's, and ``latency_retune`` runs: its plan goes
    oktopk -> dense on two stacked workers, every check passing."""
    assert set(drills.DRILLS) == set(jdrills.DRILLS)
    with pytest.raises(KeyError):
        drills.run_drill("meteor_strike")
    report = drills.run_drill("latency_retune", workers=2, device="cpu")
    assert report.ok, "\n" + report.summary()
    assert report.notes["plan"] == "oktopk->dense"


# ---- the drills on both packages ----------------------------------------

def decisions(journal):
    """The journal's events less what is not a decision (module
    docstring)."""
    out = []
    for e in journal:
        d = {k: v for k, v in e.items() if k not in DROP}
        for k in ("path", "ckpt"):
            if isinstance(d.get(k), str):
                d[k] = os.path.basename(d[k])
        if "reason" in d:
            d["reason"] = d["reason"].split(":")[0]
        if "candidates" in d:
            d["candidates"] = sorted(
                ({k: v for k, v in c.items() if k not in DROP}
                 for c in d["candidates"]),
                key=lambda c: (c["algo"], c["density"]))
        out.append(d)
    return out


DRILL_RUNS = {"chip_loss": ("mesh8", 8), "density_backoff": ("mesh4", 4),
              "ckpt_corruption": ("mesh8", 8),
              "latency_retune": ("mesh4", 4)}


@pytest.mark.chaos
@pytest.mark.parametrize("name", list(DRILL_RUNS))
def test_drill_matches_jax(name, request):
    mesh_name, P = DRILL_RUNS[name]
    report = drills.run_drill(name, workers=P, device="cpu")
    assert report.ok, "\n" + report.summary()
    # JAX's contrast run (a second Trainer, outside the journal) is the
    # port's own to show; JAX's is left out
    kw = {"include_contrast": False} if name == "density_backoff" else {}
    jreport = jdrills.run_drill(name, mesh=request.getfixturevalue(mesh_name),
                                **kw)
    assert jreport.ok, "\n" + jreport.summary()
    jchecks = [c[0] for c in jreport.checks]
    assert [c[0] for c in report.checks][:len(jchecks)] == jchecks
    assert decisions(report.journal) == decisions(jreport.journal)
    if name == "density_backoff":
        assert report.notes["skipped"] == jreport.notes["skipped"]
        assert report.notes["guarded_param_absmax"] < 1e3
    if name == "latency_retune":
        assert report.notes == jreport.notes
    if name == "chip_loss":
        rm = [e for e in report.journal if e["event"] == "remesh"]
        assert "autotuner" in rm[0]["reinitialised"]


def test_port_chaos_drill_cli(capsys):
    """``scripts/port_chaos_drill.py``: ``--list`` names the catalog,
    ``--drill chip_loss --json`` and ``--drill latency_retune --json``
    pass on the CPU."""
    import importlib.util
    import json

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "port_chaos_drill.py")
    spec = importlib.util.spec_from_file_location("port_chaos_drill", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    assert cli.main(["--list"]) == 0
    listed = capsys.readouterr().out.split("\n")
    assert sorted(line.split()[0] for line in listed if line) == sorted(
        drills.DRILLS)
    assert cli.main(["--drill", "chip_loss", "--json", "--device",
                     "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["drill"] == "chip_loss" and out["ok"]
    assert cli.main(["--drill", "latency_retune", "--json", "--device",
                     "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["drill"] == "latency_retune" and out["ok"]
    assert out["notes"]["plan"] == "oktopk->dense"
