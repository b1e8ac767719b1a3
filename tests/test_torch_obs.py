"""The port's run-journal plane against the JAX package's, on the same
inputs: the event schemas and validator (``obs/events.py``), the bus,
the run journal and the decision journal (``obs/journal.py``,
``autotune/journal.py``), the quality rollups (``obs/rollup.py``), the
Prometheus export (``obs/export.py``), the regression detector
(``obs/regress.py``), the logger (``utils/logging.py``) and the
profiling helpers (``utils/profiling.py``).

These modules are host-side Python; where the port's copy computes what
JAX's does, the results are held equal (dicts, messages, bytes), with
no tolerance. ``TraceWindow`` runs over ``torch.profiler`` here (JAX's
over ``jax.profiler``), so it is held to its own contract: a Chrome
trace on the CPU, and a no-op when the profiler cannot start.
"""

from __future__ import annotations

import json
import logging
import os
import re

import numpy as np
import pytest
import torch

from oktopk_tpu.autotune import journal as jax_ajournal
from oktopk_tpu.obs import events as jax_events
from oktopk_tpu.obs import export as jax_export
from oktopk_tpu.obs import journal as jax_journal
from oktopk_tpu.obs import regress as jax_regress
from oktopk_tpu.obs import rollup as jax_rollup
from oktopk_tpu.utils import logging as jax_logging
from oktopk_tpu.utils import profiling as jax_prof

from oktopk_tpu_torch.autotune import journal as ajournal
from oktopk_tpu_torch.obs import events, export, journal, regress, rollup
from oktopk_tpu_torch.utils import logging as tlogging
from oktopk_tpu_torch.utils import profiling as prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a fixed JAX-style header: the JAX package's own environment_header
# queries its backend, which the comparisons below do not need
JAX_HEADER = {"event": "header", "jax": "0.9.0", "jaxlib": "0.9.0",
              "device_kind": "cpu", "platform": "cpu", "world_size": 8,
              "schema_version": 1}


# ---- the schemas and the validator ---------------------------------------

def test_schemas_equal_jax():
    assert events.SCHEMA_VERSION == jax_events.SCHEMA_VERSION
    assert events.EVENT_SCHEMAS.keys() == jax_events.EVENT_SCHEMAS.keys()
    for name, schema in jax_events.EVENT_SCHEMAS.items():
        assert events.EVENT_SCHEMAS[name] == schema, name


# JAX's reject cases (tests/test_obs_schema.py, TestValidatorRejects),
# and the cases it accepts
ENTRIES = {
    "unknown event": {"event": "teleport", "step": 1},
    "missing event field": {"step": 1},
    "not a dict": ["step", 1],
    "missing required field": {"event": "fallback", "step": 1,
                               "bucket": 0, "algo": "dense"},
    "wrong type": {"event": "guard_trip", "step": 1, "buckets": "zero",
                   "consecutive_skips": 1, "strikes": []},
    "extra fields allowed": {"event": "step", "step": 1,
                             "my_custom_metric": 3.0},
    "quality missing bucket": {"event": "quality", "step": 8,
                               "comp_err": [0.1]},
    "quality null samples": {"event": "quality", "step": 8, "bucket": 0,
                             "algo": "oktopk", "count": 2, "steps": [7, 8],
                             "comp_err": [None, 0.2], "skipped": [1, 0]},
    "rollup without breaches": {"event": "quality_rollup", "step": 8,
                                "bucket": 0},
    "rollup breaches not a list": {"event": "quality_rollup", "step": 8,
                                   "bucket": 0, "breaches": "comp_err"},
    "baseline warning": {"event": "baseline_warning", "step": 0,
                         "key": "oktopk_ms", "reason": "no records",
                         "files": 0, "malformed": []},
    "baseline warning bare": {"event": "baseline_warning", "step": 0},
    "optional of the wrong type": {"event": "volume_report", "step": 1,
                                   "bucket": 0, "algo": "oktopk",
                                   "level": 3},
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_validate_event_messages_match_jax(name):
    entry = ENTRIES[name]
    assert events.validate_event(entry) == jax_events.validate_event(entry)


def _journals():
    hdr = dict(JAX_HEADER)
    port_hdr = {"event": "header", **ajournal.environment_header()}
    step = {"event": "step", "step": 1}
    return {"empty": [], "no header": [step], "two headers": [hdr, hdr, step],
            "jax header": [hdr, step], "port header": [port_hdr, step],
            "header last": [step, port_hdr],
            "a bad entry": [port_hdr, step, {"event": "teleport"}]}


@pytest.mark.parametrize("name", list(_journals()))
def test_validate_journal_messages_match_jax(name):
    entries = _journals()[name]
    got = events.validate_journal(entries)
    assert got == jax_events.validate_journal(entries)
    assert (got == []) == (name in ("jax header", "port header"))


def test_port_header_names_its_stack():
    hdr = ajournal.environment_header()
    assert hdr["jax"] is None
    assert hdr["torch"] == torch.__version__
    assert hdr["cuda"] == torch.version.cuda
    assert hdr["platform"] == "cpu" and hdr["device_kind"] == "cpu"
    assert hdr["world_size"] == 1
    assert hdr["schema_version"] == jax_events.SCHEMA_VERSION
    assert jax_events.validate_event({"event": "header", **hdr}) == []


def test_every_emitted_event_name_has_a_schema():
    """Every ``.emit("name"`` / ``.record("name"`` call site with a
    literal event name in the port (and in ``chip_smoke.py``) has a
    schema, as ``tests/test_obs_schema.py`` checks for the JAX package."""
    pat = re.compile(r"\.(?:emit|record)\(\s*[\"']([a-z_]+)[\"']")
    found = {}
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(ROOT,
                                                   "oktopk_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for m in pat.finditer(f.read()):
                found.setdefault(m.group(1), []).append(path)
    for known in ("step", "phase", "quality", "quality_rollup",
                  "volume_report", "baseline_warning", "regression"):
        assert known in found, f"scan missed the {known} emitter"
    unknown = {n: p for n, p in found.items()
               if n not in events.EVENT_SCHEMAS}
    assert not unknown, unknown


# ---- the bus and the journals --------------------------------------------

def _drive_bus(mod_journal, mod_ajournal, path):
    """The same sequence of emits through one package's bus and journals:
    a failing subscriber, a nested emit, a relayed header, a decision
    journal forwarding onto the bus."""
    bus = mod_journal.EventBus()
    rj = mod_journal.RunJournal(path, bus=bus)

    def bad(entry):
        raise RuntimeError("boom")

    def nested(entry):
        if entry["event"] == "quality":
            bus.emit("quality_rollup", step=entry["step"],
                     bucket=entry["bucket"], breaches=[])

    bus.subscribe(bad)
    bus.subscribe(nested)
    bus.emit("step", step=1, loss=2.5)
    bus.emit("header", jax=None)          # relayed: never journalled
    bus.emit("quality", step=2, bucket=0, count=1)
    dj = mod_ajournal.DecisionJournal(None, header=False, bus=bus)
    dj.record("decision", step=3, bucket=0, chosen={"algo": "oktopk"},
              reason="plan")
    rj.record("phase", step=4, phases={})
    return bus, rj


def test_bus_and_run_journal_match_jax(tmp_path):
    bus, rj = _drive_bus(journal, ajournal, str(tmp_path / "p.jsonl"))
    jbus, jrj = _drive_bus(jax_journal, jax_ajournal,
                           str(tmp_path / "j.jsonl"))
    assert bus.dropped == jbus.dropped == 5
    got, want = rj.entries, jrj.entries
    assert got[0]["event"] == "header" and got[0]["jax"] is None
    assert got[1:] == want[1:]
    assert [e["event"] for e in got[1:]] == [
        "step", "quality", "quality_rollup", "autotune_decision", "phase"]
    assert ajournal.read_journal(str(tmp_path / "p.jsonl")) == got
    assert jax_events.validate_journal(got) == []
    assert events.validate_journal(got) == []


def test_decision_journal_file_matches_jax(tmp_path):
    for mod, name in ((ajournal, "p"), (jax_ajournal, "j")):
        dj = mod.DecisionJournal(str(tmp_path / f"{name}.jsonl"),
                                 header=False)
        dj.record("calibration", step=0, alpha=1e-6, beta=1e-11)
        dj.record("decision", step=1, bucket=0, chosen={"algo": "dense"},
                  reason="trial")
    assert (tmp_path / "p.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()


# ---- quality rollups --------------------------------------------------------

def quality_events(seed: int):
    """Flushed ``quality`` events: random windows with nulls, skipped rows
    and values that cross every breach limit."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(12):
        count = int(rng.randint(1, 6))
        scale = [0.2, 3.0][i % 2]

        def col(lo, hi):
            vals = [float(v) for v in rng.uniform(lo, hi, count) * scale]
            if count > 2:
                vals[1] = None
            return vals
        ev = {"step": 4 * (i + 1), "bucket": i % 3, "algo": "oktopk",
              "count": count, "steps": list(range(count)),
              "comp_err": col(0.0, 0.6), "res_norm": col(0.0, 2.0),
              "res_growth": col(0.5, 1.0), "eff_density": col(0.0, 0.01),
              "thr_drift": col(0.8, 1.2), "churn": col(0.0, 0.5),
              "skipped": [int(v) for v in rng.randint(0, 2, count)]}
        if i == 5:
            ev.pop("algo")
            ev["res_norm"] = [0.0] * count
        out.append(ev)
    return out


@pytest.mark.parametrize("kw", [
    {}, dict(growth_limit=0.9, collapse_ratio=0.9, churn_limit=0.2,
             comp_err_limit=0.3)])
def test_rollups_and_breaches_match_jax(kw):
    got_hook, want_hook = [], []
    bus, jbus = journal.EventBus(), jax_journal.EventBus()
    rj = journal.RunJournal(None, bus=bus, header=False)
    jrj = jax_journal.RunJournal(None, bus=jbus, header=False)
    eng = rollup.RollupEngine(bus, on_breach=lambda *a: got_hook.append(a),
                              **kw)
    jeng = jax_rollup.RollupEngine(
        jbus, on_breach=lambda *a: want_hook.append(a), **kw)
    eng.target_densities = jeng.target_densities = [0.02, 0.01]
    for ev in quality_events(3):
        bus.emit("quality", **ev)
        jbus.emit("quality", **ev)
    assert eng.rollups == jeng.rollups
    assert rj.entries == jrj.entries
    assert got_hook == want_hook and eng.breached == jeng.breached
    assert bus.dropped == jbus.dropped == 0
    kinds = {b for r in eng.rollups for b in r["breaches"]}
    if kw:
        assert kinds == {"residual_growth", "density_collapse",
                         "churn_spike", "comp_err"}
    for ev in quality_events(4):
        assert rollup.rollup_quality_event(ev, target_density=0.02, **kw) \
            == jax_rollup.rollup_quality_event(ev, target_density=0.02, **kw)


# ---- the Prometheus export ---------------------------------------------------

def _export_entries():
    jbus = jax_journal.EventBus()
    jrj = jax_journal.RunJournal(None, bus=jbus, header=False)
    jax_rollup.RollupEngine(jbus, churn_limit=0.2)
    for ev in quality_events(5):
        jbus.emit("quality", **ev)
    jbus.emit("step_anatomy", step=9, bucket=0, phases={
        "select": {"ms": 1.25, "count": 2, "lane": "compute"},
        "exchange": {"ms": 3.5, "count": 1, "lane": "comm"},
        "fwd_bwd": 70.0, "bad": {"ms": float("nan")}})
    jbus.emit("overlap_report", step=9, compute_ms=71.25, comm_ms=3.5,
              overlap_ms=0.5, overlap_ratio=0.5 / 3.5, step_ms=74.25,
              ideal_ms=71.25, serialization_ms=3.0)
    return jrj.entries


def test_prometheus_text_byte_equal_jax(tmp_path):
    entries = _export_entries()
    text = export.render_prometheus(entries)
    assert text == jax_export.render_prometheus(entries)
    assert "oktopk_quality_breaches_total" in text
    assert "oktopk_anatomy_overlap_ratio" in text
    assert export.render_prometheus([]) == jax_export.render_prometheus(
        []) == ""
    p = export.write_textfile(entries, str(tmp_path / "p" / "q.prom"))
    j = jax_export.write_textfile(entries, str(tmp_path / "j" / "q.prom"))
    assert open(p, "rb").read() == open(j, "rb").read()
    assert not os.path.exists(p + ".tmp")


# ---- the regression detector -------------------------------------------------

def _plant_bench(root):
    recs = {"BENCH_r01.json": {"parsed": {"oktopk_ms": 100.0}},
            "BENCH_r02.json": {"parsed": {"oktopk_ms": 120.0,
                                          "dense_ms": 50.0}},
            "BENCH_r03.json": {"oktopk_ms": 90.0, "parsed": None},
            "BENCH_r04.json": ["not", "a", "dict"],
            "BENCH_r05.json": {"parsed": {"oktopk_ms": True}}}
    for name, rec in recs.items():
        (root / name).write_text(json.dumps(rec))
    (root / "BENCH_r06.json").write_text("{torn")


def _observe(mod_journal, mod_regress, root, key):
    bus = mod_journal.EventBus()
    rj = mod_journal.RunJournal(None, bus=bus, header=False)
    det = mod_regress.RegressionDetector.from_bench_records(
        key=key, root=str(root), bus=bus, tolerance=1.5,
        quality_limits={"comp_err_mean": 0.5, "churn_mean": 0.0},
        phase_limits={"step": 120.0, "data": 1.0})
    for s, ms in enumerate([500.0, 90.0, 100.0, 151.0, 160.0, 140.0, 400]):
        det.observe(s + 1, ms)
    det.observe_quality(8, {"comp_err_mean": 0.7, "churn_mean": 0.9,
                            "thr_drift_mean": 3.0})
    det.observe_quality(9, {"comp_err_mean": float("nan")})
    det.observe_phases(10, {"step": {"mean_ms": 130.0, "count": 4.0},
                            "data": 0.5, "fwd_bwd": 999.0})
    det.observe_phases(11, {"step": {"ms": 110.0}, "data": True})
    return det, rj.entries


@pytest.mark.parametrize("key", ["oktopk_ms", "dense_ms", "missing_ms"])
def test_regression_detector_matches_jax(tmp_path, key):
    _plant_bench(tmp_path)
    got = regress.scan_bench_records(key, root=str(tmp_path))
    assert got == jax_regress.scan_bench_records(key, root=str(tmp_path))
    det, ents = _observe(journal, regress, tmp_path, key)
    jdet, jents = _observe(jax_journal, jax_regress, tmp_path, key)
    assert det.baseline_ms == jdet.baseline_ms
    assert det.flagged == jdet.flagged
    assert ents == jents
    warned = [e for e in ents if e["event"] == "baseline_warning"]
    assert bool(warned) == (key == "missing_ms")
    assert all(events.validate_event(e) == [] for e in ents)


def test_regression_detector_without_records(tmp_path):
    det, ents = _observe(journal, regress, tmp_path, "oktopk_ms")
    jdet, jents = _observe(jax_journal, jax_regress, tmp_path, "oktopk_ms")
    assert det.baseline_ms is None and det.flagged == jdet.flagged
    assert ents == jents
    assert ents[0]["event"] == "baseline_warning"
    assert ents[0]["reason"] == "no BENCH records"


def test_default_root_is_the_repository():
    """Without ``root`` both read the repository's own BENCH_r*.json (the
    JAX package's records)."""
    assert regress.scan_bench_records("oktopk_ms") == \
        jax_regress.scan_bench_records("oktopk_ms")
    assert regress._REPO_ROOT == jax_regress._REPO_ROOT == ROOT


# ---- the logger --------------------------------------------------------------

def test_get_logger_matches_jax(tmp_path):
    """The same format, and a file attached by a later call; with
    ``console=False`` the file alone."""
    a = tlogging.get_logger("port_obs_test_a")
    j = jax_logging.get_logger("port_obs_test_j")
    try:
        assert a.handlers[0].formatter._fmt == j.handlers[0].formatter._fmt
        tlogging.get_logger("port_obs_test_a", str(tmp_path / "a.log"))
        jax_logging.get_logger("port_obs_test_j", str(tmp_path / "j.log"))
        tlogging.get_logger("port_obs_test_a", str(tmp_path / "a.log"))
        assert len(a.handlers) == len(j.handlers) == 2
        a.info("hello")
        assert (tmp_path / "a.log").read_text().endswith(
            "INFO port_obs_test_a: hello\n")
        q = tlogging.get_logger("port_obs_test_q", str(tmp_path / "q.log"),
                                console=False)
        assert [type(h) for h in q.handlers] == [logging.FileHandler]
        assert not q.propagate
        q.warning("quiet")
        assert "WARNING port_obs_test_q: quiet" in \
            (tmp_path / "q.log").read_text()
    finally:
        for lg in (a, j, logging.getLogger("port_obs_test_q")):
            for h in list(lg.handlers):
                lg.removeHandler(h)
                h.close()


# ---- the profiling helpers ---------------------------------------------------

def _timers(mod):
    t = mod.PhaseTimers(every=4)
    rng = np.random.RandomState(0)
    for d in rng.uniform(0.001, 0.2, 23):
        t.add("step", float(d))
    for d in rng.uniform(0.0001, 0.01, 5):
        t.add("data", float(d))
    t.add("eval", 1.5)
    _ = t._samples["idle"]           # a phase with no samples
    return t


def test_phase_timers_table_and_summary_match_jax():
    t, j = _timers(prof), _timers(jax_prof)
    assert t.table() == j.table()
    assert t.summary() == j.summary()
    with t.phase("host"):
        pass
    assert t.summary()["host"]["count"] == 1.0
    lg = logging.getLogger("port_obs_test_timers")
    assert t.maybe_log(8, lg) and not t._samples
    assert not t.maybe_log(9, lg)


def test_scalars_csv_byte_equal_jax(tmp_path):
    rows = [(s, {"loss": 2.0 / s, "comm_volume": 1e6 + s, "local_k": 7,
                 "grad_nonfinite": 0.0, "eps": float("nan")})
            for s in range(1, 6)]
    for mod, name in ((prof, "p"), (jax_prof, "j")):
        d = str(tmp_path / name)
        with mod.MetricWriter(d) as w:
            for s, r in rows[:3]:
                w.write(s, r)
        with mod.MetricWriter(d) as w:          # a resume: appends
            for s, r in rows[3:]:
                w.write(s, r)
        with mod.MetricWriter(d) as w:          # another metric set: rotates
            w.write(6, {"loss": 0.25})
    for f in ("scalars.csv", "scalars-1.csv"):
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f


def _chrome_names(path):
    with open(path) as f:
        trace = json.load(f)
    return {e.get("name") for e in trace["traceEvents"]}


def test_trace_window_writes_a_chrome_trace_on_the_cpu(tmp_path):
    tw = prof.TraceWindow(str(tmp_path / "trace"), start_step=2,
                          num_steps=2)
    x = torch.randn(32, 32)
    for step in range(1, 6):
        tw.on_step(step)
        x = torch.mm(x, x).tanh()
        if step == 3:
            assert tw.path is None          # still open
    tw.close()
    assert tw.path == str(tmp_path / "trace" / "trace_steps2-3.json")
    assert "aten::mm" in _chrome_names(tw.path)
    with prof.trace_window(str(tmp_path / "block")):
        torch.mm(x, x)
    assert "aten::mm" in _chrome_names(tmp_path / "block" / "trace.json")


def test_trace_window_is_a_noop_when_the_profiler_cannot_start(
        tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    # another profiler is running: the window leaves it alone
    outer = profile(activities=[ProfilerActivity.CPU])
    outer.start()
    try:
        tw = prof.TraceWindow(str(tmp_path / "nested"), 1, 1)
        tw.on_step(1)
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
        tw.on_step(2)
        assert tw.path is None
        assert torch.autograd._profiler_enabled()
    finally:
        outer.stop()
    assert "aten::mm" in {e.name for e in outer.events()}

    # starting raises: the traced code runs, nothing is written
    def refuse(self):
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(profile, "start", refuse)
    ran = []
    with prof.trace_window(str(tmp_path / "refused")):
        ran.append(1)
    tw = prof.TraceWindow(str(tmp_path / "refused_w"), 1, 1)
    tw.on_step(1)
    tw.on_step(2)
    tw.close()
    assert ran == [1] and tw.path is None
    assert not (tmp_path / "refused").exists()
    assert not (tmp_path / "refused_w").exists()


def test_memory_stats():
    assert prof.device_memory_stats("cpu") == {}
    assert prof.device_memory_stats(torch.device("cpu")) == {}
    got, want = prof.host_memory_stats(), jax_prof.host_memory_stats()
    assert got.keys() == want.keys() == {"host_rss_bytes"}
