"""The port's step anatomy (``oktopk_tpu_torch/obs/anatomy.py``) against
the JAX package's ``oktopk_tpu/obs/anatomy.py``.

- the naming contract, for every phase x bucket x level: the same names,
  and both parsers read each name (and JAX's compiled-HLO op paths) the
  same way;
- the analyser on JAX's fixture (``tests/data/anatomy_trace.json``):
  JAX's dict exactly, the same journal events, and JAX's warnings on the
  malformed, missing, gzip and bare-list traces;
- a torch-shaped trace (each range on the host thread and on the stream)
  gives JAX's result on its device copies alone; with device activities
  in the trace, each is read under the innermost device range on its
  stream; nested ranges on one lane are counted once;
- the set of (phase, bucket, level) tuples in a CPU ``torch.profiler``
  trace of one port step equals the set parsed from JAX's compiled HLO
  op names (as ``tests/test_anatomy.py`` lowers it), for oktopk, gtopk,
  topkA, gaussiank, topkSA, dense and hierarchical with an oktopk outer,
  and for a two-bucket Trainer step (fwd_bwd, the bucket containers,
  optimizer);
- a step with annotations on (under a running profiler, so the ranges
  really open) is bit-identical to one with them off;
- the pipeline capture and ``ChromeTraceSink``'s lanes.

Every comparison here is exact: the analyser and the contract are
integer and float bookkeeping over the same event times, and the phase
sets are sets of names.
"""

from __future__ import annotations

import gzip
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from oktopk_tpu.obs import anatomy as janat
from oktopk_tpu.obs.events import validate_journal as jax_validate
from oktopk_tpu.obs.journal import EventBus as JBus
from oktopk_tpu.obs.journal import RunJournal as JJournal
from oktopk_tpu_torch.obs import anatomy
from oktopk_tpu_torch.obs.events import validate_journal
from oktopk_tpu_torch.obs.journal import EventBus, RunJournal

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "anatomy_trace.json")
N, P = 512, 8
COMPRESSORS = ("oktopk", "gtopk", "topkA", "gaussiank", "topkSA", "dense",
               "hierarchical")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _fixture_events():
    with open(FIXTURE) as f:
        return json.load(f)["traceEvents"]


def _journal_view(entries):
    """The journal entries without their wall-clock stamps."""
    return [{k: v for k, v in e.items() if k not in ("t", "time", "ts")}
            for e in entries if e["event"] != "header"]


# ---- the naming contract ----------------------------------------------------

def test_constants_are_jax():
    assert anatomy.SCOPE_PREFIX == janat.SCOPE_PREFIX
    assert anatomy.PHASES == janat.PHASES
    assert anatomy.COLLECTIVE_PHASES == janat.COLLECTIVE_PHASES
    assert anatomy._COLLECTIVE_OPS.pattern == janat._COLLECTIVE_OPS.pattern
    assert anatomy.annotations_enabled() == janat.annotations_enabled()


@pytest.mark.parametrize("level", (None, 0, 1))
@pytest.mark.parametrize("bucket", (None, 0, 7, 123))
@pytest.mark.parametrize("phase", (None,) + janat.PHASES)
def test_naming_contract(phase, bucket, level):
    name = anatomy.scope_name(phase, bucket, level)
    assert name == janat.scope_name(phase, bucket, level)
    assert anatomy.parse_scope_level(name) == janat.parse_scope_level(
        name) == (phase, bucket, level)
    assert anatomy.parse_scope(name) == janat.parse_scope(name)
    assert anatomy.lane_of(phase, name) == janat.lane_of(phase, name)
    # a compiled-HLO op path nesting the name under a bucket container
    nested = f"jit(step)/{anatomy.scope_name(None, 3)}/{name}/add"
    assert anatomy.parse_scope_level(nested) == janat.parse_scope_level(
        nested)


@pytest.mark.parametrize("name", [
    "jit(f)/transpose/mul", 42, None, "anat/b0x1/select",
    "anat/lvl1/anat/b002/exchange", "jit(step)/anat/b000/anat/select/add",
    "anat/b000/all-to-all.1", "anat/b000/lvl1/anat/b000/stage/x"])
def test_parse_odd_names(name):
    assert anatomy.parse_scope_level(name) == janat.parse_scope_level(name)
    if isinstance(name, str):
        assert anatomy.lane_of(None, name) == janat.lane_of(None, name)


# ---- the analyser -----------------------------------------------------------

def test_fixture_analysis_is_jax():
    events = _fixture_events()
    got = anatomy.analyze_events(events)
    assert got == janat.analyze_events(events)
    assert anatomy.phase_totals(got) == janat.phase_totals(got)


def test_fixture_journal_is_jax():
    bus, jbus = EventBus(), JBus()
    journal, jjournal = RunJournal(None, bus), JJournal(None, jbus)
    a = anatomy.analyze_capture(FIXTURE, bus=bus, step=7, source="fixture")
    ja = janat.analyze_capture(FIXTURE, bus=jbus, step=7, source="fixture")
    assert a == ja
    assert _journal_view(journal.entries) == _journal_view(jjournal.entries)
    assert validate_journal(journal.entries) == []
    assert jax_validate(journal.entries) == []
    assert anatomy.load_trace_events(FIXTURE) == janat.load_trace_events(
        FIXTURE)


@pytest.mark.parametrize("payload", [
    "not json at all {{{",
    '{"traceEvents": "not a list"}',
    '{"traceEvents": []}',
    '[{"name": "no_anatomy_here", "ph": "X", "ts": 0, "dur": 5}]',
])
def test_malformed_trace_warns_as_jax(tmp_path, payload):
    p = tmp_path / "broken.trace.json"
    p.write_text(payload)
    bus, jbus = EventBus(), JBus()
    journal, jjournal = RunJournal(None, bus), JJournal(None, jbus)
    assert anatomy.analyze_capture(str(p), bus=bus) is None
    assert janat.analyze_capture(str(p), bus=jbus) is None
    warns = _journal_view(journal.entries)
    assert len(warns) == 1 and warns[0]["event"] == "anatomy_warning"
    assert warns == _journal_view(jjournal.entries)
    assert jax_validate(journal.entries) == []


def test_missing_path_warns_as_jax(tmp_path):
    bus, jbus = EventBus(), JBus()
    journal, jjournal = RunJournal(None, bus), JJournal(None, jbus)
    missing = str(tmp_path / "nope")
    assert anatomy.analyze_capture(missing, bus=bus) is None
    assert janat.analyze_capture(missing, bus=jbus) is None
    assert _journal_view(journal.entries) == _journal_view(jjournal.entries)
    assert journal.entries[-1]["event"] == "anatomy_warning"


def test_gzip_and_bare_list_as_jax(tmp_path):
    events = [{"name": "anat/select", "ph": "X", "ts": 0.0, "dur": 2000.0}]
    with gzip.open(tmp_path / "t.trace.json.gz", "wt") as f:
        json.dump(events, f)
    got = anatomy.load_trace_events(str(tmp_path))
    assert got == janat.load_trace_events(str(tmp_path))
    assert got[0] == events and got[2] is None
    a = anatomy.analyze_events(got[0])
    assert a == janat.analyze_events(got[0])
    assert a["compute_ms"] == 2.0 and a["overlap_ratio"] == 0.0


def test_finds_torch_trace_files(tmp_path):
    (tmp_path / "anomaly_step4").mkdir()
    path = tmp_path / "anomaly_step4" / "rank0.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": _fixture_events()}))
    assert anatomy.find_trace_file(str(tmp_path)) == str(path)
    assert anatomy.analyze_capture(str(tmp_path)) == \
        janat.analyze_events(_fixture_events())


def _torch_shaped(events):
    """Each contract "X" event twice, as torch.profiler writes a range on
    the card: on the host thread (earlier, shorter: the dispatch) and on
    the stream (the fixture's times)."""
    out = []
    for e in events:
        if e.get("ph") != "X" or anatomy.parse_scope_level(
                e.get("name")) is None:
            out.append(e)
            continue
        host = dict(e, cat="user_annotation", pid=118, tid=118,
                    ts=e["ts"] - 3000.0, dur=e["dur"] / 4)
        dev = dict(e, cat="gpu_user_annotation")
        out += [host, dev]
    return out


def test_torch_shaped_trace_reads_the_device_lane():
    events = _fixture_events()
    got = anatomy.analyze_events(_torch_shaped(events))
    assert got == janat.analyze_events(events)
    # without device copies (a CPU trace) the host copies are read
    host = [e for e in _torch_shaped(events)
            if e.get("cat") != "gpu_user_annotation"]
    assert anatomy.analyze_events(host) == janat.analyze_events(host)


def test_nested_ranges_are_counted_once():
    """A bucket container with two phases inside it, and a model-level
    range, on one lane: each instant belongs to the innermost range."""
    lane = dict(ph="X", pid=0, tid=7, cat="gpu_user_annotation")
    events = [
        dict(lane, name="anat/fwd_bwd", ts=0.0, dur=10000.0),
        dict(lane, name="anat/b000", ts=12000.0, dur=20000.0),
        dict(lane, name="anat/b000/select", ts=14000.0, dur=4000.0),
        dict(lane, name="anat/b000/exchange", ts=20000.0, dur=6000.0),
        # nested twice, with the same start as its parent
        dict(lane, name="anat/b000/combine", ts=26000.0, dur=2000.0),
        dict(lane, name="anat/b000/lvl1/combine", ts=26000.0, dur=1000.0),
        dict(lane, name="anat/optimizer", ts=33000.0, dur=2000.0),
    ]
    a = anatomy.analyze_events(events)
    b0 = a["buckets"][0]
    assert b0["other"]["ms"] == 8.0     # 20 ms less the 12 ms of phases
    assert b0["select"]["ms"] == 4.0 and b0["exchange"]["ms"] == 6.0
    assert b0["combine"]["ms"] == 1.0 and b0["lvl1/combine"]["ms"] == 1.0
    assert a["buckets"][-1]["fwd_bwd"]["ms"] == 10.0
    # no instant twice: the phases add up to the lane's busy time
    total = sum(d["ms"] for ph in a["buckets"].values() for d in ph.values())
    assert total == 32.0 == a["compute_ms"] + a["comm_ms"]
    assert a["overlap_ms"] == 0.0 and a["step_ms"] == 35.0
    assert sum(v for k, v in a["critical_path"].items()
               if k != "idle") == 32.0
    assert a["critical_path"]["idle"] == 3.0
    assert a["events"] == len(events)
    # the same ranges on distinct lanes overlap, as JAX counts them
    flat = [dict(e, tid=i) for i, e in enumerate(events)]
    assert anatomy.analyze_events(flat) == janat.analyze_events(flat)


def test_device_activities_name_the_innermost_range():
    """On the card each kernel, copy and fill is read under the innermost
    device range open at its start on its stream: busy time, where a
    range's span would count the idle gaps between its kernels (and
    cuDNN's second stream would count the whole fwd/bwd again)."""
    ms = 1000.0                                   # trace times are in us

    def rng(name, tid, t0, t1):
        return dict(name=name, ph="X", pid=0, tid=tid, ts=t0 * ms,
                    dur=(t1 - t0) * ms, cat="gpu_user_annotation")

    def act(tid, t0, t1, cat="kernel"):
        return dict(name="k", ph="X", pid=0, tid=tid, ts=t0 * ms,
                    dur=(t1 - t0) * ms, cat=cat)

    events = [
        rng("anat/fwd_bwd", 7, 0, 100), rng("anat/b000", 7, 110, 150),
        rng("anat/b000/select", 7, 115, 125),
        rng("anat/fwd_bwd", 13, 5, 95),
        # the host copies of the ranges, ignored on a device trace
        dict(rng("anat/fwd_bwd", 1, -50, 300), cat="user_annotation"),
        act(7, 0, 10), act(7, 90, 100, "gpu_memcpy"),
        act(7, 112, 114, "gpu_memset"), act(7, 116, 120), act(7, 130, 131),
        act(7, 200, 205),                         # under no range
        act(13, 5, 6), act(13, 94, 95),
    ]
    a = anatomy.analyze_events(events)
    assert a["buckets"][-1] == {"fwd_bwd": {"ms": 22.0, "count": 4,
                                            "lane": "compute"}}
    assert a["buckets"][0]["other"] == {"ms": 3.0, "count": 2,
                                        "lane": "compute"}
    assert a["buckets"][0]["select"]["ms"] == 4.0
    assert a["compute_ms"] == 27.0 and a["step_ms"] == 131.0
    assert a["serialization_ms"] == 104.0 and a["events"] == 7
    assert a["critical_path"]["idle"] == 104.0
    # kernels without device ranges: the host copies are read
    host_only = [e for e in events if e["cat"] != "gpu_user_annotation"]
    assert anatomy.analyze_events(host_only)["buckets"] == {
        -1: {"fwd_bwd": {"ms": 350.0, "count": 1, "lane": "compute"}}}


# ---- the phase sets of real steps -----------------------------------------

def _jax_hlo_set(text):
    names = set(re.findall(r'op_name="([^"]*)"', text))
    return {janat.parse_scope_level(x) for x in names} - {None}


def _trace_set(path):
    events, _, problem = anatomy.load_trace_events(path)
    assert problem is None
    return {anatomy.parse_scope_level(e.get("name"))
            for e in anatomy.device_events(events)} - {None}


def _traced(fn, tmp_path, name="t.json"):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / name)
    prof.export_chrome_trace(path)
    return out, path


def _configs(name):
    from oktopk_tpu.collectives.hierarchical import \
        make_hierarchical_config as jhier
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu_torch.collectives.hierarchical import \
        make_hierarchical_config
    from oktopk_tpu_torch.config import OkTopkConfig
    kw = dict(n=N, num_workers=P, warmup_steps=0, density=0.05)
    jcfg, cfg = JCfg(**kw), OkTopkConfig(**kw)
    if name == "hierarchical":
        jcfg = jhier(jcfg, num_pods=2, outer="oktopk")
        cfg = make_hierarchical_config(cfg, num_pods=2, outer="oktopk")
    return jcfg, cfg


@pytest.mark.parametrize("name", COMPRESSORS)
def test_step_phase_set_is_jax(name, devices, mesh8, tmp_path):
    from oktopk_tpu.collectives.api import \
        batched_init_state as jinit
    from oktopk_tpu.collectives.api import \
        build_allreduce_step as jbuild
    from oktopk_tpu.comm.mesh import hierarchical_mesh
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)

    jcfg, cfg = _configs(name)
    mesh = (hierarchical_mesh(2, 4, devices=devices[:8])
            if name == "hierarchical" else mesh8)
    jstep = jbuild(name, jcfg, mesh, warmup=False)
    grads = np.random.RandomState(7).randn(P, N).astype(np.float32)
    want = _jax_hlo_set(jstep.lower(jnp.asarray(grads), jinit(jcfg))
                        .compile().as_text())
    step = build_allreduce_step(name, cfg, warmup=False)
    state = batched_init_state(cfg, "cpu")
    _, path = _traced(lambda: step(torch.from_numpy(grads), state),
                      tmp_path)
    assert _trace_set(path) == want
    assert want      # the contract reached both


TRAINER = dict(dnn="mnistnet", dataset="mnist", batch_size=4, lr=0.05,
               density=0.05, num_buckets=2)


def _mnist_batch(seed=0):
    from oktopk_tpu_torch.data.synthetic import synthetic_batch
    return synthetic_batch("mnistnet", 16, np.random.RandomState(seed))


def _port_trainer(compressor="oktopk"):
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer
    return Trainer(TrainConfig(**TRAINER, compressor=compressor,
                               num_workers=4),
                   algo_cfg=OkTopkConfig(warmup_steps=0), warmup=False,
                   device="cpu")


@pytest.mark.parametrize("compressor", ("oktopk", "dense"))
def test_trainer_step_phase_set_is_jax(compressor, mesh4, tmp_path):
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    jt = JTrainer(JTrain(**TRAINER, compressor=compressor), mesh=mesh4,
                  warmup=False, algo_cfg=JCfg(warmup_steps=0))
    want = _jax_hlo_set(jt.step_fn.lower(
        jt.state, _mnist_batch(), jax.random.PRNGKey(0)).compile()
        .as_text())
    tr = _port_trainer(compressor)
    _, path = _traced(lambda: tr.train_step(_mnist_batch()), tmp_path)
    got = _trace_set(path)
    assert got == want
    assert ("fwd_bwd", None, None) in got and (None, 1, None) in got
    # the analysis of the real step journals cleanly
    bus = EventBus()
    journal = RunJournal(None, bus)
    a = anatomy.analyze_capture(path, bus=bus, step=1)
    assert set(a["buckets"]) == {-1, 0, 1}
    assert {"fwd_bwd", "optimizer"} <= set(a["buckets"][-1])
    assert jax_validate(journal.entries) == []


# ---- annotations change nothing -------------------------------------------

def test_allreduce_steps_bit_identical_on_off(tmp_path):
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)
    _, cfg = _configs("oktopk")
    cfg = cfg.replace(local_recompute_every=2, global_recompute_every=2)
    rng = np.random.RandomState(3)
    grads = [torch.from_numpy(rng.randn(P, N).astype(np.float32))
             for _ in range(3)]

    def run():
        step = build_allreduce_step("oktopk", cfg, warmup=False)
        st = batched_init_state(cfg, "cpu")
        outs = []
        for g in grads:
            out, st = step(g, st)
            outs.append(out.numpy().copy())
        return outs, st.residual.numpy().copy()

    prev = anatomy.set_annotations(True)
    try:
        (on, res_on), path = _traced(run, tmp_path)
        anatomy.set_annotations(False)
        (off, res_off), off_path = _traced(run, tmp_path, "off.json")
    finally:
        anatomy.set_annotations(prev)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res_on, res_off)
    assert _trace_set(path) and not _trace_set(off_path)


def test_trainer_steps_bit_identical_on_off(tmp_path):
    def run():
        tr = _port_trainer()
        losses = [tr.train_step(_mnist_batch(s))["loss"].item()
                  for s in range(2)]
        return losses, [p.detach().clone() for p in tr.params]

    prev = anatomy.set_annotations(True)
    try:
        (l_on, p_on), _ = _traced(run, tmp_path)
        anatomy.set_annotations(False)
        l_off, p_off = run()
    finally:
        anatomy.set_annotations(prev)
    assert l_on == l_off
    for a, b in zip(p_on, p_off):
        assert torch.equal(a, b)


def test_scopes_open_ranges_only_under_a_profiler():
    with anatomy.phase_scope("select", 0):
        assert anatomy._stack() == [("select", 0, None)]
    assert anatomy._stack() == []
    loss = torch.ones((), requires_grad=True) * 2.0
    assert anatomy.backward_scope(loss) is loss     # the CPU: no range


# ---- the pipeline capture and the sink --------------------------------------

def test_capture_pipeline_anatomy(tmp_path):
    from oktopk_tpu_torch.comm import StackedComm
    from oktopk_tpu_torch.config import OkTopkConfig
    cfg = OkTopkConfig(n=1 << 14, num_workers=4, density=0.02)
    bus = EventBus()
    journal = RunJournal(None, bus)
    a = anatomy.capture_pipeline_anatomy(
        cfg, StackedComm(4), str(tmp_path), num_buckets=2, iters=2,
        bus=bus, step=3, fwd_bwd_elems=1 << 10, device="cpu")
    assert set(a["buckets"]) == {-1, 0, 1}
    assert set(a["buckets"][-1]) == {"fwd_bwd", "optimizer"}
    for b in (0, 1):
        assert set(a["buckets"][b]) == {"select", "stage", "exchange",
                                        "combine"}
        assert all(d["count"] == 2 for d in a["buckets"][b].values())
    assert a["buckets"][0]["exchange"]["lane"] == "collective"
    assert a["overlap_ratio"] == 0.0          # serial by construction
    kinds = [e["event"] for e in journal.entries]
    assert kinds.count("step_anatomy") == 3 and "overlap_report" in kinds
    assert all(e["source"] == "host_probe" for e in journal.entries
               if e["event"] != "header")
    assert jax_validate(journal.entries) == []
    # a profiler already running: the capture returns None
    with profile(activities=[ProfilerActivity.CPU]):
        assert anatomy.capture_pipeline_anatomy(
            cfg, StackedComm(4), str(tmp_path), num_buckets=1, iters=1,
            device="cpu") is None


def test_chrome_trace_sink_lanes_as_jax(tmp_path):
    from oktopk_tpu.obs.tracing import ChromeTraceSink as JSink
    from oktopk_tpu_torch.obs.tracing import ChromeTraceSink
    sinks = ChromeTraceSink(), JSink()
    for sink in sinks:
        sink.add("anat/b000/select", 0.0, 0.010)
        sink.add("anat/b000/select", 0.020, 0.010)   # same family
        sink.add("anat/b001/select", 0.000, 0.005)   # other bucket
        sink.add("anat/b001/lvl1/select", 0.000, 0.005)
        sink.add("data_wait", 0.000, 0.001)          # non-contract name
    assert sinks[0].events == sinks[1].events
    tids = {ev["name"]: ev["tid"] for ev in sinks[0].events}
    assert len(set(tids.values())) == 3
    paths = [sink.write(str(tmp_path / f"{i}.trace.json"))
             for i, sink in enumerate(sinks)]
    docs = [json.load(open(p)) for p in paths]
    assert docs[0] == docs[1]


# ---- the span recorder (the port's own) -------------------------------------

def _tiny_bert_trainer():
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer
    return Trainer(TrainConfig(dnn="bert_tiny", dataset="wikipedia",
                               batch_size=2, lr=2e-4, density=0.01,
                               num_buckets=2, compressor="oktopk",
                               num_workers=4),
                   algo_cfg=OkTopkConfig(warmup_steps=0), warmup=False,
                   device="cpu")


def _tiny_bert_batch(seed):
    from oktopk_tpu_torch.data.synthetic import synthetic_batch
    return synthetic_batch("bert_tiny", 8, np.random.RandomState(seed))


@pytest.fixture(scope="module")
def recorded_steps():
    """Two stacked oktopk steps of a two-bucket bert_tiny Trainer with the
    recorder on, and the same two with it off: (spans, losses and
    parameters on, losses and parameters off)."""
    def run(rec):
        tr = _tiny_bert_trainer()
        prev = anatomy.record_spans(rec)
        try:
            losses = [tr.train_step(_tiny_bert_batch(s))["loss"].item()
                      for s in range(2)]
        finally:
            anatomy.record_spans(prev)
        return losses, [p.detach().clone() for p in tr.params]

    rec = anatomy.SpanRecorder()
    on = run(rec)
    return rec.drain(), on, run(None)


def test_span_tree_of_a_stacked_oktopk_step(recorded_steps):
    spans = recorded_steps[0]
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == [anatomy.STEP] * 2
    assert [r["step"] for r in roots] == [0, 1]
    first = [s for s in spans if s["step"] == 0]
    kids = [s["name"] for s in first if s["parent"] == roots[0]["id"]]
    assert kids == ["anat/fwd_bwd", anatomy.GRAD_STEP, "anat/optimizer"]
    grad = next(s for s in first if s["name"] == anatomy.GRAD_STEP)
    buckets = [s for s in first if s["parent"] == grad["id"]]
    assert [b["name"] for b in buckets] == ["anat/b000", "anat/b001"]
    for b in buckets:
        phases = [s for s in first if s["parent"] == b["id"]]
        assert phases and {anatomy.parse_scope(s["name"]) for s in phases} \
            == {(p, int(b["name"][-3:])) for p in
                ("select", "stage", "exchange", "combine")}
        for s in phases:
            assert b["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= b["end_ns"]
            assert s["device_ms"] is None           # the CPU: no events
    # every span but the roots hangs under an open span of its step
    for s in spans:
        if s["parent"] is not None:
            assert by_id[s["parent"]]["step"] == s["step"]


def test_recorder_leaves_the_step_bit_identical(recorded_steps):
    _, (l_on, p_on), (l_off, p_off) = recorded_steps
    assert l_on == l_off
    for a, b in zip(p_on, p_off):
        assert torch.equal(a, b)


def test_step_totals_split_the_step(recorded_steps):
    rows = anatomy.step_totals(recorded_steps[0], clock="host")
    assert [r["step"] for r in rows] == [0, 1]
    assert rows[0]["marks"] == dict.fromkeys(anatomy.MARKS, True)
    assert rows[1]["marks"] == {}
    for r in rows:
        ms = r["ms"]
        parts = sum(ms[k] for k in ("select", "stage", "exchange",
                                    "combine", "bucket", "grad_step_self"))
        assert parts == pytest.approx(ms["grad_step"], rel=1e-9)
        whole = sum(ms[k] for k in ("fwd_bwd", "optimizer", "step_self"))
        assert whole + ms["grad_step"] == pytest.approx(ms["step"],
                                                        rel=1e-9)


def test_launch_counter_deltas_on_the_step_span(recorded_steps,
                                                monkeypatch):
    from oktopk_tpu_torch.ops import combine, compaction, fused_select, prng
    zeros = dict.fromkeys(anatomy.COUNTED_OPS, 0)   # the CPU launches none
    assert all(s["attrs"]["launches"] == zeros for s in recorded_steps[0]
               if s["name"] == anatomy.STEP)
    for mod in (compaction, fused_select, prng, combine):
        monkeypatch.setattr(mod, "LAUNCHES", mod.LAUNCHES + 7)
    rec = anatomy.SpanRecorder()
    prev = anatomy.record_spans(rec)
    try:
        with anatomy.span(anatomy.STEP, root=True):
            fused_select.LAUNCHES += 4      # one sweep a worker
            compaction.LAUNCHES += 8        # two compactions a worker
            combine.LAUNCHES += 9           # 2 x 4 row scatters, 1 residual
            with anatomy.span(anatomy.GRAD_STEP):
                prng.LAUNCHES += 1
    finally:
        anatomy.record_spans(prev)
    grad, step = rec.drain()[::-1]
    assert step["attrs"]["launches"] == {"fused_select": 4,
                                         "compaction": 8, "prng": 1,
                                         "combine": 9}
    assert "launches" not in grad["attrs"]


def test_oktopk_marks_its_cadence_over_256_steps():
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)
    _, cfg = _configs("oktopk")
    cfg = cfg.replace(n=64, local_recompute_every=4,
                      global_recompute_every=8, repartition_every=16,
                      warmup_steps=5, threshold_method="sort")
    step = build_allreduce_step("oktopk", cfg, warmup=False)
    st = batched_init_state(cfg, "cpu")
    g = torch.from_numpy(np.random.RandomState(5).randn(P, 64)
                         .astype(np.float32))
    rec = anatomy.SpanRecorder()
    prev = anatomy.record_spans(rec)
    try:
        for _ in range(256):
            with anatomy.phase_scope(bucket=0):
                _, st = step(g, st)
    finally:
        anatomy.record_spans(prev)
    buckets = [s for s in rec.drain() if s["name"] == "anat/b000"]
    assert [b["attrs"]["host_step"] for b in buckets] == list(range(256))
    for b in buckets:
        s, a = b["attrs"]["host_step"], b["attrs"]
        first = s == cfg.warmup_steps
        assert a["first_sparse"] == first
        assert a["exact"] == (s % cfg.global_recompute_every == 0 or first)
        assert a["local_recompute"] == (
            s % cfg.local_recompute_every == 0 or first)
        assert a["repartition"] == (s % cfg.repartition_every == 0 or first)


def test_recorder_is_off_by_default_and_annotate_is_a_noop():
    assert anatomy._RECORDER is None
    assert anatomy.span(anatomy.STEP, root=True) is anatomy._NULL
    anatomy.annotate(exact=True)           # nothing open, nothing raised
    rec = anatomy.SpanRecorder()
    prev = anatomy.record_spans(rec)
    try:
        anatomy.annotate(exact=True)       # no open span: dropped
        with anatomy.phase_scope("select", 0):
            with anatomy.phase_scope("select"):   # adds nothing: no span
                anatomy.annotate(exact=True)
    finally:
        anatomy.record_spans(prev)
    (only,) = rec.drain()
    assert only["name"] == "anat/b000/select"
    assert only["attrs"] == {"exact": True} and only["parent"] is None
    assert rec.drain() == []


def test_profiler_reads_the_same_with_the_recorder(tmp_path):
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)
    _, cfg = _configs("oktopk")
    rng = np.random.RandomState(3)
    grads = torch.from_numpy(rng.randn(P, N).astype(np.float32))

    def run():
        step = build_allreduce_step("oktopk", cfg, warmup=False)
        with anatomy.span(anatomy.STEP, root=True):
            with anatomy.phase_scope(bucket=0):
                return step(grads, batched_init_state(cfg, "cpu"))

    _, off = _traced(run, tmp_path, "off.json")
    rec = anatomy.SpanRecorder()
    prev = anatomy.record_spans(rec)
    try:
        _, on = _traced(run, tmp_path, "on.json")
    finally:
        anatomy.record_spans(prev)
    assert _trace_set(on) == _trace_set(off)

    def names(path):
        return sorted(e["name"] for e in json.load(open(path))["traceEvents"]
                      if e.get("cat") == "user_annotation")

    assert names(on) == names(off)          # no step/grad_step range
    a_on, a_off = (anatomy.analyze_capture(p) for p in (on, off))
    assert set(a_on["buckets"]) == set(a_off["buckets"]) == {0}
    assert {k: v["count"] for k, v in a_on["buckets"][0].items()} == \
        {k: v["count"] for k, v in a_off["buckets"][0].items()}
    spans = rec.drain()
    assert {s["name"] for s in spans} >= {anatomy.STEP, "anat/b000"}
    # each contract span once, as its profiler range
    contract = [s["name"] for s in spans
                if anatomy.parse_scope(s["name"]) is not None]
    assert sorted(contract) == names(on)


def test_span_host_stamps_on_the_profiler_clock():
    rec = anatomy.SpanRecorder()
    prev = anatomy.record_spans(rec)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("warm"):
                pass
            for i in range(20):
                with anatomy.phase_scope("select", i):
                    torch.ones(64).sum()
    finally:
        anatomy.record_spans(prev)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"clock_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        doc = json.load(open(path))
    finally:
        os.remove(path)
    base = doc["baseTimeNanoseconds"]
    twins = {e["name"]: e["ts"] for e in doc["traceEvents"]
             if e.get("cat") == "user_annotation"}
    gaps = [abs(twins[s["name"]] - (s["start_ns"] - base) / 1e3)
            for s in rec.drain()]
    assert len(gaps) == 20
    assert sorted(gaps)[len(gaps) // 2] < 100.0      # µs


def test_name_gaps_on_a_hand_built_trace():
    base = 1_000_000_000_000

    def dev(ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}

    events = [dev(0, 10), dev(5, 10), dev(20, 5, "gpu_memcpy"),
              dev(40, 10, "gpu_memset"), dev(60, 5),
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 30,
               "dur": 50}]               # a host op is no device work

    def sp(i, name, parent, t0, t1, **attrs):
        return {"name": name, "id": i, "parent": parent, "step": 3,
                "start_ns": base + t0 * 1000, "end_ns": base + t1 * 1000,
                "device_ms": None, "attrs": attrs}

    spans = [sp(0, anatomy.STEP, None, 0, 55),
             sp(1, "anat/b000", 0, 10, 50, exact=True),
             sp(2, "anat/b000/select", 1, 28, 35)]
    gaps = anatomy.name_gaps(events, spans, base)
    # busy: [0, 15], [20, 25], [40, 50], [60, 65]
    assert [(g["ts"], round(g["seconds"] * 1e6, 6)) for g in gaps] == \
        [(17.5, 5.0), (32.5, 15.0), (55.0, 10.0)]
    assert [g["name"] for g in gaps] == ["anat/b000", "anat/b000/select",
                                         anatomy.STEP]
    assert gaps[0]["attrs"] == {"exact": True} and gaps[0]["step"] == 3
    spans[0]["end_ns"] = base + 50_000       # the last gap: no span open
    assert anatomy.name_gaps(events, spans, base)[-1]["name"] is None
    assert anatomy.name_gaps([], spans, base) == []


def test_chrome_export_of_spans_with_args(recorded_steps, tmp_path):
    from oktopk_tpu_torch.obs.tracing import ChromeTraceSink, spans_path
    spans = recorded_steps[0]
    sink = ChromeTraceSink()
    for s in spans:
        sink.add_span(s)
    doc = json.load(open(sink.write(str(tmp_path / "spans.json"))))
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(spans)
    for e, s in zip(xs, spans):
        assert e["ts"] == s["start_ns"] / 1e3
        assert e["args"]["step"] == s["step"]
        assert e["args"]["parent"] == s["parent"]
        assert "device_ms" in e["args"]
        assert all(e["args"][k] == v for k, v in s["attrs"].items())
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "thread_name"}
    # one lane per contract family, one each for the recorder's own
    assert {"anat/b000/select", "anat/b001/combine", "anat/fwd_bwd",
            anatomy.STEP, anatomy.GRAD_STEP} <= lanes
    assert not any(lane.startswith("anat/") and lane.count("/") > 2
                   for lane in lanes)
    assert spans_path("a/spans.json", 0) == "a/spans.json"
    assert spans_path("a/spans.json", 2) == "a/spans.rank2.json"


def test_obs_spans_flag_writes_the_trace(tmp_path):
    from oktopk_tpu_torch.train import main_bert, main_trainer
    path = tmp_path / "spans.json"
    assert main_bert.main(["--model", "bert_tiny", "--device", "cpu",
                           "--num-workers", "2", "--batch-size", "2",
                           "--num-minibatches", "2", "--data-dir",
                           str(tmp_path), "--obs-spans", str(path)]) == 0
    assert anatomy._RECORDER is None
    xs = [e for e in json.load(open(path))["traceEvents"] if e["ph"] == "X"]
    assert [e["args"]["step"] for e in xs if e["name"] == anatomy.STEP] \
        == [0, 1]
    assert xs[0]["args"]["launches"] == dict.fromkeys(anatomy.COUNTED_OPS,
                                                      0)
    with pytest.raises(SystemExit):
        main_bert.main(["--model", "bert_tiny", "--pipeline-stages", "2",
                        "--obs-spans", str(path)])
    assert main_trainer.parse_args(["--obs-spans", "x.json"]).obs_spans \
        == "x.json"
