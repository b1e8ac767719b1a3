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
