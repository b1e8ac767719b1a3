"""The port's resilience layer (``oktopk_tpu_torch/resilience/``) against
the JAX package's, on the same numpy inputs, and the guarded step through
the port's Trainer against the JAX Trainer.

- the fault seams: ``inject_grad_faults`` (row w of the stacked [W, n_b]
  gradient is JAX's shard w), ``_bitflip`` in bfloat16, float32 and
  float64, the wire hook on a [W, m] buffer against JAX's per-shard hook
  under ``shard_map``, ``dead_workers``, ``latency_ms``,
  ``with_latency``/``seek``, ``degraded_fake_ms`` and
  ``corrupt_checkpoint``: bit for bit, byte for byte;
- the guard's ``local_anomaly_count``, ``guarded`` and ``advance``;
- ``Supervisor`` and ``HealthJournal``: one observation script replayed
  through both packages' objects gives the same actions, ``to_state()``
  dicts and journal entries (less the header's environment keys);
- the guarded step (JAX's ``TestGuardedStep`` plan: ``nan_grad`` at
  attempted step 2 on worker 1, three elements; JAX's ``_trainer``
  config, P = 4, batch 8, d = 0.05, every cadence 1): the same skip
  sequence and anomaly flags; the port's own parameters, optimizer
  state, BatchNorm statistics, residual and thresholds bit-identical
  across the skip with the counters advanced; the port's state one step
  deep from JAX's at k and k+1; the port's trajectory equal to its
  never-firing control run shifted by one; the unguarded run poisoned;
- the wire corruption (JAX's ``TestWireCorruption``): skips
  [0,1,1,1,0,0,0], ``forced_dense == [1]`` and the health journal's
  events equal to JAX's; a zeroed payload recovered by error feedback;
- the restore of the last good checkpoint through ``supervise``,
  ``resize_workers`` carrying the supervisor and the health clock, the
  supervisor across a resize and a checkpoint, and a guarded checkpoint
  (health and the supervisor ``extra``) read by the other package;
- ``main_trainer``'s ``--resilience*`` flags against JAX's parser, and a
  two-step CPU run with ``--resilience --ckpt-every 1``.

Every Trainer here is JAX's ``_trainer`` config on the narrow VGG of
``test_torch_vgg.py`` (``dnn`` and ``dataset`` overridden): its
BatchNorm statistics put the model state's rollback under test, which
mnistnet has none of, and mnistnet's oktopk step with every cadence at 1
takes seconds on one CPU thread. ``chip_smoke.py`` holds mnistnet's
decisions on the card against the CPU.

Tolerances, and why: the decisions (skips, anomaly flags, strikes,
fallbacks, journal events) are held equal; the step after a JAX state is
held as ``tests/test_torch_step_options.py`` holds the narrow VGG's:
losses rtol 1e-5, parameters atol 1e-4 (XLA's and oneDNN's convolutions
add in other orders), BatchNorm statistics rtol 1e-4 / atol 1e-5,
residuals atol 1e-4 but at most 1e-5 of the elements (an
element within rounding of a threshold may be selected on one side only,
H1), thresholds within 8 ulps (H1). A skipped step rolls back to the
loaded state, so it is held bit for bit.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax.sharding import PartitionSpec

from oktopk_tpu.comm import compat
from oktopk_tpu.resilience import faults as jfaults
from oktopk_tpu.resilience import guard as jguard
from oktopk_tpu.resilience.journal import HealthJournal as JJournal
from oktopk_tpu.resilience.supervisor import Supervisor as JSupervisor
from oktopk_tpu_torch.collectives import wire
from oktopk_tpu_torch.collectives.state import (SKIP_ADVANCES, TENSOR_FIELDS,
                                                SparseState)
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.resilience import faults, guard
from oktopk_tpu_torch.resilience.journal import HealthJournal
from oktopk_tpu_torch.resilience.supervisor import Supervisor
from oktopk_tpu_torch.train import checkpoint as ckpt
from oktopk_tpu_torch.train import main_trainer
from oktopk_tpu_torch.train.trainer import Trainer

from test_resilience import NEVER
from test_resilience import _trainer as jax_trainer
from test_torch_dist import narrow_models
from test_torch_vgg import batch

K, STEPS = 2, 5          # JAX's TestGuardedStep: the fault's attempted step
ENV_KEYS = ("jax", "jaxlib", "torch", "cuda", "device_kind", "platform",
            "world_size")


@pytest.fixture(autouse=True, scope="module")
def narrow_one_thread_jitted_init():
    """The narrow VGG in both packages' registries, torch on one thread,
    and the JAX Trainer's model init under ``jax.jit`` (op by op it
    takes seconds; ``tests/test_torch_checkpoint.py`` does the same)."""
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    eager = JTrainer._init_variables
    with pytest.MonkeyPatch.context() as mp:
        narrow_models(mp)
        mp.setattr(JTrainer, "_init_variables", lambda self, r, b: jax.jit(
            lambda rr, bb: eager(self, rr, bb))(r, b))
        yield
    torch.set_num_threads(old)


NARROW = dict(dnn="vgg_narrow", dataset="cifar10")


def port_trainer(fault_plan=None, num_buckets=1, weights=None, **cfg_over):
    """The port's counterpart of JAX's ``_trainer`` (tests/
    test_resilience.py) on the narrow VGG: the same config on four
    stacked CPU workers, from the JAX Trainer's (params, batch_stats)
    when given."""
    kw = dict(batch_size=8, lr=0.05, compressor="oktopk", density=0.05,
              num_buckets=num_buckets, num_workers=4, resilience=True,
              resilience_cooldown=0, **NARROW)
    kw.update(cfg_over)
    acfg = OkTopkConfig(warmup_steps=0, local_recompute_every=1,
                        global_recompute_every=1, repartition_every=1)
    tt = Trainer(TrainConfig(**kw), algo_cfg=acfg, warmup=False,
                 device="cpu", fault_plan=fault_plan)
    if weights is not None:
        tt.load_jax_variables(*weights)
    return tt


def jax_weights(jt):
    return (jax.device_get(jt.state.params),
            jax.device_get(jt.state.model_state["batch_stats"]))


def narrow_batches(n, seed=9):
    return [batch(8, seed + i) for i in range(n)]


def jax_tree(state) -> dict:
    """A JAX ``DistTrainState`` as the state dict both packages' files
    hold."""
    return serialization.to_state_dict(jax.device_get(state))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    elif tree is not None:
        yield prefix[:-1], np.asarray(tree)


def assert_trees_equal(a, b, what):
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys(), (what, la.keys() ^ lb.keys())
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(
            la[k], lb[k], equal_nan=True), f"{what}: {k}"


def assert_ulps(a, b, ulps, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.sign(a), np.sign(b)), what
    d = np.abs(a.view(np.int32).astype(np.int64)
               - b.view(np.int32).astype(np.int64))
    assert d.max() <= ulps, f"{what}: {d.max()} ulps apart"


def normalized(entries):
    """Journal entries with the header's environment keys dropped."""
    return [{k: v for k, v in e.items()
             if not (e["event"] == "header" and k in ENV_KEYS)}
            for e in entries]


# ---- the fault seams ------------------------------------------------------

GRAD_PLAN = (
    ("nan_grad", dict(step=2, worker=1, count=3)),
    ("inf_grad", dict(step=1, duration=2, bucket=1)),
    ("scale_grad", dict(step=3, worker=2, count=5, scale=1e6)),
    ("chip_loss", dict(step=0, worker=0)),
)


def _plans(spec):
    return (jfaults.FaultPlan(tuple(jfaults.FaultSpec(k, **kw)
                                    for k, kw in spec)),
            faults.FaultPlan(tuple(faults.FaultSpec(k, **kw)
                                   for k, kw in spec)))


@pytest.mark.parametrize("step,bucket", [(s, b) for s in range(5)
                                         for b in (0, 1)])
def test_inject_grad_faults_matches_jax(step, bucket):
    jplan, plan = _plans(GRAD_PLAN)
    x = np.random.RandomState(step).randn(4, 16).astype(np.float32)
    want = np.stack([np.asarray(jfaults.inject_grad_faults(
        jplan, jnp.asarray(x[w]), jnp.int32(step), jnp.int32(w), bucket))
        for w in range(4)])
    got = faults.inject_grad_faults(plan, torch.from_numpy(x), step, 0,
                                    bucket).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # rows 2..3 of a process holding workers 2 and 3 (first_worker 2)
    part = faults.inject_grad_faults(plan, torch.from_numpy(x[2:]), step,
                                     2, bucket).numpy()
    np.testing.assert_array_equal(part.view(np.int32),
                                  want[2:].view(np.int32))


def test_inject_without_an_active_fault_is_the_input():
    _, plan = _plans(GRAD_PLAN)
    x = torch.randn(4, 8)
    assert faults.inject_grad_faults(plan, x, 0, 0, 0) is x


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
@pytest.mark.parametrize("mask", [0, 0x1234, 0x8001])
def test_bitflip_matches_jax(dtype, mask):
    x = np.random.RandomState(3).randn(64) * 10.0 ** np.arange(-4, 4, 0.125)
    with jax.enable_x64(dtype == "float64"):
        jx = jnp.asarray(x, getattr(jnp, dtype))
        want = np.asarray(jfaults._bitflip(jx, mask))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = faults._bitflip(tx, mask)
    assert got.dtype == tx.dtype
    ubits = {"bfloat16": np.uint16, "float32": np.uint32,
             "float64": np.uint64}[dtype]
    itype = {"bfloat16": torch.int16, "float32": torch.int32,
             "float64": torch.int64}[dtype]
    np.testing.assert_array_equal(got.view(itype).numpy().view(ubits),
                                  want.view(ubits))


WIRE_PLAN = (
    ("wire_bitflip", dict(step=1, duration=2, worker=2, bucket=1, count=3)),
    ("wire_zero", dict(step=2, worker=-1, bucket=0, count=-1)),
    ("wire_bitflip", dict(step=4, worker=0, bit_mask=0x10)),
)


@pytest.mark.parametrize("step", [None, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("bucket", [0, 1])
def test_wire_hook_matches_jax_per_shard(mesh4, step, bucket):
    jplan, plan = _plans(WIRE_PLAN)
    x = np.random.RandomState(5).randn(4, 2, 6).astype(np.float32)
    cfg = SimpleNamespace(bucket_index=bucket)
    jhook = jfaults.make_wire_hook(jplan)
    jstep = None if step is None else jnp.int32(step)
    spec = PartitionSpec("data")
    fn = compat.shard_map(
        lambda s: jhook(s[0].astype(jnp.bfloat16), cfg, jstep)[None],
        mesh=mesh4, in_specs=(spec,), out_specs=spec, check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x))).view(np.uint16)
    hook = faults.make_wire_hook(plan, StackedComm(4))
    got = hook(torch.from_numpy(x).to(torch.bfloat16), cfg, step)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want)


def test_wire_hook_installs_at_the_seam():
    _, plan = _plans(WIRE_PLAN)
    cfg = OkTopkConfig(n=8, num_workers=4, bucket_index=1)
    x = torch.ones(4, 2, 3)
    prev = wire.install_wire_fault(faults.make_wire_hook(plan,
                                                         StackedComm(4)))
    try:
        hit = wire.on_wire(x, cfg, 1)
        miss = wire.on_wire(x, cfg, 0)
        untouched = wire.on_wire(x, cfg, None)
    finally:
        wire.install_wire_fault(prev)
    assert hit.dtype == torch.bfloat16
    assert float(hit[2].reshape(-1)[0]) > 1e30       # worker 2 flipped
    assert torch.equal(hit[[0, 1, 3]], x[[0, 1, 3]].to(torch.bfloat16))
    assert torch.equal(miss, x.to(torch.bfloat16))
    assert torch.equal(untouched, x.to(torch.bfloat16))


HOST_PLAN = (
    ("chip_loss", dict(step=3, worker=5)),
    ("chip_loss", dict(step=7, worker=1)),
    ("latency", dict(step=2, duration=3, latency_ms=40.0)),
    ("latency", dict(step=3, bucket=1, latency_ms=7.5)),
)


@pytest.mark.parametrize("step", [0, 2, 3, 4, 7, 99])
def test_host_seams_match_jax(step):
    jplan, plan = _plans(HOST_PLAN)
    assert faults.dead_workers(plan, step) == jfaults.dead_workers(jplan,
                                                                   step)
    for b in (0, 1):
        assert faults.latency_ms(plan, step, b) == jfaults.latency_ms(
            jplan, step, b)

    def base(algo, n, density):
        return {"dense": 8.0, "oktopk": 5.0}[algo] + n * 1e-6 * density

    bucket_of_n = {1000: 0, 2000: 1}
    fake = faults.degraded_fake_ms(base, plan, bucket_of_n, step)
    jfake = jfaults.degraded_fake_ms(base, jplan, bucket_of_n, step)
    for args in (("dense", 1000, 1.0), ("oktopk", 2000, 0.05)):
        assert fake(*args) == jfake(*args)


def test_with_latency_and_seek_match_jax():
    jplan, plan = _plans(HOST_PLAN)
    slept, jslept = [], []
    w = faults.with_latency(lambda x: x, plan, sleep=slept.append,
                            start_step=1)
    jw = jfaults.with_latency(lambda x: x, jplan, sleep=jslept.append,
                              start_step=1)
    for f in (w, jw):
        for i in range(4):
            assert f(i) == i
        f.seek(2)
        f(9)
    assert slept == jslept and len(slept) == 4


@pytest.mark.parametrize("kind", ["ckpt_truncate", "ckpt_bitflip",
                                  "ckpt_torn"])
def test_corrupt_checkpoint_matches_jax(tmp_path, kind):
    data = np.random.RandomState(1).bytes(1001)
    paths = []
    for side, fn in (("port", faults.corrupt_checkpoint),
                     ("jax", jfaults.corrupt_checkpoint)):
        p = tmp_path / f"{side}.msgpack"
        p.write_bytes(data)
        fn(str(p), kind)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes() != data
    tmps = [p.with_name(p.name + ".tmp") for p in paths]
    assert [t.exists() for t in tmps] == [kind == "ckpt_torn"] * 2
    if kind == "ckpt_torn":
        assert tmps[0].read_bytes() == tmps[1].read_bytes()


@pytest.mark.parametrize("kind,kw", [
    ("meteor", {}), ("nan_grad", {"duration": 0}),
    ("nan_grad", {"step": -1}), ("chip_loss", {})])
def test_spec_validation_matches_jax(kind, kw):
    kw = {"step": 3, **kw}
    for spec in (jfaults.FaultSpec, faults.FaultSpec):
        with pytest.raises(ValueError):
            spec(kind, **kw)


def test_plan_filters_match_jax():
    spec = GRAD_PLAN + WIRE_PLAN + HOST_PLAN + (
        ("ckpt_torn", dict(step=5)),)
    jplan, plan = _plans(spec)
    for prop in ("grad_faults", "chip_faults", "wire_faults",
                 "latency_faults", "ckpt_faults"):
        assert [dataclass_tuple(f) for f in getattr(plan, prop)] == [
            dataclass_tuple(f) for f in getattr(jplan, prop)]
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS


def dataclass_tuple(f):
    return (f.kind, f.step, f.duration, f.worker, f.bucket, f.count,
            f.latency_ms, f.bit_mask, f.scale)


# ---- the guard's units ----------------------------------------------------

def test_local_anomaly_count_matches_jax():
    rng = np.random.RandomState(2)
    flat = rng.randn(4, 32).astype(np.float32)
    red = rng.randn(4, 32).astype(np.float32)
    flat[1, 3] = np.nan
    flat[2, :2] = np.inf
    red[0, 5] = 1e7                       # finite but absurd
    red[3, 1] = -np.inf
    cfg, jcfg = guard.GuardConfig(1e6), jguard.GuardConfig(1e6)
    got = guard.local_anomaly_count(torch.from_numpy(flat),
                                    torch.from_numpy(red), cfg)
    want = [int(jguard.local_anomaly_count(jnp.asarray(flat[w]),
                                           jnp.asarray(red[w]), jcfg))
            for w in range(4)]
    assert got.dtype == torch.int32 and got.tolist() == want == [1, 1, 2, 1]
    with pytest.raises(ValueError):
        guard.GuardConfig(abs_limit=0.0)


@pytest.mark.parametrize("bad", [True, False])
def test_guarded_and_advance_match_jax(bad):
    old = {"w": np.zeros(3, np.float32), "i": np.int32(1)}
    new = {"w": np.ones(3, np.float32), "i": np.int32(2)}
    want = jguard.guarded(jnp.asarray(bad), old, new)
    got = guard.guarded(torch.tensor(bad),
                        {k: torch.as_tensor(v) for k, v in old.items()},
                        {k: torch.as_tensor(v) for k, v in new.items()})
    for k in old:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    counts = np.array([0, 3], np.int32)
    h, jh = guard.init_health(2), jguard.init_health(2)
    for flag in (False, bad, True):
        h = guard.advance(h, torch.tensor(flag), torch.from_numpy(counts))
        jh = jguard.advance(jh, jnp.asarray(flag), jnp.asarray(counts))
    for f in guard.HEALTH_FIELDS:
        np.testing.assert_array_equal(getattr(h, f).numpy(),
                                      np.asarray(getattr(jh, f)), err_msg=f)
    assert h.host_step == int(h.step) == 3


def test_agree_is_exact_in_int32():
    """The counts cross the comm as int32: a count past float32's exact
    2^24 still sums exactly."""
    big = (1 << 24) + 1
    counts = [torch.tensor([big, 0, 1, 0], dtype=torch.int32)]
    total, bad = guard.agree(counts, StackedComm(4))
    assert total.tolist() == [big + 1] and bool(bad)
    total, bad = guard.agree([torch.zeros(4, dtype=torch.int32)] * 2,
                             StackedComm(4))
    assert total.tolist() == [0, 0] and not bool(bad)


# ---- the supervisor and the health journal ------------------------------

def _skip(buckets, nb):
    flags = np.zeros(nb, np.int32)
    flags[list(buckets)] = 1
    return {"step_skipped": 1, "bucket_anomalies": flags}


def _clean(nb):
    return {"step_skipped": 0, "bucket_anomalies": np.zeros(nb, np.int32)}


# (Supervisor kwargs, script of (method, args)); "observe" takes
# (step, skip buckets or None for a clean step)
SCRIPTS = {
    "strikes_to_fallback": (dict(num_buckets=2, max_strikes=3), [
        ("observe", 1, [1]), ("observe", 2, [1]), ("observe", 3, None),
        ("observe", 4, [1]), ("observe", 5, [1]), ("observe", 6, [1]),
        ("observe", 7, [1])]),
    "divergence_restore": (dict(num_buckets=1, divergence_limit=3), [
        ("note_checkpoint", "/ck/ckpt-7.msgpack", 7),
        ("observe", 8, [0]), ("observe", 9, [0]), ("observe", 10, [0]),
        ("note_checkpoint", "/ck/bad.msgpack", 10),
        ("observe", 11, None), ("note_checkpoint", "/ck/ckpt-11.msgpack", 11),
        ("note_ckpt_write_failure", 11, "/ck/ckpt-11.msgpack", "io"),
        ("observe", 12, [0]), ("observe", 13, [0]), ("observe", 14, [0])]),
    "cooldown": (dict(num_buckets=2, max_strikes=2, cooldown_steps=5), [
        ("observe", s, [0, 1]) for s in (1, 2, 3, 4)] + [
        ("observe", 7, [0, 1])]),
    "chip_loss": (dict(num_buckets=2, cooldown_steps=100), [
        ("observe", 1, [0]), ("note_chip_loss", 5, [3]),
        ("note_chip_loss", 6, [3]), ("note_chip_loss", 7, [3, 6]),
        ("observe", 8, None)]),
}


def _replay(sup, script, nb):
    acts = []
    for name, *args in script:
        if name == "observe":
            step, buckets = args
            out = sup.observe(step, _clean(nb) if buckets is None
                              else _skip(buckets, nb))
        else:
            out = getattr(sup, name)(*args)
        acts.append([(a.kind, a.bucket, a.ckpt, tuple(a.workers))
                     for a in (out or [])])
    return acts


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_supervisor_replay_matches_jax(name):
    kw, script = SCRIPTS[name]
    sup = Supervisor(**kw, journal=HealthJournal())
    jsup = JSupervisor(**kw, journal=JJournal())
    assert _replay(sup, script, sup.num_buckets) == _replay(
        jsup, script, jsup.num_buckets)
    assert sup.to_state() == jsup.to_state()
    assert normalized(sup.journal.entries) == normalized(
        jsup.journal.entries)
    # the state loads into a fresh supervisor of either package alike
    st = jsup.to_state()
    assert Supervisor(**kw).load_state(st).to_state() == JSupervisor(
        **kw).load_state(st).to_state() == st


def test_health_journal_matches_jax(tmp_path):
    from oktopk_tpu.autotune.journal import read_journal as jread

    from oktopk_tpu_torch.autotune.journal import read_journal

    entries = []
    for j, path in ((HealthJournal, tmp_path / "port.jsonl"),
                    (JJournal, tmp_path / "jax.jsonl")):
        hj = j(str(path))
        hj.fault_seen(3, "planned", buckets=[0], counts=[2, 0])
        hj.fault_seen(4, "chip_loss", workers=[5])
        hj.guard_trip(3, [0], 1, [1, 0])
        hj.fallback(5, 0, "dense", 3)
        hj.restore(9, None, -1)
        hj.restore(11, "/ck/ckpt-8.msgpack", 8)
        hj.remesh(12, 8, 7, "chip_loss", [5], ["params", "health"],
                  ["sparse_state"])
        hj.density_backoff(13, "backoff", 1, 0.5, "guard_skip")
        hj.ckpt_saved(14, "/ck/ckpt-14.msgpack", 10, "crc32:0a", True,
                      duration_ms=1.5, source="async")
        hj.ckpt_verify_failed(15, "/ck/ckpt-14.msgpack", "digest_mismatch")
        hj.ckpt_restore(15, "/ck/ckpt-8.msgpack", 8, 1, False)
        entries.append((hj.entries, (read_journal if j is HealthJournal
                                     else jread)(str(path))))
    (port_mem, port_file), (jax_mem, jax_file) = entries
    assert normalized(port_mem) == normalized(jax_mem)
    assert normalized(port_file) == normalized(port_mem)
    assert normalized(jax_file) == normalized(jax_mem)
    assert port_file[0]["jax"] is None and {"device_kind", "world_size"} \
        <= set(port_file[0])


# ---- the guarded step against the JAX Trainer ----------------------------

def _nan_plans(step):
    spec = (("nan_grad", dict(step=step, worker=1, count=3)),)
    return _plans(spec)


@pytest.fixture(scope="module")
def guarded_runs(mesh4):
    """JAX's TestGuardedStep run (its step_fn, its batches and rngs) and
    the port's run of the same plan from the same weights, both with
    every state after every step; then the port's never-firing control
    run over the batches after the faulted one, from the faulted run's
    state before it (the steps before the fault are the control's: an
    inactive plan hands the step its input untouched)."""
    jplan, plan = _nan_plans(K)
    jt = jax_trainer(mesh4, fault_plan=jplan, **NARROW)
    weights = jax_weights(jt)
    batches = narrow_batches(STEPS)
    rngs = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
    jstates, jmetrics = [jax_tree(jt.state)], []
    s = jt.state
    for b, r in zip(batches, rngs):
        s, m = jt.step_fn(s, b, r)
        jstates.append(jax_tree(s))
        jmetrics.append(jax.device_get(m))
    jt.state = s
    tt = port_trainer(plan, weights=weights)
    states, metrics = [tt.train_state(host=True)], []
    for b in batches:
        metrics.append({k: v.clone() for k, v in tt.train_step(b).items()})
        states.append(tt.train_state(host=True))
    _, never = _nan_plans(NEVER)
    ctl = port_trainer(never, weights=weights)
    ctl.load_train_state(states[K])
    ctl_losses = [float(ctl.train_step(b)["loss"]) for b in batches[K + 1:]]
    return {"jt": jt, "jstates": jstates, "jmetrics": jmetrics,
            "tt": tt, "states": states, "metrics": metrics,
            "weights": weights, "batches": batches, "ctl": ctl,
            "ctl_losses": ctl_losses}


def test_skip_sequence_matches_jax(guarded_runs):
    r = guarded_runs
    want = [1 if i == K else 0 for i in range(STEPS)]
    for key in ("step_skipped", "steps_skipped"):
        got = [int(m[key]) for m in r["metrics"]]
        assert got == [int(m[key]) for m in r["jmetrics"]], key
    assert [int(m["step_skipped"]) for m in r["metrics"]] == want
    for m, jm in zip(r["metrics"], r["jmetrics"]):
        np.testing.assert_array_equal(m["bucket_anomalies"].numpy(),
                                      np.asarray(jm["bucket_anomalies"]))
    # the values one step deep: the first step starts from equal weights
    m, jm = r["metrics"][0], r["jmetrics"][0]
    for key in ("loss", "reduced_absmax"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    # the opt_state step follows the rollback, as JAX's SGDState.step
    assert [int(s["opt_state"]["step"]) for s in r["states"]] == [
        int(s["opt_state"]["step"]) for s in r["jstates"]] == [
        0, 1, 2, 2, 3, 4]


def test_skip_is_bit_identical_with_counters_advanced(guarded_runs):
    before, after = guarded_runs["states"][K], guarded_runs["states"][K + 1]
    for part in ("params", "opt_state", "model_state", "local_momentum"):
        assert_trees_equal(before[part], after[part], part)
    # every field of the state is either rolled back or a counter that
    # SKIP_ADVANCES names: a new field must be placed in one of the two
    assert [f.name for f in dataclasses.fields(SparseState)] == list(
        TENSOR_FIELDS) + ["host_step"]
    assert set(SKIP_ADVANCES) <= set(TENSOR_FIELDS) | {"host_step"}
    sb, sa = before["sparse_state"], after["sparse_state"]
    for f in TENSOR_FIELDS:
        if f not in SKIP_ADVANCES:
            np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
    np.testing.assert_array_equal(sa["step"], sb["step"] + 1)
    assert sa["volume_elems"][0] > sb["volume_elems"][0]
    h = after["health"]
    assert (int(h["step"]), int(h["steps_skipped"]),
            int(h["last_anomaly_step"]), h["bucket_trips"].tolist()) == (
        K + 1, 1, K, [1])
    assert guarded_runs["tt"].grad_step.health.host_step == STEPS


@pytest.mark.parametrize("i", [K, K + 1])
def test_state_one_step_deep_from_jax(guarded_runs, i):
    """From JAX's state before step i, the port's step i gives JAX's state
    after it: bit for bit across the skip (i = K), within the trainer
    tolerances on the clean step after it."""
    r = guarded_runs
    _, plan = _nan_plans(K)
    tt = port_trainer(plan, weights=r["weights"])
    tt.load_train_state(r["jstates"][i])
    assert tt.grad_step.health.host_step == i
    m = tt.train_step(r["batches"][i])
    got, want = tt.train_state(host=True), r["jstates"][i + 1]
    assert int(m["step_skipped"]) == int(r["jmetrics"][i]["step_skipped"])
    assert_trees_equal(got["health"], want["health"], "health")
    assert_trees_equal(got["opt_state"]["step"], want["opt_state"]["step"],
                       "opt step")
    gs, ws = got["sparse_state"], want["sparse_state"]
    np.testing.assert_array_equal(gs["step"], ws["step"])
    if i == K:
        for part in ("params", "opt_state"):
            assert_trees_equal(got[part], want[part], part)
        for f in ("residual", "local_threshold", "global_threshold",
                  "drift", "last_exact_lt", "boundaries"):
            np.testing.assert_array_equal(gs[f], ws[f], err_msg=f)
        return
    for (k, a), (_, b) in zip(leaves(got["params"]), leaves(want["params"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=k)
    for (k, a), (_, b) in zip(leaves(got["model_state"]),
                              leaves(want["model_state"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=k)
    # an element within rounding of a threshold may be selected on one
    # side only (H1): its residual moves by its gradient
    far = np.abs(gs["residual"] - ws["residual"]) > 1e-4
    assert far.sum() <= 1e-5 * far.size, far.sum()
    for f in ("local_threshold", "global_threshold"):
        assert_ulps(gs[f], ws[f], 8, f)


@pytest.mark.chaos
def test_trajectory_matches_never_firing_control_shifted_by_one(
        guarded_runs):
    r = guarded_runs
    losses = [float(m["loss"]) for m in r["metrics"][K + 1:]]
    assert losses == r["ctl_losses"]
    final = r["ctl"].train_state(host=True)
    assert_trees_equal(final["params"], r["states"][-1]["params"], "params")
    np.testing.assert_array_equal(
        final["sparse_state"]["residual"],
        r["states"][-1]["sparse_state"]["residual"])


@pytest.mark.chaos
def test_unguarded_run_is_poisoned():
    """Without the guard a NaN step parks in the residual (NaN never
    beats a threshold compare): worker 1's row stays poisoned two steps
    after the fault, the healthy rows untouched."""
    _, plan = _plans((("nan_grad", dict(step=1, worker=1)),))
    tt = port_trainer(plan, resilience=False)
    assert tt.supervisor is None and tt.grad_step.guard is None
    for b in narrow_batches(3):
        m = tt.train_step(b)
    res = tt.grad_step.states[0].residual.numpy()
    assert not np.isfinite(res[1]).all()
    assert np.isfinite(res[0]).all()
    assert "step_skipped" not in m
    assert tt.grad_step.health.host_step == 3


# ---- the wire corruption ----------------------------------------------------

@pytest.fixture(scope="module")
def wire_runs(mesh4, tmp_path_factory):
    """JAX's TestWireCorruption run and the port's, on the narrow VGG
    (BatchNorm, two buckets): a bit-flipped payload from worker 2 on
    bucket 1 for 20 steps, three strikes."""
    from oktopk_tpu.autotune.journal import read_journal as jread
    from oktopk_tpu.collectives import wire as jwire

    from oktopk_tpu_torch.autotune.journal import read_journal

    d = tmp_path_factory.mktemp("wire")
    spec = (("wire_bitflip", dict(step=1, duration=20, worker=2,
                                  bucket=1)),)
    jplan, plan = _plans(spec)
    out = {}
    prev = jwire.install_wire_fault(jfaults.make_wire_hook(jplan))
    try:
        jt = jax_trainer(mesh4, num_buckets=2, resilience_strikes=3,
                         resilience_journal=str(d / "jax.jsonl"), **NARROW)
        out["jskips"] = []
        for i, b in enumerate(narrow_batches(7)):
            m = jt.train_step(b)
            jt.supervise(i + 1, m)
            out["jskips"].append(int(m["step_skipped"]))
    finally:
        jwire.install_wire_fault(prev)
    tt = port_trainer(num_buckets=2, resilience_strikes=3,
                      resilience_journal=str(d / "port.jsonl"),
                      weights=jax_weights(jt))
    prev = wire.install_wire_fault(faults.make_wire_hook(plan, tt.comm))
    try:
        out["skips"] = []
        for i, b in enumerate(narrow_batches(7)):
            m = tt.train_step(b)
            tt.supervise(i + 1, m)
            out["skips"].append(int(m["step_skipped"]))
    finally:
        wire.install_wire_fault(prev)
    out.update(jt=jt, tt=tt, journal=read_journal(str(d / "port.jsonl")),
               jjournal=jread(str(d / "jax.jsonl")))
    return out


@pytest.mark.chaos
def test_bitflip_escalates_to_dense_like_jax(wire_runs):
    r = wire_runs
    assert r["skips"] == r["jskips"] == [0, 1, 1, 1, 0, 0, 0]
    assert r["tt"].supervisor.forced_dense == [1] == list(
        r["jt"].supervisor.forced_dense)
    assert r["tt"].grad_step.names == ["oktopk", "dense"]
    assert r["tt"].supervisor.to_state() == r["jt"].supervisor.to_state()
    assert normalized(r["journal"]) == normalized(r["jjournal"])
    kinds = [e["event"] for e in r["journal"]]
    assert kinds.count("guard_trip") == 3 and kinds[-1] == "fallback"
    assert r["journal"][0]["jax"] is None


def test_fallback_keeps_the_residual():
    """The re-plan swaps bucket 1's algorithm and keeps every state: the
    residuals, the health clock and the step counters."""
    tt = port_trainer(num_buckets=2)
    for b in narrow_batches(1):
        tt.train_step(b)
    gs = tt.grad_step
    before = [s.residual.clone() for s in gs.states]
    health = gs.health
    tt.supervisor.forced_dense = [1]
    tt._replan()
    assert gs.names == ["oktopk", "dense"] and gs.health is health
    assert all(torch.equal(a, s.residual) for a, s in zip(before,
                                                          gs.states))
    assert [c.density for c in gs.cfgs] == [0.05, 0.05]


@pytest.mark.chaos
def test_zeroed_payload_recovered_by_error_feedback():
    """Zeroed winners are not anomalies: the senders keep the mass in
    their residual, so the guard must not trip and training stays
    finite."""
    _, plan = _plans((("wire_zero", dict(step=1, duration=2)),))
    tt = port_trainer()
    prev = wire.install_wire_fault(faults.make_wire_hook(plan, tt.comm))
    try:
        for b in narrow_batches(4):
            m = tt.train_step(b)
            assert int(m["step_skipped"]) == 0
            assert np.isfinite(float(m["loss"]))
    finally:
        wire.install_wire_fault(prev)
    assert int(tt.grad_step.health.steps_skipped) == 0
    assert np.isfinite(tt.grad_step.states[0].residual.numpy()).all()


# ---- restore, resize and files ---------------------------------------------

def test_supervise_restores_last_good_checkpoint(tmp_path):
    tt = port_trainer(resilience_divergence_limit=3, obs=True)
    path = ckpt.save_checkpoint(str(tmp_path), tt.train_state(), 0,
                                extra=tt.supervisor_extra())
    tt.note_checkpoint(path, 0)
    saved = tt.train_state(host=True)
    for b in narrow_batches(2, seed=11):
        tt.train_step(b)
    moved = tt.train_state(host=True)["params"]
    assert not all(np.array_equal(a, b) for (_, a), (_, b) in zip(
        leaves(moved), leaves(saved["params"])))
    skip = {"step_skipped": np.int32(1),
            "bucket_anomalies": np.ones(1, np.int32)}
    for step in (3, 4, 5):
        tt.supervise(step, skip)
    assert tt.supervisor.restore_events == 1
    assert_trees_equal(tt.train_state(host=True), saved, "restored")
    kinds = [e["event"] for e in tt.run_journal.entries]
    assert kinds[-2:] == ["ckpt_restore", "restore"]


def test_resize_carries_supervisor_and_health():
    tt = port_trainer(obs=True)
    for b in narrow_batches(2, seed=13):
        tt.train_step(b)
    tt.supervisor.strikes[0] = 2
    params = [p.detach().clone() for p in tt.params]
    tt.resize_workers(StackedComm(2), trigger="manual", step=2)
    assert all(torch.equal(a, p) for a, p in zip(params, tt.params))
    assert tt.supervisor.strikes[0] == 2 and tt.cfg.num_workers == 2
    assert tt.comm.size == 2 and tt.grad_step.health.host_step == 2
    assert int(tt.grad_step.health.step) == 2
    ev = [e for e in tt.supervisor.journal.entries if e["event"] == "remesh"]
    assert len(ev) == 1
    assert (ev[0]["old_world"], ev[0]["new_world"], ev[0]["trigger"]) == (
        4, 2, "manual")
    assert {"supervisor", "health"} <= set(ev[0]["carried"])
    assert ev[0]["reinitialised"] == ["sparse_state", "local_momentum",
                                      "autotuner"]
    m = tt.train_step(batch(4, 21))
    assert np.isfinite(float(m["loss"]))
    assert tt.grad_step.states[0].residual.shape[0] == 2


def test_resize_refuses_a_process_group():
    tt = port_trainer()
    with pytest.raises(NotImplementedError):
        tt.resize_workers(SimpleNamespace(size=2, local_workers=1))


def test_supervisor_survives_resize_and_checkpoint(tmp_path):
    tt = port_trainer(num_buckets=2, obs=True)
    skip = {"step_skipped": np.int32(1),
            "bucket_anomalies": np.array([0, 1], np.int32)}
    tt.supervise(1, skip)
    tt.supervise(2, skip)
    assert tt.supervisor.strikes[1] == 2
    tt.resize_workers(StackedComm(2), trigger="manual", step=2)
    assert tt.supervisor.strikes[1] == 2
    path = ckpt.save_checkpoint(str(tmp_path), tt.train_state(), 2,
                                extra=tt.supervisor_extra())
    fresh = port_trainer(num_buckets=2, num_workers=2)
    fresh.restore_supervisor(path)
    assert fresh.supervisor.to_state() == tt.supervisor.to_state()


def test_guarded_checkpoint_resumes_in_either_package(guarded_runs,
                                                      tmp_path):
    """A guarded port checkpoint (health, the supervisor ``extra`` with
    strikes and a dense fallback) restored by the JAX Trainer, and JAX's
    file by the port: the same health counters, strikes and
    ``forced_dense``."""
    from oktopk_tpu.train import checkpoint as jckpt

    r = guarded_runs
    tt, jt = r["tt"], r["jt"]
    tt.supervisor.strikes[0] = 2
    tt.supervisor.forced_dense = [0]
    port_path = ckpt.save_checkpoint(str(tmp_path / "port"),
                                     tt.train_state(), STEPS,
                                     extra=tt.supervisor_extra())
    state, step = jckpt.restore_checkpoint(port_path, jt.state)
    jt.restore_supervisor(port_path)
    assert step == STEPS
    assert_trees_equal(jax_tree(state)["health"],
                       tt.train_state(host=True)["health"], "health")
    assert_trees_equal(jax_tree(state)["params"],
                       tt.train_state(host=True)["params"], "params")
    assert jt.supervisor.to_state() == tt.supervisor.to_state()
    assert list(jt.supervisor.forced_dense) == [0]

    jt.supervisor.strikes[0] = 1
    jt.supervisor.forced_dense = []
    jax_path = jckpt.save_checkpoint(str(tmp_path / "jax"), r["jt"].state,
                                     STEPS + 1,
                                     extra=jt.supervisor_extra())
    back = port_trainer(_nan_plans(K)[1])
    tree, step = ckpt.restore_checkpoint(jax_path,
                                         back.train_state(gather=False))
    back.load_train_state(tree)
    back.restore_supervisor(jax_path)
    assert step == STEPS + 1
    assert_trees_equal(back.train_state(host=True)["health"],
                       jax_tree(r["jt"].state)["health"], "health")
    assert back.grad_step.health.host_step == STEPS
    assert back.supervisor.to_state() == jt.supervisor.to_state()
    assert back.grad_step.names == ["oktopk"]


# ---- the command line -------------------------------------------------------

FLAGS = ["--resilience", "--resilience-strikes", "5",
         "--resilience-abs-limit", "1e12", "--resilience-journal", "h.jsonl",
         "--resilience-feedback-window", "9",
         "--resilience-feedback-signals", "4",
         "--resilience-feedback-cooldown", "11",
         "--resilience-density-backoff", "--resilience-near-ratio", "0.25",
         "--resilience-backoff-steps", "2", "--resilience-backoff-factor",
         "0.25", "--resilience-backoff-max-level", "4",
         "--resilience-clean-streak", "6"]


def test_resilience_flags_parse_as_jax():
    from oktopk_tpu.train import main_trainer as jmain

    jargs = jmain.parse_args(FLAGS)
    cfg, _ = main_trainer.configs(main_trainer.parse_args(FLAGS), 4)
    names = [f for f in vars(jargs) if f.startswith("resilience")]
    assert len(names) == 14
    for f in names:
        assert getattr(cfg, f) == getattr(jargs, f), f
    default, _ = main_trainer.configs(main_trainer.parse_args([]), 4)
    from oktopk_tpu.config import TrainConfig as JTrain
    for f in names + ["resilience_divergence_limit", "resilience_cooldown",
                      "resilience_check_every"]:
        assert getattr(default, f) == getattr(JTrain(), f), f


def test_feedback_is_built_and_trains():
    """``--resilience --resilience-feedback``: with ``--obs`` the Trainer
    holds the feedback vote (``guard_trip`` and ``regression``, JAX's
    kinds) and trains; without a bus there is none, as in JAX's."""
    argv = ["--dnn", "mnistnet", "--dataset", "mnist", "--device", "cpu",
            "--num-workers", "2", "--batch-size", "2", "--resilience",
            "--resilience-feedback", "--resilience-feedback-window", "9"]
    tt, data, _, _ = main_trainer.build_trainer(
        main_trainer.parse_args(argv + ["--obs"]))
    assert tt.feedback.kinds == ("regression", "guard_trip")
    assert tt.feedback.window_steps == 9
    m = tt.train(data, 2, log_every=1)
    assert np.isfinite(m["loss"]) and tt.retune_events == 0
    quiet, _, _, _ = main_trainer.build_trainer(
        main_trainer.parse_args(argv))
    assert quiet.feedback is None


def test_cli_checkpoint_carries_the_supervisor(tmp_path):
    d = tmp_path / "ck"
    argv = ["--dnn", "mnistnet", "--dataset", "mnist", "--data-dir",
            str(tmp_path / "none"), "--device", "cpu", "--num-workers", "2",
            "--batch-size", "2", "--max-iters", "2", "--warmup-steps", "1",
            "--ckpt-dir", str(d), "--ckpt-every", "1", "--resilience",
            "--resilience-density-backoff", "--logdir",
            str(tmp_path / "logs"), "--log-every", "1"]
    assert main_trainer.main(argv) == 0
    extra = ckpt.load_extra(str(d))
    assert set(extra) == {"supervisor"}
    assert extra["supervisor"]["strikes"] == [0]
    tree = ckpt.read_payload(ckpt.latest_checkpoint(str(d)))["state"]
    assert int(tree["health"]["step"]) == 2
