"""The port's checkpoints against the JAX package's: the msgpack codec,
the durable plane, the train state in both directions, and preemption.

- ``train/msgpack.py`` writes ``flax.serialization.to_bytes``' bytes for
  a tree with every leaf kind (the chunk size lowered on both sides to
  reach flax's chunked form cheaply) and reads ``msgpack_restore``'s
  tree back;
- ``train/durable.py`` publishes, verifies, walks past corrupt files,
  keeps and cleans as ``oktopk_tpu/train/durable.py`` does on the same
  directory;
- a JAX-written checkpoint restores into the port's Trainer and the port's
  file into the JAX Trainer (``restore_checkpoint``) with no leaf
  defaulted or dropped, and one step after the restore agrees with the
  JAX Trainer's step from the same state: mnistnet with SGD momentum,
  ``bert_tiny`` with BertAdam and dropout 0.1, and the narrow VGG with
  momentum correction over two buckets (BatchNorm statistics, per-bucket
  sparse state and local momentum);
- an asynchronous save holds the state at the call, not the state the
  in-place updates leave by the time it is written;
- preemption: signals, the parked state, the epilogue's exit codes and
  ``requeue_job``.

The dropout key chain is not in the checkpoint (H20: it lives on the
JAX Trainer, ``oktopk_tpu/train/trainer.py:231,631``); the step after a
restore is compared with the JAX Trainer's key carried over.

Tolerances, and why: the restored state is the file's, bit for bit. The
step after it is held to the trainer tests' tolerances: losses rtol
1e-5, volumes and counts within 1% + 2, parameters atol 1e-4 for the
CNNs (XLA's and oneDNN's convolutions add in other orders; momentum
correction's FMA, H11) and atol 2e-6 for ``bert_tiny`` (H12:
LayerNorm's rounding), as ``tests/test_torch_step_options.py`` and
``tests/test_torch_bert_trainer.py`` hold them.
"""

import json
import logging
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.data import synthetic_batch
from oktopk_tpu_torch.train import checkpoint as ckpt
from oktopk_tpu_torch.train import durable, msgpack, preemption
from oktopk_tpu_torch.train.trainer import Trainer

from test_torch_vgg import narrow  # noqa: F401  (fixture)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the codec

def _every_leaf_kind():
    return {
        "int": 1, "neg": -5, "i8": -100, "i16": -4000, "i32": -70000,
        "i64": -3_000_000_000, "u8": 200, "u16": 60000, "u32": 70000,
        "u64": 2 ** 40, "float": 1.5, "str": "x" * 40, "str8": "y" * 300,
        "utf8": "résumé", "bytes": b"\x00\x01", "bin16": b"z" * 70000,
        "true": True, "false": False, "nil": None,
        "tuple": (1, "two", None), "f32": np.arange(12, dtype=np.float32)
        .reshape(3, 4), "i32a": np.arange(5, dtype=np.int32),
        "scalar_i32": np.int32(7), "scalar_f32": np.float32(2.5),
        "zero_d": np.asarray(3, np.int32), "bool": np.array([True, False]),
        "u32a": np.arange(5, dtype=np.uint32),
        "empty": np.zeros((0, 3), np.float32), "fixext1": np.zeros(1,
                                                                np.uint8),
        "nest": {"empty": {}, "map16": {str(i): i for i in range(20)}},
        "chunked": np.arange(1000, dtype=np.float32).reshape(10, 100),
        "f64": np.ones(2), "i64a": np.arange(3, dtype=np.int64)}


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert type(got) is np.ndarray, path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_codec_bytes_equal_flax(monkeypatch):
    import flax.serialization as fs

    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 1024)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 1024)
    tree = _every_leaf_kind()
    want = fs.to_bytes(tree)
    assert msgpack.to_bytes(tree) == want
    assert b"__msgpack_chunked_array__" in want
    _assert_trees_equal(msgpack.decode(bytearray(want)),
                        fs.msgpack_restore(want))
    # a chunked array at the root
    big = np.arange(700, dtype=np.float32)
    assert msgpack.to_bytes(big) == fs.msgpack_serialize(big)
    np.testing.assert_array_equal(msgpack.decode(fs.msgpack_serialize(big)),
                                  big)


def test_codec_refuses_truncated_and_trailing_bytes():
    data = msgpack.to_bytes({"a": np.arange(4, dtype=np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack.decode(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        msgpack.decode(data + b"\xc0")


# ---------------------------------------------------------------------------
# the durable plane, against the JAX package's on the same directory

def _small_state(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"w": rng.randn(4, 3).astype(np.float32)},
            "step": np.asarray(seed, np.int32)}


def test_atomic_publish_and_manifest_keys(tmp_path):
    from oktopk_tpu.train import durable as jdurable

    chunks = msgpack.encode(_small_state(1))
    path = str(tmp_path / "ckpt-1.msgpack")
    durable.atomic_write_bytes(path, chunks)
    man = durable.write_manifest(path, 1, chunks)
    data = open(path, "rb").read()
    assert data == b"".join(bytes(c) for c in chunks)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    jman = jdurable.write_manifest(str(tmp_path / "ckpt-2.msgpack"), 1, data)
    assert set(man) == set(jman)
    assert set(jman["environment"]) <= set(man["environment"])
    assert man["digest"] == jman["digest"] == jdurable.compute_digest(data)
    assert man["bytes"] == len(data)
    assert man["environment"]["platform"] == "cpu"
    assert jdurable.verify_checkpoint(path).reason == "ok"


def test_corrupt_file_walk_matches_jax(tmp_path):
    from oktopk_tpu.train import checkpoint as jckpt
    from oktopk_tpu.train import durable as jdurable

    for s in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path), _small_state(s), s)
    # flip a byte of the newest, truncate the second newest
    p3, p2 = (str(tmp_path / f"ckpt-{s}.msgpack") for s in (3, 2))
    raw = bytearray(open(p3, "rb").read())
    raw[-1] ^= 0xFF
    open(p3, "wb").write(raw)
    open(p2, "r+b").truncate(20)
    for path in (p3, p2):
        assert (durable.verify_checkpoint(path).reason
                == jdurable.verify_checkpoint(path).reason)
    assert durable.verify_checkpoint(p3).reason == "digest_mismatch"
    assert durable.verify_checkpoint(p2).reason.startswith("size_mismatch")
    assert (durable.latest_verified_checkpoint(str(tmp_path))
            == jdurable.latest_verified_checkpoint(str(tmp_path))
            == str(tmp_path / "ckpt-1.msgpack"))
    template = {"params": {"w": np.zeros((4, 3), np.float32)},
                "step": np.asarray(0, np.int32)}
    state, step, path, depth, legacy = durable.verified_restore(
        str(tmp_path), template)
    jstate, jstep, jpath, jdepth, jlegacy = jdurable.verified_restore(
        str(tmp_path), template)
    assert (step, path, depth, legacy) == (jstep, jpath, jdepth, jlegacy) \
        == (1, str(tmp_path / "ckpt-1.msgpack"), 2, False)
    np.testing.assert_array_equal(state["params"]["w"],
                                  jstate["params"]["w"])
    # a file without a manifest restores as legacy, in both
    os.remove(durable.manifest_path(str(tmp_path / "ckpt-1.msgpack")))
    assert durable.verify_checkpoint(str(tmp_path / "ckpt-1.msgpack")).legacy
    assert jckpt.restore_checkpoint(str(tmp_path), template)[1] == 1


def test_retention_and_stale_tmp_match_jax(tmp_path):
    from oktopk_tpu.train import durable as jdurable

    dirs = [tmp_path / "port", tmp_path / "jax"]
    for d in dirs:
        for s in range(1, 6):
            ckpt.save_checkpoint(str(d), _small_state(s), s,
                                 qualified=(s != 5 and s % 2 == 1))
        old = d / "ckpt-9.msgpack.tmp"
        old.write_bytes(b"x")
        t = time.time() - 7200
        os.utime(old, (t, t))
        (d / "ckpt-10.msgpack.tmp").write_bytes(b"y")     # in flight
    got = durable.apply_retention(str(dirs[0]), keep_last=2)
    want = jdurable.apply_retention(str(dirs[1]), keep_last=2)
    assert ([os.path.basename(p) for p in got]
            == [os.path.basename(p) for p in want])
    assert (sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1])))
    assert ([os.path.basename(p) for p in durable.clean_stale_tmp(
        str(dirs[0]))] == [os.path.basename(p) for p in
                           jdurable.clean_stale_tmp(str(dirs[1]))]
            == ["ckpt-9.msgpack.tmp"])
    assert (tmp_path / "port" / "ckpt-10.msgpack.tmp").exists()


# ---------------------------------------------------------------------------
# the train state, both packages

CASES = {
    # SGD with its momentum buffer, one bucket
    "mnistnet_momentum": dict(
        dnn="mnistnet", batch_size=2, lr=0.05, momentum=0.9, density=0.05,
        num_workers=2),
    # BertAdam's moments and step, dropout 0.1
    "bert_tiny_adam": dict(
        dnn="bert_tiny", batch_size=2, lr=4e-4, density=0.02,
        num_workers=2, total_steps=10, warmup_proportion=0.1),
    # BatchNorm statistics, momentum correction, two buckets
    "vgg_narrow_buckets": dict(
        dnn="vgg_narrow", batch_size=2, lr=0.05, density=0.05,
        num_workers=2, momentum_correction=True, num_buckets=2),
}
# no dense warmup: the step before the save is a sparse one, so the saved
# residuals, thresholds and boundaries are not the initial ones
ALGO = dict(warmup_steps=0, local_recompute_every=1,
            global_recompute_every=2, repartition_every=1)
MODEL_KW = {"bert_tiny_adam": {"dropout": 0.1}}


def _mesh2():
    from oktopk_tpu.comm.mesh import get_mesh
    return get_mesh((2,), ("data",), devices=jax.devices()[:2])


def _batch(dnn, seed):
    b = synthetic_batch("cifar" if dnn == "vgg_narrow" else dnn, 4,
                        np.random.RandomState(seed))
    return b


def _jax_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture
def jitted_jax_init(monkeypatch):
    """The JAX Trainer's model init under ``jax.jit`` (op by op it takes
    seconds): the restores below start from the JAX file either way."""
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    eager = JTrainer._init_variables
    monkeypatch.setattr(JTrainer, "_init_variables", lambda self, r, b:
                        jax.jit(lambda rr, bb: eager(self, rr, bb))(r, b))
    return JTrainer


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoints_cross_between_packages(case, tmp_path, caplog,
                                            request, jitted_jax_init):
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train import checkpoint as jckpt

    JTrainer = jitted_jax_init

    kw = CASES[case]
    if kw["dnn"] == "vgg_narrow":
        request.getfixturevalue("narrow")
    mk = MODEL_KW.get(case)
    jt = JTrainer(JTrain(**kw), mesh=_mesh2(), algo_cfg=JCfg(**ALGO),
                  model_kwargs=mk, profile_norm=False)
    jt.train_step(_batch(kw["dnn"], 0))
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), jt.state, 1)

    # JAX's file into the port: every leaf the file's, bit for bit
    tt = Trainer(TrainConfig(**kw), algo_cfg=OkTopkConfig(**ALGO),
                 device="cpu", model_kwargs=mk)
    with caplog.at_level(logging.WARNING):
        tree, step = ckpt.restore_checkpoint(str(tmp_path / "jax"),
                                             tt.train_state(gather=False))
    assert step == 1 and "does not fully match" not in caplog.text
    tt.load_train_state(tree)
    raw = jckpt.read_payload(jpath)["state"]
    got = tt.train_state(host=True)
    flat_want = _jax_leaves(raw)
    flat_got = _jax_leaves(got)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(
            path))

    # one step from the file on both sides: JAX resumed from it too (H20:
    # the key chain is the Trainer's, carried over by hand)
    jt.state, _ = jckpt.restore_checkpoint(str(tmp_path / "jax"), jt.state)
    tt._rng = np.asarray(jax.device_get(jt._rng), np.uint32)
    b = _batch(kw["dnn"], 5)
    jm = jt.train_step(b)
    tm = tt.train_step(b)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for key in ("comm_volume", "local_k", "global_k"):
        assert abs(float(tm[key]) - float(jm[key])) <= 0.01 * abs(
            float(jm[key])) + 2, key
    atol = 2e-6 if kw["dnn"].startswith("bert") else 1e-4
    got = tt.train_state(host=True)
    want = jax.device_get(jt.state.params)
    for (path, w), (_, g) in zip(_jax_leaves(want),
                                 _jax_leaves(got["params"])):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))

    # the port's file into JAX: no field defaulted or dropped, every leaf
    # of the JAX template's dtype and shape
    ppath = ckpt.save_checkpoint(str(tmp_path / "port"), tt.train_state(),
                                 2)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jstate, jstep = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                                 jt.state)
    assert jstep == 2 and "does not fully match" not in caplog.text
    for (path, t), (_, r) in zip(_jax_leaves(jt.state),
                                 _jax_leaves(jstate)):
        assert np.asarray(r).dtype == np.asarray(t).dtype, path
        assert np.shape(r) == np.shape(t), path
    # and the file decodes to the port's state, bit for bit
    for (_, g), (_, r) in zip(_jax_leaves(got),
                              _jax_leaves(jckpt.read_payload(ppath)
                                          ["state"])):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_async_save_is_the_state_at_the_call(tmp_path):
    """The Trainer updates parameters, moments and residuals in place: the
    file must hold the step at ``save``, not the one after it."""
    tt = Trainer(TrainConfig(dnn="mnistnet", batch_size=2, lr=0.05,
                             density=0.05, num_workers=2),
                 algo_cfg=OkTopkConfig(**ALGO), device="cpu")
    tt.train_step(_batch("mnistnet", 0))
    at_save = tt.train_state(host=True)
    with durable.AsyncCheckpointer(str(tmp_path)) as saver:
        saver.save(tt.train_state(), 1)
        for s in range(2):
            tt.train_step(_batch("mnistnet", 1 + s))
        assert saver.drain(60.0)
        assert saver.saves == 1 and saver.write_failures == 0
    tree, step = ckpt.restore_checkpoint(str(tmp_path),
                                         tt.train_state(gather=False))
    assert step == 1
    moved = 0
    for (path, a), (_, b) in zip(_jax_leaves(tree), _jax_leaves(at_save)):
        if isinstance(a, torch.Tensor):      # a template leaf: None in file
            continue
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    now = tt.train_state(host=True)
    for (_, a), (_, b) in zip(_jax_leaves(now["params"]),
                              _jax_leaves(at_save["params"])):
        moved += int(not np.array_equal(a, b))
    assert moved > 0          # the live state did move on


def test_load_encoder_params_refuses_other_shapes(tmp_path):
    from oktopk_tpu_torch.convert import bert_to_jax_params
    from oktopk_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)

    tt = Trainer(TrainConfig(dnn="bert_tiny", batch_size=2, num_workers=1,
                             density=0.05), device="cpu")
    ckpt.save_checkpoint(str(tmp_path), tt.train_state(), 1)
    same = BertForSequenceClassification(BertConfig.tiny(), 2)
    params = ckpt.load_encoder_params(
        str(tmp_path), bert_to_jax_params(same.state_dict()))
    want = tt.train_state(host=True)["params"]["bert"]
    for (p, a), (_, b) in zip(_jax_leaves(params["bert"]),
                              _jax_leaves(want)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    other = BertForSequenceClassification(
        BertConfig(vocab_size=1024, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64, max_position=128), 2)
    with pytest.raises(ValueError, match="encoder shapes do not match"):
        ckpt.load_encoder_params(str(tmp_path),
                                 bert_to_jax_params(other.state_dict()))
    with pytest.raises(KeyError, match="no 'nope' params subtree"):
        ckpt.load_encoder_params(str(tmp_path), params, subtree="nope")


def test_load_extra_and_merge_escalation(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), _small_state(1), 1,
                                extra={"strikes": [1, 2]})
    assert ckpt.load_extra(str(tmp_path)) == {"strikes": [1, 2]}
    assert json.loads(open(durable.manifest_path(path)).read())["step"] == 1
    with pytest.raises(ValueError, match="--ckpt-force"):
        ckpt.restore_checkpoint(str(tmp_path), {"other": {"a": 1, "b": 2,
                                                          "c": 3}})
    state, _ = ckpt.restore_checkpoint(str(tmp_path), {"other": 1},
                                       force=True)
    assert state == {"other": 1}


# ---------------------------------------------------------------------------
# preemption

def test_signals_set_the_flags():
    h = preemption.PreemptionHandler()
    try:
        os.kill(os.getpid(), signal.SIGUSR2)
        assert h.should_stop() and not h.requeue_requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.requeue_requested
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGUSR2) is signal.SIG_DFL


def test_epilogue_parks_resumes_and_clears(tmp_path, monkeypatch):
    from oktopk_tpu.train import preemption as jpre

    monkeypatch.setenv("OKTOPK_RUN_ID", "job7")
    monkeypatch.delenv("SLURM_JOBID", raising=False)
    log = logging.getLogger("test")
    sd = str(tmp_path)
    assert (preemption.interrupted_state_path(sd)
            == jpre.interrupted_state_path(sd))
    h = preemption.PreemptionHandler(exit_signals=(), requeue_signals=())
    state = _small_state(4)
    assert preemption.epilogue(state, 4, h, log, state_dir=sd) == 0
    h.request_stop()
    assert preemption.epilogue(lambda: state, 4, h, log, state_dir=sd) == 3
    template = _small_state(0)
    tree, step = preemption.load_interrupted_state(template, state_dir=sd)
    assert step == 4
    np.testing.assert_array_equal(tree["params"]["w"], state["params"]["w"])
    # the JAX package reads the parked state too
    assert jpre.load_interrupted_state(template, state_dir=sd)[1] == 4
    # a rank other than 0 parks nothing; a completed run clears
    assert preemption.epilogue(state, 5, h, log, rank=1, state_dir=sd,
                               completed=False) == 3
    assert preemption.load_interrupted_state(template, state_dir=sd)[1] == 4
    assert preemption.epilogue(state, 9, h, log, state_dir=sd,
                               completed=True) == 0
    assert preemption.load_interrupted_state(template, state_dir=sd) is None


def test_state_dir_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("OKTOPK_STATE_DIR", str(tmp_path))
    monkeypatch.delenv("SLURM_JOBID", raising=False)
    monkeypatch.delenv("OKTOPK_RUN_ID", raising=False)
    assert preemption.interrupted_state_path() == str(
        tmp_path / "local.msgpack")


def test_requeue_job_runs_scontrol_on_rank0_only():
    calls = []

    def runner(cmd, **kw):
        calls.append(cmd)

    assert preemption.requeue_job(rank=0, job_id="42", runner=runner)
    assert calls == [["scontrol", "requeue", "42"]]
    assert not preemption.requeue_job(rank=1, job_id="42", runner=runner)
    assert len(calls) == 1

    def failing(cmd, **kw):
        raise OSError("no scontrol")

    assert not preemption.requeue_job(rank=0, job_id="42", runner=failing)
