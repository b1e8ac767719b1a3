"""The bfloat16 slice as a whole: the port's Trainer with
``compute_dtype="bfloat16"`` against the JAX Trainer with the same, on
the 4-device CPU mesh, the oktopk step on the gradients of a bfloat16
model, the master state, and ``--compute-dtype`` on both command lines.

Three steps each, P = 4, oktopk with no dense warmup and cadence 2
(step 0 exact recomputes and the repartition, step 1 predicted, step 2
exact), on the float32 wire (a winner's residual is then exactly 0, so
the residuals' zero pattern is every worker's selection): ``mnistnet``
(SGD, lr 0.01, d = 0.05), ``bert_tiny`` with dropout 0.1 (both Trainers
draw JAX's masks; BertAdam, lr 4e-4 warmup-linear over 10 steps, d =
0.02) and ``lstm_tiny`` (SGD, lr 0.5, d = 0.05).

Tolerances, and why: in bfloat16 the two models are ``d_port`` apart,
as far as flax's bfloat16 lies from its float32
(``test_torch_bf16.py``): gradients a few bfloat16 ulps apart on some
elements, not float32 rounding. So an element whose |acc| lies within
that of a threshold is selected on one side only (H18's flips, many
more of them), moving one parameter by lr times a reduced value near
the global threshold on that side only. Measured (``HOLDS``): the
selections that differ in the [P, n] residual zero patterns, the
volumes' relative distance, the losses' relative distance and the
distance of the parameters' change from the JAX Trainer's after each
step.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.convert import to_jax_params
from oktopk_tpu_torch.data import synthetic_batch, synthetic_iterator
from oktopk_tpu_torch.train import main_bert, main_trainer
from oktopk_tpu_torch.train.trainer import Trainer

ALGO = dict(warmup_steps=0, local_recompute_every=2,
            global_recompute_every=2, repartition_every=2,
            wire_dtype="float32")
CASES = {
    "mnistnet": (dict(dnn="mnistnet", dataset="mnist", batch_size=2,
                      lr=0.01, density=0.05, momentum=0.0,
                      weight_decay=0.0), None),
    "bert_tiny": (dict(dnn="bert_tiny", dataset="wikipedia", batch_size=2,
                       lr=4e-4, density=0.02, total_steps=10,
                       warmup_proportion=0.1), {"dropout": 0.1}),
    "lstm_tiny": (dict(dnn="lstm_tiny", dataset="ptb", batch_size=2,
                       lr=0.5, density=0.05, momentum=0.0,
                       weight_decay=0.0), None),
}
STEPS = 3
# What each run holds: the share of the [P, n] selections allowed to
# differ on a step, the volumes' (and local and global k's) and the
# losses' relative tolerance, and the parameters' change from the shared
# start against the JAX Trainer's (``change_distance``: over all leaves,
# and the worst leaf; a port that moved nothing is 1.0 on both). Measured
# on steps 0, 1, 2:
# - mnistnet: 1,243, 8,309 and 11,114 of 6,653,480 selections differ
#   (0.17% at most); volume, local and global k at most 0.35% apart
#   (655,320 vs 653,020 on step 0); losses 3.3e-5, 4.1e-4 and 2.3e-3
#   relative; change 0.039, 0.054 and 0.063 apart, the worst leaf 0.25,
#   0.12 and 0.17;
# - bert_tiny (dropout 0.1): 354, 1,141 and 733 of 602,120 (0.19%);
#   counts 0.51% (17,926 vs 18,018 on step 1); losses 4.6e-4, 2.2e-4 and
#   2.9e-4; change 0 (BertAdam's step 0 is at lr 0: neither side moves),
#   0.154 and 0.155, the worst leaf 0.44 and 0.34 (a few flips in a
#   small bias);
# - lstm_tiny: 1,571, 5,329 and 4,249 of 3,942,400 (0.14%); counts
#   0.28% (314,012 vs 314,884 on step 1); losses 1.4e-7, 2.6e-6 and
#   7.3e-6; change 0.021, 0.021 and 0.022, the worst leaf 0.33, 0.25 and
#   0.14.
HOLDS = {
    "mnistnet": dict(flips=4e-3, counts=1e-2, loss=1e-2, change=0.15,
                     leaf_change=0.4),
    "bert_tiny": dict(flips=4e-3, counts=1e-2, loss=5e-3, change=0.25,
                      leaf_change=0.6),
    "lstm_tiny": dict(flips=4e-3, counts=1e-2, loss=1e-4, change=0.05,
                      leaf_change=0.5),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny models' matrices are far too small to share among
    threads; one thread for these tests, the old count restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True),
                        jax.device_get(tree))


@pytest.fixture(scope="module")
def jitted_jax_init():
    """The JAX Trainer's model init under ``jax.jit`` (op by op it takes
    seconds; ``test_torch_checkpoint.py`` does the same)."""
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    eager = JTrainer._init_variables
    JTrainer._init_variables = lambda self, r, b: jax.jit(
        lambda rr, bb: eager(self, rr, bb))(r, b)
    yield JTrainer
    JTrainer._init_variables = eager


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, mesh4, jitted_jax_init):
    """Both bfloat16 Trainers from the JAX weights, ``STEPS`` steps on
    the same batches: per step the metrics, the flax params and the
    residuals; the Trainers themselves for the tests below."""
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain

    JTrainer = jitted_jax_init
    case = request.param
    kw, model_kw = CASES[case]
    common = dict(num_workers=4, compute_dtype="bfloat16", **kw)
    jt = JTrainer(JTrain(**common), mesh=mesh4, algo_cfg=JCfg(**ALGO),
                  warmup=False, profile_norm=False, model_kwargs=model_kw)
    tt = Trainer(TrainConfig(**common), algo_cfg=OkTopkConfig(**ALGO),
                 device="cpu", warmup=False, model_kwargs=model_kw)
    tt.load_jax_variables(host(jt.state.params), host(
        jt.state.model_state.get("batch_stats", {})) or None)
    grads = []
    orig = tt._write_flat_grad

    def spy(w):                        # the gradients' dtype, as written
        grads.append({p.grad.dtype for p in tt.params})
        orig(w)

    tt._write_flat_grad = spy
    it = synthetic_iterator(kw["dnn"], 8, seed=4)
    out = {"case": case, "jt": jt, "tt": tt, "jax": [], "port": [],
           "grad_dtypes": grads, "start": host(jt.state.params)}
    for _ in range(STEPS):
        b = next(it)
        jm = jt.train_step(b)
        tm = tt.train_step(b)
        out["jax"].append(({k: float(np.asarray(v).mean())
                            for k, v in jm.items()},
                           host(jt.state.params),
                           host(jt.state.sparse_state.residual)))
        out["port"].append(({k: float(v) for k, v in tm.items()},
                            to_jax_params({k: v.clone() for k, v in
                                           tt.model.state_dict().items()},
                                          model=tt.model)[0],
                            tt.grad_step.states[0].residual.clone()
                            .numpy()))
    return out


def test_losses_match(runs):
    hold = HOLDS[runs["case"]]
    for s, ((tm, *_), (jm, *_)) in enumerate(zip(runs["port"],
                                                 runs["jax"])):
        assert np.isfinite(tm["loss"]), s
        np.testing.assert_allclose(tm["loss"], jm["loss"],
                                   rtol=hold["loss"], err_msg=f"step {s}")


def test_selection_flips_are_counted(runs):
    """The [P, n] residual zero patterns (every worker's selection) and
    the counts, each step."""
    hold = HOLDS[runs["case"]]
    for s, ((tm, _, tr), (jm, _, jr)) in enumerate(zip(runs["port"],
                                                       runs["jax"])):
        flips = int(((tr == 0) != (jr == 0)).sum())
        assert flips <= hold["flips"] * tr.size, (s, flips, tr.size)
        assert 0 < int((tr == 0).sum()) < tr.size
        for key in ("comm_volume", "wire_bytes", "local_k", "global_k"):
            assert abs(tm[key] - jm[key]) <= hold["counts"] * jm[key], (
                s, key, tm[key], jm[key])


def change_distance(start, jax_params, port_params):
    """How far the port's parameter change from ``start`` lies from the
    JAX Trainer's: (||dP - dJ|| / ||dJ|| over all leaves, the largest of
    the same per leaf whose dJ is not 0, how many leaves moved on one side
    only). An unchanged port (dP = 0) is 1.0 on both."""
    dj, dp = [], []
    for w0, w, g in zip(jax.tree.leaves(start), jax.tree.leaves(jax_params),
                        jax.tree.leaves(port_params)):
        w0 = np.asarray(w0, np.float64)
        dj.append(np.asarray(w, np.float64).ravel() - w0.ravel())
        dp.append(np.asarray(g, np.float64).ravel() - w0.ravel())
    leaf = [np.linalg.norm(p - j) / np.linalg.norm(j)
            for j, p in zip(dj, dp) if np.any(j)]
    one_sided = sum(1 for j, p in zip(dj, dp) if not np.any(j) and np.any(p))
    DJ, DP = np.concatenate(dj), np.concatenate(dp)
    if not np.any(DJ):
        return float(np.any(DP)), float(np.any(DP)), one_sided
    return (float(np.linalg.norm(DP - DJ) / np.linalg.norm(DJ)),
            max(leaf), one_sided)


def test_parameters_match(runs):
    """The parameters held by their change from the shared start: an
    optimizer that moved nothing, or half as far, is far outside."""
    hold = HOLDS[runs["case"]]
    for s, ((_, tp, _), (_, jp, _)) in enumerate(zip(runs["port"],
                                                     runs["jax"])):
        whole, leaf, one_sided = change_distance(runs["start"], jp, tp)
        assert whole <= hold["change"] and leaf <= hold["leaf_change"], (
            s, whole, leaf)
        assert one_sided == 0, s


def test_an_unchanged_port_fails_the_parameter_check(runs):
    """``change_distance`` tells a port that did not move from one that
    did: the start itself, as the port's state, is 1.0 off on every
    step that moved the JAX parameters."""
    moved = 0
    for _, jp, _ in runs["jax"]:
        whole, leaf, _ = change_distance(runs["start"], jp, runs["start"])
        if whole == 1.0:
            moved += 1
            assert whole > HOLDS[runs["case"]]["change"]
            assert leaf > HOLDS[runs["case"]]["leaf_change"]
    assert moved >= STEPS - 1


def test_master_state_is_float32(runs):
    """Parameters, every gradient as it reached the flat buffer, the flat
    buffer, the optimizer state and the sparse state: float32, while the
    model computes in bfloat16."""
    tt = runs["tt"]
    assert tt.model.compute_dtype == torch.bfloat16
    assert runs["grad_dtypes"] and all(d == {torch.float32}
                                       for d in runs["grad_dtypes"])
    for k, d in tt.master_dtypes().items():
        assert d <= {torch.float32}, k
    st = tt.grad_step.states[0]
    assert st.residual.dtype == torch.float32
    assert float(st.local_threshold.float().min()) > 0


def test_checkpoint_crosses_to_the_jax_trainer(runs, tmp_path, caplog):
    """The bfloat16 port's checkpoint restores into the JAX bfloat16
    Trainer's state with every leaf of the template's dtype and shape
    (master weights are float32 in both packages)."""
    from oktopk_tpu.train import checkpoint as jckpt

    from oktopk_tpu_torch.train import checkpoint as ckpt

    jt, tt = runs["jt"], runs["tt"]
    ckpt.save_checkpoint(str(tmp_path), tt.train_state(), STEPS)
    with caplog.at_level(logging.WARNING):
        state, step = jckpt.restore_checkpoint(str(tmp_path), jt.state)
    assert step == STEPS and "does not fully match" not in caplog.text
    for t, r in zip(jax.tree.leaves(jt.state), jax.tree.leaves(state)):
        assert np.asarray(r).dtype == np.asarray(t).dtype
        assert np.shape(r) == np.shape(t)


def test_oktopk_step_on_bfloat16_gradients_is_bit_equal(mesh4):
    """The sparse step does not change with the compute dtype: fed the
    [P, n] float32 gradient of a bfloat16 mnistnet (four workers' shards,
    the port's model), one oktopk step of the port and of the JAX package
    from the same initial state give the same result, residual and
    counts bit for bit, the thresholds within ulps (H1), as
    ``test_torch_oktopk.py`` holds every step."""
    from test_torch_oktopk import EXACT, THRESHOLDS, ULPS, assert_ulps
    from test_torch_oktopk import run_jax

    from oktopk_tpu_torch.collectives.registry import get_algorithm
    from oktopk_tpu_torch.collectives.state import SparseState
    from oktopk_tpu_torch.comm import StackedComm

    tt = Trainer(TrainConfig(dnn="mnistnet", num_workers=4, batch_size=2,
                             compute_dtype="bfloat16"), device="cpu")
    b = synthetic_batch("mnistnet", 8, np.random.RandomState(1))
    for w in range(4):
        for p in tt.params:
            p.grad = None
        rows = slice(2 * w, 2 * w + 2)
        loss, _ = tt._loss({k: torch.as_tensor(b[k][rows])
                            for k in ("image", "label")}, w, None)
        loss.backward()
        tt._write_flat_grad(w)
    g = tt.flat.numpy().copy()
    kw = dict(n=g.shape[1], num_workers=4, density=0.02, warmup_steps=0)
    outs, states = run_jax(mesh4, kw, [g], warmup=False)
    out, st = get_algorithm("oktopk", warmup=False)(
        torch.from_numpy(g), SparseState.from_numpy(states[0], "cpu"),
        OkTopkConfig(**kw), StackedComm(4))
    np.testing.assert_array_equal(out.numpy(), outs[0])
    got = st.to_numpy()
    for f in EXACT:
        np.testing.assert_array_equal(got[f], getattr(states[1], f),
                                      err_msg=f)
    for f in THRESHOLDS:
        assert_ulps(got[f], getattr(states[1], f), ULPS, f)


# ---- the command lines -------------------------------------------------

def test_main_trainer_compute_dtype_flag():
    """``--compute-dtype`` as the JAX command line has it (the same
    choices and default), reaching the model; a bfloat16 run on the
    CPU."""
    from oktopk_tpu.train.main_trainer import parse_args as jax_parse

    for argv in ([], ["--compute-dtype", "bfloat16"]):
        assert main_trainer.parse_args(argv).compute_dtype == \
            jax_parse(argv).compute_dtype
    with pytest.raises(SystemExit):
        main_trainer.parse_args(["--compute-dtype", "float16"])
    args = main_trainer.parse_args(
        ["--dnn", "mnistnet", "--dataset", "mnist", "--device", "cpu",
         "--num-workers", "2", "--batch-size", "2", "--max-iters", "2",
         "--compute-dtype", "bfloat16", "--warmup-steps", "1"])
    tr, data, _, _ = main_trainer.build_trainer(args)
    assert tr.cfg.compute_dtype == "bfloat16"
    assert tr.model.compute_dtype == torch.bfloat16
    assert main_trainer.main(
        ["--dnn", "mnistnet", "--dataset", "mnist", "--device", "cpu",
         "--num-workers", "2", "--batch-size", "2", "--max-iters", "2",
         "--compute-dtype", "bfloat16", "--warmup-steps", "1"]) == 0


def test_main_bert_compute_dtype_reaches_the_model():
    args = main_bert.parse_args(["--model", "bert_tiny", "--device", "cpu",
                                 "--num-workers", "2", "--num-minibatches",
                                 "1", "--compute-dtype", "bfloat16"])
    tr, data = main_bert.build_trainer(args)
    assert tr.model.compute_dtype == torch.bfloat16
    assert tr.model.cfg.dtype == torch.bfloat16
    m = tr.train_step(next(data))
    assert np.isfinite(float(m["loss"]))
    assert main_bert.main(["--model", "bert_tiny", "--device", "cpu",
                           "--num-workers", "2", "--num-minibatches", "1",
                           "--compute-dtype", "bfloat16"]) == 0


def test_glue_stays_float32():
    """The GLUE fine-tune builds its BERT with no dtype, as the JAX
    package's does (``oktopk_tpu/train/glue.py:185-186``), and its
    command line has no ``--compute-dtype``, as the JAX one has none
    (``oktopk_tpu/train/glue.py:145-157``)."""
    from oktopk_tpu_torch.train import glue

    class Tok:
        vocab_size = 1024

    with pytest.raises(SystemExit):
        glue.parse_args(["--task", "mrpc", "--data-dir", "glue",
                         "--compute-dtype", "bfloat16"])
    args = glue.parse_args(["--task", "mrpc", "--data-dir", "glue",
                            "--model", "bert_tiny"])
    m = glue.build_model(args, Tok())
    assert m.compute_dtype is None and m.cfg.dtype == torch.float32
