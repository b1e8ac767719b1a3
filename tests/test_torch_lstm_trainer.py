"""The LSTM slice as a whole: the port's Trainer on ``lstman4_tiny``
(DeepSpeech, CTC) and ``lstm_tiny`` (the PTB LSTM) against the JAX
Trainer on the 4-device CPU mesh, the per-worker dropout keys, and the
``main_trainer`` CLI on the AN4 and PTB datasets (synthetic data).

Two steps each, P = 4, bs 2 per worker, oktopk with no dense warmup and
cadence 2 (step 0 the exact recomputes and the repartition, step 1
predicted), on the float32 wire; ``lstman4_tiny`` on 101 spectrogram
frames at d = 0.05 with ``grad_clip`` 400
(``tests/test_train.py::test_ctc_lstman4_tiny_oktopk``), ``lstm_tiny`` at
d = 0.05, without dropout and with the reference's keep 0.35 (both
Trainers then draw JAX's masks from the JAX step's key chain); SGD without momentum and weight decay. The wire is float32
here because a winner's residual is then exactly 0, so the residuals'
zero pattern is every worker's selection (on the bf16 wire it is the
rounding remainder, 0 or not by the last bits of acc; the bf16 wire is
held by the VGG and BERT trainer tests).

Tolerances, and why: the forward, loss and gradients agree to float32
rounding (``test_torch_lstm.py``). The sparse selection sees those
gradients; an element whose |acc| lies within rounding of a threshold
can be selected on one side only, and then it moves one parameter by
lr times a reduced value near the global threshold on that side only.
- ``lstm_tiny``: the premise holds (no |acc| within rounding of a
  threshold): the selections are equal on both steps, and so the
  volumes, wire bytes and local and global k; parameters within 5e-5
  (lr 0.5 times the gradients' rounding, 9.7e-6 measured).
- ``lstman4_tiny``: the premise does not hold. CTC's gradient agrees to
  6e-5 of its largest element, and the 101-step recurrence carries it
  (``test_torch_lstm.py``), so a few elements near the thresholds flip:
  measured 19 of the 7,976,576 [P, n] selections on step 0 and 437 on
  step 1 (after step 0's flips moved the weights apart), held to 1e-4 of
  P·n; the volume 2 elements apart of 707,556 on step 0 and 56 of
  634,456 on step 1, local and global k at most 13 apart, held to 2e-4
  relative; parameters within 2 lr = 6e-4 (a flipped element moves by lr
  times a reduced value near the global threshold, 1.09 here);
  BatchNorm statistics within 2e-5 (4.8e-6 measured on step 1).
- ``lstm_tiny`` with dropout (keep 0.35, the masks JAX's on both
  sides): the masks scale surviving activations by 1/0.35, and an
  element of step 0's exchange lands within rounding of a threshold: the
  selections (residual zero patterns) are equal, but the volume is 2
  elements apart of 362,006 (wire bytes 8 of 1,448,024) on step 0 and
  equal on step 1; held to ``lstman4_tiny``'s flip and count bounds, and
  parameters to ``lstm_tiny``'s 5e-5 (1.5e-8 measured).
- All: losses rtol 1e-5; step 0's residuals, where the selections
  agree, within 1e-4 of the largest.
"""

import jax
import numpy as np
import pytest
import torch

from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.convert import to_jax_params
from oktopk_tpu_torch.data import synthetic_batch, synthetic_iterator
from oktopk_tpu_torch.train import main_trainer
from oktopk_tpu_torch.ops import prng
from oktopk_tpu_torch.train.trainer import Trainer

ALGO = dict(warmup_steps=0, local_recompute_every=2,
            global_recompute_every=2, repartition_every=2,
            wire_dtype="float32")
# id: (model, TrainConfig fields, sequence length, model fields)
CASES = {
    "lstman4_tiny": ("lstman4_tiny", dict(dataset="an4", lr=3e-4,
                                          density=0.05, grad_clip=400.0),
                     101, None),
    "lstm_tiny": ("lstm_tiny", dict(dataset="ptb", lr=0.5, density=0.05),
                  None, None),
    "lstm_tiny_dropout": ("lstm_tiny", dict(dataset="ptb", lr=0.5,
                                            density=0.05), None,
                          {"dropout_keep": 0.35}),
}
STEPS = 2
# What each model's run holds (see the module docstring): the share of
# the [P, n] selections allowed to differ, the counts' relative
# tolerance, and the parameters' absolute tolerance.
HOLDS = {
    "lstm_tiny": dict(flips=0.0, counts=0.0, params=5e-5),
    "lstm_tiny_dropout": dict(flips=1e-4, counts=2e-4, params=5e-5),
    "lstman4_tiny": dict(flips=1e-4, counts=2e-4, params=2 * 3e-4,
                         stats=2e-5),
}


def close(got, want, atol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= atol, f"{what}: max abs err {err} > {atol}"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny models' matrices are far too small to share among
    threads; one thread for these tests, the old count restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def host(tree):
    """A copy on the host (the next step may reuse the device buffers)."""
    return jax.tree.map(lambda a: np.array(a, copy=True),
                        jax.device_get(tree))


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, mesh4):
    """Both Trainers from the JAX weights, ``STEPS`` steps on the same
    batches (one JAX compile per model, shared by the tests below):
    per step the metrics and the flax params and batch statistics."""
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    case = request.param
    dnn, kw, seq_len, model_kw = CASES[case]
    common = dict(dnn=dnn, batch_size=2, num_workers=4, momentum=0.0,
                  weight_decay=0.0, **kw)
    jt = JTrainer(JTrain(**common), mesh=mesh4, algo_cfg=JCfg(**ALGO),
                  warmup=False, profile_norm=False, model_kwargs=model_kw)
    tt = Trainer(TrainConfig(**common), algo_cfg=OkTopkConfig(**ALGO),
                 device="cpu", warmup=False, model_kwargs=model_kw)
    p0 = host(jt.state.params)
    s0 = host(jt.state.model_state.get("batch_stats", {}))
    tt.load_jax_variables(p0, s0 or None)
    it = synthetic_iterator(dnn, 8, seed=4, seq_len=seq_len)
    out = {"dnn": case, "n": (tt.algo_cfg.n, jt.algo_cfg.n),
           "start": p0, "jax": [], "port": []}
    for _ in range(STEPS):
        b = next(it)
        jm = jt.train_step(b)
        tm = tt.train_step(b)
        out["jax"].append(({k: float(np.asarray(v).mean())
                            for k, v in jm.items()},
                           host(jt.state.params),
                           host(jt.state.model_state.get("batch_stats",
                                                         {})),
                           host(jt.state.sparse_state.residual)))
        out["port"].append(({k: float(v) for k, v in tm.items()},
                            *to_jax_params({k: v.clone() for k, v in
                                            tt.model.state_dict().items()}),
                            tt.grad_step.states[0].residual.clone().numpy()))
    return out


def test_flat_size_equal(runs):
    assert runs["n"][0] == runs["n"][1]


def test_losses_match(runs):
    for s, ((tm, *_), (jm, *_)) in enumerate(zip(runs["port"],
                                                 runs["jax"])):
        assert np.isfinite(tm["loss"]), s
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5,
                                   err_msg=f"step {s}")


def test_selections_and_volumes(runs):
    """A worker's residual is zero exactly where its accumulated gradient
    was sent and kept (the winner-only residual update, on the float32
    wire), so the zero pattern of the [P, n] residuals is every worker's
    selection. ``lstm_tiny``: equal, and so the counts; ``lstman4_tiny``:
    the few selections at a threshold differ (module docstring), and the
    counts by as little. On the first step, from equal weights, the
    residuals agree to rounding where the selections agree (later steps
    start from weights that such a flip has moved on one side only)."""
    hold = HOLDS[runs["dnn"]]
    for s, ((tm, *_, tr), (jm, *_, jr)) in enumerate(zip(runs["port"],
                                                         runs["jax"])):
        flips = (tr == 0) != (jr == 0)
        assert int(flips.sum()) <= hold["flips"] * tr.size, (s, flips.sum())
        assert 0 < int((tr == 0).sum()) < tr.size
        for key in ("comm_volume", "wire_bytes", "local_k", "global_k"):
            assert abs(tm[key] - jm[key]) <= hold["counts"] * jm[key], (
                s, key, tm[key], jm[key])
        if s == 0:
            close(tr[~flips], jr[~flips], 1e-4 * float(np.abs(jr).max()),
                  "step 0 residual")


def test_parameters_and_batch_stats_match(runs):
    for s, ((_, tp, ts, _), (_, jp, js, _)) in enumerate(zip(runs["port"],
                                                             runs["jax"])):
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree.leaves(tp)):
            close(g, w, HOLDS[runs["dnn"]]["params"],
                  f"step {s} {jax.tree_util.keystr(path)}")
        assert jax.tree.structure(ts) == jax.tree.structure(js)
        for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(js)):
            close(a, b, HOLDS[runs["dnn"]]["stats"], f"step {s} stats")


# ---- per-worker dropout keys ------------------------------------------

@pytest.mark.parametrize("dnn,kw", [
    ("bert_tiny", {}),
    ("lstm", dict(vocab_size=64, hidden_size=16)),
])
def test_worker_masks_do_not_depend_on_P(dnn, kw):
    """Worker 1's dropout keys come from (seed, step, 1, microbatch)
    alone: with P = 2 and P = 4 it gets the same keys, and so the same
    loss on the same rows, in each of two microbatches; its two
    microbatches' keys differ, and worker 0's differ from its."""
    def keys(P):
        cfg = TrainConfig(dnn=dnn, batch_size=2, num_workers=P, seed=3,
                          nsteps_update=2)
        tr = Trainer(cfg, device="cpu", model_kwargs=kw)
        tr.model.load_state_dict(weights)
        return tr, tr.microbatch_keys(prng.split(tr._rng)[1])

    def loss(tr, w, key):
        mb = {k: torch.as_tensor(v) for k, v in batch.items()}
        return float(tr._loss(mb, w, key)[0].detach())

    ref = Trainer(TrainConfig(dnn=dnn, num_workers=1), device="cpu",
                  model_kwargs=kw)
    weights = ref.model.state_dict()
    src = "bert_tiny" if dnn.startswith("bert") else "lstm_tiny"
    batch = synthetic_batch(src, 2, np.random.RandomState(0))
    if dnn == "lstm":
        batch = {k: v % 64 for k, v in batch.items()}
    (t2, k2), (t4, k4) = keys(2), keys(4)
    assert k2.shape == (2, 2, 2) and k4.shape == (4, 2, 2)
    np.testing.assert_array_equal(k2[1], k4[1])
    two = [loss(t2, 1, k2[1, j]) for j in range(2)]
    four = [loss(t4, 1, k4[1, j]) for j in range(2)]
    assert two == four
    assert two[0] != two[1]                   # the microbatches differ
    assert loss(t4, 0, k4[0, 0]) != four[0]


# ---- the CLI -------------------------------------------------------------

@pytest.mark.parametrize("dnn,dataset", [("lstman4_tiny", "an4"),
                                         ("lstm_tiny", "ptb")])
def test_main_trainer_lstm_cli_on_cpu(dnn, dataset, caplog):
    argv = ["--dnn", dnn, "--dataset", dataset, "--device", "cpu",
            "--batch-size", "2", "--num-workers", "2", "--max-iters", "2",
            "--warmup-steps", "1", "--log-every", "1", "--grad-clip",
            "400", "--lr", "0.01"]
    with caplog.at_level("INFO", logger="oktopk_tpu_torch"):
        assert main_trainer.main(argv) == 0
    text = caplog.text
    assert "iter 2 loss" in text and "done: 2 iterations" in text, text
    trainer, data, _, _ = main_trainer.build_trainer(
        main_trainer.parse_args(argv))
    assert trainer.workload == ("ctc" if dataset == "an4" else "lm")
    b = next(data)
    assert len(next(iter(b.values()))) == 4
    if dataset == "an4":
        assert b["spect"].shape == (4, 161, 201, 1)    # synthetic default
    else:
        assert b["tokens"].shape == (4, 35)


@pytest.mark.parametrize("dnn,dataset,err", [
    ("lstm_tiny", "an4", ValueError), ("lstman4_tiny", "ptb", ValueError),
    ("vgg16", "an4", ValueError), ("lstman4_tiny", "cifar10", ValueError),
    ("lstman4_tiny", "librispeech", NotImplementedError),
    ("lstm_tiny", "imagenet", ValueError)])
def test_main_trainer_dataset_and_model_must_agree(dnn, dataset, err):
    with pytest.raises(err):
        main_trainer.build_trainer(main_trainer.parse_args(
            ["--dnn", dnn, "--dataset", dataset, "--device", "cpu"]))


def test_iterations_per_epoch_from_50000_examples():
    args = main_trainer.parse_args(["--dnn", "lstm_tiny", "--dataset",
                                    "ptb", "--batch-size", "20",
                                    "--num-workers", "4"])
    assert main_trainer.iterations(args, 4) == 161 * (50000 // 80)



