"""The BERT slice as a whole: the port's Trainer on ``bert_tiny`` against
the JAX Trainer on the 4-device CPU mesh, and the ``main_bert`` CLI.

Three steps, P = 4, global batch 16, dropout 0.1 (both sides draw
JAX's masks from the JAX step's key chain), oktopk with no dense warmup
and cadence 2 (step 0 exact local and global recompute and repartition,
step 1 predicted, step 2 exact again), BertAdam with a warmup-linear
schedule over 10 steps (warmup 0.1: step 0 at lr 0, then the decay).

Tolerances, and why: the forward, loss and gradient agree to float32
rounding (``test_torch_bert.py``). The sparse selection sees those
gradients; an element whose |acc| lies within rounding of a threshold
could be selected on one side only, which would move one parameter by
about lr * (1 - b1) / sqrt(1 - b2) = 3.2 lr. Losses are held to rtol
1e-5, and parameters to atol 2e-6: every selection agrees on these
inputs, so the volumes and counts are equal and the Adam updates (each
about 3.2 lr = 1.3e-3 in size) differ only by rounding.
"""

import numpy as np
import pytest
import torch

from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.convert import to_jax_params
from oktopk_tpu_torch.data import synthetic_batch
from oktopk_tpu_torch.train import main_bert
from oktopk_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """bert_tiny's matrices are far too small to share among threads: on
    a loaded machine torch's thread pool makes each step tens of times
    slower. One thread for these tests, the old count restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


ALGO = dict(warmup_steps=0, local_recompute_every=2,
            global_recompute_every=2, repartition_every=2)
COMMON = dict(dnn="bert_tiny", batch_size=4, lr=4e-4, density=0.02,
              num_workers=4, total_steps=10, warmup_proportion=0.1)


def test_trainer_three_steps_match_jax(mesh4):
    import jax
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    jt = JTrainer(JTrain(**COMMON), mesh=mesh4, algo_cfg=JCfg(**ALGO),
                  model_kwargs={"dropout": 0.1}, profile_norm=False)
    tt = Trainer(TrainConfig(**COMMON), algo_cfg=OkTopkConfig(**ALGO),
                 device="cpu", model_kwargs={"dropout": 0.1})
    p0 = jax.device_get(jt.state.params)
    tt.load_jax_variables(p0)
    assert tt.algo_cfg.n == jt.algo_cfg.n
    rng = np.random.RandomState(7)
    for s in range(3):
        b = synthetic_batch("bert_tiny", 16, rng)
        b["attention_mask"][1::3, 20:] = 0        # padded rows
        jm = jt.train_step(b)
        tm = tt.train_step(b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert np.isfinite(float(tm["mlm_loss"]))
        np.testing.assert_allclose(
            float(tm["mlm_loss"]) + float(tm["nsp_loss"]),
            float(tm["loss"]), rtol=1e-6)
        for key in ("comm_volume", "local_k", "global_k", "wire_bytes"):
            assert float(tm[key]) == float(jm[key]), (s, key)
    assert int(tt.optimizer.step) == int(jt.state.opt_state.step) == 3
    got, _ = to_jax_params(tt.model.state_dict())
    want = jax.device_get(jt.state.params)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=2e-6,
                                   err_msg=jax.tree_util.keystr(path))
    moved = sum(int(np.sum(np.asarray(a) != np.asarray(b))) for a, b in
                zip(jax.tree.leaves(p0), jax.tree.leaves(got)))
    assert moved > 0


def test_trainer_with_dropout_is_seeded():
    """Dropout 0.1 on: two trainers from one seed take the same steps
    (the key chain starts at the seed); another seed's keys, and so its
    masks, give another loss."""
    def run(seed):
        cfg = TrainConfig(**dict(COMMON, seed=seed))
        tr = Trainer(cfg, algo_cfg=OkTopkConfig(**ALGO), device="cpu")
        b = synthetic_batch("bert_tiny", 16, np.random.RandomState(0))
        tr.model.load_state_dict(ref)
        return [float(tr.train_step(b)["loss"]) for _ in range(2)]

    ref = Trainer(TrainConfig(**COMMON), algo_cfg=OkTopkConfig(**ALGO),
                  device="cpu").model.state_dict()
    a, b, c = run(0), run(0), run(1)
    assert a == b
    assert a != c
    assert all(np.isfinite(a + c))


def test_momentum_correction_is_ignored_with_the_jax_warning():
    with pytest.warns(UserWarning, match="ignored for BERT/Adam"):
        tr = Trainer(TrainConfig(**dict(COMMON, momentum_correction=True)),
                     algo_cfg=OkTopkConfig(**ALGO), device="cpu")
    assert tr.grad_step.momenta is None


def test_main_bert_cli_on_cpu():
    assert main_bert.main(["--model", "bert_tiny", "--device", "cpu",
                           "--num-minibatches", "2", "--num-workers", "4",
                           "--log-every", "1"]) == 0


def test_main_bert_flags_and_algo_cfg():
    args = main_bert.parse_args([])
    assert (args.model, args.batch_size, args.max_seq_length, args.lr,
            args.warmup_proportion, args.num_minibatches, args.compressor,
            args.density, args.wire_dtype,
            args.gradient_accumulation_steps) == (
        "bert_base", 8, 128, 2e-4, 0.01, 1024, "oktopk", 0.01, "bfloat16",
        1)
    assert main_bert.parse_args(["--model", "bert_tiny"]).max_seq_length \
        == 32
    from oktopk_tpu.train.main_bert import _bert_algo_cfg as jax_algo
    want = jax_algo(args)
    got = main_bert._bert_algo_cfg(args)
    for f in ("warmup_steps", "local_recompute_every",
              "global_recompute_every", "repartition_every",
              "local_adapt_scale", "global_adapt_scale", "wire_dtype"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("flags,message", [
    (["--num-experts", "3", "--expert-shards", "2"],
     "must divide by --expert-shards"),
    (["--expert-shards", "2"], "no data axis"),
    (["--expert-shards", "2", "--expert-data-shards", "2",
      "--gradient-accumulation-steps", "2"], "not wired"),
    (["--expert-shards", "2", "--expert-data-shards", "2",
      "--num-workers", "2"], "runs --expert-shards x --expert-data-shards"),
])
def test_main_bert_expert_refusals(flags, message):
    """JAX's refusals of the expert route (``run_expert_parallel``), and
    ``--num-workers`` other than ep x dp, as the seq path refuses it."""
    with pytest.raises(SystemExit, match=message):
        main_bert.main(["--model", "bert_tiny", "--device", "cpu",
                        "--num-minibatches", "1", *flags])


@pytest.mark.parametrize("flags,route", [
    (["--pipeline-stages", "2", "--expert-shards", "2"], "pipeline"),
    (["--seq-shards", "2", "--expert-shards", "2"], "seq"),
    (["--expert-shards", "2"], "expert"),
])
def test_main_bert_routes_in_jax_order(monkeypatch, flags, route):
    """JAX's routing (oktopk_tpu/train/main_bert.py:112-121): the
    pipeline, then seq, then the expert path."""
    for name, r in (("run_pipeline", "pipeline"),
                    ("run_seq_parallel", "seq"),
                    ("run_expert_parallel", "expert")):
        monkeypatch.setattr(main_bert, name, lambda args, r=r: r)
    assert main_bert.main(["--model", "bert_tiny", "--device", "cpu",
                           "--num-minibatches", "1", *flags]) == route


def test_main_bert_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        main_bert.main(["--model", "bert_tiny", "--num-minibatches", "1"])
