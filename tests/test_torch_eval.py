"""Evaluation and fine-tuning in the port against the JAX package: the
greedy CTC decoder and its error rates, ``Trainer.eval_step`` for each
workload family, the ``evaluate`` command line on a checkpoint, GLUE's
readers, features, metrics and fine-tune loop, and the checkpoint flags
of ``main_bert`` and ``main_trainer``.

Tolerances, and why:
- ``eval_step``: mnistnet's loss rtol 1e-5 and accuracy equal (float32
  convolutions in another order); ``bert_tiny``'s losses rtol 1e-5 (H12:
  LayerNorm's rounding); ``lstm_tiny``'s and ``lstman4_tiny``'s losses
  rtol 1e-4 (H18: the LSTM and CTC in another order, within 2e-5 of the
  logits' largest); the speech batch's greedy hypotheses, WER and CER
  equal (the batch of ``tests/test_train.py::TestEval::
  test_eval_speech_wer``: seed 6, 101 frames, WER 3.375, above that
  test's bound of 3, which an untrained model's extra words exceed);
- the ``evaluate`` command line against the JAX one on the same file:
  rtol 1e-5 (the mnistnet losses above);
- the GLUE fine-tune: three ``bert_tiny`` steps from JAX's initial
  parameters with dropout 0.1 (JAX's masks on both sides), losses rtol
  1e-4 (H12, through three BertAdam updates), dev predictions equal;
- the checkpoint flags: two resumes from one file repeat bit for bit.
"""

import csv
import logging

import jax
import numpy as np
import pytest
import torch

from oktopk_tpu_torch.config import TrainConfig
from oktopk_tpu_torch.data import synthetic_batch, synthetic_iterator
from oktopk_tpu_torch.train import evaluate, glue, main_bert, main_trainer
from oktopk_tpu_torch.train.trainer import Trainer
from oktopk_tpu_torch.utils import decoder


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_decoder_matches_jax():
    from oktopk_tpu.utils import decoder as jdec

    rng = np.random.RandomState(0)
    words = ["YES", "NO", "GO", "STOP", "ENTER", "A", "B"]
    for _ in range(40):
        a = " ".join(rng.choice(words, size=rng.randint(0, 5)))
        b = " ".join(rng.choice(words, size=rng.randint(0, 5)))
        assert decoder.levenshtein(a, b) == jdec.levenshtein(a, b)
        assert decoder.GreedyDecoder.wer(a, b) == jdec.GreedyDecoder.wer(a, b)
        assert decoder.GreedyDecoder.cer(a, b) == jdec.GreedyDecoder.cer(a, b)
    labels = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ "
    logits = rng.randn(3, 30, len(labels)).astype(np.float32)
    lens = np.array([30, 12, 1])
    d, jd = decoder.GreedyDecoder(labels), jdec.GreedyDecoder(labels)
    assert d.decode(logits, lens) == jd.decode(logits, lens)
    assert d.decode(logits) == jd.decode(logits)


EVAL_CASES = {
    "mnistnet": dict(cfg=dict(dnn="mnistnet", batch_size=2), rtol=1e-5,
                     batch=lambda: synthetic_batch(
                         "mnistnet", 6, np.random.RandomState(1))),
    "lstm_tiny": dict(cfg=dict(dnn="lstm_tiny", batch_size=2), rtol=1e-4,
                      batch=lambda: synthetic_batch(
                          "lstm_tiny", 4, np.random.RandomState(2))),
    "bert_tiny": dict(cfg=dict(dnn="bert_tiny", batch_size=2), rtol=1e-5,
                      batch=lambda: synthetic_batch(
                          "bert_tiny", 4, np.random.RandomState(3))),
    # the batch of tests/test_train.py::TestEval::test_eval_speech_wer
    "lstman4_tiny": dict(cfg=dict(dnn="lstman4_tiny", dataset="an4",
                                  batch_size=2, compressor="dense"),
                         rtol=1e-4, batch=lambda: next(synthetic_iterator(
                             "lstman4_tiny", 4, seed=6, seq_len=101))),
}


def _jax_eval(cfg_kw, batch):
    """The JAX Trainer's ``eval_step`` and variables, on a stand-in for
    the Trainer: its model and its initial variables (``_init_variables``
    under ``PRNGKey(seed)``, jitted), without the distributed step the
    evaluation does not use; the pure-JAX families' ``eval_step`` is
    jitted too (the CTC one decodes on the host)."""
    from types import SimpleNamespace

    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.models import create_model
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    cfg = JTrain(**cfg_kw)
    model, example_fn = create_model(cfg.dnn)
    jt = SimpleNamespace(cfg=cfg, model=model, example_fn=example_fn)
    v = jax.jit(lambda r, b: JTrainer._init_variables(jt, r, b))(
        jax.random.PRNGKey(cfg.seed), JTrainer._example_batch(jt, 2))
    params = v.pop("params")
    jt.state = SimpleNamespace(params=params, model_state=dict(v))
    step = (lambda b: JTrainer.eval_step(jt, b))
    if not cfg.dnn.startswith("lstman4"):
        step = jax.jit(step)
    return step(batch), {"params": jax.device_get(params),
                         "model_state": jax.device_get(dict(v))}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_step_matches_jax(case):
    c = EVAL_CASES[case]
    b = c["batch"]()
    jm, variables = _jax_eval(c["cfg"], b)
    tt = Trainer(TrainConfig(**dict(c["cfg"], num_workers=4)),
                 warmup=False, device="cpu")
    tt.load_train_state(variables, parts=("params", "model_state"))
    tm = tt.eval_step(b)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        if k in ("accuracy", "wer", "cer"):
            assert float(tm[k]) == float(jm[k]), k
        else:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=c["rtol"], err_msg=k)
    if case == "lstman4_tiny":
        assert float(tm["wer"]) == 3.375
        assert len(tt.last_hypotheses) == 4


def test_evaluate_cli_matches_jax(tmp_path, caplog):
    from oktopk_tpu.train import evaluate as jevaluate

    ck = str(tmp_path / "ck")
    assert main_trainer.main([
        "--dnn", "mnistnet", "--dataset", "mnist", "--data-dir",
        str(tmp_path), "--device", "cpu", "--num-workers", "2",
        "--batch-size", "2", "--max-iters", "2", "--warmup-steps", "1",
        "--density", "0.05", "--ckpt-dir", ck, "--ckpt-every", "2"]) == 0
    argv = ["--dnn", "mnistnet", "--dataset", "mnist", "--data-dir",
            str(tmp_path), "--ckpt", ck, "--batch-size", "8",
            "--num-batches", "2"]
    got, hyps = evaluate.evaluate(evaluate.parse_args(argv + [
        "--device", "cpu"]))
    assert hyps == []
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert jevaluate.main(argv) == 0
    want = {r.message.split(":")[0]: float(r.message.split(":")[1])
            for r in caplog.records if r.message.startswith(("loss:",
                                                             "accuracy:"))}
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    for k in want:      # the JAX log rounds to 4 decimals
        assert abs(got[k] - want[k]) <= 5e-5 + 1e-5 * abs(want[k]), k
    # --resume picks the run up at its step
    assert main_trainer.main([
        "--dnn", "mnistnet", "--dataset", "mnist", "--data-dir",
        str(tmp_path), "--device", "cpu", "--num-workers", "2",
        "--batch-size", "2", "--max-iters", "3", "--warmup-steps", "1",
        "--density", "0.05", "--resume", ck]) == 0


def _bert_argv(tmp_path, steps, *extra):
    return ["--model", "bert_tiny", "--device", "cpu", "--num-workers", "2",
            "--batch-size", "2", "--num-minibatches", str(steps),
            "--data-dir", str(tmp_path / "nodata"), "--log-every", "1",
            *extra]


def test_main_bert_resume_repeats_and_preemption_parks(tmp_path,
                                                       monkeypatch):
    from oktopk_tpu_torch.train import checkpoint as ckpt
    from oktopk_tpu_torch.train import preemption

    d = tmp_path / "d"
    assert main_bert.main(_bert_argv(tmp_path, 2, "--ckpt-dir", str(d))) \
        == 0
    outs = []
    for i in range(2):        # two resumes from one file: the same bytes
        out = tmp_path / f"r{i}"
        assert main_bert.main(_bert_argv(tmp_path, 4, "--resume", str(d),
                                         "--ckpt-dir", str(out))) == 0
        outs.append((out / "ckpt-4.msgpack").read_bytes())
    assert outs[0] == outs[1]
    assert ckpt.read_payload(str(tmp_path / "r0" / "ckpt-4.msgpack"))[
        "state"]["opt_state"]["step"] == 4
    # a stop requested before step 2: exit 3, the state parked at step 1
    monkeypatch.setenv("OKTOPK_STATE_DIR", str(tmp_path / "parked"))
    monkeypatch.setenv("OKTOPK_RUN_ID", "bert")
    polls = []

    def stop_at_second_poll(self):
        polls.append(1)
        return len(polls) >= 2 or self._stop.is_set()

    monkeypatch.setattr(preemption.PreemptionHandler, "should_stop",
                        stop_at_second_poll)
    assert main_bert.main(_bert_argv(tmp_path, 3,
                                     "--handle-preemption")) == 3
    parked = ckpt.latest_checkpoint(
        preemption.interrupted_state_path() + ".d")
    assert parked is not None and ckpt.read_payload(parked)["step"] == 1
    monkeypatch.undo()
    monkeypatch.setenv("OKTOPK_STATE_DIR", str(tmp_path / "parked"))
    monkeypatch.setenv("OKTOPK_RUN_ID", "bert")
    assert main_bert.main(_bert_argv(tmp_path, 3,
                                     "--handle-preemption")) == 0
    assert ckpt.latest_checkpoint(
        preemption.interrupted_state_path() + ".d") is None


# ---------------------------------------------------------------------------
# GLUE

MRPC_ROWS = [
    ("1", "The quick brown fox jumps.", "A quick brown fox jumped."),
    ("0", "Hello world!", "Dogs run over lazy foxes."),
    ("1", "The lazy dog sleeps.", "The dog is lazy and sleeps."),
    ("0", "Running is fun.", "Naïve résumé über alles."),
    ("2", "a bad label", "is skipped"),
    ("1", "Brown foxes run.", "Foxes that are brown run."),
    ("0", "Over the moon.", "Under the sea?"),
]


def write_mrpc(root, rows=MRPC_ROWS):
    root.mkdir(parents=True, exist_ok=True)
    for name in ("train.tsv", "dev.tsv"):
        with open(root / name, "w", encoding="utf-8", newline="") as f:
            w = csv.writer(f, delimiter="\t", quotechar=None,
                           quoting=csv.QUOTE_NONE, escapechar="\\")
            w.writerow(["Quality", "#1 ID", "#2 ID", "#1 String",
                        "#2 String"])
            for i, (y, a, b) in enumerate(rows):
                w.writerow([y, str(2 * i), str(2 * i + 1), a, b])


def test_glue_readers_features_and_metrics_match_jax(tmp_path):
    from oktopk_tpu.data.tokenization import FullTokenizer as JTok
    from oktopk_tpu.train import glue as jglue
    from oktopk_tpu_torch.data.tokenization import FullTokenizer

    write_mrpc(tmp_path)
    assert sorted(glue.TASKS) == sorted(jglue.TASKS)
    for name in glue.TASKS:
        assert (glue.dataclasses.asdict(glue.TASKS[name])
                == glue.dataclasses.asdict(jglue.TASKS[name]))
    rows = glue.read_examples(glue.TASKS["mrpc"], str(tmp_path), "train")
    assert rows == jglue.read_examples(jglue.TASKS["mrpc"], str(tmp_path),
                                       "train")
    assert len(rows) == 6
    f = glue.featurize(rows, FullTokenizer(None, fallback_size=1024), 24,
                       False)
    jf = jglue.featurize(rows, JTok(None, fallback_size=1024), 24, False)
    for k in jf:
        assert f[k].dtype == jf[k].dtype
        np.testing.assert_array_equal(f[k], jf[k])
    rng = np.random.RandomState(0)
    y, p = rng.randint(0, 2, 50), rng.randint(0, 2, 50)
    a, b = rng.randn(50), rng.randn(50)
    for name in ("cola", "mrpc", "sts-b", "rte"):
        yy, pp = (a, b) if name == "sts-b" else (y, p)
        assert (glue.task_metrics(glue.TASKS[name], yy, pp)
                == jglue.task_metrics(jglue.TASKS[name], yy, pp))


def test_glue_fine_tune_matches_jax(tmp_path):
    """Three bert_tiny MRPC steps (batch 2, dropout 0.1) from JAX's
    initial parameters, the JAX driver's loop on both sides."""
    import jax.numpy as jnp
    import optax
    from oktopk_tpu.models.bert import BertConfig as JCfg
    from oktopk_tpu.models.bert import \
        BertForSequenceClassification as JModel
    from oktopk_tpu.optim import bert_adam
    from oktopk_tpu_torch.convert import bert_from_jax_params
    from oktopk_tpu_torch.data.tokenization import FullTokenizer
    from oktopk_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)

    write_mrpc(tmp_path)
    task = glue.TASKS["mrpc"]
    tok = FullTokenizer(None, fallback_size=1024)
    train = glue.featurize(glue.read_examples(task, str(tmp_path), "train"),
                           tok, 24, False)
    dev = dict(train)
    bs, lr, L = 2, 1e-3, 24

    jmodel = JModel(JCfg.tiny(), num_labels=2)
    rng = jax.random.PRNGKey(0)
    ex = jnp.zeros((2, L), jnp.int32)
    params = jax.jit(lambda r: jmodel.init(
        {"params": r, "dropout": r}, ex, ex, jnp.ones_like(ex),
        train=False))(rng)["params"]
    opt = bert_adam(lr=lr, warmup=0.1, t_total=3)
    opt_state = opt.init(params)

    def loss_fn(p, b, r):
        logits = jmodel.apply({"params": p}, b["input_ids"],
                              b["token_type_ids"], b["attention_mask"],
                              train=True, rngs={"dropout": r})
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, b["label"]).mean()

    model = BertForSequenceClassification(BertConfig.tiny(), 2)
    model.load_state_dict(bert_from_jax_params(jax.device_get(params)))
    got = glue.fine_tune(model, train, dev, task, 1, bs, lr, "cpu")

    @jax.jit                 # the JAX driver's train_step
    def train_step(p, o, b, r):
        loss, g = jax.value_and_grad(loss_fn)(p, b, r)
        upd, o = opt.update(g, o, p)
        return jax.tree.map(jnp.add, p, upd), o, loss

    jp, jlosses = params, []
    order = np.random.RandomState(0).permutation(len(train["label"]))
    for i in range(3):
        sel = order[i * bs:(i + 1) * bs]
        b = {k: jnp.asarray(v[sel]) for k, v in train.items()}
        rng, sub = jax.random.split(rng)
        jp, opt_state, loss = train_step(jp, opt_state, b, sub)
        jlosses.append(float(loss))
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    logits = jax.jit(lambda p, i, t, m: jmodel.apply(
        {"params": p}, i, t, m, train=False))(
        jp, dev["input_ids"], dev["token_type_ids"], dev["attention_mask"])
    np.testing.assert_array_equal(got["preds"][0],
                                  np.asarray(jnp.argmax(logits, -1)))


def test_glue_cli_grafts_the_encoder(tmp_path, caplog):
    from oktopk_tpu_torch.convert import bert_to_jax_params
    from oktopk_tpu_torch.train import checkpoint as ckpt

    write_mrpc(tmp_path / "MRPC")
    assert main_bert.main(_bert_argv(tmp_path, 1, "--ckpt-dir",
                                     str(tmp_path / "pre"))) == 0
    args = glue.parse_args(["--task", "mrpc", "--data-dir",
                            str(tmp_path / "MRPC"), "--model", "bert_tiny",
                            "--ckpt", str(tmp_path / "pre"), "--device",
                            "cpu", "--max-seq-length", "24"])
    model = glue.build_model(args, glue_tokenizer())
    glue.graft_encoder(model, args.ckpt)
    want = ckpt.read_payload(str(tmp_path / "pre" / "ckpt-1.msgpack"))[
        "state"]["params"]["bert"]
    got = bert_to_jax_params(model.state_dict())["bert"]
    for (p, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_array_equal(g, w, err_msg=str(p))
    with caplog.at_level(logging.INFO):
        assert glue.main(["--task", "mrpc", "--data-dir",
                          str(tmp_path / "MRPC"), "--model", "bert_tiny",
                          "--ckpt", str(tmp_path / "pre"), "--device",
                          "cpu", "--max-seq-length", "24", "--batch-size",
                          "2", "--epochs", "1"]) == 0
    assert "epoch 0: train loss" in caplog.text and "f1=" in caplog.text
    assert glue.main(["--task", "mrpc", "--data-dir",
                      str(tmp_path / "none"), "--device", "cpu"]) == 1


def glue_tokenizer():
    from oktopk_tpu_torch.data.tokenization import FullTokenizer
    return FullTokenizer(None, fallback_size=1024)
