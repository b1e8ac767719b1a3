"""The port's text and audio data against the JAX package's: the
WordPiece tokenizer (Python and native), BERT pretraining batches, the
AN4 audio pipeline, ``make_dataset``'s Wikipedia and AN4 branches, the
native prefetch ring and the ``OKTOPK_NATIVE`` policy.

Every comparison is exact (ids, batches, spectrograms: the same numpy
draws and operations in the same order). The corpus, the vocabulary, the
WAV files and the manifests are written by the tests.
"""

import os
import wave

import numpy as np
import pytest

from oktopk_tpu_torch import native
from oktopk_tpu_torch.data import audio, bert_pretrain, loaders, tokenization

UNICODE_TEXTS = [
    "The quick brown fox jumps over the lazy dog",
    "hello, world!  RUNNER running unaffable",
    "naïve Über résumé Łukasz",            # accents stripped by NFD
    "«hello» ¿hello? ¡world! §2 the·dog ¶",     # Latin-1 punctuation
    "北京欢迎你 東京",                       # CJK
    "tab\there\x00ctrl\x07chars​",        # control characters
    "2022 state-of-the-art e-mail's",
    "",
]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "quick", "brown", "fox", "jump", "##s", "##ed", "##ing",
         "over", "lazy", "dog", "un", "##aff", "##able", "run", "##ner",
         "hello", "world", ",", ".", "!", "?", "'", "2", "##0", "##2",
         "naive", "uber", "##lin", "resume", "北", "京", "-", "state",
         "of", "art", "e", "mail", "s", "«", "»", "¿", "¡", "§", "·", "¶"]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(p)


def _corpus(n_docs=12, seed=3):
    rng = np.random.RandomState(seed)
    words = VOCAB[5:] + ["zebra", "quickly", "Über", "naïve"]
    docs = []
    for _ in range(n_docs):
        sents = [" ".join(rng.choice(words, size=rng.randint(3, 12)))
                 for _ in range(rng.randint(2, 5))]
        docs.append("\n".join(sents))
    return "\n\n".join(docs) + "\n"


@pytest.mark.parametrize("with_vocab", [True, False])
def test_tokenizer_ids_match_jax(vocab_file, with_vocab):
    from oktopk_tpu.data import tokenization as jtok

    vf = vocab_file if with_vocab else None
    tok = tokenization.FullTokenizer(vf, fallback_size=1024)
    jt = jtok.FullTokenizer(vf, fallback_size=1024)
    assert tok.vocab_size == jt.vocab_size
    for text in UNICODE_TEXTS:
        assert tok.tokenize(text) == jt.tokenize(text), text
        ids = tok.convert_tokens_to_ids(tok.tokenize(text))
        assert ids == jt.convert_tokens_to_ids(jt.tokenize(text)), text
        assert max(ids, default=0) < tok.vocab_size
    for a, b in zip(UNICODE_TEXTS, UNICODE_TEXTS[1:]):
        assert tok.encode_pair(a, b, 16) == jt.encode_pair(a, b, 16)
    if with_vocab:   # the text set reaches ## pieces and [UNK]
        ids = tok.convert_tokens_to_ids(tok.tokenize(UNICODE_TEXTS[0]))
        assert VOCAB.index("##s") in ids
        ids = tok.convert_tokens_to_ids(tok.tokenize(UNICODE_TEXTS[1]))
        assert VOCAB.index("##able") in ids and VOCAB.index("[UNK]") in ids


def test_native_tokenizer_matches_python_and_jax(vocab_file):
    from oktopk_tpu.native.tokenizer import NativeTokenizer as JNative
    from oktopk_tpu_torch.native.tokenizer import NativeTokenizer

    nat = NativeTokenizer(vocab_file)     # raises without the library
    # built into the port's _build/, never over the JAX package's library
    assert native.lib_path().parent.name == "_build"
    assert native.lib_path().parent.parent.name == "oktopk_tpu_torch"
    py = tokenization.FullTokenizer(vocab_file)
    jn = JNative(vocab_file)
    texts = UNICODE_TEXTS[:4] + _corpus(3).split("\n")
    for text in texts:
        want = py.convert_tokens_to_ids(py.tokenize(text))
        assert nat.encode(text) == want == jn.encode(text), text
    for a, b in zip(texts, texts[1:] + [None]):
        assert (nat.encode_pair(a, b, 24) == py.encode_pair(a, b, 24)
                == jn.encode_pair(a, b, 24))


def test_mask_tokens_and_pretrain_batches_match_jax(tmp_path, vocab_file):
    from oktopk_tpu.data import bert_pretrain as jbp
    from oktopk_tpu.data import tokenization as jtok

    ids = np.random.RandomState(0).randint(5, 50, size=(4, 16)).astype(
        np.int32)
    special = np.zeros_like(ids, bool)
    special[:, 0] = True
    got = bert_pretrain.mask_tokens(ids, np.random.RandomState(1), 60, 4,
                                    special)
    want = jbp.mask_tokens(ids, np.random.RandomState(1), 60, 4, special)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(_corpus(), encoding="utf-8")
    assert (bert_pretrain.load_documents(str(corpus))
            == jbp.load_documents(str(corpus)))
    it = bert_pretrain.pretrain_iterator(
        str(corpus), tokenization.FullTokenizer(vocab_file), 3, 24, seed=5,
        vocab_size=len(VOCAB))
    jit = jbp.pretrain_iterator(
        str(corpus), jtok.FullTokenizer(vocab_file), 3, 24, seed=5,
        vocab_size=len(VOCAB))
    for _ in range(3):
        _assert_batches_equal(next(it), next(jit))


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# AN4 audio: tone-coded words, 8 frames a character

def _tone_wav(path, text, rng):
    """16 kHz PCM: each character a sine in its own 5-bin band (as the
    synthetic AN4 batches code it), 8 hops long, over a little noise."""
    hop = audio.HOP
    out = []
    for ch in text.upper():
        c = audio.AN4_LABELS.index(ch)
        t = np.arange(8 * hop) / audio.SAMPLE_RATE
        out.append(0.5 * np.sin(2 * np.pi * (c * 5 + 2) * 50.0 * t))
    x = np.concatenate(out + [np.zeros(audio.WINDOW)])
    x = x + 0.01 * rng.randn(len(x))
    pcm = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(audio.SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def write_an4(root, n=6, seed=0):
    rng = np.random.RandomState(seed)
    words = ["YES", "NO", "ENTER", "ERASE", "RUBOUT", "STOP", "GO"]
    lines = []
    for i in range(n):
        text = " ".join(rng.choice(words, size=rng.randint(1, 3)))
        _tone_wav(root / f"u{i}.wav", text, rng)
        (root / f"u{i}.txt").write_text(text)
        lines.append(f"u{i}.wav,u{i}.txt")
    for split in ("train", "val"):
        (root / f"an4_{split}_manifest.csv").write_text(
            "\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def an4_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("an4")
    write_an4(root)
    return root


def test_audio_pipeline_matches_jax(an4_dir):
    from oktopk_tpu.data import audio as jaudio

    assert audio.AN4_LABELS == jaudio.AN4_LABELS
    wav = str(an4_dir / "u0.wav")
    x = audio.read_wav(wav)
    np.testing.assert_array_equal(x, jaudio.read_wav(wav))
    np.testing.assert_array_equal(audio.log_spectrogram(x),
                                  jaudio.log_spectrogram(x))
    np.testing.assert_array_equal(audio.log_spectrogram(x[:100]),
                                  jaudio.log_spectrogram(x[:100]))
    assert audio.text_to_labels("Yes, no!") == jaudio.text_to_labels(
        "Yes, no!")
    manifest = str(an4_dir / "an4_train_manifest.csv")
    assert audio.load_manifest(manifest) == jaudio.load_manifest(manifest)
    it = audio.an4_iterator(manifest, 2, seed=4)
    jit = jaudio.an4_iterator(manifest, 2, seed=4)
    for _ in range(4):                      # past an epoch of 3 batches
        _assert_batches_equal(next(it), next(jit))


@pytest.mark.parametrize("dataset,dnn,split", [
    ("wikipedia", "bert_tiny", "train"), ("an4", "lstman4_tiny", "train"),
    ("an4", "lstman4_tiny", "test")])
def test_make_dataset_new_branches_match_jax(tmp_path, an4_dir, vocab_file,
                                             monkeypatch, dataset, dnn,
                                             split):
    from oktopk_tpu.data import loaders as jloaders

    monkeypatch.setenv("OKTOPK_NATIVE", "1")
    if dataset == "wikipedia":
        root = tmp_path
        (root / "wikipedia").mkdir()
        (root / "wikipedia" / "part0.txt").write_text(_corpus(),
                                                      encoding="utf-8")
        (root / "vocab.txt").write_text(open(vocab_file).read(),
                                        encoding="utf-8")
    else:
        root = an4_dir
    it, meta = loaders.make_dataset(dataset, dnn, 2, path=str(root),
                                    split=split, seed=1)
    jit, jmeta = jloaders.make_dataset(dataset, dnn, 2, path=str(root),
                                       split=split, seed=1)
    assert meta == jmeta and meta["synthetic"] is False
    for _ in range(2):
        _assert_batches_equal(next(it), next(jit))


def test_wikipedia_without_vocab_hashes_into_the_table(tmp_path):
    from oktopk_tpu.data import loaders as jloaders

    (tmp_path / "wikipedia").mkdir()
    (tmp_path / "wikipedia" / "a.txt").write_text(_corpus(4))
    it, meta = loaders.make_dataset("wikipedia", "bert_tiny", 2,
                                    path=str(tmp_path), seed=0)
    jit, _ = jloaders.make_dataset("wikipedia", "bert_tiny", 2,
                                   path=str(tmp_path), seed=0)
    b = next(it)
    _assert_batches_equal(b, next(jit))
    assert b["input_ids"].max() < 1024 and not meta["synthetic"]


# ---------------------------------------------------------------------------
# the native ring and the policy

def test_prefetch_ring_matches_jax():
    from oktopk_tpu.native.loader import make_prefetch_iter as jring
    from oktopk_tpu_torch.native.loader import make_prefetch_iter

    rng = np.random.RandomState(0)
    x = {"image": rng.randn(23, 4, 3).astype(np.float32),
         "label": rng.randint(0, 10, size=(23,)).astype(np.int32)}
    it, jit = make_prefetch_iter(x, 5, seed=9), jring(x, 5, seed=9)
    for _ in range(9):                      # two epochs and more
        _assert_batches_equal(next(it), next(jit))


def test_batched_takes_the_ring_under_the_policy(monkeypatch):
    from oktopk_tpu.data import loaders as jloaders
    from oktopk_tpu_torch.native import loader as ring

    calls = []
    real = ring.make_prefetch_iter

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ring, "make_prefetch_iter", counting)
    x = {"v": np.arange(40, dtype=np.float32).reshape(20, 2)}
    for mode in ("1", "0"):
        monkeypatch.setenv("OKTOPK_NATIVE", mode)
        it, jit = loaders._batched(x, 4, 3), jloaders._batched(x, 4, 3)
        for _ in range(6):
            _assert_batches_equal(next(it), next(jit))
    assert len(calls) == 1                  # the ring under "1" only


def test_native_policy(monkeypatch):
    monkeypatch.setattr(native, "_resolved", {})
    monkeypatch.setenv("OKTOPK_NATIVE", "0")
    assert not native.resolve("loader")
    monkeypatch.setenv("OKTOPK_NATIVE", "auto")
    assert native.resolve("tokenizer") == native.available()
    # auto is off across processes; 1 is on everywhere
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert not native.resolve("tokenizer")
    monkeypatch.setenv("OKTOPK_NATIVE", "1")
    assert native.resolve("tokenizer")


def test_require_raises_when_the_build_fails(monkeypatch, vocab_file):
    monkeypatch.setattr(native, "_resolved", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ["-no-such-flag"])
    monkeypatch.setenv("OKTOPK_NATIVE", "1")
    with pytest.raises(RuntimeError, match="unavailable"):
        native.resolve("loader")
    # the native classes raise too: resolve() alone decides the path
    from oktopk_tpu_torch.native.loader import make_prefetch_iter
    from oktopk_tpu_torch.native.tokenizer import NativeTokenizer
    with pytest.raises(RuntimeError, match="unavailable"):
        NativeTokenizer(vocab_file)
    with pytest.raises(RuntimeError, match="unavailable"):
        make_prefetch_iter({"v": np.zeros((4, 1), np.float32)}, 2)
    monkeypatch.setattr(native, "_resolved", {})
    monkeypatch.setenv("OKTOPK_NATIVE", "auto")
    assert not native.resolve("loader")     # auto falls back in one process
