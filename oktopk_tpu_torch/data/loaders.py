"""Dataset loaders with the synthetic fallback.

Counterpart of ``oktopk_tpu/data/loaders.py:28-290``: the CIFAR-10
pickle batches, the MNIST idx files, the reference's ImageNet HDF5 file
(RandomResizedCrop, flip and normalise in numpy), the PTB text, the AN4
manifests (``data/audio.py``), the Wikipedia sentence-per-line corpus
with its ``vocab.txt`` (``data/bert_pretrain.py``, tokenized by the
native WordPiece tokenizer when ``OKTOPK_NATIVE`` resolves to it, else
by ``data/tokenization.py``, whose hash fallback without a vocab file
is sized to the model's table), and ``make_dataset``, which returns
``(iterator, meta)`` and yields the synthetic batches of the same shapes
(``data/synthetic.py``) when the files are missing, with
``meta["synthetic"]`` True and 50,000 examples an epoch. The same files
and seed give the same batches as the JAX package: the same numpy draws
in the same order, and the native prefetch ring (``native/loader.py``)
for shuffled epochs when the policy resolves to it.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from oktopk_tpu_torch.data.synthetic import synthetic_iterator

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# examples an epoch of the synthetic fallback
SYNTHETIC_EXAMPLES = 50000
# examples an epoch of the AN4 manifests (the JAX package's count)
AN4_EXAMPLES = 948


def _batched(x: Dict[str, np.ndarray], batch_size: int, seed: int,
             shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch batches, reshuffled each epoch from one ``RandomState``; a
    shuffled stream comes from the native prefetch ring when
    ``native.resolve("loader")`` says so (``OKTOPK_NATIVE``)."""
    from oktopk_tpu_torch import native
    if shuffle and native.resolve("loader"):
        from oktopk_tpu_torch.native.loader import make_prefetch_iter
        return make_prefetch_iter(x, batch_size, seed=seed)

    def gen():
        n = len(next(iter(x.values())))
        rng = np.random.RandomState(seed)
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for i in range(0, n - batch_size + 1, batch_size):
                sel = order[i:i + batch_size]
                yield {k: v[sel] for k, v in x.items()}

    return gen()


def load_cifar10(path: str, split: str = "train"):
    """torchvision-layout pickle batches (``cifar-10-batches-py``):
    images NHWC float32, normalised by the CIFAR mean and std."""
    base = os.path.join(path, "cifar-10-batches-py")
    files = ([f"data_batch_{i}" for i in range(1, 6)]
             if split == "train" else ["test_batch"])
    images, labels = [], []
    for f in files:
        with open(os.path.join(base, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        images.append(d[b"data"])
        labels.extend(d[b"labels"])
    x = np.concatenate(images).reshape(-1, 3, 32, 32).astype(np.float32) / 255.
    x = x.transpose(0, 2, 3, 1)
    x = (x - CIFAR_MEAN) / CIFAR_STD
    return {"image": x, "label": np.asarray(labels, np.int32)}


def load_mnist(path: str, split: str = "train"):
    """Raw idx files (``train-images-idx3-ubyte`` etc.)."""
    prefix = "train" if split == "train" else "t10k"
    with open(os.path.join(path, f"{prefix}-images-idx3-ubyte"), "rb") as f:
        f.read(16)
        x = np.frombuffer(f.read(), np.uint8).reshape(-1, 28, 28, 1)
    with open(os.path.join(path, f"{prefix}-labels-idx1-ubyte"), "rb") as f:
        f.read(8)
        y = np.frombuffer(f.read(), np.uint8)
    return {"image": (x.astype(np.float32) / 255. - 0.1307) / 0.3081,
            "label": y.astype(np.int32)}


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of an HWC float32 image (half-pixel centres)."""
    h, w = img.shape[:2]
    if h == out_h and w == out_w:
        return img
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _random_resized_crop(img: np.ndarray, size: int,
                         rng: np.random.RandomState) -> np.ndarray:
    """torchvision's RandomResizedCrop (scale [0.08, 1], ratio [3/4,
    4/3]), the reference's ImageNet transform, in numpy: ten tries, then
    the centre crop of the short side."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(0.08, 1.0)
        ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target * ratio)))
        ch = int(round(np.sqrt(target / ratio)))
        if 0 < cw <= w and 0 < ch <= h:
            y = rng.randint(0, h - ch + 1)
            x = rng.randint(0, w - cw + 1)
            return _bilinear_resize(img[y:y + ch, x:x + cw], size, size)
    s = min(h, w)
    y, x = (h - s) // 2, (w - s) // 2
    return _bilinear_resize(img[y:y + s, x:x + s], size, size)


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    s = min(h, w)
    y, x = (h - s) // 2, (w - s) // 2
    return _bilinear_resize(img[y:y + s, x:x + s], size, size)


def imagenet_hdf5_iterator(h5path: str, batch_size: int,
                           split: str = "train", seed: int = 0,
                           image_size: int = 224,
                           chunk_batches: int = 16):
    """ImageNet batches from the reference's HDF5 layout
    (``imagenet-shuffled.hdf5``: ``{split}_img`` [N, H, W, C] uint8 and
    ``{split}_labels`` [N]). One contiguous slab of ``chunk_batches *
    batch_size`` images a read (the file is pre-shuffled), the slabs and
    the images within one shuffled for training; training images take
    RandomResizedCrop and a horizontal flip, the others the centre crop;
    then the ImageNet mean and std. Yields {"image": [B, size, size, 3]
    float32 NHWC, "label": [B] int32}. ``h5py`` is imported when the
    iterator first runs."""
    def gen():
        import h5py

        rng = np.random.RandomState(seed)
        with h5py.File(h5path, "r", libver="latest", swmr=True) as hf:
            imgs = hf[f"{split}_img"]
            labels = np.asarray(hf[f"{split}_labels"]).astype(np.int32)
            n = imgs.shape[0]
            slab = max(batch_size, chunk_batches * batch_size)
            train = split == "train"
            while True:
                starts = np.arange(0, n - batch_size + 1, slab)
                if train:
                    rng.shuffle(starts)
                for s0 in starts:
                    hi = min(n, s0 + slab)
                    raw = np.asarray(imgs[s0:hi])
                    order = (rng.permutation(hi - s0) if train
                             else np.arange(hi - s0))
                    for b0 in range(0, hi - s0 - batch_size + 1, batch_size):
                        sel = order[b0:b0 + batch_size]
                        out = np.empty(
                            (batch_size, image_size, image_size, 3),
                            np.float32)
                        for j, idx in enumerate(sel):
                            im = raw[idx].astype(np.float32) / 255.0
                            if im.ndim == 2:
                                im = np.repeat(im[:, :, None], 3, axis=2)
                            if train:
                                im = _random_resized_crop(im, image_size,
                                                          rng)
                                if rng.rand() < 0.5:
                                    im = im[:, ::-1]
                            else:
                                im = _center_crop(im, image_size)
                            out[j] = (im - IMAGENET_MEAN) / IMAGENET_STD
                        yield {"image": out, "label": labels[s0 + sel]}

    return gen()


def load_ptb(path: str, split: str = "train", num_steps: int = 35):
    """Word-level PTB: the vocabulary of ``ptb.train.txt`` (sorted), each
    split's ids cut into [N, num_steps] tokens and their next-token
    targets. Returns (arrays, vocabulary size)."""
    def read(fname):
        with open(os.path.join(path, fname)) as f:
            return f.read().replace("\n", " <eos> ").split()

    train_words = read("ptb.train.txt")
    vocab = {w: i for i, w in enumerate(sorted(set(train_words)))}
    words = train_words if split == "train" else read(f"ptb.{split}.txt")
    ids = np.asarray([vocab[w] for w in words if w in vocab], np.int32)
    n = (len(ids) - 1) // num_steps
    toks = ids[:n * num_steps].reshape(-1, num_steps)
    tgts = ids[1:n * num_steps + 1].reshape(-1, num_steps)
    return {"tokens": toks, "targets": tgts}, len(vocab)


def _wikipedia(path: str, dnn: str, batch_size: int, seed: int,
               seq_len: Optional[int]):
    """MLM/NSP batches from ``<path>/wikipedia`` (a file or a directory
    of files) and ``<path>/vocab.txt``."""
    from oktopk_tpu_torch.data.bert_pretrain import pretrain_iterator
    from oktopk_tpu_torch.data.tokenization import FullTokenizer
    corpus = os.path.join(path, "wikipedia")
    if not os.path.exists(corpus):
        raise FileNotFoundError(corpus)
    vocab_file = os.path.join(path, "vocab.txt")
    tok = None
    from oktopk_tpu_torch import native
    if os.path.exists(vocab_file) and native.resolve("tokenizer"):
        from oktopk_tpu_torch.native.tokenizer import NativeTokenizer
        tok = NativeTokenizer(vocab_file)
    vocab_size = 1024 if dnn == "bert_tiny" else 30522
    if tok is None:
        # without a vocab file the hash ids must fall inside the model's
        # embedding table
        tok = FullTokenizer(
            vocab_file if os.path.exists(vocab_file) else None,
            fallback_size=vocab_size)
    seq = seq_len or (32 if dnn == "bert_tiny" else 128)
    return (pretrain_iterator(corpus, tok, batch_size, seq, seed,
                              vocab_size),
            {"synthetic": False, "num_examples": SYNTHETIC_EXAMPLES})


def make_dataset(dataset: str, dnn: str, batch_size: int,
                 path: Optional[str] = None, split: str = "train",
                 seed: int = 0,
                 seq_len: Optional[int] = None) -> Tuple[Iterator, Dict]:
    """(batch iterator, meta) for (dataset, dnn) from the files under
    ``path`` (default ``$OKTOPK_DATA_DIR``, else ``./data``); the
    synthetic batches of the model's family when they are missing."""
    path = path or os.environ.get("OKTOPK_DATA_DIR", "./data")
    try:
        if dataset == "wikipedia":
            return _wikipedia(path, dnn, batch_size, seed, seq_len)
        if dataset == "an4":
            from oktopk_tpu_torch.data.audio import an4_iterator
            manifest = os.path.join(
                path, "an4_train_manifest.csv" if split == "train"
                else "an4_val_manifest.csv")
            if not os.path.exists(manifest):
                raise FileNotFoundError(manifest)
            it = an4_iterator(manifest, batch_size, seed=seed,
                              shuffle=split == "train")
            return it, {"synthetic": False, "num_examples": AN4_EXAMPLES}
        if dataset == "imagenet":
            h5path = os.path.join(path, "imagenet-shuffled.hdf5")
            if not os.path.exists(h5path):
                raise FileNotFoundError(h5path)
            import h5py
            with h5py.File(h5path, "r") as hf:
                key = "train_img" if split == "train" else "val_img"
                num = int(hf[key].shape[0])
            it = imagenet_hdf5_iterator(h5path, batch_size, split=split,
                                        seed=seed)
            return it, {"synthetic": False, "num_examples": num}
        if dataset == "cifar10":
            arrays = load_cifar10(path, split)
        elif dataset == "mnist":
            arrays = load_mnist(path, split)
        elif dataset == "ptb":
            arrays, vocab = load_ptb(os.path.join(path, "ptb"), split)
            return (_batched(arrays, batch_size, seed, split == "train"),
                    {"synthetic": False, "vocab_size": vocab,
                     "num_examples": len(arrays["tokens"])})
        else:
            raise FileNotFoundError(dataset)
        return (_batched(arrays, batch_size, seed, split == "train"),
                {"synthetic": False,
                 "num_examples": len(arrays["label"])})
    except (FileNotFoundError, OSError):
        return (synthetic_iterator(dnn, batch_size, seed, seq_len=seq_len),
                {"synthetic": True, "num_examples": SYNTHETIC_EXAMPLES})
