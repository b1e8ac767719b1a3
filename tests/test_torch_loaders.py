"""The port's dataset loaders (``oktopk_tpu_torch/data/loaders.py``)
against the JAX package's, on files the tests write in each format (a
CIFAR-10 pickle batch, MNIST idx files, an ImageNet HDF5 file as
``tests/test_data_pipelines.py`` builds it, PTB text) and the same seed:
batches bit-equal. The JAX side takes its Python path
(``OKTOPK_NATIVE=0``): the port has no native prefetch ring yet and
never reads that variable. Then the synthetic fallback and its
``meta``, and ``main_trainer --data-dir`` on the CPU.
"""

import logging
import os
import pickle

import numpy as np
import pytest
import torch

from oktopk_tpu.data import loaders as jax_loaders

from oktopk_tpu_torch.data import loaders
from oktopk_tpu_torch.data.synthetic import synthetic_batch


def write_cifar(root, n=20, seed=0):
    """``cifar-10-batches-py`` with five training batches of ``n`` images
    and a test batch, in torchvision's pickle layout."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.randint(0, 256, (n, 3 * 32 * 32), dtype=np.uint8),
             b"labels": rng.randint(0, 10, n).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)


def write_mnist(root, n=30, seed=0):
    rng = np.random.RandomState(seed)
    for prefix in ("train", "t10k"):
        with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"),
                  "wb") as f:
            f.write(b"\0" * 16 + rng.randint(0, 256, n * 784,
                                            dtype=np.uint8).tobytes())
        with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"),
                  "wb") as f:
            f.write(b"\0" * 8 + rng.randint(0, 10, n,
                                           dtype=np.uint8).tobytes())


def write_imagenet(root):
    import h5py
    rng = np.random.RandomState(0)
    with h5py.File(os.path.join(root, "imagenet-shuffled.hdf5"), "w") as hf:
        hf["train_img"] = rng.randint(0, 256, size=(12, 48, 56, 3),
                                      dtype=np.uint8)
        hf["train_labels"] = rng.randint(0, 1000, size=(12,))
        hf["val_img"] = rng.randint(0, 256, size=(6, 48, 56, 3),
                                    dtype=np.uint8)
        hf["val_labels"] = rng.randint(0, 1000, size=(6,))


def write_ptb(root):
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(40)]
    os.makedirs(os.path.join(root, "ptb"), exist_ok=True)
    for split in ("train", "valid", "test"):
        lines = [" ".join(rng.choice(words, rng.randint(3, 12)))
                 for _ in range(60)]
        with open(os.path.join(root, "ptb", f"ptb.{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    write_cifar(root)
    write_mnist(root)
    write_imagenet(root)
    write_ptb(root)
    return root


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The small models' convolutions are far too small to share among
    threads; one thread for these tests, the old count restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def python_path(monkeypatch):
    """The JAX package's Python loader path (not its native ring)."""
    monkeypatch.setenv("OKTOPK_NATIVE", "0")


def assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dataset,dnn,split,bs", [
    ("cifar10", "resnet20", "train", 8), ("cifar10", "vgg16", "test", 6),
    ("mnist", "mnistnet", "train", 7), ("mnist", "mnistnet", "test", 10),
    ("imagenet", "resnet50", "train", 4), ("imagenet", "resnet50", "val", 3),
    ("ptb", "lstm", "train", 5), ("ptb", "lstm", "valid", 4)])
def test_batches_equal_jax(data_dir, python_path, dataset, dnn, split, bs):
    """Across an epoch boundary (and, for ImageNet, across slabs): the
    same batches, the same meta."""
    it, meta = loaders.make_dataset(dataset, dnn, bs, path=data_dir,
                                    split=split, seed=3)
    jit, jmeta = jax_loaders.make_dataset(dataset, dnn, bs, path=data_dir,
                                          split=split, seed=3)
    assert meta == jmeta and meta["synthetic"] is False
    for _ in range(5):
        assert_batches_equal(next(it), next(jit))


def test_loader_functions_equal_jax(data_dir):
    for a, b in ((loaders.load_cifar10(data_dir),
                  jax_loaders.load_cifar10(data_dir)),
                 (loaders.load_mnist(data_dir, "test"),
                  jax_loaders.load_mnist(data_dir, "test")),
                 (loaders.load_ptb(os.path.join(data_dir, "ptb"))[0],
                  jax_loaders.load_ptb(os.path.join(data_dir, "ptb"))[0])):
        assert_batches_equal(a, b)
    rng = np.random.RandomState(0)
    img = rng.rand(37, 53, 3).astype(np.float32)
    for size in (16, 64):
        np.testing.assert_array_equal(
            loaders._bilinear_resize(img, size, size + 3),
            jax_loaders._bilinear_resize(img, size, size + 3))
        np.testing.assert_array_equal(loaders._center_crop(img, size),
                                      jax_loaders._center_crop(img, size))
        np.testing.assert_array_equal(
            loaders._random_resized_crop(img, size,
                                         np.random.RandomState(size)),
            jax_loaders._random_resized_crop(img, size,
                                             np.random.RandomState(size)))


@pytest.mark.parametrize("dataset,dnn", [
    ("cifar10", "resnet20"), ("mnist", "mnistnet"),
    ("imagenet", "resnet50"), ("ptb", "lstm_tiny"), ("an4", "lstman4_tiny"),
    ("wikipedia", "bert_tiny")])
def test_synthetic_fallback_and_meta(tmp_path, python_path, dataset, dnn):
    """No files: the model family's synthetic batches, the JAX meta."""
    it, meta = loaders.make_dataset(dataset, dnn, 4, path=str(tmp_path),
                                    seed=2)
    jit, jmeta = jax_loaders.make_dataset(dataset, dnn, 4,
                                          path=str(tmp_path), seed=2)
    assert meta == jmeta == {"synthetic": True, "num_examples": 50000}
    assert_batches_equal(next(it), next(jit))
    assert_batches_equal(next(it),
                         synthetic_batch(dnn, 4, _second_draw(dnn, 2)))


def _second_draw(dnn, seed):
    rng = np.random.RandomState(seed)
    synthetic_batch(dnn, 4, rng)
    return rng


def test_unported_loaders_raise_with_their_files(tmp_path):
    """The AN4 and Wikipedia loaders were the last unported ones; with
    their files present they are now taken, with the JAX meta (their
    batches are held in ``tests/test_torch_text_data.py``)."""
    (tmp_path / "an4_train_manifest.csv").write_text("a.wav,a.txt\n")
    (tmp_path / "wikipedia").mkdir()
    for dataset, dnn in (("an4", "lstman4"), ("wikipedia", "bert_base")):
        _, meta = loaders.make_dataset(dataset, dnn, 2, path=str(tmp_path))
        _, jmeta = jax_loaders.make_dataset(dataset, dnn, 2,
                                            path=str(tmp_path))
        assert meta == jmeta and meta["synthetic"] is False


def test_data_dir_from_the_environment(data_dir, monkeypatch):
    monkeypatch.setenv("OKTOPK_DATA_DIR", data_dir)
    _, meta = loaders.make_dataset("mnist", "mnistnet", 2)
    assert meta == {"synthetic": False, "num_examples": 30}


@pytest.mark.parametrize("dnn,dataset", [("mnistnet", "mnist"),
                                         ("caffe_cifar", "cifar10")])
def test_main_trainer_data_dir_on_cpu(data_dir, dnn, dataset, caplog):
    """The CLI trains from the files (no synthetic warning), an epoch
    being the files' examples over the global batch."""
    from oktopk_tpu_torch.train import main_trainer

    argv = ["--dnn", dnn, "--dataset", dataset, "--data-dir", data_dir,
            "--device", "cpu", "--num-workers", "2", "--batch-size", "2",
            "--max-iters", "2", "--warmup-steps", "1", "--log-every", "1",
            "--density", "0.05"]
    with caplog.at_level(logging.INFO, logger="oktopk_tpu_torch"):
        assert main_trainer.main(argv) == 0
    assert "synthetic" not in caplog.text
    assert "iter 2 loss" in caplog.text
    trainer, data, _, meta = main_trainer.build_trainer(
        main_trainer.parse_args(argv))
    assert meta == {"synthetic": False,
                    "num_examples": 30 if dataset == "mnist" else 100}
    epochs = main_trainer.parse_args(["--batch-size", "2", "--max-epochs",
                                      "2"])
    assert main_trainer.iterations(epochs, 2, meta["num_examples"]) == (
        2 * (meta["num_examples"] // 4))
    batch = next(data)
    assert batch["image"].shape[0] == 4


def test_main_trainer_warns_without_files(tmp_path, caplog):
    from oktopk_tpu_torch.train import main_trainer

    with caplog.at_level(logging.WARNING, logger="oktopk_tpu_torch"):
        assert main_trainer.main([
            "--dnn", "mnistnet", "--dataset", "mnist", "--data-dir",
            str(tmp_path), "--device", "cpu", "--num-workers", "1",
            "--batch-size", "2", "--max-iters", "1"]) == 0
    assert "not found on disk: using synthetic data" in caplog.text
