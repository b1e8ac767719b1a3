"""The port's embedding backward (``models/layers.py::embedding_grad``).

On a card, CUDA's embedding backward takes a sort-based kernel above
3,072 indices whose sums are not repeatable from run to run; the port
adds the gradient ``EMBED_GRAD_CHUNK`` indices at a time, the chunks in
order, so a pipeline data row's lookup (32 x 128 ids at BERT-base)
repeats bit for bit. On the CPU it is one ``embedding_dense_backward``,
as before. The card case runs with ``pytest -m cuda`` on the chip
(``chip_smoke.py``'s ``pipeline`` phase checks it too).
"""

import pytest
import torch

from oktopk_tpu_torch.models.layers import (EMBED_GRAD_CHUNK, Embedding,
                                            embedding_grad)


@pytest.mark.parametrize("n", [EMBED_GRAD_CHUNK, 4096])
def test_cpu_embedding_grad_is_one_dense_backward(n):
    gen = torch.Generator().manual_seed(n)
    ids = torch.randint(0, 64, (n,), generator=gen)
    g = torch.randn((n, 8), generator=gen)
    want = torch.ops.aten.embedding_dense_backward(g, ids, 64, -1, False)
    assert torch.equal(embedding_grad(g, ids, 64), want)
    emb = Embedding(64, 8)
    emb(ids).backward(g)
    assert torch.equal(emb.weight.grad, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_embedding_grad_repeats_above_the_chunk(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.randint(0, 30522, (32, 128), generator=gen,
                        device=cuda_device)
    ids[:, ::7] = 103
    g = torch.randn((32, 128, 768), generator=gen, device=cuda_device)
    first = embedding_grad(g, ids, 30522)
    for _ in range(8):
        assert torch.equal(embedding_grad(g, ids, 30522), first)
    # against the float64 sums, within the float32 bound of a sum of n
    # terms in any order, n u sum|g| (the [MASK] row adds 608 of them)
    ids64, g64 = ids.cpu(), g.cpu().double()
    want = torch.ops.aten.embedding_dense_backward(g64, ids64, 30522, -1,
                                                   False)
    abs_sum = torch.ops.aten.embedding_dense_backward(g64.abs(), ids64,
                                                      30522, -1, False)
    n = torch.bincount(ids64.reshape(-1), minlength=30522).double()
    bound = n[:, None] * 2.0 ** -24 * abs_sum
    assert bool(((first.cpu().double() - want).abs() <= bound).all())
    emb = Embedding(30522, 768).to(cuda_device)
    emb(ids).backward(g)
    assert torch.equal(emb.weight.grad, first)
