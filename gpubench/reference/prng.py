"""JAX's random keys and flax's dropout masks, in numpy and torch int64.

A JAX key is two uint32 words. ``threefry`` is Threefry2x32 with 20
rounds (Salmon et al., SC'11), as ``jax.random`` runs it with its
default ``jax_threefry_partitionable``:

- ``prng_key(seed)`` = (0, seed mod 2^32);
- ``fold_in(key, d)`` = threefry(key, (0, d));
- ``split(key, num)``: key i = threefry(key, (0, i));
- flax's ``make_rng`` of a scope path = ``fold_in(rng, h)``, h the first
  four bytes (big-endian) of the SHA-1 of the path's names and the
  1-based count of the scope's calls (strings as UTF-8, integers as their
  shortest big-endian bytes);
- ``jax.random.bernoulli(key, p, shape)``: element i draws the xor of the
  two output words at the counter (i >> 32, i mod 2^32) and keeps where
  ``float32((bits >> 9) | 0x3F800000) - 1 < p``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rounds(k0, k1, x0, x1, rotl):
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _threefry_py(key, x0: int, x1: int):
    k0, k1 = int(key[0]), int(key[1])

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & M32

    return _rounds(k0, k1, x0, x1, rotl)


def prng_key(seed: int) -> tuple:
    return (0, int(seed) & M32)


def fold_in(key, data: int) -> tuple:
    return _threefry_py(key, 0, int(data) & M32)


def split(key, num: int = 2) -> list:
    return [_threefry_py(key, 0, i) for i in range(num)]


def site_hash(suffix) -> int:
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return int.from_bytes(m.digest()[:4], "big")


def site_key(rng, suffix) -> tuple:
    return fold_in(rng, site_hash(suffix))


def keep_mask(key, shape, keep_prob: float, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, keep_prob, shape)`` in torch int64 ops."""
    n = int(np.prod(shape, dtype=np.int64))
    k0, k1 = int(key[0]), int(key[1])
    c = torch.arange(n, dtype=torch.int64, device=device)

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & M32

    x0, x1 = _rounds(k0, k1, c >> 32, c & M32, rotl)
    bits = x0 ^ x1
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (u < float(np.float32(keep_prob))).reshape(tuple(shape))
