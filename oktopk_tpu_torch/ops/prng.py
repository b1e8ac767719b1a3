"""JAX's random keys and dropout masks: threefry2x32-20 on the host and on
the card.

A JAX key is a pair of uint32 words. The key algebra runs on the host in
numpy (uint64 arrays masked to 32 bits), vectorised over any leading
shape, so that one call derives every dropout site's key of a
microbatch:

- ``prng_key(seed)``: ``jax.random.PRNGKey(seed)`` = (0,
  seed & 0xffffffff), as JAX makes it with 64-bit types off (its
  default);
- ``fold_in(key, data)``: the two output words of threefry under ``key``
  at the counter (0, data);
- ``split(key, num)``: key i is threefry's output at the counter (0, i)
  (``jax_threefry_partitionable``, JAX's default);
- ``flax_site_key(rng, suffix)``: the key a flax ``make_rng`` returns,
  ``fold_in(rng, h)`` with h the first four bytes, big-endian, of the
  SHA-1 of the scope path's names and the 1-based count of the scope's
  ``make_rng`` calls (strings as UTF-8, ints as their shortest big-endian
  bytes, no separator: flax's ``_fold_in_static`` with
  ``flax_fix_rng_separator`` off).

``keep_mask(key, shape, keep_prob)`` is ``jax.random.bernoulli(key,
keep_prob, shape)``: element i (flat, row-major) draws the xor of the two
output words at the counter (i >> 32, i & 0xffffffff), and keeps where
``float32((bits >> 9) | 0x3F800000) - 1.0 < keep_prob``. On a CUDA
device it launches ``csrc/threefry.cu`` (one thread per element, the key
passed as two kernel arguments, no host sync); on the CPU it takes
``keep_mask_plain``, the same arithmetic in torch int64 ops. XLA, not a
Pallas kernel, emits JAX's threefry, so the kernel replaces no TPU
kernel; it replaces the port's ``torch.rand`` + compare and, against a
plain int64 threefry on the card, some 150 elementwise launches a mask.

``uniform`` and ``normal`` are ``jax.random.uniform`` and
``jax.random.normal`` (float32) on the CPU, for the MoE gate's init: the
same bit stream, the same unit floats, then XLA's ``erf_inv`` op for op.
The uniform draw is JAX's bit for bit; the normal may differ from it in
the last bits, where torch's ``log1p`` and ``sqrt`` round otherwise.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from oktopk_tpu_torch.ops import _build

# kernel launches (one per call of the C entry point)
LAUNCHES = 0

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# 32-bit integer operations per element of the kernel: 2 counter adds,
# 20 rounds of add + rotate + xor, 5 key injections of 2 adds, and the
# xor, shift and or that make the bits
INT_OPS_PER_ELEMENT = 2 + 20 * 3 + 5 * 2 + 3

Suffix = Sequence[Union[str, int]]


def _threefry_np(k0, k1, x0, x1):
    """Threefry2x32-20 on uint64 arrays holding 32-bit words
    (broadcasting); returns the two output words."""
    m = np.uint64(M32)

    def rotl(v, r):
        return ((v << np.uint64(r)) | (v >> np.uint64(32 - r))) & m

    ks = (k0, k1, (k0 ^ k1 ^ np.uint64(_PARITY)) & m)
    x0 = (x0 + ks[0]) & m
    x1 = (x1 + ks[1]) & m
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & m
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & m
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & m
    return x0, x1


def _words(key) -> Tuple[np.ndarray, np.ndarray]:
    k = np.asarray(key, dtype=np.uint64)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key is [..., 2] uint32 words, got {k.shape}")
    return k[..., 0], k[..., 1]


def _key(x0, x1) -> np.ndarray:
    return np.stack([x0, x1], axis=-1).astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: [2] uint32."""
    return np.array([0, int(seed) & M32], dtype=np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in`` over broadcast keys [..., 2] and uint32
    ``data``: [..., 2] uint32."""
    k0, k1 = _words(key)
    d = np.asarray(data, dtype=np.uint64) & np.uint64(M32)
    return _key(*_threefry_np(k0, k1, np.zeros_like(d), d))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [..., num, 2] uint32."""
    k0, k1 = _words(key)
    i = np.arange(num, dtype=np.uint64)
    return _key(*_threefry_np(k0[..., None], k1[..., None],
                              np.zeros_like(i), i))


def site_hash(suffix: Suffix) -> int:
    """The uint32 flax folds into the rng for a ``make_rng`` suffix."""
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"a suffix holds str and int, got {x!r}")
    return int.from_bytes(m.digest()[:4], byteorder="big")


def flax_site_key(rng, suffix: Suffix) -> np.ndarray:
    """The key flax's ``make_rng`` gives the call named by ``suffix``
    (scope names, then the call's count) under the apply's ``rng``."""
    return fold_in(rng, site_hash(suffix))


def site_keys(rng, hashes: np.ndarray) -> np.ndarray:
    """Every site's key under one ``rng``: ``hashes`` [S] uint32 (from
    ``site_hash``) -> [S, 2] uint32, in one vectorised call."""
    return fold_in(np.asarray(rng)[None, :], hashes)


# ---- the Bernoulli keep mask ---------------------------------------------

def _rotl_t(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def _bits_plain(key, n: int, device=None, offset: int = 0) -> torch.Tensor:
    """JAX's 32-bit random words (``jax.random.bits``, partitionable) in
    torch int64 ops: word i is the xor of threefry's two output words at
    the counter (i >> 32, i & 0xffffffff), for i from ``offset``."""
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint64))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    c = torch.arange(n, dtype=torch.int64, device=device) + offset
    x0 = ((c >> 32) + ks[0]) & M32
    x1 = ((c & M32) + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0 ^ x1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) float32 from the words: ``(bits >> 9) | 0x3F800000`` read as
    a float in [1, 2), minus 1 (< 2^31: exact in int32)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return f.view(torch.float32) - 1.0


def keep_mask_plain(key, shape, keep_prob: float, device=None,
                    offset: int = 0) -> torch.Tensor:
    """The keep mask in torch int64 ops: bool of ``shape``, element i at
    the counter ``offset + i``."""
    n = int(np.prod(shape, dtype=np.int64))
    u = _unit_floats(_bits_plain(key, n, device, offset))
    return (u < torch.tensor(keep_prob, dtype=torch.float32,
                             device=device)).reshape(shape)


# ---- uniform and normal draws (the MoE gate's init) -----------------------

# XLA's single-precision erf_inv (Giles' two branches), as JAX 0.9 lowers
# ``lax.erf_inv`` on the CPU: w = -log1p(x * -x), then a degree-8
# polynomial in w - 2.5 (w < 5) or sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of float32 ``x`` in XLA's arithmetic, op for op;
    its ``log1p`` and ``sqrt`` are torch's, so a value may differ from
    XLA's in the last bits (``tests/test_torch_bert_moe.py`` measures
    how many)."""
    def c(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype))

    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = c(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = c(i) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def uniform(key, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)`` on the CPU: the
    unit floats of the bit stream, ``u * (hi - lo) + lo`` in float32,
    then ``max(lo, .)``."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    lo_t = torch.tensor(lo, dtype=torch.float32)
    hi_t = torch.tensor(hi, dtype=torch.float32)
    u = _unit_floats(_bits_plain(key, n)) * (hi_t - lo_t) + lo_t
    return torch.maximum(lo_t, u.reshape(shape))


def normal(key, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on the CPU: a uniform
    draw on [nextafter(-1, 0), 1), ``erf_inv``, times sqrt(2) in
    float32."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(np.sqrt(2), dtype=torch.float32) * erf_inv(u)


def _keep_mask_cuda(key, shape, keep_prob: float, device,
                    offset: int) -> torch.Tensor:
    global LAUNCHES
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint64))
    out = torch.empty(shape, dtype=torch.bool, device=device)
    n = out.numel()
    if n == 0:
        return out
    lib = _build.library("threefry")
    with torch.cuda.device(device):
        rc = lib.oktopk_keep_mask(
            k0, k1, offset, n, float(np.float32(keep_prob)),
            _build.ptr(out), _build.stream_handle(device))
    _build.check(rc, "threefry keep-mask kernel")
    LAUNCHES += 1
    return out


def keep_mask(key, shape, keep_prob: float, device=None,
              offset: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli(key, keep_prob, shape)`` as a bool tensor on
    ``device``; ``offset`` starts the counters there (a test of counters
    past 2^32 without a 4 GB mask)."""
    device = torch.device("cpu" if device is None else device)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no threefry kernel for device {device}")
    # the plain version counts in int64, the kernel in uint64
    top = 2 ** 63 if device.type == "cpu" else 2 ** 64
    if offset < 0 or offset + n > top:
        raise ValueError(f"counters {offset}..{offset + n} leave the "
                         f"{'int64' if top == 2 ** 63 else 'uint64'} range")
    if device.type == "cpu":
        return keep_mask_plain(key, shape, keep_prob, device, offset)
    return _keep_mask_cuda(key, shape, keep_prob, device, offset)
