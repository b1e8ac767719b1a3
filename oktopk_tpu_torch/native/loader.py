"""ctypes wrapper over the native prefetching batch ring
(``native/prefetch.cpp``).

Counterpart of ``oktopk_tpu/native/loader.py`` (the reference's torch
DataLoader workers, VGG/dl_trainer.py:286-343): the dataset is packed
into one contiguous records array and a C++ thread gathers shuffled
batches (splitmix64 Fisher-Yates) into a ring of buffers, so batch
assembly overlaps the step without holding the GIL. One seed gives the
JAX package's ring's batches."""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Iterator

import numpy as np

from oktopk_tpu_torch.native import require


class PrefetchLoader:
    """Iterate shuffled batches of a structured record array.

    ``arrays`` maps field name -> np.ndarray with a common leading dim; the
    fields are packed into one byte-record per example (so one memcpy moves
    an example) and unpacked to the original dtypes/shapes per batch.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1,
                 prefetch_depth: int = 2, drop_last: bool = True):
        lib = require()
        self._lib = lib
        names = sorted(arrays)
        n = arrays[names[0]].shape[0]
        for k in names:
            assert arrays[k].shape[0] == n, f"ragged field {k}"
        if n // max(1, num_shards) == 0:
            raise ValueError(
                f"shard {shard}/{num_shards} of {n} records is empty")

        self._fields = []
        contiguous = {}
        offset = 0
        for k in names:
            a = np.ascontiguousarray(arrays[k])
            contiguous[k] = a
            item_shape = a.shape[1:]
            nbytes = int(a.dtype.itemsize * np.prod(item_shape, dtype=int))
            self._fields.append((k, a.dtype, item_shape, offset, nbytes))
            offset += nbytes
        self._item_bytes = offset
        self.batch_size = batch_size
        self.num_examples = n

        # pack fields into one records buffer (kept alive: the C++ side
        # borrows this pointer for the loader's lifetime)
        self._records = np.empty((n, self._item_bytes), np.uint8)
        for k, dtype, item_shape, off, nbytes in self._fields:
            self._records[:, off:off + nbytes] = (
                contiguous.pop(k).reshape(n, -1).view(np.uint8))
        self._out = np.empty((batch_size, self._item_bytes), np.uint8)

        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._handle = lib.okn_loader_new(
            self._records.ctypes.data_as(u8p), n, self._item_bytes,
            batch_size, seed, shard, num_shards, prefetch_depth,
            1 if drop_last else 0)
        # close() must not free the C loader while another thread is inside
        # okn_loader_next (or between reading the handle and entering it):
        # in-flight calls are counted under _mu and close() drains them
        # after okn_loader_stop wakes any blocked waiter.
        self._mu = threading.Condition()
        self._inflight = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        with self._mu:
            handle = self._handle
            if handle is None:
                count = 0
            else:
                self._inflight += 1
        if handle is not None:
            try:
                count = self._lib.okn_loader_next(
                    handle, self._out.ctypes.data_as(u8p))
            finally:
                with self._mu:
                    self._inflight -= 1
                    self._mu.notify_all()
        batch = self._out[:count]
        out = {}
        for k, dtype, item_shape, off, nbytes in self._fields:
            # copy() (not ascontiguousarray, which no-ops on a contiguous
            # single-field slice): the returned arrays must not alias the
            # ring output buffer the next next_batch() overwrites
            raw = batch[:, off:off + nbytes].copy()
            out[k] = raw.view(dtype).reshape((count,) + item_shape)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def close(self) -> None:
        if getattr(self, "_handle", None) is None:
            return
        with self._mu:
            handle, self._handle = self._handle, None
            if handle is None:
                return
        self._lib.okn_loader_stop(handle)  # wake blocked next_batch calls
        with self._mu:
            while self._inflight:
                self._mu.wait()
        self._lib.okn_loader_free(handle)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_prefetch_iter(arrays: Dict[str, np.ndarray], batch_size: int,
                       seed: int = 0, shard: int = 0,
                       num_shards: int = 1) -> Iterator:
    """Prefetching batch iterator (raises when the native library cannot
    be built; ``native.resolve("loader")`` decides whether to take it)."""
    return iter(PrefetchLoader(arrays, batch_size, seed=seed, shard=shard,
                               num_shards=num_shards))
