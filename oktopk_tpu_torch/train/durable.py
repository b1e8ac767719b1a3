"""Durable checkpoints: atomic, verified, asynchronous.

Counterpart of ``oktopk_tpu/train/durable.py``, over the same files:

- ``atomic_write_bytes``: tmp file -> flush -> fsync -> ``os.replace``
  -> directory fsync, so a reader never sees a torn file;
- manifests: every checkpoint gets a ``ckpt-<step>.manifest.json``
  sidecar with the JAX package's keys (``manifest_version``, ``file``,
  ``step``, ``bytes``, ``digest`` (``crc32:<hex8>``, or xxh64 where the
  library is importable), ``qualified``, ``environment``, ``created``);
  ``environment`` is the port's copy of the JAX package's
  ``autotune/journal.py::environment_header`` (the same keys, ``jax``
  and ``jaxlib`` None, plus ``torch`` and ``cuda``);
- verification (``verify_checkpoint``, ``latest_verified_checkpoint``,
  ``verified_restore``): candidates newest -> oldest, past size or
  digest mismatches; a file without a manifest is accepted as legacy;
  the file is read and digested once, and the verified bytes are what
  ``checkpoint.read_payload`` decodes;
- ``apply_retention`` (keep the newest N and the newest qualified one),
  ``clean_stale_tmp`` (``*.tmp`` remnants older than an hour);
- ``AsyncCheckpointer``: ``save`` copies the state to host memory before
  it returns (the port's trainer updates its tensors in place, so the
  copy is the snapshot), and a background thread encodes, writes,
  verifies and applies retention; ``drain`` is the exit barrier.

The ``bus`` and ``journal`` hooks stay optional parameters (``None``
until the port's event journal exists, ROADMAP.md). The port writes and
reads the bytes itself (``train/msgpack.py``) as a list of buffers, so a
multi-gigabyte state is written and digested without a joined copy.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from oktopk_tpu_torch.train.msgpack import Buffer

MANIFEST_VERSION = 1
MANIFEST_SUFFIX = ".manifest.json"
# the JAX package's event schema version (oktopk_tpu/obs/events.py), the
# one the manifests' environment header records
SCHEMA_VERSION = 1

_log = logging.getLogger("oktopk_tpu_torch")

Data = Union[bytes, bytearray, memoryview, Sequence[Buffer]]


def _parts(data: Data) -> Sequence[Buffer]:
    return [data] if isinstance(data, (bytes, bytearray, memoryview)) \
        else data


def _nbytes(data: Data) -> int:
    return sum(memoryview(b).nbytes for b in _parts(data))


def environment_header() -> Dict[str, Any]:
    """The environment the manifests record: the keys of the JAX
    package's ``environment_header`` (``jax`` and ``jaxlib`` None here),
    plus ``torch`` and ``cuda``; ``platform`` is "gpu" or "cpu",
    ``device_kind`` the card's name, ``world_size`` the processes of a
    ``torch.distributed`` run (else 1)."""
    hdr: Dict[str, Any] = {"jax": None, "jaxlib": None,
                           "schema_version": SCHEMA_VERSION}
    try:
        import torch
        hdr["torch"] = torch.__version__
        hdr["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            hdr.update(platform="gpu",
                       device_kind=torch.cuda.get_device_name(0))
        else:
            hdr.update(platform="cpu", device_kind="cpu")
        dist = torch.distributed
        hdr["world_size"] = (dist.get_world_size()
                             if dist.is_available() and dist.is_initialized()
                             else 1)
    except Exception:
        hdr.update(device_kind=None, platform=None, world_size=0)
    return hdr


# ---------------------------------------------------------------------------
# digests

def _crc32(data: Data) -> str:
    crc = 0
    for b in _parts(data):
        crc = zlib.crc32(b, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


_DIGESTS: Dict[str, Callable[[Data], str]] = {"crc32": _crc32}
try:  # optional: only where the library is importable
    import xxhash as _xxhash

    def _xxh64(data: Data) -> str:
        h = _xxhash.xxh64()
        for b in _parts(data):
            h.update(b)
        return h.hexdigest()

    _DIGESTS["xxh64"] = _xxh64
except Exception:  # pragma: no cover - xxhash is not a dependency
    pass

DEFAULT_DIGEST = "crc32"


def compute_digest(data: Data, algo: str = DEFAULT_DIGEST) -> str:
    """``"<algo>:<hex>"`` of ``data`` (crc32 always available; xxh64 when
    the library exists — the manifest records which, so a file written
    with one can verify on a host that has both)."""
    if algo not in _DIGESTS:
        raise ValueError(f"unknown digest algo {algo!r}; "
                         f"one of {sorted(_DIGESTS)}")
    return f"{algo}:{_DIGESTS[algo](data)}"


def _digest_matches(data: Data, recorded: str) -> Optional[bool]:
    """True/False when the recorded digest's algo is computable here,
    None when it is not (treated as unverifiable, not corrupt)."""
    algo = recorded.split(":", 1)[0]
    if algo not in _DIGESTS:
        return None
    return compute_digest(data, algo) == recorded


# ---------------------------------------------------------------------------
# atomic, torn-write-safe file publication

def fsync_dir(dirpath: str) -> None:
    """fsync a directory so a just-published rename survives power loss
    (best-effort: not every filesystem exposes a dir fd)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: Data) -> None:
    """tmp-file -> flush -> fsync -> ``os.replace`` -> dir fsync: a
    reader never sees a partial file, and a crash between any two steps
    leaves either the old file or a ``*.tmp`` remnant (which the
    checkpoint scan garbage-collects), never a torn publish. ``data`` is
    one buffer or a sequence of buffers written in order."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for b in _parts(data):
            f.write(b)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def clean_stale_tmp(ckpt_dir: str, max_age_s: float = 3600.0) -> List[str]:
    """Remove ``*.tmp`` remnants left by a crashed writer. Only files
    older than ``max_age_s`` go — an in-flight :class:`AsyncCheckpointer`
    write must not have its tmp file deleted from under it."""
    removed: List[str] = []
    if not os.path.isdir(ckpt_dir):
        return removed
    now = time.time()
    for name in os.listdir(ckpt_dir):
        if not name.endswith(".tmp"):
            continue
        path = os.path.join(ckpt_dir, name)
        try:
            if now - os.path.getmtime(path) >= max_age_s:
                os.remove(path)
                removed.append(path)
        except OSError:
            continue
    return removed


# ---------------------------------------------------------------------------
# manifests

def manifest_path(ckpt_path: str) -> str:
    """``ckpt-<step>.msgpack`` -> ``ckpt-<step>.manifest.json``."""
    base = ckpt_path
    if base.endswith(".msgpack"):
        base = base[: -len(".msgpack")]
    return base + MANIFEST_SUFFIX


def write_manifest(ckpt_path: str, step: int, data: Data,
                   qualified: bool = True,
                   digest_algo: str = DEFAULT_DIGEST) -> Dict[str, Any]:
    """Publish the sidecar manifest for an already-published checkpoint
    file. Written atomically AFTER the data file: a crash in between
    leaves a fully-written but manifest-less checkpoint, which the
    verifying path accepts as legacy (with a journalled warning) rather
    than rejecting a good file."""
    man = {
        "manifest_version": MANIFEST_VERSION,
        "file": os.path.basename(ckpt_path),
        "step": int(step),
        "bytes": _nbytes(data),
        "digest": compute_digest(data, digest_algo),
        "qualified": bool(qualified),
        "environment": environment_header(),
        "created": time.time(),
    }
    atomic_write_bytes(manifest_path(ckpt_path),
                       (json.dumps(man, sort_keys=True) + "\n").encode())
    return man


def read_manifest(ckpt_path: str) -> Optional[Dict[str, Any]]:
    """The parsed sidecar manifest, or None when absent/unparseable."""
    try:
        with open(manifest_path(ckpt_path)) as f:
            man = json.load(f)
        return man if isinstance(man, dict) else None
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# verification

@dataclasses.dataclass
class VerifyResult:
    """Verdict for one checkpoint file."""

    path: str
    ok: bool
    reason: str = "ok"           # why it failed (or "ok" / "no_manifest")
    legacy: bool = False         # no manifest: accepted, but unverifiable
    qualified: bool = True       # manifest's qualified bit (True if legacy)
    manifest: Optional[Dict[str, Any]] = None
    env_mismatch: bool = False   # saved under a different schema


def read_file(path: str) -> bytearray:
    """The whole file in one writable buffer (arrays decoded from it are
    writable views, with no further copy)."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        got = f.readinto(buf)
    if got != size:
        raise OSError(f"short read of {path}: {got} of {size} B")
    return buf


def _verify(ckpt_path: str, deep: bool = False
            ) -> Tuple[VerifyResult, Optional[bytearray]]:
    """``verify_checkpoint``'s verdict and the bytes it read (None when
    the file could not be read)."""
    if not os.path.isfile(ckpt_path):
        return VerifyResult(ckpt_path, False, reason="missing_file"), None
    try:
        data = read_file(ckpt_path)
    except OSError as e:
        return (VerifyResult(ckpt_path, False, reason=f"unreadable: {e}"),
                None)
    if not data:
        return VerifyResult(ckpt_path, False, reason="empty_file"), data

    man = read_manifest(ckpt_path)
    if man is None:
        res = VerifyResult(ckpt_path, True, reason="no_manifest",
                           legacy=True)
    else:
        if int(man.get("bytes", -1)) != len(data):
            return VerifyResult(
                ckpt_path, False, manifest=man,
                qualified=bool(man.get("qualified", True)),
                reason=f"size_mismatch: manifest {man.get('bytes')} B "
                       f"vs file {len(data)} B"), data
        match = _digest_matches(data, str(man.get("digest", "")))
        if match is False:
            return VerifyResult(
                ckpt_path, False, manifest=man,
                qualified=bool(man.get("qualified", True)),
                reason="digest_mismatch"), data
        env = man.get("environment") or {}
        env_mismatch = (env.get("schema_version") is not None
                        and int(env["schema_version"]) != SCHEMA_VERSION)
        res = VerifyResult(ckpt_path, True, manifest=man,
                           qualified=bool(man.get("qualified", True)),
                           reason=("digest_unverifiable"
                                   if match is None else "ok"),
                           env_mismatch=env_mismatch)
    if deep:
        try:
            from oktopk_tpu_torch.train import msgpack
            msgpack.decode(data)
        except Exception as e:
            return VerifyResult(ckpt_path, False, legacy=res.legacy,
                                manifest=res.manifest,
                                qualified=res.qualified,
                                reason=f"decode_error: {type(e).__name__}"
                                ), data
    return res, data


def verify_checkpoint(ckpt_path: str, deep: bool = False) -> VerifyResult:
    """Check one checkpoint file against its manifest.

    Failure modes, in check order: missing/empty file; manifest present
    but size mismatched (truncation / torn write); digest mismatched
    (bit rot / flipped bytes). A missing manifest is NOT a failure — the
    file predates manifests — but flags ``legacy``. ``deep=True`` also
    decodes the msgpack container."""
    return _verify(ckpt_path, deep)[0]


def scan_checkpoints(ckpt_dir: str, prefix: str = "ckpt",
                     clean_tmp: bool = True,
                     stale_tmp_age_s: float = 3600.0
                     ) -> List[Tuple[int, str]]:
    """``[(step, path), ...]`` newest first; optionally garbage-collects
    stale ``*.tmp`` remnants on the way through."""
    if not os.path.isdir(ckpt_dir):
        return []
    if clean_tmp:
        clean_stale_tmp(ckpt_dir, max_age_s=stale_tmp_age_s)
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith(prefix + "-") and name.endswith(".msgpack"):
            try:
                out.append((int(name[len(prefix) + 1:-len(".msgpack")]),
                            os.path.join(ckpt_dir, name)))
            except ValueError:
                continue
    return sorted(out, reverse=True)


def candidate_paths(ckpt_dir_or_file: str, prefix: str = "ckpt"
                    ) -> List[str]:
    """Restore candidates newest -> oldest. A directory yields its whole
    scan; a file yields that file first, then any strictly-older
    siblings with the same prefix (the fallback ladder for a supervisor
    restore whose registered target turns out corrupt)."""
    if os.path.isdir(ckpt_dir_or_file):
        return [p for _, p in scan_checkpoints(ckpt_dir_or_file, prefix)]
    d, name = os.path.split(ckpt_dir_or_file)
    step = None
    if name.startswith(prefix + "-") and name.endswith(".msgpack"):
        try:
            step = int(name[len(prefix) + 1:-len(".msgpack")])
        except ValueError:
            step = None
    if step is None:
        return [ckpt_dir_or_file]
    older = [p for s, p in scan_checkpoints(d, prefix) if s < step]
    return [ckpt_dir_or_file] + older


def _emit(journal, bus, event: str, **fields) -> None:
    """One durable-plane event onto whichever sink the caller has: the
    health journal (which forwards to the bus itself) wins over a bare
    bus so the event is never double-delivered."""
    if journal is not None:
        journal.record(event, **fields)
    elif bus is not None:
        bus.emit(event, **fields)


def latest_verified_checkpoint(ckpt_dir: str, prefix: str = "ckpt",
                               bus=None, journal=None,
                               step: int = 0) -> Optional[str]:
    """Newest checkpoint that passes verification (legacy accepted),
    journalling a ``ckpt_verify_failed`` for each newer file skipped —
    the verifying replacement for ``checkpoint.latest_checkpoint`` on
    every resume path."""
    for path in candidate_paths(ckpt_dir, prefix):
        v = verify_checkpoint(path)
        if v.ok:
            return path
        _emit(journal, bus, "ckpt_verify_failed", step=int(step),
              path=path, reason=v.reason)
        _log.warning("checkpoint %s failed verification (%s); skipping",
                     path, v.reason)
    return None


def verified_restore(ckpt_dir_or_file: str, state_template: Any,
                     prefix: str = "ckpt", bus=None, journal=None,
                     step: int = 0, force: bool = False
                     ) -> Tuple[Any, int, str, int, bool]:
    """Restore from the newest checkpoint that verifies AND decodes,
    walking candidates newest -> oldest.

    Returns ``(state, ckpt_step, path, fallback_depth, legacy)`` where
    ``fallback_depth`` counts the newer checkpoints that had to be
    skipped (0 = the intended target loaded). Journals one
    ``ckpt_verify_failed`` per rejected file (digest/size mismatch,
    torn write, undecodable legacy) and one ``ckpt_restore`` for the
    winner, so the incident timeline shows exactly how far back the run
    had to reach. Raises ``FileNotFoundError`` when no candidate is
    restorable; a template/checkpoint structure mismatch beyond the
    merge threshold raises ``ValueError`` *without* falling back — a
    wrong ``--model`` must fail loudly, not restore an older wrong
    checkpoint (``force=True`` is the escape hatch)."""
    from oktopk_tpu_torch.train import checkpoint as ckpt

    depth = 0
    candidates = candidate_paths(ckpt_dir_or_file, prefix)
    for path in candidates:
        v, data = _verify(path)
        if not v.ok:
            _emit(journal, bus, "ckpt_verify_failed", step=int(step),
                  path=path, reason=v.reason)
            _log.warning("checkpoint %s failed verification (%s); "
                         "falling back", path, v.reason)
            depth += 1
            continue
        try:
            raw = ckpt.read_payload(path, data=data)
        except Exception as e:
            # digest-clean files cannot hit this; an unverifiable legacy
            # file (truncated before manifests existed) can
            _emit(journal, bus, "ckpt_verify_failed", step=int(step),
                  path=path, reason=f"decode_error: {type(e).__name__}")
            _log.warning("checkpoint %s undecodable (%r); falling back",
                         path, e)
            depth += 1
            continue
        if v.legacy:
            _log.warning("checkpoint %s has no manifest (predates the "
                         "manifests): restoring unverified",
                         path)
        if v.env_mismatch:
            _log.warning("checkpoint %s was saved under a different "
                         "journal schema: %s", path,
                         (v.manifest or {}).get("environment"))
        state, ckpt_step = ckpt.apply_template(raw, state_template,
                                               path=path, force=force)
        _emit(journal, bus, "ckpt_restore", step=int(step), path=path,
              ckpt_step=int(ckpt_step), fallback_depth=depth,
              legacy=bool(v.legacy))
        return state, int(ckpt_step), path, depth, bool(v.legacy)
    raise FileNotFoundError(
        f"no restorable checkpoint in {ckpt_dir_or_file!r} "
        f"({len(candidates)} candidate(s), all failed verification)")


# ---------------------------------------------------------------------------
# retention

def apply_retention(ckpt_dir: str, prefix: str = "ckpt",
                    keep_last: int = 0, pin_qualified: bool = True
                    ) -> List[str]:
    """Delete checkpoints (and their manifests) beyond the newest
    ``keep_last``, always keeping the newest *qualified* one so the
    supervisor's divergence restore never loses its target
    (``keep_last=0`` disables retention entirely). Returns the deleted
    paths."""
    if keep_last <= 0:
        return []
    entries = scan_checkpoints(ckpt_dir, prefix, clean_tmp=False)
    keep = {p for _, p in entries[:keep_last]}
    if pin_qualified:
        for _, p in entries:
            man = read_manifest(p)
            if man is None or man.get("qualified", True):
                keep.add(p)   # legacy files count as qualified: never
                break         # garbage-collect the only restore target
    deleted = []
    for _, p in entries:
        if p in keep:
            continue
        for f in (p, manifest_path(p)):
            try:
                os.remove(f)
            except OSError:
                continue
        deleted.append(p)
    return deleted


# ---------------------------------------------------------------------------
# async checkpointing

class AsyncCheckpointer:
    """Non-blocking checkpoint writer with a bounded queue.

    ``save()`` copies the state to host memory on the caller thread
    (``checkpoint.host_tree``: every tensor into a fresh host array, so
    later in-place updates of the live state cannot reach the file) and
    enqueues it; a daemon worker serialises, writes atomically
    (fsync + ``os.replace`` via ``checkpoint.save_checkpoint``),
    re-reads and verifies the published file against its manifest, and
    applies the retention policy. The queue depth bounds host memory:
    when ``queue_depth`` snapshots are already in flight, ``save()``
    blocks — training throttles rather than OOMing on a slow disk.

    Failures are escalated, never swallowed: a write or post-write
    verify error journals ``ckpt_verify_failed`` (reason
    ``write_failed: ...``), increments ``write_failures`` and invokes
    ``on_failure(step, path, exc)`` when given.

    **Barrier-on-exit:** callers must :meth:`drain` (or :meth:`close`)
    before exiting — the preemption epilogue and ``main_trainer.py`` do
    — so an async save in flight at preemption time is published whole,
    never torn.
    """

    def __init__(self, ckpt_dir: str, prefix: str = "ckpt",
                 queue_depth: int = 2, keep_last: int = 0,
                 pin_qualified: bool = True, bus=None, journal=None,
                 on_failure: Optional[Callable[[int, str, BaseException],
                                               None]] = None,
                 verify: bool = True):
        self.ckpt_dir = ckpt_dir
        self.prefix = prefix
        self.keep_last = int(keep_last)
        self.pin_qualified = bool(pin_qualified)
        self.bus = bus
        self.journal = journal
        self.on_failure = on_failure
        self.verify = bool(verify)
        self.saves = 0              # completed, verified saves
        self.verify_failures = 0    # post-write verification failures
        self.write_failures = 0     # any failed save (verify included)
        self.last_path: Optional[str] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        self._pending = 0
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, name="oktopk-torch-async-ckpt",
            daemon=True)
        self._thread.start()

    # ---- producer side ------------------------------------------------

    def path_for(self, step: int) -> str:
        from oktopk_tpu_torch.train.checkpoint import checkpoint_path

        return checkpoint_path(self.ckpt_dir, step, self.prefix)

    def save(self, state: Any, step: int, extra: Optional[dict] = None,
             qualified: bool = True) -> str:
        """Copy ``state`` to host memory and enqueue the write; returns the
        path the checkpoint WILL occupy once published (a restore that
        races the write falls back to an older verified file)."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        from oktopk_tpu_torch.train.checkpoint import host_tree

        host = host_tree(state)
        with self._cond:
            self._pending += 1
        self._q.put((host, int(step), extra, bool(qualified)))
        return self.path_for(step)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued save has been written and verified
        (the exit barrier). Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending > 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def close(self, timeout: Optional[float] = None) -> bool:
        """Drain, then stop the worker thread."""
        drained = self.drain(timeout)
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout)
        return drained

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- worker side --------------------------------------------------

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            host, step, extra, qualified = item
            path = self.path_for(step)
            t0 = time.monotonic()
            try:
                from oktopk_tpu_torch.train.checkpoint import save_checkpoint

                path = save_checkpoint(self.ckpt_dir, host, step,
                                       prefix=self.prefix, extra=extra,
                                       qualified=qualified)
                if self.verify:
                    v = verify_checkpoint(path)
                    if not v.ok:
                        self.verify_failures += 1
                        raise RuntimeError(
                            f"post-write verification failed: {v.reason}")
                if self.keep_last:
                    apply_retention(self.ckpt_dir, self.prefix,
                                    self.keep_last, self.pin_qualified)
                self.saves += 1
                self.last_path = path
                man = read_manifest(path) or {}
                _emit(self.journal, self.bus, "ckpt_saved",
                      step=int(step), path=path,
                      bytes=int(man.get("bytes", 0)),
                      digest=str(man.get("digest", "")),
                      qualified=bool(qualified), source="async",
                      duration_ms=(time.monotonic() - t0) * 1e3)
            except Exception as e:
                self.write_failures += 1
                _emit(self.journal, self.bus, "ckpt_verify_failed",
                      step=int(step), path=path,
                      reason=f"write_failed: {type(e).__name__}: {e}")
                _log.error("async checkpoint save @ step %d failed: %r",
                           step, e)
                if self.on_failure is not None:
                    try:
                        self.on_failure(step, path, e)
                    except Exception:  # escalation must not kill the
                        pass           # writer thread
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()
