"""The repository's native (C++) host components, bound through ctypes.

Counterpart of ``oktopk_tpu/native/__init__.py``. The sources are the
repository's ``native/`` directory, read only:

- ``native/wordpiece.cpp``: the WordPiece tokenizer (``tokenizer.py``);
- ``native/prefetch.cpp``: the background-thread shuffled batch ring
  (``loader.py``).

They are compiled at first use with ``g++ -O3 -fPIC -std=c++17 -shared
-pthread`` into the git-ignored ``oktopk_tpu_torch/_build/``, as the CUDA
kernels are (``ops/_build.py``): the library's name carries a hash of
the sources and flags, each build writes a per-pid temporary file and
renames it into place, so concurrent processes never load a half-written
library and an edited source is rebuilt. The JAX package's own library,
``oktopk_tpu/native/liboktopk_native.so``, is never written.

``resolve(component)`` is the JAX package's ``OKTOPK_NATIVE`` policy:
``1``/``require``/``on`` needs the library and raises when the build
fails; ``0``/``off``/``no`` takes the Python path; unset or ``auto``
takes the library in a single process only, since the native shuffle and
the Python one give different batches and every process of a run must
take the same path. Where the JAX package probes ``jax.distributed``,
the port asks ``launch.discover()``, which reads the launcher's
environment before any rendezvous. ``resolve`` is the one place that
decides: the native classes (``NativeTokenizer``, ``PrefetchLoader``)
raise when the library is missing, with no Python fallback of their own.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from oktopk_tpu_torch.ops._build import BUILD_DIR

SRC_DIR = Path(__file__).resolve().parent.parent.parent / "native"
SOURCES = ("prefetch.cpp", "wordpiece.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared",
             "-pthread"]

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def lib_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"liboktopk_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / s) for s in SOURCES)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ exit {r.returncode}: {r.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _declare(lib: ctypes.CDLL) -> None:
    i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
    lib.okn_wp_new_from_buffer.restype = ctypes.c_void_p
    lib.okn_wp_new_from_buffer.argtypes = [ctypes.c_char_p, i64, ctypes.c_int]
    lib.okn_wp_free.argtypes = [ctypes.c_void_p]
    lib.okn_wp_vocab_size.restype = i64
    lib.okn_wp_vocab_size.argtypes = [ctypes.c_void_p]
    lib.okn_wp_encode.restype = i64
    lib.okn_wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i32p, i64]
    lib.okn_wp_encode_pair.restype = i64
    lib.okn_wp_encode_pair.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, i64,
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.okn_loader_new.restype = ctypes.c_void_p
    lib.okn_loader_new.argtypes = [u8p, i64, i64, i64, ctypes.c_uint64,
                                   i64, i64, i64, ctypes.c_int]
    lib.okn_loader_next.restype = i64
    lib.okn_loader_next.argtypes = [ctypes.c_void_p, u8p]
    lib.okn_loader_stop.argtypes = [ctypes.c_void_p]
    lib.okn_loader_free.argtypes = [ctypes.c_void_p]


def load():
    """The shared library, built at first use; None when it cannot be
    built (no g++)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = lib_path()
            if not path.exists():
                _build(path)
            _lib = ctypes.CDLL(str(path))
            _declare(_lib)
        except Exception as e:  # no toolchain: resolve() decides
            _build_error = str(e)
            _lib = None
        return _lib


def require() -> ctypes.CDLL:
    """The shared library for a native class; raises when it cannot be
    built."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native library is unavailable: "
                           f"{build_error()}")
    return lib


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    load()
    return _build_error


_resolved: dict = {}
_OFF_MODES = ("0", "off", "no", "false")
_REQUIRE_MODES = ("1", "require", "on", "true")


def _multi_process() -> bool:
    """True when the launcher started more than one process."""
    from oktopk_tpu_torch.launch import discover
    return discover().num_processes > 1


def resolve(component: str) -> bool:
    """Whether ``component`` ("loader", "tokenizer") takes the native
    path under ``OKTOPK_NATIVE`` (see the module's docstring)."""
    mode = os.environ.get("OKTOPK_NATIVE", "auto").strip().lower()
    multi = _multi_process()
    key = (component, mode, multi)
    if key in _resolved:
        return _resolved[key]
    log = logging.getLogger("oktopk_tpu_torch.native")
    if mode in _OFF_MODES:
        use = False
        log.info("native %s: disabled (OKTOPK_NATIVE=%s)", component, mode)
    elif mode in _REQUIRE_MODES:
        if load() is None:
            raise RuntimeError(
                f"OKTOPK_NATIVE={mode} but the native library is "
                f"unavailable for {component}: {build_error()}")
        use = True
        log.info("native %s: enabled (required)", component)
    elif multi:
        use = False
        log.info("native %s: off in a multi-process run under the auto "
                 "policy (set OKTOPK_NATIVE=1 to take it everywhere)",
                 component)
    else:
        use = load() is not None
        log.info("native %s: %s (auto%s)", component,
                 "enabled" if use else "unavailable, Python path",
                 "" if use else f"; {build_error()}")
    _resolved[key] = use
    return use
