"""Build and bind the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into the
git-ignored ``oktopk_tpu_torch/_build/`` directory, and loaded with
``ctypes``. Libraries are named by a hash of their source and flags, so
an edited source is rebuilt and a stale one is never loaded. All sources
compile in parallel (one ``nvcc`` each, started together).

Flags: ``-O3`` without ``--use_fast_math`` and without ``-ftz=true`` —
the kernels must keep IEEE subnormals, as their plain PyTorch versions do.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "combine": "combine.cu",
    "compaction": "compaction.cu",
    "fused_select": "fused_select.cu",
    "threefry": "threefry.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_C = ctypes
_I64 = _C.c_int64
_P = _C.c_void_p
# the C entry points of each library, with their argument types
_SIGNATURES = {
    "combine": {
        "oktopk_scatter_rows": [
            _P, _I64, _C.c_int, _P, _P, _C.c_int, _I64, _I64, _I64, _I64,
            _I64, _I64, _I64, _P],
        "oktopk_residual": [
            _P, _P, _P, _P, _P, _I64, _C.c_int, _C.c_int, _P]},
    "compaction": {"oktopk_compact": [
        _P, _I64, _P, _P, _C.c_int, _C.c_int, _P, _I64, _P, _P, _P, _P]},
    "fused_select": {"oktopk_fused_select": [
        _P, _P, _P, _I64, _P, _P, _P, _P]},
    "threefry": {"oktopk_keep_mask": [
        _C.c_uint32, _C.c_uint32, _C.c_uint64, _I64, _C.c_float, _P, _P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what each build's nvcc printed (ptxas register / shared-memory report)
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler."""
    exe = shutil.which("nvcc")
    if exe is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            exe = cand
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return exe


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build_all(names=None) -> float:
    """Compile every (or the named) kernel source that is not built yet,
    one ``nvcc`` per source, all at once. Returns the seconds taken.
    Raises with nvcc's output if any compile fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for nm in names:
        out = _lib_path(nm)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[nm])]
        procs[nm] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     tmp, out)
    failed = []
    for nm, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        build_logs[nm] = log
        if p.returncode != 0:
            failed.append(f"{nm}: nvcc exit {p.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptr(t) -> int:
    """Device address of a tensor (0 for None)."""
    return 0 if t is None else t.data_ptr()


def stream_handle(device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
