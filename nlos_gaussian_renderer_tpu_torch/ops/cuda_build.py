"""Build-on-first-use loader for the CUDA kernels under `csrc/`.

The kernels have a plain C interface and are bound with `ctypes`: `nvcc`
compiles every `csrc/*.cu` file into one shared library for `sm_90a`, in a
directory under the checkout's `build/` keyed by a hash of the sources and
flags, so an edited kernel is never served stale. There is no fallback: a
missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "nlos_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (the last pointer is the stream).
SIGNATURES = {
    "cull_reduce": [_P] * 6 + [_I] * 7 + [_P],
    "build_work_lists": [_P] * 2 + [_I] * 5 + [_P] * 6 + [_P],
    "rsort_fwd": [_P] * 7 + [_I] * 12 + [_P],
    "rsort_bwd": [_P] * 8 + [_I] * 13 + [_P],
}

_lock = threading.Lock()
_lib = None
build_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libnlos_rsort.so"


def _build(out: Path) -> None:
    global build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(s) for s in _sources() if s.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    lib = library()
    lib.nlos_cuda_error_string.restype = ctypes.c_char_p
    lib.nlos_cuda_error_string.argtypes = [ctypes.c_int]
    return lib.nlos_cuda_error_string(code).decode()
