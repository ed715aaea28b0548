"""Build-on-first-use loader for the CUDA kernels under `csrc/`.

The kernels have a plain C interface and are bound with `ctypes`: one `nvcc`
per `csrc/*.cu` file, all started together, compiles each to an object for
`sm_90a`, and a last `nvcc` links them into one shared library, in a
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (the last pointer is the stream).
SIGNATURES = {
    "cull_reduce": [_P] * 6 + [_I] * 7 + [_P],
    "build_work_lists": [_P] * 2 + [_I] * 5 + [_P] * 6 + [_P],
    "rsort_fwd": [_P] * 7 + [_I] * 12 + [_P],
    "rsort_bwd": [_P] * 8 + [_I] * 13 + [_P],
    "analytic_fwd": [_P] * 8 + [_I] * 12 + [_P],
    "analytic_bwd": [_P] * 9 + [_I] * 13 + [_P],
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
    return BUILD_ROOT / h.hexdigest()[:16] / "libnlos_kernels.so"


def _build(out: Path) -> None:
    global build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    units = [s for s in _sources() if s.suffix == ".cu"]
    objs = [out.parent / f"{s.stem}.{tag}.o" for s in units]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(units, objs)
    ]
    logs = []
    try:
        for s, p in zip(units, procs):
            logs.append(f"== {s.name}\n{p.communicate(timeout=900)[0]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    build_log = "\n".join(logs)
    failed = [s.name for s, p in zip(units, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{tag}")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True, timeout=300)
    build_log += link.stdout + link.stderr
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{build_log}")
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
