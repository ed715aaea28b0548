"""Build-on-first-use loader for the CUDA kernels under `csrc/`.

The kernels have a plain C interface and are bound with `ctypes`: one `nvcc`
per `csrc/*.cu` file, all started together, compiles each to an object for
`sm_90a`, and a last `nvcc` links them into one shared library, in a
directory under the checkout's `build/` keyed by a hash of the sources and
flags, so an edited kernel is never served stale. There is no fallback: a
missing `nvcc` or a failed build raises.

`KERNELS` registers every kernel of the port (its source, the TPU kernel it
replaces, its launch count; `listed_pairs`, the tracing counter of
`utils/profiling`, `gaussian_rows_fwd` / `_bwd`, the per-Gaussian rows
of `ops/gaussian_rows`, and the rsort cull's `cull_geometry`, `cull_layout`
and `wide_gather_fwd` / `_bwd` replace none); the wrappers in `ops/fused*.py` and
`tools/microbench.py` launch through it and check their tensors with
`check_tensor`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from nlos_gaussian_renderer_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "nlos_torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (the last pointer is the stream).
SIGNATURES = {
    "cull_reduce": [_P, _I, _I] + [_P] * 4 + [_I] * 7 + [_P],
    "build_work_lists": [_P] * 2 + [_I] * 6 + [_P] * 8 + [_P],
    "rsort_fwd": [_P] * 10 + [_I] * 15 + [_P],
    "rsort_bwd": [_P] * 10 + [_I] * 15 + [_P],
    "analytic_fwd": [_P] * 11 + [_I] * 16 + [_P],
    "analytic_bwd": [_P] * 11 + [_I] * 15 + [_P],
    "field_fwd": [_P] * 10 + [_I] * 9 + [_P],
    "field_bwd": [_P] * 11 + [_I] * 8 + [_P],
    "worklist_add": [_P] * 5 + [_I] * 3 + [_P],
    "listed_pairs": [_P] * 4 + [_I] * 6 + [_P],
    "gaussian_rows_fwd": [_P] * 10 + [_I] * 3 + [_F] + [_P],
    "gaussian_rows_bwd": [_P] * 16 + [_I] * 3 + [_F] + [_P],
    "cull_geometry": [_P] * 14 + [_I] * 11 + [_F] * 3 + [_P],
    "cull_layout": [_P] * 6 + [_I] * 6 + [_P],
    "wide_gather_fwd": [_P] * 5 + [_I] * 4 + [_P],
    "wide_gather_bwd": [_P] * 3 + [_I] * 4 + [_P],
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
                with profiling.span("kernels.build"):
                    _build(path)
                profiling.count("kernels.builds")
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


# --- kernel registry ----------------------------------------------------------

_JAX = "nlos_gaussian_renderer_tpu/ops"
_SRC = "nlos_gaussian_renderer_tpu_torch/csrc"
_ROW_CHAIN = "none: the per-Gaussian row chain XLA fused on the TPU"
_CULL_CHAIN = "none: the rsort cull's chain XLA ran on the TPU"


class Kernel:
    """A CUDA kernel of the port: where its source lives, which TPU kernel
    it replaces, and how many times it was launched.

    A call made while the current stream captures a CUDA graph launches
    nothing: it records the kernel into the graph and counts in `captured`,
    not in `launches`. The graph's replays make no call, so no counter sees
    them; the profiler does."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.captured = 0

    def launch(self, *args):
        fn = getattr(library(), self.name)
        stream = torch.cuda.current_stream()
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        err = fn(*args, ctypes.c_void_p(stream.cuda_stream))
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} ({error_string(err)})")


KERNELS = {
    k.name: k for k in (
        Kernel("cull_reduce", f"{_SRC}/cull_reduce.cu", f"{_JAX}/fused_rsort.py:630"),
        Kernel("build_work_lists", f"{_SRC}/build_work_lists.cu",
               f"{_JAX}/fused_rsort.py:522"),
        Kernel("rsort_fwd", f"{_SRC}/rsort_fwd.cu", f"{_JAX}/fused_rsort.py:1243"),
        Kernel("rsort_bwd", f"{_SRC}/rsort_bwd.cu", f"{_JAX}/fused_rsort.py:1304"),
        Kernel("analytic_fwd", f"{_SRC}/analytic_fwd.cu", f"{_JAX}/fused_analytic.py:258"),
        Kernel("analytic_bwd", f"{_SRC}/analytic_bwd.cu", f"{_JAX}/fused_analytic.py:340"),
        Kernel("field_fwd", f"{_SRC}/field_fwd.cu", f"{_JAX}/fused.py:71"),
        Kernel("field_bwd", f"{_SRC}/field_bwd.cu", f"{_JAX}/fused.py:90"),
        Kernel("worklist_add", f"{_SRC}/worklist_add.cu", "tools/microbench.py:80"),
        Kernel("listed_pairs", f"{_SRC}/listed_pairs.cu",
               "none: the tracing counter cull.listed_pairs"),
        Kernel("gaussian_rows_fwd", f"{_SRC}/gaussian_rows_fwd.cu", _ROW_CHAIN),
        Kernel("gaussian_rows_bwd", f"{_SRC}/gaussian_rows_bwd.cu", _ROW_CHAIN),
        Kernel("cull_geometry", f"{_SRC}/cull_geometry.cu",
               f"{_CULL_CHAIN} (fused_rsort._cull_geometry)"),
        Kernel("cull_layout", f"{_SRC}/cull_layout.cu",
               f"{_CULL_CHAIN} (fused_rsort._layout_from_geometry)"),
        Kernel("wide_gather_fwd", f"{_SRC}/wide_gather.cu",
               f"{_CULL_CHAIN} (fused_rsort.WidePadGather.forward)"),
        Kernel("wide_gather_bwd", f"{_SRC}/wide_gather.cu",
               f"{_CULL_CHAIN} (fused_rsort.WidePadGather.backward)"),
    )
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def captured_counts() -> dict:
    """{kernel: calls recorded into CUDA graphs so far}; the difference
    across one capture is that graph's launches a replay."""
    return {name: k.captured for name, k in KERNELS.items()}


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def check_tensor(t: torch.Tensor, name: str, dtype, shape=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and `shape`)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def on_cpu(*ts) -> bool:
    """True when every tensor is on the CPU: the wrappers then run their
    plain versions. CUDA tensors go to the kernel (any other device is
    refused there)."""
    return all(t.device.type == "cpu" for t in ts)
