"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``*.cu`` source in this directory has a plain C interface (no PyTorch
headers), so one `nvcc` call per source takes seconds. All sources are
compiled in parallel, for ``sm_90a`` (Hopper), into ``_build/`` beside them
(git-ignored). A library is named by the hash of its source and flags, so
an edited source is rebuilt and an unchanged one is reused.
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

import torch

SOURCES = {"match_rows": "match_rows.cu", "jtwj": "jtwj.cu", "search": "search.cu",
           "loop": "loop.cu", "prepare": "prepare.cu", "map_update": "map_update.cu"}
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (_HERE / SOURCES[name]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing library (one nvcc per source, all at once) and
    load them all. Returns {name: CDLL}."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in SOURCES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_HERE / SOURCES[name])]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        build_seconds = time.perf_counter() - t0
        return _libs


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


def build_log(name: str) -> str:
    """The compiler's output (register and shared-memory use) for `name`."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def lanes(shape_lead) -> int:
    """The lane count B of a kernel call: its arguments' leading dims, ()
    for one sequence (B = 1) or (B,) for B sequences."""
    lead = tuple(shape_lead)
    if len(lead) > 1:
        raise ValueError(f"at most one lane axis, got leading dims {lead}")
    return lead[0] if lead else 1


def _at_lane(x, b: int):
    if isinstance(x, torch.Tensor):
        return x[b]
    if isinstance(x, tuple):
        items = [_at_lane(v, b) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _stack_lanes(xs):
    x0 = xs[0]
    if x0 is None:
        return None
    if isinstance(x0, torch.Tensor):
        return torch.stack(xs)
    items = [_stack_lanes([x[i] for x in xs]) for i in range(len(x0))]
    return type(x0)(*items) if hasattr(x0, "_fields") else tuple(items)


def lane_map(fn, batch: int, *args, **kwargs):
    """fn over the lanes of its tensor arguments, stacked: a kernel's plain
    version at B lanes as B calls of its B = 1 version. Every tensor in
    `args` (also inside tuples and named tuples) carries the leading lane
    axis; `kwargs` pass unchanged."""
    return _stack_lanes([fn(*(_at_lane(a, b) for a in args), **kwargs)
                         for b in range(batch)])


def check_tensors(*specs) -> None:
    """Raise unless every spec (tensor, name, dtype, shape[, strided_lanes])
    holds a contiguous CUDA tensor of that dtype and shape. Every shape
    (with its lane count) is checked first, then every dtype, device and
    layout. strided_lanes: that many leading (lane) dims may sit at any
    stride (a view into a larger buffer, read at its lane stride); each
    lane's own elements must still be contiguous."""
    for t, name, _, shape, *_ in specs:
        if t.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    for t, name, dtype, *_ in specs:
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    for t, name, *_ in specs:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    for t, name, _, _, *strided in specs:
        if not (strided and strided[0]):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            continue
        step = 1  # each lane's own elements, innermost first
        for size, stride in reversed(list(zip(t.shape[strided[0]:], t.stride()[strided[0]:]))):
            if size != 1 and stride != step:
                raise ValueError(f"{name} must be contiguous")
            step *= size


def c_function(lib: str, name: str, argtypes: list):
    """The C launcher `name` of library `lib`, its signature declared once
    (pointers and the stream as c_void_p, so ctypes does not cut them)."""
    fn = getattr(library(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch(fn, device, *args) -> None:
    """Call launcher `fn` on `device`'s current stream (appended as the last
    argument) and raise on a non-zero cudaError_t."""
    if len(args) + 1 != len(fn.argtypes):  # ctypes would pass extras as C ints
        raise TypeError(f"{fn.__name__}: {len(args) + 1} arguments for "
                        f"{len(fn.argtypes)} declared types")
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {status} at launch")
