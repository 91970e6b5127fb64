"""ctypes bindings for the native IO runtime (port of the JAX ``io/native.py``).

The library is built from the repository's C++ source,
``native/lidar_native.cpp``, at first use: one ``g++ -O3 -std=c++17 -fPIC
-shared`` call into ``_build/`` beside this file (git-ignored), with no
``-march=native``, so the code runs on any x86-64 host. The file is named by
the hash of the source and the flags: an edited source is rebuilt, an
unchanged one reused. The prebuilt ``native/liblidar_native.so`` is never
loaded.

`available()` is False only when no C++ compiler is found; a failed build
or load raises.
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

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "lidar_native.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
BUILD_DIR = Path(__file__).resolve().parent / "_build"
PACKET_BYTES = 1206

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # the last build's wall time (None: reused or not built)


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def available() -> bool:
    """True when a C++ compiler is found (the library can then be built)."""
    return _compiler() is not None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lidar_native-{digest}.so"


def _load() -> ctypes.CDLL:
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        cxx = _compiler()
        if cxx is None:
            raise RuntimeError("no C++ compiler found: the native library cannot be built")
        out = library_path()
        if not out.exists():
            t0 = time.perf_counter()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"native library build failed:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: concurrent builders write the same bytes
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        lib.ln_pcd_num_points.restype = ctypes.c_long
        lib.ln_pcd_num_points.argtypes = [ctypes.c_char_p]
        lib.ln_pcd_read.restype = ctypes.c_long
        lib.ln_pcd_read.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        fp = ctypes.POINTER(ctypes.c_float)
        lib.ln_vlp16_decode.restype = ctypes.c_long
        lib.ln_vlp16_decode.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long, fp, fp, fp, fp, ctypes.c_long]
        _lib = lib
        return lib


def read_pcd_fields(path: str, fields: list[str]) -> dict[str, np.ndarray] | None:
    """Read named fields as float32 columns through the native parser.

    Returns None when no compiler is found (the caller falls back to
    io/pcd.py)."""
    if not available():
        return None
    lib = _load()
    n = lib.ln_pcd_num_points(path.encode())
    if n <= 0:
        raise IOError(f"native PCD parse failed for {path}")
    buf = np.zeros((len(fields), n), np.float32)
    got = lib.ln_pcd_read(path.encode(), ";".join(fields).encode(),
                          buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if got < 0:
        raise IOError(f"native PCD read failed for {path}")
    return {f: buf[i, :got].copy() for i, f in enumerate(fields)}


def decode_vlp16_packets(packets: bytes, capacity: int = 1 << 20):
    """Decode raw VLP16 1206-byte data packets to (xyz (N, 3), intensity,
    ring (int32), time) numpy arrays."""
    lib = _load()
    if len(packets) % PACKET_BYTES != 0:
        raise ValueError(f"packet buffer must be a multiple of {PACKET_BYTES} bytes")
    num = len(packets) // PACKET_BYTES
    raw = np.frombuffer(packets, np.uint8)
    xyz = np.zeros((capacity, 3), np.float32)
    inten = np.zeros(capacity, np.float32)
    ring = np.zeros(capacity, np.float32)
    time_ = np.zeros(capacity, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    n = lib.ln_vlp16_decode(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), num,
                            xyz.ctypes.data_as(fp), inten.ctypes.data_as(fp),
                            ring.ctypes.data_as(fp), time_.ctypes.data_as(fp), capacity)
    return xyz[:n], inten[:n], ring[:n].astype(np.int32), time_[:n]
