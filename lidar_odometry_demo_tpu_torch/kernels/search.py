"""Kernel K3 (``search.cu``): lower-bound search of int32 queries in a sorted
key table, its plain PyTorch version, and its launch counter.

Replaces the TPU kernel ``scripts/pallas_search_exp.py`` (``make_search(...)
.search`` -> ``kernel``). It is the voxel map's sorted-key lookup: the
neighbourhood lookup of every candidate gather (once per scan on the cached
ICP path, once per ICP round on the exact-search path) and the group lookup
of every ``map_update``. It is bound by device-memory bytes (the 512 KB key
table read once, 4 bytes per query and per output); one thread per query
walks the table through the read-only path (see the source's note).

On CPU tensors `search_sorted` runs the plain version; on CUDA tensors it
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from lidar_odometry_demo_tpu_torch.kernels import _build
from lidar_odometry_demo_tpu_torch.kernels._build import check_tensor


def search_steps(C: int) -> int:
    """Binary-search steps that resolve every query in a table of C keys:
    ceil(log2(C + 1)), 18 for C = 2^17 (the TPU script's 17 is one short)."""
    return int(C).bit_length()


def search_sorted_plain(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(N,) int32: the number of keys strictly less than each query.

    The TPU kernel's body in torch ops, vectorised over the queries: the same
    lo / hi / mid update, run search_steps(C) times with a lo < hi guard.
    """
    C = keys.shape[0]
    lo = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    hi = torch.full(queries.shape, C, dtype=torch.int32, device=queries.device)
    for _ in range(search_steps(C)):
        mid = (lo + hi) >> 1
        less = keys[torch.clamp_max(mid, C - 1).long()] < queries
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def search_sorted(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """K3: the plain version on CPU tensors, the CUDA kernel on CUDA ones.

    keys (C,) int32 sorted ascending (runs of equal keys allowed); queries
    (N,) int32 in any order. Returns (N,) int32, the same as
    torch.searchsorted(keys, queries, side="left", out_int32=True).
    """
    if queries.device.type == "cpu":
        return search_sorted_plain(keys, queries)
    C, N = keys.shape[0], queries.shape[0]
    check_tensor(keys, "keys", torch.int32, (C,))
    check_tensor(queries, "queries", torch.int32, (N,))
    out = torch.empty((N,), dtype=torch.int32, device=queries.device)
    if N == 0:
        return out
    fn = _build.c_function("search", "search_sorted_launch",
                           [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    _build.launch(fn, queries.device, keys.data_ptr(), C, queries.data_ptr(), N,
                  out.data_ptr())
    search_sorted.launches += 1
    return out


search_sorted.launches = 0
