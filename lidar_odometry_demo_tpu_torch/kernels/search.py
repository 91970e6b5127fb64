"""Kernel K3 (``search.cu``): the voxel map's sorted-key lookup in three
modes, their plain PyTorch versions, and one launch counter.

Replaces the TPU kernel ``scripts/pallas_search_exp.py`` (``make_search(...)
.search`` -> ``kernel``), a lower-bound search of int32 queries in a sorted
key table, and the work around it in the voxel map:

- `search_sorted`: the bare search, ``searchsorted(side="left")``;
- `neighborhood_lookup`: the candidate gather of every ICP scan (cached
  path) or round (exact path). It writes a whole `CandidateSet` in one
  launch: each query's world point and voxel, the 3x3 columns, their
  searches and z probes, and the present slices' rows;
- `group_lookup`: map_update's lookup of its sorted incoming keys, the
  clamped slot and whether the key is already in the table.

The neighbourhood and group lookups take a leading lane axis B on every
argument (B sequences, each with its own map): one launch serves all
lanes, and their plain versions run the B = 1 body per lane. The bare
search keeps its one table. Every launch of any mode counts in
`search_sorted.launches`. The kernel is
bound by device-memory bytes (the neighbourhood lookup's row copy) and by the
latency of dependent loads (the searches); see the source's note. On CPU
tensors each mode runs its plain version; on CUDA tensors it launches the
kernel or raises. There is no fallback between the two.

The key packing and map window the lookup follows are defined here, with the
kernel that repeats them; ``ops/voxel_map.py`` imports them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from lidar_odometry_demo_tpu_torch.device import true_div
from lidar_odometry_demo_tpu_torch.kernels import _build
from lidar_odometry_demo_tpu_torch.kernels._build import check_tensors, lane_map, lanes
from lidar_odometry_demo_tpu_torch.ops.se3 import rot_pts

# int32 key packing: x:[20..30] (11 bits), y:[9..19] (11 bits), z:[0..8] (9 bits)
_XB, _YB, _ZB = 11, 11, 9
_XOFF, _YOFF, _ZOFF = 1 << (_XB - 1), 1 << (_YB - 1), 1 << (_ZB - 1)
EMPTY_KEY = 0x7FFFFFFF

# column window of the keyframe map: x/y within +-_GHALF voxels of the
# origin, z within +-_DIR_ZHALF (the JAX module's directory windows)
_GHALF = 512
_DIR_ZHALF = 128
_DIR_ZLO = _ZOFF - _DIR_ZHALF

# (dx, dy) column scan order: the reference's neighbour order
# (voxel_grid.h:175-177), which the tie-break follows
_COLUMN_OFFSETS = np.array(
    [[ix, iy, 0] for ix in (-1, 0, 1) for iy in (-1, 0, 1)], np.int32)


def _pack(rx, ry, rz) -> torch.Tensor:
    return (rx << (_YB + _ZB)) | (ry << _ZB) | rz


class CandidateSet(NamedTuple):
    """Per-query 27-voxel candidate cache for the ICP loop, gathered once
    per scan at the guess pose (the map is frozen during ICP), or once per
    round by the exact search.

    rows_z:    3-tuple of (9*Q, RW) int32 raw candidate rows for the
               z-1 / z / z+1 slot of each query column, column-major (9, Q)
               flat order; slot s of flat column j is real iff
               s < n_present.reshape(-1)[j] (the kernel writes only those)
    base:      (9, Q) table slot of each column's first present voxel
    n_present: (9, Q) how many of the z-1/z/z+1 voxels exist
    """

    rows_z: tuple
    base: torch.Tensor
    n_present: torch.Tensor

    @staticmethod
    def empty(Q: int, row_width: int, device, lead: tuple = ()) -> "CandidateSet":
        """A CandidateSet for Q queries of each of the lanes `lead` (() or
        (B,)), every field with that leading axis."""
        i32 = dict(dtype=torch.int32, device=device)
        return CandidateSet(
            tuple(torch.empty((*lead, 9 * Q, row_width), **i32) for _ in range(3)),
            torch.empty((*lead, 9, Q), **i32), torch.empty((*lead, 9, Q), **i32))


def search_steps(C: int) -> int:
    """Binary-search steps that resolve every query in a table of C keys:
    ceil(log2(C + 1)), 18 for C = 2^17 (the TPU script's 17 is one short)."""
    return int(C).bit_length()


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

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


def query_world(query_local: torch.Tensor, pose_R: torch.Tensor,
                pose_t: torch.Tensor) -> torch.Tensor:
    """The neighbourhood lookup's world points, rot_pts(q, R) + t (the
    kernel repeats this operation order bit for bit). query_local (..., Q,
    3) with pose_R (..., 3, 3) and pose_t (..., 3): one pose, or one per
    lane."""
    return rot_pts(query_local, pose_R) + pose_t[..., None, :]


def _column_keys(origin: torch.Tensor, q_world: torch.Tensor, query_valid: torch.Tensor,
                 voxel_size: float):
    """(col_ok, rxc, ryc, zd, start_key), each (9, Q): every query column's
    window test, its x / y (the map's centre where col_ok is false), the
    query's directory z, and the start key of the column's search."""
    rel = torch.trunc(true_div(q_world, voxel_size)).to(torch.int32) - origin  # (Q, 3)
    off = torch.from_numpy(_COLUMN_OFFSETS).to(q_world.device)
    rx = rel[None, :, 0] + off[:, 0, None] + _XOFF                 # (9, Q)
    ry = rel[None, :, 1] + off[:, 1, None] + _YOFF
    zd = (rel[:, 2] + _DIR_ZHALF).expand(9, -1)                    # directory z
    col_ok = (query_valid[None, :]
              & (rx >= _XOFF - _GHALF) & (rx < _XOFF + _GHALF)
              & (ry >= _YOFF - _GHALF) & (ry < _YOFF + _GHALF))
    rxc = torch.where(col_ok, rx, _XOFF)
    ryc = torch.where(col_ok, ry, _YOFF)
    z0 = torch.clamp(zd - 1, 0, 2 * _DIR_ZHALF - 1)
    start_key = _pack(rxc, ryc, z0 + _DIR_ZLO).to(torch.int32)
    return col_ok, rxc, ryc, zd, start_key


def neighborhood_start_keys(origin, query_local, query_valid, pose_t, pose_R, *,
                            voxel_size: float) -> torch.Tensor:
    """(9*Q,) int32: the start keys the neighbourhood lookup searches for,
    in (9, Q) flat order (the bare search's input on the main path)."""
    q_world = query_world(query_local, pose_R, pose_t)
    return _column_keys(origin, q_world, query_valid, voxel_size)[4].reshape(-1)


def neighborhood_slots_plain(keys: torch.Tensor, origin: torch.Tensor,
                             q_world: torch.Tensor, query_valid: torch.Tensor, *,
                             voxel_size: float):
    """(base (9, Q), n_present (9, Q)) int32 for each query's 3x3 columns in
    _COLUMN_OFFSETS order.

    Within a column the sorted table is ascending in z, so the present
    voxels among z-1 / z / z+1 occupy the consecutive slots base ..
    base + n_present - 1, with base the first slot at z >= z_query - 1 (z
    clipped to the map's z window). Columns outside the map window, or of
    invalid queries, get base C-1 and n_present 0. Where a column holds no
    voxel of the window, base is the insertion slot (the JAX directory
    gives C-1 there); such rows are masked by n_present = 0. A sorted-key
    search takes the place of the JAX module's dense column directory and
    z-occupancy descriptors. With a lane axis, the B = 1 version per lane.
    """
    if keys.dim() == 2:
        return lane_map(neighborhood_slots_plain, keys.shape[0], keys, origin, q_world,
                        query_valid, voxel_size=voxel_size)
    C = keys.shape[0]
    col_ok, rxc, ryc, zd, start_key = _column_keys(origin, q_world, query_valid, voxel_size)
    pos = search_sorted_plain(keys, start_key.reshape(-1))
    base = torch.clamp_max(pos.reshape(9, -1), C - 1)
    base = torch.where(col_ok, base, C - 1)

    keys_pad = torch.cat([keys, keys.new_full((3,), EMPTY_KEY)])
    slot = base
    n_present = torch.zeros_like(base)
    for dz in (-1, 0, 1):
        z = zd + dz
        key = _pack(rxc, ryc, torch.clamp(z, 0, 2 * _DIR_ZHALF - 1) + _DIR_ZLO)
        here = (col_ok & (z >= 0) & (z < 2 * _DIR_ZHALF)
                & (keys_pad[slot.long()] == key))
        n_present = n_present + here.to(torch.int32)
        slot = slot + here.to(torch.int32)
    return base, n_present


def neighborhood_lookup_plain(tab, keys, origin, query_local, query_valid, pose_t, pose_R,
                              *, voxel_size: float, row_width: int) -> CandidateSet:
    """The neighbourhood lookup as tensor ops: the world points, the slots,
    and three row gathers of the search lanes [0, row_width) at slots base,
    base+1, base+2 (clamped to the table), every slice gathered as the JAX
    package does (rows at or past n_present are masked by the contract).
    With a lane axis, the B = 1 version per lane."""
    if keys.dim() == 2:
        return lane_map(neighborhood_lookup_plain, keys.shape[0], tab, keys, origin,
                        query_local, query_valid, pose_t, pose_R, voxel_size=voxel_size,
                        row_width=row_width)
    q_world = query_world(query_local, pose_R, pose_t)
    base, n_present = neighborhood_slots_plain(keys, origin, q_world, query_valid,
                                               voxel_size=voxel_size)
    bflat = base.reshape(-1).long()
    lanes = tab[:, :row_width]
    C = keys.shape[0]
    rows_z = tuple(lanes[torch.clamp_max(bflat + s, C - 1)] for s in range(3))
    return CandidateSet(rows_z=rows_z, base=base, n_present=n_present)


def group_lookup_plain(keys: torch.Tensor, queries: torch.Tensor):
    """(pos_c (N,) int32, found (N,) bool): map_update's lookup of its
    sorted keys in the table, pos_c = min(lower bound, C-1) and found =
    (query != EMPTY_KEY) & (keys[pos_c] == query). With a lane axis, the
    B = 1 version per lane."""
    if keys.dim() == 2:
        return lane_map(group_lookup_plain, keys.shape[0], keys, queries)
    pos_c = torch.clamp_max(search_sorted_plain(keys, queries), keys.shape[0] - 1)
    found = (queries != EMPTY_KEY) & (keys[pos_c.long()] == queries)
    return pos_c, found


# --------------------------------------------------------------------------
# the kernel's three modes
# --------------------------------------------------------------------------

def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def search_sorted(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """K3's bare search: the plain version on CPU tensors, the CUDA kernel
    on CUDA ones.

    keys (C,) int32 sorted ascending (runs of equal keys allowed); queries
    (N,) int32 in any order. Returns (N,) int32, the same as
    torch.searchsorted(keys, queries, side="left", out_int32=True).
    """
    if queries.device.type == "cpu":
        return search_sorted_plain(keys, queries)
    C, N = keys.shape[0], queries.shape[0]
    check_tensors((keys, "keys", torch.int32, (C,)), (queries, "queries", torch.int32, (N,)))
    out = torch.empty((N,), dtype=torch.int32, device=queries.device)
    if N == 0:
        return out
    fn = _build.c_function("search", "search_sorted_launch",
                           [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p])
    _build.launch(fn, queries.device, keys.data_ptr(), C, queries.data_ptr(), N,
                  out.data_ptr())
    search_sorted.launches += 1
    return out


search_sorted.launches = 0


def neighborhood_lookup(tab, keys, origin, query_local, query_valid, pose_t, pose_R, *,
                        voxel_size: float, row_width: int,
                        out: CandidateSet | None = None) -> CandidateSet:
    """K3's neighbourhood lookup: the plain version on CPU tensors, one
    kernel launch on CUDA ones.

    tab (C, W) int32 map rows, keys (C,) int32 sorted, origin (3,) int32;
    query_local (Q, 3) float32, query_valid (Q,) bool; pose_t (3,) and
    pose_R (3, 3) float32; each may carry a leading lane axis B (one map
    and pose per lane). row_width RW, the search lanes copied per slice.
    On CUDA the CandidateSet is written into `out` (allocated if None): base
    and n_present everywhere, rows only where s < n_present.
    """
    if query_local.device.type == "cpu":
        return neighborhood_lookup_plain(tab, keys, origin, query_local, query_valid, pose_t,
                                         pose_R, voxel_size=voxel_size, row_width=row_width)
    lead = tuple(keys.shape[:-1])
    B, C, W = lanes(lead), keys.shape[-1], tab.shape[-1]
    Q, RW = query_local.shape[-2], row_width
    out = CandidateSet.empty(Q, RW, query_local.device, lead) if out is None else out
    check_tensors(
        (tab, "tab", torch.int32, (*lead, C, W)), (keys, "keys", torch.int32, (*lead, C)),
        (origin, "origin", torch.int32, (*lead, 3)),
        (query_local, "query_local", torch.float32, (*lead, Q, 3)),
        (query_valid, "query_valid", torch.bool, (*lead, Q)),
        (pose_t, "pose_t", torch.float32, (*lead, 3)),
        (pose_R, "pose_R", torch.float32, (*lead, 3, 3)),
        *((r, f"out.rows_z[{s}]", torch.int32, (*lead, 9 * Q, RW))
          for s, r in enumerate(out.rows_z)),
        (out.base, "out.base", torch.int32, (*lead, 9, Q)),
        (out.n_present, "out.n_present", torch.int32, (*lead, 9, Q)))
    if C == 0:
        raise ValueError("the neighbourhood lookup needs a table of at least one row")
    if RW % 4 or RW > W or W % 4:
        raise ValueError(f"row_width {RW} and table width {W} must be multiples of 4, "
                         f"row_width <= width")
    for s, r in enumerate(out.rows_z):
        _check_aligned(r, f"out.rows_z[{s}]")
    _check_aligned(tab, "tab")
    if Q == 0 or B == 0:
        return out
    fn = _build.c_function("search", "neighborhood_launch",
                           [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_float]
                           + [ctypes.c_void_p] * 6)
    _build.launch(fn, query_local.device, tab.data_ptr(), C, W, RW, keys.data_ptr(),
                  origin.data_ptr(), query_local.data_ptr(), query_valid.data_ptr(), B, Q,
                  pose_R.data_ptr(), pose_t.data_ptr(), float(voxel_size),
                  out.base.data_ptr(), out.n_present.data_ptr(),
                  *(r.data_ptr() for r in out.rows_z))
    search_sorted.launches += 1
    return out


def group_lookup(keys: torch.Tensor, queries: torch.Tensor):
    """K3's group lookup: the plain version on CPU tensors, one kernel
    launch on CUDA ones. keys (C,) int32 sorted, C >= 1; queries (N,) int32
    (map_update's are sorted); both may carry a leading lane axis B (each
    lane's keys and queries sorted on their own). Returns (pos_c (N,)
    int32, found (N,) bool), with the same leading axis."""
    if queries.device.type == "cpu":
        return group_lookup_plain(keys, queries)
    lead = tuple(keys.shape[:-1])
    B, C, N = lanes(lead), keys.shape[-1], queries.shape[-1]
    check_tensors((keys, "keys", torch.int32, (*lead, C)),
                  (queries, "queries", torch.int32, (*lead, N)))
    if C == 0:
        raise ValueError("the group lookup needs a table of at least one key")
    pos_c = torch.empty((*lead, N), dtype=torch.int32, device=queries.device)
    found = torch.empty((*lead, N), dtype=torch.bool, device=queries.device)
    if N == 0 or B == 0:
        return pos_c, found
    fn = _build.c_function("search", "group_lookup_launch",
                           [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    _build.launch(fn, queries.device, keys.data_ptr(), C, queries.data_ptr(), B, N,
                  pos_c.data_ptr(), found.data_ptr())
    search_sorted.launches += 1
    return pos_c, found
