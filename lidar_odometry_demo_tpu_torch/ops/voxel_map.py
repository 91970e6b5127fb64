"""Sorted fused-row voxel table: the keyframe map, downsampler and
neighbourhood search (port of the JAX ``ops/voxel_map.py``).

The table format is the JAX package's format v6, slot for slot, so the two
frameworks' states compare directly (see convert.py):

- voxel coordinates are quantized by truncation toward zero (the
  reference's `(int64)(x / voxel_size)`, voxel_grid.h:68-75), by a true
  division;
- coordinates pack into one non-negative int32 key, 11/11/9 bits for
  x/y/z, relative to a rebasable integer origin; EMPTY_KEY pads the tail;
- everything about a voxel lives in one int32 row of `tab` (see _lanes);
  `keys` and `count` are separate (C,) vectors, sorted by key.

Per-voxel semantics are the reference's: capped point lists keeping the
first arrivals, the first stored point as eviction anchor, and a
27-neighbourhood nearest-point search under a strict distance gate with
first-minimum tie-breaking in (column, z, k) order. When live voxels exceed
the capacity, the table keeps the C smallest keys.

The TPU layout tricks of the JAX module (2-D (n//128, 128) blocking,
packed row gathers, the dense column directory with popcount descriptors)
are not carried over: the neighbourhood lookup is a sorted-key search on
the sorted keys, which the JAX module's own index-free branch shows to
agree with the directory. Kernel K3 (kernels/search.py) runs it, with the
candidate-row gather, in one launch, and map_update's group lookup in
another; the key packing and map window are defined there.

Lanes: every function takes an optional leading lane axis B (B independent
maps, one per sequence: tab (B, C, W), keys and count (B, C), origin
(B, 3), kdim (B, 1, K)) and works per lane; the single-sequence path calls
the same functions without it. Sorts, run structure and searches run along
the last axis; the row gathers and the insert's one scatter move each
lane's indices to its own block of the flattened rows, so the targets stay
unique and the update deterministic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_odometry_demo_tpu_torch.device import true_div
from lidar_odometry_demo_tpu_torch.kernels.correspondence import Match, match_correspondences
from lidar_odometry_demo_tpu_torch.kernels.search import (
    _DIR_ZHALF, _DIR_ZLO, _GHALF, _XB, _XOFF, _YB, _YOFF, _ZB, _ZOFF, EMPTY_KEY,
    CandidateSet, _pack, group_lookup, neighborhood_lookup, neighborhood_slots_plain)
from lidar_odometry_demo_tpu_torch.ops.cloud import PointsWithNormals, lane_offsets, rows_at


def _align8(n: int) -> int:
    return -(-n // 8) * 8


def _lanes(K: int):
    """Lane layout of one table row for max_points = K (format v6).

    [0 : K)          stored point x coords, f32 bits (planar)
    [K : 2K)         y coords
    [2K : 3K)        z coords
    [3K]             the count as f32 bits (the search copy; the
                     authoritative count is VoxelMap.count)
    [RW : RW + 3K)   normals, f32 bits, interleaved (x, y, z) per point;
                     RW = align8(3K + 1)
    [MB : MB + 3)    anchor = first stored point; MB = RW + 3K
    width W = align8(MB + 3)   (128 for K = 20)
    """
    RW = _align8(3 * K + 1)
    MB = RW + 3 * K
    W = _align8(MB + 3)
    return RW, MB, W


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.float32)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical shift right of int32 (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (32 - s)) - 1)


class VoxelMap(NamedTuple):
    """Fixed-capacity voxel table, rows sorted by packed key.

    tab:    (C, W) int32 fused rows (see _lanes)
    keys:   (C,) int32 packed key per row; EMPTY_KEY pads the tail
    count:  (C,) int32 stored-point count per row
    origin: (3,) int32 integer-index origin the keys are relative to
    kdim:   (1, K) int32 marker carrying max_points in its shape

    A batch of maps puts a leading lane axis B on every field.
    """

    tab: torch.Tensor
    keys: torch.Tensor
    count: torch.Tensor
    origin: torch.Tensor
    kdim: torch.Tensor

    @property
    def max_points(self) -> int:
        return self.kdim.shape[-1]

    @property
    def capacity(self) -> int:
        return self.tab.shape[-2]

    @property
    def anchor(self) -> torch.Tensor:
        _, MB, _ = _lanes(self.max_points)
        return _f32(self.tab[..., MB : MB + 3])

    @property
    def pts(self) -> torch.Tensor:
        K = self.max_points
        planar = _f32(self.tab[..., : 3 * K]).reshape(*self.tab.shape[:-1], 3, K)
        return planar.transpose(-1, -2)  # (..., K, 3)

    @property
    def nrm(self) -> torch.Tensor:
        K = self.max_points
        RW, _, _ = _lanes(K)
        return _f32(self.tab[..., RW : RW + 3 * K]).reshape(*self.tab.shape[:-1], K, 3)


class Correspondence(NamedTuple):
    """Match of each query point against the map (voxel_grid.h:40-46)."""

    source_local: torch.Tensor  # (..., Q, 3) query point in its local frame
    plane_origin: torch.Tensor  # (..., Q, 3) matched stored point
    plane_normal: torch.Tensor  # (..., Q, 3) matched stored normal
    valid: torch.Tensor         # (..., Q)


def voxel_indices(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Integer voxel index by truncation toward zero (voxel_grid.h:68-75)."""
    return torch.trunc(true_div(xyz, voxel_size)).to(torch.int32)


def _in_map_window(rx, ry, rz) -> torch.Tensor:
    return ((rz >= _DIR_ZLO) & (rz < _DIR_ZLO + 2 * _DIR_ZHALF)
            & (rx >= _XOFF - _GHALF) & (rx < _XOFF + _GHALF)
            & (ry >= _YOFF - _GHALF) & (ry < _YOFF + _GHALF))


def pack_keys(idx: torch.Tensor, origin: torch.Tensor, valid: torch.Tensor,
              map_window: bool = False) -> torch.Tensor:
    """Relative integer indices -> sortable int32 keys; out-of-window and
    invalid entries -> EMPTY_KEY. map_window=True restricts the domain to
    the keyframe map's column window (every keyframe insert uses it, so the
    table never holds a key the neighbourhood search cannot see). idx
    (..., N, 3); origin (3,), or (B, 3) over a lane axis."""
    rel = idx - origin[..., None, :]
    rx = rel[..., 0] + _XOFF
    ry = rel[..., 1] + _YOFF
    rz = rel[..., 2] + _ZOFF
    in_range = ((rx >= 0) & (rx < (1 << _XB) - 1)
                & (ry >= 0) & (ry < (1 << _YB) - 1)
                & (rz >= 0) & (rz < (1 << _ZB) - 1))
    if map_window:
        in_range = in_range & _in_map_window(rx, ry, rz)
    key = _pack(rx, ry, rz)
    return torch.where(valid & in_range, key, EMPTY_KEY).to(torch.int32)


def _shift_key(delta: torch.Tensor) -> torch.Tensor:
    """Key-space shift of an origin move by integer `delta` (..., 3)
    (uniform, so it preserves the sorted order)."""
    return (delta[..., 0] << (_YB + _ZB)) + (delta[..., 1] << _ZB) + delta[..., 2]


def map_init(capacity: int, max_points: int, device) -> VoxelMap:
    _, _, W = _lanes(max_points)
    i32 = dict(dtype=torch.int32, device=device)
    return VoxelMap(
        tab=torch.zeros((capacity, W), **i32),
        keys=torch.full((capacity,), EMPTY_KEY, **i32),
        count=torch.zeros((capacity,), **i32),
        origin=torch.zeros((3,), **i32),
        kdim=torch.zeros((1, max_points), **i32),
    )


def map_size(m: VoxelMap) -> torch.Tensor:
    """Number of occupied voxels (voxel_grid.h:248-251), per lane."""
    return torch.sum(m.keys != EMPTY_KEY, dim=-1, dtype=torch.int32)


def _group_structure(sorted_keys: torch.Tensor):
    """(leader, rank, start) of each element of a sorted key array (each row
    of one, over a lane axis): first of its equal-key run (EMPTY excluded),
    position in the run, run start."""
    n = sorted_keys.shape[-1]
    pos = torch.arange(n, dtype=torch.int32, device=sorted_keys.device)
    valid = sorted_keys != EMPTY_KEY
    prev = torch.cat([sorted_keys.new_full((*sorted_keys.shape[:-1], 1), EMPTY_KEY),
                      sorted_keys[..., :-1]], dim=-1)
    leader = valid & (sorted_keys != prev)
    if n == 0:
        pos = pos.expand(sorted_keys.shape)
        return leader, pos, pos
    start = torch.cummax(torch.where(leader, pos, -1), dim=-1).values
    return leader, pos - start, start


# ---------------------------------------------------------------------------
# downsampling grid (reference: VoxelGrid(voxel, 1) as a filter,
# lidar_odometry.cpp:37-47)
# ---------------------------------------------------------------------------

def downsample(pts: PointsWithNormals, voxel_size: float, budget: int):
    """One point per voxel, the first in input order (voxel_grid.h:77-93),
    compacted to a fixed `budget` in key order. Scan-local (zero origin).

    Returns (points, dropped): dropped is the number of voxel leaders beyond
    the budget (int32, per lane); the kept leaders are the `budget` smallest
    keys.
    """
    n = pts.capacity
    dev = pts.xyz.device
    lead = pts.valid.shape[:-1]
    take = min(budget, n)
    pad = budget - take
    zero_origin = torch.zeros((3,), dtype=torch.int32, device=dev)
    keys = pack_keys(voxel_indices(pts.xyz, voxel_size), zero_origin, pts.valid)
    sorted_keys, order = torch.sort(keys, dim=-1, stable=True)  # ties keep input order
    leader, _, _ = _group_structure(sorted_keys)
    n_leaders = torch.sum(leader, dim=-1, dtype=torch.int32)
    comp = torch.argsort((~leader).to(torch.int8), dim=-1, stable=True)[..., :take]
    src = torch.gather(order, -1, comp)
    ok = (torch.gather(leader, -1, comp)
          & (torch.arange(take, device=dev) < n_leaders[..., None]))
    xyz = torch.where(ok[..., None], rows_at(pts.xyz, src), 0.0)
    normal = torch.where(ok[..., None], rows_at(pts.normal, src), 0.0)
    if pad:
        xyz = torch.cat([xyz, xyz.new_zeros((*lead, pad, 3))], dim=-2)
        normal = torch.cat([normal, normal.new_zeros((*lead, pad, 3))], dim=-2)
        ok = torch.cat([ok, ok.new_zeros((*lead, pad))], dim=-1)
    return (PointsWithNormals(xyz=xyz, normal=normal, valid=ok),
            torch.clamp_min(n_leaders - take, 0))


# ---------------------------------------------------------------------------
# neighbourhood candidate cache
# ---------------------------------------------------------------------------

def _neighborhood_slots(m: VoxelMap, q_world: torch.Tensor,
                        query_valid: torch.Tensor, *, voxel_size: float):
    """(base (9, Q), n_present (9, Q)) int32 for each query's 3x3 columns in
    _COLUMN_OFFSETS order: the slots of the neighbourhood lookup's plain
    version (kernels.search.neighborhood_slots_plain) on this map."""
    return neighborhood_slots_plain(m.keys, m.origin, q_world, query_valid,
                                    voxel_size=voxel_size)


def gather_candidates(m: VoxelMap, query_local: torch.Tensor,
                      query_valid: torch.Tensor, pose_t: torch.Tensor,
                      pose_R: torch.Tensor, *, voxel_size: float,
                      out: CandidateSet | None = None) -> CandidateSet:
    """Gather every query's 27-voxel candidates at the pose: the search
    lanes ([pts planar | cnt_f]) of each column's present z-1 / z / z+1
    voxels, in one launch of kernel K3's neighbourhood lookup
    (kernels.search.neighborhood_lookup). `out`: the CandidateSet to write,
    reused by a caller that gathers every round."""
    RW, _, _ = _lanes(m.max_points)
    return neighborhood_lookup(m.tab, m.keys, m.origin, query_local, query_valid, pose_t,
                               pose_R, voxel_size=voxel_size, row_width=RW, out=out)


def match_candidates(m: VoxelMap, cand: CandidateSet, query_local: torch.Tensor,
                     query_valid: torch.Tensor, pose_t: torch.Tensor,
                     pose_R: torch.Tensor, *, max_distance: float,
                     nrm_view: torch.Tensor, out: Match | None = None) -> Correspondence:
    """Nearest cached candidate under the distance gate at the current pose.

    First minimum in (column, z, k) order (voxel_grid.h:175-196) with the
    winner's normal from the table at the winning slot, all in one launch of
    kernel K1 (kernels.correspondence.match_correspondences). `nrm_view`:
    m.nrm, derived once per scan (the plain version reads it); `out`: K1's
    outputs, reused by a caller that matches every round.
    """
    max_d2 = float(np.float32(max_distance * max_distance))
    match = match_correspondences(query_local, query_valid, pose_t, pose_R, cand, m.tab,
                                  nrm_view, max_d2=max_d2, max_points=m.max_points,
                                  out=out)
    return Correspondence(source_local=query_local, plane_origin=match.plane_origin,
                          plane_normal=match.plane_normal, valid=match.valid)


def find_correspondences(m: VoxelMap, query_local: torch.Tensor,
                         query_valid: torch.Tensor, pose_t: torch.Tensor,
                         pose_R: torch.Tensor, *, voxel_size: float,
                         max_distance: float,
                         nrm_view: torch.Tensor | None = None,
                         out: Match | None = None,
                         cand_out: CandidateSet | None = None) -> Correspondence:
    """27-neighbourhood nearest-point search at the *current* pose (reference
    findMatchingPairs, voxel_grid.h:206-234): gather_candidates then
    match_candidates at the same pose.

    The counterpart of both find_correspondences_indexed and
    find_correspondences of the JAX module: the port has no SearchIndex (its
    lookup searches the sorted keys directly), so one function covers both.
    `nrm_view`: m.nrm, derived once per scan by a caller that searches the
    same map repeatedly (the exact-search ICP loop); derived here if absent.
    `out` as for match_candidates, `cand_out` as gather_candidates' `out`.
    """
    cand = gather_candidates(m, query_local, query_valid, pose_t, pose_R,
                             voxel_size=voxel_size, out=cand_out)
    return match_candidates(m, cand, query_local, query_valid, pose_t, pose_R,
                            max_distance=max_distance,
                            nrm_view=m.nrm if nrm_view is None else nrm_view, out=out)


# ---------------------------------------------------------------------------
# per-scan maintenance: evict + rebase + insert with one sort and one row
# gather (reference radiusCleanup + addCloud, voxel_grid.h:236-246, 77-93)
# ---------------------------------------------------------------------------

def _put(flat: torch.Tensor, idx: torch.Tensor, vals, mask: torch.Tensor) -> None:
    """flat[idx[mask]] = vals[mask] (idx into flat[:-1], unique where mask
    holds), in shapes that do not depend on the data: every entry is
    written, the masked-out ones to flat's last element, a spare whose
    value is left undefined. No host read, so a CUDA graph can capture it."""
    at = torch.where(mask, idx, flat.numel() - 1).reshape(-1)
    if isinstance(vals, torch.Tensor):
        flat.index_put_((at,), vals.reshape(-1))
    else:
        flat.index_fill_(0, at, vals)


def _update_impl(m: VoxelMap, new: PointsWithNormals, new_origin: torch.Tensor,
                 evict: torch.Tensor | None, voxel_size: float,
                 tab_out: torch.Tensor | None = None) -> VoxelMap:
    """Shared evict + insert body.

    1. Keys shift uniformly to the new origin; evicted voxels are
       tombstoned (count 0, key kept so a same-scan re-insert reuses the
       row) and dropped unless an incoming point touches them.
    2. Incoming points, stably sorted by key (first arrivals kept at the
       cap), are written into the extended row space [tab ++ fresh rows]
       with one scatter of unique targets (points, normals, anchors, the
       f32 count lane): found voxels append at lanes [count, K), fresh
       voxels build a row at C + leader.
    3. One stable sort of the (C + N_in) keys, one C-row gather: the C
       smallest keys win at overflow, gathered into `tab_out` where given
       (it may be m.tab itself: step 2 has copied the old rows out).
    """
    C, K = m.capacity, m.max_points
    RW, MB, W = _lanes(K)
    dev = m.tab.device
    i32 = dict(dtype=torch.int32, device=dev)
    lead = tuple(m.keys.shape[:-1])
    shift = _shift_key(new_origin - m.origin)[..., None]
    occupied = m.keys != EMPTY_KEY
    keys1 = torch.where(occupied, m.keys - shift, EMPTY_KEY).to(torch.int32)
    if evict is None:
        count1 = m.count
        evicted = torch.zeros_like(occupied)
    else:
        evicted = occupied & evict
        count1 = torch.where(evicted, 0, m.count)

    n = new.xyz.shape[-2]
    keys_in = pack_keys(voxel_indices(new.xyz, voxel_size), new_origin,
                        new.valid, map_window=True)
    order_in = torch.argsort(keys_in, dim=-1, stable=True)
    skeys = torch.gather(keys_in, -1, order_in)
    sxyz = rows_at(new.xyz, order_in)
    snrm = rows_at(new.normal, order_in)
    leader, rank, start = _group_structure(skeys)
    valid_e = skeys != EMPTY_KEY

    # locate each group in the old (shifted) table: one launch of kernel
    # K3's group lookup
    pos_c, found = group_lookup(keys1, skeys)

    # rows re-touched by an incoming group (tombstone reuse); targets unique
    touched_flat = torch.zeros(m.keys.numel() + 1, dtype=torch.bool, device=dev)
    _put(touched_flat, lane_offsets(pos_c.long(), C), True, leader & found)
    touched = touched_flat[:-1].view(m.keys.shape)
    live = (occupied & ~evicted) | touched
    keys2 = torch.where(live, keys1, EMPTY_KEY).to(torch.int32)
    count1 = torch.where(touched & evicted, 0, count1)

    tab_flat = m.tab.new_empty(m.keys.numel() // C * (C + n) * W + 1)
    tab_ext = tab_flat[:-1].view(*lead, C + n, W)
    tab_ext[..., :C, :].copy_(m.tab)
    tab_ext[..., C:, :].zero_()

    # per-element write positions, broadcast from each group's leader
    start_l = start.long()
    base_l = torch.where(found, torch.gather(count1, -1, pos_c.long()), 0)
    ext_l = torch.where(found, pos_c, C + start)
    base = torch.gather(base_l, -1, start_l)
    ext_slot = torch.gather(ext_l, -1, start_l)
    write_idx = base + rank
    keep = valid_e & (write_idx < K)

    # per-leader group size from the next run boundary
    ar = torch.arange(n, **i32)
    boundary = torch.ones(skeys.shape, dtype=torch.bool, device=dev)
    if n > 1:
        boundary[..., 1:] = skeys[..., 1:] != skeys[..., :-1]
    nxt = torch.flip(torch.cummin(torch.flip(
        torch.where(boundary, ar, n), [-1]), dim=-1).values, [-1])
    nxt_strict = torch.cat([nxt[..., 1:], torch.full((*lead, 1), n, **i32)], dim=-1)
    group_size = torch.where(leader, nxt_strict - ar, 0)
    new_count = torch.clamp_max(base + group_size, K).to(torch.int32)
    anch = leader & (base == 0)

    # one scatter of unique (row, lane) targets into the flat table, each
    # sequence's extended rows at its own offset
    ext_row = lane_offsets(ext_slot.long(), C + n)
    l3 = torch.arange(3, **i32)
    rows3 = ext_row[..., None].expand(*ext_row.shape, 3)
    keep3 = keep[..., None].expand(rows3.shape)
    cnt_bits = _i32(new_count.to(torch.float32))[..., None]
    groups = (
        # (rows, lanes, int32 values, mask)
        (rows3, write_idx[..., None] + l3 * K, _i32(sxyz), keep3),
        (rows3, (RW + 3 * write_idx)[..., None] + l3, _i32(snrm), keep3),
        (rows3, (MB + l3).expand(rows3.shape), _i32(sxyz), anch[..., None].expand(rows3.shape)),
        (ext_row[..., None], torch.full((*ext_row.shape, 1), 3 * K, **i32), cnt_bits,
         leader[..., None]),
    )
    _put(tab_flat, torch.cat([(g[0] * W + g[1]).reshape(-1) for g in groups]),
         torch.cat([g[2].reshape(-1) for g in groups]),
         torch.cat([g[3].reshape(-1) for g in groups]))

    # post-update key / count vectors over the extended rows
    fresh_keys = torch.where(leader & ~found & keep, skeys, EMPTY_KEY).to(torch.int32)
    keys_ext = torch.cat([keys2, fresh_keys], dim=-1)
    count_flat = count1.new_empty(m.keys.numel() // C * (C + n) + 1)
    count_ext = count_flat[:-1].view(*lead, C + n)
    count_ext[..., :C].copy_(count1)
    count_ext[..., C:].zero_()
    _put(count_flat, ext_row, new_count, leader)

    sorted_keys, order = torch.sort(keys_ext, dim=-1, stable=True)
    oc = order[..., :C]
    return VoxelMap(tab=rows_at(tab_ext, oc, out=tab_out), keys=sorted_keys[..., :C].contiguous(),
                    count=torch.gather(count_ext, -1, oc), origin=new_origin, kdim=m.kdim)


def map_insert(m: VoxelMap, new: PointsWithNormals, *, voxel_size: float) -> VoxelMap:
    """Insert world-frame points with first-come-kept capping."""
    return _update_impl(m, new, m.origin, None, voxel_size)


def _evict_mask(m: VoxelMap, center: torch.Tensor, new_origin: torch.Tensor,
                radius: float) -> torch.Tensor:
    """Anchor farther than `radius` from `center`, or key outside the map
    window once rebased to `new_origin`. Per lane: center (..., 3)."""
    anchor = m.anchor
    c = center[..., None, :]
    dx = anchor[..., 0] - c[..., 0]
    dy = anchor[..., 1] - c[..., 1]
    dz = anchor[..., 2] - c[..., 2]
    d2 = dx * dx + dy * dy + dz * dz
    shifted = m.keys - _shift_key(new_origin - m.origin)[..., None]
    rz = shifted & ((1 << _ZB) - 1)
    rx = _srl(shifted, _YB + _ZB)
    ry = _srl(shifted, _ZB) & ((1 << _YB) - 1)
    return (d2 > radius * radius) | ~_in_map_window(rx, ry, rz)


def radius_cleanup(m: VoxelMap, center: torch.Tensor, *, radius: float,
                   voxel_size: float) -> VoxelMap:
    """Erase voxels whose first stored point is farther than `radius` from
    `center` (voxel_with_planes.h:32-35), re-basing the origin to it."""
    new_origin = voxel_indices(center, voxel_size)
    lead = center.shape[:-1]
    z = center.new_zeros((*lead, 0, 3))
    empty = PointsWithNormals(xyz=z, normal=z,
                              valid=torch.zeros((*lead, 0), dtype=torch.bool, device=z.device))
    evict = _evict_mask(m, center, new_origin, radius)
    return _update_impl(m, empty, new_origin, evict, voxel_size)


def map_update(m: VoxelMap, new: PointsWithNormals, center: torch.Tensor, *,
               voxel_size: float, radius: float, origin_quantum: int = 1,
               tab_out: torch.Tensor | None = None) -> VoxelMap:
    """radius_cleanup then map_insert in one sort pass (the reference's
    per-scan sequence, lidar_odometry.cpp:67-70).

    tab_out: the buffer the new table is gathered into, m.tab itself
    allowed (the captured step's state buffer, pipeline/graphs.py, which
    then needs no copy of the 64 MB table per lane and scan); a new tensor
    where None.

    origin_quantum > 1 floors the rebased origin's x and y to multiples of
    it. The column-sharded map (parallel/spatial.py) passes its shard count
    N: a column's owner, gx mod N, then never changes across rebases, so no
    voxel moves between ranks. The origin stays within N - 1 voxels of the
    sensor, which the +-512-voxel key window absorbs."""
    new_origin = voxel_indices(center, voxel_size)
    if origin_quantum > 1:
        xy = torch.div(new_origin[..., :2], origin_quantum, rounding_mode="floor")
        new_origin = torch.cat([xy * origin_quantum, new_origin[..., 2:]], dim=-1)
    evict = _evict_mask(m, center, new_origin, radius)
    return _update_impl(m, new, new_origin, evict, voxel_size, tab_out)


# ---------------------------------------------------------------------------
# exports (reference getCloud / getSparseCloudWithoutNormals,
# voxel_grid.h:112-162) — host-side numpy helpers
# ---------------------------------------------------------------------------

def get_cloud(m: VoxelMap):
    """All stored (point, normal) pairs as numpy arrays."""
    keys = m.keys.cpu().numpy()
    count = m.count.cpu().numpy()
    pts = m.pts.cpu().numpy()
    nrm = m.nrm.cpu().numpy()
    out_p, out_n = [], []
    for i in np.nonzero(keys != EMPTY_KEY)[0]:
        c = count[i]
        out_p.append(pts[i, :c])
        out_n.append(nrm[i, :c])
    if not out_p:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    return np.concatenate(out_p), np.concatenate(out_n)


def get_sparse_cloud(m: VoxelMap):
    """One point per voxel (the first stored), numpy."""
    sel = m.keys.cpu().numpy() != EMPTY_KEY
    return m.anchor.cpu().numpy()[sel, :]
