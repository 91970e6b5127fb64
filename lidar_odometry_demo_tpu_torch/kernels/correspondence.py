"""Kernel K1 (``match_rows.cu``): first-minimum re-match of the cached ICP
candidates with the correspondence written in full, its plain PyTorch
version, and its launch counter.

Replaces the TPU kernel ``lidar_odometry_demo_tpu/ops/pallas/correspondence.py``
(``_match_kernel`` / ``match_rows``) and the work around it in
``voxel_map.match_candidates`` (the query's world position, the winner's
normal, the masks). It runs once per ICP outer round. It is bound by
device-memory bytes (the candidates of every present slice, ~14 MB a round
at full width) and the latency of dependent loads; one warp per query
issues each wave of loads for all 27 slices at once (see the source's
note).

Two entry points on the one kernel: `match_correspondences` (pose mode, the
main path) and `match_rows` (winner point, index and d2 of given world
points). Both count their launches in `match_rows.launches`. On CPU tensors
each runs its plain version; on CUDA tensors it launches the kernel or
raises. There is no fallback between the two.

Lanes: every argument may carry a leading lane axis B (independent
sequences, each with its own map and pose); one launch serves all lanes,
and the plain version runs its B = 1 body per lane.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lidar_odometry_demo_tpu_torch.kernels import _build
from lidar_odometry_demo_tpu_torch.kernels._build import check_tensors, lane_map, lanes
from lidar_odometry_demo_tpu_torch.ops.se3 import rot_pts


class Match(NamedTuple):
    """K1's outputs for Q queries."""

    plane_origin: torch.Tensor  # (Q, 3) winning point, 0 where not valid
    plane_normal: torch.Tensor  # (Q, 3) its stored normal, 0 where not valid
    valid: torch.Tensor         # (Q,) query_valid & (d2 < max_d2)
    index: torch.Tensor         # (Q,) int32 flat index c*3K + z*K + k
    d2: torch.Tensor            # (Q,) winning d2; max_d2 without a candidate

    @staticmethod
    def empty(Q: int, device, lead: tuple = ()) -> "Match":
        """Outputs for Q queries of each of the lanes `lead` (() or (B,))."""
        f32 = dict(dtype=torch.float32, device=device)
        return Match(torch.empty((*lead, Q, 3), **f32), torch.empty((*lead, Q, 3), **f32),
                     torch.empty((*lead, Q), dtype=torch.bool, device=device),
                     torch.empty((*lead, Q), dtype=torch.int32, device=device),
                     torch.empty((*lead, Q), **f32))


def match_rows_plain(q_world: torch.Tensor, rows_z, n_present: torch.Tensor, *,
                     max_d2: float, max_points: int):
    """(plane_origin (Q, 3), first_idx (Q,) int32, best_d2 (Q,)).

    The JAX package's XLA formulation (``voxel_map._select_best``): per
    z-slice the gated min over the K lanes and its first k, then the
    earliest z-slice and column with a strict <. An invalid query sits at
    exactly max_d2 with index 0 (its point is candidate 0 of column 0).
    With a lane axis, the B = 1 version per lane.
    """
    if q_world.dim() == 3:
        return lane_map(match_rows_plain, q_world.shape[0], q_world, rows_z, n_present,
                        max_d2=max_d2, max_points=max_points)
    K = max_points
    Q = q_world.shape[0]
    dev = q_world.device
    QR = 9 * Q
    rs = [r.view(torch.float32) for r in rows_z]
    qx, qy, qz = (q_world[:, i].expand(9, Q).reshape(QR, 1) for i in range(3))
    npres = n_present.reshape(QR)
    kf = torch.arange(K, dtype=torch.float32, device=dev)[None, :]
    ki = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    md = torch.tensor(max_d2, dtype=torch.float32, device=dev)
    best_d_row = md.expand(QR).clone()
    best_zk_row = torch.zeros((QR,), dtype=torch.int32, device=dev)
    for s in range(3):
        r2 = rs[s]
        cnt = r2[:, 3 * K]
        ok = (npres > s)[:, None] & (kf < cnt[:, None])
        dx = r2[:, :K] - qx
        dy = r2[:, K:2 * K] - qy
        dz = r2[:, 2 * K:3 * K] - qz
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(ok & (d2 < md), d2, md)
        mn = torch.amin(d2, dim=1)
        kw = torch.amin(torch.where(d2 <= mn[:, None], ki, K - 1), dim=1)
        better = mn < best_d_row  # strict: the earlier z wins ties
        best_zk_row = torch.where(better, s * K + kw, best_zk_row)
        best_d_row = torch.minimum(best_d_row, mn)
    bd = best_d_row.reshape(9, Q)
    c_idx = torch.argmin(bd, dim=0)  # first minimum in column order
    best_d2 = torch.gather(bd, 0, c_idx[None, :])[0]
    zk = torch.gather(best_zk_row.reshape(9, Q), 0, c_idx[None, :])[0]
    # winner point from the winning (column, z, k) lanes
    row = c_idx * Q + torch.arange(Q, device=dev)
    z = zk // K
    k = (zk % K).long()
    point = torch.zeros((Q, 3), dtype=torch.float32, device=dev)
    for s in range(3):
        r = rs[s][row]
        p = torch.stack([r.gather(1, (k + i * K)[:, None])[:, 0] for i in range(3)], -1)
        point = torch.where((z == s)[:, None], p, point)
    idx = (c_idx.to(torch.int32) * (3 * K) + zk).to(torch.int32)
    return point, idx, best_d2


def match_correspondences_plain(query_local, query_valid, pose_t, pose_R, cand,
                                nrm_view, *, max_d2: float, max_points: int) -> Match:
    """K1 in pose mode as tensor ops: the port's ``match_candidates`` body
    (q_world, match_rows_plain, the winner's normal from the map's (C, K, 3)
    normal view `nrm_view` at slot clamp(base[c] + z, C-1), the valid mask
    and the zeroed outputs). With a lane axis, the B = 1 version per lane."""
    if query_local.dim() == 3:
        return lane_map(match_correspondences_plain, query_local.shape[0], query_local,
                        query_valid, pose_t, pose_R, cand, nrm_view, max_d2=max_d2,
                        max_points=max_points)
    K = max_points
    C = nrm_view.shape[0]
    q_world = rot_pts(query_local, pose_R) + pose_t
    plane_origin, loc, best_d2 = match_rows_plain(q_world, cand.rows_z, cand.n_present,
                                                  max_d2=max_d2, max_points=K)
    c_idx = loc // (3 * K)
    zk_idx = loc % (3 * K)
    k_idx = zk_idx % K
    valid = query_valid & (best_d2 < torch.tensor(max_d2, dtype=torch.float32,
                                                  device=best_d2.device))
    base_win = torch.gather(cand.base, 0, c_idx.long()[None, :])[0]
    best_slot = torch.clamp_max(base_win + zk_idx // K, C - 1)
    plane_normal = nrm_view[best_slot.long(), k_idx.long()]
    v = valid[:, None]
    return Match(torch.where(v, plane_origin, 0.0), torch.where(v, plane_normal, 0.0),
                 valid, loc, best_d2)


def _row_specs(rows_z, n_present, lead: tuple, Q: int, K: int):
    """(RW, the candidate rows' and n_present's check specs)."""
    RW = rows_z[0].shape[-1]
    if RW < 3 * K + 1:
        raise ValueError(f"rows of width {RW} cannot hold K={K} candidates")
    specs = [(r, f"rows_z[{s}]", torch.int32, (*lead, 9 * Q, RW)) for s, r in enumerate(rows_z)]
    return RW, specs + [(n_present, "n_present", torch.int32, (*lead, 9, Q))]


def _launch(dev, query, query_valid, R, t, rows_z, n_present, base, tab, B, Q, K, RW,
            max_d2, out: Match, with_normal: bool) -> None:
    if Q == 0 or B == 0:  # nothing to launch
        return
    fn = _build.c_function("match_rows", "match_launch",
                           [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
                           + [ctypes.c_void_p] * 6)
    C, W = (tab.shape[-2], tab.shape[-1]) if tab is not None else (0, 0)

    def ptr(x):
        return None if x is None else x.data_ptr()

    _build.launch(fn, dev, query.data_ptr(), ptr(query_valid), ptr(R), ptr(t),
                  rows_z[0].data_ptr(), rows_z[1].data_ptr(), rows_z[2].data_ptr(),
                  n_present.data_ptr(), ptr(base), ptr(tab), B, Q, K, RW, C, W,
                  float(max_d2), out.plane_origin.data_ptr(),
                  out.plane_normal.data_ptr() if with_normal else None,
                  out.valid.data_ptr() if with_normal else None,
                  out.index.data_ptr(), out.d2.data_ptr())
    match_rows.launches += 1


def match_correspondences(query_local, query_valid, pose_t, pose_R, cand, tab, nrm_view,
                          *, max_d2: float, max_points: int,
                          out: Match | None = None) -> Match:
    """K1 in pose mode: the plain version on CPU tensors, one kernel launch
    on CUDA ones.

    query_local (Q, 3) float32 and query_valid (Q,) bool; pose_t (3,) and
    pose_R (3, 3) float32; cand a CandidateSet (rows_z three (9*Q, RW) int32
    candidate-row arrays, n_present and base (9, Q) int32); tab (C, W)
    int32, the map's rows, and nrm_view its (C, K, 3) float32 normal view
    (the plain version reads the view, the kernel the table). Each may carry
    a leading lane axis B, all the same. On CUDA the outputs are written
    into `out`, allocated if None.
    """
    if query_local.device.type == "cpu":
        return match_correspondences_plain(query_local, query_valid, pose_t, pose_R, cand,
                                           nrm_view, max_d2=max_d2, max_points=max_points)
    lead = tuple(query_local.shape[:-2])
    B, Q, K = lanes(lead), query_local.shape[-2], max_points
    rows_z, n_present, base = cand.rows_z, cand.n_present, cand.base
    RW, specs = _row_specs(rows_z, n_present, lead, Q, K)
    out = Match.empty(Q, query_local.device, lead) if out is None else out
    check_tensors(
        *specs, (query_local, "query_local", torch.float32, (*lead, Q, 3)),
        (query_valid, "query_valid", torch.bool, (*lead, Q)),
        (pose_t, "pose_t", torch.float32, (*lead, 3)),
        (pose_R, "pose_R", torch.float32, (*lead, 3, 3)),
        (base, "base", torch.int32, (*lead, 9, Q)),
        (tab, "tab", torch.int32, (*lead, *tab.shape[-2:])),
        *((x, f"out.{f}", x.dtype, (*lead, Q, *x.shape[len(lead) + 1:]))
          for f, x in zip(Match._fields, out)))
    if tab.shape[-1] < RW + 3 * K:
        raise ValueError(f"table rows of width {tab.shape[-1]} hold no normal lanes")
    _launch(query_local.device, query_local, query_valid, pose_R, pose_t, rows_z,
            n_present, base, tab, B, Q, K, RW, max_d2, out, with_normal=True)
    return out


def match_rows(q_world: torch.Tensor, rows_z, n_present: torch.Tensor, *,
               max_d2: float, max_points: int):
    """K1 in point mode: the plain version on CPU tensors, the CUDA kernel
    on CUDA ones.

    q_world (Q, 3) float32; rows_z three (9*Q, RW) int32 candidate-row
    arrays; n_present (9, Q) int32; each may carry a leading lane axis B.
    Returns (point (Q, 3) float32, index (Q,) int32, d2 (Q,) float32). The
    kernel gives 0 as the point of a query without a valid candidate (the
    plain version candidate 0 of column 0): compare points where d2 < max_d2.
    """
    if q_world.device.type == "cpu":
        return match_rows_plain(q_world, rows_z, n_present, max_d2=max_d2,
                                max_points=max_points)
    lead = tuple(q_world.shape[:-2])
    B, Q, K = lanes(lead), q_world.shape[-2], max_points
    RW, specs = _row_specs(rows_z, n_present, lead, Q, K)
    check_tensors(*specs, (q_world, "q_world", torch.float32, (*lead, Q, 3)))
    out = Match.empty(Q, q_world.device, lead)._replace(plane_normal=None, valid=None)
    _launch(q_world.device, q_world, None, None, None, rows_z, n_present, None, None, B, Q,
            K, RW, max_d2, out, with_normal=False)
    return out.plane_origin, out.index, out.d2


match_rows.launches = 0
