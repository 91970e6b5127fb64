"""Kernel K1 (``match_rows.cu``): first-minimum re-match of the cached ICP
candidates, its plain PyTorch version, and its launch counter.

Replaces the TPU kernel ``lidar_odometry_demo_tpu/ops/pallas/correspondence.py``
(``_match_kernel`` / ``match_rows``). It runs once per ICP outer round. It
is bound by device-memory bytes (the candidate lanes of every present slice,
~54 MB a round at full width); the kernel reads each present slice once,
one warp per query, and skips absent slices (see the source's note).

On CPU tensors `match_rows` runs the plain version; on CUDA tensors it
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from lidar_odometry_demo_tpu_torch.kernels import _build
from lidar_odometry_demo_tpu_torch.kernels._build import check_tensor


def match_rows_plain(q_world: torch.Tensor, rows_z, n_present: torch.Tensor, *,
                     max_d2: float, max_points: int):
    """(plane_origin (Q, 3), first_idx (Q,) int32, best_d2 (Q,)).

    The JAX package's XLA formulation (``voxel_map._select_best``): per
    z-slice the gated min over the K lanes and its first k, then the
    earliest z-slice and column with a strict <. An invalid query sits at
    exactly max_d2 with index 0 (its point is candidate 0 of column 0).
    """
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


def match_rows(q_world: torch.Tensor, rows_z, n_present: torch.Tensor, *,
               max_d2: float, max_points: int):
    """K1: the plain version on CPU tensors, the CUDA kernel on CUDA ones.

    q_world (Q, 3) float32; rows_z three (9*Q, RW) int32 candidate-row
    arrays; n_present (9, Q) int32. Returns (point (Q, 3) float32,
    index (Q,) int32, d2 (Q,) float32).
    """
    if q_world.device.type == "cpu":
        return match_rows_plain(q_world, rows_z, n_present, max_d2=max_d2,
                                max_points=max_points)
    Q = q_world.shape[0]
    K = max_points
    RW = rows_z[0].shape[-1]
    if RW < 3 * K + 1:
        raise ValueError(f"rows of width {RW} cannot hold K={K} candidates")
    check_tensor(q_world, "q_world", torch.float32, (Q, 3))
    for s, r in enumerate(rows_z):
        check_tensor(r, f"rows_z[{s}]", torch.int32, (9 * Q, RW))
    check_tensor(n_present, "n_present", torch.int32, (9, Q))
    point = torch.empty((Q, 3), dtype=torch.float32, device=q_world.device)
    index = torch.empty((Q,), dtype=torch.int32, device=q_world.device)
    d2 = torch.empty((Q,), dtype=torch.float32, device=q_world.device)
    fn = _build.c_function("match_rows", "match_rows_launch",
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                           + [ctypes.c_float] + [ctypes.c_void_p] * 4)
    _build.launch(fn, q_world.device, q_world.data_ptr(), rows_z[0].data_ptr(),
                  rows_z[1].data_ptr(), rows_z[2].data_ptr(), n_present.data_ptr(),
                  Q, K, RW, float(max_d2), point.data_ptr(), index.data_ptr(),
                  d2.data_ptr())
    match_rows.launches += 1
    return point, index, d2


match_rows.launches = 0
