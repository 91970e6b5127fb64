"""Fixed-capacity point-cloud containers (port of the JAX ``ops/cloud.py``).

Clouds are padded struct-of-arrays tensors with a validity mask: filtering
clears mask bits and never erases, so every stage sees a fixed shape. A
batch of B sequences puts a leading lane axis on every field; `count` then
counts per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_odometry_demo_tpu_torch.device import to_torch


class LidarScan(NamedTuple):
    """Padded VLP16 scan: XYZ + intensity + ring + per-point time + mask
    (lidar_point::PointXYZIRT, reference src/lidar_point_type.h:13-20)."""

    xyz: torch.Tensor        # (N, 3) float32
    intensity: torch.Tensor  # (N,) float32
    ring: torch.Tensor       # (N,) int32
    time: torch.Tensor       # (N,) float32
    valid: torch.Tensor      # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32), dim=-1, dtype=torch.int32)


class PointsWithNormals(NamedTuple):
    """Points + unit plane normals + mask (pcl::PointNormal clouds)."""

    xyz: torch.Tensor     # (N, 3) float32
    normal: torch.Tensor  # (N, 3) float32
    valid: torch.Tensor   # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32), dim=-1, dtype=torch.int32)


def lane_offsets(idx: torch.Tensor, stride: int) -> torch.Tensor:
    """Integer indices idx (B, ...) into each lane's block of `stride` rows
    -> indices into the rows of all B lanes flattened (lane b's block starts
    at b * stride); a 1-D idx (no lane axis) is returned as it is."""
    if idx.dim() == 1:
        return idx
    B = idx.shape[0]
    lane = torch.arange(B, dtype=idx.dtype, device=idx.device) * stride
    return idx + lane.reshape(B, *([1] * (idx.dim() - 1)))


def rows_at(x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Rows of x (..., N, *F) at integer indices idx (..., M): (..., M, *F),
    the leading lane axis (if any) shared by both, in one row gather;
    written into `out` (contiguous, that shape) where it is given."""
    if idx.dim() == 1:
        return x[idx] if out is None else torch.index_select(x, 0, idx, out=out)
    rows = x.reshape(-1, *x.shape[2:])
    flat_idx = lane_offsets(idx, x.shape[1]).reshape(-1)
    if out is not None:
        torch.index_select(rows, 0, flat_idx, out=out.view(-1, *x.shape[2:]))
        return out
    return rows[flat_idx].reshape(*idx.shape, *x.shape[2:])


def scan_from_numpy(
    xyz: np.ndarray,
    intensity: np.ndarray,
    ring: np.ndarray,
    time: np.ndarray,
    capacity: int,
    device: torch.device,
) -> LidarScan:
    """Pad a host-side scan up to `capacity` points on `device`."""
    n = xyz.shape[0]
    if n > capacity:
        raise ValueError(f"scan has {n} points > capacity {capacity}")
    pad = capacity - n
    f32 = np.float32
    return LidarScan(
        xyz=to_torch(np.concatenate([xyz.astype(f32), np.zeros((pad, 3), f32)]), device),
        intensity=to_torch(np.concatenate([intensity.astype(f32), np.zeros(pad, f32)]), device),
        ring=to_torch(np.concatenate([ring.astype(np.int32), np.zeros(pad, np.int32)]), device),
        time=to_torch(np.concatenate([time.astype(f32), np.zeros(pad, f32)]), device),
        valid=to_torch(np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]), device),
    )


def compact_points(pts: PointsWithNormals, budget: int) -> PointsWithNormals:
    """Valid points to the front (stable, input order), truncated or padded
    to `budget`."""
    n = pts.capacity
    order = torch.argsort((~pts.valid).to(torch.int8), stable=True)
    if budget > n:
        order = torch.cat([order, order.new_zeros(budget - n)])
    take = order[:budget]
    in_range = (torch.arange(budget, device=pts.xyz.device)
                < pts.valid.sum())
    keep = in_range[:, None]
    return PointsWithNormals(
        xyz=torch.where(keep, pts.xyz[take], 0.0),
        normal=torch.where(keep, pts.normal[take], 0.0),
        valid=in_range & pts.valid[take],
    )
