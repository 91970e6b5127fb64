"""LOAM-style planar feature extraction on the (rings x width) range image
(port of the JAX ``ops/classifier.py``; reference
src/utils/cloud_classifier.h:17-168).

1. organize the scan into a fixed (R, W) ring x azimuth image,
2. curvature over a +/-k window along the flattened image (windows cross
   ring boundaries, as in the reference),
3. for flat points, a normal from the cross product of vectors to the first
   sufficiently flat points of the previous ring within +/-k columns,
   scanned outside-in.

Every stage works per lane over an optional leading lane axis (a batch of
independent scans).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.device import true_div
from lidar_odometry_demo_tpu_torch.ops.cloud import (
    LidarScan, PointsWithNormals, lane_offsets, rows_at)
from lidar_odometry_demo_tpu_torch.ops.se3 import cross, norm


class OrganizedScan(NamedTuple):
    xyz: torch.Tensor    # (..., R, W, 3) float32; (0,0,0) for empty cells
    valid: torch.Tensor  # (..., R, W) bool — cell has a point


def organize(scan: LidarScan, cfg: OdometryConfig) -> OrganizedScan:
    """Bucket points into the (R, W) image: col = floor((atan2(-y, x) + pi)
    * W / 2pi) (cloud_classifier.h:49-54). When several points land in one
    cell the last in input order wins (the reference overwrites); an amax
    scatter of the point index gives that deterministically. Over a lane
    axis, one scatter into a flat (B (R W + 1),) buffer, each lane at its
    own offset."""
    R, W = cfg.num_rings, cfg.scan_width
    dev = scan.xyz.device
    lead = scan.valid.shape[:-1]
    x, y = scan.xyz[..., 0], scan.xyz[..., 1]
    azimuth = torch.atan2(-y, x) + math.pi
    col = torch.floor(torch.abs(true_div(azimuth * W, 2.0 * math.pi))).to(torch.int32)
    ok = scan.valid & (col < W) & (scan.ring >= 0) & (scan.ring < R)
    cell = scan.ring * W + col
    cell = torch.where(ok, cell, R * W)  # invalid points go to an overflow cell
    n = scan.capacity
    cells = R * W + 1
    winner = torch.full((scan.valid.numel() // n * cells,), -1, dtype=torch.int32, device=dev)
    winner = winner.scatter_reduce(
        0, lane_offsets(cell, cells).reshape(-1).long(),
        torch.arange(n, dtype=torch.int32, device=dev).expand(*lead, n).reshape(-1),
        reduce="amax", include_self=True).reshape(*lead, cells)[..., : R * W]
    has = winner >= 0
    gathered = rows_at(scan.xyz, torch.clamp_min(winner, 0).long())
    xyz = torch.where(has[..., None], gathered, 0.0)
    return OrganizedScan(xyz=xyz.reshape(*lead, R, W, 3), valid=has.reshape(*lead, R, W))


def curvature(org: OrganizedScan, cfg: OdometryConfig) -> torch.Tensor:
    """curv = ||sum_{w=-k..k} p_{i+w} - (2k+1) p_i|| / ||p_i||^2 over the
    flattened image; cells with range^2 < 0.1 (empty cells included) and the
    first/last k cells of the flattened image get the invalid value."""
    k = cfg.curvature_window
    *lead, R, W = org.valid.shape
    flat = org.xyz.reshape(*lead, R * W, 3)
    acc = -flat * (2.0 * k + 1.0)
    for w in range(-k, k + 1):
        acc = acc + torch.roll(flat, -w, dims=-2)
    range_sq = torch.sum(flat * flat, dim=-1)
    curv = norm(acc) / torch.where(range_sq > 0, range_sq, torch.ones_like(range_sq))
    curv = torch.where(range_sq < cfg.min_valid_range_sq, cfg.curvature_invalid_value, curv)
    idx = torch.arange(R * W, device=flat.device)
    curv = torch.where((idx < k) | (idx >= R * W - k), cfg.curvature_invalid_value, curv)
    return curv.reshape(*lead, R, W)


def _first_flat_neighbor(prev_xyz: torch.Tensor, prev_flat: torch.Tensor,
                         offsets: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Per column, the previous-ring point at the first column offset (in
    the given order) whose cell is flat enough: (point (..., R, W, 3),
    found)."""
    found = torch.zeros_like(prev_flat)
    pt = torch.zeros_like(prev_xyz)
    for off in offsets:
        cand_flat = torch.roll(prev_flat, -off, dims=-1)
        cand_xyz = torch.roll(prev_xyz, -off, dims=-2)
        take = cand_flat & ~found
        pt = torch.where(take[..., None], cand_xyz, pt)
        found = found | cand_flat
    return pt, found


def classify(scan: LidarScan, cfg: OdometryConfig) -> tuple[PointsWithNormals, OrganizedScan, torch.Tensor]:
    """(planar cloud with normals over the R*W grid, organized scan,
    curvature image). Emission: ring >= 1, col in [k, W-k), curv < 0.05,
    and a flat left and right neighbour in the previous ring
    (cloud_classifier.h:114-164)."""
    k = cfg.normals_window
    R, W = cfg.num_rings, cfg.scan_width
    org = organize(scan, cfg)
    curv = curvature(org, cfg)

    flat_mask = curv < cfg.flatness_threshold
    neigh_flat = curv < cfg.flatness_threshold * cfg.neighbor_flatness_factor

    prev_xyz = torch.roll(org.xyz, 1, dims=-3)
    prev_flat = torch.roll(neigh_flat, 1, dims=-2)
    # left: col-k .. col-1 ascending; right: col+k .. col+1 descending
    left_pt, left_found = _first_flat_neighbor(prev_xyz, prev_flat, [-o for o in range(k, 0, -1)])
    right_pt, right_found = _first_flat_neighbor(prev_xyz, prev_flat, list(range(k, 0, -1)))

    origin = org.xyz
    normal = cross(left_pt - origin, right_pt - origin)
    nn = norm(normal, keepdim=True)
    normal = normal / torch.where(nn > 0, nn, torch.ones_like(nn))

    in_window = _in_window(R, W, k, origin.device)
    planar_mask = flat_mask & left_found & right_found & in_window & (nn[..., 0] > 0)
    lead = org.valid.shape[:-2]
    planar = PointsWithNormals(
        xyz=origin.reshape(*lead, R * W, 3),
        normal=normal.reshape(*lead, R * W, 3),
        valid=planar_mask.reshape(*lead, R * W),
    )
    return planar, org, curv


def _in_window(R: int, W: int, k: int, device) -> torch.Tensor:
    rows = torch.arange(R, device=device)[:, None]
    cols = torch.arange(W, device=device)[None, :]
    return (rows >= 1) & (cols >= k) & (cols < W - k)


def unclassified_mask(planar_valid: torch.Tensor, curv: torch.Tensor,
                      cfg: OdometryConfig) -> torch.Tensor:
    """(R, W) mask of the reference's `unclassified` cloud
    (cloud_classifier.h:155-162): in-window, valid, not planar."""
    R, W = curv.shape[-2:]
    in_window = _in_window(R, W, cfg.normals_window, curv.device)
    return (in_window & (curv < cfg.curvature_invalid_value)
            & ~planar_valid.reshape(curv.shape))
