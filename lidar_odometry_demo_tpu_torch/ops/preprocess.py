"""Scan preprocessing: time normalization, range filter, deskew (port of
the JAX ``ops/preprocess.py``; reference point_time_normalize.h,
range_filter.h and cloud_transform.h)."""

from __future__ import annotations

import torch

from lidar_odometry_demo_tpu_torch.ops import se3
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, PointsWithNormals

# masking sentinel for the min/max reductions (the JAX package's value)
_BIG = 1.0e9


def time_normalize(scan: LidarScan) -> LidarScan:
    """Rescale per-point times to [0, 1] over the valid points (of each lane
    of a batch); an all-equal scan keeps range 1 (the reference divides by
    zero there)."""
    t = scan.time
    tmin = torch.amin(torch.where(scan.valid, t, _BIG), dim=-1, keepdim=True)
    tmax = torch.amax(torch.where(scan.valid, t, -_BIG), dim=-1, keepdim=True)
    rng = tmax - tmin
    rng = torch.where(rng > 0, rng, torch.ones_like(rng))
    return scan._replace(time=(t - tmin) / rng)


def range_filter_mask(xyz: torch.Tensor, valid: torch.Tensor,
                      min_range: float, max_range: float) -> torch.Tensor:
    """Keep points with min_range <= ||p|| <= max_range (squared compare)."""
    sq = torch.sum(xyz * xyz, dim=-1)
    return valid & (sq >= min_range * min_range) & (sq <= max_range * max_range)


def range_filter(pts: PointsWithNormals, min_range: float, max_range: float) -> PointsWithNormals:
    return pts._replace(valid=range_filter_mask(pts.xyz, pts.valid, min_range, max_range))


def deskew(scan: LidarScan, start_pose: se3.Pose, end_pose: se3.Pose,
           forward_translation: bool = True) -> LidarScan:
    """Continuous-time non-rigid deskew: rotation slerps from start to end
    over the normalized time; translation interpolates forward
    (start.t*(1-t) + end.t*t) or, with forward_translation=False, with the
    reference's backwards formula (cloud_transform.h:26-30). Over a lane
    axis, one start and end pose per lane."""
    shape = (*scan.time.shape, 4)
    q0 = start_pose.q[..., None, :].expand(shape)
    q1 = end_pose.q[..., None, :].expand(shape)
    q_t = se3.quat_slerp(q0, q1, scan.time)
    rotated = se3.quat_rotate(q_t, scan.xyz)
    time = scan.time[..., None]
    w_start = (1.0 - time) if forward_translation else time
    trans = start_pose.t[..., None, :] * w_start + end_pose.t[..., None, :] * (1.0 - w_start)
    return scan._replace(xyz=rotated + trans)


def transform_scan(scan: LidarScan, pose: se3.Pose) -> LidarScan:
    """Rigid transform (CloudTransformer::transform, cloud_transform.h:44-66)."""
    return scan._replace(xyz=se3.transform_points(pose, scan.xyz))


def transform_with_normals(pts: PointsWithNormals, pose: se3.Pose) -> PointsWithNormals:
    """Rigid transform rotating the normals too (one pose per lane)."""
    return pts._replace(
        xyz=se3.transform_points(pose, pts.xyz),
        normal=se3.quat_rotate(pose.q[..., None, :], pts.normal),
    )
