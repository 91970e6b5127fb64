"""Configuration presets for the odometry engine."""

from __future__ import annotations

from lidar_odometry_demo_tpu_torch.config import TINY, OdometryConfig


def vlp16_default() -> OdometryConfig:
    """The reference's exact operating point (its ROS defaults +
    hard-coded constants; reference lidar_odometry.h:36-48)."""
    return OdometryConfig()


def vlp16_fast() -> OdometryConfig:
    """Lower-latency trade-off: coarser matching grid, fewer ICP rounds,
    tighter budgets. Suitable when throughput matters more than the last
    few millimetres (e.g. many-sequence batch processing)."""
    return OdometryConfig(
        keyframe_matching_voxel_size=0.5,
        max_match_points=4096,
        icp_max_outer_iterations=20,
        map_capacity=65536,
    )


def vlp16_high_accuracy() -> OdometryConfig:
    """Denser matching + deeper solves: finer matching grid, more
    correspondences, more GN rounds."""
    return OdometryConfig(
        keyframe_matching_voxel_size=0.2,
        keyframe_update_voxel_size=0.05,
        max_match_points=16384,
        max_update_points=32768,
        icp_max_outer_iterations=50,
    )


def tiny_test() -> OdometryConfig:
    """Small static shapes for unit tests and dry runs."""
    return TINY
