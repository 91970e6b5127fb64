"""The step's front end (``prepare.cu``): what `ScanStep.prepare` computes
before the two downsample sorts, as one fused call, its plain PyTorch
version, and its launch counter.

Replaces no TPU kernel: the JAX package leaves this part of its step
(time-normalize, the constant-velocity deskew, the planar classifier, the
range filter and the two grids' voxel keys) to XLA's fusion, and the port's
plain composition of the same functions runs as ~430 small PyTorch kernels a
scan, each bound by its launch. `prepare` runs it in four launches for any
number of lanes (see the source's note); one call counts once in
`prepare.launches`. On CPU tensors it runs its plain version; on CUDA
tensors it launches the kernel or raises. There is no fallback between the
two.

Lanes: the poses and the scan may carry a leading lane axis B (independent
sequences); one call serves all lanes, and every output carries the axis.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.kernels import _build
from lidar_odometry_demo_tpu_torch.kernels._build import check_tensors, lanes
from lidar_odometry_demo_tpu_torch.ops import classifier, preprocess, se3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, PointsWithNormals

# the curvature window's halo must fit the kernel's shared memory (48 KB a block)
MAX_WINDOW = 1000


class FrontEnd(NamedTuple):
    """The front end's outputs, each with the scan's lane axis, if any."""

    guess: se3.Pose                # current o relative, the ICP's start
    planar: PointsWithNormals      # the (R W) image's points, normals, planar and in range
    num_planar: torch.Tensor       # int32: planar points in range
    update_keys: torch.Tensor      # (R W,) int32 keys of the update grid (EMPTY_KEY if not valid)
    match_keys: torch.Tensor       # (R W,) int32 keys of the matching grid
    deskewed_xyz: torch.Tensor | None  # (N, 3), where asked for


def prepare_plain(previous: se3.Pose, current: se3.Pose, raw: LidarScan, cfg: OdometryConfig,
                  return_deskewed: bool = False) -> FrontEnd:
    """The front end as the composition of its functions (pipeline order of
    the reference's LidarOdometry::processCloud, lidar_odometry.cpp:25-47)."""
    # 1. normalize per-point time to [0, 1] (lidar_odometry.cpp:25)
    scan = preprocess.time_normalize(raw)
    # 2. constant-velocity model (lidar_odometry.cpp:27-28)
    relative = se3.relative_to(previous, current)
    # 3. deskew with relative.inverse() -> identity (lidar_odometry.cpp:30)
    deskewed = preprocess.deskew(
        scan, se3.inverse(relative), se3.Pose.identity(raw.xyz.device),
        forward_translation=cfg.deskew_forward_translation)
    # 4. planar features (lidar_odometry.cpp:33); 5. range filter (:35)
    planar, _, _ = classifier.classify(deskewed, cfg)
    planar = preprocess.range_filter(planar, cfg.lidar_min_range, cfg.lidar_max_range)
    return FrontEnd(
        guess=se3.compose(current, relative), planar=planar, num_planar=planar.count(),
        update_keys=vm.grid_keys(planar, cfg.keyframe_update_voxel_size),
        match_keys=vm.grid_keys(planar, cfg.keyframe_matching_voxel_size),
        deskewed_xyz=deskewed.xyz if return_deskewed else None)


def _scalars(cfg: OdometryConfig) -> list:
    """The kernel's float arguments, computed from the configuration as the
    plain path computes its scalar operands (in double, cast to float32)."""
    k = cfg.curvature_window
    return [math.pi, 2.0 * math.pi, 2.0 * k + 1.0, cfg.min_valid_range_sq,
            cfg.curvature_invalid_value, cfg.flatness_threshold,
            cfg.flatness_threshold * cfg.neighbor_flatness_factor,
            cfg.lidar_min_range * cfg.lidar_min_range, cfg.lidar_max_range * cfg.lidar_max_range,
            cfg.keyframe_update_voxel_size, cfg.keyframe_matching_voxel_size]


def prepare(previous: se3.Pose, current: se3.Pose, raw: LidarScan, cfg: OdometryConfig,
            return_deskewed: bool = False) -> FrontEnd:
    """The front end: the plain version on CPU tensors, four kernel
    launches on CUDA ones.

    previous, current: the state's poses, t (3,) and q (4,) float32; raw:
    the padded scan, xyz (N, 3) float32, ring (N,) int32, time (N,) float32,
    valid (N,) bool; each may carry a leading lane axis B. Every tensor
    contiguous. The planar cloud covers the (num_rings x scan_width) image,
    flattened ring by ring."""
    if raw.xyz.device.type == "cpu":
        return prepare_plain(previous, current, raw, cfg, return_deskewed)
    lead = tuple(raw.valid.shape[:-1])
    B, N = lanes(lead), raw.valid.shape[-1]
    R, W = cfg.num_rings, cfg.scan_width
    kc, kn = cfg.curvature_window, cfg.normals_window
    check_tensors(
        (raw.xyz, "raw.xyz", torch.float32, (*lead, N, 3)),
        (raw.ring, "raw.ring", torch.int32, (*lead, N)),
        (raw.time, "raw.time", torch.float32, (*lead, N)),
        (raw.valid, "raw.valid", torch.bool, (*lead, N)),
        (previous.t, "previous.t", torch.float32, (*lead, 3)),
        (previous.q, "previous.q", torch.float32, (*lead, 4)),
        (current.t, "current.t", torch.float32, (*lead, 3)),
        (current.q, "current.q", torch.float32, (*lead, 4)))
    if not (0 <= kc <= MAX_WINDOW and 0 <= kn):
        raise ValueError(f"curvature_window {kc} must lie in [0, {MAX_WINDOW}] and "
                         f"normals_window {kn} must not be negative")
    dev = raw.xyz.device
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    RW = R * W
    lane_par = torch.empty((*lead, 16), **f32)
    winner = torch.empty((*lead, RW), **i32)
    flags = torch.empty((*lead, RW), dtype=torch.uint8, device=dev)
    desk = torch.empty((*lead, N, 3), **f32)
    img = torch.empty((*lead, RW, 3), **f32)
    normal = torch.empty((*lead, RW, 3), **f32)
    valid = torch.empty((*lead, RW), dtype=torch.bool, device=dev)
    keys_upd = torch.empty((*lead, RW), **i32)
    keys_match = torch.empty((*lead, RW), **i32)
    num_planar = torch.empty(lead, **i32)
    guess_t = torch.empty((*lead, 3), **f32)
    guess_q = torch.empty((*lead, 4), **f32)
    fn = _build.c_function("prepare", "prepare_launch",
                           [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float] * 11
                           + [ctypes.c_void_p] * 13)
    _build.launch(fn, dev, raw.xyz.data_ptr(), raw.ring.data_ptr(), raw.time.data_ptr(),
                  raw.valid.data_ptr(), previous.t.data_ptr(), previous.q.data_ptr(),
                  current.t.data_ptr(), current.q.data_ptr(), B, N, R, W, kc, kn,
                  int(cfg.deskew_forward_translation), *_scalars(cfg), lane_par.data_ptr(),
                  winner.data_ptr(), flags.data_ptr(), desk.data_ptr(), img.data_ptr(),
                  normal.data_ptr(), valid.data_ptr(), keys_upd.data_ptr(),
                  keys_match.data_ptr(), num_planar.data_ptr(), guess_t.data_ptr(),
                  guess_q.data_ptr())
    prepare.launches += 1
    return FrontEnd(guess=se3.Pose(guess_t, guess_q),
                    planar=PointsWithNormals(xyz=img, normal=normal, valid=valid),
                    num_planar=num_planar, update_keys=keys_upd, match_keys=keys_match,
                    deskewed_xyz=desk if return_deskewed else None)


prepare.launches = 0
