"""The odometry pipeline: the per-scan step and the sequence runner (port of
the JAX ``pipeline/odometry.py``; reference LidarOdometry::processCloud,
src/lidar_odometry.cpp:22-77):

  time-normalize -> constant-velocity deskew -> planar classification ->
  range filter -> two-resolution downsample (0.1 m update / 0.3 m matching)
  -> point-to-plane ICP against the keyframe map from the guess
  current∘relative -> angular divergence guard with constant-velocity
  fallback -> radius eviction at 80 m -> world transform + keyframe insert.

Single device only. The first-scan branch is a Python `if` on the map's
occupancy (one device read per scan).

The same step serves a batch of B independent sequences: every state and
scan field then carries a leading lane axis, and each stage works per lane
(the JAX package's `vmap` of this step; parallel/batched.py builds on it).
The first-scan branch becomes a per-lane `initialized` mask, as `lax.cond`
under `vmap` does: ICP is skipped only when no lane is initialized (the
same one read), and otherwise runs for every lane and is selected per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.device import resolve_device
from lidar_odometry_demo_tpu_torch.ops import classifier, icp, preprocess, se3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy


class OdometryState(NamedTuple):
    keyframe: vm.VoxelMap
    current: se3.Pose   # current_transform_ (lidar_odometry.h:85)
    previous: se3.Pose  # previous_transform_ (lidar_odometry.h:84)


class StepDiagnostics(NamedTuple):
    """Per-scan diagnostics; each field has the step's lane axis, if any."""

    pose: se3.Pose
    icp_iterations: torch.Tensor
    icp_step_norm: torch.Tensor
    num_matches: torch.Tensor
    diverged: torch.Tensor      # divergence guard fired ("unstable rotation")
    num_planar: torch.Tensor
    map_voxels: torch.Tensor
    # update points outside the map's key window (dropped by the insert)
    num_window_dropped: torch.Tensor | None = None
    # voxel leaders dropped by the two downsample grids' static budgets
    num_downsample_dropped: torch.Tensor | None = None
    deskewed_xyz: torch.Tensor | None = None  # getTempCloud parity (optional)


def init_state(cfg: OdometryConfig, device=None) -> OdometryState:
    """Identity poses + empty keyframe (reference lidar_odometry.cpp:14-20)
    on `device` (default "cuda"; raises if there is none)."""
    dev = resolve_device(device)
    return OdometryState(
        keyframe=vm.map_init(cfg.map_capacity, cfg.keyframe_max_points_cnt, dev),
        current=se3.Pose.identity(dev),
        previous=se3.Pose.identity(dev),
    )


def make_process_scan(cfg: OdometryConfig, return_deskewed: bool = False):
    """The per-scan step: (state, scan) -> (state, diagnostics), for one
    sequence or, with a leading lane axis on the state and the scan, for B
    sequences at once."""
    align_fn = icp.make_align(cfg)

    def process_scan(state: OdometryState, raw: LidarScan):
        dev = raw.xyz.device
        lead = tuple(state.current.t.shape[:-1])
        # 1. normalize per-point time to [0, 1] (lidar_odometry.cpp:25)
        scan = preprocess.time_normalize(raw)
        # 2. constant-velocity model (lidar_odometry.cpp:27-28)
        relative = se3.relative_to(state.previous, state.current)
        previous = state.current
        # 3. deskew with relative.inverse() -> identity (lidar_odometry.cpp:30)
        deskewed = preprocess.deskew(
            scan, se3.inverse(relative), se3.Pose.identity(dev),
            forward_translation=cfg.deskew_forward_translation)
        # 4. planar features (lidar_odometry.cpp:33); 5. range filter (:35)
        planar, _, _ = classifier.classify(deskewed, cfg)
        planar = preprocess.range_filter(planar, cfg.lidar_min_range, cfg.lidar_max_range)
        num_planar = planar.count()
        # 6. two downsampling grids (lidar_odometry.cpp:37-47)
        update_ds, upd_overflow = vm.downsample(
            planar, voxel_size=cfg.keyframe_update_voxel_size,
            budget=cfg.max_update_points)
        match_ds, match_overflow = vm.downsample(
            planar, voxel_size=cfg.keyframe_matching_voxel_size,
            budget=cfg.max_match_points)
        guess = se3.compose(state.current, relative)

        # 7. ICP + divergence guard (lidar_odometry.cpp:49-63); the first
        #    scan skips to map init (lidar_odometry.cpp:40-44). Over lanes:
        #    ICP runs if any lane is initialized, and each lane selects.
        initialized = vm.map_size(state.keyframe) > 0
        init_flags = initialized.reshape(-1).tolist()
        if any(init_flags):
            res = align_fn(state.keyframe, match_ds.xyz, match_ds.valid, guess)
            ok = se3.rotation_within_threshold(
                se3.quat_mul(res.pose.q, se3.quat_conj(state.current.q)),
                cfg.angular_divergence_threshold)
            pose = se3.pose_where(ok, res.pose, guess)
            iters, step_norm, n_matches, diverged = (
                res.iterations, res.step_norm, res.num_matches, ~ok)
            if not all(init_flags):  # the first scan of some lanes: skip_icp there
                pose = se3.pose_where(initialized, pose, state.current)
                iters = torch.where(initialized, iters, 0)
                step_norm = torch.where(initialized, step_norm, 0.0)
                n_matches = torch.where(initialized, n_matches, 0)
                diverged = initialized & diverged
        else:
            pose = state.current
            iters = torch.zeros(lead, dtype=torch.int32, device=dev)
            step_norm = torch.zeros(lead, dtype=torch.float32, device=dev)
            n_matches = torch.zeros(lead, dtype=torch.int32, device=dev)
            diverged = torch.zeros(lead, dtype=torch.bool, device=dev)

        # 8. map maintenance (lidar_odometry.cpp:67-70): evict + rebase +
        #    insert in one pass
        upd_world = preprocess.transform_with_normals(update_ds, pose)
        keyframe = vm.map_update(
            state.keyframe, upd_world, pose.t,
            voxel_size=cfg.keyframe_voxel_size, radius=cfg.keyframe_cleanup_range)
        upd_keys = vm.pack_keys(
            vm.voxel_indices(upd_world.xyz, cfg.keyframe_voxel_size),
            keyframe.origin, upd_world.valid, map_window=True)
        n_dropped = torch.sum(upd_world.valid & (upd_keys == vm.EMPTY_KEY), dim=-1,
                              dtype=torch.int32)

        new_state = OdometryState(keyframe=keyframe, current=pose, previous=previous)
        diag = StepDiagnostics(
            pose=pose,
            icp_iterations=iters,
            icp_step_norm=step_norm,
            num_matches=n_matches,
            diverged=diverged,
            num_planar=num_planar,
            map_voxels=vm.map_size(keyframe),
            num_window_dropped=n_dropped,
            num_downsample_dropped=upd_overflow + match_overflow,
            deskewed_xyz=deskewed.xyz if return_deskewed else None,
        )
        return new_state, diag

    return process_scan


def stack_diagnostics(diags: list[StepDiagnostics]) -> StepDiagnostics:
    """Per-scan diagnostics -> one StepDiagnostics with a leading scan axis
    (before the lane axis of a batched step)."""
    def stack(xs):
        return None if xs[0] is None else torch.stack(xs)

    poses = [d.pose for d in diags]
    fields = {f: stack([getattr(d, f) for d in diags])
              for f in StepDiagnostics._fields if f != "pose"}
    return StepDiagnostics(pose=se3.Pose(torch.stack([p.t for p in poses]),
                                         torch.stack([p.q for p in poses])), **fields)


def make_sequence_runner(cfg: OdometryConfig):
    """run(state, scans) -> (final state, stacked diagnostics) over a list
    of LidarScans, one step per scan (the offline / bench path)."""
    step = make_process_scan(cfg)

    def run(state: OdometryState, scans: list[LidarScan]):
        diags = []
        for scan in scans:
            state, diag = step(state, scan)
            diags.append(diag)
        return state, stack_diagnostics(diags)

    return run


class LidarOdometry:
    """Host-facing stateful wrapper (reference src/lidar_odometry.h:65-76).
    Runs on `device`, "cuda" unless the caller names another."""

    def __init__(self, cfg: OdometryConfig | None = None, keep_deskewed: bool = False,
                 device=None):
        self.cfg = cfg or OdometryConfig()
        self.device = resolve_device(device)
        self._state = init_state(self.cfg, self.device)
        self._step = make_process_scan(self.cfg, return_deskewed=keep_deskewed)
        self._last_diag: StepDiagnostics | None = None

    def process_cloud(self, xyz, intensity, ring, time) -> StepDiagnostics:
        """Process one raw scan (numpy arrays); returns diagnostics."""
        scan = scan_from_numpy(
            np.asarray(xyz), np.asarray(intensity), np.asarray(ring),
            np.asarray(time), self.cfg.max_raw_points, self.device)
        return self.process_scan(scan)

    def process_scan(self, scan: LidarScan) -> StepDiagnostics:
        self._state, diag = self._step(self._state, scan)
        self._last_diag = diag
        return diag

    def get_current_pose(self) -> tuple[np.ndarray, np.ndarray]:
        """(translation, quaternion wxyz) — reference getCurrentPose(); one
        device read."""
        tq = torch.cat([self._state.current.t, self._state.current.q]).cpu().numpy()
        return tq[:3], tq[3:]

    def get_keyframe_cloud(self) -> np.ndarray:
        """1 point/voxel keyframe export — reference getKeyFrameCloud()."""
        return vm.get_sparse_cloud(self._state.keyframe)

    def get_full_keyframe_cloud(self) -> np.ndarray:
        """All stored points — reference getFullKeyFrameCloud()."""
        return vm.get_cloud(self._state.keyframe)[0]

    def get_temp_cloud(self) -> np.ndarray | None:
        """Last deskewed input cloud (requires keep_deskewed=True)."""
        if self._last_diag is None or self._last_diag.deskewed_xyz is None:
            return None
        return self._last_diag.deskewed_xyz.cpu().numpy()

    @property
    def state(self) -> OdometryState:
        return self._state

    @state.setter
    def state(self, s: OdometryState):
        self._state = s
