"""The odometry pipeline: the per-scan step and the sequence runner (port of
the JAX ``pipeline/odometry.py``; reference LidarOdometry::processCloud,
src/lidar_odometry.cpp:22-77):

  time-normalize -> constant-velocity deskew -> planar classification ->
  range filter -> two-resolution downsample (0.1 m update / 0.3 m matching)
  -> point-to-plane ICP against the keyframe map from the guess
  current∘relative -> angular divergence guard with constant-velocity
  fallback -> radius eviction at 80 m -> world transform + keyframe insert.

The first-scan branch is a Python `if` on the map's occupancy (one wait
for a host copy of it per scan, read once the scan's preprocessing is
queued). This eager step is the CPU's and a group's; on the card the
runners replay it as CUDA graphs (pipeline/graphs.py).

Sharded modes (parallel/mesh.py groups, one rank per process): with an sp
group each rank aligns its `max_match_points // n` slice of the matching
points against the replicated map; with a spatial group each rank holds
one column shard of the map (parallel/spatial.py), searches the view its
ring neighbours' shards complete, aligns the queries it owns and inserts
the points it owns. Either way ICP sums its counts, costs, H and b over
the group (ops/icp.py), and ICP always runs: the first scan is selected
afterwards, so that no collective sits in a branch that one rank could
take and another not.

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
from lidar_odometry_demo_tpu_torch.device import HostFlags, resolve_device
from lidar_odometry_demo_tpu_torch.ops import classifier, icp, preprocess, se3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.cloud import (
    LidarScan, PointsWithNormals, scan_from_numpy)
from lidar_odometry_demo_tpu_torch.utils import profiling


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
        current=se3.Pose(*(x.clone() for x in se3.Pose.identity(dev))),
        previous=se3.Pose(*(x.clone() for x in se3.Pose.identity(dev))),
    )


class Prepared(NamedTuple):
    """What the step computes from the scan before ICP: the deskewed,
    classified and downsampled points, the guess, and what the map update
    and the diagnostics take from them."""

    previous: se3.Pose          # the state's current pose, the next previous
    guess: se3.Pose
    update_ds: PointsWithNormals
    q_xyz: torch.Tensor         # this rank's matching points (local)
    q_valid: torch.Tensor
    num_planar: torch.Tensor
    num_downsample_dropped: torch.Tensor
    deskewed_xyz: torch.Tensor | None


class ScanStep:
    """The per-scan step: (state, scan) -> (state, diagnostics), for one
    sequence or, with a leading lane axis on the state and the scan, for B
    sequences at once; eager, the counterpart of the JAX package's
    un-jitted `make_process_scan`.

    Calling it composes its parts: `prepare` (preprocessing to the
    guess), ICP (`align`: `begin`, rounds, `finish`), `outcome` (the
    divergence guard and the first-scan selection) and `update` (map
    maintenance and the diagnostics). pipeline/graphs.py captures the same
    parts as CUDA graphs.

    The state a step returns (this one's or the captured step's) is valid
    until the step's next call; a caller that keeps it longer takes
    `step.own(state)`.

    sp_group: the ranks that share each sequence's ICP, each taking a
    slice of the matching points (the JAX `sp_axis`). spatial_group: the
    ranks that hold the keyframe map's column shards; state.keyframe is
    this rank's shard (parallel/spatial.py, the JAX `spatial_axis`). The
    two are mutually exclusive."""

    def __init__(self, cfg: OdometryConfig, return_deskewed: bool = False,
                 sp_group=None, spatial_group=None):
        if sp_group is not None and spatial_group is not None:
            raise ValueError("sp_group (query slicing) and spatial_group (map partitioning) "
                             "shard the same ICP loop differently; pick one")
        self.cfg, self.return_deskewed = cfg, return_deskewed
        self.sp_group, self.spatial_group = sp_group, spatial_group
        self.group = sp_group if spatial_group is None else spatial_group
        if spatial_group is not None:
            from lidar_odometry_demo_tpu_torch.parallel import spatial

            def owner(m_view, q_world):
                return spatial.owner_mask(q_world, m_view.origin, cfg.keyframe_voxel_size,
                                          spatial_group)

            self.align = icp.make_align(cfg, group=spatial_group, owner_fn=owner)
        elif sp_group is not None:
            self.align = icp.make_align(cfg, group=sp_group)
        else:
            self.align = icp.make_align(cfg)
        self._init_flags: dict = {}

    def own(self, state: OdometryState) -> OdometryState:
        """`state` itself: the eager step returns new tensors and never
        writes one it returned (the captured step's `own` copies)."""
        return state

    def init_flags(self, lead: tuple, device) -> HostFlags:
        """The host copy of the first-scan test's flags, one per lane."""
        key = (lead, torch.device(device))
        if key not in self._init_flags:
            self._init_flags[key] = HostFlags((lead[0] if lead else 1,), torch.bool, device)
        return self._init_flags[key]

    def prepare(self, state: OdometryState, raw: LidarScan) -> Prepared:
        cfg = self.cfg
        dev = raw.xyz.device
        # 1. normalize per-point time to [0, 1] (lidar_odometry.cpp:25)
        scan = preprocess.time_normalize(raw)
        # 2. constant-velocity model (lidar_odometry.cpp:27-28)
        relative = se3.relative_to(state.previous, state.current)
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
        q_xyz, q_valid = match_ds.xyz, match_ds.valid
        if self.sp_group is not None:  # this rank's slice of the matching points
            chunk = cfg.max_match_points // self.sp_group.size
            rows = slice(self.sp_group.rank * chunk, (self.sp_group.rank + 1) * chunk)
            q_xyz = q_xyz[..., rows, :].contiguous()
            q_valid = q_valid[..., rows].contiguous()
        return Prepared(
            previous=state.current, guess=se3.compose(state.current, relative),
            update_ds=update_ds, q_xyz=q_xyz, q_valid=q_valid, num_planar=num_planar,
            num_downsample_dropped=upd_overflow + match_overflow,
            deskewed_xyz=deskewed.xyz if self.return_deskewed else None)

    def outcome(self, state: OdometryState, prep: Prepared, res: icp.IcpResult,
                initialized: torch.Tensor | None = None):
        """ICP's result through the angular divergence guard, with its
        constant-velocity fallback (lidar_odometry.cpp:49-63); where
        `initialized` is given, a lane that is not keeps its pose and
        reports no ICP (the first scan, lidar_odometry.cpp:40-44). Returns
        (pose, iterations, step norm, matches, diverged)."""
        ok = se3.rotation_within_threshold(
            se3.quat_mul(res.pose.q, se3.quat_conj(state.current.q)),
            self.cfg.angular_divergence_threshold)
        pose = se3.pose_where(ok, res.pose, prep.guess)
        iters, step_norm, n_matches, diverged = (
            res.iterations, res.step_norm, res.num_matches, ~ok)
        if initialized is not None:
            pose = se3.pose_where(initialized, pose, state.current)
            iters = torch.where(initialized, iters, 0)
            step_norm = torch.where(initialized, step_norm, 0.0)
            n_matches = torch.where(initialized, n_matches, 0)
            diverged = initialized & diverged
        return pose, iters, step_norm, n_matches, diverged

    def update(self, state: OdometryState, prep: Prepared, pose: se3.Pose, iters, step_norm,
               n_matches, diverged, tab_out: torch.Tensor | None = None):
        """Map maintenance (lidar_odometry.cpp:67-70: evict + rebase +
        insert in one pass) at the scan's pose, the new table gathered into
        `tab_out` where given (vm.map_update); returns (new state,
        diagnostics)."""
        cfg, spatial_group = self.cfg, self.spatial_group
        upd_world = preprocess.transform_with_normals(prep.update_ds, pose)
        if spatial_group is None:
            keyframe = vm.map_update(
                state.keyframe, upd_world, pose.t,
                voxel_size=cfg.keyframe_voxel_size, radius=cfg.keyframe_cleanup_range,
                tab_out=tab_out)
            map_voxels = vm.map_size(keyframe)
        else:  # insert only the columns this rank owns; rebase in steps of N
            from lidar_odometry_demo_tpu_torch.parallel import spatial

            own = spatial.owner_mask(upd_world.xyz, state.keyframe.origin,
                                     cfg.keyframe_voxel_size, spatial_group)
            upd_world = upd_world._replace(valid=upd_world.valid & own)
            keyframe = vm.map_update(
                state.keyframe, upd_world, pose.t,
                voxel_size=cfg.keyframe_voxel_size, radius=cfg.keyframe_cleanup_range,
                origin_quantum=spatial_group.size)
            map_voxels = spatial_group.psum(vm.map_size(keyframe), "map_voxels")
        upd_keys = vm.pack_keys(
            vm.voxel_indices(upd_world.xyz, cfg.keyframe_voxel_size),
            keyframe.origin, upd_world.valid, map_window=True)
        n_dropped = torch.sum(upd_world.valid & (upd_keys == vm.EMPTY_KEY), dim=-1,
                              dtype=torch.int32)
        new_state = OdometryState(keyframe=keyframe, current=pose, previous=prep.previous)
        diag = StepDiagnostics(
            pose=pose,
            icp_iterations=iters,
            icp_step_norm=step_norm,
            num_matches=n_matches,
            diverged=diverged,
            num_planar=prep.num_planar,
            map_voxels=map_voxels,
            num_window_dropped=n_dropped,
            num_downsample_dropped=prep.num_downsample_dropped,
            deskewed_xyz=prep.deskewed_xyz,
        )
        return new_state, diag

    def __call__(self, state: OdometryState, raw: LidarScan):
        dev = raw.xyz.device
        lead = tuple(state.current.t.shape[:-1])
        spatial_group = self.spatial_group
        # 7. ICP + divergence guard (lidar_odometry.cpp:49-63); the first
        #    scan skips to map init (lidar_odometry.cpp:40-44). Over lanes:
        #    ICP runs if any lane is initialized, and each lane selects.
        #    Under a group ICP always runs and every lane selects.
        if spatial_group is None:
            initialized = vm.map_size(state.keyframe) > 0
            icp_map = state.keyframe
        if self.group is None:  # read once the scan's preprocessing is queued
            flags = self.init_flags(lead, dev)
            flags.write(initialized)
            flags.mark()
        prep = self.prepare(state, raw)
        if spatial_group is not None:  # the shards' sum; ICP searches the halo's view
            from lidar_odometry_demo_tpu_torch.parallel import spatial

            initialized = spatial_group.psum(vm.map_size(state.keyframe), "initialized") > 0
            icp_map = spatial.build_halo_view(state.keyframe, spatial_group)
        if self.group is None:
            init_flags = flags.read()
            run_icp, select = any(init_flags), not all(init_flags)
        else:
            run_icp = select = True
        if run_icp:
            res = self.align(icp_map, prep.q_xyz, prep.q_valid, prep.guess)
            outcome = self.outcome(state, prep, res, initialized if select else None)
        else:
            i32 = dict(dtype=torch.int32, device=dev)
            outcome = (state.current, torch.zeros(lead, **i32),
                       torch.zeros(lead, dtype=torch.float32, device=dev),
                       torch.zeros(lead, **i32), torch.zeros(lead, dtype=torch.bool, device=dev))
        return self.update(state, prep, *outcome)


def make_process_scan(cfg: OdometryConfig, return_deskewed: bool = False,
                      sp_group=None, spatial_group=None) -> ScanStep:
    """The eager per-scan step (see ScanStep): the CPU's step, a group's
    step, and the reference the captured step (pipeline/graphs.py) is held
    to."""
    return ScanStep(cfg, return_deskewed, sp_group, spatial_group)


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
    of LidarScans, one step per scan (the offline / bench path; the JAX
    runner's `jax.jit(lax.scan(step))`): the captured step on the card
    (pipeline/graphs.py), the eager step on CPU tensors."""
    from lidar_odometry_demo_tpu_torch.pipeline.graphs import CapturedStep

    step = CapturedStep(cfg)

    def run(state: OdometryState, scans: list[LidarScan]):
        diags = []
        for scan in scans:
            state, diag = step(state, scan)
            diags.append(diag)
        return step.own(state), stack_diagnostics(diags)

    return run


class LidarOdometry:
    """Host-facing stateful wrapper (reference src/lidar_odometry.h:65-76).
    Runs on `device`, "cuda" unless the caller names another; on the card
    each scan replays the captured step (pipeline/graphs.py). `state`
    reads a copy that later scans leave as it is (`CapturedStep.own`); a
    state assigned to it is copied into the step's buffers at the next
    scan."""

    def __init__(self, cfg: OdometryConfig | None = None, keep_deskewed: bool = False,
                 device=None):
        from lidar_odometry_demo_tpu_torch.pipeline.graphs import CapturedStep

        self.cfg = cfg or OdometryConfig()
        self.device = resolve_device(device)
        self._state = init_state(self.cfg, self.device)
        self._step = CapturedStep(self.cfg, return_deskewed=keep_deskewed)
        self._last_diag: StepDiagnostics | None = None

    def process_cloud(self, xyz, intensity, ring, time) -> StepDiagnostics:
        """Process one raw scan (numpy arrays); returns diagnostics."""
        scan = scan_from_numpy(
            np.asarray(xyz), np.asarray(intensity), np.asarray(ring),
            np.asarray(time), self.cfg.max_raw_points, self.device)
        return self.process_scan(scan)

    def process_scan(self, scan: LidarScan) -> StepDiagnostics:
        if profiling.ON:
            profiling.begin("odometry.scan")
        self._state, diag = self._step(self._state, scan)
        self._last_diag = diag
        if profiling.ON:
            profiling.end()
        return diag

    def get_current_pose(self) -> tuple[np.ndarray, np.ndarray]:
        """(translation, quaternion wxyz) — reference getCurrentPose(); one
        device read."""
        if profiling.ON:
            profiling.begin("odometry.pose_read", "dev.pose_read")
        tq = torch.cat([self._state.current.t, self._state.current.q]).cpu().numpy()
        if profiling.ON:
            profiling.end(dev_end=True)
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
        return self._step.own(self._state)

    @state.setter
    def state(self, s: OdometryState):
        self._state = s
