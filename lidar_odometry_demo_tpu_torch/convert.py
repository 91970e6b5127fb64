"""Carry odometry state across frameworks.

The system has no weights; its state is `OdometryState`: a `VoxelMap` in
format v6 (tab (C, W) int32, keys (C,), count (C,), origin (3,), kdim
(1, K)) and two poses. Both frameworks keep the same format and the same
field names, so a state moves across leaf for leaf and compares slot by
slot. A batched state (parallel/batched.py, the JAX `init_batched_state`
and batched runners) keeps its leading lane axis on every leaf and moves
the same way.
"""

from __future__ import annotations

import numpy as np

from lidar_odometry_demo_tpu_torch.device import resolve_device, to_torch
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.se3 import Pose
from lidar_odometry_demo_tpu_torch.pipeline.odometry import OdometryState


def state_from_numpy(d, device=None) -> OdometryState:
    """State leaves as numpy arrays -> OdometryState on `device` (default
    "cuda"). `d` has the fields of OdometryState, as the JAX state does:
    `jax.tree.map(np.asarray, state)`, or what `state_to_numpy` returns."""
    dev = resolve_device(device)

    def leaf(x, dtype):
        return to_torch(np.asarray(x, dtype), dev)

    def pose(p):
        return Pose(leaf(p.t, np.float32), leaf(p.q, np.float32))

    keyframe = vm.VoxelMap(*(leaf(getattr(d.keyframe, f), np.int32)
                             for f in vm.VoxelMap._fields))
    return OdometryState(keyframe=keyframe, current=pose(d.current),
                         previous=pose(d.previous))


def state_to_numpy(state: OdometryState) -> OdometryState:
    """The inverse: the same named tuples with numpy leaves."""
    def leaf(t):
        return t.detach().cpu().numpy()

    return OdometryState(
        keyframe=vm.VoxelMap(*(leaf(x) for x in state.keyframe)),
        current=Pose(leaf(state.current.t), leaf(state.current.q)),
        previous=Pose(leaf(state.previous.t), leaf(state.previous.q)))
