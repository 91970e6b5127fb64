"""Multi-sequence batched odometry over a (dp, sp) mesh of ranks (port of
the JAX ``parallel/batched.py``).

The scan loop is serial within a sequence (the pose feeds the next deskew,
lidar_odometry.cpp:27-30), so fleet throughput comes from stepping many
independent sequences together. The JAX package `vmap`s its per-scan step
and shards the batch over a (dp, sp) device mesh; here the per-scan step
itself takes the lane axis (pipeline/odometry.py): every tensor carries a
leading B and every kernel launch serves all B lanes, so one step of B
scans issues the launches of one scan. On the card that step is captured
as CUDA graphs (pipeline/graphs.py), as the JAX package jits its batched
step, under an sp group too where the group runs on NCCL (its gathers
captured in the round's graph); under a gloo group it runs eager.

With a mesh (parallel/mesh.py), each rank steps its dp index's B / dp
lanes on that lane axis (`Mesh.lanes`), and with sp > 1 the ranks of its sp
group share each lane's ICP, each on a slice of the matching points, with
the normal equations summed over the group. Without a mesh the runner
steps all B lanes in this process.

Layouts follow the JAX package: states have a leading (B, ...) axis on
every leaf, and a sequence runner's scans a leading (S, B, ...) axis (time,
then lane), so a JAX batched state moves across leaf for leaf (convert.py).
"""

from __future__ import annotations

import numpy as np

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.pipeline import odometry
from lidar_odometry_demo_tpu_torch.pipeline.graphs import CapturedStep
from lidar_odometry_demo_tpu_torch.utils import profiling


def init_batched_state(cfg: OdometryConfig, batch: int, device=None) -> odometry.OdometryState:
    """Stacked fresh odometry states for `batch` independent sequences on
    `device` (default "cuda"; raises if there is none)."""
    one = odometry.init_state(cfg, device)

    def stacked(x):
        return x.expand(batch, *x.shape).clone()

    return odometry.OdometryState(
        keyframe=type(one.keyframe)(*(stacked(x) for x in one.keyframe)),
        current=type(one.current)(*(stacked(x) for x in one.current)),
        previous=type(one.previous)(*(stacked(x) for x in one.previous)))


def make_batched_step(cfg: OdometryConfig, mesh=None):
    """(state_batch, scan_batch) -> (state_batch, diag_batch): one step of
    every lane, each field with a leading B: the captured step
    (pipeline/graphs.py; eager on CPU tensors and under a gloo group). With
    a mesh of sp > 1 the ICP of every lane is shared by the mesh's sp group
    (the JAX `make_batched_step`). The returned state is valid until the
    step's next call, which may rewrite it in place; `step.own(state)`
    keeps it. The caller passes this rank's lanes."""
    if mesh is not None and mesh.sp.size > 1:
        return CapturedStep(cfg, sp_group=mesh.sp)
    return CapturedStep(cfg)


def make_batched_sequence_runner(cfg: OdometryConfig, mesh=None):
    """run(state_batch, scans) -> (final state_batch, diagnostics (S, B)).

    scans: a LidarScan whose fields have leading (S, B, ...) axes (time,
    lane), as the JAX runner takes them. With a mesh, scans are the same on
    every rank and this rank steps its lanes `mesh.lanes(B)`: the state
    holds those lanes only (init_batched_state(cfg, B // dp)), and so do
    the final state and diagnostics (`gather_lanes` puts every rank's back
    together)."""
    step = make_batched_step(cfg, mesh)

    def run(state_b: odometry.OdometryState, scans_b: LidarScan):
        if mesh is not None and mesh.dp > 1:
            mine = mesh.lanes(scans_b.xyz.shape[1])
            scans_b = LidarScan(*(x[:, mine] for x in scans_b))
        if state_b.current.t.shape[0] != scans_b.xyz.shape[1]:
            raise ValueError(f"the state holds {state_b.current.t.shape[0]} lanes, this "
                             f"rank steps {scans_b.xyz.shape[1]}")
        diags = []
        for s in range(scans_b.xyz.shape[0]):
            if profiling.ON:
                profiling.begin("fleet.step")
            state_b, diag = step(state_b, LidarScan(*(x[s] for x in scans_b)))
            diags.append(diag)
            if profiling.ON:
                profiling.end()
        if profiling.ON:
            profiling.begin("fleet.collect", "dev.collect")
        out = step.own(state_b), odometry.stack_diagnostics(diags)
        if profiling.ON:
            profiling.end(dev_end=True)
        return out

    return run


def gather_lanes(mesh, x: np.ndarray, lane_axis: int = 1) -> np.ndarray:
    """Every lane of a per-rank numpy result, in lane order, on every rank:
    the pieces of each dp index's first rank (the ranks of one sp group
    hold the same lanes), concatenated along `lane_axis`."""
    parts = mesh.all_gather_object(x)
    return np.concatenate(parts[::mesh.sp_size], axis=lane_axis)
