"""Multi-sequence batched odometry on one device (port of the JAX
``parallel/batched.py``).

The scan loop is serial within a sequence (the pose feeds the next deskew,
lidar_odometry.cpp:27-30), so fleet throughput comes from stepping many
independent sequences together. The JAX package `vmap`s its per-scan step
and shards the batch over a (dp, sp) device mesh; here the per-scan step
itself takes the lane axis (pipeline/odometry.py): every tensor carries a
leading B and every kernel launch serves all B lanes, so one step of B
scans issues the launches of one scan. One card is dp = 1, sp = 1; the
sharded modes are not ported.

Layouts follow the JAX package: states have a leading (B, ...) axis on
every leaf, and a sequence runner's scans a leading (S, B, ...) axis (time,
then lane), so a JAX batched state moves across leaf for leaf (convert.py).
"""

from __future__ import annotations

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.pipeline import odometry


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


def make_batched_step(cfg: OdometryConfig):
    """(state_batch, scan_batch) -> (state_batch, diag_batch): one step of
    every lane, each field with a leading B (the JAX `make_batched_step`
    without its mesh)."""
    return odometry.make_process_scan(cfg)


def make_batched_sequence_runner(cfg: OdometryConfig):
    """run(state_batch, scans) -> (final state_batch, diagnostics (S, B)).

    scans: a LidarScan whose fields have leading (S, B, ...) axes (time,
    lane), as the JAX runner takes them."""
    step = make_batched_step(cfg)

    def run(state_b: odometry.OdometryState, scans_b: LidarScan):
        diags = []
        for s in range(scans_b.xyz.shape[0]):
            state_b, diag = step(state_b, LidarScan(*(x[s] for x in scans_b)))
            diags.append(diag)
        return state_b, odometry.stack_diagnostics(diags)

    return run
