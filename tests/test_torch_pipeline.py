"""Port parity for the whole slice: the per-scan step and a TINY drive
against the JAX package (CPU), state carried across frameworks, and the
port's guards.

Tolerances: one step from a carried-over state gives bitwise-equal map
keys, counts and origin and a pose within 1e-5; over an 8-scan TINY drive
the per-scan poses agree within 1e-4 m (the float32 differences of the two
libraries' transcendentals and reduction orders, compounded over scans)
with equal ICP iteration counts.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.pipeline import odometry as jodo
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.convert import state_from_numpy, state_to_numpy
from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy as port_scan
from lidar_odometry_demo_tpu_torch.pipeline import odometry as todo

REPO = pathlib.Path(__file__).resolve().parent.parent
N_SCANS = 8


@pytest.fixture(scope="module")
def drive():
    """A TINY drive through the JAX step, with every intermediate state."""
    d = simulate_sequence(num_scans=N_SCANS, width=TINY.scan_width, seed=3,
                          speed=2.0, yaw_rate=0.05, ramp_time=0.0)
    raw = [(s["xyz"], s["intensity"], s["ring"], s["time"]) for s in d.scans]
    step = jax.jit(jodo.make_process_scan(JTINY))
    state = jodo.init_state(JTINY)
    states, diags = [state], []
    for r in raw:
        state, diag = step(state, jax_scan(*r, JTINY.max_raw_points))
        states.append(state)
        diags.append(jax.tree.map(np.asarray, diag))
    return raw, states, diags


def test_tiny_drive_matches_jax(drive):
    raw, _, jdiags = drive
    run = todo.make_sequence_runner(TINY)
    _, tdiag = run(todo.init_state(TINY, "cpu"),
                   [port_scan(*r, TINY.max_raw_points, "cpu") for r in raw])
    jt = np.stack([d.pose.t for d in jdiags])
    assert np.abs(jt[-1]).max() > 0.01  # the estimate moves
    np.testing.assert_allclose(tdiag.pose.t.numpy(), jt, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tdiag.icp_iterations.numpy(),
                                  [d.icp_iterations for d in jdiags])
    np.testing.assert_array_equal(tdiag.map_voxels.numpy(), [d.map_voxels for d in jdiags])
    np.testing.assert_array_equal(tdiag.num_planar.numpy(), [d.num_planar for d in jdiags])
    assert not tdiag.diverged.any()


@pytest.mark.parametrize("at", [1, 5])
def test_one_step_from_carried_state(drive, at):
    raw, jstates, jdiags = drive
    state = state_from_numpy(jax.tree.map(np.asarray, jstates[at]), device="cpu")
    new, diag = todo.make_process_scan(TINY)(state, port_scan(*raw[at], TINY.max_raw_points, "cpu"))
    want = jstates[at + 1]
    for f in ("keys", "count", "origin"):
        np.testing.assert_array_equal(getattr(new.keyframe, f).numpy(),
                                      np.asarray(getattr(want.keyframe, f)))
    np.testing.assert_allclose(diag.pose.t.numpy(), jdiags[at].pose.t, atol=1e-5, rtol=0)
    np.testing.assert_allclose(diag.pose.q.numpy(), jdiags[at].pose.q, atol=1e-5, rtol=0)
    assert int(diag.icp_iterations) == int(jdiags[at].icp_iterations)
    assert int(diag.num_window_dropped) == int(jdiags[at].num_window_dropped)
    assert int(diag.num_downsample_dropped) == int(jdiags[at].num_downsample_dropped)


def test_state_round_trip(drive):
    _, jstates, _ = drive
    d = jax.tree.map(np.asarray, jstates[4])
    back = state_to_numpy(state_from_numpy(d, device="cpu"))
    for f in d.keyframe._fields:
        np.testing.assert_array_equal(getattr(back.keyframe, f), getattr(d.keyframe, f))
    for p in ("current", "previous"):
        np.testing.assert_array_equal(getattr(back, p).t, getattr(d, p).t)
        np.testing.assert_array_equal(getattr(back, p).q, getattr(d, p).q)


def test_lidar_odometry_wrapper_matches_jax(drive):
    raw, _, jdiags = drive
    odo = todo.LidarOdometry(TINY, keep_deskewed=True, device="cpu")
    for r in raw[:3]:
        diag = odo.process_cloud(*r)
    t, q = odo.get_current_pose()
    np.testing.assert_allclose(t, jdiags[2].pose.t, atol=1e-5, rtol=0)
    assert odo.get_keyframe_cloud().shape == (int(diag.map_voxels), 3)
    assert odo.get_full_keyframe_cloud().shape[0] >= int(diag.map_voxels)
    assert odo.get_temp_cloud().shape == (TINY.max_raw_points, 3)


def test_no_device_raises_without_cuda(monkeypatch):
    """Asking for nothing on a machine without CUDA raises; it does not run
    on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        todo.LidarOdometry(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        todo.init_state(TINY)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "lidar_odometry_demo_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lidar_odometry_demo_tpu"), (path, mod)
