"""Port parity for the whole slice: the per-scan step and a TINY drive
against the JAX package (CPU), state carried across frameworks, and the
port's guards.

Tolerances: one step from a carried-over state gives bitwise-equal map
keys, counts and origin and a pose within 1e-5; over an 8-scan TINY drive
the per-scan poses agree within 1e-4 m (the float32 differences of the two
libraries' transcendentals and reduction orders, compounded over scans)
with equal ICP iteration counts, under the default config and under
reference_parity(TINY). Under reference_parity the port also meets the
NumPy oracle with the config and bar of tests/test_oracle_equivalence.py
(per-scan translation within 0.05 m).
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.config import OdometryConfig as JConfig
from lidar_odometry_demo_tpu.config import reference_parity as jreference_parity
from lidar_odometry_demo_tpu.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.oracle.full_pipeline import OracleOdometry
from lidar_odometry_demo_tpu.pipeline import odometry as jodo
from lidar_odometry_demo_tpu_torch.config import TINY, OdometryConfig, reference_parity
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


def test_reference_parity_flags_reach_their_stages(drive, monkeypatch):
    """reference_parity() sets the four flags of the strict reference path,
    and each reaches its stage: the deskew gets the backwards translation,
    ICP is built from the same config (stall rounds, best-pose exit) and
    re-searches the map once per round and gathers no cache."""
    cfg = reference_parity(TINY)
    assert cfg.deskew_forward_translation is False
    assert cfg.icp_cached_candidates is False
    assert cfg.icp_stall_exit_rounds == cfg.icp_max_outer_iterations == 35
    assert cfg.icp_best_pose_exit is False
    calls = {"deskew": [], "align_cfg": [], "find": 0, "gather": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            if name == "deskew":
                calls[name].append(kw["forward_translation"])
            else:
                calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    make_align = todo.icp.make_align
    monkeypatch.setattr(todo.preprocess, "deskew", spy("deskew", todo.preprocess.deskew))
    monkeypatch.setattr(todo.icp, "make_align",
                        lambda c: calls["align_cfg"].append(c) or make_align(c))
    monkeypatch.setattr(todo.vm, "find_correspondences",
                        spy("find", todo.vm.find_correspondences))
    monkeypatch.setattr(todo.vm, "gather_candidates", spy("gather", todo.vm.gather_candidates))
    scans = [port_scan(*r, TINY.max_raw_points, "cpu") for r in drive[0][:4]]
    _, diag = todo.make_sequence_runner(cfg)(todo.init_state(cfg, "cpu"), scans)
    rounds = int(diag.icp_iterations.sum())
    assert rounds > 0
    assert calls["deskew"] == [False] * 4
    assert calls["align_cfg"] == [cfg]
    assert calls["find"] == calls["gather"] == rounds


def test_reference_parity_tiny_drive_matches_jax(drive):
    raw = drive[0]
    jcfg, tcfg = jreference_parity(JTINY), reference_parity(TINY)
    step = jax.jit(jodo.make_process_scan(jcfg))
    state = jodo.init_state(jcfg)
    jt, jiters = [], []
    for r in raw:
        state, diag = step(state, jax_scan(*r, JTINY.max_raw_points))
        jt.append(np.asarray(diag.pose.t))
        jiters.append(int(diag.icp_iterations))
    _, tdiag = todo.make_sequence_runner(tcfg)(
        todo.init_state(tcfg, "cpu"), [port_scan(*r, TINY.max_raw_points, "cpu") for r in raw])
    assert np.abs(jt[-1]).max() > 0.01
    np.testing.assert_allclose(tdiag.pose.t.numpy(), np.stack(jt), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tdiag.icp_iterations.numpy(), jiters)
    assert not tdiag.diverged.any()


# the config of tests/test_oracle_equivalence.py: budgets cover the worst case
ORACLE_CFG = dict(scan_width=450, max_raw_points=8192, max_planar_points=8192,
                  max_match_points=8192, max_update_points=8192, map_capacity=32768)


def test_reference_parity_matches_numpy_oracle():
    """The bar of test_strict_reference_parity_mode_matches_oracle, with the
    port in place of the JAX engine."""
    cfg = reference_parity(OdometryConfig(**ORACLE_CFG))
    d = simulate_sequence(num_scans=8, width=cfg.scan_width, seed=21, speed=2.0,
                          yaw_rate=0.05)
    odo = todo.LidarOdometry(cfg, device="cpu")
    oracle = OracleOdometry(jreference_parity(JConfig(**ORACLE_CFG)))
    port_traj, oracle_traj = [], []
    for s in d.scans:
        odo.process_cloud(s["xyz"], s["intensity"], s["ring"], s["time"])
        oracle.process(s["xyz"], s["ring"], s["time"])
        port_traj.append(odo.get_current_pose()[0])
        oracle_traj.append(oracle.current.t.copy())
    port_traj, oracle_traj = np.asarray(port_traj), np.asarray(oracle_traj)
    err = np.linalg.norm(port_traj - oracle_traj, axis=1)
    assert np.linalg.norm(port_traj[-1]) > 0.2
    assert err.max() < 0.05, (err, port_traj[-1], oracle_traj[-1])


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
