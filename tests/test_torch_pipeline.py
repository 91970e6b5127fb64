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


# ROADMAP Queue C: seed 0 under reference_parity(TINY) (C2) and seed 1 under
# the default TINY (C3), each on a 5-scan drive
def _seed_drive(seed):
    d = simulate_sequence(num_scans=5, width=TINY.scan_width, seed=seed, speed=2.0,
                          yaw_rate=0.05, ramp_time=0.0)
    return [(s["xyz"], s["intensity"], s["ring"], s["time"]) for s in d.scans]


def _jax_steps(cfg, raw, lanes=False):
    """The JAX step over the drive (under jax.vmap at B = 1 with `lanes`):
    every carried state and every scan's diagnostics, as numpy."""
    step = jodo.make_process_scan(cfg)
    state = jodo.init_state(cfg)
    if lanes:
        step = jax.vmap(step)
        state = jax.tree.map(lambda x: x[None], state)
    step = jax.jit(step)
    states, diags = [jax.tree.map(np.asarray, state)], []
    for r in raw:
        scan = jax_scan(*r, JTINY.max_raw_points)
        if lanes:
            scan = jax.tree.map(lambda x: x[None], scan)
        state, diag = step(state, scan)
        if lanes:
            state_np = jax.tree.map(lambda x: np.asarray(x)[0], state)
            diag = jax.tree.map(lambda x: np.asarray(x)[0], diag)
        else:
            state_np = jax.tree.map(np.asarray, state)
        states.append(state_np)
        diags.append(jax.tree.map(np.asarray, diag))
    return states, diags


@pytest.fixture(scope="module")
def seed0_parity():
    """C2's drive: seed 0 through the JAX step under reference_parity(TINY)."""
    raw = _seed_drive(0)
    return raw, *_jax_steps(jreference_parity(JTINY), raw)


def test_c2_one_step_from_jax_state_is_exact(seed0_parity):
    """C2, the op half: started from JAX's own carried state, the port's step
    on scan 4 gives JAX's keys, counts and origin exactly (the counts that
    differ on the chained drive below come from the carried pose alone)."""
    raw, jstates, jdiags = seed0_parity
    state = state_from_numpy(jstates[4], device="cpu")
    new, diag = todo.make_process_scan(reference_parity(TINY))(
        state, port_scan(*raw[4], TINY.max_raw_points, "cpu"))
    for f in ("keys", "count", "origin"):
        np.testing.assert_array_equal(getattr(new.keyframe, f).numpy(),
                                      getattr(jstates[5].keyframe, f))
    np.testing.assert_allclose(diag.pose.t.numpy(), jdiags[4].pose.t, atol=1e-5, rtol=0)
    np.testing.assert_allclose(diag.pose.q.numpy(), jdiags[4].pose.q, atol=1e-5, rtol=0)
    assert int(diag.icp_iterations) == int(jdiags[4].icp_iterations)


def _counts_moved_between_adjacent_slots(got, want):
    """Where the counts differ, they differ by one point that moved between
    two adjacent slots: pairs (s, s + 1) with differences +-1 and -+1."""
    d = got.astype(np.int64) - want.astype(np.int64)
    idx = list(np.nonzero(d)[0])
    while idx:
        s = idx.pop(0)
        if not idx or idx[0] != s + 1 or abs(d[s]) != 1 or d[s] + d[s + 1] != 0:
            return False
        idx.pop(0)
    return True


def test_c2_chained_drive_within_carried_pose_ulps(seed0_parity):
    """C2, the chained half: the 5-scan drive from the empty map. Poses
    within 1e-6 (t and q), keys equal, iterations and matches equal; the
    counts may differ only by a point moving between two adjacent slots
    with an unchanged sum (a pose 1e-7 m from JAX's moves a boundary point
    into the neighbouring voxel)."""
    raw, jstates, jdiags = seed0_parity
    step = todo.make_process_scan(reference_parity(TINY))
    state = todo.init_state(reference_parity(TINY), "cpu")
    for k, r in enumerate(raw):
        state, diag = step(state, port_scan(*r, TINY.max_raw_points, "cpu"))
        np.testing.assert_allclose(diag.pose.t.numpy(), jdiags[k].pose.t, atol=1e-6, rtol=0)
        np.testing.assert_allclose(diag.pose.q.numpy(), jdiags[k].pose.q, atol=1e-6, rtol=0)
        assert int(diag.icp_iterations) == int(jdiags[k].icp_iterations)
        assert int(diag.num_matches) == int(jdiags[k].num_matches)
        want = jstates[k + 1].keyframe
        np.testing.assert_array_equal(state.keyframe.keys.numpy(), want.keys)
        assert _counts_moved_between_adjacent_slots(state.keyframe.count.numpy(), want.count), k
    assert not np.array_equal(state.keyframe.count.numpy(), jstates[5].keyframe.count)


def test_c3_ill_conditioned_drive_within_jax_own_spread():
    """C3: seed 1 under TINY sees [0, 508, 1, 0, 0] matches, so the rotation
    is held by the damping alone. The port's q stays within the JAX step's
    own spread between its single and its vmapped run (+ 1e-6); matches
    and iterations equal, t within 1e-5."""
    raw = _seed_drive(1)
    _, single = _jax_steps(JTINY, raw)
    _, vmapped = _jax_steps(JTINY, raw, lanes=True)
    _, tdiag = todo.make_sequence_runner(TINY)(
        todo.init_state(TINY, "cpu"), [port_scan(*r, TINY.max_raw_points, "cpu") for r in raw])
    assert [int(d.num_matches) for d in single] == [0, 508, 1, 0, 0]
    for k in range(len(raw)):
        for ref in (single[k], vmapped[k]):
            assert int(tdiag.num_matches[k]) == int(ref.num_matches)
            assert int(tdiag.icp_iterations[k]) == int(ref.icp_iterations)
        np.testing.assert_allclose(tdiag.pose.t[k].numpy(), single[k].pose.t, atol=1e-5, rtol=0)
        port_dq = np.abs(tdiag.pose.q[k].numpy() - single[k].pose.q).max()
        jax_dq = np.abs(vmapped[k].pose.q - single[k].pose.q).max()
        assert port_dq <= jax_dq + 1e-6, (k, port_dq, jax_dq)


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
    names = {str(p.relative_to(REPO)) for p in files}
    for mod in ("io/native.py", "io/live.py", "io/real_world.py", "parallel/pose_graph.py"):
        assert f"lidar_odometry_demo_tpu_torch/{mod}" in names, mod
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lidar_odometry_demo_tpu"), (path, mod)
