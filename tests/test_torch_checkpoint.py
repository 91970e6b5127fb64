"""Port parity for the npz checkpoint (utils/checkpoint.py) against the JAX
package's (CPU): each package loads the other's files, both read the legacy
layouts (v1, v3, v4, v5) into equal states, and both reject the same
malformed files.

Tolerances: loaded leaves bitwise equal; one step resumed on each side from
the other's file gives poses within 1e-5 and equal map keys.
"""

import dataclasses

import jax
import numpy as np
import pytest

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.pipeline import odometry as jodo
from lidar_odometry_demo_tpu.utils import checkpoint as jckpt
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.convert import state_from_numpy, state_to_numpy
from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy as port_scan
from lidar_odometry_demo_tpu_torch.parallel import batched
from lidar_odometry_demo_tpu_torch.pipeline import odometry as todo
from lidar_odometry_demo_tpu_torch.utils import checkpoint as tckpt
from tests.test_checkpoint import _legacy_v45_npz


@pytest.fixture(scope="module")
def run():
    """Three TINY scans through the JAX step: the state after them, and the
    fourth scan."""
    d = simulate_sequence(num_scans=4, width=TINY.scan_width, seed=3, speed=2.0,
                          yaw_rate=0.05, ramp_time=0.0)
    raw = [(s["xyz"], s["intensity"], s["ring"], s["time"]) for s in d.scans]
    step = jax.jit(jodo.make_process_scan(JTINY))
    state = jodo.init_state(JTINY)
    for r in raw[:3]:
        state, _ = step(state, jax_scan(*r, JTINY.max_raw_points))
    return jax.tree.map(np.asarray, state), raw[3]


def _assert_same_state(a, b):
    """Two OdometryStates with numpy leaves, leaf for leaf bitwise."""
    for f in a.keyframe._fields:
        np.testing.assert_array_equal(getattr(a.keyframe, f), getattr(b.keyframe, f), err_msg=f)
    for p in ("current", "previous"):
        np.testing.assert_array_equal(getattr(a, p).t, getattr(b, p).t)
        np.testing.assert_array_equal(getattr(a, p).q, getattr(b, p).q)


def test_port_file_loads_in_jax_and_resumes(run, tmp_path):
    jstate, next_raw = run
    path = str(tmp_path / "port.npz")
    tckpt.save_npz(path, state_from_numpy(jstate, device="cpu"))
    loaded = jckpt.load_npz(path)
    _assert_same_state(jax.tree.map(np.asarray, loaded), jstate)
    # one step on the JAX side from the port's file, one on the port's side
    # from the state it saved
    _, jdiag = jax.jit(jodo.make_process_scan(JTINY))(loaded,
                                                      jax_scan(*next_raw, JTINY.max_raw_points))
    tnew, tdiag = todo.make_process_scan(TINY)(tckpt.load_npz(path, device="cpu"),
                                               port_scan(*next_raw, TINY.max_raw_points, "cpu"))
    np.testing.assert_allclose(tdiag.pose.t.numpy(), np.asarray(jdiag.pose.t), atol=1e-5, rtol=0)
    assert int(tdiag.icp_iterations) == int(jdiag.icp_iterations) > 0


def test_jax_file_loads_in_the_port_and_resumes(run, tmp_path):
    jstate, next_raw = run
    path = str(tmp_path / "jax.npz")
    jckpt.save_npz(path, jax.tree.map(np.asarray, jstate))
    loaded = tckpt.load_npz(path, device="cpu")
    _assert_same_state(state_to_numpy(loaded), jstate)
    jnew, jdiag = jax.jit(jodo.make_process_scan(JTINY))(
        jax.tree.map(np.asarray, jstate), jax_scan(*next_raw, JTINY.max_raw_points))
    tnew, tdiag = todo.make_process_scan(TINY)(loaded, port_scan(*next_raw, TINY.max_raw_points,
                                                                 "cpu"))
    np.testing.assert_allclose(tdiag.pose.t.numpy(), np.asarray(jdiag.pose.t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tdiag.pose.q.numpy(), np.asarray(jdiag.pose.q), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tnew.keyframe.keys.numpy(), np.asarray(jnew.keyframe.keys))


def test_batched_state_round_trips(tmp_path):
    state = batched.init_batched_state(TINY, 3, "cpu")
    path = str(tmp_path / "fleet.npz")
    tckpt.save_npz(path, state)
    back = tckpt.load_npz(path, device="cpu")
    assert back.keyframe.tab.shape == (3, TINY.map_capacity, 128)
    _assert_same_state(state_to_numpy(back), state_to_numpy(state))


def _v1(m, s):
    return {"keyframe.keys": m.keys, "keyframe.count": m.count,
            "keyframe.pts": np.ascontiguousarray(m.pts), "keyframe.nrm": m.nrm,
            "keyframe.origin": m.origin, "current.t": s.current.t, "current.q": s.current.q,
            "previous.t": s.previous.t, "previous.q": s.previous.q}


def _v3(m, s):
    """The round-3 136-lane table by its own lane math (tests/test_checkpoint.py)."""
    k, c = m.max_points, m.capacity
    align8 = lambda n: -(-n // 8) * 8  # noqa: E731
    rw = align8(3 * k + 1)
    mb_old = align8(rw + 3 * k)
    tab3 = np.zeros((c, align8(mb_old + 5)), np.int32)
    tab3[:, : 3 * k] = np.asarray(m.pts).reshape(c, 3 * k).view(np.int32)
    tab3[:, 3 * k] = m.count.astype(np.float32).view(np.int32)
    tab3[:, rw : rw + 3 * k] = np.asarray(m.nrm).reshape(c, 3 * k).view(np.int32)
    tab3[:, mb_old] = m.keys
    tab3[:, mb_old + 1] = m.count
    tab3[:, mb_old + 2 : mb_old + 5] = np.ascontiguousarray(m.anchor).view(np.int32)
    return {"keyframe.tab": tab3, "keyframe.origin": m.origin,
            "keyframe.kdim": np.zeros((1, k), np.int32), "current.t": s.current.t,
            "current.q": s.current.q, "previous.t": s.previous.t, "previous.q": s.previous.q,
            "format_version": np.int32(3)}


@pytest.fixture(scope="module")
def run_k7(run):
    """The state of three TINY scans through the JAX step at K = 7 points
    per voxel, whose legacy lane layouts (v4, v5) are narrower than the
    current one: the width branch of the port's `_legacy_lanes_v45` /
    `_migrate_v4`, never taken at K = 20."""
    cfg = dataclasses.replace(JTINY, keyframe_max_points_cnt=7)
    d = simulate_sequence(num_scans=3, width=TINY.scan_width, seed=3, speed=2.0,
                          yaw_rate=0.05, ramp_time=0.0)
    step = jax.jit(jodo.make_process_scan(cfg))
    state = jodo.init_state(cfg)
    for s in d.scans:
        state, _ = step(state, jax_scan(s["xyz"], s["intensity"], s["ring"], s["time"],
                                        JTINY.max_raw_points))
    return jax.tree.map(np.asarray, state), None


@pytest.mark.parametrize("k", [20, 7])
@pytest.mark.parametrize("version", ["v1", "v3", "v4", "v5"])
def test_legacy_files_migrate_equally(run, run_k7, tmp_path, version, k):
    """Both packages read a legacy file into the same state, and into the
    state it was written from, at K = 20 and at K = 7 points per voxel."""
    from lidar_odometry_demo_tpu.ops import voxel_map as jvm

    jstate = (run if k == 20 else run_k7)[0]
    assert jstate.keyframe.kdim.shape[-1] == k
    m = jvm.VoxelMap(*(jax.numpy.asarray(x) for x in jstate.keyframe))
    host = jvm.VoxelMap(*(np.asarray(x) for x in jstate.keyframe))
    fixture = {"v1": lambda: _v1(m, jstate), "v3": lambda: _v3(m, jstate),
               "v4": lambda: _legacy_v45_npz(m, jstate, planar=False),
               "v5": lambda: _legacy_v45_npz(m, jstate, planar=True)}[version]()
    path = str(tmp_path / f"{version}.npz")
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in fixture.items()})
    jloaded = jax.tree.map(np.asarray, jckpt.load_npz(path))
    tloaded = state_to_numpy(tckpt.load_npz(path, device="cpu"))
    _assert_same_state(tloaded, jloaded)
    for f in ("keys", "count", "origin"):
        np.testing.assert_array_equal(getattr(tloaded.keyframe, f), getattr(host, f))


def test_malformed_files_raise_in_both(run, tmp_path):
    jstate = run[0]
    path = str(tmp_path / "ok.npz")
    tckpt.save_npz(path, state_from_numpy(jstate, device="cpu"))
    z = dict(np.load(path))
    bad_version = dict(z, format_version=np.int32(99))
    truncated = dict(z, **{"keyframe.tab": z["keyframe.tab"][:, :-8]})
    for fields, match in ((bad_version, "unknown checkpoint format_version 99"),
                          (truncated, "table width 120 does not match")):
        p = str(tmp_path / "bad.npz")
        np.savez_compressed(p, **fields)
        for load in (jckpt.load_npz, lambda q: tckpt.load_npz(q, device="cpu")):
            with pytest.raises(ValueError, match=match):
                load(p)
    p = str(tmp_path / "empty.npz")
    np.savez_compressed(p, **{"current.t": np.zeros(3)})
    with pytest.raises(ValueError, match="unrecognized checkpoint layout"):
        tckpt.load_npz(p, device="cpu")
