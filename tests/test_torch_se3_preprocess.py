"""Port parity: se3, cloud and preprocess against the JAX package (CPU).

Inputs are made with numpy from a seed and fed to both frameworks.
Tolerance: atol 1e-6 (float32 rounding of the same formulas; the two
libraries' transcendental functions differ in the last ulp). Point clouds
of tens of metres are held to 4 float32 ulps of their largest coordinate
(~1.5e-5 at 60 m): XLA contracts multiply-adds into FMAs where PyTorch's
CPU kernels round each step, and the cancellation in a rotation of a
60 m point leaves a few ulps of that magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.ops import cloud as jcloud
from lidar_odometry_demo_tpu.ops import preprocess as jpre
from lidar_odometry_demo_tpu.ops import se3 as jse3
from lidar_odometry_demo_tpu_torch.ops import cloud as tcloud
from lidar_odometry_demo_tpu_torch.ops import preprocess as tpre
from lidar_odometry_demo_tpu_torch.ops import se3 as tse3

ATOL = 1e-6


def _unit_quats(rng, n, scale=0.3):
    q = np.concatenate([np.ones((n, 1)), rng.normal(0, scale, (n, 3))], axis=1)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _poses(rng, n):
    t = rng.normal(0, 3, (n, 3)).astype(np.float32)
    q = _unit_quats(rng, n)
    return (jse3.Pose(jnp.asarray(t), jnp.asarray(q)),
            tse3.Pose(torch.from_numpy(t), torch.from_numpy(q)))


def _close(jx, tx):
    np.testing.assert_allclose(np.asarray(jx), tx.numpy(), atol=ATOL, rtol=0)


def _close_cloud(jx, tx):
    want = np.asarray(jx)
    atol = 4 * float(np.spacing(np.abs(want).max()))
    np.testing.assert_allclose(tx.numpy(), want, atol=atol, rtol=0)


SE3_CASES = ["compose", "inverse", "relative_to", "apply_delta", "se3_exp",
             "quat_slerp", "quat_to_matrix", "transform_points",
             "rotation_within_threshold"]


@pytest.mark.parametrize("op", SE3_CASES)
def test_se3_matches_jax(rng, op):
    n = 64
    (ja, ta), (jb, tb) = _poses(rng, n), _poses(rng, n)
    if op in ("compose", "relative_to"):
        jr, tr = getattr(jse3, op)(ja, jb), getattr(tse3, op)(ta, tb)
        _close(jr.t, tr.t), _close(jr.q, tr.q)
    elif op == "inverse":
        jr, tr = jse3.inverse(ja), tse3.inverse(ta)
        _close(jr.t, tr.t), _close(jr.q, tr.q)
    elif op in ("apply_delta", "se3_exp"):
        xi = rng.normal(0, 0.05, (n, 6)).astype(np.float32)
        xi[:4] *= 1e-7  # the small-angle branch
        if op == "se3_exp":
            jr, tr = jse3.se3_exp(jnp.asarray(xi)), tse3.se3_exp(torch.from_numpy(xi))
        else:
            jr = jse3.apply_delta(ja, jnp.asarray(xi))
            tr = tse3.apply_delta(ta, torch.from_numpy(xi))
        _close(jr.t, tr.t), _close(jr.q, tr.q)
    elif op == "quat_slerp":
        tt = rng.uniform(0, 1, n).astype(np.float32)
        qb = np.asarray(jb.q).copy()
        qb[:8] = np.asarray(ja.q)[:8]          # the aligned (lerp) branch
        qb[8:16] = -np.asarray(ja.q)[8:16]     # the shortest-path sign flip
        _close(jse3.quat_slerp(ja.q, jnp.asarray(qb), jnp.asarray(tt)),
               tse3.quat_slerp(ta.q, torch.from_numpy(qb), torch.from_numpy(tt)))
    elif op == "quat_to_matrix":
        _close(jse3.quat_to_matrix(ja.q), tse3.quat_to_matrix(ta.q))
    elif op == "transform_points":
        pts = rng.normal(0, 10, (n, 50, 3)).astype(np.float32)
        _close_cloud(jse3.transform_points(ja, jnp.asarray(pts)),
                     tse3.transform_points(ta, torch.from_numpy(pts)))
    else:
        qs = _unit_quats(rng, n, scale=0.08)
        qs[:4] = [[0.0, 1.0, 0.0, 0.0]] * 4  # 180 degrees: near-pi branch
        got = tse3.rotation_within_threshold(torch.from_numpy(qs), 5.0).numpy()
        want = np.asarray(jse3.rotation_within_threshold(jnp.asarray(qs), 5.0))
        assert want.any() and not want.all()
        np.testing.assert_array_equal(got, want)


def _scan(rng, n=700, capacity=1024, equal_times=False):
    xyz = rng.normal(0, 20, (n, 3)).astype(np.float32)
    inten = rng.uniform(0, 100, n).astype(np.float32)
    ring = rng.integers(0, 16, n).astype(np.int32)
    time = np.full(n, 0.03, np.float32) if equal_times else \
        rng.uniform(0.0, 0.1, n).astype(np.float32)
    args = (xyz, inten, ring, time, capacity)
    return jcloud.scan_from_numpy(*args), tcloud.scan_from_numpy(*args, device="cpu")


def test_scan_from_numpy_pads_like_jax(rng):
    js, ts = _scan(rng)
    for f in js._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy())
    assert int(ts.count()) == int(js.count()) == 700
    with pytest.raises(ValueError):
        tcloud.scan_from_numpy(*(np.zeros((5, 3)), np.zeros(5), np.zeros(5), np.zeros(5)),
                               capacity=4, device="cpu")


def test_compact_points_matches_jax(rng):
    n = 300
    xyz = rng.normal(0, 5, (n, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.4
    jp = jcloud.PointsWithNormals(jnp.asarray(xyz), jnp.asarray(nrm), jnp.asarray(valid))
    tp = tcloud.PointsWithNormals(torch.from_numpy(xyz), torch.from_numpy(nrm),
                                  torch.from_numpy(valid))
    for budget in (64, 200):
        jr, tr = jcloud.compact_points(jp, budget), tcloud.compact_points(tp, budget)
        for f in jr._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)), getattr(tr, f).numpy())


@pytest.mark.parametrize("equal_times", [False, True])
def test_time_normalize_matches_jax(rng, equal_times):
    js, ts = _scan(rng, equal_times=equal_times)
    _close(jpre.time_normalize(js).time, tpre.time_normalize(ts).time)


def test_range_filter_matches_jax(rng):
    js, ts = _scan(rng)
    jp = jcloud.PointsWithNormals(js.xyz, js.xyz, js.valid)
    tp = tcloud.PointsWithNormals(ts.xyz, ts.xyz, ts.valid)
    want = np.asarray(jpre.range_filter(jp, 4.0, 30.0).valid)
    assert 0 < want.sum() < 700
    np.testing.assert_array_equal(tpre.range_filter(tp, 4.0, 30.0).valid.numpy(), want)


@pytest.mark.parametrize("forward", [True, False])
def test_deskew_matches_jax(rng, forward):
    js, ts = _scan(rng)
    js, ts = jpre.time_normalize(js), tpre.time_normalize(ts)
    (j0, t0), (j1, t1) = _poses(rng, 1), _poses(rng, 1)
    j0, j1 = (jse3.Pose(p.t[0], p.q[0]) for p in (j0, j1))
    t0, t1 = (tse3.Pose(p.t[0], p.q[0]) for p in (t0, t1))
    _close_cloud(jpre.deskew(js, j0, j1, forward_translation=forward).xyz,
                 tpre.deskew(ts, t0, t1, forward_translation=forward).xyz)


def test_transform_with_normals_matches_jax(rng):
    n = 200
    xyz = rng.normal(0, 10, (n, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (n, 3)).astype(np.float32)
    jp = jcloud.PointsWithNormals(jnp.asarray(xyz), jnp.asarray(nrm), jnp.ones(n, bool))
    tp = tcloud.PointsWithNormals(torch.from_numpy(xyz), torch.from_numpy(nrm),
                                  torch.ones(n, dtype=torch.bool))
    (jpose, tpose) = _poses(rng, 1)
    jpose, tpose = jse3.Pose(jpose.t[0], jpose.q[0]), tse3.Pose(tpose.t[0], tpose.q[0])
    jr, tr = jpre.transform_with_normals(jp, jpose), tpre.transform_with_normals(tp, tpose)
    _close_cloud(jr.xyz, tr.xyz)
    _close(jr.normal, tr.normal)


def test_quat_log_round_trip_matches_jax(rng):
    """tests/test_se3.py's exp/log round trip (|w| < pi, atol 1e-4 to w),
    plus quaternions with w < 0 (the shortest-path flip) and the exact
    identity, against the JAX quat_log within 1e-6."""
    w = rng.normal(size=(64, 3))
    w = w / np.linalg.norm(w, axis=-1, keepdims=True) * rng.uniform(0, 3.0, (64, 1))
    w = w.astype(np.float32)
    q = tse3.quat_exp(torch.from_numpy(w))
    np.testing.assert_allclose(tse3.quat_log(q).numpy(), w, atol=1e-4, rtol=0)
    qs = np.concatenate([q.numpy(), -q.numpy()[:16], [[1.0, 0.0, 0.0, 0.0]],
                         [[-1.0, 0.0, 0.0, 0.0]]]).astype(np.float32)
    assert (qs[:, 0] < 0).sum() >= 16
    got = tse3.quat_log(torch.from_numpy(qs)).numpy()
    _close(jse3.quat_log(jnp.asarray(qs)), torch.from_numpy(got))
    np.testing.assert_allclose(got[64:80], w[:16], atol=1e-4, rtol=0)  # -q is the same rotation
    np.testing.assert_array_equal(got[-2:], 0.0)


def test_quat_log_small_angle_matches_jax():
    """tests/test_se3.py's small angles: exp then log returns w within 1e-9."""
    w = np.array([[0.0, 0.0, 0.0], [1e-8, 0, 0], [0, -1e-7, 0]], np.float32)
    q = tse3.quat_exp(torch.from_numpy(w))
    np.testing.assert_allclose(tse3.norm(q).numpy(), 1.0, atol=1e-6)
    got = tse3.quat_log(q)
    np.testing.assert_allclose(got.numpy(), w, atol=1e-9, rtol=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jse3.quat_log(jnp.asarray(q.numpy()))))


def test_quat_from_axis_angle_matches_jax(rng):
    axis = rng.normal(size=(32, 3))
    axis = (axis / np.linalg.norm(axis, axis=1, keepdims=True)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, 32).astype(np.float32)
    _close(jse3.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)),
           tse3.quat_from_axis_angle(torch.from_numpy(axis), torch.from_numpy(angle)))
    _close(jse3.quat_from_axis_angle(jnp.asarray(axis[0]), 0.7),
           tse3.quat_from_axis_angle(torch.from_numpy(axis[0]), 0.7))


def test_transform_scan_matches_jax(rng):
    xyz = rng.normal(0, 1, (300, 3)).astype(np.float32)
    args = (xyz, rng.uniform(0, 100, 300).astype(np.float32),
            rng.integers(0, 16, 300).astype(np.int32),
            rng.uniform(0.0, 0.1, 300).astype(np.float32), 512)
    js, ts = jcloud.scan_from_numpy(*args), tcloud.scan_from_numpy(*args, device="cpu")
    (jpose, tpose) = _poses(rng, 1)
    jpose, tpose = jse3.Pose(jpose.t[0], jpose.q[0]), tse3.Pose(tpose.t[0], tpose.q[0])
    jr, tr = jpre.transform_scan(js, jpose), tpre.transform_scan(ts, tpose)
    _close(jr.xyz, tr.xyz)
    for f in ("intensity", "ring", "time", "valid"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)))
