"""Port parity: the 6x6 solve, the K2 normal equations and the ICP outer
loop against the JAX package (CPU).

Tolerances: solve_spd_6x6 rtol 1e-5 (the same unrolled float32 Cholesky);
K2's plain version against the Pallas kernel in interpret mode rtol 2e-5,
atol 1e-4; K2's plain Gauss-Newton step over four steps against the JAX
_gn_steps and make_align: t within atol 1e-5, q within 1e-6 (each step's
norm rtol 1e-5, atol 1e-7 for the last steps' rounding-level norms), equal
iteration counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io.simulator import sample_structured_cloud
from lidar_odometry_demo_tpu.ops import cloud as jcloud
from lidar_odometry_demo_tpu.ops import icp as jicp
from lidar_odometry_demo_tpu.ops import se3 as jse3
from lidar_odometry_demo_tpu.ops import voxel_map as jvm
from lidar_odometry_demo_tpu.ops.pallas.jtwj import jtwj_accumulate as pallas_jtwj
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.kernels.jtwj import (
    GnWork, add_prior, gn_step, gn_step_plain, jtwj_accumulate, jtwj_plain, prior_weight,
    solve_spd_6x6)
from lidar_odometry_demo_tpu_torch.ops import icp as ticp
from lidar_odometry_demo_tpu_torch.ops import se3 as tse3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as tvm


def _t(x):
    return torch.from_numpy(np.array(x))


def _system(rng, Q):
    sl = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    pn = rng.normal(0, 1, (Q, 3)).astype(np.float32)
    pn /= np.linalg.norm(pn, axis=1, keepdims=True)
    R = Rotation.from_euler("xyz", [0.02, -0.01, 0.3]).as_matrix().astype(np.float32)
    t = np.array([1.5, -0.2, 0.1], np.float32)
    po = (sl @ R.T + t + rng.normal(0, 0.03, (Q, 3))).astype(np.float32)
    valid = rng.random(Q) < 0.8
    return sl, po, pn, valid, R, t


def test_solve_spd_6x6_matches_jax(rng):
    for _ in range(5):
        A = rng.normal(0, 1, (6, 6)).astype(np.float32)
        H = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
        b = rng.normal(0, 1, 6).astype(np.float32)
        want = np.asarray(jicp.solve_spd_6x6(jnp.asarray(H), jnp.asarray(b)))
        got = solve_spd_6x6(_t(H), _t(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got, np.linalg.solve(H.astype(np.float64), b), rtol=1e-4)


def test_jtwj_plain_matches_pallas(rng):
    sl, po, pn, valid, R, t = _system(rng, 2048)
    jH, jb = pallas_jtwj(*(jnp.asarray(a) for a in (sl, po, pn, valid, R, t)),
                         huber_delta=0.15, tile=512, interpret=True)
    tH, tb = jtwj_plain(*(_t(a) for a in (sl, po, pn, valid, R, t)), huber_delta=0.15)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=2e-5, atol=1e-4)


def test_normal_equations_with_prior_match_jax(rng):
    Q = 512
    sl, po, pn, valid, R, t = _system(rng, Q)
    q = Rotation.from_matrix(R.astype(np.float64)).as_quat()[[3, 0, 1, 2]].astype(np.float32)
    guess_t = t + np.float32(0.05)
    jcorr = jvm.Correspondence(*(jnp.asarray(a) for a in (sl, po, pn, valid)))
    tcorr = tvm.Correspondence(*(_t(a) for a in (sl, po, pn, valid)))
    jH, jb = jicp._normal_equations(jcorr, jse3.Pose(jnp.asarray(t), jnp.asarray(q)),
                                    jnp.asarray(guess_t), JTINY)
    tH, tb = add_prior(*jtwj_accumulate(tcorr, tse3.Pose(_t(t), _t(q)),
                                        huber_delta=TINY.icp_huber_delta),
                       _t(t), _t(guess_t), prior_weight(TINY))
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("seed,offset", [(11, 0.0), (5, 0.08), (5, 0.2), (7, 0.3)])
def test_make_align_matches_jax(rng, seed, offset, cached):
    """The setup of test_icp_pallas_jtwj_flag_matches_xla, and variants
    started 8, 20 and 30 cm off, with the candidates cached once at the
    guess pose and (cached=False, the reference_parity() mode) re-searched
    at the current pose every round."""
    xyz, nrm = sample_structured_cloud(seed=seed, n_per_plane=400)
    jp = jcloud.PointsWithNormals(jnp.asarray(xyz), jnp.asarray(nrm),
                                  jnp.ones(xyz.shape[0], bool))
    jm = jvm.map_insert(jvm.map_init(8192, 20), jp, voxel_size=0.2)
    tm = tvm.VoxelMap(*(_t(np.asarray(x)) for x in jm))
    n_q = TINY.max_match_points
    q = xyz[:n_q] + rng.normal(0, 0.02, (n_q, 3)).astype(np.float32)
    qv = np.ones(n_q, bool)
    gt = np.array([offset, -offset / 2, 0.0], np.float32)
    gq = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    jcfg = JTINY.replace(icp_cached_candidates=cached)
    tcfg = TINY.replace(icp_cached_candidates=cached)
    jres = jicp.make_align(jcfg)(jm, jnp.asarray(q), jnp.asarray(qv),
                                 jse3.Pose(jnp.asarray(gt), jnp.asarray(gq)))
    tres = ticp.make_align(tcfg)(tm, _t(q), _t(qv), tse3.Pose(_t(gt), _t(gq)))
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.num_matches) == int(jres.num_matches)
    np.testing.assert_allclose(tres.pose.t.numpy(), np.asarray(jres.pose.t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tres.pose.q.numpy(), np.asarray(jres.pose.q), atol=1e-6, rtol=0)


def _align_setup(rng, seed, offset):
    """The map, queries and guess of test_make_align_matches_jax."""
    xyz, nrm = sample_structured_cloud(seed=seed, n_per_plane=400)
    jp = jcloud.PointsWithNormals(jnp.asarray(xyz), jnp.asarray(nrm),
                                  jnp.ones(xyz.shape[0], bool))
    jm = jvm.map_insert(jvm.map_init(8192, 20), jp, voxel_size=0.2)
    n_q = TINY.max_match_points
    q = xyz[:n_q] + rng.normal(0, 0.02, (n_q, 3)).astype(np.float32)
    gt = np.array([offset, -offset / 2, 0.0], np.float32)
    gq = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    return jm, q, np.ones(n_q, bool), gt, gq


@pytest.mark.parametrize("seed,offset", [(11, 0.0), (5, 0.08), (7, 0.3)])
def test_gn_step_plain_matches_jax_gn_steps(rng, seed, offset):
    """Four of K2's plain steps against the JAX _gn_steps on the
    correspondences of the guess pose (the setup of
    test_make_align_matches_jax)."""
    jm, q, qv, gt, gq = _align_setup(rng, seed, offset)
    jc = jvm.find_correspondences(jm, jnp.asarray(q), jnp.asarray(qv), jnp.asarray(gt),
                                  jse3.quat_to_matrix(jnp.asarray(gq)), voxel_size=0.2,
                                  max_distance=TINY.icp_max_correspondence_distance)
    assert int(np.sum(np.asarray(jc.valid))) > 100
    guess_t = jnp.asarray(gt + np.float32(0.01))  # the prior pulls: exercise it
    jpose0 = jse3.Pose(jnp.asarray(gt), jnp.asarray(gq))
    jpose, _ = jicp._gn_steps(jc, jpose0, guess_t, JTINY)
    # each step's norm, one JAX step at a time from the JAX pose
    one = JTINY.replace(icp_inner_iterations=1)
    jnorms, jp = [], jpose0
    for _ in range(TINY.icp_inner_iterations):
        jp, n = jicp._gn_steps(jc, jp, guess_t, one)
        jnorms.append(float(n))
    tcorr = tvm.Correspondence(*(_t(np.asarray(x)) for x in jc))
    pose, norms = tse3.Pose(_t(gt), _t(gq)), []
    for _ in range(TINY.icp_inner_iterations):
        pose, norm, _, _ = gn_step_plain(tcorr, pose, _t(np.asarray(guess_t)), TINY)
        norms.append(float(norm))
    np.testing.assert_allclose(pose.t.numpy(), np.asarray(jpose.t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pose.q.numpy(), np.asarray(jpose.q), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pose.t.numpy(), np.asarray(jp.t), atol=1e-5, rtol=0)
    # the last steps' norms sit at float32 rounding of the pose: atol 1e-7
    np.testing.assert_allclose(norms, jnorms, rtol=1e-5, atol=1e-7)
    assert norms[0] > 1e-4 or offset == 0.0  # the first step moves the pose


def test_gn_steps_on_cpu_are_the_plain_steps(rng):
    """On CPU tensors _gn_steps and the K2 wrapper run the plain step, bit
    for bit, and its H and b are the normal equations before the prior."""
    sl, po, pn, valid, R, t = _system(rng, 512)
    q = Rotation.from_matrix(R.astype(np.float64)).as_quat()[[3, 0, 1, 2]].astype(np.float32)
    corr = tvm.Correspondence(*(_t(a) for a in (sl, po, pn, valid)))
    pose0 = tse3.Pose(_t(t), _t(q))
    guess_t = _t(t + np.float32(0.05))
    pose, norm = ticp._gn_steps(corr, pose0, guess_t, TINY)
    want = pose0
    for _ in range(TINY.icp_inner_iterations):
        want, want_norm, H, b = gn_step_plain(corr, want, guess_t, TINY)
    assert torch.equal(pose.t, want.t) and torch.equal(pose.q, want.q)
    assert torch.equal(norm, want_norm)
    got = gn_step(corr, pose0, guess_t, TINY, work=GnWork.empty(1, "cpu"))
    ref = gn_step_plain(corr, pose0, guess_t, TINY)
    for x, y in zip(got[2:], ref[2:]):
        assert torch.equal(x, y)
    H0, b0 = jtwj_accumulate(corr, pose0, huber_delta=TINY.icp_huber_delta)
    assert torch.equal(got[2], H0) and torch.equal(got[3], b0)


def test_align_matches_jax_and_caches_per_config(rng, monkeypatch):
    """icp.align (make_align built once per config) on a TINY map against
    the JAX align: t within 1e-5, q within 1e-6, equal iterations and
    matches; two configs give two cache entries, a repeat none."""
    jm, q, qv, gt, gq = _align_setup(rng, 5, 0.08)
    tm = tvm.VoxelMap(*(_t(np.asarray(x)) for x in jm))
    monkeypatch.setattr(ticp, "_ALIGN_CACHE", {})
    for cached in (True, False):
        jcfg = JTINY.replace(icp_cached_candidates=cached)
        tcfg = TINY.replace(icp_cached_candidates=cached)
        jres = jicp.align(jm, jnp.asarray(q), jnp.asarray(qv),
                          jse3.Pose(jnp.asarray(gt), jnp.asarray(gq)), jcfg)
        tres = ticp.align(tm, _t(q), _t(qv), tse3.Pose(_t(gt), _t(gq)), tcfg)
        assert int(tres.iterations) == int(jres.iterations)
        assert int(tres.num_matches) == int(jres.num_matches)
        np.testing.assert_allclose(tres.pose.t.numpy(), np.asarray(jres.pose.t), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tres.pose.q.numpy(), np.asarray(jres.pose.q), atol=1e-6, rtol=0)
    assert len(ticp._ALIGN_CACHE) == 2
    fn = ticp._cached_align(TINY)
    ticp.align(tm, _t(q), _t(qv), tse3.Pose(_t(gt), _t(gq)), TINY)
    assert len(ticp._ALIGN_CACHE) == 2 and ticp._cached_align(TINY) is fn
