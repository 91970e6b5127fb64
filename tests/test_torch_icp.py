"""Port parity: the 6x6 solve, the K2 normal equations and the ICP outer
loop against the JAX package (CPU).

Tolerances: solve_spd_6x6 rtol 1e-5 (the same unrolled float32 Cholesky);
K2's plain version against the Pallas kernel in interpret mode rtol 2e-5,
atol 1e-4; make_align t within atol 1e-5, q within 1e-6, equal iteration
counts.
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
from lidar_odometry_demo_tpu_torch.kernels.jtwj import jtwj_accumulate
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
        got = ticp.solve_spd_6x6(_t(H), _t(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got, np.linalg.solve(H.astype(np.float64), b), rtol=1e-4)


def test_jtwj_plain_matches_pallas(rng):
    sl, po, pn, valid, R, t = _system(rng, 2048)
    jH, jb = pallas_jtwj(*(jnp.asarray(a) for a in (sl, po, pn, valid, R, t)),
                         huber_delta=0.15, tile=512, interpret=True)
    tH, tb = jtwj_accumulate(*(_t(a) for a in (sl, po, pn, valid, R, t)), huber_delta=0.15)
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
    tH, tb = ticp._normal_equations(tcorr, tse3.Pose(_t(t), _t(q)), _t(guess_t), TINY)
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
