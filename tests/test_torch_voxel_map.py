"""Port parity: voxel keys, downsample, neighbourhood search (K3's
neighbourhood lookup), the K1 re-match and map maintenance against the JAX
package (CPU).

Tolerances: keys, downsample, n_present and map_update's keys / count /
origin bitwise equal; base equal wherever n_present > 0 (elsewhere it only
addresses masked rows), and the lookup's present candidate rows and world
points bitwise; tab compared on live rows only, on the point and
normal lanes below count plus the count and anchor lanes (the other lanes
of a row may hold stale data by design). K1's plain version against the
Pallas kernel in interpret mode: index equal where valid, point and d2
within atol 1e-6. The exact search (find_correspondences) against the JAX
find_correspondences: valid equal, plane point and normal bitwise; against
the dict oracle within atol 1e-5, as tests/test_voxel_map.py holds the JAX
function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.io.simulator import sample_structured_cloud
from lidar_odometry_demo_tpu.ops import cloud as jcloud
from lidar_odometry_demo_tpu.ops import se3 as jse3
from lidar_odometry_demo_tpu.ops import voxel_map as jvm
from lidar_odometry_demo_tpu.oracle.reference_semantics import DictVoxelGrid
from lidar_odometry_demo_tpu.ops.pallas.correspondence import match_rows as pallas_match_rows
from lidar_odometry_demo_tpu_torch.kernels.correspondence import match_rows, match_rows_plain
from lidar_odometry_demo_tpu_torch.ops import cloud as tcloud
from lidar_odometry_demo_tpu_torch.ops import voxel_map as tvm


def _t(x):
    return torch.from_numpy(np.array(x))


def _pts(xyz, nrm, valid=None):
    valid = np.ones(xyz.shape[0], bool) if valid is None else valid
    return (jcloud.PointsWithNormals(jnp.asarray(xyz), jnp.asarray(nrm), jnp.asarray(valid)),
            tcloud.PointsWithNormals(_t(xyz), _t(nrm), _t(valid)))


def _to_port(jm) -> tvm.VoxelMap:
    return tvm.VoxelMap(*(_t(np.asarray(x)) for x in jm))


def _assert_maps_equal(jm, tm):
    keys, count = np.asarray(jm.keys), np.asarray(jm.count)
    np.testing.assert_array_equal(tm.keys.numpy(), keys)
    np.testing.assert_array_equal(tm.count.numpy(), count)
    np.testing.assert_array_equal(tm.origin.numpy(), np.asarray(jm.origin))
    K = jm.max_points
    RW, MB, _ = jvm._lanes(K)
    jt, tt = np.asarray(jm.tab), tm.tab.numpy()
    live = np.nonzero(keys != jvm.EMPTY_KEY)[0]
    for i in live:
        c = count[i]
        lanes = ([k + j * K for j in range(3) for k in range(c)]
                 + [RW + 3 * k + j for k in range(c) for j in range(3)]
                 + [3 * K, MB, MB + 1, MB + 2])
        np.testing.assert_array_equal(tt[i, lanes], jt[i, lanes], err_msg=f"row {i}")


def test_voxel_keys_bitwise(rng):
    n = 20000
    xyz = rng.uniform(-120, 120, (n, 3)).astype(np.float32)
    # values one ulp around voxel boundaries, where a reciprocal multiply
    # and a division disagree
    k = rng.integers(-600, 600, (n, 3))
    edge = (k * np.float32(0.2)).astype(np.float32)
    edge = np.nextafter(edge, np.where(rng.random(edge.shape) < 0.5, -np.inf, np.inf))
    xyz = np.concatenate([xyz, edge.astype(np.float32)])
    valid = rng.random(xyz.shape[0]) < 0.9
    origin = np.array([7, -3, 2], np.int32)
    for vs in (0.1, 0.2, 0.3):
        ji = jvm.voxel_indices(jnp.asarray(xyz), vs)
        ti = tvm.voxel_indices(_t(xyz), vs)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        for window in (False, True):
            jk = jvm.pack_keys(ji, jnp.asarray(origin), jnp.asarray(valid), map_window=window)
            tk = tvm.pack_keys(ti, _t(origin), _t(valid), map_window=window)
            assert tk.dtype == torch.int32
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    delta = np.array([3, -5, 1], np.int32)
    assert int(tvm._shift_key(_t(delta))) == int(jvm._shift_key(jnp.asarray(delta)))


@pytest.mark.parametrize("voxel_size,budget", [(0.3, 512), (0.1, 1024), (0.3, 64)])
def test_downsample_bitwise(rng, voxel_size, budget):
    n = 1500
    xyz = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    xyz[n // 2:] = xyz[: n // 2] + rng.normal(0, 0.02, (n - n // 2, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (n, 3)).astype(np.float32)
    jp, tp = _pts(xyz, nrm, rng.random(n) < 0.85)
    jo, jdrop = jvm.downsample(jp, voxel_size=voxel_size, budget=budget, with_overflow=True)
    to, tdrop = tvm.downsample(tp, voxel_size=voxel_size, budget=budget)
    for f in jo._fields:
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)))
    assert int(tdrop) == int(jdrop)
    if budget == 64:
        assert int(jdrop) > 0  # the overflow count is exercised


def _structured_map(seed, capacity=8192, n_per_plane=400):
    xyz, nrm = sample_structured_cloud(seed=seed, n_per_plane=n_per_plane)
    jp, _ = _pts(xyz, nrm)
    jm = jvm.map_insert(jvm.map_init(capacity, 20), jp, voxel_size=0.2)
    return xyz, jm, _to_port(jm)


def test_neighborhood_slots_match_jax(rng):
    xyz, jm, tm = _structured_map(seed=4)
    Q = 1024
    q = xyz[rng.integers(0, xyz.shape[0], Q)] + rng.normal(0, 0.15, (Q, 3)).astype(np.float32)
    q[:16] += 150.0                       # outside the map's column window
    q[16:32, 2] += rng.uniform(-30, 30, 16).astype(np.float32)  # beyond the z window
    valid = rng.random(Q) < 0.95
    jbase, jn = jvm._neighborhood_slots(jm, jvm.build_search_index(jm), jnp.asarray(q),
                                        jnp.asarray(valid), voxel_size=0.2)
    tbase, tn = tvm._neighborhood_slots(tm, _t(q), _t(valid), voxel_size=0.2)
    jn, jbase = np.asarray(jn), np.asarray(jbase)
    assert (jn == 3).sum() > 100 and (jn == 0).sum() > 16
    np.testing.assert_array_equal(tn.numpy(), jn)
    present = jn > 0
    np.testing.assert_array_equal(tbase.numpy()[present], jbase[present])


def _lookup_queries(rng, xyz, Q, R, t):
    """Local queries that the pose (R, t) maps near stored points, with some
    outside the map's column window, some beyond its z window and about 5 %
    invalid."""
    world = xyz[rng.integers(0, xyz.shape[0], Q)] + rng.normal(0, 0.15, (Q, 3))
    world[:16] += 150.0
    world[16:32, 2] += rng.uniform(-30, 30, 16)
    local = ((world.astype(np.float32) - t) @ R).astype(np.float32)
    return local, rng.random(Q) < 0.95


@pytest.mark.parametrize("turn", [0.0, 0.3])
def test_neighborhood_lookup_plain_matches_jax(rng, turn):
    """K3's neighbourhood lookup (plain version) against the JAX
    gather_candidates + _neighborhood_slots, at the identity and at a turned,
    shifted pose: n_present and present base equal, present rows bitwise."""
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.kernels.search import neighborhood_lookup_plain

    xyz, jm, tm = _structured_map(seed=4)
    Q, K = 1024, 20
    RW, _, _ = tvm._lanes(K)
    R = Rotation.from_euler("z", turn).as_matrix().astype(np.float32)
    t = np.array([turn, -2 * turn, 0.1 * turn], np.float32)
    q, qv = _lookup_queries(rng, xyz, Q, R, t)
    jcand = jvm.gather_candidates(jm, jvm.build_search_index(jm), jnp.asarray(q),
                                  jnp.asarray(qv), jnp.asarray(t), jnp.asarray(R),
                                  voxel_size=0.2)
    args = (tm.tab, tm.keys, tm.origin, _t(q), _t(qv), _t(t), _t(R))
    for fn in (neighborhood_lookup_plain, tvm.neighborhood_lookup):
        cand = fn(*args, voxel_size=0.2, row_width=RW)
        jn = np.asarray(jcand.n_present)
        assert (jn == 3).sum() > 100 and (jn == 0).sum() > 16
        np.testing.assert_array_equal(cand.n_present.numpy(), jn)
        present = jn > 0
        np.testing.assert_array_equal(cand.base.numpy()[present],
                                      np.asarray(jcand.base)[present])
        for s in range(3):
            live = jn.reshape(-1) > s
            np.testing.assert_array_equal(cand.rows_z[s].numpy()[live],
                                          np.asarray(jcand.rows_z[s])[live])


def test_query_world_matches_jax_bitwise(rng):
    """The lookup's world points are the JAX package's rot_pts(q, R) + t bit
    for bit (the voxel a point lands in depends on every bit), here on
    points a turned pose sends to within an ulp or so of voxel boundaries."""
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.kernels.search import query_world
    from lidar_odometry_demo_tpu_torch.ops.se3 import rot_pts

    R = Rotation.from_euler("xyz", [0.02, -0.03, 0.7]).as_matrix().astype(np.float32)
    t = np.array([3.1, -0.7, 0.25], np.float32)
    edges = (rng.integers(-400, 400, (4096, 3)) * np.float32(0.2)).astype(np.float32)
    q = np.concatenate([((edges - t) @ R).astype(np.float32),
                        rng.uniform(-60, 60, (4096, 3)).astype(np.float32)])
    got = query_world(_t(q), _t(R), _t(t)).numpy()
    want = np.asarray(jvm._rot_pts_exact(jnp.asarray(q), jnp.asarray(R)) + jnp.asarray(t))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got, (rot_pts(_t(q), _t(R)) + _t(t)).numpy())
    # and the voxel each lands in
    np.testing.assert_array_equal(tvm.voxel_indices(_t(got), 0.2).numpy(),
                                  np.asarray(jvm.voxel_indices(jnp.asarray(want), 0.2)))


def _candidate_rows(rng, Q, K):
    """Candidates in both layouts: JAX (Q, 9, 3*RW) triple rows and the
    port's three (9*Q, RW) column-major arrays."""
    RW, _, _ = jvm._lanes(K)
    q = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    pts = (q[:, None, None, None, :]
           + rng.normal(0, 0.25, (Q, 9, 3, K, 3))).astype(np.float32)
    cnt = rng.integers(0, K + 1, (Q, 9, 3))
    n_present = rng.integers(0, 4, (Q, 9)).astype(np.int32)
    rows = np.zeros((Q, 9, 3, RW), np.float32)
    for i in range(3):
        rows[..., i * K:(i + 1) * K] = pts[..., i]
    rows[..., 3 * K] = cnt
    rows_i = rows.view(np.int32)
    jax_rows = rows_i.reshape(Q, 9, 3 * RW)
    port_rows = tuple(_t(np.ascontiguousarray(rows_i[:, :, s].transpose(1, 0, 2)).reshape(9 * Q, RW))
                      for s in range(3))
    return q, jax_rows, n_present, port_rows


@pytest.mark.parametrize("far", [False, True])
def test_match_rows_plain_matches_pallas(rng, far):
    Q, K, max_d2 = 512, 20, 0.09
    q, jax_rows, n_present, port_rows = _candidate_rows(rng, Q, K)
    if far:
        q = q + 100.0  # no query has a valid candidate
    jo, ji, jd = pallas_match_rows(jnp.asarray(q), jnp.asarray(jax_rows), jnp.asarray(n_present),
                                   max_d2=max_d2, max_points=K, tile=128, interpret=True)
    to, ti, td = match_rows(_t(q), port_rows, _t(n_present.T.copy()),
                            max_d2=float(np.float32(max_d2)), max_points=K)
    jd = np.asarray(jd)
    valid = jd < np.float32(max_d2)
    if far:
        assert not valid.any() and np.all(td.numpy() == np.float32(max_d2))
        assert np.all(ti.numpy() == 0)
    else:
        assert valid.sum() > 50
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ti.numpy()[valid], np.asarray(ji)[valid])
    np.testing.assert_allclose(to.numpy()[valid], np.asarray(jo)[valid], atol=1e-6, rtol=0)


def test_match_candidates_on_real_map_match_jax(rng):
    xyz, jm, tm = _structured_map(seed=11)
    Q, K = 512, 20
    q = xyz[:Q] + rng.normal(0, 0.05, (Q, 3)).astype(np.float32)
    qv = np.ones(Q, bool)
    t0, R0 = np.zeros(3, np.float32), np.eye(3, dtype=np.float32)
    jidx = jvm.build_search_index(jm)
    jcand = jvm.gather_candidates(jm, jidx, jnp.asarray(q), jnp.asarray(qv),
                                  jnp.asarray(t0), jnp.asarray(R0), voxel_size=0.2)
    tcand = tvm.gather_candidates(tm, _t(q), _t(qv), _t(t0), _t(R0), voxel_size=0.2)
    RW = jcand.rows_z[0].shape[-1]
    legacy = jnp.concatenate(jcand.rows_z, axis=1).reshape(9, Q, 3 * RW).swapaxes(0, 1)
    jo, ji, jd = pallas_match_rows(jnp.asarray(q), legacy, jcand.n_present.T,
                                   max_d2=0.09, max_points=K, tile=128, interpret=True)
    to, ti, td = match_rows_plain(_t(q), tcand.rows_z, tcand.n_present,
                                  max_d2=float(np.float32(0.09)), max_points=K)
    valid = np.asarray(jd) < np.float32(0.09)
    assert valid.sum() > 400
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ti.numpy()[valid], np.asarray(ji)[valid])
    np.testing.assert_allclose(to.numpy()[valid], np.asarray(jo)[valid], atol=1e-6, rtol=0)

    # the whole correspondence, winner normal included
    jc = jvm.match_candidates(jm, jcand, jnp.asarray(q), jnp.asarray(qv), jnp.asarray(t0),
                              jnp.asarray(R0), max_distance=0.3)
    tc = tvm.match_candidates(tm, tcand, _t(q), _t(qv), _t(t0), _t(R0), max_distance=0.3,
                              nrm_view=tm.nrm)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    np.testing.assert_array_equal(tc.plane_origin.numpy(), np.asarray(jc.plane_origin))
    np.testing.assert_array_equal(tc.plane_normal.numpy(), np.asarray(jc.plane_normal))


@pytest.mark.parametrize("turn", [0.0, 0.05])
def test_match_correspondences_plain_matches_jax(rng, turn):
    """K1's pose-mode plain version (the fused kernel's reference) against
    the JAX match_candidates on a real map, at the identity and at a turned
    and shifted pose, with some queries invalid."""
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.kernels.correspondence import (
        match_correspondences_plain)

    xyz, jm, tm = _structured_map(seed=11)
    Q, K = 512, 20
    R = Rotation.from_euler("z", turn).as_matrix().astype(np.float32)
    t = np.array([turn, -turn / 2, 0.0], np.float32)
    # local points that the pose maps near stored points
    q = ((xyz[:Q] - t) @ R + rng.normal(0, 0.05, (Q, 3))).astype(np.float32)
    qv = rng.random(Q) < 0.9
    jcand = jvm.gather_candidates(jm, jvm.build_search_index(jm), jnp.asarray(q),
                                  jnp.asarray(qv), jnp.asarray(t), jnp.asarray(R),
                                  voxel_size=0.2)
    jc = jvm.match_candidates(jm, jcand, jnp.asarray(q), jnp.asarray(qv), jnp.asarray(t),
                              jnp.asarray(R), max_distance=0.3)
    tcand = tvm.gather_candidates(tm, _t(q), _t(qv), _t(t), _t(R), voxel_size=0.2)
    got = match_correspondences_plain(_t(q), _t(qv), _t(t), _t(R), tcand, tm.nrm,
                                      max_d2=float(np.float32(0.09)), max_points=K)
    valid = np.asarray(jc.valid)
    assert 350 < valid.sum() < Q
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.plane_origin.numpy()[valid],
                                  np.asarray(jc.plane_origin)[valid])
    np.testing.assert_array_equal(got.plane_normal.numpy()[valid],
                                  np.asarray(jc.plane_normal)[valid])
    assert not got.plane_origin.numpy()[~valid].any()
    assert not got.plane_normal.numpy()[~valid].any()


def test_fused_wrappers_refuse_non_cuda_devices():
    """K1's pose mode and K2's step launch the CUDA kernel or raise off the
    CPU; they never run the plain version on another device."""
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.kernels.correspondence import match_correspondences
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import gn_step
    from lidar_odometry_demo_tpu_torch.ops.se3 import Pose

    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    cand = tvm.CandidateSet(rows_z=tuple(torch.zeros((9 * 8, 64), **i32) for _ in range(3)),
                            base=torch.zeros((9, 8), **i32), n_present=torch.zeros((9, 8), **i32))
    v3 = torch.zeros((8, 3), **meta)
    valid = torch.zeros(8, dtype=torch.bool, **meta)
    tab = torch.zeros((64, 128), **i32)
    with pytest.raises(ValueError, match="CUDA"):
        match_correspondences(v3, valid, torch.zeros(3, **meta), torch.zeros((3, 3), **meta),
                              cand, tab, None, max_d2=0.09, max_points=20)
    pose = Pose(torch.zeros(3, **meta), torch.zeros(4, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        gn_step(tvm.Correspondence(v3, v3, v3, valid), pose, pose.t, OdometryConfig())


def _padded(xyz, nrm, capacity):
    """Points padded with invalid rows to `capacity`, in both frameworks."""
    n = xyz.shape[0]
    pad = np.zeros((capacity - n, 3), np.float32)
    valid = np.concatenate([np.ones(n, bool), np.zeros(capacity - n, bool)])
    return _pts(np.concatenate([xyz, pad]), np.concatenate([nrm, pad]), valid)


def _both_maps(xyz, nrm, capacity, K, voxel, pad_to):
    jp, tp = _padded(xyz, nrm, pad_to)
    jm = jvm.map_insert(jvm.map_init(capacity, K), jp, voxel_size=voxel)
    tm = tvm.map_insert(tvm.map_init(capacity, K, "cpu"), tp, voxel_size=voxel)
    _assert_maps_equal(jm, tm)
    return jm, tm


def _assert_corr_equal(tc, jc):
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    np.testing.assert_array_equal(tc.plane_origin.numpy(), np.asarray(jc.plane_origin))
    np.testing.assert_array_equal(tc.plane_normal.numpy(), np.asarray(jc.plane_normal))


def test_find_correspondences_matches_oracle_and_jax(rng):
    """Mirrors test_correspondence_matches_oracle (tests/test_voxel_map.py)."""
    voxel = 0.3
    stored = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    oracle = DictVoxelGrid(voxel, 5)
    oracle.add_cloud(stored, nrm)
    jm, tm = _both_maps(stored, nrm, 2048, 5, voxel, 512)

    queries = rng.uniform(-3.5, 3.5, (64, 3)).astype(np.float32)
    qv, t0, R0 = np.ones(64, bool), np.zeros(3, np.float32), np.eye(3, dtype=np.float32)
    tc = tvm.find_correspondences(tm, _t(queries), _t(qv), _t(t0), _t(R0),
                                  voxel_size=voxel, max_distance=0.3)
    jc = jvm.find_correspondences(jm, jnp.asarray(queries), jnp.asarray(qv), jnp.asarray(t0),
                                  jnp.asarray(R0), voxel_size=voxel, max_distance=0.3)
    _assert_corr_equal(tc, jc)
    n_valid = 0
    for i in range(64):
        expect = oracle.get_correspondence(queries[i], 0.3 * 0.3)
        assert bool(tc.valid[i]) == (expect is not None), i
        if expect is not None:
            n_valid += 1
            np.testing.assert_allclose(tc.plane_origin[i].numpy(), expect[0], atol=1e-5)
            np.testing.assert_allclose(tc.plane_normal[i].numpy(), expect[1], atol=1e-5)
    assert 0 < n_valid < 64


def test_find_correspondences_respects_pose(rng):
    """Mirrors test_correspondence_respects_pose: queries are transformed by
    the pose first (voxel_grid.h:217-223)."""
    voxel = 0.3
    stored = rng.uniform(-3, 3, (100, 3)).astype(np.float32)
    jm, tm = _both_maps(stored, np.zeros_like(stored), 1024, 3, voxel, 128)
    q = jse3.quat_from_axis_angle(jnp.asarray([0.0, 0, 1.0], jnp.float32), 0.3)
    t = np.array([0.5, -0.2, 0.1], np.float32)
    R = np.asarray(jse3.quat_to_matrix(q))
    local = ((stored - t) @ R).astype(np.float32)  # R^-1 (p - t): exact hits
    qv = np.ones(100, bool)
    tc = tvm.find_correspondences(tm, _t(local), _t(qv), _t(t), _t(R),
                                  voxel_size=voxel, max_distance=0.05)
    jc = jvm.find_correspondences(jm, jnp.asarray(local), jnp.asarray(qv), jnp.asarray(t),
                                  jnp.asarray(R), voxel_size=voxel, max_distance=0.05)
    _assert_corr_equal(tc, jc)
    valid = tc.valid.numpy()
    assert valid.mean() > 0.95
    err = np.linalg.norm(tc.plane_origin.numpy() - stored, axis=-1)
    assert np.all(err[valid] < 0.05)


def test_cached_candidates_match_find_correspondences(rng):
    """Mirrors test_cached_candidates_match_exact_search: the cache matched at
    its gather pose equals the exact search there, and nearly so a few mm
    away (the intra-ICP regime); the exact search equals the JAX one."""
    voxel = 0.3
    stored = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    jm, tm = _both_maps(stored, nrm, 2048, 5, voxel, 512)
    queries = rng.uniform(-3.5, 3.5, (128, 3)).astype(np.float32)
    qv = np.ones(128, bool)
    t = np.array([0.05, -0.02, 0.01], np.float32)
    R = np.eye(3, dtype=np.float32)
    args = (_t(queries), _t(qv))

    exact = tvm.find_correspondences(tm, *args, _t(t), _t(R), voxel_size=voxel,
                                     max_distance=0.3)
    cand = tvm.gather_candidates(tm, *args, _t(t), _t(R), voxel_size=voxel)
    cached = tvm.match_candidates(tm, cand, *args, _t(t), _t(R), max_distance=0.3,
                                  nrm_view=tm.nrm)
    for f in ("valid", "plane_origin", "plane_normal"):
        np.testing.assert_array_equal(getattr(exact, f).numpy(), getattr(cached, f).numpy())
    jidx = jvm.build_search_index(jm)
    _assert_corr_equal(exact, jvm.find_correspondences_indexed(
        jm, jidx, jnp.asarray(queries), jnp.asarray(qv), jnp.asarray(t), jnp.asarray(R),
        voxel_size=voxel, max_distance=0.3))

    t2 = t + np.array([0.004, -0.003, 0.002], np.float32)
    exact2 = tvm.find_correspondences(tm, *args, _t(t2), _t(R), voxel_size=voxel,
                                      max_distance=0.3)
    cached2 = tvm.match_candidates(tm, cand, *args, _t(t2), _t(R), max_distance=0.3,
                                   nrm_view=tm.nrm)
    assert np.mean(exact2.valid.numpy() == cached2.valid.numpy()) > 0.95
    _assert_corr_equal(exact2, jvm.find_correspondences_indexed(
        jm, jidx, jnp.asarray(queries), jnp.asarray(qv), jnp.asarray(t2), jnp.asarray(R),
        voxel_size=voxel, max_distance=0.3))


def test_kernel_wrappers_refuse_non_cuda_devices():
    """Off the CPU the wrappers launch the CUDA kernel or raise; they never
    run the plain version on another device."""
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import jtwj_accumulate
    from lidar_odometry_demo_tpu_torch.ops.se3 import Pose

    meta = dict(device="meta")
    rows = tuple(torch.zeros((9 * 8, 64), dtype=torch.int32, **meta) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        match_rows(torch.zeros((8, 3), **meta), rows,
                   torch.zeros((9, 8), dtype=torch.int32, **meta), max_d2=0.09, max_points=20)
    v3 = torch.zeros((8, 3), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        jtwj_accumulate(tvm.Correspondence(v3, v3, v3, torch.zeros(8, dtype=torch.bool, **meta)),
                        Pose(torch.zeros(3, **meta), torch.zeros(4, **meta)), huber_delta=0.15)


# --------------------------------------------------------------------------
# map maintenance
# --------------------------------------------------------------------------

def _update_sequence(rng, capacity, K, n_scans, n_pts, spread, step, radius):
    """Both frameworks through the same map_update sequence: a sensor
    moving along x (rebase), a small eviction radius (tombstones, reuse),
    dense repeats (capping at K) and a small table (overflow)."""
    jm, tm = jvm.map_init(capacity, K), tvm.map_init(capacity, K, "cpu")
    for s in range(n_scans):
        center = np.array([s * step, 0.3 * s, 0.0], np.float32)
        xyz = (center + rng.uniform(-spread, spread, (n_pts, 3))).astype(np.float32)
        xyz[: n_pts // 3] = xyz[n_pts // 3: 2 * (n_pts // 3)] + 0.01
        nrm = rng.normal(0, 1, (n_pts, 3)).astype(np.float32)
        jp, tp = _pts(xyz, nrm, rng.random(n_pts) < 0.9)
        jm = jvm.map_update(jm, jp, jnp.asarray(center), voxel_size=0.2, radius=radius)
        tm = tvm.map_update(tm, tp, _t(center), voxel_size=0.2, radius=radius)
        _assert_maps_equal(jm, tm)
    return jm, tm


@pytest.mark.parametrize("case", ["evict_rebase_cap", "overflow"])
def test_map_update_sequence_bitwise(rng, case):
    if case == "evict_rebase_cap":
        jm, _ = _update_sequence(rng, capacity=4096, K=4, n_scans=6, n_pts=600,
                                 spread=1.5, step=0.9, radius=2.0)
        assert np.asarray(jm.count).max() == 4  # capping exercised
    else:
        jm, _ = _update_sequence(rng, capacity=256, K=20, n_scans=3, n_pts=800,
                                 spread=4.0, step=0.5, radius=50.0)
        assert int(jvm.map_size(jm)) == 256  # saturated: the C smallest keys kept


def test_insert_cleanup_and_exports_match_jax(rng):
    xyz, jm, tm = _structured_map(seed=2, capacity=4096, n_per_plane=200)
    _assert_maps_equal(jm, tm)
    center = np.array([3.0, -1.0, 0.5], np.float32)
    jm = jvm.radius_cleanup(jm, jnp.asarray(center), radius=8.0, voxel_size=0.2)
    tm = tvm.radius_cleanup(tm, _t(center), radius=8.0, voxel_size=0.2)
    _assert_maps_equal(jm, tm)
    more = xyz[:300] + np.float32(0.05)
    jp, tp = _pts(more, np.ones_like(more))
    jm = jvm.map_insert(jm, jp, voxel_size=0.2)
    tm = tvm.map_insert(tm, tp, voxel_size=0.2)
    _assert_maps_equal(jm, tm)
    jc, tc = jvm.get_cloud(jm), tvm.get_cloud(tm)
    np.testing.assert_array_equal(tc[0], jc[0])
    np.testing.assert_array_equal(tc[1], jc[1])
    np.testing.assert_array_equal(tvm.get_sparse_cloud(tm), jvm.get_sparse_cloud(jm))
    assert int(tvm.map_size(tm)) == int(jvm.map_size(jm))
