"""Port parity for the column-sharded keyframe map (parallel/spatial.py,
`map_update(origin_quantum=)` and the spatial hooks of ops/icp.py and
pipeline/odometry.py), against the JAX package on its 8-device CPU fabric
(tests/conftest.py).

The port's ranks run on gloo CPU process groups: one `run_ranks` call per
world size (2 and 4) runs every mode once (a module-scoped fixture), and
the JAX side runs in this process. TINY, 5 scans.

Bars (those of tests/test_spatial.py):
- the composite view's search, exact and from cached candidates, merged
  over the queries' owners, bitwise equal to the replicated map's search,
  field by field; the owned queries and the shards' voxels partition the
  replicated sets (N = 2, 4);
- the spatial pipeline: each shard's final keys, counts and origin equal
  to the JAX spatial runner's at the same N, the poses within 1e-5 (t) and
  1e-6 (q), iterations and matches equal; every rank's poses bitwise equal;
  within 1e-3 m of the port's single run; the shards really partition the
  map;
- dp = 2 x sp = 2 (4 ranks): each lane against the JAX batched spatial
  runner at the same mesh, as above, and bitwise the port's N = 2 run of
  the same drive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io.simulator import sample_structured_cloud, simulate_sequence
from lidar_odometry_demo_tpu.ops import voxel_map as jvm
from lidar_odometry_demo_tpu.ops.cloud import PointsWithNormals as JPoints
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.parallel import mesh as jmesh
from lidar_odometry_demo_tpu.parallel import spatial as jspatial
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, PointsWithNormals
from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy as port_scan
from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib
from lidar_odometry_demo_tpu_torch.parallel import spatial
from lidar_odometry_demo_tpu_torch.pipeline import odometry as todo

VSIZE = 0.2
CAP = 8192
N_SCANS = 5
DRIVE_SEEDS = (3, 17)
TIMEOUT = 300.0
CORR_FIELDS = ("valid", "plane_origin", "plane_normal")


def _cloud(seed=5, n=3000):
    rng = np.random.default_rng(seed)
    xyz, nrm = sample_structured_cloud(seed=seed, n_per_plane=n // 7)
    keep = rng.permutation(xyz.shape[0])[:n]
    return xyz[keep].astype(np.float32), nrm[keep].astype(np.float32)


def _queries(xyz, seed=9, q=512):
    rng = np.random.default_rng(seed)
    sel = rng.permutation(xyz.shape[0])[:q]
    return (xyz[sel] + rng.normal(0, 0.05, (q, 3))).astype(np.float32)


def _drives():
    out = []
    for seed in DRIVE_SEEDS:
        d = simulate_sequence(num_scans=N_SCANS, width=TINY.scan_width, seed=seed, speed=2.0,
                              yaw_rate=0.05)
        out.append([(s["xyz"], s["intensity"], s["ring"], s["time"]) for s in d.scans])
    return out


def _points(xyz, nrm):
    return PointsWithNormals(torch.from_numpy(xyz), torch.from_numpy(nrm),
                             torch.ones(xyz.shape[0], dtype=torch.bool))


def _poses():
    """The searches' poses: identity (both paths), and the cached path's
    candidates gathered there and matched at a pose 4 cm and 0.01 rad off."""
    c, s = np.cos(0.01), np.sin(0.01)
    R1 = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (torch.zeros(3), torch.eye(3)), (torch.tensor([0.04, -0.03, 0.01]),
                                            torch.from_numpy(R1))


def _searches(m, view, q, q_valid):
    """The exact search at identity and the cached path (gathered at
    identity, matched at the second pose) on `view` (m's nrm for both)."""
    (t0, R0), (t1, R1) = _poses()
    exact = tvm.find_correspondences(view, q, q_valid, t0, R0, voxel_size=VSIZE,
                                     max_distance=0.3)
    cand = tvm.gather_candidates(view, q, q_valid, t0, R0, voxel_size=VSIZE)
    cached = tvm.match_candidates(view, cand, q, q_valid, t1, R1, max_distance=0.3,
                                  nrm_view=view.nrm)
    return {"exact": {f: getattr(exact, f) for f in CORR_FIELDS},
            "cached": {f: getattr(cached, f) for f in CORR_FIELDS}}


def _spatial_ranks(n, cloud, queries, drives):
    """Every spatial mode of this module on one rank of an n-rank gloo group."""
    out = {}
    m = mesh_lib.make_mesh(1, n, "cpu")
    g = m.sp

    # the composite view's search against the replicated one (the caller's)
    pts = _points(*cloud)
    shard = tvm.map_init(CAP // n, 20, "cpu")
    own = spatial.owner_mask(pts.xyz, shard.origin, VSIZE, g)
    shard = tvm.map_update(shard, pts._replace(valid=pts.valid & own), torch.zeros(3),
                           voxel_size=VSIZE, radius=80.0, origin_quantum=n)
    view = spatial.build_halo_view(shard, g)
    q = torch.from_numpy(queries)
    q_own = spatial.owner_mask(q, shard.origin, VSIZE, g)
    out["search"] = dict(_searches(shard, view, q, q_own), q_own=q_own, keys=shard.keys,
                         view_rows=view.capacity, size=tvm.map_size(shard))

    # the spatial pipeline on drive 0
    run = spatial.make_spatial_sequence_runner(TINY, m)
    g.stats.reset()
    state, d = run(spatial.init_spatial_state(TINY, n, "cpu"),
                   [port_scan(*r, TINY.max_raw_points, "cpu") for r in drives[0]])
    out["pipe"] = dict(t=d.pose.t, q=d.pose.q, iters=d.icp_iterations, matches=d.num_matches,
                       map_voxels=d.map_voxels, keys=state.keyframe.keys,
                       count=state.keyframe.count, origin=state.keyframe.origin,
                       stats=g.stats.as_dict())

    if n == 4:  # dp = 2 x sp = 2: both drives, one lane per dp index
        bm = mesh_lib.make_mesh(2, 2, "cpu")
        per = [[port_scan(*r, TINY.max_raw_points, "cpu") for r in drive] for drive in drives]
        scans_b = LidarScan(*(torch.stack([torch.stack([getattr(lane[s], f) for lane in per])
                                           for s in range(N_SCANS)])
                              for f in LidarScan._fields))
        run_b = spatial.make_batched_spatial_sequence_runner(TINY, bm)
        state_b, d = run_b(spatial.init_batched_spatial_state(TINY, 1, 2, "cpu"), scans_b)
        out["dpsp"] = dict(dp_index=bm.dp_index, sp_index=bm.sp_index, t=d.pose.t, q=d.pose.q,
                           iters=d.icp_iterations, matches=d.num_matches,
                           keys=state_b.keyframe.keys, count=state_b.keyframe.count,
                           origin=state_b.keyframe.origin)
    return out


@pytest.fixture(scope="module")
def inputs():
    xyz, nrm = _cloud()
    return (xyz, nrm), _queries(xyz), _drives()


@pytest.fixture(scope="module")
def ranks(inputs):
    """{n: [rank 0's results, ...]} for n = 2 and 4 ranks."""
    cloud, queries, drives = inputs
    return {n: mesh_lib.run_ranks(_spatial_ranks, n, n, cloud, queries, drives,
                                  device="cpu", timeout=TIMEOUT) for n in (2, 4)}


def _jax_scans(raw):
    scans = [jax_scan(*r, JTINY.max_raw_points) for r in raw]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *scans)


@pytest.mark.parametrize("n", [2, 4])
def test_composite_search_is_the_replicated_search(ranks, inputs, n):
    (xyz, nrm), queries, _ = inputs
    outs = [o["search"] for o in ranks[n]]
    rep = tvm.map_update(tvm.map_init(CAP, 20, "cpu"), _points(xyz, nrm), torch.zeros(3),
                         voxel_size=VSIZE, radius=80.0, origin_quantum=n)
    want = _searches(rep, rep, torch.from_numpy(queries),
                     torch.ones(queries.shape[0], dtype=torch.bool))
    q_own = np.stack([o["q_own"] for o in outs])
    assert (q_own.sum(axis=0) == 1).all()  # every query owned exactly once
    # the shards' voxels partition the replicated map's
    live = [set(o["keys"][o["keys"] != tvm.EMPTY_KEY].tolist()) for o in outs]
    assert sum(len(s) for s in live) == len(set().union(*live))
    rep_keys = rep.keys.numpy()
    assert set().union(*live) == set(rep_keys[rep_keys != tvm.EMPTY_KEY].tolist())
    assert sum(int(o["size"]) for o in outs) == int(tvm.map_size(rep))
    # the composite holds the shard and its ring neighbours' (one at N = 2)
    assert all(o["view_rows"] == min(n, 3) * CAP // n for o in outs)
    owner, qi = np.argmax(q_own, axis=0), np.arange(queries.shape[0])
    for path in ("exact", "cached"):
        for f in CORR_FIELDS:
            got = np.stack([o[path][f] for o in outs])[owner, qi]
            np.testing.assert_array_equal(got, want[path][f].numpy(), err_msg=f"{path}.{f}")
        assert want[path]["valid"].sum() > 100


@pytest.mark.parametrize("n", [2, 4])
def test_origin_quantum_matches_jax(inputs, n):
    """map_update with origin_quantum=N against the JAX map_update, from a
    centre that is no multiple of N voxels: keys, counts and origin equal,
    the origin's x and y floored to multiples of N."""
    (xyz, nrm), _, _ = inputs
    center = np.array([3.5, -1.5, 0.5], np.float32)  # voxel (17, -7, 2)
    got = tvm.map_update(tvm.map_init(CAP, 20, "cpu"), _points(xyz, nrm),
                         torch.from_numpy(center), voxel_size=VSIZE, radius=80.0,
                         origin_quantum=n)
    want = jvm.map_update(jvm.map_init(CAP, 20), JPoints(jnp.asarray(xyz), jnp.asarray(nrm),
                                                         jnp.ones(xyz.shape[0], bool)),
                          jnp.asarray(center), voxel_size=VSIZE, radius=80.0, origin_quantum=n)
    for f in ("keys", "count", "origin"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.origin[0] % n == 0 and got.origin[1] % n == 0
    assert got.origin.tolist() != tvm.voxel_indices(torch.from_numpy(center), VSIZE).tolist()


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_pipeline_matches_jax_spatial(ranks, inputs, n):
    _, _, drives = inputs
    outs = [o["pipe"] for o in ranks[n]]
    for o in outs[1:]:  # every rank takes the same steps
        for f in ("t", "q", "iters", "matches", "map_voxels"):
            np.testing.assert_array_equal(o[f], outs[0][f], err_msg=f)
    p = outs[0]
    run = jspatial.make_spatial_sequence_runner(JTINY, jmesh.make_mesh(dp=1, sp=n), axis="sp")
    jfinal, jd = run(jspatial.init_spatial_state(JTINY, n), _jax_scans(drives[0]))
    np.testing.assert_allclose(p["t"], np.asarray(jd.pose.t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(p["q"], np.asarray(jd.pose.q), atol=1e-6, rtol=0)
    for f, jf in (("iters", "icp_iterations"), ("matches", "num_matches"),
                  ("map_voxels", "map_voxels")):
        np.testing.assert_array_equal(p[f], np.asarray(getattr(jd, jf)), err_msg=f)
    for f in ("keys", "count", "origin"):  # shard by shard
        np.testing.assert_array_equal(np.stack([o[f] for o in outs]),
                                      np.asarray(getattr(jfinal.keyframe, f)), err_msg=f)
    assert (p["iters"][1:] > 0).all() and p["matches"][-1] > 0
    # the shards really partition the map
    sizes = np.array([(o["keys"] != tvm.EMPTY_KEY).sum() for o in outs])
    assert sizes.sum() == p["map_voxels"][-1] > 100
    assert (sizes < TINY.map_capacity // n).all() and sizes.max() < sizes.sum()
    # one halo exchange per scan from each ring neighbour (one at N = 2)
    stats = p["stats"]
    assert stats["by_kind"]["ppermute"] == N_SCANS * min(n - 1, 2)
    # the port's single run
    single = todo.make_sequence_runner(TINY)(
        todo.init_state(TINY, "cpu"), [port_scan(*r, TINY.max_raw_points, "cpu")
                                       for r in drives[0]])[1]
    np.testing.assert_allclose(p["t"], single.pose.t.numpy(), atol=1e-3, rtol=0)


def test_dp2_sp2_spatial_matches_jax_and_the_n2_run(ranks, inputs):
    _, _, drives = inputs
    outs = [o["dpsp"] for o in ranks[4]]
    assert [(o["dp_index"], o["sp_index"]) for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    run = jspatial.make_batched_spatial_sequence_runner(JTINY, jmesh.make_mesh(dp=2, sp=2))
    scans = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=1),
                         *[_jax_scans(d) for d in drives])
    jfinal, jd = run(jspatial.init_batched_spatial_state(JTINY, dp=2, sp=2), scans)
    for r, o in enumerate(outs):
        lane, shard = divmod(r, 2)
        np.testing.assert_allclose(o["t"][:, 0], np.asarray(jd.pose.t)[:, lane], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(o["q"][:, 0], np.asarray(jd.pose.q)[:, lane], atol=1e-6,
                                   rtol=0)
        for f, jf in (("iters", "icp_iterations"), ("matches", "num_matches")):
            np.testing.assert_array_equal(o[f][:, 0], np.asarray(getattr(jd, jf))[:, lane],
                                          err_msg=f)
        for f in ("keys", "count", "origin"):
            np.testing.assert_array_equal(o[f][0],
                                          np.asarray(getattr(jfinal.keyframe, f))[lane, shard],
                                          err_msg=f)
    # lane 0 (drive 0) bitwise the port's unbatched N = 2 run of that drive
    n2 = [o["pipe"] for o in ranks[2]]
    for r in (0, 1):
        np.testing.assert_array_equal(outs[r]["t"][:, 0], n2[r]["t"])
        np.testing.assert_array_equal(outs[r]["q"][:, 0], n2[r]["q"])
        np.testing.assert_array_equal(outs[r]["keys"][0], n2[r]["keys"])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16])
def test_init_spatial_state_accepts_what_jax_accepts(n):
    try:
        jspatial.init_spatial_state(JTINY, n)
        jax_ok = True
    except AssertionError:
        jax_ok = False
    if jax_ok:
        s = spatial.init_spatial_state(TINY, n, "cpu")
        assert s.keyframe.capacity == TINY.map_capacity // n
    else:
        with pytest.raises(ValueError, match="16-divisible"):
            spatial.init_spatial_state(TINY, n, "cpu")


def test_sp_and_spatial_groups_are_exclusive():
    g = mesh_lib.make_mesh(1, 1, "cpu").sp
    with pytest.raises(ValueError, match="pick one"):
        todo.make_process_scan(TINY, sp_group=g, spatial_group=g)


def test_spatial_step_over_lanes_matches_jax(inputs):
    """Two lanes (both drives) through the batched spatial runner in one
    process (a mesh of one: one shard per lane) against the JAX batched
    spatial runner at dp = 2 x sp = 1: t within 1e-5, q within 1e-6,
    iterations, matches and the final shards equal. With more than one lane
    per rank, ICP's owner mask takes each lane's own guess pose
    (query_world over a lane axis)."""
    _, _, drives = inputs
    per = [[port_scan(*r, TINY.max_raw_points, "cpu") for r in drive] for drive in drives]
    scans_b = LidarScan(*(torch.stack([torch.stack([getattr(lane[s], f) for lane in per])
                                       for s in range(N_SCANS)]) for f in LidarScan._fields))
    run = spatial.make_batched_spatial_sequence_runner(TINY, mesh_lib.make_mesh(1, 1, "cpu"))
    state, d = run(spatial.init_batched_spatial_state(TINY, 2, 1, "cpu"), scans_b)
    jrun = jspatial.make_batched_spatial_sequence_runner(JTINY, jmesh.make_mesh(dp=2, sp=1))
    scans = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=1),
                         *[_jax_scans(drive) for drive in drives])
    jfinal, jd = jrun(jspatial.init_batched_spatial_state(JTINY, dp=2, sp=1), scans)
    np.testing.assert_allclose(d.pose.t.numpy(), np.asarray(jd.pose.t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(d.pose.q.numpy(), np.asarray(jd.pose.q), atol=1e-6, rtol=0)
    for f, jf in (("icp_iterations", "icp_iterations"), ("num_matches", "num_matches")):
        np.testing.assert_array_equal(getattr(d, f).numpy(), np.asarray(getattr(jd, jf)),
                                      err_msg=f)
    for f in ("keys", "count", "origin"):
        np.testing.assert_array_equal(getattr(state.keyframe, f).numpy(),
                                      np.asarray(getattr(jfinal.keyframe, f))[:, 0], err_msg=f)
