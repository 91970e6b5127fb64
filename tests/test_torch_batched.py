"""Port parity for the batched multi-sequence path: `align` over a lane axis
against `jax.vmap` of the JAX align, the batched sequence runner and one
batched step from a mixed state against the JAX package's (CPU), and the
kernels' plain versions and wrappers over a lane axis.

Tolerances: per lane and per scan, t within 1e-5 and q within 1e-6 of the
JAX package, ICP iterations and matches equal, and at the end the map's
keys, counts and origin equal; lanes with the same inputs bitwise equal to
each other, and each lane within the same tolerance of the port's
single-sequence runner. The kernels' plain versions at B = 3 are bitwise
their B = 1 calls lane by lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.config import reference_parity as jreference_parity
from lidar_odometry_demo_tpu.io.simulator import sample_structured_cloud, simulate_sequence
from lidar_odometry_demo_tpu.ops import cloud as jcloud
from lidar_odometry_demo_tpu.ops import icp as jicp
from lidar_odometry_demo_tpu.ops import se3 as jse3
from lidar_odometry_demo_tpu.ops import voxel_map as jvm
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.parallel import batched as jbatched
from lidar_odometry_demo_tpu.parallel import mesh as jmesh
from lidar_odometry_demo_tpu.pipeline import odometry as jodo
from lidar_odometry_demo_tpu_torch.config import TINY, reference_parity
from lidar_odometry_demo_tpu_torch.convert import state_from_numpy
from lidar_odometry_demo_tpu_torch.kernels._build import lanes
from lidar_odometry_demo_tpu_torch.kernels.correspondence import (
    match_correspondences, match_correspondences_plain)
from lidar_odometry_demo_tpu_torch.kernels.jtwj import gn_step
from lidar_odometry_demo_tpu_torch.kernels.search import (
    CandidateSet, group_lookup, neighborhood_lookup)
from lidar_odometry_demo_tpu_torch.ops import icp as ticp
from lidar_odometry_demo_tpu_torch.ops import se3 as tse3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy as port_scan
from lidar_odometry_demo_tpu_torch.parallel import batched
from lidar_odometry_demo_tpu_torch.pipeline import odometry as todo

N_SCANS = 5
# the four align setups of tests/test_torch_icp.py::test_make_align_matches_jax
ALIGN_LANES = [(11, 0.0), (5, 0.08), (5, 0.2), (7, 0.3)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _stack_np(trees):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


@pytest.fixture(scope="module")
def align_lanes():
    """Per lane: its own map (structured cloud, voxel 0.2 m), queries with
    noise and a guess offset, as test_make_align_matches_jax builds them."""
    rng = np.random.default_rng(1234)
    maps, qs, gts = [], [], []
    for seed, offset in ALIGN_LANES:
        xyz, nrm = sample_structured_cloud(seed=seed, n_per_plane=400)
        jp = jcloud.PointsWithNormals(jnp.asarray(xyz), jnp.asarray(nrm),
                                      jnp.ones(xyz.shape[0], bool))
        maps.append(jvm.map_insert(jvm.map_init(8192, 20), jp, voxel_size=0.2))
        n_q = TINY.max_match_points
        qs.append(xyz[:n_q] + rng.normal(0, 0.02, (n_q, 3)).astype(np.float32))
        gts.append(np.array([offset, -offset / 2, 0.0], np.float32))
    B, n_q = len(ALIGN_LANES), TINY.max_match_points
    return dict(maps=_stack_np(maps), q=np.stack(qs), qv=np.ones((B, n_q), bool),
                gt=np.stack(gts), gq=np.tile(np.array([1.0, 0, 0, 0], np.float32), (B, 1)))


@pytest.mark.parametrize("cached", [True, False])
def test_batched_align_matches_jax_vmap(align_lanes, cached):
    """Four lanes, each with its own map, that leave the loop after
    different numbers of rounds: the finished lanes stay frozen."""
    a = align_lanes
    jcfg = JTINY.replace(icp_min_outer_iterations=1, icp_cached_candidates=cached)
    tcfg = TINY.replace(icp_min_outer_iterations=1, icp_cached_candidates=cached)
    jres = jax.vmap(jicp.make_align(jcfg))(
        jax.tree.map(jnp.asarray, a["maps"]), jnp.asarray(a["q"]), jnp.asarray(a["qv"]),
        jse3.Pose(jnp.asarray(a["gt"]), jnp.asarray(a["gq"])))
    tm = tvm.VoxelMap(*(_t(x) for x in a["maps"]))
    tres = ticp.make_align(tcfg)(tm, _t(a["q"]), _t(a["qv"]),
                                 tse3.Pose(_t(a["gt"]), _t(a["gq"])))
    iters = tres.iterations.numpy()
    assert len(set(iters.tolist())) > 1  # the lanes exit at different rounds
    np.testing.assert_array_equal(iters, np.asarray(jres.iterations))
    np.testing.assert_array_equal(tres.num_matches.numpy(), np.asarray(jres.num_matches))
    np.testing.assert_allclose(tres.pose.t.numpy(), np.asarray(jres.pose.t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tres.pose.q.numpy(), np.asarray(jres.pose.q), atol=1e-6, rtol=0)
    # each lane as its own single-sequence align
    align = ticp.make_align(tcfg)
    for b in range(len(ALIGN_LANES)):
        one = align(tvm.VoxelMap(*(x[b] for x in tm)), _t(a["q"][b]), _t(a["qv"][b]),
                    tse3.Pose(_t(a["gt"][b]), _t(a["gq"][b])))
        assert int(one.iterations) == int(iters[b])
        assert torch.equal(one.pose.t, tres.pose.t[b]) and torch.equal(one.pose.q, tres.pose.q[b])
        assert int(one.num_matches) == int(tres.num_matches[b])


# Two TINY drives that track in both configs. Not seeds 0 and 1: under the
# default config seed 1's scene loses every match from scan 3 on, where the
# unconstrained rotation parts the JAX package's own single and vmapped runs
# by 4e-4 in q; under reference_parity seed 0 puts an update point on a voxel
# boundary, where the last ulps of the pose decide its voxel (one count
# differs from the JAX run's, the keys do not).
DRIVE_SEEDS = (2, 3)


@pytest.fixture(scope="module")
def drives():
    """The two TINY drives as raw numpy scans."""
    out = []
    for seed in DRIVE_SEEDS:
        d = simulate_sequence(num_scans=N_SCANS, width=TINY.scan_width, seed=seed, speed=2.0,
                              yaw_rate=0.05, ramp_time=0.0)
        out.append([(s["xyz"], s["intensity"], s["ring"], s["time"]) for s in d.scans])
    return out


LANE_DRIVES = [0, 1, 0, 1]  # B = 4: each drive twice


def _port_scans_b(drives):
    """(S, B, ...) port scans of the lanes' drives (CPU)."""
    per = [[port_scan(*r, TINY.max_raw_points, "cpu") for r in drives[d]] for d in LANE_DRIVES]
    return LidarScan(*(torch.stack([torch.stack([getattr(lane[s], f) for lane in per])
                                    for s in range(N_SCANS)]) for f in LidarScan._fields))


def _jax_scans_b(drives):
    per = [[jax_scan(*r, JTINY.max_raw_points) for r in drives[d]] for d in LANE_DRIVES]
    steps = [jax.tree.map(lambda *xs: jnp.stack(xs), *[lane[s] for lane in per])
             for s in range(N_SCANS)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *steps)


def _assert_pose_close(t, q, jt, jq):
    np.testing.assert_allclose(t, jt, atol=1e-5, rtol=0)
    np.testing.assert_allclose(q, jq, atol=1e-6, rtol=0)


@pytest.mark.parametrize("parity", [False, True])
def test_batched_runner_matches_jax(drives, parity):
    jcfg = jreference_parity(JTINY) if parity else JTINY
    tcfg = reference_parity(TINY) if parity else TINY
    B = len(LANE_DRIVES)
    jrun = jbatched.make_batched_sequence_runner(jcfg, jmesh.make_mesh(dp=1, sp=1))
    jstate, jdiag = jrun(jbatched.init_batched_state(jcfg, B), _jax_scans_b(drives))
    tstate, tdiag = batched.make_batched_sequence_runner(tcfg)(
        batched.init_batched_state(tcfg, B, "cpu"), _port_scans_b(drives))

    assert tdiag.pose.t.shape == (N_SCANS, B, 3)
    assert bool((tdiag.icp_iterations[1:] > 0).all())  # ICP ran after the first scan
    _assert_pose_close(tdiag.pose.t.numpy(), tdiag.pose.q.numpy(),
                       np.asarray(jdiag.pose.t), np.asarray(jdiag.pose.q))
    for f in ("icp_iterations", "num_matches", "map_voxels", "num_planar", "diverged"):
        np.testing.assert_array_equal(getattr(tdiag, f).numpy(), np.asarray(getattr(jdiag, f)),
                                      err_msg=f)
    for f in ("keys", "count", "origin"):
        np.testing.assert_array_equal(getattr(tstate.keyframe, f).numpy(),
                                      np.asarray(getattr(jstate.keyframe, f)), err_msg=f)
    # lanes with the same drive: bitwise; each lane: the single-sequence runner
    for b, other in ((0, 2), (1, 3)):
        assert torch.equal(tdiag.pose.t[:, b], tdiag.pose.t[:, other])
        assert torch.equal(tdiag.pose.q[:, b], tdiag.pose.q[:, other])
        assert torch.equal(tstate.keyframe.tab[b], tstate.keyframe.tab[other])
    run = todo.make_sequence_runner(tcfg)
    for b in range(2):
        sstate, sdiag = run(todo.init_state(tcfg, "cpu"),
                            [port_scan(*r, TINY.max_raw_points, "cpu") for r in drives[b]])
        _assert_pose_close(tdiag.pose.t[:, b].numpy(), tdiag.pose.q[:, b].numpy(),
                           sdiag.pose.t.numpy(), sdiag.pose.q.numpy())
        assert torch.equal(tdiag.icp_iterations[:, b], sdiag.icp_iterations)
        assert torch.equal(tdiag.num_matches[:, b], sdiag.num_matches)
        assert torch.equal(tstate.keyframe.keys[b], sstate.keyframe.keys)


def test_mixed_first_scan_matches_jax(drives):
    """Lane 0 starts a fresh map while lane 1 carries two scans of state:
    ICP runs for the batch and lane 0 keeps its first-scan branch."""
    step = jax.jit(jodo.make_process_scan(JTINY))
    carried = jodo.init_state(JTINY)
    for r in drives[1][:2]:
        carried, _ = step(carried, jax_scan(*r, JTINY.max_raw_points))
    jstate_b = jax.tree.map(lambda *xs: jnp.stack(xs), jodo.init_state(JTINY), carried)
    raw = [drives[0][0], drives[1][2]]
    jscan_b = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[jax_scan(*r, JTINY.max_raw_points) for r in raw])
    jnew, jdiag = jbatched.make_batched_step(JTINY, jmesh.make_mesh(dp=1, sp=1))(
        jstate_b, jscan_b)

    tstate_b = state_from_numpy(jax.tree.map(np.asarray, jstate_b), device="cpu")
    assert tstate_b.keyframe.tab.shape[0] == 2
    tscans = [port_scan(*r, TINY.max_raw_points, "cpu") for r in raw]
    tscan_b = LidarScan(*(torch.stack([getattr(s, f) for s in tscans])
                          for f in LidarScan._fields))
    tnew, tdiag = batched.make_batched_step(TINY)(tstate_b, tscan_b)
    iters = tdiag.icp_iterations.numpy()
    assert iters[0] == 0 and iters[1] > 0
    np.testing.assert_array_equal(iters, np.asarray(jdiag.icp_iterations))
    np.testing.assert_array_equal(tdiag.num_matches.numpy(), np.asarray(jdiag.num_matches))
    _assert_pose_close(tdiag.pose.t.numpy(), tdiag.pose.q.numpy(),
                       np.asarray(jdiag.pose.t), np.asarray(jdiag.pose.q))
    for f in ("keys", "count", "origin"):
        np.testing.assert_array_equal(getattr(tnew.keyframe, f).numpy(),
                                      np.asarray(getattr(jnew.keyframe, f)), err_msg=f)


# ---------------------------------------------------------------------------
# the kernels' plain versions and wrappers over a lane axis
# ---------------------------------------------------------------------------

B3 = 3


@pytest.fixture(scope="module")
def lane_maps():
    """Three TINY-capacity maps built from different structured clouds, and
    each lane's queries, valid flags and pose."""
    rng = np.random.default_rng(7)
    maps, args = [], []
    for b in range(B3):
        xyz, nrm = sample_structured_cloud(seed=20 + b, n_per_plane=300)
        pts = tvm.PointsWithNormals(_t(xyz), _t(nrm), torch.ones(xyz.shape[0], dtype=torch.bool))
        maps.append(tvm.map_insert(tvm.map_init(TINY.map_capacity, 20, "cpu"), pts,
                                   voxel_size=0.2))
        turn = 0.1 * b
        R = torch.from_numpy(np.array([[np.cos(turn), -np.sin(turn), 0],
                                       [np.sin(turn), np.cos(turn), 0], [0, 0, 1]], np.float32))
        t = _t(np.array([0.1 * b, -0.05, 0.02], np.float32))
        q = xyz[rng.integers(0, xyz.shape[0], 256)] + rng.normal(0, 0.1, (256, 3))
        args.append((_t(q.astype(np.float32)), _t(rng.random(256) < 0.9), t, R))
    m = tvm.VoxelMap(*(torch.stack(xs) for xs in zip(*maps)))
    return maps, m, [torch.stack(xs) for xs in zip(*args)]


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_equal_trees(x, y) for x, y in zip(a, b))


def test_lookups_over_lanes_are_their_single_lane_calls(lane_maps):
    maps, m, (q, qv, t, R) = lane_maps
    RW = tvm._lanes(20)[0]
    cand = neighborhood_lookup(m.tab, m.keys, m.origin, q, qv, t, R, voxel_size=0.2,
                               row_width=RW)
    assert cand.base.shape == (B3, 9, 256) and cand.rows_z[0].shape == (B3, 9 * 256, RW)
    assert int(cand.n_present.sum()) > 0
    skeys = torch.sort(tvm.pack_keys(tvm.voxel_indices(q, 0.2), m.origin, qv), dim=-1).values
    pos_c, found = group_lookup(m.keys, skeys)
    assert bool(found.any())
    for b in range(B3):
        one = neighborhood_lookup(maps[b].tab, maps[b].keys, maps[b].origin, q[b], qv[b], t[b],
                                  R[b], voxel_size=0.2, row_width=RW)
        assert _equal_trees(CandidateSet(tuple(r[b] for r in cand.rows_z), cand.base[b],
                                         cand.n_present[b]), one)
        p1, f1 = group_lookup(maps[b].keys, skeys[b])
        assert torch.equal(pos_c[b], p1) and torch.equal(found[b], f1)


def test_match_over_lanes_is_its_single_lane_calls(lane_maps):
    maps, m, (q, qv, t, R) = lane_maps
    RW = tvm._lanes(20)[0]
    cand = neighborhood_lookup(m.tab, m.keys, m.origin, q, qv, t, R, voxel_size=0.2,
                               row_width=RW)
    got = match_correspondences(q, qv, t, R, cand, m.tab, m.nrm, max_d2=0.09, max_points=20)
    assert got.plane_origin.shape == (B3, 256, 3) and int(got.valid.sum()) > 0
    for b in range(B3):
        one = match_correspondences_plain(q[b], qv[b], t[b], R[b],
                                          CandidateSet(tuple(r[b] for r in cand.rows_z),
                                                       cand.base[b], cand.n_present[b]),
                                          maps[b].nrm, max_d2=0.09, max_points=20)
        assert _equal_trees(tuple(x[b] for x in got), one)


def test_gn_step_over_lanes_holds_an_inactive_lane(lane_maps):
    maps, m, (q, qv, t, R) = lane_maps
    corr = tvm.find_correspondences(m, q, qv, t, R, voxel_size=0.2, max_distance=0.3)
    pose = tse3.Pose(t, torch.tensor([[1.0, 0, 0, 0]] * B3))
    guess_t = t + 0.01
    norm_in = torch.tensor([0.5, 0.25, 0.125])
    active = torch.tensor([True, False, True])
    new, norm, H, b = gn_step(corr, pose, guess_t, TINY, step_norm=norm_in, active=active)
    assert torch.equal(new.t[1], pose.t[1]) and torch.equal(new.q[1], pose.q[1])
    assert float(norm[1]) == 0.25
    for lane in (0, 2):
        one = gn_step(tvm.Correspondence(*(x[lane] for x in corr)),
                      tse3.Pose(pose.t[lane], pose.q[lane]), guess_t[lane], TINY)
        assert torch.equal(new.t[lane], one[0].t) and torch.equal(new.q[lane], one[0].q)
        assert torch.equal(norm[lane], one[1]) and torch.equal(H[lane], one[2])
        assert not torch.equal(new.t[lane], pose.t[lane])  # an active lane moves


def test_wrappers_check_the_lane_count():
    """On non-CPU tensors every wrapper checks each argument's lane count
    before the device (meta tensors reach the checks without a card)."""
    meta = dict(device="meta")
    i32, f32 = dict(dtype=torch.int32, **meta), dict(dtype=torch.float32, **meta)
    keys, q = torch.zeros((3, 64), **i32), torch.zeros((2, 16), **i32)
    with pytest.raises(ValueError, match=r"queries must have shape \(3, 16\)"):
        group_lookup(keys, q)
    with pytest.raises(ValueError, match="CUDA"):
        group_lookup(keys, torch.zeros((3, 16), **i32))
    tab = torch.zeros((3, 64, 128), **i32)
    args = [torch.zeros((3, 3), **i32), torch.zeros((3, 8, 3), **f32),
            torch.zeros((3, 8), dtype=torch.bool, **meta), torch.zeros((2, 3), **f32),
            torch.zeros((3, 3, 3), **f32)]
    with pytest.raises(ValueError, match=r"pose_t must have shape \(3, 3\)"):
        neighborhood_lookup(tab, keys, *args, voxel_size=0.2, row_width=64)
    cand = CandidateSet.empty(8, 64, "meta", (3,))
    with pytest.raises(ValueError, match=r"base must have shape \(3, 9, 8\)"):
        match_correspondences(args[1], args[2], torch.zeros((3, 3), **f32), args[4],
                              cand._replace(base=torch.zeros((2, 9, 8), **i32)), tab, None,
                              max_d2=0.09, max_points=20)
    corr = tvm.Correspondence(torch.zeros((3, 8, 3), **f32), torch.zeros((3, 8, 3), **f32),
                              torch.zeros((3, 8, 3), **f32),
                              torch.zeros((3, 8), dtype=torch.bool, **meta))
    pose = tse3.Pose(torch.zeros((3, 3), **f32), torch.zeros((3, 4), **f32))
    with pytest.raises(ValueError, match=r"active must have shape \(3,\)"):
        gn_step(corr, pose, torch.zeros((3, 3), **f32), TINY,
                step_norm=torch.zeros(3, **f32),
                active=torch.zeros(2, dtype=torch.bool, **meta))
    with pytest.raises(ValueError, match="at most one lane axis"):
        lanes((2, 3))
