"""Port parity for the mesh, the dp and sp sharded modes and the
edge-sharded refine (parallel/mesh.py, parallel/batched.py with a mesh, the
sp hooks of ops/icp.py and pipeline/odometry.py, parallel/pose_graph.py
`make_refine_sharded`), against the JAX package on its 8-device CPU fabric
(tests/conftest.py), and K2's epilogue entry point against its plain
version.

The port's ranks run on gloo CPU process groups: one `run_ranks` call per
world size (2 and 4) runs every mode once (a module-scoped fixture), and
the JAX side runs in this process. TINY, 5 scans, drives seeds 2 and 3.

Bars:
- the mesh: the sum and the ring exchange give each rank its expected
  values;
- sp (N = 2, 4): against the JAX sp step at the same N (the batched runner
  over a dp=1 x sp=N mesh), t within 1e-5 and q within 1e-6, iterations
  and matches equal; within 1e-5 m of the port's single run
  (tests/test_parallel.py's bar); every rank bitwise equal; at N = 2
  bitwise the one-process witness of the split sums (two threads);
- dp (dp = 2, and dp = 2 x sp = 2): against the JAX batched runner at the
  same mesh, t within 1e-5, q within 1e-6, iterations and matches equal,
  and the final keys, counts and origin equal; at sp = 1 each lane bitwise
  the port's single-process batched run;
- refine over N = 2, 4 ranks: within 2e-3 (tests/test_pose_graph.py's bar)
  of the JAX `make_refine_sharded` at the same N and of the port's refine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.parallel import batched as jbatched
from lidar_odometry_demo_tpu.parallel import mesh as jmesh
from lidar_odometry_demo_tpu.parallel import pose_graph as jpg
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.kernels.jtwj import (
    GnWork, gn_epilogue, gn_epilogue_plain, gn_step_plain, jtwj_accumulate)
from lidar_odometry_demo_tpu_torch.ops import se3 as tse3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy as port_scan
from lidar_odometry_demo_tpu_torch.parallel import batched
from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib
from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg
from lidar_odometry_demo_tpu_torch.pipeline import odometry as todo

N_SCANS = 5
DRIVE_SEEDS = (2, 3)
LANE_DRIVES = [0, 1, 0, 1]  # B = 4: each drive twice
SP_DRIVE = 1                # the sp runs' drive (seed 3)
TIMEOUT = 300.0


def _drives():
    out = []
    for seed in DRIVE_SEEDS:
        d = simulate_sequence(num_scans=N_SCANS, width=TINY.scan_width, seed=seed, speed=2.0,
                              yaw_rate=0.05, ramp_time=0.0)
        out.append([(s["xyz"], s["intensity"], s["ring"], s["time"]) for s in d.scans])
    return out


def _port_scans_b(drives):
    per = [[port_scan(*r, TINY.max_raw_points, "cpu") for r in drives[d]] for d in LANE_DRIVES]
    return LidarScan(*(torch.stack([torch.stack([getattr(lane[s], f) for lane in per])
                                    for s in range(N_SCANS)]) for f in LidarScan._fields))


def _jax_scans_b(lane_raw):
    per = [[jax_scan(*r, JTINY.max_raw_points) for r in raw] for raw in lane_raw]
    steps = [jax.tree.map(lambda *xs: jnp.stack(xs), *[lane[s] for lane in per])
             for s in range(N_SCANS)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *steps)


def _sharded_ranks(n, drives, graph):
    """Every mode of this module on one rank of an n-rank gloo group."""
    out = {}
    # the mesh: one sp group of all n ranks
    m = mesh_lib.make_mesh(1, n, "cpu")
    x = torch.full((2,), float(m.rank + 1))
    m.sp.psum(x)
    nxt = m.sp.ppermute_from([torch.tensor([m.rank]), torch.full((3,), float(m.rank))], 1)
    prv = m.sp.ppermute_from(torch.tensor([m.rank]), n - 1)
    out["mesh"] = dict(rank=m.rank, sp_index=m.sp_index, psum=x, next=nxt[0], next_f=nxt[1],
                       prev=prv, backend=m.backend,
                       default_device=str(mesh_lib.make_mesh(n, 1).device))

    # sp: one sequence, its matching points over the n ranks
    step = todo.make_process_scan(TINY, sp_group=m.sp)
    state = todo.init_state(TINY, "cpu")
    diags = []
    for r in drives[SP_DRIVE]:
        state, d = step(state, port_scan(*r, TINY.max_raw_points, "cpu"))
        diags.append(d)
    d = todo.stack_diagnostics(diags)
    out["sp"] = dict(t=d.pose.t, q=d.pose.q, iters=d.icp_iterations, matches=d.num_matches,
                     keys=state.keyframe.keys, count=state.keyframe.count,
                     stats=m.stats.as_dict())

    # dp: B = 4 lanes over dp = 2 (x sp = n / 2)
    dm = mesh_lib.make_mesh(2, n // 2, "cpu")
    run = batched.make_batched_sequence_runner(TINY, dm)
    state_b, d = run(batched.init_batched_state(TINY, len(LANE_DRIVES) // dm.dp, "cpu"),
                     _port_scans_b(drives))
    lanes = dm.lanes(len(LANE_DRIVES))
    out["dp"] = dict(lanes=(lanes.start, lanes.stop), t=d.pose.t, q=d.pose.q,
                     iters=d.icp_iterations, matches=d.num_matches, keys=state_b.keyframe.keys,
                     count=state_b.keyframe.count, origin=state_b.keyframe.origin,
                     all_t=batched.gather_lanes(dm, d.pose.t.numpy()))

    # refine: the edges over all n ranks
    rm = mesh_lib.make_mesh(n, 1, "cpu")
    refined = pg.make_refine_sharded(rm, "dp", iterations=5)(pg.pad_edges(graph, n))
    out["refine"] = refined.poses.t
    return out


def _one_rank():
    """A world of one: its group is live, so psum runs; on gloo
    ppermute_from returns its inputs (gloo pairs no rank with itself)."""
    m = mesh_lib.make_mesh(1, 1, "cpu")
    x = torch.arange(4, dtype=torch.float32)
    s = m.sp.psum(x.clone())
    y = m.sp.ppermute_from([x, torch.tensor([7], dtype=torch.int32)], 1)
    return dict(live=m.sp.live, backend=m.backend, psum=s, recv=y[0], recv_i=y[1],
                stats=m.stats.as_dict())


@pytest.fixture(scope="module")
def drives():
    return _drives()


@pytest.fixture(scope="module")
def loop(drives):
    from test_torch_pose_graph import _graphs, _make_noisy_loop

    gt_t, gt_q, est_t, est_q = _make_noisy_loop()
    return _graphs(est_t, est_q, gt_t, gt_q, [(31, 0)])


@pytest.fixture(scope="module")
def ranks(drives, loop):
    """{n: [rank 0's results, ...]} for n = 2 and 4 ranks."""
    return {n: mesh_lib.run_ranks(_sharded_ranks, n, n, drives, loop[1], timeout=TIMEOUT)
            for n in (2, 4)}


@pytest.fixture(scope="module")
def single(drives):
    """The port's single-sequence runs of both drives and its batched run
    of the four lanes, in this process."""
    run = todo.make_sequence_runner(TINY)
    singles = [run(todo.init_state(TINY, "cpu"),
                   [port_scan(*r, TINY.max_raw_points, "cpu") for r in raw])[1] for raw in drives]
    state_b, diag_b = batched.make_batched_sequence_runner(TINY)(
        batched.init_batched_state(TINY, len(LANE_DRIVES), "cpu"), _port_scans_b(drives))
    return singles, state_b, diag_b


def _assert_pose_close(t, q, jt, jq):
    np.testing.assert_allclose(t, jt, atol=1e-5, rtol=0)
    np.testing.assert_allclose(q, jq, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_collectives(ranks, n):
    for r, out in enumerate(ranks[n]):
        mo = out["mesh"]
        assert mo["rank"] == r and mo["sp_index"] == r and mo["backend"] == "gloo"
        np.testing.assert_array_equal(mo["psum"], np.full(2, n * (n + 1) / 2, np.float32))
        assert int(mo["next"][0]) == (r + 1) % n and int(mo["prev"][0]) == (r - 1) % n
        np.testing.assert_array_equal(mo["next_f"], np.full(3, (r + 1) % n, np.float32))


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_without_a_device_takes_its_ranks(ranks, n):
    """A mesh built with no device lays its tensors on the device run_ranks
    gave the rank (the CPU here), never on one of its own choosing."""
    assert [o["mesh"]["default_device"] for o in ranks[n]] == ["cpu"] * n


def test_mesh_without_a_group_or_a_card_raises(monkeypatch):
    """With no group and no device named, a mesh runs on the card, as the
    port's entry points do, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_mesh(1, 1)
    assert mesh_lib.make_mesh(1, 1, "cpu").device == torch.device("cpu")


def test_world_of_one_runs_real_collectives():
    (out,) = mesh_lib.run_ranks(_one_rank, 1, timeout=TIMEOUT)
    assert out["live"] and out["backend"] == "gloo"
    np.testing.assert_array_equal(out["psum"], np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(out["recv"], np.arange(4, dtype=np.float32))
    assert out["recv_i"].tolist() == [7]
    stats = out["stats"]
    assert (stats["collectives"], stats["exchanges"], stats["exchanged_bytes"]) == (1, 0, 0)


def test_mesh_layout_and_lanes_in_one_process():
    m = mesh_lib.make_mesh(1, 1, "cpu")
    assert (m.dp_index, m.sp_index, m.sp.size, m.backend, m.sp.live) == (0, 0, 1, "none", False)
    x = torch.ones(3)
    assert m.sp.psum(x) is x and m.sp.ppermute_from(x, 1) is x
    assert m.lanes(4) == slice(0, 4)
    assert mesh_lib.choose_backend(torch.device("cpu"), 4) == "gloo"
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_lib.make_mesh(2, 1, "cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_sp_matches_jax_sp_and_single(ranks, drives, single, n):
    outs = [o["sp"] for o in ranks[n]]
    for o in outs[1:]:  # every rank takes the same steps
        for f in ("t", "q", "iters", "matches", "keys", "count"):
            np.testing.assert_array_equal(o[f], outs[0][f], err_msg=f)
    sp = outs[0]
    assert (sp["iters"][1:] > 0).all() and sp["iters"][0] == 0
    # the JAX sp step at the same N: the batched runner over dp=1 x sp=N, B = 1
    jrun = jbatched.make_batched_sequence_runner(JTINY, jmesh.make_mesh(dp=1, sp=n))
    _, jdiag = jrun(jbatched.init_batched_state(JTINY, 1), _jax_scans_b([drives[SP_DRIVE]]))
    _assert_pose_close(sp["t"], sp["q"], np.asarray(jdiag.pose.t)[:, 0],
                       np.asarray(jdiag.pose.q)[:, 0])
    np.testing.assert_array_equal(sp["iters"], np.asarray(jdiag.icp_iterations)[:, 0])
    np.testing.assert_array_equal(sp["matches"], np.asarray(jdiag.num_matches)[:, 0])
    s = single[0][SP_DRIVE]
    np.testing.assert_allclose(sp["t"], s.pose.t.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(sp["matches"], s.num_matches.numpy())
    # one all-reduce per round (matches and cost) and one per Gauss-Newton
    # step (H and b); ICP ran on the first scan too, and was selected away
    stats = sp["stats"]["by_kind"]
    assert stats["H,b"] == TINY.icp_inner_iterations * stats["matches,cost"]
    assert stats["matches,cost"] > int(sp["iters"].sum())


def test_sp_ranks_are_the_one_process_witness(ranks, drives):
    """sp at N = 2 over gloo ranks bitwise (poses, iterations, matches) the
    same halves in two threads of this process with the sums added in rank
    order (chip_smoke.py's `sp_witness`, which the card run holds its sp
    ranks to): the ranks differ from the single run by the sum order
    alone."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    scans = [port_scan(*r, TINY.max_raw_points, "cpu") for r in drives[SP_DRIVE]]
    witness = smoke.sp_witness(TINY, scans, "cpu", 2)
    sp = ranks[2][0]["sp"]
    for f in ("t", "q", "iters", "matches"):
        np.testing.assert_array_equal(sp[f], witness[f], err_msg=f)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_matches_jax_at_the_same_mesh(ranks, drives, single, n):
    dp, sp = 2, n // 2
    outs = ranks[n]
    B = len(LANE_DRIVES)
    t = np.concatenate([o["dp"]["t"] for o in outs[::sp]], axis=1)
    q = np.concatenate([o["dp"]["q"] for o in outs[::sp]], axis=1)
    for o in outs:  # every rank gathered every lane
        np.testing.assert_array_equal(o["dp"]["all_t"], t)
    assert [tuple(o["dp"]["lanes"]) for o in outs] == [
        (r // sp * B // dp, (r // sp + 1) * B // dp) for r in range(n)]
    jrun = jbatched.make_batched_sequence_runner(JTINY, jmesh.make_mesh(dp=dp, sp=sp))
    jstate, jdiag = jrun(jbatched.init_batched_state(JTINY, B),
                         _jax_scans_b([drives[d] for d in LANE_DRIVES]))
    _assert_pose_close(t, q, np.asarray(jdiag.pose.t), np.asarray(jdiag.pose.q))
    for f, jf in (("iters", "icp_iterations"), ("matches", "num_matches")):
        got = np.concatenate([o["dp"][f] for o in outs[::sp]], axis=1)
        np.testing.assert_array_equal(got, np.asarray(getattr(jdiag, jf)), err_msg=f)
    for f in ("keys", "count", "origin"):
        got = np.concatenate([o["dp"][f] for o in outs[::sp]])
        np.testing.assert_array_equal(got, np.asarray(getattr(jstate.keyframe, f)), err_msg=f)
    _, state_b, diag_b = single
    if sp == 1:  # each lane bitwise the single-process batched run
        np.testing.assert_array_equal(t, diag_b.pose.t.numpy())
        np.testing.assert_array_equal(q, diag_b.pose.q.numpy())
        got = np.concatenate([o["dp"]["keys"] for o in outs])
        np.testing.assert_array_equal(got, state_b.keyframe.keys.numpy())
    else:
        np.testing.assert_allclose(t, diag_b.pose.t.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_refine_sharded_matches_jax_and_refine(ranks, loop, n):
    jg, tg = loop
    for o in ranks[n][1:]:
        np.testing.assert_array_equal(o["refine"], ranks[n][0]["refine"])
    got = ranks[n][0]["refine"]
    jrun = jpg.make_refine_sharded(jmesh.make_mesh(dp=n, sp=1), axis="dp", iterations=5)
    np.testing.assert_allclose(got, np.asarray(jrun(jpg.pad_edges(jg, n)).poses.t), atol=2e-3)
    np.testing.assert_allclose(got, pg.refine(tg, iterations=5).poses.t.numpy(), atol=2e-3)


def test_refine_sharded_refuses_unpadded_edges(loop):
    m = mesh_lib.make_mesh(1, 1, "cpu")
    m.groups["dp"] = mesh_lib.Group(None, [0, 1], 0, "gloo", m.stats)  # two ranks, no group
    with pytest.raises(ValueError, match="multiple of 2"):
        pg.make_refine_sharded(m, "dp")(loop[1]._replace(
            edge_i=loop[1].edge_i[:31], edge_j=loop[1].edge_j[:31]))


# --------------------------------------------------------------------------
# K2's epilogue entry point (the split step's second part)
# --------------------------------------------------------------------------

def _corr_and_pose(rng, Q=300, lanes=()):
    cloud = rng.normal(0, 5, (*lanes, Q, 3)).astype(np.float32)
    normals = rng.normal(0, 1, (*lanes, Q, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    corr = tvm.Correspondence(
        source_local=torch.from_numpy(cloud),
        plane_origin=torch.from_numpy(cloud + rng.normal(0, 0.05, cloud.shape).astype(np.float32)),
        plane_normal=torch.from_numpy(normals),
        valid=torch.from_numpy(rng.random((*lanes, Q)) < 0.9))
    q = rng.normal(0, 1, (*lanes, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pose = tse3.Pose(torch.from_numpy(rng.normal(0, 0.1, (*lanes, 3)).astype(np.float32)),
                     torch.from_numpy(q))
    guess_t = torch.from_numpy(rng.normal(0, 0.1, (*lanes, 3)).astype(np.float32))
    return corr, pose, guess_t


def test_epilogue_plain_is_gn_step_plain(rng):
    """accumulate, then the epilogue on its H and b: gn_step_plain's pose
    within 1e-6 and its step norm within 1e-6 relative (H's lower triangle
    may differ from its upper one in the last ulp, and the epilogue reads
    the upper), and exactly on a symmetric H."""
    corr, pose, guess_t = _corr_and_pose(rng)
    want_pose, want_norm, H, b = gn_step_plain(corr, pose, guess_t, TINY)
    work = GnWork.empty(1, "cpu")
    jtwj_accumulate(corr, pose, huber_delta=TINY.icp_huber_delta, work=work)
    torch.testing.assert_close(work.H, H, rtol=0, atol=0)
    torch.testing.assert_close(work.b, b, rtol=0, atol=0)
    got_pose, got_norm = gn_epilogue(work.H, work.b, pose, guess_t, TINY, work=work)
    np.testing.assert_allclose(got_pose.t.numpy(), want_pose.t.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_pose.q.numpy(), want_pose.q.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    sym = torch.triu(H) + torch.triu(H, 1).T
    a = gn_epilogue_plain(sym, b, pose, guess_t, TINY)
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import _solve_and_update
    e = _solve_and_update(sym, b, pose, guess_t, TINY)
    assert torch.equal(a[0].t, e[0].t) and torch.equal(a[0].q, e[0].q) and torch.equal(a[1], e[1])


def test_epilogue_plain_over_lanes_holds_an_inactive_lane(rng):
    corr, pose, guess_t = _corr_and_pose(rng, lanes=(3,))
    work = GnWork.empty(1, "cpu", (3,))
    jtwj_accumulate(corr, pose, huber_delta=TINY.icp_huber_delta, work=work)
    norm_in = torch.tensor([7.0, 8.0, 9.0])
    active = torch.tensor([True, False, True])
    got_pose, got_norm = gn_epilogue(work.H, work.b, pose, guess_t, TINY, work=work,
                                     step_norm=norm_in, active=active)
    for b in range(3):
        one_pose, one_norm = gn_epilogue_plain(work.H[b], work.b[b],
                                               tse3.Pose(pose.t[b], pose.q[b]), guess_t[b], TINY)
        if b == 1:
            one_pose, one_norm = tse3.Pose(pose.t[b], pose.q[b]), norm_in[b]
        assert torch.equal(got_pose.t[b], one_pose.t) and torch.equal(got_pose.q[b], one_pose.q)
        assert torch.equal(got_norm[b], one_norm)


def test_epilogue_wrapper_checks_its_inputs():
    meta = torch.device("meta")
    H, b = torch.empty((2, 6, 6), device=meta), torch.empty((2, 6), device=meta)
    pose = tse3.Pose(torch.empty((2, 3), device=meta), torch.empty((2, 4), device=meta))
    work = GnWork.empty(1, meta, (2,))
    with pytest.raises(ValueError, match="guess_t must have shape"):
        gn_epilogue(H, b, pose, torch.empty((3,), device=meta), TINY, work=work)
    with pytest.raises(ValueError, match="step_norm"):
        gn_epilogue(H, b, pose, torch.empty((2, 3), device=meta), TINY, work=work,
                    active=torch.ones(2, dtype=torch.bool, device=meta))
