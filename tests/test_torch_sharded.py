"""Port parity for the mesh, the dp and sp sharded modes and the
edge-sharded refine (parallel/mesh.py, parallel/batched.py with a mesh, the
sp hooks of ops/icp.py and pipeline/odometry.py, parallel/pose_graph.py
`make_refine_sharded`), against the JAX package on its 8-device CPU fabric
(tests/conftest.py), and K2's split-step entry points (`gn_sum_step` and
K2e, `gn_epilogue`) against the launch sequence they replace.

The port's ranks run on gloo CPU process groups: one `run_ranks` call per
world size (2 and 4) runs every mode once (a module-scoped fixture), and
the JAX side runs in this process. TINY, 5 scans, drives seeds 2 and 3.

Bars:
- the mesh: the sum and the ring exchange give each rank its expected
  values;
- sp (N = 2, 4): against the JAX sp step at the same N (the batched runner
  over a dp=1 x sp=N mesh), t within 1e-5 and q within 1e-6, iterations
  and matches equal; within 1e-5 m of the port's single run
  (tests/test_parallel.py's bar); every rank bitwise equal; at N = 2 and
  4 bitwise the one-process witness of the split sums (threads), since
  every sum over the ranks is added in rank order; one K2e and four K2
  launches (`jtwj_accumulate`, then `gn_sum_step`) per ICP round;
- the split step's plain versions bitwise the sequence they replace (the
  parts added in rank order, `gn_epilogue_plain`, `jtwj_plain`), and the
  rank-order sum of the parts within 1e-5 of its scale of the JAX
  `_normal_equations(..., axis_name)` under `shard_map` at the same N;
- dp (dp = 2, and dp = 2 x sp = 2): against the JAX batched runner at the
  same mesh, t within 1e-5, q within 1e-6, iterations and matches equal,
  and the final keys, counts and origin equal; at sp = 1 each lane bitwise
  the port's single-process batched run;
- refine over N = 2, 4 ranks: within 2e-3 (tests/test_pose_graph.py's bar)
  of the JAX `make_refine_sharded` at the same N and of the port's refine;
- the segment-Schur refine over N = 2, 4 ranks (a 64-pose loop, stride 8,
  the edges padded to N): the summed chain system within 1e-5 of its scale
  of the JAX `build_chain_system(axis_name="dp")` under `shard_map` at the
  same N and of the port's one-process system, the refined poses within
  1e-4 m of the JAX sharded `refine_segment` and of the port's own, the
  ranks bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu.ops import se3 as jse3
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.parallel import batched as jbatched
from lidar_odometry_demo_tpu.parallel import mesh as jmesh
from lidar_odometry_demo_tpu.parallel import pose_graph as jpg
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.kernels.jtwj import (
    GnWork, add_prior, gn_epilogue, gn_epilogue_plain, gn_epilogue_sum_plain, gn_step_plain,
    gn_sum_step, gn_sum_step_plain, jtwj_accumulate, jtwj_plain, prior_weight, split_record,
    sum_in_rank_order)
from lidar_odometry_demo_tpu_torch.ops import icp as ticp
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
SEG_POSES, SEG_STRIDE, SEG_ITERATIONS = 64, 8, 10
SEG_CLOSURES = [(56, 0), (32, 0)]  # separator poses (index % stride == 0)
CHAIN_SYSTEM = ("diag", "off", "S_extra", "b")
K2_ENTRY_POINTS = ("gn_step", "jtwj_accumulate", "gn_sum_step", "gn_epilogue")


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


def _sharded_ranks(n, drives, graph, seg_graph):
    """Every mode of this module on one rank of an n-rank gloo group."""
    out = {}
    # the mesh: one sp group of all n ranks
    m = mesh_lib.make_mesh(1, n, "cpu")
    x = torch.full((2,), float(m.rank + 1))
    m.sp.psum(x)
    nxt = m.sp.ppermute_from([torch.tensor([m.rank]), torch.full((3,), float(m.rank))], 1)
    prv = m.sp.ppermute_from(torch.tensor([m.rank]), n - 1)
    gathered = m.sp.gather_parts(torch.full((2, 3), float(m.rank + 1)), "test")
    out["mesh"] = dict(rank=m.rank, sp_index=m.sp_index, psum=x, next=nxt[0], next_f=nxt[1],
                       prev=prv, gathered=gathered, backend=m.backend,
                       default_device=str(mesh_lib.make_mesh(n, 1).device))

    # sp: one sequence, its matching points over the n ranks, with every
    # call ICP makes to K2's entry points counted
    calls = {name: 0 for name in K2_ENTRY_POINTS}
    real = {name: getattr(ticp, name) for name in K2_ENTRY_POINTS}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in K2_ENTRY_POINTS:
        setattr(ticp, name, counted(name))
    m.stats.reset()
    try:
        step = todo.make_process_scan(TINY, sp_group=m.sp)
        state = todo.init_state(TINY, "cpu")
        diags = []
        for r in drives[SP_DRIVE]:
            state, d = step(state, port_scan(*r, TINY.max_raw_points, "cpu"))
            diags.append(d)
    finally:
        for name in K2_ENTRY_POINTS:
            setattr(ticp, name, real[name])
    d = todo.stack_diagnostics(diags)
    out["sp"] = dict(t=d.pose.t, q=d.pose.q, iters=d.icp_iterations, matches=d.num_matches,
                     keys=state.keyframe.keys, count=state.keyframe.count,
                     stats=m.stats.as_dict(), calls=calls)

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

    # the segment-Schur refine: the 64-pose loop's edges over all n ranks
    group = rm.axis("dp")
    local = pg.shard_edges(pg.pad_edges(seg_graph, n), group)
    rm.stats.reset()
    system = pg.build_chain_system(local, SEG_STRIDE, group)
    refined = pg.refine_segment(local, SEG_STRIDE, SEG_ITERATIONS, group)
    out["segment"] = dict(system=system, t=refined.poses.t, q=refined.poses.q,
                          all_reduces=rm.stats.by_kind.get("chain system", 0),
                          collectives=rm.stats.collectives)
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
def seg_loop():
    """The 64-pose loop with two separator-aligned closures, in both
    packages: (gt_t, est_t, JAX graph, port graph)."""
    from test_torch_pose_graph import _graphs, _make_noisy_loop

    gt_t, gt_q, est_t, est_q = _make_noisy_loop(P_n=SEG_POSES, drift=0.02)
    return (gt_t, est_t, *_graphs(est_t, est_q, gt_t, gt_q, SEG_CLOSURES))


@pytest.fixture(scope="module")
def ranks(drives, loop, seg_loop):
    """{n: [rank 0's results, ...]} for n = 2 and 4 ranks."""
    return {n: mesh_lib.run_ranks(_sharded_ranks, n, n, drives, loop[1], seg_loop[3],
                                  device="cpu", timeout=TIMEOUT)
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


def test_run_ranks_defaults_to_the_card(monkeypatch):
    """run_ranks without a device asks for the card, as the port's other
    entry points do, and raises where there is none before a rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.run_ranks(_one_rank, 1)


def test_world_of_one_runs_real_collectives():
    (out,) = mesh_lib.run_ranks(_one_rank, 1, device="cpu", timeout=TIMEOUT)
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


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_sp_ranks_at_four_are_the_one_process_witness(ranks, drives):
    """sp at N = 4 over gloo ranks bitwise (poses, iterations, matches) the
    same quarters in four threads of this process (`sp_witness`): past two
    ranks too the ranks differ from the single run by the sum order alone,
    since every sum over the group is added in rank order."""
    scans = [port_scan(*r, TINY.max_raw_points, "cpu") for r in drives[SP_DRIVE]]
    witness = _chip_smoke().sp_witness(TINY, scans, "cpu", 4)
    sp = ranks[4][0]["sp"]
    for f in ("t", "q", "iters", "matches"):
        np.testing.assert_array_equal(sp[f], witness[f], err_msg=f)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_launch_schedule_under_a_group(ranks, n):
    """Under a group every ICP round makes one call of K2e and four of the
    K2 family (`jtwj_accumulate` at the round's pose, then `gn_sum_step`
    for each later step), with four gathers of H and b and one of matches
    and costs; the fused `gn_step` never runs."""
    for out in ranks[n]:
        sp = out["sp"]
        rounds = sp["stats"]["by_kind"]["matches,cost"]
        inner = TINY.icp_inner_iterations
        assert rounds > 0
        assert sp["calls"] == {"gn_step": 0, "jtwj_accumulate": rounds,
                               "gn_sum_step": (inner - 1) * rounds, "gn_epilogue": rounds}
        assert sp["stats"]["gathers"] == sp["stats"]["by_kind"]["H,b"] + rounds
        assert "psum" not in sp["stats"]["by_kind"]


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_gathers_parts_in_rank_order(ranks, n):
    """`gather_parts` gives every rank every rank's tensor, in group order,
    with its shape behind the group axis."""
    want = np.stack([np.full((2, 3), r + 1, np.float32) for r in range(n)])
    for out in ranks[n]:
        np.testing.assert_array_equal(out["mesh"]["gathered"], want)


def test_gather_parts_of_a_group_that_is_not_live():
    """A group with no process group behind it gathers nothing: x comes back
    as its one part, a copy."""
    m = mesh_lib.make_mesh(1, 1, "cpu")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    parts = m.sp.gather_parts(x)
    assert parts.shape == (1, 2, 3) and torch.equal(parts[0], x)
    x += 1
    assert not torch.equal(parts[0], x)
    assert m.stats.collectives == m.stats.gathers == 0


def test_thread_group_gathers_in_rank_order():
    """chip_smoke.py's ThreadGroup (the sp witness's group) gives every
    thread the four threads' tensors in rank order, and their rank-order
    sum is ((1e8 + 1) - 1e8) + 1 = 1 in float32 on every thread (pairwise
    it would be 0): the sum's order is the path's, not the group's."""
    import threading

    smoke = _chip_smoke()
    shared = smoke.ThreadGroup.shared(4)
    xs = [torch.tensor([v], dtype=torch.float32) for v in (1e8, 1.0, -1e8, 1.0)]
    outs = [None] * 4

    def rank(r):
        outs[r] = smoke.ThreadGroup(r, shared).gather_parts(xs[r].clone())

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for o in outs:
        assert torch.equal(o, torch.stack(xs))
        assert float(sum_in_rank_order(o)) == 1.0


def test_comm_stats_time_the_device_only_when_asked():
    """A Group times its NCCL collectives of CUDA tensors with CUDA events
    only after its stats were reset with device_timing; a plain reset turns
    it off again, and gloo or CPU tensors are never timed on the device."""
    import types

    cuda = types.SimpleNamespace(is_cuda=True)
    nccl = mesh_lib.Group(None, [0, 1], 0, "nccl", mesh_lib.CommStats())
    gloo = mesh_lib.Group(None, [0, 1], 0, "gloo", nccl.stats)
    assert not nccl._device_timed(cuda)
    nccl.stats.reset(device_timing=True)
    assert nccl._device_timed(cuda) and not gloo._device_timed(cuda)
    assert not nccl._device_timed(torch.zeros(1))
    nccl.stats.reset()
    assert not nccl._device_timed(cuda) and nccl.stats.pending == []


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


def _jax_segment_sharded(jg, n):
    """The JAX package's edge-sharded segment refine on its n-device CPU
    fabric: the first chain system (build_chain_system with axis_name) and
    the poses after refine_segment with axis_name, under shard_map."""
    from jax.sharding import PartitionSpec as P

    def local(pt, pq, ei, ej, zt, zq, wr, wt, valid):
        g = jpg.PoseGraph(poses=jse3.Pose(pt, pq), edge_i=ei, edge_j=ej,
                          edge_z=jse3.Pose(zt, zq), edge_w_rot=wr, edge_w_t=wt,
                          edge_valid=valid)
        system = jpg.build_chain_system(g, SEG_STRIDE, axis_name="dp")
        out = jpg.refine_segment(g, SEG_STRIDE, SEG_ITERATIONS, axis_name="dp")
        return system, out.poses.t

    f = jax.jit(jax.shard_map(local, mesh=jmesh.make_mesh(dp=n, sp=1),
                              in_specs=(P(), P()) + (P("dp"),) * 7,
                              out_specs=((P(),) * 4, P()), check_vma=False))
    g = jpg.pad_edges(jg, n)
    system, t = f(g.poses.t, g.poses.q, g.edge_i, g.edge_j, g.edge_z.t, g.edge_z.q,
                  g.edge_w_rot, g.edge_w_t, g.edge_valid)
    return [np.asarray(x) for x in system], np.asarray(t)


@pytest.mark.parametrize("n", [2, 4])
def test_refine_segment_sharded_matches_jax(ranks, seg_loop, n):
    gt_t, est_t, jg, tg = seg_loop
    outs = [o["segment"] for o in ranks[n]]
    for o in outs[1:]:  # every rank sums and solves the same system
        for name, a, b in zip(CHAIN_SYSTEM, o["system"], outs[0]["system"]):
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(o["t"], outs[0]["t"])
        np.testing.assert_array_equal(o["q"], outs[0]["q"])
    got = outs[0]
    # one all-reduce per chain system: the first one above, then one per iteration
    assert got["all_reduces"] == got["collectives"] == SEG_ITERATIONS + 1
    want_sys, want_t = _jax_segment_sharded(jg, n)
    one = pg.build_chain_system(tg, SEG_STRIDE)
    for name, a, w, o in zip(CHAIN_SYSTEM, got["system"], want_sys, one):
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(a, w, atol=1e-5 * scale, rtol=0, err_msg=name)
        np.testing.assert_allclose(a, o.numpy(), atol=1e-5 * scale, rtol=0, err_msg=name)
    np.testing.assert_allclose(got["t"], want_t, atol=1e-4, rtol=0)
    mine = pg.refine_segment(tg, SEG_STRIDE, SEG_ITERATIONS).poses.t.numpy()
    np.testing.assert_allclose(got["t"], mine, atol=1e-4, rtol=0)
    rms = [float(np.sqrt(np.mean(np.sum((t - gt_t) ** 2, -1)))) for t in (got["t"], est_t)]
    assert rms[0] < 0.5 * rms[1]


def test_chain_system_slices_add_up_and_padding_adds_nothing(seg_loop):
    """The edge slices' chain systems, added, are the whole graph's (within
    1e-5 of the scale), and a slice of padding alone is exactly zero: its
    Jacobians are zero, the chain scatter skips (0, 0) and S_extra sends it
    to the virtual row. The 65 edges padded to 128 over four slices: the
    third holds one edge, the fourth none."""
    tg = seg_loop[3]
    padded = pg.pad_edges(tg, 128)
    slices = [pg.shard_edges(padded, mesh_lib.Group(None, [0, 1, 2, 3], r, "gloo",
                                                    mesh_lib.CommStats()))
              for r in range(4)]
    assert not slices[3].edge_valid.any() and int(slices[2].edge_valid.sum()) == 1
    parts = [pg.build_chain_system(s, SEG_STRIDE) for s in slices]
    for name, x in zip(CHAIN_SYSTEM, parts[3]):
        assert not x.any(), name
    whole = pg.build_chain_system(tg, SEG_STRIDE)
    for i, (name, w) in enumerate(zip(CHAIN_SYSTEM, whole)):
        total = sum(p[i] for p in parts)
        scale = max(float(w.abs().max()), 1.0)
        np.testing.assert_allclose(total.numpy(), w.numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)


def test_shard_edges_refuses_unpadded_edges(seg_loop):
    """The segment refine's slices, like make_refine_sharded's, need the
    edges padded to a multiple of the group's size."""
    tg = seg_loop[3]
    two = mesh_lib.Group(None, [0, 1], 1, "gloo", mesh_lib.CommStats())
    with pytest.raises(ValueError, match="multiple of 2"):
        pg.shard_edges(tg, two)  # 65 edges
    local = pg.shard_edges(pg.pad_edges(tg, 2), two)
    assert local.edge_i.shape == (33,) and local.poses.t.shape == (SEG_POSES, 3)


# --------------------------------------------------------------------------
# K2's split-step entry points: gn_sum_step and K2e (gn_epilogue)
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


def _rank_slices(corr, n):
    """The n contiguous row slices of a correspondence set (the sp cut)."""
    Q = corr.valid.shape[-1]
    return [tvm.Correspondence(*(x[..., r * Q // n:(r + 1) * Q // n, :].contiguous()
                                 for x in corr[:3]),
                               corr.valid[..., r * Q // n:(r + 1) * Q // n].contiguous())
            for r in range(n)]


def test_epilogue_plain_is_gn_step_plain(rng):
    """accumulate, then the epilogue on its H and b (K2e on that one part):
    gn_step_plain's pose within 1e-6 and its step norm within 1e-6 relative
    (H's lower triangle may differ from its upper one in the last ulp, and
    the epilogue reads the upper), and exactly on a symmetric H."""
    corr, pose, guess_t = _corr_and_pose(rng)
    want_pose, want_norm, H, b = gn_step_plain(corr, pose, guess_t, TINY)
    work = GnWork.empty(1, "cpu")
    jtwj_accumulate(corr, pose, huber_delta=TINY.icp_huber_delta, work=work)
    torch.testing.assert_close(work.H, H, rtol=0, atol=0)
    torch.testing.assert_close(work.b, b, rtol=0, atol=0)
    got_pose, got_norm = gn_epilogue(work.hb[None], pose, guess_t, TINY, work=work)
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
    got_pose, got_norm = gn_epilogue(work.hb[None], pose, guess_t, TINY, work=work,
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
    parts = torch.empty((1, 2, 42), device=meta)
    pose = tse3.Pose(torch.empty((2, 3), device=meta), torch.empty((2, 4), device=meta))
    work = GnWork.empty(1, meta, (2,))
    with pytest.raises(ValueError, match="guess_t must have shape"):
        gn_epilogue(parts, pose, torch.empty((3,), device=meta), TINY, work=work)
    with pytest.raises(ValueError, match="step_norm"):
        gn_epilogue(parts, pose, torch.empty((2, 3), device=meta), TINY, work=work,
                    active=torch.ones(2, dtype=torch.bool, device=meta))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_gathered_step_plain_is_the_old_sequence(rng, n):
    """On the parts of n fake ranks (the rows of a B = 3 set cut in n,
    lane 1 inactive), `gn_sum_step_plain` and K2e's plain version
    (`gn_epilogue_sum_plain`) are bitwise the sequence they replace: the
    parts added in rank order, `gn_epilogue_plain` on the sums, then
    `jtwj_plain` at the new pose; and the wrappers on CPU tensors give the
    same, writing the new part into the workspace."""
    corr, pose, guess_t = _corr_and_pose(rng, Q=400, lanes=(3,))
    norm_in = torch.tensor([7.0, 8.0, 9.0])
    active = torch.tensor([True, False, True])
    lane_args = dict(step_norm=norm_in, active=active)
    slices = _rank_slices(corr, n)
    parts = []
    for part_corr in slices:
        w = GnWork.empty(1, "cpu", (3,))
        jtwj_accumulate(part_corr, pose, huber_delta=TINY.icp_huber_delta, work=w)
        parts.append(w.hb.clone())
    parts = torch.stack(parts)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    want_pose, want_norm = gn_epilogue_plain(total[..., :36].reshape(3, 6, 6), total[..., 36:],
                                             pose, guess_t, TINY, **lane_args)
    assert torch.equal(want_pose.t[1], pose.t[1]) and float(want_norm[1]) == 8.0
    got_pose, got_norm = gn_epilogue_sum_plain(parts, pose, guess_t, TINY, **lane_args)
    for x, y in ((got_pose.t, want_pose.t), (got_pose.q, want_pose.q), (got_norm, want_norm)):
        assert torch.equal(x, y)
    e_pose, e_norm = gn_epilogue(parts, pose, guess_t, TINY, work=GnWork.empty(1, "cpu", (3,)),
                                 **lane_args)
    assert torch.equal(e_pose.t, want_pose.t) and torch.equal(e_pose.q, want_pose.q)
    assert torch.equal(e_norm, want_norm)
    R = tse3.quat_to_matrix(want_pose.q)
    for part_corr in slices:
        want_H, want_b = jtwj_plain(*part_corr, R, want_pose.t, huber_delta=TINY.icp_huber_delta)
        s_pose, s_norm, H, b = gn_sum_step_plain(parts, part_corr, pose, guess_t, TINY,
                                                 **lane_args)
        for x, y in ((s_pose.t, want_pose.t), (s_pose.q, want_pose.q), (s_norm, want_norm),
                     (H, want_H), (b, want_b)):
            assert torch.equal(x, y)
        work = GnWork.empty(1, "cpu", (3,))
        w_pose, w_norm = gn_sum_step(parts, part_corr, pose, guess_t, TINY, work=work,
                                     **lane_args)
        assert torch.equal(w_pose.t, want_pose.t) and torch.equal(w_pose.q, want_pose.q)
        assert torch.equal(w_norm, want_norm)
        assert torch.equal(work.H, want_H) and torch.equal(work.b, want_b)


@pytest.mark.parametrize("n", [2, 4])
def test_rank_order_sum_matches_jax_sharded_normal_equations(rng, n):
    """The ranks' parts of H and b (each rank's slice of the rows, K2 at the
    pose), added in rank order with the translation prior after, within
    1e-5 of their scale of the JAX `_normal_equations(..., axis_name)`
    (ops/icp.py:143-145, a psum over the axis) under `shard_map` on n of
    its CPU devices, on the same numpy inputs."""
    from jax.sharding import PartitionSpec as P

    from lidar_odometry_demo_tpu.ops import icp as jicp
    from lidar_odometry_demo_tpu.ops import voxel_map as jvm

    corr, pose, guess_t = _corr_and_pose(rng, Q=512)
    arrays = [x.numpy() for x in corr]

    def local(sl, po, pn, valid, t, q, g):
        return jicp._normal_equations(jvm.Correspondence(sl, po, pn, valid), jse3.Pose(t, q), g,
                                      JTINY, axis_name="sp")

    f = jax.jit(jax.shard_map(local, mesh=jmesh.make_mesh(dp=1, sp=n),
                              in_specs=(P("sp"),) * 4 + (P(),) * 3, out_specs=(P(), P()),
                              check_vma=False))
    jH, jb = f(*(jnp.asarray(a) for a in arrays), jnp.asarray(pose.t.numpy()),
               jnp.asarray(pose.q.numpy()), jnp.asarray(guess_t.numpy()))
    parts = []
    for part_corr in _rank_slices(corr, n):
        w = GnWork.empty(1, "cpu")
        jtwj_accumulate(part_corr, pose, huber_delta=TINY.icp_huber_delta, work=w)
        parts.append(w.hb.clone())
    H, b = add_prior(*split_record(sum_in_rank_order(torch.stack(parts))), pose.t, guess_t,
                     prior_weight(TINY))
    for got, want in ((H, jH), (b, jb)):
        scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * scale, rtol=0)


def test_sum_step_wrapper_checks_its_inputs():
    """gn_sum_step refuses parts of the wrong lanes or width before it
    launches; on meta tensors it raises."""
    meta = torch.device("meta")
    f32 = dict(dtype=torch.float32, device=meta)
    corr = tvm.Correspondence(torch.empty((2, 8, 3), **f32), torch.empty((2, 8, 3), **f32),
                              torch.empty((2, 8, 3), **f32),
                              torch.empty((2, 8), dtype=torch.bool, device=meta))
    pose = tse3.Pose(torch.empty((2, 3), **f32), torch.empty((2, 4), **f32))
    work = GnWork.empty(1, meta, (2,))
    guess_t = torch.empty((2, 3), **f32)
    with pytest.raises(ValueError, match="parts must have shape"):
        gn_sum_step(torch.empty((2, 42), **f32), corr, pose, guess_t, TINY, work=work)
    with pytest.raises(ValueError, match=r"parts must have shape \(2, 2, 42\)"):
        gn_sum_step(torch.empty((2, 2, 41), **f32), corr, pose, guess_t, TINY, work=work)
    with pytest.raises(ValueError, match="CUDA"):
        gn_sum_step(torch.empty((4, 2, 42), **f32), corr, pose, guess_t, TINY, work=work)
