"""The captured step's parts (pipeline/graphs.py) on CPU tensors, at TINY.

On the CPU a `_LaneGraphs` calls its three parts where the card launches
their graphs: (a) the scan's preparation and ICP's start, (b) one ICP
round (with the loop's condition the WHILE node's body), (c) ICP's end,
the map update and the diagnostics, on the buffers the graphs would read
and write, in the graphs' schedule (the first scans through the eager
step, the rounds and conditions through the loop's one host schedule).
Here those segments, composed eagerly, are held to the eager step and to
the JAX package.

Tolerances: the segments bitwise the eager step (`make_process_scan`) on a
6-scan drive, every diagnostic and the final state, for one sequence, for
B = 2 lanes and under reference_parity(TINY); against the JAX package's
`make_sequence_runner` the bar of tests/test_torch_pipeline.py for a TINY
drive (per-scan poses within 1e-4 m, equal ICP iterations). `active` all
true bitwise `active=None`. Inside a segment or the loop's condition no
operation reads the device from the host or has an output shape that
depends on the data, and every segment's outputs keep their shapes and
dtypes from scan to scan. Under an sp and a spatial group (two
gloo CPU ranks, one `run_ranks` call), the segments of a group's step,
its rounds driven from the host, bitwise the eager group step on every
rank, with the same checks inside each segment.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.config import reference_parity as jreference_parity
from lidar_odometry_demo_tpu.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.pipeline import odometry as jodo
from lidar_odometry_demo_tpu_torch.config import TINY, reference_parity
from lidar_odometry_demo_tpu_torch.kernels.jtwj import GnWork, gn_step
from lidar_odometry_demo_tpu_torch.ops import se3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy as port_scan
from lidar_odometry_demo_tpu_torch.parallel import batched, spatial
from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib
from lidar_odometry_demo_tpu_torch.pipeline import graphs
from lidar_odometry_demo_tpu_torch.pipeline import odometry as todo
from lidar_odometry_demo_tpu_torch.utils import checkpoint as tckpt

N_SCANS = 6  # two warm-up scans through the eager step, four through the segments
# operations that read the device from the host or make a tensor from host
# data: none may run inside a captured segment
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh",
             "aten.masked_select", "aten.item", "aten._unique", "aten.unique")
# indexing operations whose output shape depends on the data under a bool index
INDEXING = ("aten.index.Tensor", "aten.index_put", "aten._index_put_impl")


def _raw(seed):
    d = simulate_sequence(num_scans=N_SCANS, width=TINY.scan_width, seed=seed, speed=2.0,
                          yaw_rate=0.05, ramp_time=0.0)
    return [(s["xyz"], s["intensity"], s["ring"], s["time"]) for s in d.scans]


@pytest.fixture(scope="module")
def drives():
    """Two TINY drives (seeds 3 and 6) as raw arrays."""
    return {3: _raw(3), 6: _raw(6)}


def _scans(raw, lanes=False):
    """Port scans of one drive, or (lanes) of each drive stacked per scan."""
    if not lanes:
        return [port_scan(*r, TINY.max_raw_points, "cpu") for r in raw]
    per = [_scans(r) for r in raw]
    return [LidarScan(*(torch.stack([getattr(p[i], f) for p in per])
                        for f in LidarScan._fields)) for i in range(N_SCANS)]


class Recorder(TorchDispatchMode):
    """Every operation run under it, with its outputs' shapes and dtypes;
    fails on a forbidden one or an indexing by a bool mask."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name.startswith(FORBIDDEN):
            raise AssertionError(f"{func} inside a segment")
        if name.startswith(INDEXING):
            index = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in index):
                raise AssertionError(f"{func} with a bool index: a data-dependent shape")
        out = func(*args, **(kwargs or {}))
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        self.ops.append((str(func), tuple((tuple(t.shape), t.dtype) for t in leaves
                                          if isinstance(t, torch.Tensor))))
        return out


def _signature(x):
    return [(tuple(t.shape), t.dtype) for t in graphs._leaves(x)]


def composed(cfg, scans, record=False, step=None, state=None):
    """The drive through a `_LaneGraphs` on CPU tensors: its segments called
    eagerly in the replay schedule. Returns (final state, stacked
    diagnostics, the _LaneGraphs, per segment the op records and output
    signatures of every call). `step` and `state`: a group's step and its
    fresh state (default the plain step's)."""
    lead = tuple(scans[0].xyz.shape[:-2])
    if state is None:
        state = todo.init_state(cfg, "cpu")
        if lead:
            state = batched.init_batched_state(cfg, lead[0], "cpu")
    lg = graphs._LaneGraphs(step or todo.make_process_scan(cfg), state, scans[0])
    calls = {"a": [], "b": [], "c": [], "condition": []}
    if record:  # each call: its ops, its output signature, the conditions inside it
        def recorded(fn, key):
            def wrapped(*args):
                n = len(calls["condition"])
                with Recorder() as rec:
                    out = fn(*args)
                calls[key].append((rec.ops, _signature(out), len(calls["condition"]) - n))
                return out
            return wrapped

        align = lg.step.align
        align.condition = recorded(align.condition, "condition")  # the eager scans' too
        for key in "abc":
            setattr(lg, f"segment_{key}", recorded(getattr(lg, f"segment_{key}"), key))
    diags = []
    for scan in scans:
        state, diag = lg(state, scan)
        diags.append(graphs._map(torch.clone, diag))
    return graphs._map(torch.clone, state), todo.stack_diagnostics(diags), lg, calls


def eager(cfg, scans, step=None, state=None):
    lead = tuple(scans[0].xyz.shape[:-2])
    if state is None:
        state = todo.init_state(cfg, "cpu")
        if lead:
            state = batched.init_batched_state(cfg, lead[0], "cpu")
    step = step or todo.make_process_scan(cfg)
    diags = []
    for scan in scans:
        state, diag = step(state, scan)
        diags.append(diag)
    return state, todo.stack_diagnostics(diags)


def _assert_bitwise(a, b):
    la, lb = graphs._leaves(a), graphs._leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


_JAX_RUNNERS = {}


def _jax_run(jcfg, raw):
    """The JAX package's make_sequence_runner over a drive (one runner, so
    one compilation, per config)."""
    if jcfg not in _JAX_RUNNERS:
        _JAX_RUNNERS[jcfg] = jodo.make_sequence_runner(jcfg)
    _, jdiag = _JAX_RUNNERS[jcfg](
        jodo.init_state(jcfg), jax.tree.map(lambda *x: np.stack(x),
                                            *[jax_scan(*r, JTINY.max_raw_points) for r in raw]))
    return np.asarray(jdiag.pose.t), np.asarray(jdiag.icp_iterations)


CASES = {"single": (TINY, JTINY, False), "lanes": (TINY, JTINY, True),
         "parity": (reference_parity(TINY), jreference_parity(JTINY), False)}


@pytest.fixture(scope="module")
def runs(drives):
    """Each case's drive through the segments (recorded) and the eager step."""
    out = {}
    for name, (cfg, _, lanes) in CASES.items():
        scans = _scans([drives[3], drives[6]] if lanes else drives[3], lanes)
        out[name] = dict(scans=scans, composed=composed(cfg, scans, record=True),
                         eager=eager(cfg, scans))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_segments_are_the_eager_step(runs, case):
    """Segments (a), (b) x rounds and (c), composed eagerly, bitwise the
    eager step over the drive: every diagnostic, the final state."""
    state, diag, lg, calls = runs[case]["composed"]
    e_state, e_diag = runs[case]["eager"]
    assert lg.segments is not None and lg.eager_scans == graphs.WARM_UP_SCANS
    assert len(calls["a"]) == len(calls["c"]) == N_SCANS - graphs.WARM_UP_SCANS
    assert len(calls["b"]) == int(diag.icp_iterations[graphs.WARM_UP_SCANS:]
                                  .reshape(N_SCANS - graphs.WARM_UP_SCANS, -1)
                                  .amax(dim=-1).sum())
    _assert_bitwise(diag, e_diag)
    _assert_bitwise(state, e_state)


@pytest.mark.parametrize("case", list(CASES))
def test_segments_match_jax(runs, drives, case):
    """The segments' trajectory against the JAX package's
    make_sequence_runner, each lane on its own drive."""
    _, diag, _, _ = runs[case]["composed"]
    _, jcfg, lanes = CASES[case]
    t, iters = diag.pose.t.numpy(), diag.icp_iterations.numpy()
    for b, seed in enumerate((3, 6) if lanes else (3,)):
        jt, jiters = _jax_run(jcfg, drives[seed])
        got_t = t[:, b] if lanes else t
        got_i = iters[:, b] if lanes else iters
        assert np.abs(jt[-1]).max() > 1e-3  # the estimate moves
        np.testing.assert_allclose(got_t, jt, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got_i, jiters)


@pytest.mark.parametrize("case", list(CASES))
def test_segments_read_nothing_and_keep_their_shapes(runs, case):
    """No host read, host-data tensor or data-dependent shape inside a
    segment or the loop's condition (Recorder), no condition inside a
    segment, one condition before each scan's rounds and one after each
    round (eager scans and segments alike), and every call of a segment
    or the condition runs the same operations with the same output shapes
    and dtypes, on scans of different point counts."""
    scans = runs[case]["scans"]
    counts = {int(s.valid.sum()) for s in scans}
    assert len(counts) > 1  # the drive's scans differ in size
    _, diag, _, calls = runs[case]["composed"]
    rounds = diag.icp_iterations.reshape(N_SCANS, -1).amax(dim=-1)
    assert len(calls["condition"]) == int((rounds + 1)[rounds > 0].sum())
    for key, seen in calls.items():
        assert seen, key
        ops0, sig0, _ = seen[0]
        for ops, sig, n_conditions in seen:
            assert ops == ops0, f"segment {key} ran other operations"
            assert sig == sig0, f"segment {key} returned other shapes"
            assert n_conditions == 0, f"segment {key}: {n_conditions} conditions"


def _round_inputs(drives):
    """A B = 2 step's state after two scans and the third scan's
    preparation."""
    cfg = TINY
    scans = _scans([drives[3], drives[6]], lanes=True)
    state = batched.init_batched_state(cfg, 2, "cpu")
    step = todo.make_process_scan(cfg)
    for scan in scans[:2]:
        state, _ = step(state, scan)
    return step, state, step.prepare(state, scans[2])


def test_active_all_true_is_active_none(drives):
    """`active` all true is bitwise `active=None`: K2's plain step (the
    wrapper on CPU tensors) and a whole round at B = 2."""
    step, state, prep = _round_inputs(drives)
    align = step.align
    loops = [align.begin(state.keyframe, prep.q_xyz, prep.q_valid, prep.guess)
             for _ in range(2)]
    loops[1] = loops[1]._replace(active=None)
    for loop in loops:
        align.round(state.keyframe, loop)
        assert torch.equal(loop.stall, loops[0].stall)
    a, b = loops
    for x, y in ((a.work.poses, b.work.poses), (a.best_pose.t, b.best_pose.t),
                 (a.best_pose.q, b.best_pose.q), (a.best_cost, b.best_cost),
                 (a.best_matches, b.best_matches), (a.n_matches, b.n_matches),
                 (a.iters, b.iters), (a.stall, b.stall)):
        assert torch.equal(x, y)
    corr = step.align.begin(state.keyframe, prep.q_xyz, prep.q_valid, prep.guess)
    c = vm.match_candidates(state.keyframe, corr.cand, prep.q_xyz, prep.q_valid,
                            prep.guess.t, se3.quat_to_matrix(prep.guess.q),
                            max_distance=TINY.icp_max_correspondence_distance,
                            nrm_view=state.keyframe.nrm)
    norm = torch.tensor([3.0, 4.0])
    with_active = gn_step(c, prep.guess, prep.guess.t, TINY, work=GnWork.empty(1, "cpu", (2,)),
                          step_norm=norm, active=torch.ones(2, dtype=torch.bool))
    without = gn_step(c, prep.guess, prep.guess.t, TINY, work=GnWork.empty(1, "cpu", (2,)))
    for x, y in zip(graphs._leaves(with_active), graphs._leaves(without)):
        assert torch.equal(x, y)


def test_checkpoint_loaded_into_state_is_what_the_next_step_reads(drives, tmp_path):
    """A checkpoint assigned to `LidarOdometry.state` is the state the next
    scan steps from: bitwise the run it was saved from."""
    scans = _scans(drives[3])
    odo = todo.LidarOdometry(TINY, device="cpu")
    for scan in scans[:2]:
        odo.process_scan(scan)
    tckpt.save_npz(tmp_path / "state.npz", odo.state)
    resumed = todo.LidarOdometry(TINY, device="cpu")
    resumed.state = tckpt.load_npz(tmp_path / "state.npz", device="cpu")
    for scan in scans[2:]:
        _assert_bitwise(resumed.process_scan(scan), odo.process_scan(scan))
    _assert_bitwise(resumed.state, odo.state)


def test_a_state_copied_in_is_tested_before_segment_a(drives):
    """A fresh state passed to a captured step (a runner reused for another
    drive) is tested for its first scan before (a) runs: its first scan
    goes to the eager step without running (a), whose launches would count
    without a use."""
    scans = _scans(drives[3])
    _, _, lg, _ = composed(TINY, scans)
    a = lg.segments[0]
    out, eager_scans = a.out, lg.eager_scans
    lg(todo.init_state(TINY, "cpu"), scans[0])
    assert a.out is out and lg.eager_scans == eager_scans + 1
    lg(lg.state, scans[1])
    assert a.out is not out


def test_own_keeps_a_state_the_next_call_rewrites(drives):
    """The state a `_LaneGraphs` returns is its buffers, which its next call
    rewrites in place; `CapturedStep.own` of it is a copy that stays as it
    was, and the eager step's `own` is the state itself."""
    scans = _scans(drives[3])
    step = graphs.CapturedStep(TINY)
    state = todo.init_state(TINY, "cpu")
    lg = step._lanes[()] = graphs._LaneGraphs(step.eager, state, scans[0])
    for scan in scans[:3]:
        state, _ = lg(state, scan)
    held, kept = step.own(state), graphs._map(torch.clone, state)
    assert held.current.t is not state.current.t
    lg(state, scans[3])
    _assert_bitwise(held, kept)
    assert not torch.equal(state.current.t, kept.current.t)  # the buffers moved on
    assert step.eager.own(kept) is kept


GROUP_MODES = ("sp", "spatial")


def _group_rank(raw):
    """One of two gloo CPU ranks: per mode, the segments of the group's step
    composed eagerly (recorded) and the eager group step over the drive."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(1, 2, device="cpu")
    scans = _scans(raw)
    out = {}
    for mode in GROUP_MODES:
        kw = {f"{mode}_group": mesh.sp}

        def init(mode=mode):
            if mode == "sp":
                return todo.init_state(TINY, "cpu")
            return spatial.init_spatial_state(TINY, mesh.sp.size, "cpu")

        got = composed(TINY, scans, record=True, step=todo.make_process_scan(TINY, **kw),
                       state=init())
        want = eager(TINY, scans, step=todo.make_process_scan(TINY, **kw), state=init())
        state, diag, lg, calls = got
        out[mode] = dict(got=(state, diag), want=want, eager_scans=lg.eager_scans,
                         grouped=lg.grouped, calls=calls)
    return out


@pytest.fixture(scope="module")
def group_runs(drives):
    return mesh_lib.run_ranks(_group_rank, 2, drives[3], device="cpu", timeout=300.0)


@pytest.mark.parametrize("mode", GROUP_MODES)
def test_group_segments_are_the_eager_group_step(group_runs, mode):
    """Under an sp and a spatial group (two gloo CPU ranks), the segments
    of the group's step composed eagerly, its rounds driven from the host,
    bitwise the eager group step on each rank; no host read or
    data-dependent shape inside a segment, the same operations every call,
    and (b) once per round with no condition in it."""
    for r in group_runs:
        run = r[mode]
        assert run["grouped"] and run["eager_scans"] == graphs.WARM_UP_SCANS
        (state, diag), (e_state, e_diag) = run["got"], run["want"]
        _assert_bitwise(diag, e_diag)
        _assert_bitwise(state, e_state)
        calls = run["calls"]
        assert len(calls["b"]) == int(diag.icp_iterations[graphs.WARM_UP_SCANS:].sum())
        for key, seen in calls.items():
            ops0, sig0, _ = seen[0]
            for ops, sig, n_conditions in seen:
                assert ops == ops0 and sig == sig0 and n_conditions == 0, key
