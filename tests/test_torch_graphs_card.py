"""The captured step (pipeline/graphs.py) on the card, against the eager
step on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it runs on a GPU machine
without JAX, with the repository's conftest left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_graphs_card.py

Tolerances: none. The captured step replays the eager step's kernels and
operations on the same inputs, its ICP rounds under a WHILE node on the
device, so on a TINY drive (one sequence, B = 2 lanes, reference_parity)
and at full width (the 35-round budget run out at every scan; B = 3 lanes
that stop at different rounds) its diagnostics and final state are
bitwise the eager step's, and the kernels' launch counters, which count a
graph's launches at every launch and the loop's rounds when they are
settled, read what the eager drive's read, the loop's condition among
them (the eager step's loop launches it as the WHILE node does). The
loop's condition kernel is bitwise its plain version.
"""

import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu_torch.config import TINY, OdometryConfig, reference_parity
from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu_torch.kernels.correspondence import match_rows
from lidar_odometry_demo_tpu_torch.kernels.jtwj import GnWork, gn_step, jtwj_accumulate
from lidar_odometry_demo_tpu_torch.kernels.loop import loop_condition, loop_condition_plain
from lidar_odometry_demo_tpu_torch.kernels.search import search_sorted
from lidar_odometry_demo_tpu_torch.ops import se3
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy
from lidar_odometry_demo_tpu_torch.ops.voxel_map import Correspondence
from lidar_odometry_demo_tpu_torch.parallel import batched
from lidar_odometry_demo_tpu_torch.pipeline import graphs, odometry
from lidar_odometry_demo_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.cuda
COUNTERS = (match_rows, jtwj_accumulate, search_sorted, loop_condition)
N_SCANS = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scans(dev, seeds, cfg=TINY, n_scans=N_SCANS, speeds=None):
    """A drive per seed on `dev` at the width of `cfg` (TINY's at 2 m/s, or
    one speed per seed); with several seeds, stacked as lanes."""
    per = []
    for k, seed in enumerate(seeds):
        d = simulate_sequence(num_scans=n_scans, width=cfg.scan_width, seed=seed,
                              speed=speeds[k] if speeds else 2.0, yaw_rate=0.05, ramp_time=0.0)
        per.append([scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                                    cfg.max_raw_points, dev) for s in d.scans])
    if len(per) == 1:
        return per[0]
    return [LidarScan(*(torch.stack([getattr(p[i], f) for p in per])
                        for f in LidarScan._fields)) for i in range(n_scans)]


def _drive(step, state, scans):
    """(final state, stacked diagnostics, launches) of the drive."""
    graphs.settle_launches()
    for fn in COUNTERS:
        fn.launches = 0
    diags = []
    for scan in scans:
        state, diag = step(state, scan)
        diags.append(diag)
    torch.cuda.synchronize()
    graphs.settle_launches()
    return (graphs._map(torch.clone, state), odometry.stack_diagnostics(diags),
            [fn.launches for fn in COUNTERS])


def _assert_bitwise(a, b):
    la, lb = graphs._leaves(a), graphs._leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("case", ["single", "lanes", "parity"])
def test_captured_step_is_the_eager_step(dev, case):
    """The captured step bitwise the eager step on a TINY drive, its graphs
    replayed from the third scan on, and the launch counters equal."""
    cfg = reference_parity(TINY) if case == "parity" else TINY
    scans = _scans(dev, (3, 6) if case == "lanes" else (3,))
    if case == "lanes":
        state = lambda: batched.init_batched_state(cfg, 2, dev)  # noqa: E731
    else:
        state = lambda: odometry.init_state(cfg, dev)  # noqa: E731
    e_state, e_diag, e_launches = _drive(odometry.make_process_scan(cfg), state(), scans)
    captured = graphs.CapturedStep(cfg)
    c_state, c_diag, c_launches = _drive(captured, state(), scans)
    (lane_graphs,) = captured._lanes.values()
    assert lane_graphs.segments is not None
    assert lane_graphs.eager_scans == graphs.WARM_UP_SCANS
    _assert_bitwise(c_diag, e_diag)
    _assert_bitwise(c_state, e_state)
    assert c_launches == e_launches and min(c_launches) > 0


def test_runners_replay_graphs(dev):
    """make_sequence_runner and the batched runner on CUDA tensors replay
    the captured step (bitwise the eager drive), and the state they return
    is not the step's buffers."""
    scans = _scans(dev, (3,))
    _, e_diag, _ = _drive(odometry.make_process_scan(TINY), odometry.init_state(TINY, dev),
                          scans)
    state, diag = odometry.make_sequence_runner(TINY)(odometry.init_state(TINY, dev), scans)
    _assert_bitwise(diag, e_diag)
    lanes = LidarScan(*(torch.stack([getattr(s, f)[None] for s in scans])
                        for f in LidarScan._fields))
    _, b_diag = batched.make_batched_sequence_runner(TINY)(
        batched.init_batched_state(TINY, 1, dev), lanes)
    assert torch.equal(b_diag.pose.t[:, 0], e_diag.pose.t)
    assert torch.equal(b_diag.icp_iterations[:, 0], e_diag.icp_iterations)


def test_checkpoint_loaded_into_state_is_read_by_the_graphs(dev, tmp_path):
    """A checkpoint assigned to `LidarOdometry.state` after the capture is
    copied into the graphs' buffers: the next scans are bitwise the run it
    was saved from."""
    scans = _scans(dev, (3,))
    odo = odometry.LidarOdometry(TINY, device=dev)
    for scan in scans[:4]:
        odo.process_scan(scan)
    checkpoint.save_npz(tmp_path / "state.npz", odo.state)
    resumed = odometry.LidarOdometry(TINY, device=dev)
    for scan in scans[3::-1]:  # another state in the buffers, captured
        resumed.process_scan(scan)
    resumed.state = checkpoint.load_npz(tmp_path / "state.npz", device=dev)
    for scan in scans[4:]:
        _assert_bitwise(resumed.process_scan(scan), odo.process_scan(scan))
    _assert_bitwise(resumed.state, odo.state)


def test_a_held_state_is_not_rewritten(dev):
    """A state kept across a captured scan, through `LidarOdometry.state`
    or a batched step's `own`, reads after that scan what it read before."""
    scans = _scans(dev, (3,))
    odo = odometry.LidarOdometry(TINY, device=dev)
    step = batched.make_batched_step(TINY)
    state = batched.init_batched_state(TINY, 1, dev)
    for scan in scans[:4]:  # captured at the third
        odo.process_scan(scan)
        state, _ = step(state, LidarScan(*(x[None] for x in scan)))
    held = [odo.state, step.own(state)]
    kept = [graphs._map(torch.clone, h) for h in held]
    odo.process_scan(scans[4])
    state, _ = step(state, LidarScan(*(x[None] for x in scans[4])))
    for h, k in zip(held, kept):
        _assert_bitwise(h, k)
    assert not torch.equal(odo.state.current.t, kept[0].current.t)
    assert not torch.equal(state.current.t, kept[1].current.t)


def test_k2_active_all_true_is_active_none(dev):
    """K2's kernel with `active` all true is bitwise the kernel without it."""
    rng = np.random.default_rng(5)
    Q = 1000
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    nrm = rng.normal(size=(2, Q, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    corr = Correspondence(up(rng.normal(size=(2, Q, 3)).astype(np.float32)),
                          up(rng.normal(size=(2, Q, 3)).astype(np.float32)), up(nrm),
                          up(rng.random((2, Q)) < 0.9))
    pose = se3.Pose(torch.zeros((2, 3), device=dev),
                    torch.tensor([[1.0, 0, 0, 0]] * 2, device=dev))
    got = gn_step(corr, pose, pose.t, TINY, work=GnWork.empty(1, dev, (2,)),
                  step_norm=torch.full((2,), 3.0, device=dev),
                  active=torch.ones(2, dtype=torch.bool, device=dev))
    want = gn_step(corr, pose, pose.t, TINY, work=GnWork.empty(1, dev, (2,)))
    for x, y in zip(graphs._leaves(got), graphs._leaves(want)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["cap", "frozen_lanes"])
def test_device_loop_is_the_eager_step_at_full_width(dev, case):
    """At full width (`OdometryConfig()`), the captured step, its ICP loop
    a WHILE node on the device, bitwise the eager step (its loop on the
    host) and the launch counters equal. `cap`: one sequence with the
    convergence tolerance 0 and no stall exit, so every scan runs out the
    35-round budget; `frozen_lanes`: B = 3 drives at 1, 5 and 10 m/s with
    the convergence tolerance 0, so each lane runs until its stall exit
    (converged, every lane of such drives stops at the minimum of 4 rounds),
    and the lanes stop at different rounds within a step (checked)."""
    base = OdometryConfig()
    if case == "cap":
        cfg = base.replace(icp_convergence_step_norm=0.0,
                           icp_stall_exit_rounds=base.icp_max_outer_iterations + 1)
        scans = _scans(dev, (42,), cfg, n_scans=5)
        state = lambda: odometry.init_state(cfg, dev)  # noqa: E731
    else:
        cfg = base.replace(icp_convergence_step_norm=0.0)
        scans = _scans(dev, (42, 43, 44), cfg, n_scans=6, speeds=(1.0, 5.0, 10.0))
        state = lambda: batched.init_batched_state(cfg, 3, dev)  # noqa: E731
    e_state, e_diag, e_launches = _drive(odometry.make_process_scan(cfg), state(), scans)
    captured = graphs.CapturedStep(cfg)
    c_state, c_diag, c_launches = _drive(captured, state(), scans)
    (lane_graphs,) = captured._lanes.values()
    assert lane_graphs.loop_graph is not None
    _assert_bitwise(c_diag, e_diag)
    _assert_bitwise(c_state, e_state)
    assert c_launches == e_launches and min(c_launches) > 0
    iters = c_diag.icp_iterations[graphs.WARM_UP_SCANS:]  # the captured scans
    if case == "cap":
        assert bool((iters == base.icp_max_outer_iterations).all())
    else:
        assert bool((iters.amax(dim=-1) > iters.amin(dim=-1)).any()), iters


def test_loop_condition_is_its_plain_version(dev):
    """The loop's condition kernel bitwise its plain version on the card,
    one launch per call, for one sequence, 8 lanes and 300 (more lanes than
    the kernel's block has threads), on carries around every threshold
    (rounds 0-36 against the minimum 4 and the cap 35, stall 0-4 against
    3, step norms at and beside the tolerance, read at K2's lane stride)."""
    cfg = OdometryConfig()
    rng = np.random.default_rng(9)
    tol = np.float32(cfg.icp_convergence_step_norm)
    norms = np.array([0.0, np.nextafter(tol, np.float32(0)), tol, np.nextafter(tol, np.float32(1)),
                      2e-4, 1e9], np.float32)
    up = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    for lead in ((), (8,), (300,)):
        iters = up(rng.integers(0, 37, lead).astype(np.int32))
        stall = up(rng.integers(0, 5, lead).astype(np.int32))
        work = GnWork.empty(4, dev, lead)
        norm = work.slots[-1][1]
        norm.copy_(up(rng.choice(norms, lead)))
        out = torch.empty(lead, dtype=torch.bool, device=dev)
        before = loop_condition.launches
        got = loop_condition(iters, stall, norm, cfg, out=out)
        assert loop_condition.launches == before + 1 and got is out
        want = loop_condition_plain(iters, stall, norm, cfg)
        assert torch.equal(got, want)
        assert not lead or 0 < int(want.sum()) < want.numel()  # both outcomes seen
