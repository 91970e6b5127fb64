"""The captured step (pipeline/graphs.py) on the card, against the eager
step on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it runs on a GPU machine
without JAX, with the repository's conftest left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_graphs_card.py

Tolerances: none. The captured step replays the eager step's kernels and
operations on the same inputs, so on a TINY drive (one sequence, B = 2
lanes, reference_parity) its diagnostics and final state are bitwise the
eager step's, and the kernels' launch counters, which count a graph's
launches at every replay, read what the eager drive's read.
"""

import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu_torch.config import TINY, reference_parity
from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu_torch.kernels.correspondence import match_rows
from lidar_odometry_demo_tpu_torch.kernels.jtwj import GnWork, gn_step, jtwj_accumulate
from lidar_odometry_demo_tpu_torch.kernels.search import search_sorted
from lidar_odometry_demo_tpu_torch.ops import se3
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy
from lidar_odometry_demo_tpu_torch.ops.voxel_map import Correspondence
from lidar_odometry_demo_tpu_torch.parallel import batched
from lidar_odometry_demo_tpu_torch.pipeline import graphs, odometry
from lidar_odometry_demo_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.cuda
COUNTERS = (match_rows, jtwj_accumulate, search_sorted)
N_SCANS = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scans(dev, seeds):
    """A TINY drive per seed on `dev`; with several seeds, stacked as lanes."""
    per = []
    for seed in seeds:
        d = simulate_sequence(num_scans=N_SCANS, width=TINY.scan_width, seed=seed, speed=2.0,
                              yaw_rate=0.05, ramp_time=0.0)
        per.append([scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                                    TINY.max_raw_points, dev) for s in d.scans])
    if len(per) == 1:
        return per[0]
    return [LidarScan(*(torch.stack([getattr(p[i], f) for p in per])
                        for f in LidarScan._fields)) for i in range(N_SCANS)]


def _drive(step, state, scans):
    """(final state, stacked diagnostics, launches) of the drive."""
    for fn in COUNTERS:
        fn.launches = 0
    diags = []
    for scan in scans:
        state, diag = step(state, scan)
        diags.append(diag)
    torch.cuda.synchronize()
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
