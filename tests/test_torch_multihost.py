"""Port parity for multi-process execution (parallel/multihost.py) and the
sharded checkpoint (utils/checkpoint.py `save_sharded` / `load_sharded`).

The port's ranks run on gloo CPU process groups: one `run_ranks` call per
world size (2 and 4) runs the demo worker and every checkpoint case once (a
module-scoped fixture); the JAX side runs in this process. TINY, 4-5 scans.

Bars:
- the demo worker (the dp fleet over all ranks, one lane each): every lane
  bitwise the single-sequence run on its rank, the final pose within 1e-5 m
  of the JAX package's single run of the same drive, rank 0's report
  written with the JAX report's keys;
- the checkpoint: a run stopped after 3 of 5 scans, saved by every rank,
  loaded into fresh states and run on continues bitwise as the
  uninterrupted run (the spatial mode with a column shard per rank, and the
  dp mode with a lane per rank).
"""

import json

import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.pipeline import odometry as jodo
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy as port_scan
from lidar_odometry_demo_tpu_torch.parallel import batched, multihost, spatial
from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib
from lidar_odometry_demo_tpu_torch.pipeline import odometry as todo
from lidar_odometry_demo_tpu_torch.utils.checkpoint import load_sharded, save_sharded

N_SCANS = 5
STOP = 3          # the interrupted runs save after this many scans
DEMO_SCANS = 4
TIMEOUT = 300.0


def _drive(seed=3, n=N_SCANS):
    d = simulate_sequence(num_scans=n, width=TINY.scan_width, seed=seed, speed=2.0,
                          yaw_rate=0.05)
    return [(s["xyz"], s["intensity"], s["ring"], s["time"]) for s in d.scans]


def _run_from(step, state, scans):
    t = []
    for scan in scans:
        state, d = step(state, scan)
        t.append(d.pose.t)
    return state, t


def _resume_case(step, fresh, scans, path, mesh):
    """The uninterrupted run of `scans`, and the run stopped after STOP
    scans, saved to `path` by every rank, loaded into `fresh()` and run on.
    Returns (final state, trajectory) of both."""
    full, t_full = _run_from(step, fresh(), scans)
    stopped, _ = _run_from(step, fresh(), scans[:STOP])
    save_sharded(path, stopped, mesh)
    resumed, t_rest = _run_from(step, load_sharded(path, fresh(), mesh), scans[STOP:])
    return full, t_full, resumed, t_rest


def _multihost_ranks(n, drive, ckpt_dir, report_path):
    """The demo worker and both checkpoint cases on one rank of n."""
    out = {"demo": multihost.demo_worker(report_path, n_scans=DEMO_SCANS, reps=1)}
    scans = [port_scan(*r, TINY.max_raw_points, "cpu") for r in drive]

    # the spatial mode: the map in n column shards
    m = mesh_lib.make_mesh(1, n, "cpu")
    step = todo.make_process_scan(TINY, spatial_group=m.sp)

    def fresh():
        return spatial.init_spatial_state(TINY, n, "cpu")

    cases = {"spatial": _resume_case(step, fresh, scans, f"{ckpt_dir}/spatial", m)}

    # the dp mode: one lane per rank, the same drive on every lane
    dm = mesh_lib.make_mesh(n, 1, "cpu")
    step_b = batched.make_batched_step(TINY, dm)
    scans_b = [LidarScan(*(x[None] for x in s)) for s in scans]

    def fresh_b():
        return batched.init_batched_state(TINY, 1, "cpu")

    cases["dp"] = _resume_case(step_b, fresh_b, scans_b, f"{ckpt_dir}/dp", dm)

    for name, (full, t_full, resumed, t_rest) in cases.items():
        out[name] = dict(
            full={f: getattr(full.keyframe, f) for f in ("keys", "count", "origin", "tab")}
            | {"t": torch.stack(t_full), "current_q": full.current.q,
               "previous_t": full.previous.t},
            resumed={f: getattr(resumed.keyframe, f) for f in ("keys", "count", "origin", "tab")}
            | {"t": torch.stack(t_rest), "current_q": resumed.current.q,
               "previous_t": resumed.previous.t})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{n: (reports' directory, [rank 0's results, ...])} for n = 2 and 4."""
    drive = _drive()
    out = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"ranks{n}")
        out[n] = (d, mesh_lib.run_ranks(_multihost_ranks, n, n, drive, str(d),
                                        str(d / "report.json"), device="cpu",
                                        timeout=TIMEOUT))
    return out


@pytest.fixture(scope="module")
def jax_single_t():
    """The JAX package's single run of the demo's drive: its final t."""
    single = jodo.LidarOdometry(JTINY)
    for r in _drive(n=DEMO_SCANS):
        single.process_scan(jax_scan(*r, JTINY.max_raw_points))
    return np.asarray(single.state.current.t)


@pytest.mark.parametrize("n", [2, 4])
def test_demo_worker_matches_jax_single(ranks, jax_single_t, n):
    d, outs = ranks[n]
    report = json.loads((d / "report.json").read_text())
    assert report == outs[0]["demo"]
    for key in ("scaling", "machine_utilization_ratio", "scaling_efficiency_core_ceiling",
                "n_scans", "lanes", "max_lane_vs_single_dt", "final_t"):
        assert key in report, key
    assert report["scaling"]["devices"] == n and report["lanes"] == n
    assert report["backend"] == "gloo" and report["n_scans"] == DEMO_SCANS
    assert report["max_lane_vs_single_dt"] == 0.0
    np.testing.assert_allclose(report["final_t"], jax_single_t, atol=1e-5, rtol=0)
    for o in outs[1:]:  # every rank ran its lane the same way
        assert o["demo"]["final_t"] == report["final_t"]


@pytest.mark.parametrize("mode", ["spatial", "dp"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_checkpoint_resumes_bitwise(ranks, n, mode):
    d, outs = ranks[n]
    assert (d / mode).is_dir()
    for o in outs:
        full, resumed = o[mode]["full"], o[mode]["resumed"]
        for f in ("keys", "count", "origin", "tab", "current_q", "previous_t"):
            np.testing.assert_array_equal(resumed[f], full[f], err_msg=f)
        np.testing.assert_array_equal(resumed["t"], full["t"][STOP:])
    if mode == "spatial":  # each rank saved and resumed its own shard
        keys = [o[mode]["full"]["keys"] for o in outs]
        assert all(not np.array_equal(keys[0], k) for k in keys[1:])
