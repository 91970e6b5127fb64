"""The check itself: a run whose timed path is broken underneath comes out
not correct, once for each fault a cell can have, and a sound run comes
out correct, on several seeds. On the CPU at TINY on 12-scan drives, the
harness's look for a card skipped."""

import time

import pytest
import torch

import _paths  # noqa: F401
import harness
import run

from lidar_odometry_demo_tpu_torch.config import TINY

SIZES = {k: getattr(TINY, k) for k in ("scan_width", "max_raw_points", "max_planar_points",
                                       "max_match_points", "max_update_points",
                                       "map_capacity")}
TRAFFIC = {"scans_per_drive": 12}


def _run(name, fault, seed):
    torch.set_num_threads(2)
    cell = harness.load_cell(name, overrides={"odometry": SIZES, "traffic": TRAFFIC})
    raw = harness.run_cell(cell, seed, 2.0, False, "cpu", time.perf_counter(), fault=fault)
    return run.result(cell, raw, False, "cpu")


CASES = [("vlp16.replay", None), ("vlp16.replay", "stale"), ("vlp16.replay", "alter"),
         ("vlp16.fleet8", None), ("vlp16.fleet8", "stale"), ("vlp16.fleet8", "alter"),
         ("vlp16.fleet8", "half")]
# a small seed, another, and one past 32 signed bits
SEEDS = [5, 12, 2**31 + 7]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f or 'sound'}" for n, f in CASES])
def test_fault_is_not_correct(name, fault, seed):
    out = _run(name, fault, seed)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
