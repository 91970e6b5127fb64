"""Benchmark of the PyTorch/CUDA port: full-pipeline VLP16 odometry
throughput on one GPU (the port's counterpart of bench.py).

    python3 bench_cuda.py [--batch B]

Drives the 40-scan bench drive (seed 42, 5 m/s, 0.08 rad/s) at the full
`OdometryConfig()` through the port's sequence runner on "cuda":

- single sequence: one warm-up pass, then 3 timed passes from a fresh
  state, each timed with CUDA events and ended by a synchronisation; the
  best pass counts;
- batched: the same drive on every one of B lanes (default 8) through the
  batched sequence runner, one warm-up pass and 2 timed passes, the best
  counting.

Prints per-pass lines on stderr and ONE JSON line on stdout with
bench.py's keys (`single_seq_scans_per_sec`, `aligned_ate_m`,
`ate_vs_pinned_reference_m`, `map_occupancy_voxels`, `map_capacity`,
`batched_x{B}_scans_per_sec`, `batched_vs_single_ratio`, and the headline
`metric` / `value` / `unit` / `vs_baseline`, the single-sequence rate over
the 10 scans/s of a real-time VLP16) and the card's name and power limit.
Exits non-zero, with no JSON line, when no CUDA device is present or any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_SCANS = 40


def log(msg: str) -> None:
    print(f"bench_cuda: {msg}", file=sys.stderr, flush=True)


def timed_ms(fn) -> tuple[float, object]:
    """(ms, result) of one call of fn, by CUDA events, ended by a
    synchronisation."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8, help="lanes of the batched phase")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
    from lidar_odometry_demo_tpu_torch.io.trajectory import ate_rmse, read_tum
    from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy
    from lidar_odometry_demo_tpu_torch.parallel import batched
    from lidar_odometry_demo_tpu_torch.pipeline import odometry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}")
    dev = torch.device("cuda")
    cfg = OdometryConfig()
    drive = simulate_sequence(num_scans=NUM_SCANS, width=cfg.scan_width, seed=42, speed=5.0,
                              yaw_rate=0.08)
    scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             cfg.max_raw_points, dev) for s in drive.scans]

    # single sequence
    run = odometry.make_sequence_runner(cfg)
    run(odometry.init_state(cfg, dev), scans)  # warm-up (and the kernels' build)
    times = []
    for rep in range(3):
        state0 = odometry.init_state(cfg, dev)
        ms, (state, diags) = timed_ms(lambda: run(state0, scans))
        times.append(ms)
        log(f"single rep {rep}: {ms / NUM_SCANS:.3f} ms/scan")
    scans_per_sec = NUM_SCANS / (min(times) / 1e3)
    est = diags.pose.t.cpu().numpy()
    if est.shape != (NUM_SCANS, 3) or not np.all(np.isfinite(est)):
        raise AssertionError("single sequence: non-finite or misshapen poses")
    g0 = drive.gt_q[0]
    gt_rel = Rotation.from_quat([g0[1], g0[2], g0[3], g0[0]]).inv().apply(
        drive.gt_t - drive.gt_t[0])
    ate = ate_rmse(est, gt_rel, align=True)
    _, ref_t, _ = read_tum(os.path.join(REPO, "benchmarks", "BASELINE_REF.tum"))
    ate_vs_ref = ate_rmse(est, ref_t, align=True)
    occupancy = int(vm.map_size(state.keyframe))
    log(f"single-seq {scans_per_sec:.2f} scans/s ({min(times) / NUM_SCANS:.3f} ms/scan), "
        f"aligned ATE {ate:.5f} m vs GT, {ate_vs_ref:.5f} m vs pinned reference trajectory, "
        f"matches(last)={int(diags.num_matches[-1])}")

    # batched: the drive broadcast to every lane
    B = args.batch
    scans_b = LidarScan(*(
        torch.stack([getattr(s, f) for s in scans])[:, None].expand(
            NUM_SCANS, B, *getattr(scans[0], f).shape).contiguous()
        for f in LidarScan._fields))
    run_b = batched.make_batched_sequence_runner(cfg)
    run_b(batched.init_batched_state(cfg, B, dev), scans_b)  # warm-up
    tb = []
    for rep in range(2):
        state_b0 = batched.init_batched_state(cfg, B, dev)
        ms, (_, diags_b) = timed_ms(lambda: run_b(state_b0, scans_b))
        tb.append(ms)
        log(f"batched x{B} rep {rep}: {ms / NUM_SCANS:.3f} ms/step-of-{B}")
    batched_sps = NUM_SCANS * B / (min(tb) / 1e3)
    lane_t = diags_b.pose.t.cpu().numpy()
    if not np.all(np.isfinite(lane_t)):
        raise AssertionError("batched: non-finite poses")
    lane_err = float(np.abs(lane_t - est[:, None]).max())
    log(f"batched x{B}: {batched_sps:.2f} scans/s aggregate ({min(tb) / NUM_SCANS:.3f} "
        f"ms/step-of-{B}); lanes' largest distance from the single-sequence poses "
        f"{lane_err:.3g} m")

    print(json.dumps({
        "metric": "vlp16_full_pipeline_scans_per_sec_per_chip",
        "value": round(scans_per_sec, 2),
        "unit": "scans/s",
        "vs_baseline": round(scans_per_sec / 10.0, 2),
        "single_seq_scans_per_sec": round(scans_per_sec, 2),
        "aligned_ate_m": round(float(ate), 5),
        "ate_vs_pinned_reference_m": round(float(ate_vs_ref), 5),
        "map_occupancy_voxels": occupancy,
        "map_capacity": cfg.map_capacity,
        f"batched_x{B}_scans_per_sec": round(batched_sps, 2),
        "batched_vs_single_ratio": round(batched_sps / scans_per_sec, 3),
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
