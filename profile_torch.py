"""Profile the PyTorch/CUDA port's main path on one GPU.

    python3 profile_torch.py [--scans N] [--out FILE] [--reference-parity] [--batch B]

Runs the 40-scan bench drive (seed 42, 5 m/s, full `OdometryConfig()`, or
`reference_parity(OdometryConfig())` with --reference-parity, where ICP
re-searches the map every round)
through `LidarOdometry(device="cuda")` once to warm up, then again with the
pipeline's stages (deskew, classify, downsample, ICP, map update) wrapped
in device synchronisations to time each stage's wall time over scans
1..39, and profiles N steady-state scans (default 5, scans 30..34) of a
third pass with `torch.profiler`. Prints the card, per-stage ms/scan, wall
time per scan, the device's busy time and idle share over the profiled
window, device kernel launches per scan, each of the port's kernels' launches
per scan and device time per launch, and the operations with the most
device time; with --out, writes the full tables (by device and by host
time) to FILE. With --batch B, the same for the batched step
(parallel/batched.py) with the drive on each of B lanes (as bench.py and
bench_cuda.py broadcast it): every number is then per step of B scans, and
"rounds" are batched rounds (each step's slowest lane). Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time


# the port's kernels by their CUDA function names
KERNELS = ("match_kernel", "gn_step_kernel", "neighborhood_kernel", "group_kernel",
           "search_kernel")


def stage_timer(stage_s: dict, name: str, fn):
    """fn wrapped to add its synchronised wall time to stage_s[name]."""
    import torch

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stage_s[name] += time.perf_counter() - t0
        return out

    return timed


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=5)
    ap.add_argument("--out", help="file for the full profiler tables")
    ap.add_argument("--reference-parity", action="store_true",
                    help="profile the strict reference path (exact-search ICP)")
    ap.add_argument("--batch", type=int, default=0,
                    help="profile the batched step at B lanes (default: one sequence)")
    args = ap.parse_args()
    n_prof = args.scans
    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig, reference_parity
    from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
    from lidar_odometry_demo_tpu_torch.ops import classifier, icp, preprocess
    from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy
    from lidar_odometry_demo_tpu_torch.parallel import batched
    from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = reference_parity(OdometryConfig()) if args.reference_parity else OdometryConfig()
    B = args.batch
    unit = f"step of {B}" if B else "scan"
    print(f"card: {card}; config: "
          f"{'reference_parity' if args.reference_parity else 'default'}"
          + (f"; batched step, B = {B} lanes of the drive" if B else ""))
    dev = torch.device("cuda")
    drive = simulate_sequence(num_scans=40, width=cfg.scan_width, seed=42,
                              speed=5.0, yaw_rate=0.08)
    scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             cfg.max_raw_points, dev) for s in drive.scans]
    if B:
        scans = [LidarScan(*(x[None].expand(B, *x.shape).contiguous() for x in scan))
                 for scan in scans]

    def stepper():
        """A fresh pipeline's step(scan) -> its ICP rounds."""
        if not B:
            odo = LidarOdometry(cfg, device=dev)
            return lambda scan: int(odo.process_scan(scan).icp_iterations)
        step = batched.make_batched_step(cfg)
        state = [batched.init_batched_state(cfg, B, dev)]

        def run(scan):
            state[0], diag = step(state[0], scan)
            return int(diag.icp_iterations.max())
        return run

    warm = stepper()
    for scan in scans:
        warm(scan)

    # stage wall times: the pipeline looks these functions up at call time
    # (make_align when the step is built), so wrapping the module attributes
    # times every call of the next pipeline stepper() builds
    stage_s = collections.Counter()
    patched = [(preprocess, "deskew"), (classifier, "classify"), (vm, "downsample"),
               (vm, "map_update")]
    originals = {(mod, name): getattr(mod, name) for mod, name in patched}
    make_align = icp.make_align
    for mod, name in patched:
        setattr(mod, name, stage_timer(stage_s, name, originals[(mod, name)]))
    icp.make_align = lambda c: stage_timer(stage_s, "icp", make_align(c))
    staged = stepper()
    staged(scans[0])  # the first scan skips ICP
    stage_s.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scan in scans[1:]:
        staged(scan)
    torch.cuda.synchronize()
    staged_wall = time.perf_counter() - t0
    for (mod, name), fn in originals.items():
        setattr(mod, name, fn)
    icp.make_align = make_align
    n_staged = len(scans) - 1
    parts = ", ".join(f"{k} {1e3 * v / n_staged:.3f}" for k, v in stage_s.items())
    print(f"stages (ms per {unit}, synchronised, scans 1..39): {parts}; rest "
          f"{1e3 * (staged_wall - sum(stage_s.values())) / n_staged:.3f}; "
          f"total {1e3 * staged_wall / n_staged:.3f}")

    step = stepper()
    for scan in scans[:30]:
        step(scan)
    torch.cuda.synchronize()

    window = scans[30:30 + n_prof]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rounds = 0
        for scan in window:
            rounds += step(scan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # the device's own events (kernels, copies); operator rows repeat
    # their kernels' time, so they are left out of the sums
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in device)
    launches = sum(e.count for e in device)
    n = len(window)
    print(f"profile: {n} {unit}s, {rounds} ICP rounds, wall {1e3 * wall / n:.3f} ms per {unit} "
          f"(with the profiler on)")
    print(f"profile: device busy {device_us / 1e3 / n:.3f} ms per {unit}, idle share "
          f"{1 - device_us / 1e6 / wall:.4f}, {launches / n:.1f} device kernel launches per "
          f"{unit}")
    # the port's own kernels (K1, K2, K3's three modes), per launch
    for e in device:
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        if name in KERNELS:
            print(f"profile: {name}: {e.count / n:.1f} launches per {unit}, "
                  f"{e.self_device_time_total / e.count / 1e3:.4f} ms per launch")
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    print("\n".join(table.splitlines()[:20]))
    if not args.out:
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"card: {card}; reference_parity: {args.reference_parity}; batch: {B}\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=80))
        f.write("\n\nby host time:\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
