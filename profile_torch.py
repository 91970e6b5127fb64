"""Profile the PyTorch/CUDA port's main path on one GPU.

    python3 profile_torch.py [--scans N] [--out FILE] [--reference-parity] [--batch B]
                             [--eager]

Runs the 40-scan bench drive (seed 42, 5 m/s, full `OdometryConfig()`, or
`reference_parity(OdometryConfig())` with --reference-parity, where ICP
re-searches the map every round) through the step a user calls,
`LidarOdometry(device="cuda")` (on the card, the step replayed from CUDA
graphs, pipeline/graphs.py), or with --eager through the eager step
(`make_process_scan`, every operation launched from Python). Passes:

1. a warm-up pass;
2. the pipeline's stages (deskew, classify, downsample, ICP, map update)
   wrapped in device synchronisations, through the eager step (a
   synchronisation cannot sit inside a captured graph), each stage's wall
   time over scans 1..39;
3. a fresh pass measured by `measure` from scan 30 - N on: a timed window
   of N scans (host clock, ended by a synchronisation) counting the synchronising
   calls (torch's sync debug mode warnings, plus the step's own waits on
   its pinned host copies, `HostFlags.waits`, which that mode does not
   see), then as many further scans under `torch.profiler`: host launches
   (the CUDA runtime's launch, graph-launch, copy and set calls), device
   operations (kernels, copies, sets), the device's busy time and its idle
   share, against the profiled window's wall time (which the profiler
   slows) and against the timed window's.

Prints the card, per-stage ms/scan, the window's ms/scan, synchronising
calls, host launches, device operations, busy ms and idle share per scan,
each of the port's kernels' launches per scan and device time per launch,
and the operations with the most device time; with --out, writes the full
tables (by device and by host time) to FILE. With --batch B, the same for
the batched step (parallel/batched.py) with the drive on each of B lanes
(as bench.py and bench_cuda.py broadcast it): every number is then per
step of B scans, and "rounds" are batched rounds (each step's slowest
lane). The script reaches the package through its public entry points
only, so it runs unchanged against an earlier checkout of the package.
Exits non-zero without a CUDA device.
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


# the CUDA runtime calls that put work on a stream from the host
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                     "cuMemcpy", "cudaMemset", "cuMemset")


def measure(step, scans, profile_window: bool = True) -> dict:
    """step(scan) -> the scan's ICP iterations (a device tensor, read after
    the window so that the harness adds no synchronisation), over `scans`
    (a warmed pipeline): per scan,
    the host-clock ms of a window ended by a synchronisation and the
    synchronising calls in it (sync debug mode warnings + `HostFlags.waits`
    where the package has it); then, with `profile_window`, the profiler's
    host launches, device operations, busy ms and idle share over the same
    number of further scans (the caller passes twice the window's scans).
    Returns the numbers and the profiler's events."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lidar_odometry_demo_tpu_torch import device as device_mod

    flags = getattr(device_mod, "HostFlags", None)
    half = len(scans) // 2 if profile_window else len(scans)
    timed, profiled = scans[:half], scans[half:]
    torch.cuda.synchronize()
    waits0 = flags.waits if flags is not None else 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            iters = [step(scan) for scan in timed]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n = len(timed)
    waits = (flags.waits - waits0) if flags is not None else 0
    # one warning per synchronising call (the mode's own notice aside)
    warned = sum("called a synchronizing" in str(w.message) for w in caught)
    rounds = sum(int(x.max()) for x in iters)  # a step's rounds are its slowest lane's
    out = dict(scans=n, rounds=rounds, ms=1e3 * wall / n, sync_warnings=warned / n,
               waits=waits / n, syncs=(warned + waits) / n)
    if not profile_window:
        return out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iters = [step(scan) for scan in profiled]
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    p_rounds = sum(int(x.max()) for x in iters)
    events = prof.key_averages()
    # the device's own events (kernels, copies); operator rows repeat
    # their kernels' time, so they are left out of the sums
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in device)
    launches = {e.key: e.count for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith(HOST_LAUNCH_CALLS)}
    m = len(profiled)
    out.update(profiled_scans=m, profiled_rounds=p_rounds, profiled_ms=1e3 * p_wall / m,
               host_launches=sum(launches.values()) / m,
               host_launch_calls={k: v / m for k, v in sorted(launches.items())},
               device_ops=sum(e.count for e in device) / m, busy_ms=device_us / 1e3 / m,
               idle_share=1 - device_us / 1e6 / p_wall, events=events, device_events=device)
    # the profiler slows the host, so the same busy time against the timed
    # window's ms (another window of the same steady drive) as well
    out["idle_share_timed"] = 1 - out["busy_ms"] / out["ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=5)
    ap.add_argument("--out", help="file for the full profiler tables")
    ap.add_argument("--reference-parity", action="store_true",
                    help="profile the strict reference path (exact-search ICP)")
    ap.add_argument("--batch", type=int, default=0,
                    help="profile the batched step at B lanes (default: one sequence)")
    ap.add_argument("--eager", action="store_true",
                    help="the eager step (make_process_scan) in place of the entry point's")
    args = ap.parse_args()
    n_prof = args.scans
    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig, reference_parity
    from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
    from lidar_odometry_demo_tpu_torch.ops import classifier, icp, preprocess
    from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy
    from lidar_odometry_demo_tpu_torch.parallel import batched
    from lidar_odometry_demo_tpu_torch.pipeline import odometry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = reference_parity(OdometryConfig()) if args.reference_parity else OdometryConfig()
    B = args.batch
    unit = f"step of {B}" if B else "scan"
    print(f"card: {card}; config: "
          f"{'reference_parity' if args.reference_parity else 'default'}; step: "
          f"{'eager' if args.eager else 'the entry point'}"
          + (f"; batched step, B = {B} lanes of the drive" if B else ""))
    dev = torch.device("cuda")
    drive = simulate_sequence(num_scans=40, width=cfg.scan_width, seed=42,
                              speed=5.0, yaw_rate=0.08)
    scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             cfg.max_raw_points, dev) for s in drive.scans]
    if B:
        scans = [LidarScan(*(x[None].expand(B, *x.shape).contiguous() for x in scan))
                 for scan in scans]

    def stepper(eager: bool):
        """A fresh pipeline's step(scan) -> its ICP iterations (on the device)."""
        if eager:
            step = odometry.make_process_scan(cfg)
        elif B:
            step = batched.make_batched_step(cfg)
        else:
            odo = odometry.LidarOdometry(cfg, device=dev)
            return lambda scan: odo.process_scan(scan).icp_iterations
        state = [batched.init_batched_state(cfg, B, dev) if B
                 else odometry.init_state(cfg, dev)]

        def run(scan):
            state[0], diag = step(state[0], scan)
            return diag.icp_iterations
        return run

    warm = stepper(args.eager)
    for scan in scans:
        warm(scan)

    # stage wall times: the pipeline looks these functions up at call time
    # (make_align when the step is built), so wrapping the module attributes
    # times every call of the next eager step stepper() builds
    stage_s = collections.Counter()
    patched = [(preprocess, "deskew"), (classifier, "classify"), (vm, "downsample"),
               (vm, "map_update")]
    originals = {(mod, name): getattr(mod, name) for mod, name in patched}
    make_align = icp.make_align
    for mod, name in patched:
        setattr(mod, name, stage_timer(stage_s, name, originals[(mod, name)]))
    icp.make_align = lambda c: stage_timer(stage_s, "icp", make_align(c))
    staged = stepper(eager=True)
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
    print(f"stages (eager step, ms per {unit}, synchronised, scans 1..39): {parts}; rest "
          f"{1e3 * (staged_wall - sum(stage_s.values())) / n_staged:.3f}; "
          f"total {1e3 * staged_wall / n_staged:.3f}")

    step = stepper(args.eager)
    for scan in scans[:30 - n_prof]:
        step(scan)
    m = measure(step, scans[30 - n_prof:30 + n_prof])
    n = m["profiled_scans"]
    print(f"window: {m['scans']} {unit}s, {m['rounds']} ICP rounds, {m['ms']:.3f} ms per "
          f"{unit} (host clock, no profiler); synchronising calls per {unit} {m['syncs']:.2f} "
          f"(sync debug warnings {m['sync_warnings']:.2f}, step waits {m['waits']:.2f})")
    print(f"profile: {n} {unit}s, {m['profiled_rounds']} ICP rounds, wall "
          f"{m['profiled_ms']:.3f} ms per {unit} (with the profiler on)")
    print(f"profile: device busy {m['busy_ms']:.3f} ms per {unit}, idle share "
          f"{m['idle_share']:.4f} ({m['idle_share_timed']:.4f} against the window's "
          f"{m['ms']:.3f} ms), {m['device_ops']:.1f} device operations and "
          f"{m['host_launches']:.1f} host launches per {unit} "
          f"{ {k: round(v, 1) for k, v in m['host_launch_calls'].items()} }")
    # the port's own kernels (K1, K2, K3's three modes), per launch
    for e in m["device_events"]:
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        if name in KERNELS:
            print(f"profile: {name}: {e.count / n:.1f} launches per {unit}, "
                  f"{e.self_device_time_total / e.count / 1e3:.4f} ms per launch")
    events = m["events"]
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    print("\n".join(table.splitlines()[:20]))
    if not args.out:
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"card: {card}; reference_parity: {args.reference_parity}; batch: {B}; "
                f"eager: {args.eager}\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=80))
        f.write("\n\nby host time:\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
