"""The benchmark's cells: set-up, the measured window, the traced span and
the check against the plain reference, for the loop kinds the traffic
files name (`replay`, `fleet`), on one card.

A cell is found by name: `BENCHMARK.json` gives its configuration and
traffic, `configs/<config>.json` and `traffic/<traffic>.json` hold them,
`limits/<cell>.json` the limits of its check, `metrics/<metric>.py` one
reader per per-layer metric and `roofline/<kernel>.py` one kernel's bytes
and operations. A configuration may name its sensor, `"sensor": {"name",
"rings", "elevation_deg"}` (R elevations, lowest ring first); one that
names none is the VLP16. Nothing here names a cell.

The program under test is the port, `lidar_odometry_demo_tpu_torch`; the
harness drives it through its public entry points only (`LidarOdometry`,
`make_batched_sequence_runner`) and reads its public counters.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import checks  # noqa: E402
import devtrace  # noqa: E402
import gen  # noqa: E402
from reference import odometry as ref_odometry  # noqa: E402

# the kernels whose launches the traced span is held to (K1, K2)
CHECKED_KERNELS = ("match_kernel", "gn_step_kernel")


# ----------------------------------------------------------------- loading

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A reader or count module, loaded by file name."""
    spec = importlib.util.spec_from_file_location(f"odobench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_functions(mod) -> tuple:
    """The CUDA functions of a `roofline/<kernel>.py`: its `KERNEL`, or its
    `KERNELS` where one call launches each of several once."""
    return tuple(getattr(mod, "KERNELS", None) or (mod.KERNEL,))


def trace_kernels() -> tuple:
    """The kernels a trace summary counts: K1 and K2, and every CUDA
    function of every `roofline/<kernel>.py`."""
    names = {f for p in sorted((HERE / "roofline").glob("*.py"))
             for f in kernel_functions(load_module(p))}
    return tuple(sorted(names | set(CHECKED_KERNELS)))


class Cell(SimpleNamespace):
    """One workload of BENCHMARK.json with its files."""


def load_cell(name: str, bench_path: Path | None = None, overrides: dict | None = None) -> Cell:
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{work['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{work['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    overrides = overrides or {}
    config["odometry"] = {**config["odometry"], **overrides.get("odometry", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return Cell(name=name, chips=work["chips"], config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer,
                elevation_deg=elevation_table(config, work["config"]))


def elevation_table(config: dict, name: str) -> list:
    """The configuration's beam elevations (degrees, lowest ring first): its
    `sensor`'s table, or the VLP16's; refused unless it has `num_rings`
    entries, rises, and its R x W beams fit `max_raw_points`."""
    odo = config["odometry"]
    sensor = config.get("sensor")
    table = (list(sensor["elevation_deg"]) if sensor is not None
             else gen.vlp16_elevation_deg().tolist())
    rings = sensor["rings"] if sensor is not None else len(table)
    if not len(table) == rings == odo["num_rings"]:
        raise ValueError(f"configuration {name!r}: {len(table)} elevations, {rings} rings, "
                         f"num_rings {odo['num_rings']}")
    if any(b <= a for a, b in zip(table, table[1:])):
        raise ValueError(f"configuration {name!r}: elevations not lowest ring first")
    if rings * odo["scan_width"] > odo["max_raw_points"]:
        raise ValueError(f"configuration {name!r}: {rings} x {odo['scan_width']} beams do "
                         f"not fit max_raw_points {odo['max_raw_points']}")
    return table


def port_config(cell: Cell):
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig

    return OdometryConfig.from_dict(cell.config["odometry"])


def ref_config(cell: Cell) -> SimpleNamespace:
    return SimpleNamespace(**cell.config["odometry"])


def motion(traffic: dict, lane: int | None = None) -> gen.Motion:
    m = dict(traffic["motion"])
    if lane is not None:
        m["yaw_rate"] = traffic["yaw_rate_per_lane"] * (lane + 1)
    return gen.Motion(**m)


def drives_of(cell: Cell, seed: int, device, with_range_image: bool = False) -> list:
    """The run's distinct drives, made on the device from the seed: the
    replay's `drives`, or one per fleet lane."""
    cfg, tr = cell.config["odometry"], cell.traffic
    n = tr["lanes"] if tr["loop"] == "fleet" else tr.get("drives", 1)
    return [gen.simulate_drive(gen.drive_seed(seed, d), tr["scans_per_drive"],
                               cfg["scan_width"], cfg["max_raw_points"],
                               motion(tr, d if tr["loop"] == "fleet" else None), device,
                               with_range_image=with_range_image,
                               elevation_deg=cell.elevation_deg)
            for d in range(n)]


def scan_at(drive: gen.Drive, s: int):
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan

    return LidarScan(drive.xyz[s], drive.intensity[s], drive.ring[s], drive.time[s],
                     drive.valid[s])


def pose7(t, q) -> np.ndarray:
    return np.concatenate([np.asarray(t, np.float64), np.asarray(q, np.float64)])


def map_keys(keyframe, lane: int | None = None) -> torch.Tensor:
    """The port's map (packed keys relative to its origin) as the
    reference's absolute voxel keys: the benchmark's own reading of the
    port's documented key format (11 / 11 / 9 bits around the origin)."""
    keys, origin = keyframe.keys, keyframe.origin
    if lane is not None:
        keys, origin = keys[lane], origin[lane]
    keys = keys[keys != 0x7FFFFFFF].to(torch.int64)
    vox = torch.stack([(keys >> 20) & 2047, (keys >> 9) & 2047, keys & 511], -1)
    vox = vox - torch.tensor([1024, 1024, 256], device=keys.device) + origin.to(torch.int64)
    return ref_odometry.abs_key(vox).cpu()


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics, numpy's
    default) of every value."""
    return float(np.percentile(np.asarray(values, np.float64), q))


# ----------------------------------------------------------------- faults

# an answer altered where it is produced: 5 cm along x, one answer in ten
ALTER = np.array([0.05, 0.0, 0.0])


def apply_fault(fault: str | None, target, kind: str):
    """A broken timed path for the check's own tests: `stale` returns the
    state unchanged (the pose never moves), `alter` alters one answered
    pose in ten where it is produced, `half` leaves half the lanes out
    (their answers are the other half's)."""
    if fault is None:
        return target
    if kind == "odometry":
        if fault == "stale":
            step = target.process_scan

            def stale(scan):
                before = target.state
                diag = step(scan)
                target.state = before
                return diag
            target.process_scan = stale
        elif fault == "alter":
            get, calls = target.get_current_pose, [0]

            def altered():
                t, q = get()
                calls[0] += 1
                return (t + ALTER if calls[0] % 10 == 0 else t), q
            target.get_current_pose = altered
        return target
    if kind == "runner":
        def broken(state, scans):
            state, diag = target(state, scans)
            if fault == "alter":
                t = diag.pose.t.clone()
                t[::10] += torch.as_tensor(ALTER, dtype=t.dtype, device=t.device)
                diag = diag._replace(pose=diag.pose._replace(t=t))
            elif fault == "half":
                B = diag.pose.t.shape[1]
                t = diag.pose.t.clone()
                t[:, B // 2:] = t[:, : B - B // 2]
                diag = diag._replace(pose=diag.pose._replace(t=t))
            elif fault == "stale":
                diag = diag._replace(pose=diag.pose._replace(t=torch.zeros_like(diag.pose.t)))
            return state, diag
        return broken
    return target


# ----------------------------------------------------------------- replay, one card

def run_replay(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
               fault: str | None = None) -> dict:
    from lidar_odometry_demo_tpu_torch.device import HostFlags
    from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry, init_state

    cfg = port_config(cell)
    tr = cell.traffic
    if trace:
        devtrace.start_cupti()
    drives = drives_of(cell, seed, device)
    S = tr["scans_per_drive"]
    lo = apply_fault(fault, LidarOdometry(cfg, device=device), "odometry")
    fresh = init_state(cfg, device)
    for s in range(S):  # the warm-up: one pass of the first drive
        if s == 0:
            lo.state = fresh
        lo.process_scan(scan_at(drives[0], s))
        lo.get_current_pose()
    setup_s = settle(device) - t_process

    lat, passes, cur = [], [], None
    tracer = devtrace.Tracer() if trace else None
    traced_rounds, span = [], None
    n_traced = tr.get("trace_scans", 0)
    first = tr.get("trace_first", 0)  # in the window's first pass (drive 0)
    waits0 = HostFlags.waits
    d = s = done = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        if s == 0:
            lo.state = fresh
            cur = {"drive": d, "poses": []}
        t_due = time.perf_counter()
        if t_due >= deadline:
            break
        if tracer is not None and done == first:
            tracer.start()
            span = tracer.window()
            span.__enter__()
        diag = lo.process_scan(scan_at(drives[d], s))
        t, q = lo.get_current_pose()
        lat.append(time.perf_counter() - t_due)
        cur["poses"].append(pose7(t, q))
        if span is not None:
            traced_rounds.append(diag.icp_iterations)
            if len(traced_rounds) == n_traced:
                span.__exit__(None, None, None)
                tracer.stop()
                span = None
        done += 1
        s += 1
        if s == S:
            cur["map"] = map_keys(lo.state.keyframe)
            passes.append(cur)
            s, d = 0, (d + 1) % len(drives)
    t_end = time.perf_counter()
    if s:
        passes.append(cur)
    waits = HostFlags.waits - waits0
    out = dict(setup_s=setup_s, window_s=t_end - t_start, scans=done, latencies=lat,
               counters=dict(host_waits=waits), memory_peak=peak_memory(device))
    if tracer is not None:
        if span is not None:
            raise RuntimeError(f"the window ended before the {n_traced} traced scans")
        rounds = [int(r) for r in traced_rounds]
        out["trace"] = [tracer.summary(trace_kernels())]
        out["traced"] = dict(scans=n_traced, rounds=sum(rounds), lanes=1)
        out["traced_scans"] = [(0, first + i) for i in range(n_traced)]
    del lo, fresh
    free(device)
    refs = reference_drives(cell, drives, device)
    out["check"] = checks.compare_passes(passes, refs)
    out["ref_stats"] = refs
    return out


# ----------------------------------------------------------------- fleet, one card

def run_fleet(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
              fault: str | None = None) -> dict:
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
    from lidar_odometry_demo_tpu_torch.parallel.batched import (
        init_batched_state, make_batched_sequence_runner)

    cfg = port_config(cell)
    tr = cell.traffic
    B, S = tr["lanes"], tr["scans_per_drive"]
    if trace:
        devtrace.start_cupti()
    drives = drives_of(cell, seed, device)
    scans = LidarScan(*(torch.stack([getattr(dr, f) for dr in drives], 1)
                        for f in LidarScan._fields))
    del drives
    run = apply_fault(fault, make_batched_sequence_runner(cfg), "runner")
    fresh = init_batched_state(cfg, B, device)
    run(fresh, scans)  # the warm-up: one pass
    setup_s = settle(device) - t_process

    answered, n_pass = [], 0
    first, n_traced = tr.get("trace_first", 0), tr.get("trace_scans", 0)
    t_start = time.perf_counter()
    deadline = t_start + seconds
    trace_out = None
    while True:
        if trace and n_pass == 0:  # the first pass in three parts, the middle traced
            tracer = devtrace.Tracer()
            parts = [(0, first), (first, first + n_traced), (first + n_traced, S)]
            state, poses, its = fresh, [], []
            for i, (a, b) in enumerate(parts):
                part = LidarScan(*(x[a:b] for x in scans))
                if i == 1:
                    tracer.start()
                    with tracer.window():
                        state, diag = run(state, part)
                        sync(device)
                    tracer.stop()
                    its.append(diag.icp_iterations)
                else:
                    state, diag = run(state, part)
                poses.append(torch.cat([diag.pose.t, diag.pose.q], -1))
            pose = torch.cat(poses).cpu().numpy()
            rounds = int(its[0].max(-1).values.sum())
            trace_out = dict(summary=tracer.summary(trace_kernels()), rounds=rounds)
        else:
            state, diag = run(fresh, scans)
            pose = torch.cat([diag.pose.t, diag.pose.q], -1).cpu().numpy()   # (S, B, 7)
        n_pass += 1
        answered.append(pose)
        if time.perf_counter() >= deadline:
            break
    t_end = time.perf_counter()
    # every lane of every pass is compared; the last pass's state and
    # diagnostics stay the runner's until its next call, so its maps and
    # ICP rounds are read after the window
    passes = [{"drive": b, "poses": pose[:, b]} for pose in answered for b in range(B)]
    whole = not (trace and n_pass == 1)   # the traced pass's diagnostics are its last part's
    rounds = diag.icp_iterations.cpu().numpy() if whole else None
    for b, p in enumerate(passes[-B:]):
        p["map"] = map_keys(state.keyframe, b)
        if rounds is not None:
            p["rounds"] = rounds[:, b]
    out = dict(setup_s=setup_s, window_s=t_end - t_start, scans=n_pass * B * S, latencies=None,
               counters={}, memory_peak=peak_memory(device))
    if trace_out is not None:
        out["trace"] = [trace_out["summary"]]
        out["traced"] = dict(scans=n_traced, rounds=trace_out["rounds"], lanes=B)
        out["traced_scans"] = [(b, first + i) for b in range(B) for i in range(n_traced)]
    lane_drives = [SimpleNamespace(xyz=scans.xyz[:, b], time=scans.time[:, b],
                                   ring=scans.ring[:, b], valid=scans.valid[:, b])
                   for b in range(B)]
    del run, fresh, state, diag
    free(device)
    refs = reference_drives(cell, lane_drives, device)
    out["check"] = checks.compare_passes(passes, refs)
    out["ref_stats"] = refs
    return out


# ----------------------------------------------------------------- reference

def reference_drives(cell: Cell, drives: list, device) -> list:
    """The plain reference over each distinct drive once: per drive its
    poses (S, 7), its map keys at the end and its ICP counts per scan."""
    rcfg = ref_config(cell)
    odo = ref_odometry.Odometry(rcfg, device)
    out = []
    t0 = time.perf_counter()
    for dr in drives:
        odo.reset()
        poses, stats = [], []
        for s in range(dr.xyz.shape[0]):
            r = odo.step(dr.xyz[s], dr.time[s], dr.ring[s], dr.valid[s])
            poses.append(pose7(r.t, r.q))
            stats.append(r.stats)
        out.append(dict(poses=np.stack(poses), map=odo.map.keys.cpu(), stats=stats))
    print(f"reference: {len(drives)} drive(s) in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return out


# ----------------------------------------------------------------- helpers

def settle(device) -> float:
    """The end of set-up: the device idle, the harness's own objects out
    of the collector's way (so that no collection of them lands in the
    window), and the set-up's end on the clock."""
    sync(device)
    gc.collect()
    gc.freeze()
    return time.perf_counter()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


LOOPS = {"replay": run_replay, "fleet": run_fleet}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
             fault: str | None = None) -> dict:
    """Set-up, window, trace and check of one cell: the raw readings."""
    device = torch.device(device)
    if cell.config["layout"]["sp"] > 1 or cell.config["layout"]["dp"] > 1:
        raise NotImplementedError("the harness has no loop for a sharded layout yet")
    return LOOPS[cell.traffic["loop"]](cell, seed, seconds, trace, device, t_process, fault)
