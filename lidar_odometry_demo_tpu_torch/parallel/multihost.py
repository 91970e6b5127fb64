"""Multi-process execution over torch.distributed (port of the JAX
``parallel/multihost.py``).

The JAX package calls `jax.distributed.initialize` once per process and
builds its meshes over the global devices. Here a process is a rank:
`initialize` joins the default process group (explicit arguments, or the
`env://` variables a launcher such as torchrun sets), `global_mesh` lays
all ranks out as a (dp, sp) mesh (parallel/mesh.py), and every sharded
mode of the port (parallel/batched.py, parallel/spatial.py, the sp-sharded
ICP, parallel/pose_graph.py `make_refine_sharded`) runs on it unchanged.

`demo_worker` is the runnable multi-process entry point: the dp-sharded
fleet over all ranks, one lane each, with a scaling report that rank 0
writes. Run it with

    python -m lidar_odometry_demo_tpu_torch.parallel.multihost --ranks 2 --device cpu

(it spawns its ranks), or under a launcher, one process per rank:

    torchrun --nproc-per-node 2 -m lidar_odometry_demo_tpu_torch.parallel.multihost
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device_type: str = "cuda") -> torch.device:
    """Join the default process group; returns this rank's device. With no
    arguments the launcher's environment gives them (`env://`: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, and LOCAL_RANK and
    LOCAL_WORLD_SIZE for the card); otherwise pass all three. The backend
    follows the topology (mesh.choose_backend)."""
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    device = mesh_lib.rank_device(device_type, local_rank)
    mesh_lib.init_process_group(rank, world_size, device, init_method, local_world)
    return device


def global_mesh(dp: int | None = None, sp: int = 1, device=None) -> mesh_lib.Mesh:
    """The mesh over all ranks: dp defaults to world size // sp."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return mesh_lib.make_mesh(dp=world // sp if dp is None else dp, sp=sp, device=device)


def scaling_report(mesh: mesh_lib.Mesh, scans_per_sec: float, baseline_single: float) -> dict:
    """Scaling-efficiency record (BASELINE.json: >= 80 % to N hosts)."""
    ideal = baseline_single * mesh.world_size
    return {
        "devices": mesh.world_size,
        "processes": mesh.world_size,
        "scans_per_sec": scans_per_sec,
        "single_device_scans_per_sec": baseline_single,
        "scaling_efficiency": scans_per_sec / ideal if ideal > 0 else 0.0,
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def demo_worker(out_path: str | None = None, n_scans: int = 4, reps: int = 3,
                width: int | None = None, device=None) -> dict:
    """The dp-sharded fleet over all ranks, one lane each (the same drive,
    seed 3, on every lane). Call after `initialize`. Every rank steps its
    lane through the batched runner over the global mesh (B = world size),
    then runs the single-sequence runner on the same drive as its baseline;
    rank 0 writes the JSON report: each lane's largest distance from the
    single run and the scaling efficiency. Returns the report.

    `width`: azimuth columns per scan (None: TINY's 128); the other sizes
    follow the JAX demo's. Ranks that share the host's cores (or one card)
    cap `scaling_efficiency` at the share each gets; the core-aware figure
    is `machine_utilization_ratio`, aggregate over single scans/s."""
    from lidar_odometry_demo_tpu_torch.config import TINY
    from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy
    from lidar_odometry_demo_tpu_torch.parallel import batched
    from lidar_odometry_demo_tpu_torch.pipeline import odometry

    cfg = TINY
    if width is not None and width != cfg.scan_width:
        cfg = cfg.replace(scan_width=width, max_raw_points=max(cfg.max_raw_points, 16 * width * 2),
                          max_planar_points=8192, max_match_points=2048,
                          max_update_points=8192, map_capacity=32768)
    mesh = global_mesh(sp=1, device=device)
    dev, n_lanes = mesh.device, mesh.dp
    drive = simulate_sequence(num_scans=n_scans, width=cfg.scan_width, seed=3, speed=2.0,
                              yaw_rate=0.05)
    scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             cfg.max_raw_points, dev) for s in drive.scans]
    # (S, B, ...): the drive on every lane; each rank steps its own
    scans_b = LidarScan(*(torch.stack([getattr(s, f) for s in scans])[:, None]
                          .expand(-1, n_lanes, *getattr(scans[0], f).shape).contiguous()
                          for f in LidarScan._fields))
    run = batched.make_batched_sequence_runner(cfg, mesh)

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0

    (state, _), warmup_s = timed(lambda: run(batched.init_batched_state(cfg, 1, dev), scans_b))
    times = []
    for _ in range(reps):
        (state, _), dt = timed(lambda: run(batched.init_batched_state(cfg, 1, dev), scans_b))
        times.append(dt)
    # the fleet's time is its slowest rank's
    multi_sps = n_scans * n_lanes / max(mesh.all_gather_object(min(times)))

    run1 = odometry.make_sequence_runner(cfg)
    t1 = []
    for _ in range(reps):
        (s1, _), dt = timed(lambda: run1(odometry.init_state(cfg, dev), scans))
        t1.append(dt)
    single_sps = n_scans / min(t1)

    t_lanes = batched.gather_lanes(mesh, state.current.t.cpu().numpy(), lane_axis=0)
    t_single = s1.current.t.cpu().numpy()
    max_dt = float(np.abs(t_lanes - t_single[None]).max())
    cores = os.cpu_count() or 1
    report = {
        "scaling": scaling_report(mesh, multi_sps, single_sps),
        "machine_utilization_ratio": multi_sps / single_sps if single_sps > 0 else 0.0,
        "host_cpu_count": cores,
        "scaling_efficiency_core_ceiling": min(1.0, cores / n_lanes),
        "device": str(dev) if dev.type == "cpu" else torch.cuda.get_device_name(dev),
        "backend": mesh.backend,
        "scan_width": cfg.scan_width,
        "warmup_s": warmup_s,
        "n_scans": n_scans,
        "lanes": n_lanes,
        "max_lane_vs_single_dt": max_dt,
        "final_t": t_single.tolist(),
    }
    if out_path and mesh.rank == 0:
        with open(out_path, "w") as f:
            json.dump(report, f)
    return report


def _demo_rank(out_path, n_scans, reps, width) -> dict:
    """One spawned rank of the demo (mesh.run_ranks), on the device
    run_ranks gave the rank."""
    return demo_worker(out_path, n_scans, reps, width)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m lidar_odometry_demo_tpu_torch.parallel.multihost",
                                description=demo_worker.__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2,
                   help="ranks to spawn when no launcher set RANK and WORLD_SIZE")
    p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    p.add_argument("--out", default=None, help="where rank 0 writes the JSON report")
    p.add_argument("--scans", type=int, default=4)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--width", type=int, default=None)
    args = p.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        device = initialize(device_type=args.device)
        try:
            report = demo_worker(args.out, args.scans, args.reps, args.width, device)
        finally:
            mesh_lib.destroy_process_group()
        if int(os.environ["RANK"]) == 0:
            print(json.dumps(report))
        return 0
    report = mesh_lib.run_ranks(_demo_rank, args.ranks, args.out, args.scans, args.reps,
                                args.width, device=args.device)[0]
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
