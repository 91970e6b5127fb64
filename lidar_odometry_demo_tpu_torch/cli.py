"""Command-line runner of the PyTorch/CUDA port (port of the JAX ``cli.py``).

Replays a data source through the odometry pipeline and writes the same
outputs as the JAX package's CLI: a TUM trajectory (the /odometry + TF
analogue), an optional keyframe cloud PCD (the /keyframe_cloud analogue),
and per-scan diagnostics JSON lines on stderr (the stdout telemetry
analogue, lidar_odometry.cpp:75), including ``map_saturated``:

  python -m lidar_odometry_demo_tpu_torch.cli sim --scans 100 --out traj.tum
  python -m lidar_odometry_demo_tpu_torch.cli pcd-dir /path/to/scans --out traj.tum
  python -m lidar_odometry_demo_tpu_torch.cli fleet --batch 8 --scans 40
  python -m lidar_odometry_demo_tpu_torch.cli live --port 2368 --out live.tum
  python -m lidar_odometry_demo_tpu_torch.cli refine traj.tum --out refined.tum
  python -m lidar_odometry_demo_tpu_torch.cli sim --device cpu --scans 5

Runs on the card ("cuda") unless --device names another device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np


def _load_config(args) -> "OdometryConfig":
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig

    if args.config:
        import yaml  # type: ignore

        with open(args.config) as f:
            return OdometryConfig.from_dict(yaml.safe_load(f) or {})
    return OdometryConfig()


def _run_stream(cfg, scans_iter, device, gt=None, out=None, keyframe_out=None,
                quiet=False):
    from lidar_odometry_demo_tpu_torch.io import trajectory
    from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry
    from lidar_odometry_demo_tpu_torch.utils.profiling import ScanRateCounter

    odo = LidarOdometry(cfg, device=device)
    rate = ScanRateCounter()
    stamps, ts, qs = [], [], []
    for i, s in enumerate(scans_iter):
        t0 = time.perf_counter()
        diag = odo.process_cloud(s["xyz"], s["intensity"], s["ring"], s["time"])
        t, q = odo.get_current_pose()  # reads the pose back: the scan is done
        dt = time.perf_counter() - t0
        stamp = s.get("stamp", i * 0.1)
        stamps.append(stamp)
        ts.append(t)
        qs.append(q)
        if not quiet:
            print(json.dumps({
                "scan": i,
                "stamp": stamp,
                "t": [round(float(x), 4) for x in t],
                "processing_ms": round(1e3 * dt, 1),  # lidar_odometry.cpp:75 analogue
                "scans_per_sec": round(rate.tick(), 2),
                "icp_iterations": int(diag.icp_iterations),
                "matches": int(diag.num_matches),
                "diverged": bool(diag.diverged),
                "map_voxels": int(diag.map_voxels),
            } | ({"window_dropped": int(diag.num_window_dropped)}
                 if diag.num_window_dropped is not None
                 and int(diag.num_window_dropped) else {})
              | ({"downsample_dropped": int(diag.num_downsample_dropped)}
                 if diag.num_downsample_dropped is not None
                 and int(diag.num_downsample_dropped) else {})
              | ({"map_saturated": True}
                 if int(diag.map_voxels) >= cfg.map_capacity else {})),
                file=sys.stderr)
    if out:
        trajectory.write_tum(out, stamps, ts, qs)
        print(f"wrote {out} ({len(ts)} poses)")
    if keyframe_out:
        from lidar_odometry_demo_tpu_torch.io import pcd

        pcd.write_pcd(keyframe_out, odo.get_keyframe_cloud())
        print(f"wrote {keyframe_out}")
    if gt is not None and len(ts) > 1:
        est = np.asarray(ts)
        ate = trajectory.ate_rmse(est, gt[: len(est)], align=True)
        print(f"aligned ATE RMSE vs ground truth: {ate:.4f} m")
    return np.asarray(ts), np.asarray(qs)


def cmd_sim(args):
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence

    cfg = _load_config(args)
    drive = simulate_sequence(
        num_scans=args.scans, width=cfg.scan_width, seed=args.seed,
        speed=args.speed, yaw_rate=args.yaw_rate,
    )
    g0_R = Rotation.from_quat(
        [drive.gt_q[0][1], drive.gt_q[0][2], drive.gt_q[0][3], drive.gt_q[0][0]]
    )
    gt_rel = g0_R.inv().apply(drive.gt_t - drive.gt_t[0])
    _run_stream(cfg, drive.scans, args.device, gt=gt_rel, out=args.out,
                keyframe_out=args.keyframe_out, quiet=args.quiet)


def cmd_pcd_dir(args):
    from lidar_odometry_demo_tpu_torch.io import pcd

    cfg = _load_config(args)

    def scans():
        for path in sorted(glob.glob(os.path.join(args.path, "*.pcd"))):
            d = pcd.read_pcd(path)
            n = d["x"].shape[0]
            xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
            yield dict(
                xyz=xyz,
                intensity=d.get("intensity", np.zeros(n, np.float32)),
                ring=d.get("ring", np.zeros(n, np.int32)).astype(np.int32),
                time=d.get("time", d.get("t", np.linspace(0, 0.1, n))).astype(np.float32),
            )

    _run_stream(cfg, scans(), args.device, out=args.out,
                keyframe_out=args.keyframe_out, quiet=args.quiet)


def cmd_fleet(args):
    """Batched multi-sequence odometry: B simulated drives (seed + b, yaw
    rate 0.03 (b + 1)) stepped together on one device, one TUM per lane
    (the JAX CLI's `fleet`, the production serving shape, on one card)."""
    import torch
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.device import resolve_device
    from lidar_odometry_demo_tpu_torch.io import trajectory
    from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy
    from lidar_odometry_demo_tpu_torch.parallel import batched

    dp = 1 if args.dp is None else args.dp
    if dp > 1 or args.sp > 1:
        raise SystemExit(f"fleet: --dp {dp} --sp {args.sp} needs the sharded modes (a dp x sp "
                         f"device mesh), which this port does not have yet; it runs dp=1 x "
                         f"sp=1 on one device")
    cfg = _load_config(args)
    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"mesh: dp={dp} x sp={args.sp} over {n_dev} devices", file=sys.stderr)

    drives = [
        simulate_sequence(num_scans=args.scans, width=cfg.scan_width, seed=args.seed + b,
                          speed=args.speed, yaw_rate=0.03 * (b + 1))
        for b in range(args.batch)
    ]
    # (S, B, ...) scans on the device, as the JAX runner takes them
    lanes = [[scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                              cfg.max_raw_points, dev) for s in d.scans] for d in drives]
    scans_b = LidarScan(*(
        torch.stack([torch.stack([getattr(lane[i], f) for lane in lanes])
                     for i in range(args.scans)]) for f in LidarScan._fields))
    state_b = batched.init_batched_state(cfg, args.batch, dev)
    run = batched.make_batched_sequence_runner(cfg)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, diags = run(state_b, scans_b)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = args.scans * args.batch
    print(f"fleet: {args.batch} sequences x {args.scans} scans in {dt:.1f}s "
          f"= {total / dt:.1f} scans/s", file=sys.stderr)

    t_all, q_all = diags.pose.t.cpu().numpy(), diags.pose.q.cpu().numpy()
    for b in range(args.batch):
        out = f"{args.out_prefix}{b}.tum"
        t_b, q_b = t_all[:, b], q_all[:, b]
        trajectory.write_tum(out, [i * 0.1 for i in range(args.scans)], t_b, q_b)
        g0 = Rotation.from_quat([
            drives[b].gt_q[0][1], drives[b].gt_q[0][2], drives[b].gt_q[0][3], drives[b].gt_q[0][0]
        ])
        gt_rel = g0.inv().apply(drives[b].gt_t - drives[b].gt_t[0])
        ate = trajectory.ate_rmse(t_b, gt_rel, align=True)
        print(f"  lane {b}: {out}  aligned ATE {ate:.3f} m")


def cmd_live(args):
    """Online odometry from live VLP16 UDP packets, the analogue of the
    reference's per-message ROS loop (lidar_odometry_node.cpp:45-108): one
    JSON line per scan on stderr, the TUM rewritten every 10 scans."""
    from lidar_odometry_demo_tpu_torch.io import live, trajectory
    from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry
    from lidar_odometry_demo_tpu_torch.utils.profiling import ScanRateCounter

    cfg = _load_config(args)
    odo = LidarOdometry(cfg, device=args.device)
    rate = ScanRateCounter()
    stamps, ts, qs = [], [], []

    def on_scan(i, t, diag):
        _, q = odo.get_current_pose()
        stamps.append(i * 0.1)
        ts.append(t)
        qs.append(q)
        if not args.quiet:
            print(json.dumps({
                "scan": i,
                "t": [round(float(x), 4) for x in t],
                "scans_per_sec": round(rate.tick(), 2),
                "icp_iterations": int(diag.icp_iterations),
                "matches": int(diag.num_matches),
                "diverged": bool(diag.diverged),
                "map_voxels": int(diag.map_voxels),
            } | ({"downsample_dropped": int(diag.num_downsample_dropped)}
                 if diag.num_downsample_dropped is not None
                 and int(diag.num_downsample_dropped) else {})
              | ({"map_saturated": True}
                 if int(diag.map_voxels) >= cfg.map_capacity else {})),
                file=sys.stderr)
        if args.out and (i + 1) % 10 == 0:  # incremental trajectory flush
            trajectory.write_tum(args.out, stamps, ts, qs)

    print(f"listening on udp://{args.host}:{args.port} "
          f"(idle timeout {args.idle_timeout}s)", file=sys.stderr)
    n = live.run_live(odo, live.udp_packets(args.host, args.port, timeout_s=args.idle_timeout),
                      on_scan=on_scan, max_scans=args.max_scans)
    if args.out and ts:
        trajectory.write_tum(args.out, stamps, ts, qs)
        print(f"wrote {args.out} ({len(ts)} poses)")
    print(f"processed {n} scans", file=sys.stderr)


def cmd_refine(args):
    """Pose-graph refinement of a TUM trajectory: its odometry chain, Gauss-
    Newton with the direct or (--schur) the Schur solver."""
    from lidar_odometry_demo_tpu_torch.io import trajectory
    from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg

    stamps, t, q = trajectory.read_tum(args.traj)
    g = pg.chain_from_odometry(t, q, device=args.device)
    refined = pg.refine(g, iterations=args.iterations, use_schur=args.schur)
    trajectory.write_tum(args.out, stamps, refined.poses.t.cpu().numpy(),
                         refined.poses.q.cpu().numpy())
    print(f"wrote {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="lidar_odometry_demo_tpu_torch")
    p.add_argument("--config", help="YAML config overriding OdometryConfig fields")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sim", help="run odometry on a simulated VLP16 drive")
    ps.add_argument("--scans", type=int, default=50)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--speed", type=float, default=3.0)
    ps.add_argument("--yaw-rate", type=float, default=0.05)
    ps.set_defaults(fn=cmd_sim)

    pp = sub.add_parser("pcd-dir", help="run odometry over a directory of PCD scans")
    pp.add_argument("path")
    pp.set_defaults(fn=cmd_pcd_dir)

    for sp in (ps, pp):
        sp.add_argument("--out", default="trajectory.tum")
        sp.add_argument("--keyframe-out")
        sp.add_argument("--quiet", action="store_true")

    pf = sub.add_parser("fleet", help="batched multi-sequence odometry on one device")
    pf.add_argument("--batch", type=int, default=4)
    pf.add_argument("--scans", type=int, default=20)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--speed", type=float, default=3.0)
    pf.add_argument("--dp", type=int, default=None,
                    help="sequences' device axis; only 1 (the sharded modes are not ported)")
    pf.add_argument("--sp", type=int, default=1,
                    help="ICP's device axis; only 1 (the sharded modes are not ported)")
    pf.add_argument("--out-prefix", default="fleet_")
    pf.set_defaults(fn=cmd_fleet)

    pl = sub.add_parser("live", help="online odometry from live VLP16 UDP packets")
    pl.add_argument("--host", default="0.0.0.0")
    pl.add_argument("--port", type=int, default=2368)  # VLP16 data port
    pl.add_argument("--out", default="live_trajectory.tum")
    pl.add_argument("--idle-timeout", type=float, default=10.0,
                    help="stop after this many seconds without packets")
    pl.add_argument("--max-scans", type=int, default=None)
    pl.add_argument("--quiet", action="store_true")
    pl.set_defaults(fn=cmd_live)

    pr = sub.add_parser("refine", help="pose-graph refine a TUM trajectory")
    pr.add_argument("traj")
    pr.add_argument("--out", default="refined.tum")
    pr.add_argument("--iterations", type=int, default=10)
    pr.add_argument("--schur", action="store_true")
    pr.set_defaults(fn=cmd_refine)

    for sp in (ps, pp, pf, pl, pr):
        sp.add_argument("--device", default="cuda",
                        help='torch device to run on (default "cuda"; "cpu" on request)')

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
