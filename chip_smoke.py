"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. card: name and power limit (nvidia-smi); build the CUDA kernels from
   the sources in this checkout (one nvcc per source, in parallel) and
   print the build time;
2. K1 and K2 against their plain PyTorch versions on the card, at the
   shapes of the main path, in both of each kernel's modes. K1 (Q = 8192,
   K = 20): point mode `match_rows`, index equal where valid, point and d2
   within 1e-6; pose mode `match_correspondences` (the main path's, and
   100 m away where no query is valid), index and valid equal, origin,
   normal and d2 within 1e-6. K2: `jtwj_accumulate` (H, b) at Q = 8192 and a ragged Q, rtol
   2e-5 / atol 1e-4, two runs bitwise equal; `gn_step` (one whole
   Gauss-Newton step) at
   Q = 8192, 8115 and 1, H and b as before, pose within 1e-6, step norm
   rtol 1e-5, two runs bitwise equal, and 100 back-to-back steps on one
   workspace equal. K2's split-step entry points (`gn_sum_step`, and K2e,
   `gn_epilogue`) on the parts of N = 1, 2 and 4 fake ranks (slices of a
   Q = 8192 set), at B = 1 and at B = 8 with lane 3 inactive: bitwise the
   launch sequence they replace (the parts added in rank order by torch, K2e
   on that one sum, `jtwj_accumulate` at its pose), K2e at N = 1 bitwise the
   fused step, and within the K2 tolerances above of their plain versions
   (for the new part, rtol taken against the lane's largest entry).
   CUDA event times of every mode and its plain version (the split-step
   entry points at N = 2, B = 1 and 8, and N = 4), of K2's step at Q = 1 and
   of a one-element torch op (the launch floor). The ICP loop's condition
   kernel (kernels/loop.cu, the JAX `lax.while_loop`'s `cond`) bitwise its
   plain version on 100 carries each at B = 1 and 8, drawn around every
   threshold, and the times of both;
3. the main path, `LidarOdometry(device="cuda")` at the full VLP16
   configuration `OdometryConfig()`, on the 40-scan bench drive (seed 42,
   5 m/s, 0.08 rad/s): one warm-up pass, one timed pass. It fails if a
   kernel was not launched, if the launch counts do not match the schedule
   (K1 once per ICP round, K2 four times, K3 once per ICP scan and once per
   map_update, the condition once per ICP scan and once per round), if
   aligned ATE against ground truth exceeds 0.03 m or is not within 1e-4 m
   of 0.00936 m (the JAX package's and the port's earlier runs), or if any
   scan diverged, or unless the step's front end and map update each ran
   once a scan. Then the front end (kernels/prepare.cu) against its plain
   version, bitwise (every output; the normals on planar cells), on the
   drive's scans 2-39 deskewed between phase 3's poses, at B = 1 and at
   B = 8 (each lane its B = 1 call), two calls equal and four device
   operations a call; CUDA event times of both at B = 1 and 8 beside the
   bound; then the map update (kernels/map_update.cu) against its plain
   version, bitwise (the whole table, keys, count, origin, size, dropped),
   on the eager step's calls of scans 32-39 at B = 1 (new and in place)
   and B = 8 (each lane its B = 1 call), its device operations a call, CUDA
   event times of both beside the bound and the table passes' TB/s;
4. K3's three modes against their plain versions on the card, bitwise: the
   neighbourhood lookup (base and n_present everywhere, every present
   candidate row) and map_update's group lookup (pos_c, found), recorded
   from one more step of the bench drive from the main path's final state;
   the bare search also against torch.searchsorted, index equal, at the
   main path's two key sets (the map's 131,072 keys with the 73,728
   neighbourhood start keys, and with the 16,384 sorted map_update
   queries), on the TPU script's own fixture (131,072 keys, 221,184
   queries, rng seed 0), on the edges (below, at and just above keys[0],
   equal to a key, in the EMPTY_KEY run, above every key) and with no
   queries. CUDA event times of every mode alone and as dispatched, of its
   plain version and (bare search, and the group lookup's search part) of
   torch.searchsorted, the present-slice count, each mode's bound and the
   launch floor;
5. the strict reference path, `reference_parity(OdometryConfig())` (ICP
   re-searches the map every round, up to 35 rounds, backwards deskew
   translation), through `LidarOdometry(device="cuda")` on the same drive:
   one timed pass, with the checks of phase 3 (the ATE bound of 0.03 m; in
   place of the 0.00936 m check, at most 0.0005 m from the NumPy oracle's
   trajectory `benchmarks/BASELINE_REF.tum`) and K3 once per ICP round and
   once per map_update; then K3's neighbourhood lookups (one per ICP round)
   and group lookup of one more step on this path's map, bitwise against
   their plain versions;
6. the CLI on the card, in-process: `sim --scans 5` at full width with a
   TUM and a keyframe PCD written under chiprun_out/cli_smoke/; the TUM
   must hold 5 monotone rows and the PCD POINTS > 0, and every kernel must
   have launched;
7. the fleet path: the batched sequence runner at `OdometryConfig()` with
   B = 8 lanes of 40 scans (lanes 0 and 7 the bench drive, lanes 1-6 seeds
   43-48 at 5 m/s with yaw rate 0.03 (b + 1), simulated in six worker
   processes), one warm-up pass and one timed pass. It fails unless lanes 0
   and 7 are bitwise equal (poses, final keys, counts, origin), lane 0 is
   within 1e-5 m / 1e-6 (t / q) of phase 3's trajectory with the same ICP
   iterations and matches on every scan and the same final keys and
   counts, lane 0's ATE is within 1e-4 m of 0.00936 m, every lane's ATE is
   under 0.03 m, no scan diverged, and the launches follow the batched
   schedule (K1 once per batched round, a step's rounds its slowest lane's;
   K2 four times that; K3 once per ICP step and once per map_update step).
   Then each kernel at B = 8 on the inputs of one more batched step: K1
   and K3's two lookups bitwise against their plain versions, K2 (lane 3
   inactive) within phase 2's tolerances, and all three bitwise against
   B = 1 launches lane by lane; per-launch times at B = 8 with their bounds.
   Last, `fleet --batch 2 --scans 5` in-process (TUMs under
   chiprun_out/cli_smoke/);
8. live ingestion at full width: the native library built from
   native/lidar_native.cpp (its build time printed), the bench drive
   encoded as 3,000 VLP16 data packets (75 per scan), sent by a spawned
   process over loopback UDP at the sensor's 750 packets/s to `udp_packets`
   (the sender starts once the listener has bound), cut into revolutions,
   decoded and run through `run_live` and `LidarOdometry(OdometryConfig(),
   "cuda")` with the last revolution flushed. It fails unless the packets
   received are the packets sent, each revolution holds its encoded scan's
   packets within one (and no packet no scan encoded),
   at least 40 scans are processed, the trajectory is within 1e-5 m / 1e-6
   of the socket-free run over the same packets, within 0.05 m of phase 3's
   and its aligned ATE under 0.03 m, no scan diverged and the launches
   follow phase 3's schedule; prints each scan's ms split into decode,
   upload, the step's host call and the pose read, the step's CUDA event
   time, and how many scans took over the sensor's 100 ms. Then `live
   --max-scans 5 --idle-timeout 3` in-process (TUM of 5 monotone rows under
   chiprun_out/cli_smoke/);
9. the pose graph (`refine`) on the card against the same on CPU tensors in
   this process (first system within 1e-5 of its scale, refined poses
   within 5e-3 of the correction's scale or 4 float32 ulps, two card runs
   printed side by side): phase 3's 40 poses (the odometry chain, a fixed
   point: poses move under 1e-3 m), direct and Schur; a 32-pose noisy loop
   with a closure, direct and Schur (RMS against ground truth halved, pose
   0 within 1e-3 m); the segment Schur solver at P = 256, stride 8; the
   CLI's `refine` (and `--schur`) on phase 3's TUM. No kernel launches;
10. the sharded modes on one H100. K2's split-step entry points must not
   have run on phases 3-9. The composite view of the column-sharded map on the card: phase 3's final
   map split into N = 2 and 4 shards, each rank's view merged from its
   shard and its ring neighbours' (131,072 and 98,304 rows), searched by K3
   and K1 at one more step's guess pose: every owned query bitwise the
   replicated search. Then two ranks spawned on cuda:0 over gloo (the
   kernels built before, so no rank runs nvcc; the inputs handed over as
   files): (a) sp = 2 on the bench drive, bitwise (poses, iterations,
   matches) the one-process witness of the split sums (the same two halves
   in two threads of the parent, their parts of H, b, matches and costs
   gathered and added in rank order as the ranks add them: sp_witness), with
   the split schedule (per ICP round one gather of matches and costs, and
   four of H and b, one K1, one `jtwj_accumulate`, three `gn_sum_step`, one
   K2e), and within 1e-4 m of phase 3 (the JAX
   package's bar for an sp sequence, tests/test_parallel.py:147) with equal
   iterations and ATE within 1e-4 m of 0.00936 m; (b) spatial N = 2, within
   1e-3 m of phase 3, ATE under 0.03 m, the shards disjoint, both ranks'
   halo views equal and holding both shards, and on each rank, after the
   last scan, the view build_halo_view made (through the real exchange)
   searched for the queries the rank owns (phase 3's last lookup) bitwise,
   field by field, the search on the merge of every rank's shard gathered
   through the mesh, the owned queries a partition; (c) dp = 2 with four of phase
   7's lanes per rank, each bitwise phase 7's lane; (a)-(c) with the
   split or batched launch schedule, per-rank ms/scan, collectives, halo
   bytes, staging ms and launches per scan printed; (d) the edge-sharded
   refine of phase 9's noisy loop, within 5e-3 of the correction from
   phase 9's and equal on both ranks, and the edge-sharded segment-Schur
   refine (refine_segment with a group) at config 5's shape (a 512-pose
   noisy loop, stride 8, closures (504, 0) and (256, 0), 10 iterations),
   within 1e-4 m of the one-process refine_segment on the card, the ranks
   bitwise equal, one all-reduce per iteration. Last, a world of one on
   NCCL: psum and ppermute_from (to itself) through the mesh's group, each
   timed on the device by CUDA events (CommStats) as well as on the host;
11. the captured step against the eager step. Phases 3, 5, 6, 7 and 8 ran
   the entry points a user calls (`LidarOdometry`, the batched runner, the
   CLI, `run_live`), which on the card run the step from CUDA graphs
   (pipeline/graphs.py) from the third scan on: (a) replayed, then one
   graph of the ICP loop as a WHILE node and (c); their launch counts
   counted per launch and the loop's rounds read from the device when the
   counts are read. Here the eager step (`make_process_scan`, its ICP loop
   the same schedule driven from the host) runs the scans of the main
   path, the parity path and the live path (the 40 scans phase 8
   uploaded) from a fresh state, and the fleet's B = 8 drives; each must
   be bitwise the captured runs of phases 3, 5, 8 and 7 (poses, ICP
   iterations and matches of every scan, every lane; final keys, counts
   and origin), with every launch counter equal, the loop's condition's
   among them. Then, for both steps on each of the four, per scan (fleet:
   per step of 8; scans 20-39 after 20 scans of warm-up; `step_counts`):
   synchronising calls (torch's sync debug mode warnings plus the step's
   waits on its pinned host copies), graph launches and ICP rounds. It
   fails unless the captured step makes exactly 1 synchronising call and
   at most 2 graph launches per scan on every path, both steps run the
   same rounds, and the main path runs 4.00 rounds per scan. Device
   operations, busy ms and idle share by name are odobench's
   (`odobench/run.py --trace 1`).

Prints a `kernels` JSON line (each kernel, the loop's condition among
them, with its launches on every path,
`launches_live` the live phase's, `launches_sharded_sp` / `_spatial` /
`_dp` phase 10's per rank, K2's split-step entry points `gn_sum_step` and
`gn_epilogue` (K2e) as kernels of their own whose `launches` are the sp
path's, its times, bound and plain time at the main path's shapes and at
B = 8), the card's name and power limit, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Exits non-zero without a result when no CUDA device is present. Every
process it starts (the kernel builds, the simulation workers, the UDP
sender, the ranks and multiprocessing's resource tracker) has ended and
been reaped when it exits.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
F32_EPS = float(np.finfo(np.float32).eps)
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int, queue_first: bool = True) -> float:
    """Mean time of fn() over `reps` back-to-back calls, by CUDA events.

    queue_first: the card first spins ~0.1 s (torch.cuda._sleep), so the
    host has queued every call before the card reaches the start event and
    the events time the device's work alone; without it they time the
    calls as the host dispatches them.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_first:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def candidate_fixture(rng, Q: int, K: int, device, q=None):
    """Candidate rows in the port's CandidateSet layout: three (9*Q, RW)
    int32 arrays (planar x/y/z lanes + f32 count lane) and n_present (9, Q),
    with candidates scattered around each query (world points `q`, drawn
    if None)."""
    import torch

    from lidar_odometry_demo_tpu_torch.ops.voxel_map import _lanes

    RW, _, _ = _lanes(K)
    if q is None:
        q = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    rows = np.zeros((3, 9, Q, RW), np.float32)
    pts = q[None, None, :, None, :] + rng.normal(0, 0.25, (3, 9, Q, K, 3))
    cnt = rng.integers(0, K + 1, (3, 9, Q))
    for i in range(3):
        rows[..., i * K:(i + 1) * K] = pts[..., i]
    rows[..., 3 * K] = cnt
    n_present = rng.integers(0, 4, (9, Q)).astype(np.int32)
    rows_z = tuple(torch.from_numpy(rows[s].reshape(9 * Q, RW).view(np.int32).copy()).to(device)
                   for s in range(3))
    return (torch.from_numpy(q).to(device), rows_z,
            torch.from_numpy(n_present).to(device), cnt, n_present)


def fused_fixture(rng, Q: int, K: int, device):
    """K1's pose-mode inputs at the main path's shapes: queries in their
    local frame, a pose, candidates scattered around each query's world
    position (CandidateSet layout), random column bases and a 131,072-row
    table of random normal lanes."""
    import torch
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.ops.voxel_map import CandidateSet, _lanes

    C = 131072
    RW, MB, W = _lanes(K)
    R = Rotation.from_euler("xyz", [0.03, -0.02, 0.4]).as_matrix().astype(np.float32)
    t = np.array([2.0, -1.0, 0.3], np.float32)
    local = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    q_world = (local @ R.T + t).astype(np.float32)
    _, rows_z, n_present, cnt, npres = candidate_fixture(rng, Q, K, device, q=q_world)
    base = rng.integers(0, C, (9, Q)).astype(np.int32)
    tab = rng.normal(0, 1, (C, W)).astype(np.float32).view(np.int32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    tab_t = up(tab)
    nrm_view = tab_t[:, RW:RW + 3 * K].view(torch.float32).reshape(C, K, 3)
    cand = CandidateSet(rows_z=rows_z, base=up(base), n_present=n_present)
    return dict(query_local=up(local), query_valid=up(rng.random(Q) < 0.9), pose_t=up(t),
                pose_R=up(R), cand=cand, tab=tab_t, nrm_view=nrm_view, cnt=cnt,
                npres=npres)


def check_match_rows(rng, device) -> dict:
    import torch

    from lidar_odometry_demo_tpu_torch.kernels.correspondence import (
        match_correspondences, match_correspondences_plain, match_rows, match_rows_plain)

    Q, K, max_d2 = 8192, 20, float(np.float32(0.3 * 0.3))
    q, rows_z, n_present, _, _ = candidate_fixture(rng, Q, K, device)
    max_err = 0.0
    # point mode (match_rows)
    for shift in (0.0, 100.0):  # 100 m: no query has a valid candidate
        qs = q + shift
        po, pi, pd = match_rows(qs, rows_z, n_present, max_d2=max_d2, max_points=K)
        ro, ri, rd = match_rows_plain(qs, rows_z, n_present, max_d2=max_d2, max_points=K)
        torch.cuda.synchronize()
        valid = (rd < max_d2).cpu().numpy()
        if shift == 0.0 and valid.sum() < Q // 2:
            raise AssertionError(f"K1 fixture has too few matches: {valid.sum()}")
        if shift > 0.0:
            if valid.any() or not torch.all(pd == max_d2) or not torch.all(pi == 0):
                raise AssertionError("K1: a query without candidates must give max_d2, index 0")
        pi_n, ri_n = pi.cpu().numpy(), ri.cpu().numpy()
        if not np.array_equal(pi_n[valid], ri_n[valid]):
            raise AssertionError(f"K1 index differs at {np.sum(pi_n[valid] != ri_n[valid])} queries")
        err_d = (pd - rd).abs().max().item()
        err_o = (po - ro).abs()[torch.from_numpy(valid).to(device)].max().item() if valid.any() else 0.0
        if err_d > 1e-6 or err_o > 1e-6:
            raise AssertionError(f"K1 disagrees: d2 {err_d}, point {err_o}")
        max_err = max(max_err, err_d, err_o)

    # pose mode (the main path's): the whole correspondence
    fx = fused_fixture(rng, Q, K, device)
    args = [fx[k] for k in ("query_local", "query_valid", "pose_t", "pose_R", "cand")]
    for shift in (0.0, 100.0):
        a = list(args)
        a[2] = args[2] + shift
        ref = match_correspondences_plain(*a, fx["nrm_view"], max_d2=max_d2, max_points=K)
        got = match_correspondences(*a, fx["tab"], fx["nrm_view"], max_d2=max_d2,
                                    max_points=K)
        torch.cuda.synchronize()
        n_valid = int(ref.valid.sum())
        if shift == 0.0 and n_valid < Q // 2:
            raise AssertionError(f"K1 pose-mode fixture has too few matches: {n_valid}")
        if shift > 0.0 and (n_valid or bool(got.valid.any())):
            raise AssertionError("K1 pose mode: no query may be valid 100 m away")
        if not (torch.equal(got.index, ref.index) and torch.equal(got.valid, ref.valid)):
            raise AssertionError(f"K1 pose mode: index differs at "
                                 f"{int((got.index != ref.index).sum())}, valid at "
                                 f"{int((got.valid != ref.valid).sum())} queries")
        errs = [(getattr(got, f) - getattr(ref, f)).abs().max().item()
                for f in ("plane_origin", "plane_normal", "d2")]
        if max(errs) > 1e-6:
            raise AssertionError(f"K1 pose mode disagrees: origin, normal, d2 {errs}")
        max_err = max(max_err, *errs)

    out = match_correspondences(*args, fx["tab"], fx["nrm_view"], max_d2=max_d2,
                                max_points=K)

    def fused():
        match_correspondences(*args, fx["tab"], fx["nrm_view"], max_d2=max_d2,
                              max_points=K, out=out)

    ms = time_ms(fused, 100)
    call_ms = time_ms(fused, 100, queue_first=False)
    point_ms = time_ms(lambda: match_rows(q, rows_z, n_present, max_d2=max_d2, max_points=K),
                       100)
    plain_ms = time_ms(lambda: match_correspondences_plain(
        *args, fx["nrm_view"], max_d2=max_d2, max_points=K), 5)
    # least traffic: each present slice's count lane and its cnt candidates'
    # three coordinates; the queries, their valid flags, the pose,
    # n_present and base; a normal per valid query; the outputs
    cnt, npres = fx["cnt"], fx["npres"]
    present = np.arange(3)[:, None, None] < npres[None]
    n_cand = float(np.sum(np.where(present, np.maximum(cnt, 0), 0)))
    n_valid = int(match_correspondences_plain(*args, fx["nrm_view"], max_d2=max_d2,
                                              max_points=K).valid.sum())
    n_bytes = (4.0 * (np.sum(present) + 3 * n_cand) + Q * 13 + 48 + 2 * 9 * Q * 4
               + 12 * n_valid + Q * 33)
    b_ms, b_by = bound_ms(n_bytes, 9 * n_cand + 15 * Q)
    log(f"kernel match_rows (K1), pose mode: Q={Q} K={K} max_abs_err={max_err:.3g} "
        f"kernel {ms:.4f} ms on the card ({call_ms:.4f} ms per call as dispatched), "
        f"point mode {point_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    return dict(name="match_rows", route="cuda",
                source="lidar_odometry_demo_tpu_torch/kernels/match_rows.cu",
                replaces="lidar_odometry_demo_tpu/ops/pallas/correspondence.py:119",
                max_abs_err=max_err, ms=ms, call_ms=call_ms,
                point_mode_ms=point_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_jtwj(rng, device) -> dict:
    import torch
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import (
        GnWork, gn_step, gn_step_plain, jtwj_accumulate, jtwj_plain)
    from lidar_odometry_demo_tpu_torch.ops.se3 import Pose, quat_to_matrix
    from lidar_odometry_demo_tpu_torch.ops.voxel_map import Correspondence

    rot = Rotation.from_euler("xyz", [0.02, -0.01, 0.3])

    def system(Q):
        sl = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
        pn = rng.normal(0, 1, (Q, 3)).astype(np.float32)
        pn /= np.linalg.norm(pn, axis=1, keepdims=True)
        R = rot.as_matrix().astype(np.float32)
        t = np.array([1.5, -0.2, 0.1], np.float32)
        po = (sl @ R.T + t + rng.normal(0, 0.03, (Q, 3))).astype(np.float32)
        valid = rng.random(Q) < 0.8
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (sl, po, pn, valid, R, t)]

    cfg = OdometryConfig()
    q_np = rot.as_quat()[[3, 0, 1, 2]].astype(np.float32)

    def step_inputs(Q):
        sl, po, pn, valid, _, t = system(Q)
        pose = Pose(t, torch.from_numpy(q_np).to(device))
        return Correspondence(sl, po, pn, valid), pose, t + 0.05

    def hb_plain(corr, pose):
        return jtwj_plain(*corr, quat_to_matrix(pose.q), pose.t, huber_delta=0.15)

    max_err = 0.0
    # normal-equations mode (jtwj_accumulate: H and b at the pose)
    for Q in (8192, 8192 - 77):
        corr, pose, _ = step_inputs(Q)
        H, b = jtwj_accumulate(corr, pose, huber_delta=0.15)
        H2, b2 = jtwj_accumulate(corr, pose, huber_delta=0.15)
        Hp, bp = hb_plain(corr, pose)
        torch.cuda.synchronize()
        if not (torch.equal(H, H2) and torch.equal(b, b2)):
            raise AssertionError("K2 is not bitwise repeatable")
        for got, ref in ((H, Hp), (b, bp)):
            if not torch.allclose(got, ref, rtol=2e-5, atol=1e-4):
                raise AssertionError(f"K2 disagrees at Q={Q}: {(got - ref).abs().max().item()}")
            max_err = max(max_err, (got - ref).abs().max().item())

    # step mode (the main path's): one whole Gauss-Newton step
    def snapshot(out):
        pose, norm, H, b = out
        return [x.clone() for x in (pose.t, pose.q, norm, H, b)]

    pose_err = 0.0
    for Q in (8192, 8192 - 77, 1):
        corr, pose, guess_t = step_inputs(Q)
        work = GnWork.empty(1, device)
        first = snapshot(gn_step(corr, pose, guess_t, cfg, work=work))
        second = snapshot(gn_step(corr, pose, guess_t, cfg, work=work))
        ref = gn_step_plain(corr, pose, guess_t, cfg)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"K2 step is not bitwise repeatable at Q={Q}")
        t_, q_, norm, H, b = first
        for got, want in ((H, ref[2]), (b, ref[3])):
            if not torch.allclose(got, want, rtol=2e-5, atol=1e-4):
                raise AssertionError(f"K2 step H, b disagree at Q={Q}: "
                                     f"{(got - want).abs().max().item()}")
            max_err = max(max_err, (got - want).abs().max().item())
        errs = [(t_ - ref[0].t).abs().max().item(), (q_ - ref[0].q).abs().max().item()]
        if max(errs) > 1e-6 or not torch.allclose(norm, ref[1], rtol=1e-5, atol=1e-7):
            raise AssertionError(f"K2 step pose disagrees at Q={Q}: t, q {errs}, norm "
                                 f"{norm.item()} vs {ref[1].item()}")
        pose_err = max(pose_err, *errs)
    # the cluster's reduction, reused: 100 back-to-back steps on one workspace
    corr, pose, guess_t = step_inputs(8192)
    work = GnWork.empty(1, device)
    first = snapshot(gn_step(corr, pose, guess_t, cfg, work=work))
    for _ in range(100):
        out = gn_step(corr, pose, guess_t, cfg, work=work)
    if not all(torch.equal(x, y) for x, y in zip(first, snapshot(out))):
        raise AssertionError("K2 step: 100 back-to-back calls on one workspace disagree")

    def step():
        return gn_step(corr, pose, guess_t, cfg, work=work)

    ms = time_ms(step, 200)
    call_ms = time_ms(step, 200, queue_first=False)
    plain_ms = time_ms(lambda: gn_step_plain(corr, pose, guess_t, cfg), 20)
    hb_args = step_inputs(8192)[:2]
    hb_work = GnWork.empty(1, device)
    hb_ms = time_ms(lambda: jtwj_accumulate(*hb_args, huber_delta=0.15, work=hb_work), 200)
    hb_plain_ms = time_ms(lambda: hb_plain(*hb_args), 20)
    # what does not scale with the rows: the step at Q = 1, and the card's
    # back-to-back launch floor (a one-element torch op)
    one = step_inputs(1)
    q1_ms = time_ms(lambda: gn_step(*one, cfg, work=work), 200)
    x = torch.zeros(1, device=device)
    floor_ms = time_ms(lambda: x.add_(1.0), 200)
    Q = 8192
    # inputs read once (3 x (Q,3) f32, (Q,) bool, the pose and the guess),
    # H, b and the new pose written; ~100 flops per correspondence and ~300
    # for the prior, the solve and the pose update
    b_ms, b_by = bound_ms(Q * 37 + 40 + 42 * 4 + 32, 100 * Q + 300)
    log(f"kernel jtwj_accumulate (K2), step mode: Q={Q} max_abs_err={max_err:.3g} (H, b), "
        f"pose {pose_err:.3g}, bitwise repeatable; kernel {ms:.4f} ms on the card "
        f"({call_ms:.4f} ms per call as dispatched), plain step {plain_ms:.4f} ms; H-and-b "
        f"mode {hb_ms:.4f} ms, its plain {hb_plain_ms:.4f} ms; step at Q=1 {q1_ms:.4f} ms, "
        f"launch floor {floor_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by})")
    return dict(name="jtwj_accumulate", route="cuda",
                source="lidar_odometry_demo_tpu_torch/kernels/jtwj.cu",
                replaces="lidar_odometry_demo_tpu/ops/pallas/jtwj.py:101",
                max_abs_err=max_err, pose_max_abs_err=pose_err, ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, hb_mode_ms=hb_ms,
                hb_mode_plain_ms=hb_plain_ms, step_q1_ms=q1_ms, launch_floor_ms=floor_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_gathered_step(rng, device) -> tuple[dict, dict]:
    """K2's split-step entry points against the launch sequence they
    replace and against their plain versions on the card, on the parts of
    N = 1, 2 and 4 fake ranks (a Q = 8192 correspondence set cut into N
    slices of Q / N rows, each slice's H and b at the pose from
    `jtwj_accumulate`), at B = 1 and at B = 8 with lane 3 inactive, for every
    rank's slice: `gn_sum_step` bitwise the old sequence (the parts added in
    rank order by torch, K2e on that one sum, `jtwj_accumulate` at its
    pose: pose, step norm and the new part), K2e on the N parts bitwise K2e
    on their torch sum, and at N = 1 K2e bitwise the fused step; the pose
    within 1e-6 and the step norm within rtol 1e-5 of the plain versions,
    and the new part, entry by entry, within 4 eps sqrt(Q / N) of its
    terms' magnitudes (`abs_terms_sum`) of `jtwj_plain` at the kernel's
    pose. CUDA event times of both entry points and their plain versions
    beside their bounds. Returns the two kernels' `kernels` entries."""
    import torch
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import (
        GnWork, gn_epilogue, gn_epilogue_sum_plain, gn_step, gn_sum_step, gn_sum_step_plain,
        jtwj_accumulate, jtwj_plain, sum_in_rank_order)
    from lidar_odometry_demo_tpu_torch.ops.se3 import Pose, quat_to_matrix
    from lidar_odometry_demo_tpu_torch.ops.voxel_map import Correspondence

    cfg = OdometryConfig()
    Q = 8192
    rot = Rotation.from_euler("xyz", [0.02, -0.01, 0.3])

    def step_inputs(lanes):
        sl = rng.uniform(-20, 20, (*lanes, Q, 3)).astype(np.float32)
        pn = rng.normal(0, 1, (*lanes, Q, 3)).astype(np.float32)
        pn /= np.linalg.norm(pn, axis=-1, keepdims=True)
        t = np.broadcast_to(np.array([1.5, -0.2, 0.1], np.float32), (*lanes, 3)).copy()
        po = (sl @ rot.as_matrix().T.astype(np.float32) + t[..., None, :]
              + rng.normal(0, 0.03, sl.shape)).astype(np.float32)
        q = np.broadcast_to(rot.as_quat()[[3, 0, 1, 2]].astype(np.float32), (*lanes, 4)).copy()
        cuda = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (sl, po, pn)]
        valid = torch.from_numpy(rng.random((*lanes, Q)) < 0.8).to(device)
        pose = Pose(torch.from_numpy(t).to(device), torch.from_numpy(q).to(device))
        return Correspondence(*cuda, valid), pose, pose.t + 0.05

    def rank_slice(corr, n, r):
        """Fake rank r's rows of n (contiguous slices, as the sp path cuts)."""
        rows = slice(r * Q // n, (r + 1) * Q // n)
        return Correspondence(*(x[..., rows, :].contiguous() for x in corr[:3]),
                              corr.valid[..., rows].contiguous())

    def lane_bits(xs, on):
        return [x[on] if on is not None else x for x in xs]

    def part_plain(corr, pose):
        """`jtwj_plain`'s part at `pose` as a record per lane."""
        H, b = jtwj_plain(*corr, quat_to_matrix(pose.q), pose.t,
                          huber_delta=cfg.icp_huber_delta)
        return torch.cat([H.flatten(-2), b], -1)

    max_err, part_err, part_share, timed = 0.0, 0.0, 0.0, {}
    for lanes in ((), (8,)):
        corr, pose, guess_t = step_inputs(lanes)
        kw, on = {}, None
        if lanes:
            on = torch.arange(lanes[0], device=device) != 3
            kw = dict(step_norm=torch.full(lanes, 0.5, device=device), active=on)
        for n in (1, 2, 4):
            slices = [rank_slice(corr, n, r) for r in range(n)]
            parts = []
            for part_corr in slices:
                w = GnWork.empty(1, device, lanes)
                jtwj_accumulate(part_corr, pose, huber_delta=cfg.icp_huber_delta, work=w,
                                active=kw.get("active"))
                parts.append(w.hb)
            parts = torch.stack(parts)
            total = sum_in_rank_order(parts)
            # the launch sequence these entry points replace: the torch sum in
            # rank order, K2e on that one sum, then H and b at its pose
            old_work = GnWork.empty(1, device, lanes)
            old_pose, old_norm = gn_epilogue(total[None], pose, guess_t, cfg, work=old_work, **kw)
            e_pose, e_norm = gn_epilogue(parts, pose, guess_t, cfg,
                                         work=GnWork.empty(1, device, lanes), **kw)
            plain_pose, plain_norm = gn_epilogue_sum_plain(parts, pose, guess_t, cfg, **kw)
            torch.cuda.synchronize()
            if not _bitwise([e_pose.t, e_pose.q, e_norm], [old_pose.t, old_pose.q, old_norm]):
                raise AssertionError(f"K2e at N = {n}, lanes {lanes}: not bitwise K2e on the "
                                     f"torch rank-order sum of the parts")
            errs = [(e_pose.t - plain_pose.t).abs().max().item(),
                    (e_pose.q - plain_pose.q).abs().max().item()]
            if max(errs) > 1e-6 or not torch.allclose(e_norm, plain_norm, rtol=1e-5, atol=1e-7):
                raise AssertionError(f"K2e at N = {n}, lanes {lanes} vs its plain version: t, q "
                                     f"{errs}, norm {(e_norm - plain_norm).abs().max().item()}")
            max_err = max(max_err, *errs)
            if n == 1:  # K2e on one epilogue-off part is the fused step
                fp, fn, _, _ = gn_step(corr, pose, guess_t, cfg,
                                       work=GnWork.empty(1, device, lanes), **kw)
                torch.cuda.synchronize()
                if not _bitwise([e_pose.t, e_pose.q, e_norm], [fp.t, fp.q, fn]):
                    raise AssertionError(f"K2e at N = 1, lanes {lanes}: not bitwise the fused "
                                         f"step")
            for r, part_corr in enumerate(slices):
                acc_work = GnWork.empty(1, device, lanes)
                jtwj_accumulate(part_corr, old_pose, huber_delta=cfg.icp_huber_delta,
                                work=acc_work, active=kw.get("active"))
                work = GnWork.empty(1, device, lanes)
                s_pose, s_norm = gn_sum_step(parts, part_corr, pose, guess_t, cfg, work=work,
                                             **kw)
                pp, pn_, _, _ = gn_sum_step_plain(parts, part_corr, pose, guess_t, cfg, **kw)
                torch.cuda.synchronize()
                if not (_bitwise([s_pose.t, s_pose.q, s_norm], [old_pose.t, old_pose.q, old_norm])
                        and _bitwise(lane_bits([work.hb], on), lane_bits([acc_work.hb], on))):
                    raise AssertionError(f"gn_sum_step at N = {n}, rank {r}, lanes {lanes}: not "
                                         f"bitwise the rank-order sum, K2e and jtwj_accumulate")
                errs = [(s_pose.t - pp.t).abs().max().item(), (s_pose.q - pp.q).abs().max().item()]
                # the part against the plain accumulation at the kernel's own
                # pose (the pose is held to the plain one above), each entry
                # within a few float32 orders' rounding of its Q / N terms
                got, want, scale = lane_bits(
                    [work.hb, part_plain(part_corr, s_pose),
                     abs_terms_sum(part_corr, s_pose, cfg.icp_huber_delta)], on)
                part_bar = F32_EPS * (Q // n) ** 0.5 * scale
                part_ok = bool(((got - want).abs() <= 4 * part_bar).all())
                if (max(errs) > 1e-6 or not torch.allclose(s_norm, pn_, rtol=1e-5, atol=1e-7)
                        or not part_ok):
                    raise AssertionError(f"gn_sum_step at N = {n}, rank {r}, lanes {lanes} vs "
                                         f"its plain version: t, q {errs}, H and b "
                                         f"{(got - want).abs().max().item()}, "
                                         f"{((got - want).abs() / part_bar).max().item():.3g} "
                                         f"eps sqrt(Q / N) of their terms' magnitudes")
                max_err = max(max_err, *errs)
                part_err = max(part_err, (got - want).abs().max().item())
                part_share = max(part_share, ((got - want).abs() / part_bar).max().item())
            if lanes and not (
                    torch.equal(e_pose.t[3], pose.t[3]) and torch.equal(s_pose.q[3], pose.q[3])
                    and float(s_norm[3]) == 0.5 and float(e_norm[3]) == 0.5):
                raise AssertionError(f"N = {n}: the inactive lane's pose or step norm moved")
            # times at N = 2 (phase 10's split) and 4 (four cards), this
            # rank's slice the last one's
            if n > 1:
                B = lanes[0] if lanes else 1
                Qr = Q // n
                work = GnWork.empty(1, device, lanes)
                key = (n, B)
                timed[key] = dict(
                    sum_ms=time_ms(lambda: gn_sum_step(parts, part_corr, pose, guess_t, cfg,
                                                       work=work, **kw), 200),
                    sum_plain_ms=time_ms(lambda: gn_sum_step_plain(parts, part_corr, pose,
                                                                   guess_t, cfg, **kw),
                                         20 if not lanes else 3),
                    e_ms=time_ms(lambda: gn_epilogue(parts, pose, guess_t, cfg, work=work, **kw),
                                 200),
                    e_plain_ms=time_ms(lambda: gn_epilogue_sum_plain(parts, pose, guess_t, cfg,
                                                                     **kw),
                                       20 if not lanes else 3),
                    # gn_sum_step: the rank's rows (37 B each), the parts, the
                    # pose and guess read; the new pose and part written; ~100
                    # flops a row, ~500 for the epilogue and 27 (N - 1) adds
                    sum_bound=bound_ms(B * (Qr * 37 + n * 168 + 40 + 32 + 168),
                                       B * (100 * Qr + 500 + 27 * (n - 1))),
                    # K2e: the parts, the pose and guess read, the pose written
                    e_bound=bound_ms(B * (n * 168 + 40 + 32), B * (500 + 27 * (n - 1))))
    gn_epilogue.launches = gn_sum_step.launches = 0
    for (n, B), t in sorted(timed.items()):
        log(f"kernel gn_sum_step (K2, split step) at N = {n}, B = {B}, Q = {Q // n} per rank: "
            f"{t['sum_ms']:.4f} ms, plain {t['sum_plain_ms']:.4f} ms, bound "
            f"{t['sum_bound'][0]:.6f} ms ({t['sum_bound'][1]}); K2e {t['e_ms']:.4f} ms, plain "
            f"{t['e_plain_ms']:.4f} ms, bound {t['e_bound'][0]:.8f} ms ({t['e_bound'][1]})")
    log(f"kernels gn_sum_step and K2e (gn_epilogue) at N = 1, 2, 4 and B = 1, 8 (lane 3 "
        f"inactive): bitwise the rank-order sum, K2e and jtwj_accumulate they replace (K2e at "
        f"N = 1 bitwise the fused step); pose {max_err:.3g} from the plain versions, part "
        f"{part_err:.3g} ({part_share:.3g} eps sqrt(Q / N) of its terms' magnitudes, bar 4) "
        f"from the plain accumulation at the kernel's pose")
    main, b8, n4 = timed[(2, 1)], timed[(2, 8)], timed[(4, 1)]
    common = dict(route="cuda", source="lidar_odometry_demo_tpu_torch/kernels/jtwj.cu",
                  replaces="lidar_odometry_demo_tpu/ops/pallas/jtwj.py:101", library_ms=None)
    summed = dict(name="gn_sum_step", **common, max_abs_err=max(max_err, part_err),
                  ms=main["sum_ms"], plain_ms=main["sum_plain_ms"], bound_ms=main["sum_bound"][0],
                  bound_by=main["sum_bound"][1], ms_b8=b8["sum_ms"],
                  plain_ms_b8=b8["sum_plain_ms"], bound_ms_b8=b8["sum_bound"][0],
                  ms_n4=n4["sum_ms"], bound_ms_n4=n4["sum_bound"][0])
    epilogue = dict(name="gn_epilogue", **common, max_abs_err=max_err, ms=main["e_ms"],
                    plain_ms=main["e_plain_ms"], bound_ms=main["e_bound"][0],
                    bound_by=main["e_bound"][1], ms_b8=b8["e_ms"], plain_ms_b8=b8["e_plain_ms"],
                    bound_ms_b8=b8["e_bound"][0], ms_n4=n4["e_ms"],
                    bound_ms_n4=n4["e_bound"][0])
    return summed, epilogue


def check_loop_condition(rng, device) -> dict:
    """The ICP loop's condition kernel (kernels/loop.cu, the counterpart of
    the JAX `lax.while_loop`'s `cond`) against its plain version, bitwise
    (a bool per lane), at the main path's carry (one sequence) and the
    fleet's (B = 8), the step norm read at K2's lane stride; 100 carries
    each, drawn around every threshold (rounds 0-36 against the minimum 4
    and the cap 35, stall 0-4 against 3, step norms at and beside the
    tolerance). CUDA event times of the kernel and its plain version."""
    import torch

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import GnWork
    from lidar_odometry_demo_tpu_torch.kernels.loop import loop_condition, loop_condition_plain

    cfg = OdometryConfig()
    tol = np.float32(cfg.icp_convergence_step_norm)
    norms = np.array([0.0, np.nextafter(tol, np.float32(0)), tol,
                      np.nextafter(tol, np.float32(1)), 2e-4, 1e9], np.float32)
    up = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    out, seen = {}, set()
    for lead in ((), (8,)):
        work = GnWork.empty(cfg.icp_inner_iterations, device, lead)
        norm = work.slots[-1][1]
        go = torch.empty(lead, dtype=torch.bool, device=device)
        for _ in range(100):
            iters = up(rng.integers(0, 37, lead).astype(np.int32))
            stall = up(rng.integers(0, 5, lead).astype(np.int32))
            norm.copy_(up(rng.choice(norms, lead)))
            got = loop_condition(iters, stall, norm, cfg, out=go).clone()
            want = loop_condition_plain(iters, stall, norm, cfg)
            if not torch.equal(got, want):
                raise AssertionError(f"loop_condition at lanes {lead}: {got} != plain {want}")
            seen.update(want.reshape(-1).tolist())
        B = lead[0] if lead else 1
        out[B] = dict(
            ms=time_ms(lambda: loop_condition(iters, stall, norm, cfg, out=go), 200),
            plain_ms=time_ms(lambda: loop_condition_plain(iters, stall, norm, cfg), 200),
            # the carry read once (rounds, stall, step norm: 12 bytes a lane),
            # the condition written (a byte a lane); ~6 operations a lane
            bound=bound_ms(13 * B, 6 * B))
    if seen != {True, False}:
        raise AssertionError(f"loop_condition: the carries gave only {seen}")
    b1, b8 = out[1], out[8]
    log(f"kernel loop_condition (the ICP loop's condition) at B = 1 and 8: bitwise its plain "
        f"version on 200 carries; {b1['ms']:.4f} / {b8['ms']:.4f} ms, plain "
        f"{b1['plain_ms']:.4f} / {b8['plain_ms']:.4f} ms, bound {b1['bound'][0]:.2e} / "
        f"{b8['bound'][0]:.2e} ms ({b1['bound'][1]})")
    return dict(name="loop_condition", route="cuda",
                source="lidar_odometry_demo_tpu_torch/kernels/loop.cu",
                replaces="lidar_odometry_demo_tpu/ops/icp.py:267", max_abs_err=0.0,
                ms=b1["ms"], plain_ms=b1["plain_ms"], bound_ms=b1["bound"][0],
                bound_by=b1["bound"][1], library_ms=None, ms_b8=b8["ms"],
                plain_ms_b8=b8["plain_ms"], bound_ms_b8=b8["bound"][0])


# --------------------------------------------------------------------------
# phases 3 and 5: the main path and the strict reference path
# --------------------------------------------------------------------------

def counters() -> dict:
    """The launch-counted kernel wrappers, by kernel name: K1, K2, K3, the
    ICP loop's condition (before an ICP loop's first round and after each
    round, eager or captured) and the step's front end (one count a step,
    of four launches)."""
    from lidar_odometry_demo_tpu_torch.kernels.correspondence import match_rows
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import jtwj_accumulate
    from lidar_odometry_demo_tpu_torch.kernels.loop import loop_condition
    from lidar_odometry_demo_tpu_torch.kernels.map_update import map_update
    from lidar_odometry_demo_tpu_torch.kernels.prepare import prepare
    from lidar_odometry_demo_tpu_torch.kernels.search import search_sorted

    return {"match_rows": match_rows, "jtwj_accumulate": jtwj_accumulate,
            "search_sorted": search_sorted, "loop_condition": loop_condition,
            "prepare": prepare, "map_update": map_update}


def zero_counts(counted: dict | None = None) -> None:
    """Every count of `counted` (default: counters()) set to 0, after the
    rounds the captured loops ran so far are added (so none is added
    later)."""
    from lidar_odometry_demo_tpu_torch.pipeline.graphs import settle_launches

    settle_launches()
    for fn in (counted or counters()).values():
        fn.launches = 0


def read_counts(counted: dict | None = None) -> dict:
    """The counts of `counted` (default: counters()), the rounds the
    captured loops ran added first (a wait for the device)."""
    from lidar_odometry_demo_tpu_torch.pipeline.graphs import settle_launches

    settle_launches()
    return {name: fn.launches for name, fn in (counted or counters()).items()}


def loop_schedule(iters: np.ndarray) -> int:
    """The condition kernel's launches over a drive without a group, eager
    or captured scans alike: per step that ran ICP one before its first
    round and one per round (a step's rounds are its slowest lane's)."""
    per_step = iters.reshape(len(iters), -1).max(axis=1)
    ran = per_step[per_step > 0]
    return int(ran.sum()) + len(ran)


def bench_drive(device) -> dict:
    """The 40-scan bench drive at full width, uploaded, with its ground
    truth and the JAX package's pinned trajectory."""
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
    from lidar_odometry_demo_tpu_torch.io.trajectory import read_tum
    from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy

    cfg = OdometryConfig()
    num_scans = 40
    t0 = time.perf_counter()
    drive = simulate_sequence(num_scans=num_scans, width=cfg.scan_width, seed=42,
                              speed=5.0, yaw_rate=0.08)
    scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             cfg.max_raw_points, device) for s in drive.scans]
    log(f"main path: simulated and uploaded {num_scans} scans in "
        f"{time.perf_counter() - t0:.1f} s")
    g0 = drive.gt_q[0]
    g0_R = Rotation.from_quat([g0[1], g0[2], g0[3], g0[0]])
    _, ref_t, _ = read_tum(os.path.join(REPO, "benchmarks", "BASELINE_REF.tum"))
    return dict(scans=scans, gt_rel=g0_R.inv().apply(drive.gt_t - drive.gt_t[0]),
                ref_t=ref_t, range_images=[(s["range_image"], s["scan_start"])
                                           for s in drive.scans])


def drive_path(name: str, cfg, bench: dict, device, *, ate_gt=None, ate_ref_max=None):
    """One timed pass of the bench drive through LidarOdometry(cfg) with
    every launch count set to 0 just before it and read just after; checks
    accuracy (ATE under 0.03 m; within 1e-4 m of `ate_gt` and under
    `ate_ref_max` against BASELINE_REF.tum where given), divergence and the
    K1 / K2 schedule. Returns (odometry, launches, iterations per scan,
    per-scan diagnostics, ms per scan)."""
    import torch

    from lidar_odometry_demo_tpu_torch.io.trajectory import ate_rmse
    from lidar_odometry_demo_tpu_torch.ops.voxel_map import map_size
    from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry

    scans = bench["scans"]
    num_scans = len(scans)
    odo = LidarOdometry(cfg, device=device)
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    diags = [odo.process_scan(scan) for scan in scans]
    end.record()
    end.synchronize()
    launches = read_counts()
    ms_per_scan = start.elapsed_time(end) / num_scans

    est = np.stack([d.pose.t.cpu().numpy() for d in diags])
    iters = np.array([int(d.icp_iterations) for d in diags])
    diverged = np.array([bool(d.diverged) for d in diags])
    if not np.all(np.isfinite(est)) or est.shape != (num_scans, 3):
        raise AssertionError(f"{name}: non-finite or misshapen poses")
    ate = ate_rmse(est, bench["gt_rel"], align=True)
    ate_ref = ate_rmse(est, bench["ref_t"], align=True)
    occupancy = int(map_size(odo.state.keyframe))
    rounds = int(iters.sum())
    icp_scans = int(np.sum(iters > 0))
    log(f"{name}: {ms_per_scan:.3f} ms/scan, {1e3 / ms_per_scan:.2f} scans/s "
        f"(CUDA events, {num_scans} scans)")
    log(f"{name}: aligned ATE {ate:.5f} m vs ground truth, {ate_ref:.5f} m vs "
        f"benchmarks/BASELINE_REF.tum")
    log(f"{name}: map occupancy {occupancy} / {cfg.map_capacity} voxels, mean ICP "
        f"rounds {rounds / max(icp_scans, 1):.2f} over {icp_scans} scans (max "
        f"{iters.max()}), diverged {int(diverged.sum())}, launches {launches}")

    if min(launches.values()) == 0:
        raise AssertionError(f"{name}: a kernel was not launched: {launches}")
    if launches["match_rows"] != rounds:
        raise AssertionError(f"{name}: K1 launches {launches['match_rows']} != ICP rounds {rounds}")
    if launches["jtwj_accumulate"] != cfg.icp_inner_iterations * rounds:
        raise AssertionError(
            f"{name}: K2 launches {launches['jtwj_accumulate']} != 4 x ICP rounds {rounds}")
    for kernel in ("prepare", "map_update"):
        if launches[kernel] != num_scans:
            raise AssertionError(f"{name}: {kernel} calls {launches[kernel]} != scans "
                                 f"{num_scans} (one a step, eager or captured)")
    want_loop = loop_schedule(iters)
    if launches["loop_condition"] != want_loop:
        raise AssertionError(f"{name}: condition launches {launches['loop_condition']} != "
                             f"ICP scans + their rounds {want_loop}")
    if ate > 0.03:
        raise AssertionError(f"{name}: aligned ATE {ate:.4f} m exceeds 0.03 m")
    if ate_gt is not None and abs(ate - ate_gt) > 1e-4:
        raise AssertionError(f"{name}: aligned ATE {ate:.5f} m is not within 1e-4 m of "
                             f"{ate_gt} m")
    if ate_ref_max is not None and ate_ref > ate_ref_max:
        raise AssertionError(f"{name}: {ate_ref:.5f} m from BASELINE_REF.tum exceeds "
                             f"{ate_ref_max} m")
    if diverged.any():
        raise AssertionError(f"{name}: {int(diverged.sum())} scans diverged")
    return odo, launches, iters, diags, ms_per_scan


def run_main_path(bench: dict, device):
    import torch

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry

    cfg = OdometryConfig()
    t0 = time.perf_counter()
    warm = LidarOdometry(cfg, device=device)
    for scan in bench["scans"]:
        warm.process_scan(scan)
    torch.cuda.synchronize()
    log(f"main path: warm-up pass {time.perf_counter() - t0:.1f} s")
    # the JAX package's figure on this drive, which the port has held: 0.00936 m
    odo, launches, iters, diags, ms_per_scan = drive_path("main path", cfg, bench, device,
                                                          ate_gt=0.00936)
    # K3: the neighbourhood lookup of each ICP scan's one candidate gather,
    # and the group lookup of every scan's map_update
    want = int(np.sum(iters > 0)) + len(iters)
    if launches["search_sorted"] != want:
        raise AssertionError(f"main path: K3 launches {launches['search_sorted']} != ICP "
                             f"scans + map_update calls {want}")
    return odo, launches, diags, ms_per_scan


def run_reference_parity(bench: dict, device):
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig, reference_parity

    cfg = reference_parity(OdometryConfig())
    # the NumPy oracle's own trajectory, which this path reproduces
    odo, launches, iters, diags, _ = drive_path("reference_parity path", cfg, bench, device,
                                                ate_ref_max=0.0005)
    # K3: one neighbourhood lookup per ICP round (the map re-searched at the
    # round's pose), one per map_update (every scan)
    want = int(iters.sum()) + len(iters)
    if launches["search_sorted"] != want:
        raise AssertionError(f"reference_parity path: K3 launches {launches['search_sorted']}"
                             f" != ICP rounds + map_update calls {want}")
    return odo, launches, diags


def _front_end_diffs(got, want) -> list:
    """The outputs of two front-end calls that differ bitwise (the normals
    compared on planar cells: the kernel leaves cells outside the normals
    window at zero, where the plain version computes from wrapped rows)."""
    v = want.planar.valid
    pairs = dict(valid=(got.planar.valid, v), xyz=(got.planar.xyz, want.planar.xyz),
                 normal=(got.planar.normal[v], want.planar.normal[v]),
                 num_planar=(got.num_planar, want.num_planar),
                 update_keys=(got.update_keys, want.update_keys),
                 match_keys=(got.match_keys, want.match_keys),
                 guess_t=(got.guess.t, want.guess.t), guess_q=(got.guess.q, want.guess.q),
                 deskewed_xyz=(got.deskewed_xyz, want.deskewed_xyz))
    return [k for k, (a, b) in pairs.items() if not _bitwise(a, b)]


def check_prepare(bench: dict, diags: list, device) -> dict:
    """Phase 3's front end (kernels/prepare.cu: ScanStep.prepare up to the
    downsample sorts) against its plain version on the card, bitwise (every
    output, the normals on planar cells), on the bench drive's scans 2-39
    deskewed between the main path's poses as the step did, at B = 1 and at
    B = 8 (scans 32-39 as lanes); each lane of the B = 8 call bitwise its
    B = 1 call; two calls bitwise equal; four device operations a call under
    torch.profiler. CUDA event times of the kernel and its plain version at
    B = 1 and 8, beside the bound (bytes: the raw scan read, the image's
    points, normals, mask and two key arrays written)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.kernels.prepare import prepare, prepare_plain
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
    from lidar_odometry_demo_tpu_torch.ops.se3 import Pose

    cfg = OdometryConfig()
    scans, poses = bench["scans"], [d.pose for d in diags]

    def args_at(idx):
        """(previous, current, scan, cfg, return_deskewed) of scan idx, or
        of the scans in list idx as lanes."""
        if isinstance(idx, int):
            return poses[idx - 2], poses[idx - 1], scans[idx], cfg, True
        prev = Pose(*(torch.stack([getattr(poses[i - 2], f) for i in idx]) for f in Pose._fields))
        cur = Pose(*(torch.stack([getattr(poses[i - 1], f) for i in idx]) for f in Pose._fields))
        raw = LidarScan(*(torch.stack([getattr(scans[i], f) for i in idx])
                          for f in LidarScan._fields))
        return prev, cur, raw, cfg, True

    before = prepare.launches
    for s in range(2, len(scans)):
        got = prepare(*args_at(s))
        bad = _front_end_diffs(got, prepare_plain(*args_at(s)))
        if bad:
            raise AssertionError(f"front end, bench scan {s}: {bad} differ from the plain version")
    lanes8 = list(range(len(scans) - 8, len(scans)))
    a1, a8 = args_at(lanes8[-1]), args_at(lanes8)
    got8 = prepare(*a8)
    bad = _front_end_diffs(got8, prepare_plain(*a8))
    bad += _front_end_diffs(got8, prepare(*a8))
    for b, s in enumerate(lanes8):
        one = prepare(*args_at(s))
        bad += [f"lane {b}: {k}" for k in _front_end_diffs(_lane(got8, b), one)]
    if bad:
        raise AssertionError(f"front end at B = 8: {bad} differ")
    calls = prepare.launches - before
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            prepare(*a1)
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")
    if ops != 40:
        raise AssertionError(f"front end: {ops} device operations in 10 calls (4 a call asked)")
    N, RW = cfg.max_raw_points, cfg.num_rings * cfg.scan_width
    out = {}
    for B, a in ((1, a1), (8, a8)):
        out[B] = dict(ms=time_ms(lambda a=a: prepare(*a), 200),
                      plain_ms=time_ms(lambda a=a: prepare_plain(*a), 20),
                      # raw xyz, ring, time, valid (21 bytes a point) in; the
                      # image's xyz, normal, mask, two keys (33 a cell) out;
                      # ~80 operations a point (deskew, cell), ~135 a cell
                      bound=bound_ms(B * (21 * N + 33 * RW), B * (80 * N + 135 * RW)))
    b1, b8 = out[1], out[8]
    log(f"kernel prepare (the step's front end): bitwise its plain version on {len(scans) - 2} "
        f"bench scans at B = 1 and on 8 lanes at B = 8 (every lane its B = 1 call), two calls "
        f"equal, {calls} calls, 4 device operations a call; {b1['ms']:.4f} / {b8['ms']:.4f} ms "
        f"at B = 1 / 8, plain {b1['plain_ms']:.4f} / {b8['plain_ms']:.4f} ms, bound "
        f"{b1['bound'][0]:.5f} / {b8['bound'][0]:.5f} ms ({b1['bound'][1]})")
    return dict(name="prepare", route="cuda",
                source="lidar_odometry_demo_tpu_torch/kernels/prepare.cu", replaces=None,
                max_abs_err=0.0, ms=b1["ms"], plain_ms=b1["plain_ms"], bound_ms=b1["bound"][0],
                bound_by=b1["bound"][1], library_ms=None, ms_b8=b8["ms"],
                plain_ms_b8=b8["plain_ms"], bound_ms_b8=b8["bound"][0], device_ops_per_call=4)


def map_update_calls(bench: dict, device, first: int) -> list:
    """The map update's arguments (map, update points, keywords), cloned, of
    the bench drive's scans `first`.. through the eager step on the card."""
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.pipeline import odometry

    cfg = OdometryConfig()
    step, state = odometry.make_process_scan(cfg), odometry.init_state(cfg, device)
    calls, index, original = [], itertools.count(), odometry.update_map

    def clone(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(_clone(v) for v in x))
        return _clone(x)

    def record(m, new, **kwargs):
        if next(index) >= first:
            calls.append((clone(m), clone(new), {k: clone(v) for k, v in kwargs.items()}))
        return original(m, new, **kwargs)

    odometry.update_map = record
    try:
        for scan in bench["scans"]:
            state, _ = step(state, scan)
    finally:
        odometry.update_map = original
    return calls


def _update_diffs(got, want) -> list:
    """The outputs of two map-update calls that differ bitwise (the whole
    table, keys, count, origin, size, dropped)."""
    pairs = {f: (getattr(got.keyframe, f), getattr(want.keyframe, f))
             for f in ("tab", "keys", "count", "origin")}
    pairs.update(size=(got.size, want.size), dropped=(got.dropped, want.dropped))
    return [k for k, (a, b) in pairs.items() if not _bitwise(a, b)]


def check_map_update(bench: dict, device) -> dict:
    """Phase 3's map update (kernels/map_update.cu: ScanStep.update's world
    transform, evict + rebase + insert and diagnostics) against its plain
    version on the card, bitwise (the whole table, keys, count, origin, size,
    dropped), on the eager step's calls of the bench drive's scans 32-39 (a
    saturated map) at B = 1, into a new table and in place, and at B = 8 (the
    eight calls as lanes, each lane bitwise its B = 1 call); one count a call;
    device operations a call under torch.profiler. CUDA event times of the
    kernels (in place, as the captured step runs them) and of the plain
    version at B = 1 and 8, beside the bound (bytes: each lane's table read
    and written by the scratch copy and by the assembly, the points), and the
    table passes' (the prologue with its copy, the assembly) effective TB/s
    over those bytes in the profiler's times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lidar_odometry_demo_tpu_torch.kernels.map_update import map_update, map_update_plain
    from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm

    calls = map_update_calls(bench, device, first=32)
    before = map_update.launches
    ones = []
    for s, (m, new, kw) in enumerate(calls):
        want = map_update_plain(m, new, **kw)
        got = map_update(m, new, **kw)
        tab = m.tab.clone()
        bad = _update_diffs(got, want)
        bad += [f"in place: {k}" for k in _update_diffs(
            map_update(m._replace(tab=tab), new, **dict(kw, tab_out=tab)), want)]
        if bad:
            raise AssertionError(f"map update, bench scan {32 + s}: {bad} differ from the plain "
                                 f"version")
        ones.append(got)

    def stack(xs):
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(stack([x[i] for x in xs]) for i in range(len(xs[0]))))
        return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else xs[0]

    m8, new8 = stack([c[0] for c in calls]), stack([c[1] for c in calls])
    kw8 = {k: stack([c[2][k] for c in calls]) for k in calls[0][2]}
    got8 = map_update(m8, new8, **kw8)
    bad = _update_diffs(got8, map_update_plain(m8, new8, **kw8))
    for b, one in enumerate(ones):
        bad += [f"lane {b}: {k}" for k in _update_diffs(_lane(got8, b), one)]
    if bad:
        raise AssertionError(f"map update at B = 8: {bad} differ")
    n_calls = map_update.launches - before
    occupancy = [int(o.size) for o in ones]

    def in_place(m, new, kw):
        """A call as the captured step makes it: into the map's own table
        (a copy of it, so the recorded calls stay as they were)."""
        mc = m._replace(tab=m.tab.clone())
        return lambda: map_update(mc, new, **dict(kw, tab_out=mc.tab))

    m1, new1, kw1 = calls[-1]
    run1, run8 = in_place(m1, new1, kw1), in_place(m8, new8, kw8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run1()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    ops = sum(e.count for e in events) / 10
    names = sorted({e.key for e in events})
    with profile(activities=[ProfilerActivity.CUDA]) as prof8:
        for _ in range(10):
            run8()
        torch.cuda.synchronize()
    table_us = {B: sum(e.self_device_time_total for e in p.key_averages()
                       if e.device_type.name == "CUDA"
                       and ("prologue_kernel" in e.key or "assemble_kernel" in e.key)) / 10
                for B, p in ((1, prof), (8, prof8))}
    C, K, N = m1.capacity, m1.max_points, new1.valid.shape[-1]
    _, _, W = vm._lanes(K)
    out = {}
    for B, run, args in ((1, run1, (m1, new1, kw1)), (8, run8, (m8, new8, kw8))):
        table_bytes = B * 4 * C * W * 4   # copy and assembly: each reads and writes the table
        out[B] = dict(ms=time_ms(run, 100),
                      plain_ms=time_ms(lambda a=args: map_update_plain(a[0], a[1], **a[2]), 10),
                      # + the points and normals in and their world copies out and
                      # back, keys and counts in and out
                      bound=bound_ms(table_bytes + B * (N * 73 + C * 16), B * (N * 120 + C * 20)),
                      table_ms=table_us[B] / 1e3,
                      table_tb_per_s=table_bytes / (table_us[B] * 1e-6) / 1e12)
    b1, b8 = out[1], out[8]
    log(f"kernel map_update (the step's map update): bitwise its plain version on "
        f"{len(calls)} bench calls (occupancy {min(occupancy)}-{max(occupancy)} of {C}) at B = 1, "
        f"new and in place, and at B = 8 (every lane its B = 1 call), {n_calls} calls; "
        f"{ops:g} device operations a call ({', '.join(names)}); {b1['ms']:.4f} / "
        f"{b8['ms']:.4f} ms at B = 1 / 8 in place, plain {b1['plain_ms']:.4f} / "
        f"{b8['plain_ms']:.4f} ms, bound {b1['bound'][0]:.5f} / {b8['bound'][0]:.5f} ms "
        f"({b1['bound'][1]}); table passes {b1['table_ms']:.4f} / {b8['table_ms']:.4f} ms, "
        f"{b1['table_tb_per_s']:.2f} / {b8['table_tb_per_s']:.2f} TB/s")
    if n_calls != 2 * len(calls) + 1:
        raise AssertionError(f"map update: {n_calls} counted for {2 * len(calls) + 1} calls")
    return dict(name="map_update", route="cuda",
                source="lidar_odometry_demo_tpu_torch/kernels/map_update.cu", replaces=None,
                max_abs_err=0.0, ms=b1["ms"], plain_ms=b1["plain_ms"], bound_ms=b1["bound"][0],
                bound_by=b1["bound"][1], library_ms=None, ms_b8=b8["ms"],
                plain_ms_b8=b8["plain_ms"], bound_ms_b8=b8["bound"][0],
                device_ops_per_call=ops, table_ms=b1["table_ms"], table_ms_b8=b8["table_ms"],
                table_tb_per_s=b1["table_tb_per_s"], table_tb_per_s_b8=b8["table_tb_per_s"])


# --------------------------------------------------------------------------
# phase 4: K3's three modes against their plain versions
# --------------------------------------------------------------------------

def _clone(x):
    import torch

    return x.clone() if isinstance(x, torch.Tensor) else x


def path_lookups(odo, scan) -> dict:
    """K3's lookups of one more step of the bench drive from a path's final
    state, recorded with their inputs (cloned: the exact path rewrites its
    pose buffers every round): {"neighbourhood": [(args, kwargs), ...],
    "group": [(keys, queries), ...]}. Their launches are not counted:
    counts are zeroed before every drive."""
    from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_demo_tpu_torch.pipeline.odometry import make_process_scan

    calls = {"neighbourhood": [], "group": []}
    neighbourhood, group = vm.neighborhood_lookup, vm.group_lookup

    def recorded_neighbourhood(*args, **kwargs):
        calls["neighbourhood"].append((tuple(_clone(a) for a in args),
                                       {k: v for k, v in kwargs.items() if k != "out"}))
        return neighbourhood(*args, **kwargs)

    def recorded_group(keys, queries):
        calls["group"].append((keys.clone(), queries.clone()))
        return group(keys, queries)

    vm.neighborhood_lookup, vm.group_lookup = recorded_neighbourhood, recorded_group
    try:
        make_process_scan(odo.cfg)(odo.state, scan)
    finally:
        vm.neighborhood_lookup, vm.group_lookup = neighbourhood, group
    if not calls["neighbourhood"] or len(calls["group"]) != 1:
        raise AssertionError(f"expected neighbourhood lookups and one group lookup in one "
                             f"step, saw {len(calls['neighbourhood'])} and {len(calls['group'])}")
    return calls


def check_lookups(label: str, lookups: dict) -> int:
    """Every recorded neighbourhood and group lookup, the kernel against its
    plain version, bitwise: base and n_present everywhere, the present rows,
    pos_c and found. Returns the first neighbourhood lookup's present-slice
    count."""
    import torch

    from lidar_odometry_demo_tpu_torch.kernels.search import (
        group_lookup, group_lookup_plain, neighborhood_lookup, neighborhood_lookup_plain)

    present = None
    for i, (args, kwargs) in enumerate(lookups["neighbourhood"]):
        got = neighborhood_lookup(*args, **kwargs)
        ref = neighborhood_lookup_plain(*args, **kwargs)
        torch.cuda.synchronize()
        bad = [f for f in ("base", "n_present") if not torch.equal(getattr(got, f),
                                                                    getattr(ref, f))]
        npres = ref.n_present.reshape(-1)
        bad += [f"rows of slice {s}" for s in range(3)
                if not torch.equal(got.rows_z[s][npres > s], ref.rows_z[s][npres > s])]
        if bad:
            raise AssertionError(f"K3 neighbourhood lookup {i} on the {label}: {bad} differ")
        if present is None:
            present = int(npres.sum())
    keys, q = lookups["group"][0]
    pos_c, found = group_lookup(keys, q)
    ref_pos, ref_found = group_lookup_plain(keys, q)
    torch.cuda.synchronize()
    if not (torch.equal(pos_c, ref_pos) and torch.equal(found, ref_found)):
        raise AssertionError(f"K3 group lookup on the {label}: pos_c differs at "
                             f"{int((pos_c != ref_pos).sum())}, found at "
                             f"{int((found != ref_found).sum())} queries")
    log(f"K3 on the {label}: {len(lookups['neighbourhood'])} neighbourhood lookups and the "
        f"group lookup equal to their plain versions (bitwise); {present} present slices "
        f"in the first, {int(found.sum())} of {q.numel()} groups found")
    return present


def _bare_search_checks(device, lookups: dict) -> dict:
    """The bare search against its plain version and torch.searchsorted,
    index equal: on the main path's two key sets (the neighbourhood lookup's
    start keys, map_update's sorted queries), the TPU script's fixture, the
    edges and no queries. Returns {label: (keys, queries)} of the shapes."""
    import torch

    from lidar_odometry_demo_tpu_torch.kernels.search import (
        neighborhood_start_keys, search_sorted, search_sorted_plain)
    from lidar_odometry_demo_tpu_torch.ops.voxel_map import EMPTY_KEY

    def agree(label, keys, q):
        got = search_sorted(keys, q)
        plain = search_sorted_plain(keys, q)
        lib = torch.searchsorted(keys, q, side="left", out_int32=True)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != q.shape:
            raise AssertionError(f"K3 {label}: {got.dtype} {tuple(got.shape)}")
        for ref, ref_name in ((plain, "plain version"), (lib, "torch.searchsorted")):
            if not torch.equal(got, ref):
                raise AssertionError(f"K3 {label}: differs from the {ref_name} at "
                                     f"{int((got != ref).sum())} of {q.numel()} queries")
        return got

    (tab, keys, origin, *pose_args), kwargs = lookups["neighbourhood"][0]
    start = neighborhood_start_keys(origin, *pose_args, voxel_size=kwargs["voxel_size"])
    rng = np.random.default_rng(0)
    C = 131072
    fix_keys = torch.from_numpy(np.sort(rng.integers(0, 2**31, C)).astype(np.int32)).to(device)
    fix_q = torch.from_numpy(rng.integers(0, 2**31, 8192 * 27).astype(np.int32)).to(device)
    shapes = {"neighbourhood start keys": (keys, start),
              "map_update queries": lookups["group"][0],
              "TPU script fixture": (fix_keys, fix_q)}
    for label, (k, q) in shapes.items():
        agree(label, k, q)

    # the edges, on the main path's map (EMPTY_KEY tail) and on a tail-free table
    n_live = int((keys != EMPTY_KEY).sum())
    k = keys.cpu().numpy().astype(np.int64)
    gaps = np.nonzero(np.diff(k[:n_live]) >= 2)[0]
    if n_live < 2 or n_live == keys.numel() or gaps.size == 0:
        raise AssertionError(f"K3 edges: the map's keys do not present every edge ({n_live} live)")
    g = int(gaps[0])  # k[g] < k[g] + 1 < k[g + 1]: strictly between two keys
    # below keys[0]; equal to keys[0]; keys[0] < q <= keys[1] (where 17 steps
    # stop at 0); strictly between two keys; equal to a key; the last live
    # key and one above it; the EMPTY_KEY run (its lower bound)
    edges = torch.tensor([k[0] - 1, k[0], k[1], k[g] + 1, k[n_live // 2], k[n_live - 1],
                          k[n_live - 1] + 1, EMPTY_KEY], dtype=torch.int32, device=device)
    got = agree("edges on the map", keys, edges).cpu().numpy()
    want = [0, 0, 1, g + 1, n_live // 2, n_live - 1, n_live, n_live]
    if list(got) != want:
        raise AssertionError(f"K3 edges: {list(got)} != {want}")
    got = agree("above every key", fix_keys, torch.tensor(
        [2**31 - 1, int(fix_keys[-1]) + 1], dtype=torch.int32, device=device))
    if got.tolist() != [C, C]:
        raise AssertionError(f"K3 above every key: {got.tolist()} != [{C}, {C}]")
    before = search_sorted.launches
    empty = search_sorted(keys, torch.zeros(0, dtype=torch.int32, device=device))
    torch.cuda.synchronize()
    if empty.shape != (0,) or search_sorted.launches != before:
        raise AssertionError("K3 with no queries must return an empty tensor without a launch")
    return shapes


def _time_modes(lookups: dict, shapes: dict, n_present: int) -> list[dict]:
    """CUDA event times of each mode at the main path's shapes: the kernel
    alone and as dispatched, its plain version and, where one PyTorch call
    computes the same function, that call; with each mode's bound."""
    import torch

    from lidar_odometry_demo_tpu_torch.kernels.search import (
        group_lookup, group_lookup_plain, neighborhood_lookup, neighborhood_lookup_plain,
        search_sorted, search_sorted_plain, search_steps)

    args, kwargs = lookups["neighbourhood"][0]
    tab, keys = args[0], args[1]
    C, W = tab.shape
    Q, RW = args[3].shape[0], kwargs["row_width"]
    out = neighborhood_lookup(*args, **kwargs)
    gkeys, gq = lookups["group"][0]
    steps = search_steps(C)

    def library(k, q):
        return torch.searchsorted(k, q, side="left", out_int32=True)

    modes = [
        # (mode, shape, fn, plain, library call, bytes, operations)
        ("neighbourhood lookup", f"Q={Q} (9Q={9 * Q} columns), C={C}, RW={RW}, "
         f"{n_present} present slices",
         lambda: neighborhood_lookup(*args, **kwargs, out=out),
         lambda: neighborhood_lookup_plain(*args, **kwargs), None,
         # queries, flags, pose, origin, the keys once, base and n_present,
         # each present row read and written
         13.0 * Q + 60 + 4.0 * C + 8.0 * 9 * Q + 2.0 * 4 * RW * n_present,
         9.0 * Q * (24 + steps)),
        ("group lookup", f"N={gq.numel()} sorted, C={gkeys.numel()}",
         lambda: group_lookup(gkeys, gq), lambda: group_lookup_plain(gkeys, gq), None,
         4.0 * gkeys.numel() + 9.0 * gq.numel(), float(gq.numel() * (steps + 2))),
    ]
    for label, (k, q) in shapes.items():
        modes.append((f"bare search, {label}", f"N={q.numel()}, C={k.numel()}",
                      lambda k=k, q=q: search_sorted(k, q),
                      lambda k=k, q=q: search_sorted_plain(k, q),
                      lambda k=k, q=q: library(k, q),
                      4.0 * k.numel() + 8.0 * q.numel(), float(q.numel() * steps)))
    timed = []
    for mode, shape, fn, plain, lib, n_bytes, n_ops in modes:
        ms = time_ms(fn, 200)
        call_ms = time_ms(fn, 200, queue_first=False)
        plain_ms = time_ms(plain, 10)
        library_ms = time_ms(lib, 200) if lib is not None else None
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        log(f"kernel search_sorted (K3), {mode}: {shape}; max_abs_err=0 kernel {ms:.4f} ms "
            f"on the card ({call_ms:.4f} ms per call as dispatched), plain {plain_ms:.4f} ms, "
            + (f"torch.searchsorted {library_ms:.4f} ms, " if lib is not None else "")
            + f"bound {b_ms:.5f} ms ({b_by})")
        timed.append(dict(mode=mode, shape=shape, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=b_ms, bound_by=b_by))
    # the group lookup's search part alone, by the library
    timed[1]["searchsorted_ms"] = time_ms(lambda: library(gkeys, gq), 200)
    return timed


def check_search(device, main_lookups: dict) -> dict:
    import torch

    present = check_lookups("main path's map", main_lookups)
    shapes = _bare_search_checks(device, main_lookups)
    timed = _time_modes(main_lookups, shapes, present)
    x = torch.zeros(1, device=device)
    floor_ms = time_ms(lambda: x.add_(1.0), 200)
    head = timed[0]  # the neighbourhood lookup: the main path's mode
    return dict(name="search_sorted", route="cuda",
                source="lidar_odometry_demo_tpu_torch/kernels/search.cu",
                replaces="scripts/pallas_search_exp.py:39", max_abs_err=0.0,
                ms=head["ms"], call_ms=head["call_ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None,
                present_slices=present, launch_floor_ms=floor_ms, modes=timed)


# --------------------------------------------------------------------------
# phase 6: the CLI
# --------------------------------------------------------------------------

def run_cli() -> dict:
    from lidar_odometry_demo_tpu_torch import cli
    from lidar_odometry_demo_tpu_torch.io.trajectory import read_tum

    out_dir = os.path.join(REPO, "chiprun_out", "cli_smoke")
    os.makedirs(out_dir, exist_ok=True)
    tum, kf = os.path.join(out_dir, "t.tum"), os.path.join(out_dir, "kf.pcd")
    for path in (tum, kf):
        if os.path.exists(path):
            os.remove(path)
    zero_counts()
    t0 = time.perf_counter()
    cli.main(["sim", "--scans", "5", "--out", tum, "--keyframe-out", kf, "--quiet"])
    launches = read_counts()
    stamps, t, _ = read_tum(tum)
    with open(kf) as f:
        points = next(int(line.split()[1]) for line in f if line.startswith("POINTS"))
    log(f"cli: sim --scans 5 in {time.perf_counter() - t0:.1f} s, {len(stamps)} TUM rows, "
        f"keyframe PCD POINTS {points}, launches {launches}")
    if t.shape != (5, 3) or not np.all(np.isfinite(t)) or not np.all(np.diff(stamps) > 0):
        raise AssertionError(f"cli: the TUM must hold 5 monotone rows: {stamps}")
    if points <= 0:
        raise AssertionError("cli: the keyframe PCD holds no points")
    if min(launches.values()) == 0:
        raise AssertionError(f"cli: a kernel was not launched: {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 7: the fleet path (batched multi-sequence odometry)
# --------------------------------------------------------------------------

FLEET_B = 8


def simulate_lane(b: int) -> dict:
    """Fleet lane b's drive (seed 42 + b, yaw rate 0.03 (b + 1), 5 m/s) as
    numpy scans and ground truth relative to its first pose; run in a worker
    process."""
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence

    drive = simulate_sequence(num_scans=40, width=OdometryConfig().scan_width, seed=42 + b,
                              speed=5.0, yaw_rate=0.03 * (b + 1))
    g0 = drive.gt_q[0]
    gt_rel = Rotation.from_quat([g0[1], g0[2], g0[3], g0[0]]).inv().apply(
        drive.gt_t - drive.gt_t[0])
    return dict(scans=drive.scans, gt_rel=gt_rel)


def fleet_scans(bench: dict, device):
    """The fleet's (S, B, ...) scans on the card and each lane's ground truth:
    lanes 0 and 7 the bench drive, lanes 1-6 their own drives (simulated in
    six worker processes, all stopped before this returns)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy

    cfg = OdometryConfig()
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=6,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        drives = list(pool.map(simulate_lane, range(1, FLEET_B - 1)))
    lanes = [bench["scans"]]
    for d in drives:
        lanes.append([scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                                      cfg.max_raw_points, device) for s in d["scans"]])
    lanes.append(bench["scans"])
    n = len(bench["scans"])
    scans_b = LidarScan(*(torch.stack([torch.stack([getattr(lane[i], f) for lane in lanes])
                                       for i in range(n)]) for f in LidarScan._fields))
    log(f"fleet path: simulated and uploaded {FLEET_B - 2} more drives in "
        f"{time.perf_counter() - t0:.1f} s")
    return scans_b, [bench["gt_rel"]] + [d["gt_rel"] for d in drives] + [bench["gt_rel"]]


def run_fleet(bench: dict, main_diags: list, main_odo, single_ms: float, device) -> dict:
    """The batched runner at B = 8 on the 40-scan drives: one warm-up pass,
    one timed pass with the launch counts set to 0 just before it and read
    just after. Checks lanes 0 and 7 bitwise equal, lane 0 against the main
    path's single-sequence run, every lane's accuracy, divergence and the
    kernels' schedule (K1 once per batched round, the slowest lane's; K2
    four times that; K3 once per ICP step and once per map_update step).
    Returns the launches, the final state and the scans."""
    import torch

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.io.trajectory import ate_rmse
    from lidar_odometry_demo_tpu_torch.parallel import batched

    cfg = OdometryConfig()
    scans_b, gts = fleet_scans(bench, device)
    S, B = scans_b.xyz.shape[:2]
    run = batched.make_batched_sequence_runner(cfg)
    t0 = time.perf_counter()
    run(batched.init_batched_state(cfg, B, device), scans_b)
    torch.cuda.synchronize()
    log(f"fleet path: warm-up pass {time.perf_counter() - t0:.1f} s")
    state0 = batched.init_batched_state(cfg, B, device)
    torch.cuda.synchronize()
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, diags = run(state0, scans_b)
    end.record()
    end.synchronize()
    launches = read_counts()
    ms_step = start.elapsed_time(end) / S
    sps = B * 1e3 / ms_step
    log(f"fleet path: B={B} lanes x {S} scans, {ms_step:.3f} ms per step of {B}, {sps:.2f} "
        f"scans/s aggregate, {sps / (1e3 / single_ms):.3f}x the main path's "
        f"{1e3 / single_ms:.2f} scans/s (CUDA events)")

    t, q = diags.pose.t.cpu().numpy(), diags.pose.q.cpu().numpy()
    iters = diags.icp_iterations.cpu().numpy()
    matches = diags.num_matches.cpu().numpy()
    if t.shape != (S, B, 3) or not np.all(np.isfinite(t)) or not np.all(np.isfinite(q)):
        raise AssertionError("fleet path: non-finite or misshapen poses")
    kf = state.keyframe
    same = [torch.equal(diags.pose.t[:, 0], diags.pose.t[:, 7]),
            torch.equal(diags.pose.q[:, 0], diags.pose.q[:, 7])]
    same += [torch.equal(getattr(kf, f)[0], getattr(kf, f)[7]) for f in ("keys", "count", "origin")]
    if not all(same):
        raise AssertionError(f"fleet path: lanes 0 and 7 (one drive) differ: poses t, q, keys, "
                             f"count, origin equal = {same}")
    st = np.stack([d.pose.t.cpu().numpy() for d in main_diags])
    sq = np.stack([d.pose.q.cpu().numpy() for d in main_diags])
    s_iters = np.array([int(d.icp_iterations) for d in main_diags])
    s_matches = np.array([int(d.num_matches) for d in main_diags])
    dt, dq = float(np.abs(t[:, 0] - st).max()), float(np.abs(q[:, 0] - sq).max())
    if dt > 1e-5 or dq > 1e-6:
        raise AssertionError(f"fleet path: lane 0 is {dt} m / {dq} from the main path")
    if not (np.array_equal(iters[:, 0], s_iters) and np.array_equal(matches[:, 0], s_matches)):
        raise AssertionError(f"fleet path: lane 0's ICP iterations or matches differ from the "
                             f"main path's: {iters[:, 0]} vs {s_iters}, {matches[:, 0]} vs "
                             f"{s_matches}")
    if not (torch.equal(kf.keys[0], main_odo.state.keyframe.keys)
            and torch.equal(kf.count[0], main_odo.state.keyframe.count)):
        raise AssertionError("fleet path: lane 0's final map keys or counts differ from the "
                             "main path's")
    ates = [ate_rmse(t[:, b], gts[b], align=True) for b in range(B)]
    diverged = int(diags.diverged.sum())
    rounds = int(iters.max(axis=1).sum())
    icp_steps = int(np.sum(iters.max(axis=1) > 0))
    log(f"fleet path: lane 0 within {dt:.3g} m / {dq:.3g} of the main path with equal "
        f"iterations and matches, lanes 0 and 7 bitwise equal; aligned ATE per lane "
        f"{[round(a, 5) for a in ates]} m; diverged {diverged}; {rounds} batched rounds over "
        f"{icp_steps} ICP steps (lane rounds {int(iters.sum())}); launches {launches}")
    if abs(ates[0] - 0.00936) > 1e-4:
        raise AssertionError(f"fleet path: lane 0's ATE {ates[0]:.5f} m is not within 1e-4 m "
                             f"of 0.00936 m")
    if max(ates) > 0.03:
        raise AssertionError(f"fleet path: a lane's ATE exceeds 0.03 m: {ates}")
    if diverged:
        raise AssertionError(f"fleet path: {diverged} lane scans diverged")
    # the runner's step is captured already: only the fresh state's first step is eager
    want = {"match_rows": rounds, "jtwj_accumulate": cfg.icp_inner_iterations * rounds,
            "search_sorted": icp_steps + S, "loop_condition": loop_schedule(iters),
            "prepare": S, "map_update": S}
    if launches != want:
        raise AssertionError(f"fleet path: launches {launches} != the schedule {want}")
    return dict(launches=launches, state=state, scans=scans_b, diags=diags, ms_per_step=ms_step,
                scans_per_sec=sps, ates=ates)


def fleet_calls(state, scan) -> dict:
    """The kernels' first calls in one more batched step from the fleet's
    final state, with their inputs (cloned: the step rewrites its buffers):
    {"K1": (args, kwargs), "K2": (args, kwargs), "neighbourhood": ...,
    "group": ...}. Their launches are not counted: counts are zeroed before
    every drive."""
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.ops import icp
    from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_demo_tpu_torch.parallel import batched

    calls = {}
    patched = [(vm, "match_correspondences", "K1"), (icp, "gn_step", "K2"),
               (vm, "neighborhood_lookup", "neighbourhood"), (vm, "group_lookup", "group")]
    originals = {key: getattr(mod, name) for mod, name, key in patched}

    def clone(x):
        if hasattr(x, "clone"):
            return x.clone()
        if isinstance(x, tuple):
            return type(x)(*(clone(v) for v in x)) if hasattr(x, "_fields") else tuple(
                clone(v) for v in x)
        return x

    def recorder(key):
        def call(*args, **kwargs):
            if key not in calls:
                calls[key] = (clone(args), {k: clone(v) for k, v in kwargs.items()
                                            if k not in ("out", "work", "slot")})
            return originals[key](*args, **kwargs)
        return call

    for mod, name, key in patched:
        setattr(mod, name, recorder(key))
    try:
        batched.make_batched_step(OdometryConfig())(state, scan)
    finally:
        for mod, name, key in patched:
            setattr(mod, name, originals[key])
    if set(calls) != {key for _, _, key in patched}:
        raise AssertionError(f"fleet step: recorded only {sorted(calls)}")
    return calls


def abs_terms_sum(corr, pose, huber_delta: float):
    """Per entry of a part's record (H row-major, then b) at `pose`, the sum
    over the rows of its terms' magnitudes, sum |w J_a J_b| and sum
    |w J_a r| (w >= 0): the scale of the float32 rounding of any order of
    that sum. With a lane axis, per lane."""
    import torch

    from lidar_odometry_demo_tpu_torch.ops.se3 import Pose, quat_to_matrix, rot_pts
    from lidar_odometry_demo_tpu_torch.ops.voxel_map import Correspondence

    if corr.source_local.dim() == 3:
        return torch.stack([abs_terms_sum(Correspondence(*(x[i] for x in corr)),
                                          Pose(pose.t[i], pose.q[i]), huber_delta)
                            for i in range(corr.source_local.shape[0])])
    rp = rot_pts(corr.source_local, quat_to_matrix(pose.q))
    n = corr.plane_normal
    r = ((rp + pose.t - corr.plane_origin) * n).sum(-1).abs()
    w = torch.where(corr.valid, torch.clamp(huber_delta / r, max=1.0), 0.0)
    J = torch.cat([torch.linalg.cross(rp, n), n], -1).abs()
    return torch.cat([(J.T @ (J * w[:, None])).flatten(), (J * w[:, None]).T @ r])


def _bitwise(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_bitwise(x, y) for x, y in zip(a, b))


def _lane(x, b):
    import torch

    if isinstance(x, torch.Tensor):
        return x[b]
    if isinstance(x, tuple):
        items = [_lane(v, b) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def check_fleet_kernels(calls: dict, device) -> dict:
    """Each kernel at B = 8 on the fleet step's inputs against its plain
    version (K1, K3 bitwise; K2 within phase 2's tolerances) and against B = 1
    launches lane by lane (bitwise); K2 with lane 3 inactive. Per-launch CUDA
    event times at B = 8 with their bounds. Returns {kernel name: numbers}."""
    import torch

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.kernels.correspondence import (
        Match, match_correspondences, match_correspondences_plain)
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import GnWork, gn_step, gn_step_plain
    from lidar_odometry_demo_tpu_torch.kernels.search import (
        CandidateSet, group_lookup, group_lookup_plain, neighborhood_lookup,
        neighborhood_lookup_plain, search_steps)

    cfg = OdometryConfig()
    out = {}

    # K1, pose mode
    args, kw = calls["K1"]
    query, qvalid, pose_t, pose_R, cand, tab, nrm = args
    B, Q = query.shape[:2]
    K = kw["max_points"]
    got = match_correspondences(*args, **kw)
    ref = match_correspondences_plain(*args[:5], nrm, **kw)
    torch.cuda.synchronize()
    if not _bitwise(got, ref):
        raise AssertionError("fleet K1 at B=8: differs from its plain version")
    for b in range(B):
        if not _bitwise(_lane(got, b), match_correspondences(*(_lane(a, b) for a in args), **kw)):
            raise AssertionError(f"fleet K1: lane {b} differs from its B=1 launch")
    match_out = Match.empty(Q, device, (B,))
    ms = time_ms(lambda: match_correspondences(*args, **kw, out=match_out), 100)
    plain_ms = time_ms(lambda: match_correspondences_plain(*args[:5], nrm, **kw), 3)
    RW = cand.rows_z[0].shape[-1]
    npres = cand.n_present.cpu().numpy()                        # (B, 9, Q)
    present = np.arange(3)[:, None, None, None] < npres[None]   # (3, B, 9, Q)
    cnt = np.stack([r.view(torch.float32)[..., 3 * K].reshape(B, 9, Q).cpu().numpy()
                    for r in cand.rows_z])
    n_cand = float(np.sum(np.where(present, np.clip(np.ceil(cnt), 0, K), 0)))
    n_valid = int(ref.valid.sum())
    n_bytes = (4.0 * (np.sum(present) + 3 * n_cand)
               + B * (Q * 13 + 48 + 2 * 9 * Q * 4 + Q * 33) + 12 * n_valid)
    b_ms, b_by = bound_ms(n_bytes, 9 * n_cand + 15 * Q * B)
    out["match_rows"] = dict(fleet_ms=ms, fleet_plain_ms=plain_ms, fleet_bound_ms=b_ms,
                             fleet_bound_by=b_by)
    log(f"fleet kernel match_rows (K1) at B={B}: Q={Q} K={K}, {n_valid} valid; bitwise its "
        f"plain version and its B=1 launches; {ms:.4f} ms per launch, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")

    # K2, one whole Gauss-Newton step with lane 3 inactive
    args, kw = calls["K2"]
    corr, pose, guess_t, _ = args
    active = torch.ones(B, dtype=torch.bool, device=device)
    active[3] = False
    norm_in = torch.linspace(0.1, 0.8, B, device=device)
    work = GnWork.empty(1, device, (B,))
    new, norm, H, bvec = gn_step(corr, pose, guess_t, cfg, work=work, step_norm=norm_in,
                                 active=active)
    snap = [x.clone() for x in (new.t, new.q, norm, H, bvec)]
    plain = gn_step_plain(corr, pose, guess_t, cfg, step_norm=norm_in, active=active)
    torch.cuda.synchronize()
    if not (torch.equal(snap[0][3], pose.t[3]) and torch.equal(snap[1][3], pose.q[3])
            and torch.equal(snap[2][3], norm_in[3])):
        raise AssertionError("fleet K2: the inactive lane's pose or step norm moved")
    errs = [(snap[0] - plain[0].t).abs().max().item(), (snap[1] - plain[0].q).abs().max().item()]
    on = active.cpu().numpy()
    hb_err = max((snap[3][active] - plain[2][active]).abs().max().item(),
                 (snap[4][active] - plain[3][active]).abs().max().item())
    if max(errs) > 1e-6 or not (
            torch.allclose(snap[3][active], plain[2][active], rtol=2e-5, atol=1e-4)
            and torch.allclose(snap[4][active], plain[3][active], rtol=2e-5, atol=1e-4)):
        raise AssertionError(f"fleet K2: pose {errs}, H/b {hb_err} from its plain version")
    for b in range(B):
        if not on[b]:
            continue
        one = gn_step(_lane(corr, b), _lane(pose, b), guess_t[b], cfg)
        if not _bitwise([x[b] for x in snap], [one[0].t, one[0].q, one[1], one[2], one[3]]):
            raise AssertionError(f"fleet K2: lane {b} differs from its B=1 launch")
    ms = time_ms(lambda: gn_step(corr, pose, guess_t, cfg, work=work, step_norm=norm_in,
                                 active=active), 200)
    all_on = time_ms(lambda: gn_step(corr, pose, guess_t, cfg, work=work), 200)
    plain_ms = time_ms(lambda: gn_step_plain(corr, pose, guess_t, cfg), 3)
    Qk = corr.source_local.shape[1]
    b_ms, b_by = bound_ms(B * (Qk * 37 + 40 + 42 * 4 + 32), B * (100 * Qk + 300))
    out["jtwj_accumulate"] = dict(fleet_ms=all_on, fleet_ms_one_inactive=ms,
                                  fleet_plain_ms=plain_ms, fleet_bound_ms=b_ms,
                                  fleet_bound_by=b_by, fleet_pose_max_abs_err=max(errs))
    log(f"fleet kernel jtwj_accumulate (K2) at B={B}: Q={Qk}; lane 3 inactive held, the others "
        f"bitwise their B=1 launches, pose {max(errs):.3g} from the plain step; {all_on:.4f} ms "
        f"per launch ({ms:.4f} with lane 3 inactive), plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.6f} ms ({b_by})")

    # K3: the neighbourhood lookup and the group lookup
    args, kw = calls["neighbourhood"]
    got = neighborhood_lookup(*args, **kw)
    ref = neighborhood_lookup_plain(*args, **kw)
    torch.cuda.synchronize()
    for b in range(B):
        g, r = _lane(got, b), _lane(ref, b)
        one = neighborhood_lookup(*(_lane(a, b) for a in args), **kw)
        for other, label in ((r, "plain version"), (one, "B=1 launch")):
            live = other.n_present.reshape(-1)
            same = (torch.equal(g.base, other.base) and torch.equal(g.n_present, other.n_present)
                    and all(torch.equal(g.rows_z[s][live > s], other.rows_z[s][live > s])
                            for s in range(3)))
            if not same:
                raise AssertionError(f"fleet K3 neighbourhood lookup: lane {b} differs from its "
                                     f"{label}")
    tab, keys = args[0], args[1]
    C, Qn = keys.shape[1], args[3].shape[1]
    RW = kw["row_width"]
    present = int(ref.n_present.sum())
    cand_out = CandidateSet.empty(Qn, RW, device, (B,))
    n_ms = time_ms(lambda: neighborhood_lookup(*args, **kw, out=cand_out), 200)
    n_plain = time_ms(lambda: neighborhood_lookup_plain(*args, **kw), 3)
    steps = search_steps(C)
    nb_ms, nb_by = bound_ms(B * (13.0 * Qn + 60 + 4.0 * C + 8.0 * 9 * Qn)
                            + 2.0 * 4 * RW * present, B * 9.0 * Qn * (24 + steps))
    gkeys, gq = calls["group"][0]
    pos_c, found = group_lookup(gkeys, gq)
    ref_g = group_lookup_plain(gkeys, gq)
    torch.cuda.synchronize()
    if not (torch.equal(pos_c, ref_g[0]) and torch.equal(found, ref_g[1])):
        raise AssertionError("fleet K3 group lookup: differs from its plain version")
    for b in range(B):
        p1, f1 = group_lookup(gkeys[b], gq[b])
        if not (torch.equal(pos_c[b], p1) and torch.equal(found[b], f1)):
            raise AssertionError(f"fleet K3 group lookup: lane {b} differs from its B=1 launch")
    N = gq.shape[1]
    g_ms = time_ms(lambda: group_lookup(gkeys, gq), 200)
    g_plain = time_ms(lambda: group_lookup_plain(gkeys, gq), 3)
    gb_ms, gb_by = bound_ms(B * (4.0 * C + 9.0 * N), float(B * N * (steps + 2)))
    out["search_sorted"] = dict(fleet_ms=n_ms, fleet_plain_ms=n_plain, fleet_bound_ms=nb_ms,
                                fleet_bound_by=nb_by, fleet_present_slices=present,
                                fleet_group_ms=g_ms, fleet_group_plain_ms=g_plain,
                                fleet_group_bound_ms=gb_ms)
    log(f"fleet kernel search_sorted (K3) at B={B}: neighbourhood lookup Q={Qn} C={C}, "
        f"{present} present slices, and group lookup N={N} ({int(found.sum())} found): bitwise "
        f"their plain versions and B=1 launches; neighbourhood {n_ms:.4f} ms per launch, plain "
        f"{n_plain:.4f} ms, bound {nb_ms:.4f} ms ({nb_by}); group {g_ms:.4f} ms, plain "
        f"{g_plain:.4f} ms, bound {gb_ms:.5f} ms ({gb_by})")
    return out


def run_fleet_cli() -> dict:
    """`fleet --batch 2 --scans 5` in-process, TUMs under chiprun_out/cli_smoke/."""
    from lidar_odometry_demo_tpu_torch import cli
    from lidar_odometry_demo_tpu_torch.io.trajectory import read_tum

    prefix = os.path.join(REPO, "chiprun_out", "cli_smoke", "fleet_")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    for b in range(2):
        if os.path.exists(f"{prefix}{b}.tum"):
            os.remove(f"{prefix}{b}.tum")
    zero_counts()
    t0 = time.perf_counter()
    cli.main(["fleet", "--batch", "2", "--scans", "5", "--out-prefix", prefix])
    launches = read_counts()
    for b in range(2):
        stamps, t, _ = read_tum(f"{prefix}{b}.tum")
        if t.shape != (5, 3) or not np.all(np.isfinite(t)) or not np.all(np.diff(stamps) > 0):
            raise AssertionError(f"cli fleet: lane {b}'s TUM must hold 5 monotone rows")
    log(f"cli: fleet --batch 2 --scans 5 in {time.perf_counter() - t0:.1f} s, two TUMs of 5 "
        f"rows, launches {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"cli fleet: a kernel was not launched: {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 8: live ingestion (UDP packets -> revolutions -> native decode -> odometry)
# --------------------------------------------------------------------------

PACKET_RATE = 750.0   # the VLP16's own packet rate: 75 packets per scan, 10 scans/s


def encode_packets(bench: dict) -> list[list[bytes]]:
    """The bench drive's scans as VLP16 data packets, a list per scan."""
    from lidar_odometry_demo_tpu_torch.io.live import PACKET_SIZE
    from lidar_odometry_demo_tpu_torch.io.simulator import encode_vlp16_packets

    out = []
    for range_image, scan_start in bench["range_images"]:
        log_ = encode_vlp16_packets(range_image, scan_start)
        out.append([log_[i:i + PACKET_SIZE] for i in range(0, len(log_), PACKET_SIZE)])
    return out


def free_udp_port() -> int:
    import socket

    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _send(packets: list, port: int, ready, started, sent, rate: float) -> None:
    """Set `ready`, wait for `started`, then send `packets` to
    127.0.0.1:port paced at `rate` packets per second, counting them in
    `sent.value`."""
    import socket

    ready.set()
    if not started.wait(60.0):
        return
    out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(packets):
            delay = t0 + i / rate - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            out.sendto(p, ("127.0.0.1", port))
            with sent.get_lock():
                sent.value += 1
    except OSError:
        pass  # the listener has gone (the CLI's --max-scans)
    finally:
        out.close()


def start_sender(packets: list, port: int, rate: float = PACKET_RATE, process: bool = True):
    """Start a sender of `packets` to 127.0.0.1:port that waits for the
    returned `started` event (the listener sets it after its bind). With
    `process` the sender is a spawned process, which shares no interpreter
    lock with the listener; else a thread. Returns once the sender is
    running (a spawned interpreter takes a while to start, longer than the
    listener's silence timeout may allow): (worker, started, sent),
    `sent.value` the packets sent so far."""
    import multiprocessing
    import threading

    ctx = multiprocessing.get_context("spawn")
    ready, started, sent = ctx.Event(), ctx.Event(), ctx.Value("i", 0)
    worker = (ctx.Process if process else threading.Thread)(
        target=_send, args=(packets, port, ready, started, sent, rate), daemon=True)
    worker.start()
    if not ready.wait(60.0):
        stop_sender(worker, 0.0)
    return worker, started, sent


def stop_sender(worker, timeout: float = 30.0) -> None:
    """Join the sender; one still running after `timeout` is ended and
    reported."""
    worker.join(timeout)
    if worker.is_alive():
        if hasattr(worker, "terminate"):
            worker.terminate()
            worker.join(5.0)
        raise AssertionError("live: the sender did not finish")


class _TimedOdometry:
    """LidarOdometry with each live scan's host clock read at the decode's
    start and end (`decoded`, set by the timed decoder), at process_cloud's
    start, after the upload (scan_from_numpy), after the step's host call
    returns and after the pose read, and CUDA events around the step."""

    def __init__(self, odo):
        self.odo = odo
        self.decoded = (0.0, 0.0)
        self.marks: list[list[float]] = []
        self.events: list = []
        self.scans: list = []  # the uploaded scans, which phase 11 drives again

    def process_cloud(self, xyz, intensity, ring, t):
        import torch

        from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy

        marks = [*self.decoded, time.perf_counter()]
        scan = scan_from_numpy(xyz, intensity, ring, t, self.odo.cfg.max_raw_points,
                               self.odo.device)
        marks.append(time.perf_counter())
        self.scans.append(scan)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        diag = self.odo.process_scan(scan)
        ev[1].record()
        marks.append(time.perf_counter())
        self.marks.append(marks)
        self.events.append(ev)
        return diag

    def get_current_pose(self):
        out = self.odo.get_current_pose()
        self.marks[-1].append(time.perf_counter())
        return out


def check_revolutions(received: list, sent: list, per_scan: list) -> list:
    """Check that `received` holds exactly the packets sent (as a multiset:
    loopback UDP may reorder, which the assembler tolerates), then cut it
    into revolutions as the listener did and check that revolution k holds
    scan k's packets, give or take the one packet at the cut
    (test_scan_assembler_cuts_revolutions' allowance), and no packet that
    no scan encoded. Returns the revolutions' packet counts."""
    from lidar_odometry_demo_tpu_torch.io.live import PACKET_SIZE, scans_from_packet_stream

    if sorted(received) != sorted(sent):
        raise AssertionError("live: the packets received are not the packets sent")
    owner = {p: k for k, scan in enumerate(per_scan) for p in scan}
    if len(owner) != sum(len(s) for s in per_scan):
        raise AssertionError("live: two encoded packets are byte-identical")
    sizes = []
    for k, rev in enumerate(scans_from_packet_stream(iter(received), flush_partial=True)):
        owners = [owner.get(rev[i:i + PACKET_SIZE], -1)
                  for i in range(0, len(rev), PACKET_SIZE)]
        own = sum(o == k for o in owners)
        others = [o for o in owners if o != k]
        if (k >= len(per_scan) or own < len(per_scan[k]) - 1 or len(others) > 1
                or any(o == -1 or abs(o - k) != 1 for o in others)):
            raise AssertionError(f"live: revolution {k} holds packets of scans "
                                 f"{sorted(set(owners))} ({own} of its own)")
        sizes.append(len(owners))
    return sizes


def run_live_path(bench: dict, main_diags: list, main_ms: float, device) -> dict:
    """Phase 8: the bench drive as VLP16 packets, sent by a spawned process
    over loopback UDP at the sensor's rate to `udp_packets`, through
    `run_live` and `LidarOdometry(OdometryConfig(), device="cuda")`, with
    every launch count set to 0 just before and read just after. Checks the
    packets received against those sent, the revolutions, at least 40
    scans, the trajectory against the socket-free run over the same packets
    (1e-5 m / 1e-6), against the main path (0.05 m, tests/test_live.py's
    bar) and against ground truth (aligned ATE 0.03 m), no divergence and
    the main path's launch schedule. Prints each scan's time split into
    decode, upload, the step's host call, the pose read and the step's CUDA
    event time, beside the main path's `main_ms`."""
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.io import live, native
    from lidar_odometry_demo_tpu_torch.io.trajectory import ate_rmse
    from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry

    cfg = OdometryConfig()
    native._load()
    log(f"live: native library {native.library_path().name} "
        + (f"built from native/lidar_native.cpp in {native.build_seconds:.2f} s"
           if native.build_seconds is not None else "reused (already built)"))
    t0 = time.perf_counter()
    per_scan = encode_packets(bench)
    sent_packets = [p for scan in per_scan for p in scan]
    log(f"live: encoded {len(per_scan)} scans into {len(sent_packets)} packets "
        f"({sorted(set(len(s) for s in per_scan))} per scan) in {time.perf_counter() - t0:.1f} s")

    port = free_udp_port()
    sender, started, sent = start_sender(sent_packets, port)
    received = []

    def packets():
        for p in live.udp_packets("127.0.0.1", port, timeout_s=1.0,
                                  stop=lambda: started.set() or False):
            received.append(p)
            yield p

    odo = _TimedOdometry(LidarOdometry(cfg, device=device))
    ts, diags = [], []
    decode = native.decode_vlp16_packets

    def timed_decode(*args, **kwargs):
        t1 = time.perf_counter()
        out = decode(*args, **kwargs)
        odo.decoded = (t1, time.perf_counter())
        return out

    def on_scan(i, t, diag):
        ts.append(t)
        diags.append(diag)

    zero_counts()
    native.decode_vlp16_packets = timed_decode
    t0 = time.perf_counter()
    try:
        n = live.run_live(odo, packets(), on_scan=on_scan, flush_partial=True)
    finally:
        native.decode_vlp16_packets = decode
    wall = time.perf_counter() - t0
    launches = read_counts()
    stop_sender(sender)

    # per scan: decode, upload, the step's host call, the pose read, the
    # whole (decode start to pose read) and the step's device time
    marks = np.array(odo.marks)
    dec_a, _, upload, step_host, pose_read = (1e3 * np.diff(marks, axis=1)).T
    total = 1e3 * (marks[:, -1] - marks[:, 0])
    step_dev = np.array([a.elapsed_time(b) for a, b in odo.events])
    med = lambda x: float(np.median(x))  # noqa: E731
    log(f"live: sent {sent.value} / received {len(received)} packets at {PACKET_RATE:.0f} "
        f"packets/s (sender in its own process), {n} scans in {wall:.1f} s")
    log(f"live: ms per scan, median (max): decode {med(dec_a):.3f} ({dec_a.max():.3f}), upload "
        f"{med(upload):.3f} ({upload.max():.3f}), step host call {med(step_host):.3f} "
        f"({step_host.max():.3f}), pose read {med(pose_read):.3f} ({pose_read.max():.3f}); "
        f"decode start to pose read {med(total):.3f} ({total.max():.3f}), first "
        f"{total[0]:.3f}; step on the card (CUDA events) {med(step_dev):.3f} "
        f"({step_dev.max():.3f}) against the main path's {main_ms:.3f} per scan back to back; "
        f"{int(np.sum(total > 100.0))} of {n} scans over the sensor's 100 ms period")
    log(f"live: per-scan ms decode start to pose read {[round(float(x), 3) for x in total]}")
    log(f"live: per-scan step ms on the card {[round(float(x), 3) for x in step_dev]}")
    if sent.value != len(sent_packets) or len(received) != len(sent_packets):
        raise AssertionError(f"live: sent {sent.value} of {len(sent_packets)} packets, "
                             f"received {len(received)}: the listener fell behind")
    in_order = received == sent_packets
    sizes = check_revolutions(received, sent_packets, per_scan)
    log(f"live: {len(sizes)} revolutions of {sorted(set(sizes))} packets, each its encoded "
        f"scan's within one; packets received in the order sent: {in_order}")
    if n < len(per_scan):
        raise AssertionError(f"live: {n} scans processed, fewer than {len(per_scan)}")

    est = np.stack(ts)
    q_live = np.stack([d.pose.q.cpu().numpy() for d in diags])
    iters = np.array([int(d.icp_iterations) for d in diags])
    diverged = int(sum(bool(d.diverged) for d in diags))

    # the same packets, no socket
    free = LidarOdometry(cfg, device=device)
    free_t, free_q = [], []
    run_free = live.run_live(free, iter(received), flush_partial=True,
                             on_scan=lambda i, t, d: (free_t.append(t),
                                                      free_q.append(d.pose.q.cpu().numpy())))
    d_free_t = float(np.abs(est - np.stack(free_t)).max()) if run_free == n else float("inf")
    d_free_q = float(np.abs(q_live - np.stack(free_q)).max()) if run_free == n else float("inf")
    main_t = np.stack([d.pose.t.cpu().numpy() for d in main_diags])
    m = min(len(main_t), n)
    d_main = float(np.linalg.norm(est[:m] - main_t[:m], axis=1).max())
    k = min(n, len(bench["gt_rel"]))
    ate = ate_rmse(est[:k], bench["gt_rel"][:k], align=True)
    rounds = int(iters.sum())
    want = {"match_rows": rounds, "jtwj_accumulate": cfg.icp_inner_iterations * rounds,
            "search_sorted": int(np.sum(iters > 0)) + n,
            "loop_condition": loop_schedule(iters), "prepare": n,
            "map_update": n}
    log(f"live: {d_free_t:.3g} m / {d_free_q:.3g} from the socket-free run over the same "
        f"packets, {d_main:.5f} m from the main path (phase 3), aligned ATE {ate:.5f} m vs "
        f"ground truth, diverged {diverged}, mean ICP rounds {rounds / max(n - 1, 1):.2f}, "
        f"launches {launches}")
    if d_free_t > 1e-5 or d_free_q > 1e-6:
        raise AssertionError(f"live: {d_free_t} m / {d_free_q} from the socket-free run")
    if d_main > 0.05:
        raise AssertionError(f"live: {d_main} m from the main path's trajectory exceeds 0.05 m")
    if ate > 0.03:
        raise AssertionError(f"live: aligned ATE {ate:.4f} m exceeds 0.03 m")
    if diverged:
        raise AssertionError(f"live: {diverged} scans diverged")
    if launches != want:
        raise AssertionError(f"live: launches {launches} != the main path's schedule {want}")
    return dict(launches=launches, total_ms=total, step_ms=step_dev, decode_ms=dec_a,
                packets_sent=sent.value, packets_received=len(received), scans=n, ate=ate,
                d_main=d_main, d_free=d_free_t, diags=diags, state=odo.odo.state,
                uploaded=odo.scans)


def run_live_cli(bench: dict) -> dict:
    """`live --max-scans 5 --idle-timeout 3` in-process, fed the bench
    drive's first seven scans over loopback UDP; TUM under
    chiprun_out/cli_smoke/."""
    from lidar_odometry_demo_tpu_torch import cli
    from lidar_odometry_demo_tpu_torch.io import live
    from lidar_odometry_demo_tpu_torch.io.trajectory import read_tum

    out_dir = os.path.join(REPO, "chiprun_out", "cli_smoke")
    os.makedirs(out_dir, exist_ok=True)
    tum = os.path.join(out_dir, "live.tum")
    if os.path.exists(tum):
        os.remove(tum)
    packets = [p for scan in encode_packets(dict(range_images=bench["range_images"][:7]))
               for p in scan]
    port = free_udp_port()
    sender, started, _ = start_sender(packets, port)
    bound = live.udp_packets
    # the listener releases the sender once bound (its first stop() call)
    live.udp_packets = lambda *a, **kw: bound(*a, stop=lambda: started.set() or False, **kw)
    zero_counts()
    t0 = time.perf_counter()
    try:
        cli.main(["live", "--host", "127.0.0.1", "--port", str(port), "--max-scans", "5",
                  "--idle-timeout", "3", "--out", tum, "--quiet"])
    finally:
        live.udp_packets = bound
    launches = read_counts()
    stop_sender(sender)
    stamps, t, _ = read_tum(tum)
    log(f"cli: live --max-scans 5 in {time.perf_counter() - t0:.1f} s, {len(stamps)} TUM rows, "
        f"launches {launches}")
    if t.shape != (5, 3) or not np.all(np.isfinite(t)) or not np.all(np.diff(stamps) > 0):
        raise AssertionError(f"cli live: the TUM must hold 5 monotone rows: {stamps}")
    if min(launches.values()) == 0:
        raise AssertionError(f"cli live: a kernel was not launched: {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 9: the pose graph (`refine`)
# --------------------------------------------------------------------------

def make_noisy_loop(P_n: int = 32, drift: float = 0.03, seed: int = 0):
    """tests/test_pose_graph.py's loop, through the port's se3 on the CPU: a
    circle of radius 10 m returning to its start; odometry is the true
    relative poses with noise, integrated. Returns (gt_t, gt_q, est_t,
    est_q) as numpy and closure(i, j), the true relative pose i -> j."""
    import torch
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.ops import se3

    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, P_n, endpoint=False)
    gt_t = np.stack([10.0 * np.cos(angles), 10.0 * np.sin(angles), np.zeros(P_n)], -1)
    gt_q = np.array([Rotation.from_euler("z", a + np.pi / 2).as_quat()[[3, 0, 1, 2]]
                     for a in angles])

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32)

    def closure(i, j):
        return se3.relative_to(se3.Pose(f32(gt_t[i]), f32(gt_q[i])),
                               se3.Pose(f32(gt_t[j]), f32(gt_q[j])))

    est_t, est_q = [gt_t[0]], [gt_q[0]]
    for k in range(P_n - 1):
        z = closure(k, k + 1)
        noise_t = rng.normal(0, drift, 3).astype(np.float32)
        noise_w = rng.normal(0, drift * 0.3, 3).astype(np.float32)
        z = se3.Pose(z.t + f32(noise_t), se3.quat_mul(se3.quat_exp(f32(noise_w)), z.q))
        nxt = se3.compose(se3.Pose(f32(est_t[-1]), f32(est_q[-1])), z)
        est_t.append(nxt.t.numpy())
        est_q.append(nxt.q.numpy())
    return gt_t, gt_q, np.asarray(est_t), np.asarray(est_q), closure


def _edge_scale(x: np.ndarray) -> float:
    """The largest entry of a system array, leaving out H's gauge prior."""
    x = np.abs(x).copy()
    if x.ndim == 4:  # dense H (P, P, 6, 6): pose 0's block holds the 1e6 prior
        x[0, 0] = 0.0
    return max(float(x.max()), 1.0)


def refine_case(name: str, est_t, est_q, closures, solver: str, device) -> dict:
    """One refinement (10 Gauss-Newton iterations) on the card and on CPU
    tensors in this process: the first system (H and b, or the chain
    system) within 1e-5 of its scale, the refined poses within 5e-3 of the
    correction's scale or 4 float32 ulps of the coordinates, whichever is
    larger; a second card run beside the first; one more iteration's time
    split into the system's assembly and its solve. Returns the card's
    poses and the numbers."""
    import torch

    from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg

    def build(g):
        return pg.build_chain_system(g, 8) if solver == "segment" else pg.build_normal_equations(g)

    def solve(system):
        if solver == "segment":
            return pg.solve_segment_schur(*system, stride=8)
        if solver == "schur":
            P = system[1].shape[0]
            return pg.solve_schur(*system, torch.arange(P, device=system[1].device) % 4 == 0)
        return pg.solve_direct(*system)

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize()

    out, split = {}, {}
    for dev in (device, torch.device("cpu"), device):
        g = pg.chain_from_odometry(est_t, est_q, closures=closures, device=dev)
        system = build(g)
        sync(dev)
        t0 = time.perf_counter()
        if solver == "segment":
            refined = pg.refine_segment(g, stride=8, iterations=10)
        else:
            refined = pg.refine(g, iterations=10, use_schur=solver == "schur")
        t, q = refined.poses.t.cpu().numpy(), refined.poses.q.cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
        key = dev.type if dev.type not in out else "cuda_again"
        out[key] = ([x.cpu().numpy() for x in system], t, q, ms)
        # one iteration split: the system's assembly (Jacobians included)
        # and its solve, each followed by a synchronisation
        sync(dev)
        t1 = time.perf_counter()
        system = build(g)
        sync(dev)
        t2 = time.perf_counter()
        solve(system)
        sync(dev)
        split[key] = (1e3 * (t2 - t1), 1e3 * (time.perf_counter() - t2))
    (sys_g, t_g, q_g, ms_g), (sys_c, t_c, q_c, ms_c) = out["cuda"], out["cpu"]
    sys_err = max(float(np.abs(a - b).max()) / _edge_scale(b) for a, b in zip(sys_g, sys_c))
    bad_sys = [i for i, (a, b) in enumerate(zip(sys_g, sys_c))
               if not np.allclose(a, b, atol=1e-5 * _edge_scale(b), rtol=1e-5)]
    step = float(np.abs(t_c - est_t).max())
    tol_t = max(5e-3 * step, 4 * float(np.spacing(np.float32(np.abs(t_c).max()))))
    tol_q = max(5e-3 * float(np.abs(q_c - est_q).max()), 4 * float(np.spacing(np.float32(1.0))))
    d_t, d_q = float(np.abs(t_g - t_c).max()), float(np.abs(q_g - q_c).max())
    again = float(max(np.abs(out["cuda_again"][1] - t_g).max(),
                      np.abs(out["cuda_again"][2] - q_g).max()))
    log(f"refine {name} ({solver}, P={len(est_t)}, {len(closures)} closures): card "
        f"{ms_g:.1f} ms / CPU {ms_c:.1f} ms for 10 iterations (host clock); first system card vs "
        f"CPU {sys_err:.3g} of its scale; poses card vs CPU {d_t:.3g} m / {d_q:.3g} (bars "
        f"{tol_t:.3g} / {tol_q:.3g}); correction {step:.4g} m; two card runs {again:.3g} apart; "
        f"one iteration's assembly / solve ms: card {split['cuda'][0]:.2f} / "
        f"{split['cuda'][1]:.2f}, again {split['cuda_again'][0]:.2f} / "
        f"{split['cuda_again'][1]:.2f}, CPU {split['cpu'][0]:.2f} / {split['cpu'][1]:.2f}")
    if bad_sys:
        raise AssertionError(f"refine {name}: system arrays {bad_sys} differ card vs CPU")
    if d_t > tol_t or d_q > tol_q:
        raise AssertionError(f"refine {name}: card vs CPU {d_t} / {d_q} over {tol_t} / {tol_q}")
    if not (np.all(np.isfinite(t_g)) and np.all(np.isfinite(q_g))):
        raise AssertionError(f"refine {name}: non-finite poses")
    return dict(t=t_g, q=q_g, card_ms=ms_g, cpu_ms=ms_c, card_vs_cpu_m=d_t, correction_m=step,
                two_card_runs=again, split_ms=split)


def run_refine(main_diags: list, device) -> dict:
    """Phase 9: the main path's 40 poses (its odometry chain: a fixed
    point), a 32-pose noisy loop with a closure (direct and Schur: drift
    halved, pose 0 held), the segment Schur solver at P = 256, stride 8,
    each on the card against the CPU; then the CLI's `refine` on the main
    path's TUM. No kernel launches: refine is dense float32 algebra."""
    from lidar_odometry_demo_tpu_torch import cli
    from lidar_odometry_demo_tpu_torch.io.trajectory import read_tum, write_tum

    zero_counts()
    est_t = np.stack([d.pose.t.cpu().numpy() for d in main_diags]).astype(np.float64)
    est_q = np.stack([d.pose.q.cpu().numpy() for d in main_diags]).astype(np.float64)
    results = {}
    for solver in ("direct", "schur"):
        r = refine_case("main path", est_t, est_q, [], solver, device)
        moved = float(np.abs(r["t"] - est_t).max())
        if moved > 1e-3:
            raise AssertionError(f"refine main path ({solver}): the odometry chain is a fixed "
                                 f"point, but poses moved {moved} m")
        results[f"main_{solver}"] = r

    def rms(t, gt):
        return float(np.sqrt(np.mean(np.sum((t - gt) ** 2, -1))))

    for P_n, drift, solver, pairs in ((32, 0.03, "direct", [(31, 0)]),
                                      (32, 0.03, "schur", [(31, 0)]),
                                      (256, 0.02, "segment", [(248, 0), (128, 0)])):
        gt_t, gt_q, lt, lq, closure = make_noisy_loop(P_n, drift)
        closures = [(i, j, closure(i, j), 1.0) for i, j in pairs]
        r = refine_case("noisy loop", lt, lq, closures, solver, device)
        before, after = rms(lt, gt_t), rms(r["t"], gt_t)
        log(f"refine noisy loop ({solver}, P={P_n}): RMS vs ground truth {before:.4f} -> "
            f"{after:.4f} m, pose 0 moved {float(np.abs(r['t'][0] - lt[0]).max()):.3g} m")
        if not after < 0.5 * before:
            raise AssertionError(f"refine noisy loop ({solver}): RMS {before} -> {after}, not "
                                 f"halved")
        if float(np.abs(r["t"][0] - lt[0]).max()) > 1e-3:
            raise AssertionError(f"refine noisy loop ({solver}): pose 0 moved")
        results[f"loop_{solver}"] = dict(r, rms_before=before, rms_after=after)

    out_dir = os.path.join(REPO, "chiprun_out", "cli_smoke")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "main_path.tum")
    write_tum(src, [0.1 * i for i in range(len(est_t))], est_t, est_q)
    for flags in ([], ["--schur"]):
        dst = os.path.join(out_dir, f"refined{'_schur' if flags else ''}.tum")
        cli.main(["refine", src, "--out", dst, "--iterations", "5", *flags])
        stamps, t, _ = read_tum(dst)
        moved = float(np.abs(t - read_tum(src)[1]).max())
        log(f"cli: refine {' '.join(flags)} on the main path's TUM: {len(stamps)} rows, moved "
            f"{moved:.3g} m")
        if t.shape != est_t.shape or not np.all(np.isfinite(t)) or moved > 1e-3:
            raise AssertionError(f"cli refine {flags}: {t.shape} rows, moved {moved} m")
    launches = read_counts()
    log(f"refine: kernel launches {launches} (none expected: dense float32 algebra)")
    if any(launches.values()):
        raise AssertionError(f"refine launched kernels: {launches}")
    results["launches"] = launches
    return results


# --------------------------------------------------------------------------
# phase 10: the sharded modes on one H100 (two ranks on cuda:0 over gloo)
# --------------------------------------------------------------------------

SHARDED_RANKS = 2
MAIN_PATH_ATE = 0.00936  # phase 3's aligned ATE on the bench drive, which sp must hold
ATE_CEILING = 0.03       # every path's aligned ATE bound
# sp's trajectory against phase 3's, m: the JAX package's own bar for an
# sp-sharded sequence against its single run (tests/test_parallel.py:147).
# The ranks add H and b in rank order where the single path adds them in
# one sum, so the two drift apart by ulps from scan 1 on and a
# correspondence at a gate's edge flips
SP_FROM_MAIN_M = 1e-4
# Every scan's matches under sp against phase 3's, as a share of the
# drive's largest count (6,437 on the bench drive): the drift above moves
# correspondences across a gate, by up to 16 at two ranks and 10 at four
# (the one-process witnesses, one H100); a rank whose part of a sum is
# lost or counted twice moves them by a quarter
SP_MATCHES_FROM_MAIN = 0.02
SPATIAL_FROM_MAIN_M = 1e-3  # spatial's trajectory against phase 3's, m
EMPTY_KEY = 0x7FFFFFFF      # kernels/search.py: an empty slot of a voxel map


class ThreadGroup:
    """Rank `rank` of a group of n threads of one process, standing in for
    an sp group of n ranks (the interface ops/icp.py and
    pipeline/odometry.py use: size, rank, gather_parts). `gather_parts`
    stacks the n threads' tensors in rank order on the device, as the
    group's all-gather does, and the sp path adds them in rank order
    itself, so the threads take the ranks' sums bit for bit: the
    one-process witness of the split sums. The threads share one stream, so
    the barriers order the reads and writes on the device."""

    def __init__(self, rank: int, shared: dict):
        self.rank, self.size, self.shared = rank, shared["n"], shared

    @staticmethod
    def shared(n: int) -> dict:
        import threading

        return {"n": n, "barrier": threading.Barrier(n, timeout=120), "slots": [None] * n}

    def gather_parts(self, x, kind: str = "gather"):
        import torch

        sh = self.shared
        sh["slots"][self.rank] = x
        sh["barrier"].wait()  # every rank's x is in
        parts = torch.stack(sh["slots"])
        sh["barrier"].wait()  # every rank has queued its reads of the slots
        return parts


def sp_witness(cfg, scans, device, n: int = 2) -> dict:
    """The sp path with its group's gathers taken in one process: n
    threads each drive `make_process_scan(cfg, sp_group=...)` over `scans`
    from a fresh state with a ThreadGroup, so each Gauss-Newton step is
    split into the same parts (K2 on each rank's slice of the matching
    points), which the path adds in rank order as the ranks do. Returns
    rank 0's poses, iterations and matches (numpy); raises if the threads
    disagree."""
    import threading
    import traceback

    from lidar_odometry_demo_tpu_torch.pipeline import odometry

    shared = ThreadGroup.shared(n)
    outs, errors = [None] * n, []

    def drive(rank):
        try:
            step = odometry.make_process_scan(cfg, sp_group=ThreadGroup(rank, shared))
            state, diags = odometry.init_state(cfg, device), []
            for scan in scans:
                state, d = step(state, scan)
                diags.append(d)
            d = odometry.stack_diagnostics(diags)
            outs[rank] = {f: x.cpu().numpy() for f, x in (
                ("t", d.pose.t), ("q", d.pose.q), ("iters", d.icp_iterations),
                ("matches", d.num_matches))}
        except Exception:  # reported below; the other threads' barrier breaks
            errors.append(traceback.format_exc())
            shared["barrier"].abort()

    threads = [threading.Thread(target=drive, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("sp witness: a thread is still running after 600 s")
    if errors:
        raise AssertionError(f"sp witness: a thread failed:\n{errors[0]}")
    for o in outs[1:]:
        if not all(np.array_equal(o[f], outs[0][f]) for f in o):
            raise AssertionError("sp witness: the threads' results differ")
    return outs[0]


def sharded_counters() -> dict:
    """The launch-counted kernel wrappers of the sharded paths: phase 3's,
    plus K2's split-step entry points (gn_sum_step and K2e)."""
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import gn_epilogue, gn_sum_step

    return counters() | {"gn_sum_step": gn_sum_step, "gn_epilogue": gn_epilogue}


def split_shard(m, n: int, rank: int):
    """Rank `rank`'s shard of a replicated map (one sequence): the rows of
    the columns it owns, in key order, in a table of capacity C/n (raises
    if they do not fit). A row's owner is its key's column gx mod n, gx the
    key's x field less the window's half width, as spatial.owner_mask gives
    it for the voxel's points."""
    import torch

    from lidar_odometry_demo_tpu_torch.kernels.search import _GHALF, _XOFF, _YB, _ZB
    from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm

    cap = m.capacity // n
    gx = (m.keys >> (_YB + _ZB)) - _XOFF + _GHALF
    mine = torch.nonzero((m.keys != vm.EMPTY_KEY) & (torch.remainder(gx, n) == rank))
    mine = mine.reshape(-1)
    if mine.numel() > cap:
        raise AssertionError(f"rank {rank}'s {mine.numel()} rows exceed the shard capacity {cap}")
    out = vm.map_init(cap, m.max_points, m.tab.device)._replace(origin=m.origin.clone())
    k = mine.numel()
    out.tab[:k] = m.tab[mine]
    out.keys[:k] = m.keys[mine]
    out.count[:k] = m.count[mine]
    return out


def composite_search_check(m, lookup_args: tuple, n: int, cfg) -> dict:
    """The column-sharded map's composite search against the replicated
    map's on the card, bitwise: m split into n shards (split_shard),
    each rank's view the merge of its shard and its ring neighbours'
    (spatial.merge_blocks, as build_halo_view merges what it receives), its
    owned queries gathered (K3) and matched (K1) on the view; every owned
    query's valid, plane origin and plane normal equal to the replicated
    search's, and every query owned once. lookup_args: a recorded
    neighbourhood lookup's (tab, keys, origin, queries, valid, t, R)."""
    import torch

    from lidar_odometry_demo_tpu_torch.kernels.search import query_world
    from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_demo_tpu_torch.parallel import spatial

    q_local, q_valid, t, R = lookup_args[3:7]
    vs = cfg.keyframe_voxel_size

    def search(view, valid):
        cand = vm.gather_candidates(view, q_local, valid, t, R, voxel_size=vs)
        return vm.match_candidates(view, cand, q_local, valid, t, R,
                                   max_distance=cfg.icp_max_correspondence_distance,
                                   nrm_view=view.nrm)

    want = search(m, q_valid)
    shards = [split_shard(m, n, r) for r in range(n)]
    gx = spatial.column_gx(query_world(q_local, R, t), m.origin, vs)
    owned = torch.zeros_like(q_valid, dtype=torch.int32)
    for r in range(n):
        blocks = [shards[r], shards[(r + 1) % n]] + ([shards[(r - 1) % n]] if n > 2 else [])
        view = spatial.merge_blocks(blocks)
        own = q_valid & (torch.remainder(gx, n) == r)
        got = search(view, own)
        bad = [f for f in ("valid", "plane_origin", "plane_normal")
               if not torch.equal(getattr(got, f)[own], getattr(want, f)[own])]
        if bad or bool(got.valid[~own].any()):
            raise AssertionError(f"composite search, N = {n}, rank {r}: {bad} differ from the "
                                 f"replicated search (or a query it does not own matched)")
        owned += own.to(torch.int32)
    if not torch.equal(owned, q_valid.to(torch.int32)):
        raise AssertionError(f"composite search, N = {n}: the owned queries are no partition")
    return dict(rows=view.capacity, matches=int(want.valid.sum()),
                shard_rows=[int(vm.map_size(s)) for s in shards])


def _sharded_drive(step, state, scans, mesh, counted: dict, sync_ranks=None):
    """One warm-up pass and one timed pass of `scans` through `step` on
    this rank; every launch count and the mesh's collective costs set to 0
    just before the timed pass and read just after, the collectives timed
    on the device in the timed pass and their spans read once per scan
    (CommStats.settle). `sync_ranks`: called between the two passes (a
    barrier, so that ranks without collectives time the same stretch).
    Returns the poses, diagnostics, final state, launches, collectives, the
    step's waits on the device (`HostFlags.waits`) and graph launches, and
    ms per scan: by CUDA events, by the host's clock, and the process's CPU
    time. `captured`: the step runs from CUDA graphs (not eager)."""
    import torch

    from lidar_odometry_demo_tpu_torch.device import HostFlags
    from lidar_odometry_demo_tpu_torch.pipeline import graphs, odometry

    def run(s):
        diags = []
        for scan in scans:
            s, d = step(s, scan)
            mesh.stats.settle()
            diags.append(d)
        return s, odometry.stack_diagnostics(diags)

    run(state)
    torch.cuda.synchronize()
    if sync_ranks is not None:
        sync_ranks()
    zero_counts(counted)
    mesh.stats.reset(device_timing=True)
    waits, graph_launches = HostFlags.waits, graphs.graph_launches
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0, c0 = time.perf_counter(), time.process_time()
    start.record()
    final, d = run(state)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(scans)
    cpu_ms = (time.process_time() - c0) * 1e3 / len(scans)
    final = step.own(final)  # a captured step's buffers: its next call rewrites them
    waits, graph_launches = HostFlags.waits - waits, graphs.graph_launches - graph_launches
    return dict(waits=waits, graph_launches=graph_launches,
                captured=getattr(step, "capturable", False) and final.current.t.is_cuda,t=d.pose.t, q=d.pose.q, iters=d.icp_iterations, matches=d.num_matches,
                diverged=d.diverged, map_voxels=d.map_voxels,
                keys=final.keyframe.keys, count=final.keyframe.count,
                origin=final.keyframe.origin, state=final,
                launches=read_counts(counted),
                stats=mesh.stats.as_dict(), ms_per_scan=start.elapsed_time(end) / len(scans),
                host_ms_per_scan=host_ms, cpu_ms_per_scan=cpu_ms)


def halo_view_search_check(view, shard, mesh, queries, cfg) -> dict:
    """On one rank of a spatial group, after its last scan: the view
    `build_halo_view` made (through the real exchange) searched (K3, then
    K1) for the queries this rank owns, against the same search on the
    merge of every rank's shard, gathered through the mesh (the replicated
    map), every field of the match bitwise for the owned queries, and no
    query it does not own matched. queries: (q_local, q_valid, t, R).
    Returns the check's result and the owned mask, for the parent."""
    import torch

    from lidar_odometry_demo_tpu_torch.kernels.search import query_world
    from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
    from lidar_odometry_demo_tpu_torch.parallel import spatial

    dev = view.keys.device
    q_local, q_valid, t, R = (x.to(dev) for x in queries)
    vs = cfg.keyframe_voxel_size

    def search(m, valid):
        cand = vm.gather_candidates(m, q_local, valid, t, R, voxel_size=vs)
        return vm.match_candidates(m, cand, q_local, valid, t, R,
                                   max_distance=cfg.icp_max_correspondence_distance,
                                   nrm_view=m.nrm)

    shards = mesh.all_gather_object(
        {f: getattr(shard, f).cpu() for f in ("tab", "keys", "count")})
    full = spatial.merge_blocks([shard._replace(**{f: x.to(dev) for f, x in sh.items()})
                                 for sh in shards])
    own = q_valid & spatial.owner_mask(query_world(q_local, R, t), view.origin, vs, mesh.sp)
    got, want = search(view, own), search(full, own)
    bad = [f for f in got._fields
           if not torch.equal(getattr(got, f)[own], getattr(want, f)[own])]
    return dict(bad_fields=bad, foreign_matched=bool(got.valid[~own].any()),
                owned=own, matched=int(got.valid[own].sum()), replicated_rows=full.capacity)


def _view_digest(view) -> str:
    """sha1 of a view's live rows (keys, counts, rows), in key order."""
    import hashlib

    live = view.keys != EMPTY_KEY
    h = hashlib.sha1()
    for x in (view.keys[live], view.count[live], view.tab[live]):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def halo_view_fields(shard, mesh, queries, cfg) -> dict:
    """On one rank of a spatial group, after its last scan: the halo view
    `build_halo_view` makes from this rank's final shard, its digest and
    live keys, and its search for the queries this rank owns
    (halo_view_search_check), for check_spatial_ranks."""
    from lidar_odometry_demo_tpu_torch.parallel import spatial

    view = spatial.build_halo_view(shard, mesh.sp)
    return dict(view_digest=_view_digest(view), view_rows=view.capacity,
                shard_rows=shard.capacity, view_live_keys=view.keys[view.keys != EMPTY_KEY],
                view_search=halo_view_search_check(view, shard, mesh, queries, cfg))


def sharded_rank(inputs: str) -> dict:
    """One of phase 10's two ranks (parallel/mesh.py run_ranks, gloo on
    cuda:0): (a) sp = 2, (b) spatial N = 2, (c) dp = 2 with four fleet lanes
    per rank, each a warm-up and a timed pass of the 40 scans; (d) the
    edge-sharded refine of phase 9's noisy loop and the edge-sharded
    segment-Schur refine of config 5's. Returns numpy results."""
    import torch

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
    from lidar_odometry_demo_tpu_torch.parallel import batched, spatial
    from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib
    from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg
    from lidar_odometry_demo_tpu_torch.pipeline import odometry
    from lidar_odometry_demo_tpu_torch.pipeline.graphs import CapturedStep

    cfg = OdometryConfig()
    mesh = mesh_lib.make_mesh(1, SHARDED_RANKS)
    dev = mesh.device
    data = torch.load(inputs.format(name="bench"), weights_only=False)
    scans = [LidarScan(*(x[i].to(dev) for x in data)) for i in range(data.xyz.shape[0])]
    counted = sharded_counters()
    out = {"backend": mesh.backend, "device": str(dev)}

    # (a) sp: every rank aligns its half of the matching points (the captured
    # step, which runs eager on gloo)
    step = CapturedStep(cfg, sp_group=mesh.sp)
    r = _sharded_drive(step, odometry.init_state(cfg, dev), scans, mesh, counted)
    r.pop("state")
    out["sp"] = r

    # (b) spatial: a column shard of the map per rank, the halo per scan
    step = CapturedStep(cfg, spatial_group=mesh.sp)
    r = _sharded_drive(step, spatial.init_spatial_state(cfg, SHARDED_RANKS, dev), scans, mesh,
                       counted)
    r.update(halo_view_fields(r.pop("state").keyframe, mesh, torch.load(
        inputs.format(name="queries"), weights_only=False), cfg))
    out["spatial"] = r

    # (c) dp: this rank's four of phase 7's eight lanes
    dmesh = mesh_lib.make_mesh(SHARDED_RANKS, 1)
    data = torch.load(inputs.format(name=f"fleet{dmesh.dp_index}"), weights_only=False)
    scans_b = [LidarScan(*(x[i].to(dev) for x in data)) for i in range(data.xyz.shape[0])]
    lanes = data.xyz.shape[1]
    step = batched.make_batched_step(cfg, dmesh)
    r = _sharded_drive(step, batched.init_batched_state(cfg, lanes, dev), scans_b, dmesh,
                       counted)
    r.pop("state")
    r["lanes"] = (dmesh.lanes(lanes * dmesh.dp).start, dmesh.lanes(lanes * dmesh.dp).stop)
    out["dp"] = r

    # (d) refine: the loop's edges split over the ranks, 10 iterations; then
    # the segment-Schur refine at config 5's shape
    _, _, est_t, est_q, closure = make_noisy_loop(32, 0.03)
    g = pg.chain_from_odometry(est_t, est_q, closures=[(31, 0, closure(31, 0), 1.0)],
                               device=dev)
    dmesh.stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = pg.make_refine_sharded(dmesh, "dp", iterations=10)(pg.pad_edges(g, dmesh.dp))
    out["refine"] = dict(t=refined.poses.t, q=refined.poses.q,
                         ms=(time.perf_counter() - t0) * 1e3, stats=dmesh.stats.as_dict())
    out["segment"] = sharded_segment_refine(dmesh.axis("dp"), dev)
    return out


SEGMENT = dict(poses=512, drift=0.02, stride=8, closures=((504, 0), (256, 0)), iterations=10)


def segment_loop(device):
    """Config 5's pose graph (benchmarks/run_configs.py config5): a 512-pose
    noisy loop (drift 0.02) with closures (504, 0) and (256, 0), whose
    indices are multiples of the stride 8. Returns (gt_t, est_t, graph)."""
    from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg

    gt_t, _, est_t, est_q, closure = make_noisy_loop(SEGMENT["poses"], SEGMENT["drift"])
    closures = [(i, j, closure(i, j), 1.0) for i, j in SEGMENT["closures"]]
    return gt_t, est_t, pg.chain_from_odometry(est_t, est_q, closures=closures, device=device)


def sharded_segment_refine(group, device) -> dict:
    """On one rank of `group`: the segment-Schur refine of `segment_loop`,
    this rank's slice of the edges (padded to the group's size), one
    all-reduce of the chain system per iteration. One warm-up run, then one
    timed run (host clock around a synchronised run). Returns the poses,
    the ms and the collectives of the timed run."""
    import torch

    from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg

    _, _, g = segment_loop(device)
    local = pg.shard_edges(pg.pad_edges(g, group.size), group)
    pg.refine_segment(local, SEGMENT["stride"], SEGMENT["iterations"], group)
    torch.cuda.synchronize()
    group.stats.reset(device_timing=True)
    t0 = time.perf_counter()
    refined = pg.refine_segment(local, SEGMENT["stride"], SEGMENT["iterations"], group)
    t, q = refined.poses.t.cpu(), refined.poses.q.cpu()
    return dict(t=t, q=q, ms=(time.perf_counter() - t0) * 1e3, stats=group.stats.as_dict())


def segment_reference(device) -> dict:
    """The one-process refine_segment of `segment_loop` on `device` (after
    one warm-up run), with RMS against ground truth before and after."""
    import torch

    from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg

    gt_t, est_t, g = segment_loop(device)
    pg.refine_segment(g, SEGMENT["stride"], SEGMENT["iterations"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = pg.refine_segment(g, SEGMENT["stride"], SEGMENT["iterations"]).poses.t.cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3

    def rms(x):
        return float(np.sqrt(np.mean(np.sum((x - gt_t) ** 2, -1))))

    return dict(t=t, ms=ms, rms_before=rms(est_t), rms_after=rms(t))


def check_segment_ranks(label: str, ranks: list, ref: dict) -> dict:
    """The ranks' segment refines (sharded_segment_refine) bitwise equal to
    each other, within 1e-4 m of the one-process refine_segment `ref`, RMS
    against ground truth halved, one all-reduce per iteration."""
    segs = [r["segment"] for r in ranks]
    d_ranks = max(max(float(np.abs(s["t"] - segs[0]["t"]).max()),
                      float(np.abs(s["q"] - segs[0]["q"]).max())) for s in segs)
    d_ref = float(np.abs(segs[0]["t"] - ref["t"]).max())
    reduces = [s["stats"]["by_kind"].get("chain system", 0) for s in segs]
    st = segs[0]["stats"]
    log(f"{label}: segment-Schur refine (P = {SEGMENT['poses']}, stride {SEGMENT['stride']}, "
        f"{SEGMENT['iterations']} iterations, {len(segs)} ranks): {d_ref:.3g} m from the "
        f"one-process refine_segment (bar 1e-4), ranks {d_ranks:.3g} apart; RMS vs ground truth "
        f"{ref['rms_before']:.4f} -> {ref['rms_after']:.4f} m; "
        f"{[round(s['ms'], 1) for s in segs]} ms per {SEGMENT['iterations']} iterations per rank "
        f"(one process: {ref['ms']:.1f} ms); {reduces[0]} all-reduces, host "
        f"{st['collective_host_ms']:.3f} ms, device {st['collective_device_ms']:.3f} ms, wait "
        f"{st['wait_ms']:.3f} ms")
    if d_ranks != 0.0 or d_ref > 1e-4 or not ref["rms_after"] < 0.5 * ref["rms_before"]:
        raise AssertionError(f"{label}: segment refine {d_ref} m from the one-process refine "
                             f"(bar 1e-4), ranks {d_ranks} apart, RMS {ref['rms_before']} -> "
                             f"{ref['rms_after']}")
    if reduces != [SEGMENT["iterations"]] * len(segs):
        raise AssertionError(f"{label}: segment refine all-reduces {reduces}, not one per "
                             f"iteration")
    return dict(from_one_process_m=d_ref, ms=[s["ms"] for s in segs], one_process_ms=ref["ms"],
                rms_before=ref["rms_before"], rms_after=ref["rms_after"], stats=st)


def nccl_rank() -> dict:
    """A world of one on the card: NCCL (each rank has a card of its own),
    one psum and one ppermute_from (to itself) through the mesh's group."""
    import torch

    from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(1, 1)
    mesh.stats.reset(device_timing=True)
    x = torch.arange(6, dtype=torch.float32, device=mesh.device)
    s = mesh.sp.psum(x.clone())
    y = mesh.sp.ppermute_from(x, 1)
    torch.cuda.synchronize()
    return dict(backend=mesh.backend, live=mesh.sp.live, psum=s, recv=y,
                stats=mesh.stats.as_dict())


def _per_scan(r: dict, n_scans: int) -> str:
    st = r["stats"]
    launches = " / ".join(f"{k} {v / n_scans:.2f}" for k, v in r["launches"].items())
    return (f"{r['ms_per_scan']:.3f} ms/scan by CUDA events ({r['host_ms_per_scan']:.3f} host, "
            f"{r['cpu_ms_per_scan']:.3f} process CPU); "
            f"collectives {st['collectives'] / n_scans:.2f}/scan (gathers "
            f"{st['gathers'] / n_scans:.2f}), host "
            f"{st['collective_host_ms'] / n_scans:.3f} ms/scan in the calls after "
            f"{st['wait_ms'] / n_scans:.3f} ms/scan waiting for queued work, device "
            f"{st['collective_device_ms'] / n_scans:.3f} ms/scan; halo exchanges "
            f"{st['exchanges'] / n_scans:.2f}/scan, {st['exchanged_bytes'] / n_scans / 1e6:.3f} "
            f"MB/scan, host {st['exchange_host_ms'] / n_scans:.3f} ms/scan (of which staging "
            f"{st['staging_ms'] / n_scans:.3f} ms, {st['staged_bytes'] / n_scans / 1e6:.3f} "
            f"MB/scan), device {st['exchange_device_ms'] / n_scans:.3f} ms/scan; captured "
            f"graphs holding collectives, device {st.get('graph_device_ms', 0.0) / n_scans:.3f} "
            f"ms/scan; {r['graph_launches'] / n_scans:.2f} graph launches and "
            f"{r['waits'] / n_scans:.2f} waits on the device per scan "
            f"({'captured' if r['captured'] else 'eager'} step); launches per scan {launches}")


def path_reference(bench: dict, diags: list, odo) -> dict:
    """What the sharded modes are held to, from phase 3's run (`diags`, the
    final state in `odo`): poses, iterations and matches per scan, the
    final map's keys, origin and voxel count, and the drive's ground
    truth."""
    from lidar_odometry_demo_tpu_torch.ops.voxel_map import map_size

    km = odo.state.keyframe
    return dict(t=np.stack([d.pose.t.cpu().numpy() for d in diags]),
                iters=np.array([int(d.icp_iterations) for d in diags]),
                matches=np.array([int(d.num_matches) for d in diags]),
                keys=km.keys.cpu().numpy(), origin=km.origin.cpu().numpy(),
                voxels=int(map_size(km)), gt_rel=bench["gt_rel"])


def voxel_codes(keys: np.ndarray, origin: np.ndarray) -> np.ndarray:
    """A map's live keys as absolute voxel indices, one int64 code each:
    keys are relative to the map's origin, and the spatial mode rebases in
    steps of N where the single path rebases in steps of 1."""
    from lidar_odometry_demo_tpu_torch.kernels.search import _XOFF, _YB, _YOFF, _ZB, _ZOFF

    k = keys[keys != EMPTY_KEY].astype(np.int64)
    x = (k >> (_YB + _ZB)) - _XOFF + int(origin[0])
    y = ((k >> _ZB) & ((1 << _YB) - 1)) - _YOFF + int(origin[1])
    z = (k & ((1 << _ZB) - 1)) - _ZOFF + int(origin[2])
    return ((x + (1 << 20)) << 42) | ((y + (1 << 20)) << 21) | (z + (1 << 20))


def _ranks_equal(label: str, rs: list, fields) -> None:
    for f in fields:
        if not all(np.array_equal(r[f], rs[0][f]) for r in rs[1:]):
            raise AssertionError(f"{label}: the ranks' {f} differ")


def _split_schedule(label: str, rs: list, n_scans: int) -> None:
    """Every rank launched the split step's schedule: per ICP round (one
    gather of matches and cost) one K1, one jtwj_accumulate, a gn_sum_step
    per later inner iteration, one K2e and one condition, with a gather of
    H and b per inner iteration; per scan two lookups and one condition
    before the rounds (a group's step runs ICP on every scan)."""
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig

    inner = OdometryConfig().icp_inner_iterations
    for i, r in enumerate(rs):
        by_kind = r["stats"]["by_kind"]
        rounds = by_kind.get("matches,cost", 0)
        want = {"match_rows": rounds, "jtwj_accumulate": rounds,
                "gn_sum_step": (inner - 1) * rounds, "gn_epilogue": rounds,
                "search_sorted": 2 * n_scans, "loop_condition": rounds + n_scans,
                "prepare": n_scans,
                "map_update": n_scans}
        if r["launches"] != want or by_kind.get("H,b", 0) != inner * rounds:
            raise AssertionError(f"{label}, rank {i}: launches {r['launches']} != the split "
                                 f"schedule {want}, or {by_kind.get('H,b', 0)} gathers of H and "
                                 f"b for {rounds} rounds")
        # the rounds driven from the host, one wait each; captured (NCCL):
        # per scan (a) and (c), and (b) per round; eager (gloo): no graph
        graph_launches = 2 * n_scans + rounds if r["captured"] else 0
        if (r["waits"], r["graph_launches"]) != (rounds, graph_launches):
            raise AssertionError(f"{label}, rank {i}: {r['waits']} waits and "
                                 f"{r['graph_launches']} graph launches for {rounds} rounds "
                                 f"over {n_scans} scans (want {rounds} and {graph_launches})")


def _drift(label: str, a: dict, ref: dict) -> tuple[float, np.ndarray, float]:
    """A sharded run's poses against phase 3's: finite and of its shape;
    returns the largest |dt| (m), the per-scan matches minus phase 3's, and
    the aligned ATE."""
    from lidar_odometry_demo_tpu_torch.io.trajectory import ate_rmse

    st = ref["t"]
    if not np.all(np.isfinite(a["t"])) or a["t"].shape != st.shape:
        raise AssertionError(f"{label}: non-finite or misshapen poses")
    per_scan = np.abs(a["t"] - st).max(axis=1)
    d_matches = a["matches"].astype(np.int64) - ref["matches"]
    log(f"{label}: |dt| from phase 3 per scan (every 5th scan from 0) "
        f"{[float(f'{x:.3g}') for x in per_scan[::5]]}, first over 1e-6 m at scan "
        f"{int(np.argmax(per_scan > 1e-6)) if (per_scan > 1e-6).any() else None}; matches minus "
        f"phase 3's at the scans that differ "
        f"{ {int(i): int(d_matches[i]) for i in np.flatnonzero(d_matches)} }")
    return float(per_scan.max()), d_matches, float(ate_rmse(a["t"], ref["gt_rel"], align=True))


def check_sp_ranks(label: str, rs: list, ref: dict, witness: dict) -> dict:
    """An sp mode's ranks (_sharded_drive results) against phase 3 (`ref`,
    path_reference) and the one-process witness of the split sums
    (`witness`, sp_witness at the same group size): the ranks bitwise each
    other and bitwise the witness (every sum is added in rank order, so the
    backend adds nothing of its own); within SP_FROM_MAIN_M of phase 3,
    every scan's matches within SP_MATCHES_FROM_MAIN of the drive's largest
    count of phase 3's, iterations equal, ATE within 1e-4 m of
    MAIN_PATH_ATE, no scan diverged, the split launch schedule. Returns the
    numbers."""
    a, n_scans = rs[0], len(ref["t"])
    _ranks_equal(label, rs, ("t", "q", "iters", "matches", "map_voxels"))
    for i, r in enumerate(rs):
        log(f"{label}, rank {i} ({r.get('device', '')}): {_per_scan(r, n_scans)}")
    d_main, d_matches, ate = _drift(label, a, ref)
    rounds = a["stats"]["by_kind"].get("matches,cost", 0)
    from_witness = max(float(np.abs(a[f] - witness[f]).max()) for f in ("t", "q"))
    witness_main = float(np.abs(witness["t"] - ref["t"]).max())
    same = all(np.array_equal(a[f], witness[f]) for f in witness)
    worst_matches = int(np.abs(d_matches).max())
    matches_bar = SP_MATCHES_FROM_MAIN * int(ref["matches"].max())
    iters_equal = np.array_equal(a["iters"], ref["iters"])
    log(f"{label}: ranks bitwise equal; {d_main:.3g} m from phase 3 (bar {SP_FROM_MAIN_M}); "
        f"bitwise the one-process witness of the split sums: {same} ((t, q) {from_witness:.3g} "
        f"apart; the witness {witness_main:.3g} m from phase 3); matches at most "
        f"{worst_matches} from phase 3's (bar {matches_bar:.0f}); iterations equal "
        f"{iters_equal}; ATE {ate:.5f} m; {rounds} ICP rounds (the first scan's included: ICP "
        f"always runs under a group); per rank and scan "
        f"{a['launches']['gn_epilogue'] / n_scans:.2f} K2e and "
        f"{a['launches']['gn_sum_step'] / n_scans:.2f} gn_sum_step launches, "
        f"{a['stats']['gathers'] / n_scans:.2f} gathers")
    if not same:
        raise AssertionError(f"{label}: not bitwise the one-process witness of the split sums: "
                             f"something other than the sum order moves the ranks")
    if d_main > SP_FROM_MAIN_M or not iters_equal or worst_matches > matches_bar:
        raise AssertionError(f"{label}: {d_main} m from phase 3 (bar {SP_FROM_MAIN_M}), "
                             f"iterations differ, or matches off by {worst_matches} (bar "
                             f"{matches_bar:.0f})")
    if abs(ate - MAIN_PATH_ATE) > 1e-4 or a["diverged"].any():
        raise AssertionError(f"{label}: ATE {ate} not within 1e-4 m of {MAIN_PATH_ATE}, or a "
                             f"scan diverged")
    _split_schedule(label, rs, n_scans)
    return dict(ms_per_scan=[r["ms_per_scan"] for r in rs],
                host_ms_per_scan=[r["host_ms_per_scan"] for r in rs],
                stats=[r["stats"] for r in rs], launches=a["launches"], from_phase3_m=d_main,
                from_witness=from_witness, witness_from_phase3_m=witness_main,
                matches_from_phase3=worst_matches, ate=ate)


def check_spatial_ranks(label: str, rs: list, ref: dict, q_valid: np.ndarray) -> dict:
    """A spatial mode's ranks (_sharded_drive results with
    halo_view_fields) against phase 3 (`ref`, path_reference): the ranks'
    poses, iterations, matches, voxel counts and origins bitwise each
    other's; within SPATIAL_FROM_MAIN_M of phase 3, ATE under ATE_CEILING,
    no scan diverged, the split launch schedule; the shards' voxels
    disjoint, as many as the ranks' map_voxels, and phase 3's voxel set but
    for 1e-3 of it (the trajectories differ in ulps, so a few update points
    land in other voxels); each rank's halo view holding exactly its own
    and its ring neighbours' shards (every rank's view alike up to three
    ranks); each rank's view search bitwise the gathered map's for the
    queries it owns (q_valid: phase 3's last lookup), the owned queries a
    partition. Returns the numbers."""
    a, n, n_scans = rs[0], len(rs), len(ref["t"])
    _ranks_equal(label, rs, ("t", "q", "iters", "matches", "map_voxels", "origin"))
    for i, r in enumerate(rs):
        log(f"{label}, rank {i} ({r.get('device', '')}): {_per_scan(r, n_scans)}")
    d_main, _, ate = _drift(label, a, ref)
    if d_main > SPATIAL_FROM_MAIN_M or ate > ATE_CEILING or a["diverged"].any():
        raise AssertionError(f"{label}: {d_main} m from phase 3 (bar {SPATIAL_FROM_MAIN_M}), ATE "
                             f"{ate} m, or {int(a['diverged'].sum())} scans diverged")
    codes = [voxel_codes(r["keys"], r["origin"]) for r in rs]
    total = sum(len(c) for c in codes)
    union = np.unique(np.concatenate(codes))
    differ = len(np.setxor1d(union, voxel_codes(ref["keys"], ref["origin"])))
    log(f"{label}: {d_main:.3g} m from phase 3, ATE {ate:.5f} m; shards of {a['shard_rows']} "
        f"rows holding {[len(c) for c in codes]} voxels ({total} in all, the ranks' map_voxels "
        f"{int(a['map_voxels'][-1])}, phase 3's {ref['voxels']}; {differ} voxels in one map "
        f"only), disjoint {len(union) == total}; halo views of {a['view_rows']} rows")
    if len(union) != total or total != int(a["map_voxels"][-1]) or differ > 1e-3 * ref["voxels"]:
        raise AssertionError(f"{label}: the shards share a voxel ({len(union) != total}), hold "
                             f"{total} voxels against map_voxels {int(a['map_voxels'][-1])}, or "
                             f"{differ} voxels differ from phase 3's map (bar "
                             f"{1e-3 * ref['voxels']:.0f})")
    live = [r["keys"][r["keys"] != EMPTY_KEY] for r in rs]
    for i, r in enumerate(rs):
        held = sorted({i, (i + 1) % n, (i - 1) % n})
        if not np.array_equal(r["view_live_keys"], np.sort(np.concatenate([live[j]
                                                                          for j in held]))):
            raise AssertionError(f"{label}, rank {i}: the halo view does not hold exactly the "
                                 f"shards of ranks {held}")
    if n <= 3 and any(r["view_digest"] != a["view_digest"] for r in rs):
        raise AssertionError(f"{label}: the ranks' halo views differ")
    for i, r in enumerate(rs):
        v = r["view_search"]
        if v["bad_fields"] or v["foreign_matched"]:
            raise AssertionError(f"{label}, rank {i}: the halo view's search differs from the "
                                 f"gathered map's in {v['bad_fields']} (or matched a query it "
                                 f"does not own: {v['foreign_matched']})")
    if not np.array_equal(sum(r["view_search"]["owned"].astype(np.int32) for r in rs),
                          q_valid.astype(np.int32)):
        raise AssertionError(f"{label}: the ranks' owned queries are no partition")
    log(f"{label}: each rank's halo view holds its own and its ring neighbours' shards; on each "
        f"rank its search bitwise the search on the merge of the gathered shards "
        f"({a['view_search']['replicated_rows']} rows), every field, for its owned queries "
        f"(matched {[r['view_search']['matched'] for r in rs]} of {int(q_valid.sum())}), the "
        f"owned queries a partition")
    _split_schedule(label, rs, n_scans)
    st = a["stats"]
    return dict(ms_per_scan=[r["ms_per_scan"] for r in rs],
                host_ms_per_scan=[r["host_ms_per_scan"] for r in rs],
                stats=[r["stats"] for r in rs], launches=a["launches"], from_phase3_m=d_main,
                ate=ate, halo_mb_per_scan=st["exchanged_bytes"] / n_scans / 1e6,
                halo_device_ms_per_scan=st["exchange_device_ms"] / n_scans,
                halo_host_ms_per_scan=st["exchange_host_ms"] / n_scans)


def check_dp_ranks(label: str, rs: list, fleet: dict) -> dict:
    """A dp fleet's ranks (_sharded_drive results with `lanes`, the (lo,
    hi) of phase 7's lanes the rank stepped): every lane bitwise phase 7's
    (`fleet`, run_fleet: poses, iterations, final keys, counts and origin),
    then the batched launch schedule on every rank. Returns the numbers."""
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig

    inner = OdometryConfig().icp_inner_iterations
    fd, fk = fleet["diags"], fleet["state"].keyframe
    n_scans = fd.pose.t.shape[0]
    for i, r in enumerate(rs):
        lo, hi = r["lanes"]
        same = [np.array_equal(r["t"], fd.pose.t[:, lo:hi].cpu().numpy()),
                np.array_equal(r["q"], fd.pose.q[:, lo:hi].cpu().numpy()),
                np.array_equal(r["iters"], fd.icp_iterations[:, lo:hi].cpu().numpy())]
        same += [np.array_equal(r[f], getattr(fk, f)[lo:hi].cpu().numpy())
                 for f in ("keys", "count", "origin")]
        log(f"{label}, rank {i} ({r.get('device', '')}, lanes {lo}-{hi - 1}), per step of "
            f"{hi - lo}: {_per_scan(r, n_scans)}")
        if not all(same):
            raise AssertionError(f"{label}, rank {i}: lanes {lo}-{hi - 1} differ from phase 7's "
                                 f"(t, q, iterations, keys, count, origin equal = {same})")
    log(f"{label}: every lane bitwise phase 7's (poses, iterations, final keys, counts, origin)")
    for i, r in enumerate(rs):
        rounds = int(r["iters"].max(axis=1).sum())
        # the step is captured in the warm-up pass: only the first step is eager
        want = {"match_rows": rounds, "jtwj_accumulate": inner * rounds, "gn_sum_step": 0,
                "gn_epilogue": 0,
                "search_sorted": int(np.sum(r["iters"].max(axis=1) > 0)) + n_scans,
                "loop_condition": loop_schedule(r["iters"]), "prepare": n_scans,
                "map_update": n_scans}
        if r["launches"] != want:
            raise AssertionError(f"{label}, rank {i}: launches {r['launches']} != the batched "
                                 f"schedule {want}")
        # the fresh state's first step eager (two first-scan reads: the
        # state copied in, then the eager step's own), then per step (a),
        # the loop graph and the first-scan test's one wait
        if (r["waits"], r["graph_launches"]) != (n_scans + 1, 2 * (n_scans - 1)):
            raise AssertionError(f"{label}, rank {i}: {r['waits']} waits and "
                                 f"{r['graph_launches']} graph launches over {n_scans} steps "
                                 f"(want {n_scans + 1} and {2 * (n_scans - 1)})")
    return dict(ms_per_scan=[r["ms_per_scan"] for r in rs],
                host_ms_per_scan=[r["host_ms_per_scan"] for r in rs],
                cpu_ms_per_scan=[r["cpu_ms_per_scan"] for r in rs],
                stats=[r["stats"] for r in rs], launches=rs[0]["launches"])


def run_sharded(bench: dict, main_diags: list, main_odo, fleet: dict, refine: dict,
                device) -> dict:
    """Phase 10: the kernels are built (phase 1) before any rank starts, so
    no rank runs nvcc; two ranks on cuda:0 over gloo run (a)-(d)
    (sharded_rank), held to phases 3, 7 and 9 and (the segment refine) to
    the one-process refine_segment on the card; the composite search against
    the replicated one on the main path's map at N = 2 and 4; a world of one
    on NCCL. Returns each mode's launches and numbers."""
    import tempfile

    import torch

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.kernels import _build
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
    from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib

    from lidar_odometry_demo_tpu_torch.kernels.jtwj import gn_epilogue, gn_sum_step

    cfg = OdometryConfig()
    if not all(_build._lib_path(name).exists() for name in _build.SOURCES):
        raise AssertionError("phase 10: the kernels are not built before the ranks start")
    if gn_epilogue.launches or gn_sum_step.launches:
        raise AssertionError(f"K2's split-step entry points ran {gn_sum_step.launches} / "
                             f"{gn_epilogue.launches} times on the single-process paths "
                             f"(phases 3-9), which never split a step")

    # the composite view's search on the card, at N = 2 (C rows) and N = 4
    # (3C/4 rows, no power of two), on the main path's final map at one more
    # step's guess pose
    lookup = path_lookups(main_odo, bench["scans"][-1])["neighbourhood"][0][0]
    for n in (2, 4):
        c = composite_search_check(main_odo.state.keyframe, lookup, n, cfg)
        log(f"sharded: composite search at N = {n} ({c['rows']} rows per view, shards of "
            f"{c['shard_rows']} voxels) bitwise the replicated search for every owned query; "
            f"{c['matches']} matches")

    tmp = tempfile.mkdtemp(prefix="sharded_")
    try:
        t0 = time.perf_counter()
        torch.save(LidarScan(*(torch.stack([getattr(s, f) for s in bench["scans"]]).cpu()
                               for f in LidarScan._fields)), os.path.join(tmp, "bench.pt"))
        B = fleet["scans"].xyz.shape[1]
        per = B // SHARDED_RANKS
        for d in range(SHARDED_RANKS):
            torch.save(LidarScan(*(x[:, d * per:(d + 1) * per].cpu() for x in fleet["scans"])),
                       os.path.join(tmp, f"fleet{d}.pt"))
        q_local, q_valid, t, R = lookup[3:7]
        torch.save([x.cpu() for x in (q_local, q_valid, t, R)], os.path.join(tmp, "queries.pt"))
        log(f"sharded: inputs written for the ranks in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ranks = mesh_lib.run_ranks(sharded_rank, SHARDED_RANKS,
                                   os.path.join(tmp, "{name}.pt"), device="cuda",
                                   timeout=600)
        log(f"sharded: {SHARDED_RANKS} ranks spawned, ran (a)-(d) and joined in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    log(f"sharded: {SHARDED_RANKS} ranks on {r0['device']} ({torch.cuda.get_device_name(0)}), "
        f"backend {r0['backend']}; two ranks on one card measure correctness and per-rank "
        f"overhead, not scaling")
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"sharded: two ranks on one card must pick gloo: "
                             f"{[r['backend'] for r in ranks]}")

    t0 = time.perf_counter()
    witness = sp_witness(cfg, bench["scans"], device, SHARDED_RANKS)
    log(f"sharded: the sp witness (two threads of this process, their parts gathered and "
        f"added in rank order) ran the 40 scans in {time.perf_counter() - t0:.1f} s")
    ref = path_reference(bench, main_diags, main_odo)
    results = {"sp": check_sp_ranks("sharded sp", [r["sp"] for r in ranks], ref, witness),
               "spatial": check_spatial_ranks("sharded spatial", [r["spatial"] for r in ranks],
                                              ref, lookup[4].cpu().numpy()),
               "dp": check_dp_ranks("sharded dp", [r["dp"] for r in ranks], fleet)}

    # (d) the edge-sharded refine against phase 9's loop (direct)
    ref = refine["loop_direct"]
    tol = 5e-3 * ref["correction_m"]
    d_t = max(float(np.abs(r["refine"]["t"] - ref["t"]).max()) for r in ranks)
    d_ranks = float(np.abs(ranks[0]["refine"]["t"] - ranks[1]["refine"]["t"]).max())
    log(f"sharded refine (2 ranks, edges split, 10 iterations): {d_t:.3g} m from phase 9's "
        f"refine (bar {tol:.3g}: 5e-3 of the correction), ranks {d_ranks:.3g} apart; "
        f"{ranks[0]['refine']['ms']:.1f} ms, {ranks[0]['refine']['stats']['collectives']} "
        f"collectives")
    if d_t > tol or d_ranks != 0.0:
        raise AssertionError(f"sharded refine: {d_t} m from phase 9 (bar {tol}) or ranks "
                             f"{d_ranks} apart")
    results["refine"] = dict(from_phase9_m=d_t, ms=ranks[0]["refine"]["ms"])
    results["segment"] = check_segment_ranks("sharded refine", ranks, segment_reference(device))

    # the NCCL branch: a world of one on the card
    (nc,) = mesh_lib.run_ranks(nccl_rank, 1, device="cuda", timeout=300)
    ok = (nc["backend"] == "nccl" and nc["live"]
          and np.array_equal(nc["psum"], np.arange(6, dtype=np.float32))
          and np.array_equal(nc["recv"], np.arange(6, dtype=np.float32))
          and nc["stats"]["collectives"] == 1 and nc["stats"]["exchanges"] == 1
          and nc["stats"]["staged_bytes"] == 0
          and nc["stats"]["collective_device_ms"] > 0 and nc["stats"]["exchange_device_ms"] > 0)
    if not ok:
        raise AssertionError(f"sharded: the NCCL world of one failed its checks: {nc}")
    log(f"sharded: a world of one picks {nc['backend']}; psum and ppermute_from (to itself) "
        f"ran through it ({nc['stats']['collectives']} all-reduce, "
        f"{nc['stats']['exchanges']} exchange, no staging; device ms by CUDA events "
        f"{nc['stats']['collective_device_ms']:.4f} / {nc['stats']['exchange_device_ms']:.4f}, "
        f"host {nc['stats']['collective_host_ms']:.4f} / {nc['stats']['exchange_host_ms']:.4f});"
        f" NCCL between cards: multicard_smoke.py")
    results["launches"] = {mode: results[mode]["launches"] for mode in ("sp", "spatial", "dp")}
    return results


# --------------------------------------------------------------------------
# phase 11: the captured step against the eager step
# --------------------------------------------------------------------------

def _eager_drive(cfg, state, scans):
    """The eager step (make_process_scan, every operation launched from
    Python) over `scans` from `state`: (final state, per-scan diagnostics)."""
    import torch

    from lidar_odometry_demo_tpu_torch.pipeline.odometry import make_process_scan

    step = make_process_scan(cfg)
    diags = []
    for scan in scans:
        state, diag = step(state, scan)
        diags.append(diag)
    torch.cuda.synchronize()
    return state, diags


def _bitwise_drives(label: str, got: tuple, want: tuple) -> None:
    """Two drives' (per-scan diagnostics, final state) bitwise: poses, ICP
    iterations and matches of every scan (lane by lane), final keys, counts
    and origin."""
    import torch

    (g_diags, g_state), (w_diags, w_state) = got, want
    bad = [f"scan {i} {f}" for i, (g, w) in enumerate(zip(g_diags, w_diags))
           for f, x, y in (("pose.t", g.pose.t, w.pose.t), ("pose.q", g.pose.q, w.pose.q),
                           ("icp_iterations", g.icp_iterations, w.icp_iterations),
                           ("num_matches", g.num_matches, w.num_matches))
           if not torch.equal(x, y)]
    bad += [f"final {f}" for f in ("keys", "count", "origin")
            if not torch.equal(getattr(g_state.keyframe, f), getattr(w_state.keyframe, f))]
    if bad or len(g_diags) != len(w_diags):
        raise AssertionError(f"{label}: the captured step differs from the eager step: "
                             f"{bad[:8]}")


def step_counts(run, scans) -> dict:
    """run(scan) -> the scan's ICP iterations (a device tensor, read after
    the scans, so that the count adds no synchronisation) over `scans` (a
    warmed step): per scan, the synchronising calls (torch's sync debug
    mode warnings plus the step's waits on its pinned host copies,
    `HostFlags.waits`, which that mode does not see), the graph launches
    from the host (`pipeline.graphs.graph_launches`) and the ICP rounds (a
    step's rounds are its slowest lane's)."""
    import warnings

    import torch

    from lidar_odometry_demo_tpu_torch.device import HostFlags
    from lidar_odometry_demo_tpu_torch.pipeline import graphs

    torch.cuda.synchronize()
    waits, launched = HostFlags.waits, graphs.graph_launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            iters = [run(scan) for scan in scans]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n = len(scans)
    waits, launched = HostFlags.waits - waits, graphs.graph_launches - launched
    # one warning per synchronising call (the mode's own notice aside)
    warned = sum("called a synchronizing" in str(w.message) for w in caught)
    return dict(scans=n, sync_warnings=warned / n, waits=waits / n, syncs=(warned + waits) / n,
                graph_launches=launched / n, rounds=sum(int(x.max()) for x in iters) / n)


def run_capture_check(bench: dict, paths: dict, fleet: dict, device) -> dict:
    """Phase 11: the eager step over the scans of the main, parity and live
    paths from a fresh state and over the fleet's B = 8 drives, each
    bitwise the captured step's run of phases 3, 5, 8 and 7 (`paths`: name
    -> (diagnostics, final state, launches, scans), `fleet`: phase 7's
    result), lane by lane, with every launch counter equal (the loop's
    condition among them: the eager step's loop runs the loop graph's
    schedule from the host). Then, per scan for both steps on each path
    (per step of 8 on the fleet; `step_counts` over scans 20-39 after 20 of
    warm-up), synchronising calls, graph launches and ICP rounds. It fails
    unless the captured step makes exactly one synchronising call and at
    most two graph launches per scan on every path, and both steps run the
    same rounds (4.00 per scan on the main path)."""
    from lidar_odometry_demo_tpu_torch.config import OdometryConfig, reference_parity
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
    from lidar_odometry_demo_tpu_torch.parallel import batched
    from lidar_odometry_demo_tpu_torch.pipeline import odometry
    from lidar_odometry_demo_tpu_torch.pipeline.graphs import CapturedStep

    cfg = OdometryConfig()
    cfgs = dict(main=cfg, parity=reference_parity(cfg), live=cfg)

    S, B = fleet["scans"].xyz.shape[:2]
    lanes = [LidarScan(*(x[s] for x in fleet["scans"])) for s in range(S)]
    f_diags = [odometry.StepDiagnostics(*(None if x is None else (
        type(x)(*(y[s] for y in x)) if isinstance(x, tuple) else x[s]) for x in fleet["diags"]))
        for s in range(S)]
    drives = {name: (cfgs[name], odometry.init_state(cfgs[name], device), scans,
                     (diags, state), launches)
              for name, (diags, state, launches, scans) in paths.items()}
    drives[f"fleet (B = {B})"] = (cfg, batched.init_batched_state(cfg, B, device), lanes,
                                  (f_diags, fleet["state"]), fleet["launches"])
    for name, (c, state0, scans, got, launches) in drives.items():
        zero_counts()
        e_state, e_diags = _eager_drive(c, state0, scans)
        e_launches = read_counts()
        _bitwise_drives(f"{name} path", got, (e_diags, e_state))
        if e_launches != launches:
            raise AssertionError(f"{name} path: the captured run's launches {launches} differ "
                                 f"from the eager step's {e_launches}")
    log(f"captured step: bitwise the eager step on the main, parity and live paths "
        f"({', '.join(str(len(d[2])) for d in drives.values())} scans) and on the fleet "
        f"(B = {B}, every lane): poses, iterations, matches, final keys, counts and origin; "
        f"every launch counter (the loop's condition among them) equal to the eager step's")

    out = {}
    for name, (c, _, scans, _, _) in drives.items():
        B_ = B if name.startswith("fleet") else 0
        unit = f"step of {B}" if B_ else "scan"
        for label in ("eager", "captured"):
            step = odometry.make_process_scan(c) if label == "eager" else CapturedStep(c)
            state = [batched.init_batched_state(c, B_, device) if B_
                     else odometry.init_state(c, device)]

            def run(scan, step=step, state=state):
                state[0], diag = step(state[0], scan)
                return diag.icp_iterations

            for scan in scans[:20]:
                run(scan)
            m = out[f"{name.split()[0]} {label}"] = step_counts(run, scans[20:40])
            log(f"phase 11, {name.split()[0]} {label} step, per {unit} (scans 20-39): "
                f"{m['syncs']:.2f} synchronising calls (sync debug warnings "
                f"{m['sync_warnings']:.2f}, step waits {m['waits']:.2f}), "
                f"{m['graph_launches']:.2f} graph launches, {m['rounds']:.2f} ICP rounds")
        e, g = out[f"{name.split()[0]} eager"], out[f"{name.split()[0]} captured"]
        if abs(g["syncs"] - 1.0) > 1e-9 or g["graph_launches"] > 2 + 1e-9:
            raise AssertionError(f"phase 11, {name}: the captured step makes {g['syncs']} "
                                 f"synchronising calls and {g['graph_launches']} graph launches "
                                 f"per {unit} (1 and at most 2 asked)")
        if e["rounds"] != g["rounds"]:
            raise AssertionError(f"phase 11, {name}: ICP rounds per {unit} eager {e['rounds']}, "
                                 f"captured {g['rounds']}")
    main_rounds = out["main captured"]["rounds"]
    if main_rounds != 4.0:
        raise AssertionError(f"phase 11: {main_rounds} ICP rounds per scan on the main path "
                             f"(4.00 before the loop moved to the device)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from lidar_odometry_demo_tpu_torch.kernels import _build

    device = torch.device("cuda")
    card = card_line()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    _build.build_all()
    log(f"kernels built in {_build.build_seconds:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(1234)
    kernels = [check_match_rows(rng, device), check_jtwj(rng, device),
               check_loop_condition(np.random.default_rng(11), device)]
    split_kernels = check_gathered_step(np.random.default_rng(7), device)
    bench = bench_drive(device)
    odo, launches, main_diags, single_ms = run_main_path(bench, device)
    kernels.append(check_prepare(bench, main_diags, device))
    kernels.append(check_map_update(bench, device))
    kernels.append(check_search(device, path_lookups(odo, bench["scans"][-1])))
    parity_odo, parity, parity_diags = run_reference_parity(bench, device)
    check_lookups("reference_parity path's map", path_lookups(parity_odo, bench["scans"][-1]))
    cli_launches = run_cli()
    fleet = run_fleet(bench, main_diags, odo, single_ms, device)
    last = type(fleet["scans"])(*(x[-1] for x in fleet["scans"]))
    fleet_numbers = check_fleet_kernels(fleet_calls(fleet["state"], last), device)
    cli_fleet = run_fleet_cli()
    live_path = run_live_path(bench, main_diags, single_ms, device)
    run_live_cli(bench)
    refine = run_refine(main_diags, device)
    sharded = run_sharded(bench, main_diags, odo, fleet, refine, device)
    run_capture_check(bench, dict(
        main=(main_diags, odo.state, launches, bench["scans"]),
        parity=(parity_diags, parity_odo.state, parity, bench["scans"]),
        live=(live_path["diags"], live_path["state"], live_path["launches"],
              live_path["uploaded"])), fleet, device)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_reference_parity"] = parity[k["name"]]
        k["launches_cli"] = cli_launches[k["name"]]
        k["launches_fleet"] = fleet["launches"][k["name"]]
        k["launches_cli_fleet"] = cli_fleet[k["name"]]
        k["launches_live"] = live_path["launches"][k["name"]]
        k["launches_refine"] = refine["launches"][k["name"]]
        k.update(fleet_numbers.get(k["name"], {}))  # the condition's B = 8 numbers are its own
        k["kernel_ms"] = k["ms"]
    for k in kernels + list(split_kernels):
        for mode in ("sp", "spatial", "dp"):
            k[f"launches_sharded_{mode}"] = sharded["launches"][mode][k["name"]]
    # the split step's entry points run only on the sharded paths: their
    # launches are the sp path's (per rank), and 0 on every phase 3-9 path
    for k in split_kernels:
        k["launches"] = k["launches_sharded_sp"]
    kernels += split_kernels
    print(json.dumps({"kernels": kernels, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def stop_helper_processes() -> None:
    """Stop every process this script started that is still running, then
    multiprocessing's resource tracker (started by the first spawned
    process), and reap them all. Left to the interpreter's exit, the
    tracker outlives this process: it exits only when it reads the end of
    its pipe, after this process has gone, and waits unreaped until then."""
    import gc
    import multiprocessing
    from multiprocessing import resource_tracker

    for child in multiprocessing.active_children():
        child.terminate()
        child.join(10.0)
        if child.is_alive():
            child.kill()
            child.join(10.0)
    gc.collect()  # finalize (unlink) the semaphores no one holds before the tracker goes
    resource_tracker._resource_tracker._stop()


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_helper_processes()
    sys.exit(code)
