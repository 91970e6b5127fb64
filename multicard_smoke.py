"""Drive the PyTorch/CUDA port's sharded modes with one rank per card, on
every card of the machine (up to four), over NCCL, and check them.

    python3 multicard_smoke.py

`chip_smoke.py` is the one-card smoke test (its phase 10 runs the sharded
modes as two ranks on one card over gloo); this script runs them as their
users do, each rank on a card of its own. It raises with fewer than two
cards: there is no stand-in. The kernels are built in this process before
any rank starts, and every rank asserts that its group runs on NCCL
(`parallel/mesh.py` `choose_backend`). It reuses `chip_smoke.py`'s helpers
by import.

This process first computes the references on cuda:0: the main path
(chip_smoke phase 3) and the fleet path at B = 8 (phase 7) on the 40-scan
bench drive at full width (`OdometryConfig()`), the one-process sp
witnesses at two and four ranks (`sp_witness`, the split parts gathered
and added in rank order, as the ranks add them), the
one-process refines on the card, and each kernel against its plain version
(phases 2 and 4, K2's split-step entry points included). Then every mode
that fits
the cards, the shapes for four (with two, those that fit):

a. K2 on two cards in one process: the fused step (`gn_step`) and
   `jtwj_accumulate` at Q = 8192 on cuda:0, then cuda:1, on the same
   inputs: bitwise equal (a refused launch on the second card is reported
   with its error);
b. dp = N fleet: phase 7's 8 lanes on each card (B = 8N): every lane
   bitwise phase 7's; per-rank ms per step of 8, aggregate scans/s and its
   ratio to N times phase 7's B = 8 rate in this call (the scaling
   efficiency), each rank's host-clock and process-CPU ms per step beside
   its CUDA-event ms, the host's cores and each rank's CPU affinity;
c. sp = 2 on two cards: bitwise the two-thread witness, iterations equal
   to phase 3's, within 1e-4 m of phase 3 (the JAX package's bar for an sp sequence,
   tests/test_parallel.py:147), ATE within 1e-4 m of 0.00936 m;
d. sp = 4, then dp = 2 x sp = 2 (the bench drive on each dp index), as c:
   every rank's poses, iterations and matches bitwise every other rank's
   and bitwise the witness of its group size (every sum over the ranks is
   added in rank order, by K2 for H and b, so NCCL adds nothing of its
   own), within 1e-4 m of phase 3, matches within 2 % of phase 3's largest
   count, iterations equal, ATE as in c. At sp = 4 a second pass checks
   every gather (its parts bitwise the operands all-gathered again from
   every rank) and every sum K2 takes of them (bitwise the rank-order sum of
   the parts the rank gathered, added by torch);
e. spatial N = 4: shards of C/4 rows, halo views of 3C/4; within 1e-3 m of
   phase 3, ATE under 0.03 m, the shards disjoint with phase 3's voxel
   count in all, and on each rank the halo view's search bitwise the
   search on the merge of the gathered shards (`halo_view_search_check`),
   the owned queries a partition; halo MB and device ms per scan;
f. dp = 2 x spatial N = 2 (`make_batched_spatial_sequence_runner`) on
   lanes 0-3 of phase 7's drives: each lane within 1e-3 m of its phase-7
   lane;
g. the edge-sharded refine over N ranks: direct and Schur
   (`make_refine_sharded`) on phase 9's 32-pose loop, and the segment-Schur
   refine (`refine_segment` with a group) at config 5's shape (512 poses,
   stride 8, closures (504, 0) and (256, 0)), 10 iterations each: within
   1e-4 m of the one-process refine on the card, the ranks bitwise equal,
   RMS against ground truth before and after, ms per 10 iterations;
h. the sharded checkpoint over NCCL: spatial N = 4 saved after scan 20
   (`save_sharded`), loaded into a fresh state (`load_sharded`), scans
   21-39 run: bitwise (poses and final shards) the uninterrupted run of e;
i. the CLI and the launcher: `fleet --batch 8 --scans 40 --dp 2 --sp 2`
   (it spawns its ranks; with two cards `--dp 2`), whose mesh line must
   read `over N devices (N ranks, backend nccl)`, and `torchrun
   --nproc-per-node N -m lidar_odometry_demo_tpu_torch.parallel.multihost`,
   whose report must show backend nccl and `max_lane_vs_single_dt` 0.

Every step (b-f, i) is the captured step (pipeline/graphs.py): over NCCL
the sp and spatial steps too, their rounds replayed from the host with
one wait each, the round's gathers in its graph (spatial: the halo and
the sums in the scan's two other graphs). Each mode prints its per-rank
ms/scan (CUDA events), collectives and gathers per scan with their host
and device ms (a captured step's collectives are timed by its graphs'
replays, `graph_device_ms`), exchanged bytes, graph launches and waits
on the device per scan (b-e: sp and spatial one wait per round and per
scan two graph launches plus one per round; dp, per step after the
first, one wait and two graph launches), and (b-f) launches per rank
per scan, K2e's and `gn_sum_step`'s among them. Prints a
`kernels` JSON line (each kernel's launches per rank in every mode beside
its times from this call), each card's name and power limit, then as its
last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}, N the
cards used. Exits non-zero without a result when no CUDA device is
present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

import chip_smoke as smoke
from chip_smoke import log

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "multicard")
SPATIAL_FROM_MAIN_M = smoke.SPATIAL_FROM_MAIN_M
REFINE_FROM_ONE_M = 1e-4
CHECKPOINT_AFTER = 20     # the sharded checkpoint is saved after this scan
EXPECT_BACKEND = "nccl"


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()


# --------------------------------------------------------------------------
# a: K2 on two cards in one process
# --------------------------------------------------------------------------

def k2_two_cards() -> dict:
    """K2's fused step and its H-and-b entry point at Q = 8192 on cuda:0,
    then on cuda:1, on the same inputs (numpy, seed 11): bitwise equal
    across the cards. Each card's launch error, if any, is reported before
    the check fails."""
    import torch
    from scipy.spatial.transform import Rotation

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.kernels.jtwj import GnWork, gn_step, jtwj_accumulate
    from lidar_odometry_demo_tpu_torch.ops.se3 import Pose
    from lidar_odometry_demo_tpu_torch.ops.voxel_map import Correspondence

    cfg = OdometryConfig()
    rng = np.random.default_rng(11)
    Q = 8192
    sl = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    pn = rng.normal(0, 1, (Q, 3)).astype(np.float32)
    pn /= np.linalg.norm(pn, axis=-1, keepdims=True)
    rot = Rotation.from_euler("xyz", [0.02, -0.01, 0.3])
    t = np.array([1.5, -0.2, 0.1], np.float32)
    po = (sl @ rot.as_matrix().T.astype(np.float32) + t
          + rng.normal(0, 0.03, sl.shape)).astype(np.float32)
    q = rot.as_quat()[[3, 0, 1, 2]].astype(np.float32)
    valid = rng.random(Q) < 0.8

    per_card = {}
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        corr = Correspondence(up(sl), up(po), up(pn), up(valid))
        pose = Pose(up(t), up(q))
        guess_t = pose.t + 0.05
        try:
            new, norm, H, b = gn_step(corr, pose, guess_t, cfg, work=GnWork.empty(1, dev))
            H2, b2 = jtwj_accumulate(corr, pose, huber_delta=cfg.icp_huber_delta,
                                     work=GnWork.empty(1, dev))
            torch.cuda.synchronize(dev)
            with torch.cuda.device(dev):
                work = GnWork.empty(1, dev)
                ms = smoke.time_ms(lambda: gn_step(corr, pose, guess_t, cfg, work=work), 200)
            per_card[str(dev)] = dict(ok=True, ms=ms, out=[x.cpu().numpy() for x in (
                new.t, new.q, norm, H, b, H2, b2)])
        except RuntimeError as e:  # a refused launch raises in _build.launch
            per_card[str(dev)] = dict(ok=False, error=str(e).splitlines()[0])
    a, b = per_card["cuda:0"], per_card["cuda:1"]
    equal = a["ok"] and b["ok"] and all(np.array_equal(x, y) for x, y in zip(a["out"], b["out"]))
    for name, r in per_card.items():
        log(f"a. K2 on {name} ({torch.cuda.get_device_name(torch.device(name))}): "
            + (f"fused step and jtwj_accumulate launched, {r['ms']:.4f} ms per step"
               if r["ok"] else f"launch failed: {r['error']}"))
    log(f"a. K2 on cuda:0, then cuda:1 in one process: bitwise equal {equal}")
    if not equal:
        raise AssertionError(f"a. K2 on two cards in one process: "
                             f"{ {k: r.get('error') for k, r in per_card.items()} }")
    return dict(equal=equal, ms={k: r["ms"] for k, r in per_card.items()})


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _load_scans(path: str, dev):
    import torch

    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan

    data = torch.load(path, weights_only=False)
    return [LidarScan(*(x[i].to(dev) for x in data)) for i in range(data.xyz.shape[0])]


def _rank_head(mesh) -> dict:
    import torch.distributed as dist

    if mesh.backend != EXPECT_BACKEND or dist.get_backend() != EXPECT_BACKEND:
        raise AssertionError(f"rank {mesh.rank}: backend {mesh.backend}, not {EXPECT_BACKEND}")
    return dict(rank=mesh.rank, device=str(mesh.device), backend=mesh.backend,
                affinity=len(os.sched_getaffinity(0)))


def _sp_drive(cfg, mesh, scans, counted, sync_ranks) -> dict:
    from lidar_odometry_demo_tpu_torch.pipeline import odometry
    from lidar_odometry_demo_tpu_torch.pipeline.graphs import CapturedStep

    step = CapturedStep(cfg, sp_group=mesh.sp)
    r = smoke._sharded_drive(step, odometry.init_state(cfg, mesh.device), scans, mesh, counted,
                             sync_ranks)
    r.pop("state")
    r["device"] = str(mesh.device)
    return r


class GatherCheckedGroup:
    """An sp group (parallel/mesh.py Group) whose every gather is checked:
    the parts it returns must equal bitwise (as int32 bits) the operands
    all-gathered again from every rank (`dist.all_gather`, a list of
    tensors): each rank's part arrives as it was sent, in rank order.
    `calls`, `unequal`: the gathers and those that differed."""

    def __init__(self, group):
        self.group, self.size, self.rank = group, group.size, group.rank
        self.calls, self.unequal = 0, 0

    def gather_parts(self, x, kind: str = "gather"):
        import torch
        import torch.distributed as dist

        parts = self.group.gather_parts(x, kind)
        again = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(again, x.contiguous(), group=self.group.pg)
        self.calls += 1
        self.unequal += int(not torch.equal(parts.view(torch.int32),
                                            torch.stack(again).view(torch.int32)))
        return parts


def checked_sums(cfg, mesh, scans) -> dict:
    """One more pass of `scans` on the sp path with every gather checked
    (GatherCheckedGroup) and every step K2 takes on the gathered parts
    (`gn_sum_step`, K2e) held bitwise, pose and step norm, to K2e on the
    rank-order sum of those parts by torch (`sum_in_rank_order`) at the
    same input pose. Returns the gathers and steps checked and how many
    differed."""
    import torch

    from lidar_odometry_demo_tpu_torch.kernels.jtwj import GnWork, sum_in_rank_order
    from lidar_odometry_demo_tpu_torch.ops import icp
    from lidar_odometry_demo_tpu_torch.pipeline import odometry

    group = GatherCheckedGroup(mesh.sp)
    seen = {"steps": 0, "steps_unequal": 0}
    entry_points = {name: getattr(icp, name) for name in ("gn_sum_step", "gn_epilogue")}
    epilogue = entry_points["gn_epilogue"]

    def checked(fn):
        def call(parts, *args, **kwargs):
            pose, guess_t, step_cfg = args[-3:]
            launches = epilogue.launches  # the check's launch is not the path's
            want = epilogue(sum_in_rank_order(parts)[None], pose, guess_t, step_cfg,
                            work=GnWork.empty(1, parts.device, tuple(parts.shape[1:-1])),
                            step_norm=kwargs.get("step_norm"), active=kwargs.get("active"))
            epilogue.launches = launches
            got = fn(parts, *args, **kwargs)
            seen["steps"] += 1
            seen["steps_unequal"] += int(not all(
                torch.equal(x, y) for x, y in zip((got[0].t, got[0].q, got[1]),
                                                  (want[0].t, want[0].q, want[1]))))
            return got
        return call

    try:
        for name, fn in entry_points.items():
            setattr(icp, name, checked(fn))
        step = odometry.make_process_scan(cfg, sp_group=group)
        state = odometry.init_state(cfg, mesh.device)
        for scan in scans:
            state, _ = step(state, scan)
    finally:
        for name, fn in entry_points.items():
            setattr(icp, name, fn)
    return dict(calls=group.calls, unequal=group.unequal, **seen)


def sp_pair_rank(inputs: str, cfg) -> dict:
    """Mode c on one of two ranks: sp = 2 on the bench drive."""
    import torch.distributed as dist

    from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(1, 2)
    out = _rank_head(mesh)
    scans = _load_scans(os.path.join(inputs, "bench.pt"), mesh.device)
    out["c"] = _sp_drive(cfg, mesh, scans, smoke.sharded_counters(), dist.barrier)
    return out


def card_rank(inputs: str, cfg) -> dict:
    """Modes b, d-h on one rank of a world of N (one card each; f only at
    N = 4). Every rank builds every mesh in one order (each sp group is
    created collectively). Returns numpy results for the parent's checks."""
    import torch
    import torch.distributed as dist

    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
    from lidar_odometry_demo_tpu_torch.parallel import batched, spatial
    from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib
    from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg
    from lidar_odometry_demo_tpu_torch.pipeline import odometry
    from lidar_odometry_demo_tpu_torch.utils import checkpoint

    n = dist.get_world_size()
    dp_mesh = mesh_lib.make_mesh(n, 1)
    sp_mesh = mesh_lib.make_mesh(1, n)
    grid = mesh_lib.make_mesh(2, n // 2) if n == 4 else None
    out = _rank_head(dp_mesh)
    dev = dp_mesh.device
    counted = smoke.sharded_counters()
    bench = _load_scans(os.path.join(inputs, "bench.pt"), dev)
    fleet = _load_scans(os.path.join(inputs, "fleet.pt"), dev)  # (S, 8, ...) per scan

    def dp_fleet():  # b: phase 7's 8 lanes on this card
        step = batched.make_batched_step(cfg, dp_mesh)
        r = smoke._sharded_drive(step, batched.init_batched_state(cfg, fleet[0].xyz.shape[0],
                                                                  dev),
                                 fleet, dp_mesh, counted, dist.barrier)
        r.pop("state")
        r.update(lanes=(0, fleet[0].xyz.shape[0]), device=str(dev), affinity=out["affinity"])
        out["b"] = r

    def sp_modes():  # d: sp = N, then dp = 2 x sp = N / 2
        out["d_sp"] = _sp_drive(cfg, sp_mesh, bench, counted, dist.barrier)
        out["d_sp"]["sums"] = checked_sums(cfg, sp_mesh, bench)
        if grid is not None:
            out["d_grid"] = _sp_drive(cfg, grid, bench, counted, dist.barrier)

    def spatial_mode():  # e, and h on its step
        step = spatial.make_spatial_step(cfg, sp_mesh)
        r = smoke._sharded_drive(step, spatial.init_spatial_state(cfg, n, dev), bench, sp_mesh,
                                 counted, dist.barrier)
        shard = r.pop("state").keyframe
        queries = torch.load(os.path.join(inputs, "queries.pt"), weights_only=False)
        r.update(smoke.halo_view_fields(shard, sp_mesh, queries, cfg), device=str(dev))
        out["e"] = r
        # h: save after scan 20, load into a fresh state, run 21-39
        state = spatial.init_spatial_state(cfg, n, dev)
        for scan in bench[:CHECKPOINT_AFTER + 1]:
            state, _ = step(state, scan)
        path = os.path.join(inputs, "checkpoint")
        checkpoint.save_sharded(path, state, sp_mesh)
        state = checkpoint.load_sharded(path, spatial.init_spatial_state(cfg, n, dev), sp_mesh)
        diags = []
        for scan in bench[CHECKPOINT_AFTER + 1:]:
            state, d = step(state, scan)
            diags.append(d)
        d = odometry.stack_diagnostics(diags)
        tail = slice(CHECKPOINT_AFTER + 1, None)
        same = {"t": torch.equal(d.pose.t, r["t"][tail]),
                "q": torch.equal(d.pose.q, r["q"][tail]),
                "iters": torch.equal(d.icp_iterations, r["iters"][tail])}
        same.update({f: torch.equal(getattr(state.keyframe, f), getattr(shard, f))
                     for f in ("keys", "count", "tab", "origin")})
        out["h"] = dict(same=same, files=sorted(os.listdir(path)))

    def spatial_fleet():  # f: lanes 0-3 of phase 7, each map over sp = 2
        lanes = 4
        scans_b = LidarScan(*(torch.stack([getattr(s, f)[:lanes] for s in fleet])
                              for f in LidarScan._fields))
        run = spatial.make_batched_spatial_sequence_runner(cfg, grid)

        def init():
            return spatial.init_batched_spatial_state(cfg, lanes // grid.dp, grid.sp_size, dev)

        run(init(), scans_b)
        torch.cuda.synchronize()
        dist.barrier()
        grid.stats.reset(device_timing=True)
        smoke.zero_counts(counted)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, d = run(init(), scans_b)
        end.record()
        end.synchronize()
        mine = grid.lanes(lanes)
        out["f"] = dict(t=d.pose.t, lanes=(mine.start, mine.stop), stats=grid.stats.as_dict(),
                        ms_per_scan=start.elapsed_time(end) / len(bench),
                        launches=smoke.read_counts(counted))

    def refines():  # g
        _, _, est_t, est_q, closure = smoke.make_noisy_loop(32, 0.03)
        g = pg.chain_from_odometry(est_t, est_q, closures=[(31, 0, closure(31, 0), 1.0)],
                                   device=dev)
        g = pg.pad_edges(g, n)
        out["g"] = {}
        for solver in ("direct", "schur"):
            run = pg.make_refine_sharded(dp_mesh, "dp", iterations=10,
                                         use_schur=solver == "schur")
            run(g)
            torch.cuda.synchronize()
            dp_mesh.stats.reset(device_timing=True)
            t0 = time.perf_counter()
            refined = run(g)
            t, q = refined.poses.t.cpu(), refined.poses.q.cpu()
            out["g"][solver] = dict(t=t, q=q, ms=(time.perf_counter() - t0) * 1e3,
                                    stats=dp_mesh.stats.as_dict())
        out["segment"] = smoke.sharded_segment_refine(dp_mesh.axis("dp"), dev)

    # a mode that raises on every rank alike is reported, and the next runs
    out["errors"] = {}
    for name, fn in (("b", dp_fleet), ("d", sp_modes), ("e", spatial_mode),
                     ("f", spatial_fleet), ("g", refines)):
        if name == "f" and grid is None:
            continue
        try:
            fn()
        except Exception:
            out["errors"][name] = traceback.format_exc()
    return out


# --------------------------------------------------------------------------
# this process: references and checks
# --------------------------------------------------------------------------

def check_sp4_sums(rs: list) -> dict:
    """d at sp > 2: every rank's checked pass (checked_sums) made as many
    gathers and K2 steps as the others, every gather returned the operands
    of every rank bitwise, and every step K2 took on them was bitwise K2e on
    the rank-order sum of the parts the rank gathered."""
    sums = [r["sums"] for r in rs]
    log(f"d. sp = {len(rs)}: a second pass, every gather checked against the operands "
        f"all-gathered again ({[s['calls'] for s in sums]} per rank, "
        f"{sum(s['unequal'] for s in sums)} differed) and every step K2 took on the parts "
        f"against K2e on their rank-order sum ({[s['steps'] for s in sums]} per rank, "
        f"{sum(s['steps_unequal'] for s in sums)} differed)")
    if (len({(s["calls"], s["steps"]) for s in sums}) != 1 or sums[0]["calls"] == 0
            or sums[0]["steps"] == 0):
        raise AssertionError(f"d. the ranks' checked passes made {[s['calls'] for s in sums]} "
                             f"gathers and {[s['steps'] for s in sums]} steps")
    if any(s["unequal"] or s["steps_unequal"] for s in sums):
        raise AssertionError(f"d. a gather or a step differs from its rank-order check: {sums}")
    return dict(calls=sums[0]["calls"], steps=sums[0]["steps"])


def check_dp_scaling(rs: list, fleet: dict, n: int) -> dict:
    """b: every lane bitwise phase 7's (chip_smoke.check_dp_ranks); the
    aggregate scans/s of the slowest rank's step against n times phase 7's
    one-card rate in this call (the scaling efficiency), with each rank's
    host and process CPU ms per step beside its CUDA-event ms."""
    out = smoke.check_dp_ranks(f"b. dp = {n}", rs, fleet)
    lanes = rs[0]["lanes"][1] - rs[0]["lanes"][0]
    slowest = max(r["ms_per_scan"] for r in rs)
    aggregate = n * lanes * 1e3 / slowest
    one_card = fleet["scans_per_sec"]
    eff = aggregate / (n * one_card)
    log(f"b. dp = {n}: per-rank ms per step of {lanes}, CUDA events / host clock / process "
        f"CPU: {[(round(r['ms_per_scan'], 3), round(r['host_ms_per_scan'], 3), round(r['cpu_ms_per_scan'], 3)) for r in rs]} "
        f"(phase 7 on one card {fleet['ms_per_step']:.3f}); aggregate {aggregate:.2f} scans/s "
        f"over {n * lanes} lanes = {eff:.4f} of {n} x one card's {one_card:.2f} (scaling "
        f"efficiency; BASELINE asks >= 0.8); host cores {os.cpu_count()}, ranks' CPU affinity "
        f"{[r['affinity'] for r in rs]} cores")
    return out | dict(aggregate_scans_per_sec=aggregate, one_card_scans_per_sec=one_card,
                      scaling_efficiency=eff)


def check_refines(rs: list, ref: dict) -> dict:

    out = {}
    for solver in ("direct", "schur"):
        gs = [r["g"][solver] for r in rs]
        d_ranks = max(float(np.abs(g["t"] - gs[0]["t"]).max()) for g in gs)
        d_ref = float(np.abs(gs[0]["t"] - ref[solver]["t"]).max())
        rms = [ref["rms_before"], float(np.sqrt(np.mean(np.sum(
            (gs[0]["t"] - ref["gt_t"]) ** 2, -1))))]
        st = gs[0]["stats"]
        log(f"g. refine {solver} (32 poses, {len(rs)} ranks): {d_ref:.3g} m from the one-process "
            f"refine (bar {REFINE_FROM_ONE_M}), ranks {d_ranks:.3g} apart; RMS vs ground truth "
            f"{rms[0]:.4f} -> {rms[1]:.4f} m; {[round(g['ms'], 1) for g in gs]} ms per 10 "
            f"iterations (one process {ref[solver]['ms']:.1f}); {st['collectives']} all-reduces, "
            f"device {st['collective_device_ms']:.3f} ms, host {st['collective_host_ms']:.3f} ms")
        if d_ranks != 0.0 or d_ref > REFINE_FROM_ONE_M:
            raise AssertionError(f"g. refine {solver}: {d_ref} m from the one-process refine or "
                                 f"ranks {d_ranks} apart")
        out[solver] = dict(from_one_process_m=d_ref, ms=[g["ms"] for g in gs], rms=rms)
    out["segment"] = smoke.check_segment_ranks("g. refine", rs, ref["segment"])
    return out


def check_checkpoint(hs: list, n: int) -> dict:
    log(f"h. sharded checkpoint over {EXPECT_BACKEND} (spatial N = {n}, saved after scan "
        f"{CHECKPOINT_AFTER}, {len(hs[0]['files'])} files): resumed run equal to the "
        f"uninterrupted one per rank {[h['same'] for h in hs]}")
    if not all(all(h["same"].values()) for h in hs):
        raise AssertionError("h. the resumed run differs from the uninterrupted one")
    return hs[0]["same"]


def check_spatial_fleet(fs: list, fleet: dict) -> dict:
    fd = fleet["diags"].pose.t.cpu().numpy()
    n_scans = fd.shape[0]
    worst = 0.0
    for i, f in enumerate(fs):
        lo, hi = f["lanes"]
        worst = max(worst, float(np.abs(f["t"] - fd[:, lo:hi]).max()))
        st = f["stats"]
        launches = " / ".join(f"{k} {v / n_scans:.2f}" for k, v in f["launches"].items())
        log(f"f. dp = 2 x spatial N = 2, rank {i}: lanes {lo}-{hi - 1}, {f['ms_per_scan']:.3f} "
            f"ms per step of {hi - lo} (CUDA events); collectives "
            f"{st['collectives'] / n_scans:.2f}/step (gathers {st['gathers'] / n_scans:.2f}), "
            f"device {st['collective_device_ms'] / n_scans:.4f} ms (captured graphs holding "
            f"them {st.get('graph_device_ms', 0.0) / n_scans:.4f} ms); halo "
            f"{st['exchanged_bytes'] / n_scans / 1e6:.3f} MB/step, device "
            f"{st['exchange_device_ms'] / n_scans:.4f} ms, host "
            f"{st['exchange_host_ms'] / n_scans:.4f} ms; launches per step {launches}")
    log(f"f. every lane within {worst:.3g} m of its phase-7 lane (bar {SPATIAL_FROM_MAIN_M})")
    if worst > SPATIAL_FROM_MAIN_M:
        raise AssertionError(f"f. a lane is {worst} m from its phase-7 lane")
    return dict(from_phase7_m=worst, ms=[f["ms_per_scan"] for f in fs],
                launches=fs[0]["launches"])


def references(bench: dict, device) -> dict:
    """Phases 2-4 and 7 of chip_smoke.py on cuda:0, the sp witnesses at
    two and four ranks and the one-process refines on the card: what the
    modes are held to."""
    import torch

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig
    from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg

    cfg = OdometryConfig()
    rng = np.random.default_rng(1234)
    kernels = [smoke.check_match_rows(rng, device), smoke.check_jtwj(rng, device)]
    odo, launches, diags, ms = smoke.run_main_path(bench, device)
    lookups = smoke.path_lookups(odo, bench["scans"][-1])
    kernels.append(smoke.check_search(device, lookups))
    kernels += list(smoke.check_gathered_step(np.random.default_rng(7), device))
    ref = smoke.path_reference(bench, diags, odo) | dict(
        kernels=kernels, main_ms=ms, main_launches=launches,
        queries=[x.cpu() for x in lookups["neighbourhood"][0][0][3:7]],
        fleet=smoke.run_fleet(bench, diags, odo, ms, device))
    ref["witness"] = {}
    for n in (2, 4):
        t0 = time.perf_counter()
        w = ref["witness"][n] = smoke.sp_witness(cfg, bench["scans"], device, n)
        log(f"references: the sp witness at n = {n}, the parts gathered and added in rank order "
            f"(threads of this process), in {time.perf_counter() - t0:.1f} s: "
            f"{float(np.abs(w['t'] - ref['t']).max()):.3g} m from phase 3, matches off by at "
            f"most {int(np.abs(w['matches'] - ref['matches']).max())}")
    gt_t, _, est_t, est_q, closure = smoke.make_noisy_loop(32, 0.03)
    g = pg.chain_from_odometry(est_t, est_q, closures=[(31, 0, closure(31, 0), 1.0)],
                               device=device)
    ref["refine"] = dict(gt_t=gt_t, rms_before=float(np.sqrt(np.mean(np.sum(
        (est_t - gt_t) ** 2, -1)))), segment=smoke.segment_reference(device))
    for solver in ("direct", "schur"):
        pg.refine(g, iterations=10, use_schur=solver == "schur")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = pg.refine(g, iterations=10, use_schur=solver == "schur").poses.t.cpu().numpy()
        ref["refine"][solver] = dict(t=t, ms=(time.perf_counter() - t0) * 1e3)
    return ref


def run_cli(n: int) -> dict:
    """Mode i: the CLI's fleet over spawned ranks, and the multihost demo
    under torchrun, one rank per card."""
    os.makedirs(OUT_DIR, exist_ok=True)
    dp, sp = (2, 2) if n == 4 else (n, 1)
    cmd = [sys.executable, "-m", "lidar_odometry_demo_tpu_torch.cli", "fleet", "--batch", "8",
           "--scans", "40", "--dp", str(dp), "--sp", str(sp), "--out-prefix",
           os.path.join(OUT_DIR, "fleet_")]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    fleet_s = time.perf_counter() - t0
    want = f"over {n} devices ({n} ranks, backend {EXPECT_BACKEND})"
    mesh_line = next((x for x in p.stderr.splitlines() if x.startswith("mesh:")), "")
    fleet_line = next((x for x in p.stderr.splitlines() if x.startswith("fleet:")), "")
    ates = [float(x.split("ATE")[1].split()[0]) for x in p.stdout.splitlines() if "ATE" in x]
    log(f"i. cli fleet --batch 8 --scans 40 --dp {dp} --sp {sp}: rc {p.returncode} in "
        f"{fleet_s:.1f} s; {mesh_line}; {fleet_line}; lane ATEs {ates}")
    if p.returncode != 0 or want not in mesh_line or len(ates) != 8 or max(ates) > 0.03:
        raise AssertionError(f"i. cli fleet: rc {p.returncode}, mesh line {mesh_line!r} (want "
                             f"{want!r}), ATEs {ates}\n{p.stderr[-4000:]}")
    report_path = os.path.join(OUT_DIR, "multihost.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "-m", "lidar_odometry_demo_tpu_torch.parallel.multihost",
           "--out", report_path]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    log(f"i. torchrun --nproc-per-node {n} -m lidar_odometry_demo_tpu_torch.parallel.multihost: "
        f"rc {p.returncode} in {time.perf_counter() - t0:.1f} s")
    if p.returncode != 0 or not os.path.exists(report_path):
        raise AssertionError(f"i. torchrun multihost: rc {p.returncode}\n{p.stderr[-4000:]}")
    with open(report_path) as f:
        rep = json.load(f)
    sc = rep["scaling"]
    log(f"i. multihost report: backend {rep['backend']}, {sc['devices']} ranks on "
        f"{rep['device']}, max_lane_vs_single_dt {rep['max_lane_vs_single_dt']}, scans/s "
        f"{sc['scans_per_sec']:.2f} vs one rank's {sc['single_device_scans_per_sec']:.2f}, "
        f"scaling_efficiency {sc['scaling_efficiency']:.4f} (host cores "
        f"{rep['host_cpu_count']}, width {rep['scan_width']}, {rep['n_scans']} scans)")
    if rep["backend"] != EXPECT_BACKEND or rep["max_lane_vs_single_dt"] != 0.0:
        raise AssertionError(f"i. multihost: backend {rep['backend']}, lanes "
                             f"{rep['max_lane_vs_single_dt']} m from the single run")
    return dict(fleet_seconds=fleet_s, fleet_line=fleet_line, mesh_line=mesh_line,
                multihost=rep)


def write_inputs(tmp: str, bench: dict, ref: dict) -> None:
    import torch

    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan

    torch.save(LidarScan(*(torch.stack([getattr(s, f) for s in bench["scans"]]).cpu()
                           for f in LidarScan._fields)), os.path.join(tmp, "bench.pt"))
    torch.save(LidarScan(*(x.cpu() for x in ref["fleet"]["scans"])),
               os.path.join(tmp, "fleet.pt"))
    torch.save(ref["queries"], os.path.join(tmp, "queries.pt"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("multicard_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        raise RuntimeError(f"multicard_smoke: one rank per card needs at least two cards, "
                           f"found {n_cards}")
    from lidar_odometry_demo_tpu_torch.kernels import _build
    from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib

    n = 4 if n_cards >= 4 else 2
    cards = card_lines()
    nccl = torch.cuda.nccl.version()
    log(f"cards: {cards}; using {n}; torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
        f"{'.'.join(map(str, nccl)) if isinstance(nccl, tuple) else nccl}; host cores "
        f"{os.cpu_count()}, this process's affinity {len(os.sched_getaffinity(0))}")
    _build.build_all()
    log(f"kernels built in {_build.build_seconds:.1f} s (before any rank starts)")
    results, failures = {}, {}

    def attempt(name: str, fn, *fn_args):
        """Run one mode's check; a failure is printed and kept, and the
        next mode runs."""
        try:
            results[name] = fn(*fn_args)
        except Exception:
            failures[name] = traceback.format_exc()
            log(f"{name}: FAILED\n{failures[name]}")

    attempt("a", k2_two_cards)

    from lidar_odometry_demo_tpu_torch.config import OdometryConfig

    device = torch.device("cuda", 0)
    bench = smoke.bench_drive(device)
    ref = references(bench, device)
    cfg = OdometryConfig()
    tmp = tempfile.mkdtemp(prefix="multicard_")
    try:
        write_inputs(tmp, bench, ref)
        t0 = time.perf_counter()
        pair = mesh_lib.run_ranks(sp_pair_rank, 2, tmp, cfg, device="cuda", timeout=300)
        log(f"c. two ranks spawned, ran and joined in {time.perf_counter() - t0:.1f} s")
        attempt("c", smoke.check_sp_ranks, "c. sp = 2 on two cards", [r["c"] for r in pair],
                ref, ref["witness"][2])
        t0 = time.perf_counter()
        ranks = mesh_lib.run_ranks(card_rank, n, tmp, cfg, device="cuda", timeout=900)
        log(f"{n} ranks spawned, ran b and d-h and joined in {time.perf_counter() - t0:.1f} s; "
            f"devices {[r['device'] for r in ranks]}, backends "
            f"{[r['backend'] for r in ranks]}")
        rank_errors = ranks[0]["errors"]
        for mode, err in rank_errors.items():
            failures[mode] = err
            log(f"{mode}: FAILED on the ranks\n{err}")
        sp_n = [r.get("d_sp") for r in ranks]
        checks = {"b": (lambda: check_dp_scaling([r["b"] for r in ranks], ref["fleet"], n)),
                  "d_sp": (lambda: smoke.check_sp_ranks(f"d. sp = {n}", sp_n, ref,
                                                        ref["witness"][n])),
                  "d_sums": (lambda: check_sp4_sums(sp_n)),
                  "d_grid": (lambda: smoke.check_sp_ranks(
                      "d. dp = 2 x sp = 2", [r["d_grid"] for r in ranks], ref,
                      ref["witness"][2])),
                  "e": (lambda: smoke.check_spatial_ranks(
                      f"e. spatial N = {n}", [r["e"] for r in ranks], ref,
                      ref["queries"][1].numpy())),
                  "h": (lambda: check_checkpoint([r["h"] for r in ranks], n)),
                  "f": (lambda: check_spatial_fleet([r["f"] for r in ranks], ref["fleet"])),
                  "g": (lambda: check_refines(ranks, ref["refine"]))}
        for name, fn in checks.items():
            mode = name[0]
            skip = mode in rank_errors or (mode == "h" and "e" in rank_errors)
            if not skip and (name not in ("d_grid", "f") or n == 4):
                attempt(name, fn)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    attempt("i", run_cli, n)

    kernels = ref["kernels"]
    for k in kernels:
        k["launches_main"] = ref["main_launches"].get(k["name"], 0)
        for mode in ("b", "c", "d_sp", "d_grid", "e", "f"):
            if mode in results and "launches" in results[mode]:
                k[f"launches_multicard_{mode}"] = results[mode]["launches"][k["name"]]
        k["launches"] = k.get("launches_multicard_e", k["launches_main"])
    print(json.dumps({"kernels": kernels, "cards": cards, "results": results}, default=str))
    for line in cards:
        print(line)
    if failures:
        raise AssertionError(f"multicard_smoke: modes {sorted(failures)} failed (above)")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
