"""The benchmark of the port, `lidar_odometry_demo_tpu_torch`, on NVIDIA
H100s.

    python3 odobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json (see harness.py): set-up (drives made on
the card from the seed, the program warmed up), a measured window of
`--seconds`, then the check of what the window answered against the plain
reference. Prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics from a profiler span of a fixed
count of scans), `device`, with --trace 1 `breakdown`, and last `checks`:
each number compared beside its limit, which also end standard error.
Exits non-zero with no result line when the card or cards the cell asks
for are missing, and when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# a kernel cache the program or torch may keep, at fixed paths in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".odobench_cache" / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_odometry_demo_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a per-layer reader (metrics/<name>.py) may read."""

    def __init__(self, raw: dict, cell, shape: dict | None, load):
        self.trace = raw.get("trace")
        self.traced = raw.get("traced")
        self.counters = raw.get("counters", {})
        self.scans = raw.get("scans")
        self.cell = cell
        self.shape = shape
        self._load = load

    def roofline(self, name: str):
        return self._load(HERE / "roofline" / f"{name}.py")

    def roofline_share(self, name: str):
        """The bound of `roofline/<name>.py` over the mean time of one call,
        in percent; a call launches each of its CUDA functions once, so
        their mean times per launch are summed."""
        import harness
        import peaks

        mod = self.roofline(name)
        if not self.trace or self.shape is None:
            return None
        per_call = 0.0
        for fn in harness.kernel_functions(mod):
            launches, seconds = self.trace[0].kernels.get(fn, (0, 0.0))
            if launches == 0 or seconds <= 0:
                return None
            per_call += seconds / launches
        return 100.0 * peaks.bound_s(*mod.bytes_ops(**self.shape)) / per_call


def kernel_shape(raw: dict, cell) -> dict | None:
    """The traced kernels' shapes: the configuration's sizes (the raw
    scan's N points, R rings and W columns among them), and the
    data-dependent counts (present voxel slices, their candidates, valid
    matches) that the reference found on the same scans of every lane,
    per scan averaged over the traced scans and summed over the lanes."""
    traced, scans = raw.get("traced"), raw.get("traced_scans")
    if not traced or not scans:
        return None
    odo = cell.config["odometry"]
    refs = raw["ref_stats"]
    got = [refs[d]["stats"][s] for d, s in scans if refs[d]["stats"][s] is not None]
    if not got:
        return None
    B = traced["lanes"]
    n = len(got)
    K = odo["keyframe_max_points_cnt"]
    return dict(Q=odo["max_match_points"], B=B, C=odo["map_capacity"],
                RW=-(-(3 * K + 1) // 8) * 8, N=odo["max_raw_points"], R=odo["num_rings"],
                W=odo["scan_width"],
                present=B * sum(g.present_slices for g in got) / n,
                candidates=B * sum(g.candidates for g in got) / n,
                valid=B * sum(g.matches for g in got) / n)


def check_trace(raw: dict, cfg_odo: dict) -> None:
    """The traced span holds every ICP round's K1 and K2 launches (the
    WHILE body's kernels included)."""
    traced = raw.get("traced") or {}
    if traced.get("rounds") is None:
        return
    k1 = raw["trace"][0].kernels["match_kernel"][0]
    k2 = raw["trace"][0].kernels["gn_step_kernel"][0]
    want1, want2 = traced["rounds"], traced["rounds"] * cfg_odo["icp_inner_iterations"]
    print(f"trace: {traced['rounds']} ICP rounds in {traced['scans']} traced scans; "
          f"K1 launches {k1} (want {want1}), K2 launches {k2} (want {want2})", file=sys.stderr)
    if (k1, k2) != (want1, want2):
        raise RuntimeError("the trace misses ICP rounds' kernels")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("--seed must be a whole number >= 0", file=sys.stderr)
        return 2

    import torch

    import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {n} available",
              file=sys.stderr)
        return 2
    raw = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_PROCESS)
    return report(cell, raw, bool(args.trace), torch.cuda.get_device_name(0))


def result(cell, raw: dict, trace: bool, kind: str) -> dict:
    """The result line's object (checks last)."""
    import harness

    numbers = raw["check"]
    limits = cell.limits
    attempted = raw.get("attempted", raw["scans"])
    failed = raw.get("failed", 0)
    correct = harness.checks.verdict(numbers, limits) and failed == 0
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                v = raw["setup_s"]
            elif m["name"] == "scans_per_s":
                v = raw["scans"] / raw["window_s"]
            elif m["name"] == "scan_latency_p95_ms":
                v = harness.percentile(raw["latencies"], 95) * 1e3
            else:
                raise ValueError(f"no reading for the end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        check_trace(raw, cell.config["odometry"])
        ctx = Context(raw, cell, kernel_shape(raw, cell), harness.load_module)
        for m in cell.per_layer:
            v = harness.load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": raw["memory_peak"]}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    summaries = raw.get("trace") or []
    if trace and summaries:
        device["busy_s"] = sum(s.busy_s for s in summaries) / len(summaries)
        device["window_s"] = sum(s.window_s for s in summaries) / len(summaries)
        slowest = max(summaries, key=lambda s: s.busy_s)
        out["breakdown"] = {"device_ops": slowest.top_ops, "idle_gaps": slowest.idle_gaps}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return out


def report(cell, raw: dict, trace: bool, kind: str) -> int:
    out = result(cell, raw, trace, kind)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"compared {raw['check'].get('scans_compared')} answered scans", file=sys.stderr)
    for k, v in raw["check"].items():
        if k not in out["checks"] and k != "scans_compared":
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
