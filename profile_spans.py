"""The span recorder (lidar_odometry_demo_tpu_torch/utils/profiling.py) in the
benchmark's cells, on the card: what spans cost, and what they read.

    python3 profile_spans.py [--phases cost,trace] [--cells vlp16.replay,vlp16.fleet8]

Runs `odobench/`'s cells in this process through its harness, whose files
stay as they are: the harness's end of set-up (`harness.settle`) is wrapped
to switch the recorder on at the window's start, its profiler span
(`devtrace.Tracer`) to note where CUPTI ran, and the runs are read with
`profiling.summarize`. One JSON line per run on standard output (and
appended to `--out`, where given):

- cost: per cell, `--rounds` rounds of windows of `--cost-seconds` with the
  spans off, on, on, off (one seed a round), no profiler and no check
  against the reference: ms per scan and the p95 latency of each, and the
  recorder's readings and ms per span name over each window with spans on;
- trace: per cell, a `--trace 1` run of 30 s with the spans on from the
  window's start: the harness's result (per-layer metrics, `breakdown`,
  whose idle gaps the program's spans now name, and `correct`), its launch
  check's verdict, and the recorder's readings outside the CUPTI span and
  the fleet's trace export, which lies inside its window.

`--cpu-rehearsal` runs the same at TINY on the CPU (host spans only).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "odobench"))

import run as odorun  # noqa: E402  (sets the benchmark's cache paths)
import torch  # noqa: E402

import devtrace  # noqa: E402
import harness  # noqa: E402
from lidar_odometry_demo_tpu_torch.utils import profiling  # noqa: E402

STATE = {"spans": False}


def _wrap(owner, name, before=None, after=None):
    fn = getattr(owner, name)

    def wrapped(*args):
        if before:
            before()
        out = fn(*args)
        if after:
            after(args, out)
        return out
    setattr(owner, name, wrapped)


def _spans_on(args, out):
    if STATE["spans"]:
        profiling.enable(args[0])


def _note(key):
    return lambda: STATE.setdefault(key, []).append(time.perf_counter_ns())


def _note_end(key):
    return lambda args, out: STATE[key].append(time.perf_counter_ns())


def _check_trace(raw, cfg_odo, _check=odorun.check_trace):
    try:
        _check(raw, cfg_odo)
        STATE["check_trace"] = "ok"
    except RuntimeError as e:
        STATE["check_trace"] = str(e)


_wrap(harness, "settle", after=_spans_on)
_wrap(devtrace.Tracer, "start", before=_note("cupti"))
_wrap(devtrace.Tracer, "stop", after=_note_end("cupti"))
_wrap(devtrace.Tracer, "summary", before=_note("summary"), after=_note_end("summary"))
odorun.check_trace = _check_trace


def emit(path, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")


def one(cell, seed, seconds, trace, spans, check, device):
    STATE.update(spans=spans, cupti=[], summary=[], check_trace=None)
    saved = harness.reference_drives, harness.checks.compare_passes
    if not check:
        harness.reference_drives = lambda *a: []
        harness.checks.compare_passes = lambda *a: {}
    try:
        raw = harness.run_cell(cell, seed, seconds, trace, torch.device(device),
                               time.perf_counter())
    finally:
        harness.reference_drives, harness.checks.compare_passes = saved
    rec = dict(cell=cell.name, seed=seed, trace=trace, spans=spans, scans=raw["scans"],
               window_s=raw["window_s"], ms_per_scan=raw["window_s"] * 1e3 / raw["scans"],
               setup_s=raw["setup_s"], waits=raw["counters"].get("host_waits"))
    if raw.get("latencies"):
        rec["p95_ms"] = harness.percentile(raw["latencies"], 95) * 1e3
    if spans:
        got = profiling.drain()
        profiling.disable()
        skip = [tuple(STATE[k]) for k in ("cupti", "summary") if len(STATE[k]) == 2]
        rec["recorder"] = profiling.summarize(got, skip=skip)
        rec["recorder"].update(dropped=got.dropped,
                               anchor_bracket_ms=got.anchor_bracket_ns * 1e-6)
        for kind, spans_of in (("host", got.host), ("device", got.device)):
            ms = {}
            for s in spans_of:
                ms[s.name] = ms.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-6
            rec[f"{kind}_ms_by_span"] = ms
    if trace and check:
        rec["result"] = odorun.result(cell, raw, True, torch.cuda.get_device_name(0))
        rec["check_trace"] = STATE["check_trace"]
        rec["kernels"] = {k: list(v) for k, v in raw["trace"][0].kernels.items()}
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="cost,trace")
    ap.add_argument("--cells", default="vlp16.replay,vlp16.fleet8")
    ap.add_argument("--cost-seconds", type=float, default=15.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2147483901)
    ap.add_argument("--out", help="a file to append the JSON lines to")
    ap.add_argument("--cpu-rehearsal", action="store_true")
    args = ap.parse_args()
    overrides, device = None, "cuda"
    if args.cpu_rehearsal:
        from lidar_odometry_demo_tpu_torch.config import TINY

        overrides = {"odometry": {k: getattr(TINY, k) for k in (
            "scan_width", "max_raw_points", "max_planar_points", "max_match_points",
            "max_update_points", "map_capacity")}, "traffic": {"scans_per_drive": 12}}
        device = "cpu"
    elif not torch.cuda.is_available():
        print("no CUDA device (--cpu-rehearsal runs at TINY on the CPU)", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    card = "cpu" if args.cpu_rehearsal else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    emit(args.out, {"card": card, "torch": torch.__version__})
    seed = args.seed
    for name in args.cells.split(","):
        cell = harness.load_cell(name, overrides=overrides)
        if "cost" in args.phases:
            for _ in range(args.rounds):
                seed += 1
                for spans in (False, True, True, False):
                    emit(args.out, one(cell, seed, args.cost_seconds, False, spans, False, device))
        if "trace" in args.phases and device == "cuda":
            seed += 1
            emit(args.out, one(cell, seed, 30.0, True, True, True, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
