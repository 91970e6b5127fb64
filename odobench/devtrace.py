"""The device trace of a traced run: torch.profiler (CUPTI) over a fixed
span of scans between the harness's own markers, reduced to what the
per-layer readers take.

The span is marked by a `record_function` range named `WINDOW` on the host;
device operations (kernels, copies, sets) are placed on the same clock by
the profiler's chrome-trace export. Busy time is the union of the device
operations' intervals inside the span, so operations that overlap count
once; the idle share is 1 - busy / span.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import NamedTuple

WINDOW = "odobench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def start_cupti() -> None:
    """One empty profiler session before any CUDA graph is built: the
    kernels in the body of a conditional WHILE node of a graph instantiated
    before CUPTI's first session are not traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


class TraceSummary(NamedTuple):
    """One process's traced span: its length and the device's busy
    seconds in it, device operations, per-kernel launches and seconds
    (names matched by substring), the top operations and the longest idle
    gaps, each gap named by the host marker and call in progress."""

    window_s: float
    busy_s: float
    device_ops: int
    kernels: dict          # substring -> (launches, seconds)
    top_ops: list          # [[name, seconds]]
    idle_gaps: list        # [[name, seconds]]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def union_length(intervals: list[tuple[float, float]], lo: float, hi: float):
    """(total length of the union of [a, b) clipped to [lo, hi], the gaps
    between the merged intervals as (start, end))."""
    merged: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps, cur = [], lo
    for a, b in merged:
        if a > cur:
            gaps.append((cur, a))
        cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return sum(b - a for a, b in merged), gaps


def summarize(events: list[dict], kernel_names: tuple = ()) -> TraceSummary:
    """Reduce chrome-trace events (ts and dur in microseconds) to the span
    of the first `WINDOW` marker."""
    marks = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW} marker")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
           and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    busy, gaps = union_length([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev],
                              lo, hi)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    kernels = {}
    for k in kernel_names:
        hits = [e for e in dev if e.get("cat") == "kernel" and k in e["name"]]
        kernels[k] = (len(hits), sum(float(e["dur"]) for e in hits) * 1e-6)
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (a + b)
        inside = [e for e in host if float(e["ts"]) <= mid < float(e["ts"]) + float(e["dur"])]
        marker = max((e for e in inside if e["cat"] == "user_annotation"),
                     key=lambda e: float(e["ts"]), default=None)
        call = max(inside, key=lambda e: float(e["ts"]), default=None)
        name = "/".join(dict.fromkeys(x["name"] for x in (marker, call) if x is not None))
        named.append([name or "(no host call)", (b - a) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, device_ops=len(dev),
                        kernels=kernels, top_ops=[[n, s] for n, s in top], idle_gaps=named)


class Tracer:
    """A profiler session over the harness's span: `start()`, the span
    inside `with tracer.window():`, `stop()`, then `summary()`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()

    def window(self):
        from torch.profiler import record_function

        return record_function(WINDOW)

    def stop(self) -> None:
        self.prof.stop()

    def summary(self, kernel_names: tuple = ()) -> TraceSummary:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return summarize(events, kernel_names)
