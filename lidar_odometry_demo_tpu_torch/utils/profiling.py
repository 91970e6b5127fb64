"""Tracing / profiling instrumentation (port of the JAX ``utils/profiling.py``).

The reference's only telemetry is a per-scan wall-clock printf
("processing time: Xms", lidar_odometry.cpp:23,73-75). Here: torch.profiler
traces (a Chrome trace of host and device activity), per-stage wall timers
that synchronise the device at their boundaries, and a scans/s counter.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block (host, and the
    card when there is one) into `log_dir`/trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


def _cuda_devices(x, found: set) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, found)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    return found


class StageTimer:
    """Host-side per-stage wall timers with a device synchronisation at the
    boundaries.

    Usage:
        timer = StageTimer()
        with timer.stage("icp", sync=state):
            out = align(...)
        print(timer.summary())

    `sync` is a tensor or a nest of them (a NamedTuple such as a state); on
    exit the timer waits for every CUDA device they lie on, where the JAX
    version blocks until they are ready.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                for dev in _cuda_devices(sync, set()):
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:24s} {1e3 * tot:9.1f} ms total  {1e3 * tot / n:8.2f} ms/call  x{n}")
        return "\n".join(lines)


class ScanRateCounter:
    """Rolling scans/s counter — the BASELINE.json north-star metric."""

    def __init__(self, window: int = 50):
        self.window = window
        self.stamps: list[float] = []

    def tick(self) -> float:
        now = time.perf_counter()
        self.stamps.append(now)
        if len(self.stamps) > self.window:
            self.stamps.pop(0)
        if len(self.stamps) < 2:
            return 0.0
        return (len(self.stamps) - 1) / (self.stamps[-1] - self.stamps[0])
