"""The port's span recorder: host spans on the host's clock and device spans
from CUDA events, on one clock, recorded only while switched on; and the
CLI's scans/s counter.

The reference's only telemetry is a per-scan wall-clock printf
("processing time: Xms", lidar_odometry.cpp:23,73-75). Here the step's
host code marks its stages (pipeline/odometry.py, pipeline/graphs.py,
parallel/batched.py, device.HostFlags), each place behind one test of the
module flag `ON`: off (the default) a place reads the flag and branches,
and takes no clock reading, records no event, opens no profiler range and
allocates nothing. An operator switches it on around a stretch of scans:

    from lidar_odometry_demo_tpu_torch.utils import profiling

    profiling.enable()           # waits for the device once, anchors the clocks
    ...                          # scans
    spans = profiling.drain()    # what was recorded, cleared (waits for the device)
    profiling.disable()
    print(profiling.summarize(spans))

A host span is a name, its start and end on `time.perf_counter_ns()`, its
id, its parent's id and the id of the scan (or fleet step) it belongs to:
a span named in `SCAN_ROOTS` starts a new scan, and every span until the
next one shares its id. While a torch.profiler session is active, a host
span also opens a `record_function` range of its name, so the profiler's
trace names what the device waited for by the program's innermost span.

A device span is a stage of the device's stream between two CUDA timing
events, recorded on the stream current at `enable()` (the step's) and
outside any graph (an event cannot sit inside a captured graph, so a
graph's replay is the finest stage); a stage that follows another
directly starts at that one's end event. A stage counts as busy from its
start event to its end event: the stages cover every operation the step
enqueues, and count as busy the gaps between a graph's kernels and, in a
stage of launches the host issues one by one (the eager step), the
device's waits for them. Events come from a pool that `enable()` makes
and records once (torch makes a CUDA event at its first record); a span
is read once its end event has completed (checked as each scan's root
span ends, the scan queued, never waited for) or at `drain()`. Its times
are on the host's clock: `enable()` waits for the device, takes the host's
time and records an anchor event, and an event's time is the anchor's
host time plus the device's time since the anchor; the anchor's own
latency (under `Spans.anchor_bracket_ns`, the host time from before its
record to after its completion) is the error.

The recorder serves one thread and the device current at `enable()`. It
keeps at most `CAPACITY` spans of each kind and at most `POOL` events in
flight; what does not fit counts in `Spans.dropped`.
"""

from __future__ import annotations

import time
from time import perf_counter_ns
from typing import NamedTuple

import torch

# the module flag every instrumented place tests
ON = False
# spans that start a scan (a replay scan, a fleet step of every lane)
SCAN_ROOTS = ("odometry.scan", "fleet.step")
# what step.enqueue_ms_per_scan leaves out of a scan's root span
NOT_ENQUEUE = ("step.wait", "step.eager", "step.capture")
# events in flight at most (a scan records 8, and is read a scan later)
POOL = 256
# spans of each kind kept at most: 30 s of replay scans (~11,000 of ~8 host
# and 6 device spans) several times over
CAPACITY = 1 << 18


class HostSpan(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    scan: int


class DeviceSpan(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    scan: int


class Spans(NamedTuple):
    """What `drain()` returns: host and device spans (each in the order
    they ended), the spans that did not fit, and the anchor's bracket."""

    host: list
    device: list
    dropped: int
    anchor_bracket_ns: int


class PendingSpans(list):
    """Device spans in flight on one stream: (key, start event, end event)
    in the order they were recorded, so they complete in that order. The
    recorder's device spans and the collectives' (parallel/mesh.py
    CommStats) are kept and read here."""

    def add(self, key, start, end) -> None:
        self.append((key, start, end))

    def take(self, wait: bool = False) -> list:
        """Remove and return the leading spans whose end event has
        completed; with `wait`, wait for the last one and return all."""
        if wait:
            if self:
                self[-1][2].synchronize()
            n = len(self)
        else:
            n = 0
            while n < len(self) and self[n][2].query():
                n += 1
        done = self[:n]
        del self[:n]
        return done


class Recorder:
    """The spans of one `enable()` (see the module's docstring)."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else (
            torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
            else torch.device("cpu"))
        self.cuda = dev.type == "cuda"
        self.host: list[HostSpan] = []
        self.device: list[DeviceSpan] = []
        self.dropped = 0
        self.stack: list[list] = []     # open host spans: [name, start, id, parent, scan, range]
        self.next_id = 0
        self.scan = -1
        self.pending = PendingSpans()
        self.open = None                # the open device stage: (name, scan, start event)
        self.refs: dict = {}            # event -> spans that still read it
        self.times: dict = {}           # event -> its time, while another span reads it
        self.resumed: list = []         # stages a wait closed, to reopen after it
        self.pool: list = []
        self.anchor_ns = self.anchor_bracket_ns = 0
        if self.cuda:
            self.pool = [torch.cuda.Event(enable_timing=True) for _ in range(POOL)]
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.stream = torch.cuda.current_stream(dev)
            for ev in self.pool:  # torch makes the CUDA event at its first record: now
                ev.record(self.stream)
            torch.cuda.synchronize(dev)
            self.anchor_ns = perf_counter_ns()
            self.anchor.record(self.stream)
            self.anchor.synchronize()
            self.anchor_bracket_ns = perf_counter_ns() - self.anchor_ns

    # ----------------------------------------------------------- host spans

    def begin(self, name: str, dev: str | None) -> None:
        if name in SCAN_ROOTS:
            self.scan += 1
            self.dropped += len(self.stack)  # left open by an exception
            self.stack.clear()
        rng = None
        if torch._C._autograd._profiler_enabled():
            rng = torch.profiler.record_function(name)
            rng.__enter__()
        parent = self.stack[-1][2] if self.stack else None
        self.stack.append([name, perf_counter_ns(), self.next_id, parent, self.scan, rng])
        self.next_id += 1
        if dev is not None:
            self.stage(dev)

    def end(self, dev_end: bool) -> None:
        if dev_end:
            self.stage_end()
        if not self.stack:
            return
        name, start, id_, parent, scan, rng = self.stack.pop()
        t = perf_counter_ns()
        if rng is not None:
            rng.__exit__(None, None, None)
        self._keep(self.host, HostSpan(name, start, t, id_, parent, scan))
        if parent is None and name in SCAN_ROOTS:
            self.poll()  # the scan is queued: the device works while the host reads

    # --------------------------------------------------------- device spans

    def _record(self):
        if not self.pool:
            self.dropped += 1
            return None
        ev = self.pool.pop()
        ev.record(self.stream)
        return ev

    def _close(self, end) -> None:
        name, scan, start = self.open
        self.open = None
        if end is None:
            self._release(start)
        else:
            self.pending.add((name, scan), start, end)

    def stage(self, name: str) -> None:
        """Device stage `name` starts now; an open one ends at its start."""
        if not self.cuda:
            return
        ev = self._record()
        shared = self.open is not None
        if shared:
            self._close(ev)
        if ev is not None:
            self.refs[ev] = 1 + shared
            self.open = (name, self.scan, ev)

    def stage_end(self) -> None:
        if self.open is None:
            return
        ev = self._record()
        if ev is not None:
            self.refs[ev] = 1
        self._close(ev)

    def wait_begin(self) -> None:
        """A host wait on the device: host span `step.wait`; the open stage
        ends before it and resumes after it, so the wait's idle shows."""
        self.resumed.append(None if self.open is None else self.open[0])
        self.stage_end()
        self.begin("step.wait", None)

    def wait_end(self) -> None:
        self.end(False)
        name = self.resumed.pop() if self.resumed else None
        if name is not None:
            self.stage(name)

    def _release(self, ev) -> None:
        self.refs[ev] -= 1
        if self.refs[ev] == 0:
            del self.refs[ev]
            self.times.pop(ev, None)
            self.pool.append(ev)

    def _time(self, ev) -> int:
        t = self.times.get(ev)
        if t is None:
            t = self.times[ev] = self.anchor_ns + round(self.anchor.elapsed_time(ev) * 1e6)
        return t

    def poll(self, wait: bool = False) -> None:
        """Read the device spans whose end has completed (with `wait`, all
        of them, waiting for the last)."""
        for (name, scan), start, end in self.pending.take(wait):
            self._keep(self.device, DeviceSpan(name, self._time(start), self._time(end), scan))
            self._release(start)
            self._release(end)

    def _keep(self, out: list, span) -> None:
        if len(out) < CAPACITY:
            out.append(span)
        else:
            self.dropped += 1

    def drain(self) -> Spans:
        self.poll(wait=True)
        out = Spans(self.host, self.device, self.dropped, self.anchor_bracket_ns)
        self.host, self.device, self.dropped = [], [], 0
        return out


_REC: Recorder | None = None


def enable(device=None) -> None:
    """Switch spans on, with a new recorder: device spans on `device` (the
    current CUDA device by default; none on the CPU)."""
    global ON, _REC
    _REC = Recorder(device)
    ON = True


def disable() -> None:
    """Switch spans off; what was recorded stays for `drain()`."""
    global ON
    ON = False


def drain() -> Spans:
    """Every span recorded since `enable()` or the last drain, cleared;
    waits for the device spans still in flight."""
    if _REC is None:
        return Spans([], [], 0, 0)
    return _REC.drain()


# The instrumented places call these only while ON.

def begin(name: str, dev: str | None = None) -> None:
    """Host span `name` starts; with `dev`, device stage `dev` too."""
    _REC.begin(name, dev)


def end(dev_end: bool = False) -> None:
    """The innermost host span ends; with `dev_end`, the open device stage."""
    _REC.end(dev_end)


def device_end() -> None:
    """The open device stage ends."""
    _REC.stage_end()


def wait_begin() -> None:
    _REC.wait_begin()


def wait_end() -> None:
    _REC.wait_end()


# ----------------------------------------------------------------- readings

def _union_ns(intervals, pieces) -> int:
    """Length of the union of `intervals` (start, end) inside `pieces`
    (disjoint (start, end)): overlapping intervals count once."""
    total, ordered = 0, sorted(intervals)
    for lo, hi in pieces:
        cur = lo
        for a, b in ordered:
            a, b = max(a, cur), min(b, hi)
            if b > a:
                total += b - a
                cur = b
    return total


def summarize(spans: Spans, skip: tuple = ()) -> dict:
    """The step's readings over a stretch: the first scan's start to the
    last span's end, less the `skip` intervals (start, end), such as a
    profiler's. Its scans are those whose root span lies in it whole; per
    scan is per replay scan, or per fleet step of every lane.

    `step.idle_share`: 1 - the union of the device spans inside the
    stretch over its length on the host's clock. `step.enqueue_ms_per_scan`:
    host ms in the scans' root spans less their `NOT_ENQUEUE` spans.
    `step.host_wait_ms_per_scan`, `step.eager_ms_per_scan`: host ms in the
    scans' `step.wait` and `step.eager` spans. Also `scans`, `stretch_s`
    and `device_busy_ms_per_scan`."""
    roots = [s for s in spans.host if s.name in SCAN_ROOTS and s.parent is None]
    lo_ns = min((s.start_ns for s in roots), default=0)
    hi_ns = max((s.end_ns for s in spans.host), default=lo_ns)
    cuts = sorted((max(a, lo_ns), min(b, hi_ns)) for a, b in skip if b > lo_ns and a < hi_ns)
    pieces, cur = [], lo_ns
    for a, b in cuts:
        if a > cur:
            pieces.append((cur, a))
        cur = max(cur, b)
    if hi_ns > cur:
        pieces.append((cur, hi_ns))
    stretch = sum(b - a for a, b in pieces)
    counted = {s.scan: s for s in roots
               if any(a <= s.start_ns and s.end_ns <= b for a, b in pieces)}
    children: dict = {}
    for s in spans.host:
        if s.scan in counted and s.parent is not None:
            children.setdefault(s.parent, []).append(s)

    def left_out(span) -> int:
        """ns of `span`'s outermost NOT_ENQUEUE descendants."""
        return sum(c.end_ns - c.start_ns if c.name in NOT_ENQUEUE else left_out(c)
                   for c in children.get(span.id, ()))

    def host_ms(name) -> float:
        return sum(s.end_ns - s.start_ns for s in spans.host
                   if s.name == name and s.scan in counted) * 1e-6

    busy = _union_ns([(s.start_ns, s.end_ns) for s in spans.device], pieces)
    out = {"step.idle_share": 1.0 - busy / stretch if stretch > 0 else None,
           "scans": len(counted), "stretch_s": stretch * 1e-9}
    per_scan = {
        "step.enqueue_ms_per_scan":
            sum(r.end_ns - r.start_ns - left_out(r) for r in counted.values()) * 1e-6,
        "step.host_wait_ms_per_scan": host_ms("step.wait"),
        "step.eager_ms_per_scan": host_ms("step.eager"),
        "device_busy_ms_per_scan": busy * 1e-6}
    for k, v in per_scan.items():
        out[k] = v / len(counted) if counted else None
    return out


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
