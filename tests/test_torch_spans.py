"""The span recorder (utils/profiling.py) on CPU tensors, at TINY.

Off, the instrumented places of the step record nothing: no CUDA event, no
profiler range and no clock reading (each stand-in raises). On, over 6
TINY scans through `LidarOdometry` driving a `_LaneGraphs` (two eager
warm-up scans, the capture, then the segments' schedule) and through the
fleet runner, the spans are the step's stages: their names, their nesting,
one scan id per scan, a `step.wait` per `HostFlags.waits`, `step.eager`
exactly on the eager scans, device stages that share their boundary event,
no event made while the scans run, and `drain()` clears. CUDA events are a
host-clock stand-in here (the card test, tests/test_torch_spans_card.py,
has the real ones). Last, `summarize`'s arithmetic on hand-made spans.
"""

import time

import pytest
import torch

from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.device import HostFlags
from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, scan_from_numpy
from lidar_odometry_demo_tpu_torch.parallel import batched
from lidar_odometry_demo_tpu_torch.pipeline import graphs
from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry
from lidar_odometry_demo_tpu_torch.utils import profiling
from lidar_odometry_demo_tpu_torch.utils.profiling import DeviceSpan, HostSpan, Spans

N_SCANS = 6
HOST_SPANS = {"odometry.scan", "odometry.pose_read", "step.copy_in", "step.eager", "step.wait",
              "step.capture", "step.replay_a", "step.launch_loop", "step.clone_diag"}
DEVICE_SPANS = {"dev.copy_in", "dev.eager", "dev.a", "dev.loop", "dev.clone_diag",
                "dev.pose_read"}


class FakeEvent:
    """A CUDA timing event's stand-in: its time is the host's at `record`,
    and it has completed at once."""

    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e-6


@pytest.fixture(scope="module")
def scans():
    d = simulate_sequence(num_scans=N_SCANS, width=TINY.scan_width, seed=3, speed=2.0,
                          yaw_rate=0.05, ramp_time=0.0)
    return [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                            TINY.max_raw_points, "cpu") for s in d.scans]


class FlagEvent:
    """HostFlags' event on the CPU: done at once."""

    def record(self):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def flags_wait(monkeypatch):
    """HostFlags on the CPU with a stand-in event, so every read is a wait
    as on the card."""
    init = HostFlags.__init__

    def with_event(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.event = FlagEvent()

    monkeypatch.setattr(HostFlags, "__init__", with_event)


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA events and the device's synchronisation as host stand-ins."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)


@pytest.fixture
def recorder():
    """The recorder off and empty before and after the test."""
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _lane_graphs_odometry(scans):
    """A LidarOdometry on the CPU whose step is a `_LaneGraphs` (the
    captured step's schedule, its segments called), its flags made."""
    lo = LidarOdometry(TINY, device="cpu")
    lg = graphs._LaneGraphs(lo._step.eager, lo._state, scans[0])
    lo._step = lg
    lg.step.init_flags((), torch.device("cpu"))
    return lo, lg


def _fleet_scans(scans):
    per = [scans[:3], scans[3:]]
    return LidarScan(*(torch.stack([torch.stack([getattr(p[i], f) for p in per])
                                    for i in range(3)]) for f in LidarScan._fields))


def test_off_records_nothing(recorder, scans, flags_wait, monkeypatch):
    """With spans off, scans through LidarOdometry (the eager step on the
    CPU), a `_LaneGraphs` and the fleet runner, under a profiler session,
    make no CUDA event, open no record_function and read no clock in the
    recorder, and leave nothing to drain."""
    lo, lg = _lane_graphs_odometry(scans)
    plain = LidarOdometry(TINY, device="cpu")
    run = batched.make_batched_sequence_runner(TINY)
    fleet = _fleet_scans(scans)

    def refuse(*args, **kwargs):
        raise AssertionError("called with spans off")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.cuda, "Event", refuse)
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        monkeypatch.setattr(profiling, "perf_counter_ns", refuse)
        for scan in scans:
            for odo in (lo, plain):
                odo.process_scan(scan)
                odo.get_current_pose()
        run(batched.init_batched_state(TINY, 2, "cpu"), fleet)
    assert lg.segments is not None  # the segments ran
    assert profiling.drain() == Spans([], [], 0, 0)


def _parents_nest(spans):
    by_id = {s.id: s for s in spans.host}
    for s in spans.host:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns and p.scan == s.scan


def test_on_records_the_steps_spans(recorder, scans, flags_wait, fake_cuda):
    """On over 6 TINY scans through a `_LaneGraphs`: every span name of the
    step and no other, properly nested under one root per scan, one scan id
    per scan, a step.wait per HostFlags wait, step.eager on the eager scans
    alone, device stages chained on shared events, no event made during the
    scans; `drain()` clears."""
    lo, lg = _lane_graphs_odometry(scans)
    profiling.enable("cuda")
    made, waits, eager = FakeEvent.made, HostFlags.waits, []
    for scan in scans:
        n = lg.eager_scans
        lo.process_scan(scan)
        lo.get_current_pose()
        eager.append(lg.eager_scans > n)
    spans = profiling.drain()
    assert FakeEvent.made == made
    assert {s.name for s in spans.host} == HOST_SPANS
    assert {s.name for s in spans.device} == DEVICE_SPANS
    assert spans.dropped == 0
    _parents_nest(spans)
    roots = [s for s in spans.host if s.parent is None]
    assert [s.scan for s in roots if s.name == "odometry.scan"] == list(range(N_SCANS))
    assert [s.scan for s in roots if s.name == "odometry.pose_read"] == list(range(N_SCANS))
    assert {s.name for s in roots} == {"odometry.scan", "odometry.pose_read"}
    assert sum(s.name == "step.wait" for s in spans.host) == HostFlags.waits - waits > 0
    assert [any(s.name == "step.eager" and s.scan == k for s in spans.host)
            for k in range(N_SCANS)] == eager == [True, True] + [False] * (N_SCANS - 2)
    assert [s.scan for s in spans.host if s.name == "step.capture"] == [2]
    for k in range(2, N_SCANS):  # the segments' scans: copy-in, (a), loop, clone, chained
        dev = {s.name: s for s in spans.device if s.scan == k}
        assert set(dev) == {"dev.copy_in", "dev.a", "dev.loop", "dev.clone_diag",
                            "dev.pose_read"}
        assert dev["dev.loop"].end_ns == dev["dev.clone_diag"].start_ns
        if k > 2:  # (the capture ends the copy-in's stage)
            assert dev["dev.copy_in"].end_ns == dev["dev.a"].start_ns
    for s in spans.device:
        assert s.start_ns <= s.end_ns
    assert profiling.drain() == Spans([], [], 0, spans.anchor_bracket_ns)


def test_on_records_the_fleets_spans(recorder, scans, flags_wait, fake_cuda):
    """The fleet runner: one fleet.step root per step (its scan id), the
    pass's fleet.collect (and dev.collect) under the last step's id."""
    run = batched.make_batched_sequence_runner(TINY)
    state = batched.init_batched_state(TINY, 2, "cpu")
    fleet = _fleet_scans(scans)
    profiling.enable("cuda")
    waits = HostFlags.waits
    run(state, fleet)
    spans = profiling.drain()
    assert {s.name for s in spans.host} == {"fleet.step", "fleet.collect", "step.wait"}
    assert [s.scan for s in spans.host if s.name == "fleet.step"] == [0, 1, 2]
    assert [s.scan for s in spans.host if s.name == "fleet.collect"] == [2]
    assert [(s.name, s.scan) for s in spans.device] == [("dev.collect", 2)]
    assert sum(s.name == "step.wait" for s in spans.host) == HostFlags.waits - waits
    _parents_nest(spans)


def test_summarize_on_hand_made_spans():
    """Four scans (ns), the third inside a skipped stretch (the profiler's):
    waits, an eager step with a wait inside, a capture and a wait under a
    stage; device spans that overlap, cross the stretch's edges or lie in
    the skipped part."""
    host = [
        HostSpan("odometry.scan", 0, 100, 0, None, 0),
        HostSpan("step.wait", 10, 30, 1, 0, 0),
        HostSpan("step.eager", 40, 90, 2, 0, 0),
        HostSpan("step.wait", 50, 60, 3, 2, 0),
        HostSpan("odometry.scan", 1000, 1100, 10, None, 1),
        HostSpan("step.copy_in", 1000, 1020, 11, 10, 1),
        HostSpan("step.capture", 1030, 1080, 12, 10, 1),
        HostSpan("odometry.scan", 2000, 2100, 20, None, 2),
        HostSpan("step.wait", 2010, 2090, 21, 20, 2),
        HostSpan("odometry.scan", 3000, 3200, 30, None, 3),
        HostSpan("step.launch_loop", 3000, 3050, 31, 30, 3),
        HostSpan("step.wait", 3010, 3040, 32, 31, 3),
        HostSpan("odometry.pose_read", 3200, 3300, 33, None, 3),
    ]
    device = [DeviceSpan("dev.a", 0, 80, 0), DeviceSpan("dev.eager", 50, 120, 0),
              DeviceSpan("dev.a", 1000, 1100, 1), DeviceSpan("dev.loop", 1850, 2000, 1),
              DeviceSpan("dev.a", 2100, 2200, 2), DeviceSpan("dev.loop", 3000, 3250, 3),
              DeviceSpan("dev.pose_read", 3200, 3400, 3)]
    got = profiling.summarize(Spans(host, device, 0, 0), skip=[(1900, 2500)])
    stretch = 1900 + 800          # [0, 3300] less [1900, 2500]
    busy = 120 + 100 + 50 + 300   # [0, 120], [1000, 1100], [1850, 1900], [3000, 3300]
    assert got["scans"] == 3
    assert got["stretch_s"] == pytest.approx(stretch * 1e-9)
    assert got["step.idle_share"] == pytest.approx(1 - busy / stretch)
    assert got["device_busy_ms_per_scan"] == pytest.approx(busy * 1e-6 / 3)
    # roots less their outermost waits, eager steps and captures: 30 + 50 + 170
    assert got["step.enqueue_ms_per_scan"] == pytest.approx(250 * 1e-6 / 3)
    assert got["step.host_wait_ms_per_scan"] == pytest.approx((20 + 10 + 30) * 1e-6 / 3)
    assert got["step.eager_ms_per_scan"] == pytest.approx(50 * 1e-6 / 3)
    whole = profiling.summarize(Spans(host, device, 0, 0))
    assert whole["scans"] == 4
    assert whole["step.idle_share"] == pytest.approx(1 - (120 + 100 + 150 + 100 + 300) / 3300)
    empty = profiling.summarize(Spans([], [], 0, 0))
    assert empty["scans"] == 0 and empty["step.enqueue_ms_per_scan"] is None


def test_pending_spans_are_taken_in_order_when_done():
    """PendingSpans (the recorder's and CommStats' device spans in flight):
    `take` returns the leading completed spans, and with `wait` all of them
    after waiting for the last."""
    class Done:
        def __init__(self, done):
            self.done, self.waited = done, False

        def query(self):
            return self.done

        def synchronize(self):
            self.waited = True

    pending = profiling.PendingSpans()
    ends = [Done(True), Done(False), Done(True)]
    for k, e in enumerate(ends):
        pending.add(k, None, e)
    assert [k for k, _, _ in pending.take()] == [0] and len(pending) == 2
    assert [k for k, _, _ in pending.take(wait=True)] == [1, 2] and ends[2].waited
    assert pending == [] and pending.take(wait=True) == []
