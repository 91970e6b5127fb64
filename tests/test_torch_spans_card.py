"""The span recorder (utils/profiling.py) on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q -s -m cuda tests/test_torch_spans_card.py

- A host sleep between two launches on an idle device is a gap between
  their device spans as long as the host's time between the two records,
  from 0.05 ms shorter to 0.1 ms longer: an idle device reaches the next
  work 0.02-0.06 ms after the host submits it (longer after a longer
  sleep), and that wait is idle too. Each printed, with the anchor's
  bracket (the error of the one clock) and the offset of an event recorded
  on the idle device from the host's time of its record.
- The device spans of captured scans at full width (`OdometryConfig()`)
  cover at least 95 % of the device's busy time that torch.profiler
  (CUPTI) reads on the same scans: the spans leave no operation of the
  step out. Printed beside it, the spans' busy ms per scan without the
  profiler against CUPTI's.
"""

import json
import time

import pytest
import torch

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy
from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry
from lidar_odometry_demo_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    profiling.disable()
    profiling.drain()
    yield torch.device("cuda")
    profiling.disable()
    profiling.drain()


def test_host_sleep_is_a_device_gap(dev):
    """The first pair after `enable()` is a warm-up, printed and not held
    to the bar: its start event once read 0.08 ms after its host time on
    the idle device."""
    x = torch.randn(1 << 20, device=dev)
    x.mul_(1.0)
    torch.cuda.synchronize()
    profiling.enable(dev)
    for ms in (1.0, 0.2, 1.0, 5.0):
        profiling.begin("odometry.scan", "dev.a")
        x.mul_(1.0)
        profiling.end(dev_end=True)
        time.sleep(ms * 1e-3)
        profiling.begin("odometry.pose_read", "dev.pose_read")
        x.mul_(1.0)
        profiling.end(dev_end=True)
        torch.cuda.synchronize()
    spans = profiling.drain()
    profiling.disable()
    host, device = spans.host, spans.device
    assert [s.name for s in device] == ["dev.a", "dev.pose_read"] * 4, device
    gaps, offsets = [], []
    for k in range(4):
        h_a, h_b = host[2 * k], host[2 * k + 1]
        d_a, d_b = device[2 * k], device[2 * k + 1]
        gaps.append(((h_b.start_ns - h_a.end_ns) * 1e-6, (d_b.start_ns - d_a.end_ns) * 1e-6))
        offsets.append((d_b.start_ns - h_b.start_ns) * 1e-6)  # idle device: its record's latency
    print("spans card:", json.dumps({
        "card": torch.cuda.get_device_name(0),
        "anchor_bracket_ms": spans.anchor_bracket_ns * 1e-6,
        "idle_event_offset_ms": offsets, "gaps_host_device_ms": gaps,
        "host": [(s.name, s.start_ns, s.end_ns) for s in host],
        "device": [(s.name, s.start_ns, s.end_ns) for s in device]}))
    for host_gap, dev_gap in gaps[1:]:  # the device sees the next work 0.02-0.06 ms late
        assert -0.05 < dev_gap - host_gap < 0.1, gaps


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def test_device_spans_cover_the_profilers_busy_time(dev, tmp_path):
    """Captured full-width scans, their device spans and torch.profiler
    (CUPTI) on together: the share of the device operations' busy time that
    lies inside the device spans, the two clocks aligned by the host spans'
    profiler ranges, is at least 95 %. Printed beside it, from the same
    scans run from the same state without the profiler: the spans' busy ms
    per scan against CUPTI's (the gaps between a graph's kernels count as
    busy in a span)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # before any graph: CUPTI sees WHILE bodies
        torch.cuda.synchronize()
    cfg = OdometryConfig()
    drive = simulate_sequence(num_scans=22, width=cfg.scan_width, seed=11, speed=5.0,
                              yaw_rate=0.05, ramp_time=0.0)
    scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             cfg.max_raw_points, dev) for s in drive.scans]
    lo = LidarOdometry(cfg, device=dev)
    for scan in scans[:6]:  # eager warm-up, the capture
        lo.process_scan(scan)
        lo.get_current_pose()
    start, timed = lo.state, scans[6:]

    def run():
        lo.state = start
        for scan in timed:
            lo.process_scan(scan)
            lo.get_current_pose()
        torch.cuda.synchronize()

    run()
    profiling.enable(dev)
    run()
    alone = profiling.summarize(profiling.drain())
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    run()
    prof.stop()
    spans = profiling.drain()
    profiling.disable()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    # the profiler's clock (us) against the spans' (ns), by the roots' ranges
    marks = sorted(round(float(e["ts"]) * 1e3) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == "odometry.scan")
    roots = sorted(s.start_ns for s in spans.host if s.name == "odometry.scan")
    assert len(roots) == len(marks) == len(timed)
    shifts = sorted(m - r for m, r in zip(marks, roots))
    shift = shifts[len(shifts) // 2]
    lo_t = marks[0]
    hi_t = max((float(e["ts"]) + float(e["dur"])) * 1e3 for e in events
               if e.get("cat") == "user_annotation" and e["name"] == "odometry.pose_read")
    ops = _merged([(max(float(e["ts"]) * 1e3, lo_t),
                    min((float(e["ts"]) + float(e["dur"])) * 1e3, hi_t))
                   for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"])
    stages = _merged([(s.start_ns + shift, s.end_ns + shift) for s in spans.device])
    busy = sum(b - a for a, b in ops)
    covered = _overlap(ops, stages) / busy
    print("spans card:", json.dumps({
        "card": torch.cuda.get_device_name(0), "scans": alone["scans"],
        "covered_share": covered, "clock_shift_spread_us": (shifts[-1] - shifts[0]) * 1e-3,
        "spans_busy_ms_per_scan": alone["device_busy_ms_per_scan"],
        "cupti_busy_ms_per_scan": busy * 1e-6 / len(timed),
        "spans_idle_share": alone["step.idle_share"],
        "enqueue_ms_per_scan": alone["step.enqueue_ms_per_scan"]}))
    assert alone["scans"] == len(timed)
    assert covered >= 0.95
