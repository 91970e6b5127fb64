"""The trace reader on synthetic profiler events, and the roofline counts
at the main path's shapes against the bounds of PERF.md's kernel table."""

import pytest

import _paths  # noqa: F401
import devtrace
import harness
import peaks
import run
from harness import load_module, HERE


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    return [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 101.0, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 150.0, "dur": 30.0},
        _kernel("match_kernel(float const*)", 110.0, 20.0),
        _kernel("gn_step_kernel(float const*)", 120.0, 20.0),   # overlaps the one before
        _kernel("match_kernel(float const*)", 190.0, 30.0),     # runs past the window
        _kernel("Memcpy DtoH", 140.0, 5.0, cat="gpu_memcpy"),
        _kernel("early", 50.0, 40.0),                            # before the window
    ]


def test_overlapping_intervals_count_once():
    busy, gaps = devtrace.union_length([(0, 10), (5, 15), (20, 30), (25, 26)], 0, 40)
    assert busy == 25
    assert gaps == [(15, 20), (30, 40)]
    busy, gaps = devtrace.union_length([(-5, 5), (35, 50)], 0, 40)
    assert busy == 10 and gaps == [(5, 35)]


def test_summary_of_a_span():
    s = devtrace.summarize(_events(), ("match_kernel", "gn_step_kernel"))
    assert s.window_s == pytest.approx(100e-6)
    # [110, 140) + [140, 145) + [190, 200): the kernels' overlap counted once,
    # the part past the window left out
    assert s.busy_s == pytest.approx(45e-6)
    assert 0.0 <= s.idle_share <= 1.0 and s.idle_share == pytest.approx(0.55)
    assert s.device_ops == 4
    assert s.kernels["match_kernel"] == (2, pytest.approx(50e-6))
    assert s.kernels["gn_step_kernel"] == (1, pytest.approx(20e-6))
    longest = s.idle_gaps[0]
    assert longest[0] == f"{devtrace.WINDOW}/aten::copy_"
    assert longest[1] == pytest.approx(45e-6)


def test_idle_share_stays_within_0_and_1():
    full = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 0.0, "dur": 10.0},
            _kernel("a", -5.0, 30.0), _kernel("b", 1.0, 2.0)]
    assert devtrace.summarize(full).idle_share == pytest.approx(0.0)
    empty = full[:1]
    assert devtrace.summarize(empty).idle_share == pytest.approx(1.0)


def _bound_ms(kernel, **shape):
    mod = load_module(HERE / "roofline" / f"{kernel}.py")
    return peaks.bound_s(*mod.bytes_ops(**shape)) * 1e3


MAIN = dict(Q=8192, C=131072, RW=64)


def test_k2_bound_is_the_kernel_tables():
    # PERF.md's kernel table: 0.00009 ms at B = 1, 0.00072 at B = 8 (bytes)
    assert _bound_ms("k2", B=1, **MAIN) == pytest.approx(0.00009, rel=0.02)
    assert _bound_ms("k2", B=8, **MAIN) == pytest.approx(0.00072, rel=0.02)


def test_k3_bound_is_the_kernel_tables():
    # 0.0053 ms at B = 1 with 32,521 present slices, 0.0359 at B = 8 with 216,068
    assert _bound_ms("k3", B=1, present=32521, **MAIN) == pytest.approx(0.0053, rel=0.01)
    assert _bound_ms("k3", B=8, present=216068, **MAIN) == pytest.approx(0.0359, rel=0.01)


def test_k1_counts():
    # each present slice's count lane and its candidates' coordinates, per
    # lane the query-side traffic, a normal per valid match
    mod = load_module(HERE / "roofline" / "k1.py")
    n_bytes, n_ops = mod.bytes_ops(Q=8192, B=1, present=30000, candidates=400000,
                                   valid=7000)
    assert n_bytes == 4 * (30000 + 3 * 400000) + 8192 * (13 + 72 + 33) + 48 + 12 * 7000
    assert n_ops == 9 * 400000 + 15 * 8192
    b8, _ = mod.bytes_ops(Q=8192, B=8, present=8 * 30000, candidates=8 * 400000,
                          valid=8 * 7000)
    assert b8 == 8 * n_bytes
    # bound by bytes at these shapes
    assert n_bytes / peaks.HBM_BYTES_PER_S > n_ops / peaks.FP32_FLOPS_PER_S


VLP16 = dict(N=32768, R=16, W=1800)


def test_prepare_bound_is_the_kernel_tables():
    # the front end's bound at vlp16 sizes (PERF.md): 0.00049 ms at B = 1, 0.0039 at B = 8,
    # by bytes: 21 a raw point in, 33 an image cell out
    assert _bound_ms("prepare", B=1, **VLP16) == pytest.approx(0.00049, rel=0.01)
    assert _bound_ms("prepare", B=8, **VLP16) == pytest.approx(0.0039, rel=0.01)
    mod = load_module(HERE / "roofline" / "prepare.py")
    n_bytes, n_ops = mod.bytes_ops(B=1, **VLP16)
    assert n_bytes == 21 * 32768 + 33 * 16 * 1800
    assert n_bytes / peaks.HBM_BYTES_PER_S > n_ops / peaks.FP32_FLOPS_PER_S


def _trace_of(kernels: dict):
    return devtrace.TraceSummary(window_s=1e-3, busy_s=5e-4, device_ops=100, kernels=kernels,
                                 top_ops=[], idle_gaps=[])


def test_a_kernels_module_share_sums_its_functions_per_call():
    mod = load_module(HERE / "roofline" / "prepare.py")
    assert set(mod.KERNELS) <= set(harness.trace_kernels())
    assert {"match_kernel", "gn_step_kernel", "neighborhood_kernel"} <= set(harness.trace_kernels())
    shape = dict(B=8, **VLP16)
    # 20 calls; the four functions' mean times per launch 6, 3, 2.5 and 4 us
    kernels = {"lane_kernel": (20, 120e-6), "point_kernel": (20, 60e-6),
               "image_kernel": (20, 50e-6), "planar_kernel": (20, 80e-6)}
    ctx = run.Context({"trace": [_trace_of(kernels)]}, None, shape, load_module)
    bound = peaks.bound_s(*mod.bytes_ops(**shape))
    assert ctx.roofline_share("prepare") == pytest.approx(100 * bound / 15.5e-6)
    # a record lost on one function moves only that function's mean
    kernels["image_kernel"] = (19, 47.5e-6)
    ctx = run.Context({"trace": [_trace_of(kernels)]}, None, shape, load_module)
    assert ctx.roofline_share("prepare") == pytest.approx(100 * bound / 15.5e-6)
    # a function the span never ran leaves the metric out, as does a missing trace
    del kernels["point_kernel"]
    ctx = run.Context({"trace": [_trace_of(kernels)]}, None, shape, load_module)
    assert ctx.roofline_share("prepare") is None
    assert run.Context({}, None, shape, load_module).roofline_share("prepare") is None


def test_a_kernel_module_share_is_its_mean_launch():
    shape = dict(Q=8192, B=1, C=131072, RW=64)
    mod = load_module(HERE / "roofline" / "k2.py")
    ctx = run.Context({"trace": [_trace_of({"gn_step_kernel": (80, 400e-6)})]}, None, shape,
                      load_module)
    assert ctx.roofline_share("k2") == pytest.approx(
        100 * peaks.bound_s(*mod.bytes_ops(**shape)) / 5e-6)


def test_kernel_shape_gives_the_raw_scan_and_the_counts():
    from types import SimpleNamespace
    cell = harness.load_cell("vlp16.fleet8")
    stats = SimpleNamespace(present_slices=100, candidates=1000, matches=50)
    raw = dict(traced=dict(scans=2, rounds=8, lanes=8), traced_scans=[(0, 0), (1, 1)],
               ref_stats=[dict(stats=[stats, None]), dict(stats=[None, stats])])
    shape = run.kernel_shape(raw, cell)
    assert {k: shape[k] for k in ("B", "N", "R", "W")} == dict(B=8, **VLP16)
    assert (shape["present"], shape["candidates"], shape["valid"]) == (800, 8000, 400)
