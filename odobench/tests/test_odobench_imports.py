"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), no file of the benchmark reads the JAX package's `benchmarks/`,
and without a card the benchmark exits non-zero with no result."""

import re
import subprocess
import sys
import textwrap

import pytest

import _paths

FORBIDDEN = {"jax", "jaxlib", "flax", "lidar_odometry_demo_tpu"}


def test_a_run_loads_no_jax():
    """A whole run of a cell (on the CPU at TINY, the card's look skipped),
    then every module loaded, by top-level name."""
    probe = textwrap.dedent(f'''
        import sys, time
        sys.path.insert(0, {str(_paths.BENCH)!r})
        import harness, run
        from lidar_odometry_demo_tpu_torch.config import TINY
        odo = {{k: getattr(TINY, k) for k in ("scan_width", "max_raw_points",
               "max_planar_points", "max_match_points", "max_update_points", "map_capacity")}}
        cell = harness.load_cell("vlp16.replay", overrides={{"odometry": odo,
                                 "traffic": {{"scans_per_drive": 4}}}})
        raw = harness.run_cell(cell, 3, 0.5, False, "cpu", time.perf_counter())
        run.result(cell, raw, False, "cpu")
        for p in (harness.HERE / "metrics").glob("*.py"):
            harness.load_module(p)
        for p in (harness.HERE / "roofline").glob("*.py"):
            harness.load_module(p)
        print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
        ''')
    got = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr
    loaded = set(got.stdout.split())
    assert "lidar_odometry_demo_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    # the guard run.py applies after the window compares whole names too
    sys.path.insert(0, str(_paths.BENCH))
    import run
    assert "lidar_odometry_demo_tpu_torch" not in run.FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN


def test_no_file_reads_the_jax_benchmarks():
    pattern = re.compile(r"""["'/]benchmarks["'/]""")
    for path in _paths.BENCH.rglob("*"):
        if path.suffix in (".py", ".json", ".sh", ".txt") and path.name != "test_odobench_imports.py":
            assert not pattern.search(path.read_text()), path


def test_without_a_card_no_result():
    got = subprocess.run([sys.executable, str(_paths.BENCH / "run.py"), "--workload",
                          "vlp16.replay", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=_paths.ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "CUDA device" in got.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = subprocess.run([sys.executable, str(_paths.BENCH / "run.py"), "--workload",
                          "vlp16.replay", "--seed", "2147483659", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=_paths.ROOT)
    assert got.returncode == 0, got.stderr[-4000:]
    import json
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
