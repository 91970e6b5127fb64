"""The on-card generator's torch ray cast and packet encoder against the
port's NumPy simulator at a small width (on the CPU), and the harness
finding a configuration, traffic mix, per-layer metric and limits added as new files
by name, with no existing file edited."""

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _paths
import gen

from lidar_odometry_demo_tpu_torch.io import simulator

WIDTH = 120


@pytest.fixture(scope="module")
def drives():
    numpy_drive = simulator.simulate_sequence(4, WIDTH, seed=9, speed=5.0, yaw_rate=0.08)
    torch_drive = gen.simulate_drive(9, 4, WIDTH, 2048, gen.Motion(), "cpu",
                                     with_range_image=True)
    return numpy_drive, torch_drive


def test_ray_cast_is_the_numpy_simulator(drives):
    numpy_drive, d = drives
    for s, scan in enumerate(numpy_drive.scans):
        n = int(d.valid[s].sum())
        assert n == scan["xyz"].shape[0]
        assert not d.valid[s, n:].any()
        np.testing.assert_array_equal(d.xyz[s, :n].numpy(), scan["xyz"])
        np.testing.assert_array_equal(d.ring[s, :n].numpy(), scan["ring"])
        np.testing.assert_array_equal(d.time[s, :n].numpy(), scan["time"])
        np.testing.assert_array_equal(d.intensity[s, :n].numpy(), scan["intensity"])
        img = d.range_image[s].numpy()
        np.testing.assert_array_equal(np.isfinite(img), np.isfinite(scan["range_image"]))
        hit = np.isfinite(img)
        np.testing.assert_allclose(img[hit], scan["range_image"][hit], rtol=0, atol=1e-9)


def test_packets_are_the_numpy_encoder(drives):
    numpy_drive, d = drives
    pk = gen.encode_packets(d.range_image.numpy(), 0, 0.1)
    for s, scan in enumerate(numpy_drive.scans):
        assert pk[s].tobytes() == simulator.encode_vlp16_packets(scan["range_image"],
                                                                 scan["scan_start"])


def _digest(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_files_are_found_by_name(tmp_path):
    bench = tmp_path / "odobench"
    shutil.copytree(_paths.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text((_paths.ROOT / "BENCHMARK.json").read_text())
    before = _digest(bench)
    # a later change adds files and entries only
    cfg = json.loads((bench / "configs" / "vlp16.json").read_text())
    cfg["odometry"]["max_match_points"] = 4096
    (bench / "configs" / "vlp16-small.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "replay.json").read_text())
    traffic["scans_per_drive"] = 40
    (bench / "traffic" / "short.json").write_text(json.dumps(traffic))
    (bench / "limits" / "vlp16-small.short.json").write_text(json.dumps({"incr_gap_m_p50": 1.0}))
    (bench / "metrics" / "test.scans.py").write_text(textwrap.dedent('''
        def read(ctx):
            return float(ctx.scans)
        '''))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "vlp16-small", "source": "test", "why": "test",
                         "file": "odobench/configs/vlp16-small.json",
                         "reduced": ["max_match_points"]})
    b["workloads"].append({"name": "vlp16-small.short", "config": "vlp16-small",
                           "traffic": "short", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "test.scans", "unit": "scans", "better": "higher",
                           "source": "host_clock", "layer": "test", "moves": "scans_per_s",
                           "workloads": ["vlp16-small.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    probe = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(bench)!r})
        import harness, run
        cell = harness.load_cell("vlp16-small.short")
        assert cell.config["odometry"]["max_match_points"] == 4096
        assert cell.traffic["scans_per_drive"] == 40
        assert cell.limits == {{"incr_gap_m_p50": 1.0}}
        raw = dict(scans=7, window_s=1.0, setup_s=1.0, latencies=[0.001], counters={{}},
                   memory_peak=0, check=dict(incr_gap_m_p50=0.0, scans_compared=7), trace=None)
        out = run.result(cell, raw, True, "cpu")
        assert out["metrics"]["test.scans"] == {{"value": 7.0, "unit": "scans"}}, out
        print("ok")
        ''')
    got = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120)
    assert got.returncode == 0 and got.stdout.strip() == "ok", got.stderr
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
