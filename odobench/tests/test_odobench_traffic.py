"""The on-card generator's torch ray cast and packet encoder against the
port's NumPy simulator at a small width (on the CPU), its cast of another
sensor's beam table, and the harness finding a configuration, traffic mix,
per-layer metric and limits added as new files by name, with no existing
file edited."""

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


def test_the_vlp16_table_is_the_default(drives):
    _, d = drives
    table = gen.simulate_drive(9, 4, WIDTH, 2048, gen.Motion(), "cpu", with_range_image=True,
                               elevation_deg=json.loads(json.dumps(
                                   gen.vlp16_elevation_deg().tolist())))
    for f in gen.Drive._fields:
        assert getattr(table, f).dtype == getattr(d, f).dtype
        assert getattr(table, f).numpy().tobytes() == getattr(d, f).numpy().tobytes(), f


# a 64-beam table in two blocks of 32, +2.0 to -24.9 degrees, lowest ring first
HDL64_DEG = np.concatenate([np.linspace(-24.9, -8.83, 32), np.linspace(-8.33, 2.0, 32)])


def test_a_64_ring_table_casts_its_beams():
    W, m = 64, gen.Motion(num_boxes=0, range_noise=0.0)
    d = gen.simulate_drive(3, 2, W, 64 * W, m, "cpu", with_range_image=True,
                           elevation_deg=HDL64_DEG.tolist())
    elev = np.deg2rad(HDL64_DEG)
    reach = m.sensor_height / np.sin(-elev)            # the ground's range on each ring
    assert d.range_image.shape == (2, 64, W)
    for s in range(2):
        n = int(d.valid[s].sum())
        assert not d.valid[s, n:].any()
        ring = d.ring[s, :n].numpy()
        # ring-major: each ring's W columns in turn, the rings that return nothing left out
        lit = np.flatnonzero((elev < 0) & (reach <= m.max_range))
        assert np.array_equal(ring, np.repeat(lit, W))
        xyz = d.xyz[s, :n].numpy().astype(np.float64)
        got = np.arctan2(xyz[:, 2], np.hypot(xyz[:, 0], xyz[:, 1]))
        np.testing.assert_allclose(got, elev[ring], rtol=0, atol=1e-6)
        img = d.range_image[s].numpy()
        assert not np.isfinite(img[elev >= 0]).any()   # above the horizon: no return
        np.testing.assert_allclose(img[lit], np.repeat(reach[lit, None], W, 1), rtol=0,
                                   atol=1e-9)


def _digest(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add_cell(bench, b, config, cfg, traffic, tr, limits, reduced):
    """A configuration, a traffic mix and a cell's limits as new files, and
    their entries in BENCHMARK.json's object `b`."""
    (bench / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(tr))
    (bench / "limits" / f"{config}.{traffic}.json").write_text(json.dumps(limits))
    b["configs"].append({"name": config, "source": "test", "why": "test",
                         "file": f"odobench/configs/{config}.json", "reduced": reduced})
    b["workloads"].append({"name": f"{config}.{traffic}", "config": config,
                           "traffic": traffic, "chips": 1, "why": "test"})


def _smaller_vlp16(bench, b):
    cfg = json.loads((bench / "configs" / "vlp16.json").read_text())
    cfg["odometry"]["max_match_points"] = 4096
    traffic = json.loads((bench / "traffic" / "replay.json").read_text())
    traffic["scans_per_drive"] = 40
    _add_cell(bench, b, "vlp16-small", cfg, "short", traffic, {"incr_gap_m_p50": 1.0},
              ["max_match_points"])
    (bench / "metrics" / "test.scans.py").write_text(textwrap.dedent('''
        def read(ctx):
            return float(ctx.scans)
        '''))
    b["per_layer"].append({"name": "test.scans", "unit": "scans", "better": "higher",
                           "source": "host_clock", "layer": "test", "moves": "scans_per_s",
                           "workloads": ["vlp16-small.short"]})
    return textwrap.dedent('''
        cell = harness.load_cell("vlp16-small.short")
        assert cell.config["odometry"]["max_match_points"] == 4096
        assert cell.traffic["scans_per_drive"] == 40
        assert cell.limits == {"incr_gap_m_p50": 1.0}
        raw = dict(scans=7, window_s=1.0, setup_s=1.0, latencies=[0.001], counters={},
                   memory_peak=0, check=dict(incr_gap_m_p50=0.0, scans_compared=7), trace=None)
        out = run.result(cell, raw, True, "cpu")
        assert out["metrics"]["test.scans"] == {"value": 7.0, "unit": "scans"}, out
        ''')


def _sensor_config(bench, rings: int, table: list):
    cfg = json.loads((bench / "configs" / "vlp16.json").read_text())
    cfg["sensor"] = {"name": "test-64", "rings": rings, "elevation_deg": table}
    cfg["odometry"].update(num_rings=64, scan_width=32, max_raw_points=2048)
    traffic = json.loads((bench / "traffic" / "replay.json").read_text())
    traffic.update(scans_per_drive=2, drives=1)
    return cfg, traffic


def _64_rings(bench, b):
    cfg, traffic = _sensor_config(bench, 64, HDL64_DEG.tolist())
    _add_cell(bench, b, "ring64", cfg, "pair", traffic, {"incr_gap_m_p50": 1.0},
              ["num_rings", "scan_width", "max_raw_points"])
    return textwrap.dedent('''
        cell = harness.load_cell("ring64.pair")
        (d,) = harness.drives_of(cell, 2**31 + 7, "cpu", with_range_image=True)
        assert d.range_image.shape == (2, 64, 32), d.range_image.shape
        assert d.xyz.shape == (2, 2048, 3)
        ring = d.ring[d.valid]
        assert int(ring.min()) == 0 and int(ring.max()) == 63
        ''')


def _table_of_the_wrong_length(bench, b):
    cfg, traffic = _sensor_config(bench, 64, HDL64_DEG.tolist()[:-1])
    _add_cell(bench, b, "ring63", cfg, "pair", traffic, {"incr_gap_m_p50": 1.0},
              ["num_rings", "scan_width", "max_raw_points"])
    return textwrap.dedent('''
        try:
            harness.load_cell("ring63.pair")
        except ValueError as e:
            assert "63 elevations" in str(e), e
        else:
            raise AssertionError("a 63-entry table for 64 rings was taken")
        ''')


@pytest.mark.parametrize("add", [_smaller_vlp16, _64_rings, _table_of_the_wrong_length],
                         ids=["smaller-vlp16", "64-rings", "table-refused"])
def test_new_cell_files_are_found_by_name(tmp_path, add):
    bench = tmp_path / "odobench"
    shutil.copytree(_paths.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text((_paths.ROOT / "BENCHMARK.json").read_text())
    before = _digest(bench)
    # a later change adds files and entries only
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    body = add(bench, b)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    probe = f"import sys\nsys.path.insert(0, {str(bench)!r})\nimport harness, run\n" + body + \
        "print('ok')\n"
    got = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120)
    assert got.returncode == 0 and got.stdout.strip() == "ok", got.stderr
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
