"""Port parity for the entry point: the CLI (`sim`, `pcd-dir`) against the
JAX package's CLI on TINY-sized scans, and the framework-free copies
(io/pcd.py, models/presets.py) and the profiling helpers (CPU).

Tolerances: the TUM rows agree within 1e-5 (the one-step bar of
tests/test_torch_pipeline.py; TUM keeps 6 decimals); the JSON lines carry
the same keys and equal ICP iterations, matches and map sizes; PCD values
round-trip to the 6 decimals the ascii writer keeps.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import yaml

from lidar_odometry_demo_tpu import cli as jcli
from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io import pcd as jpcd
from lidar_odometry_demo_tpu.models import presets as jpresets
from lidar_odometry_demo_tpu_torch import cli
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.io import pcd
from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu_torch.io.trajectory import read_tum
from lidar_odometry_demo_tpu_torch.models import presets
from lidar_odometry_demo_tpu_torch.utils import profiling

N_SCANS = 6


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    path.write_text(yaml.safe_dump(dataclasses.asdict(TINY)))
    return str(path)


def _json_lines(err: str):
    return [json.loads(line) for line in err.splitlines() if line.startswith("{")]


def test_cli_sim_matches_the_jax_cli(tmp_path, capsys, tiny_yaml):
    sim = ["sim", "--scans", str(N_SCANS), "--seed", "3", "--speed", "5.0"]
    jcli.main(["--config", tiny_yaml, *sim, "--out", str(tmp_path / "j.tum")])
    jerr = capsys.readouterr().err
    cli.main(["--config", tiny_yaml, *sim, "--device", "cpu", "--out", str(tmp_path / "t.tum"),
              "--keyframe-out", str(tmp_path / "kf.pcd")])
    captured = capsys.readouterr()
    assert "aligned ATE RMSE vs ground truth" in captured.out

    stamps, t, q = read_tum(str(tmp_path / "t.tum"))
    _, jt, jq = read_tum(str(tmp_path / "j.tum"))
    assert t.shape == (N_SCANS, 3) and np.all(np.diff(stamps) > 0)
    assert np.abs(t[-1]).max() > 1e-3  # the estimate moves
    np.testing.assert_allclose(t, jt, atol=1e-5, rtol=0)
    np.testing.assert_allclose(q, jq, atol=1e-5, rtol=0)

    lines, jlines = _json_lines(captured.err), _json_lines(jerr)
    assert len(lines) == len(jlines) == N_SCANS
    for got, want in zip(lines, jlines):
        assert got.keys() == want.keys()
        for k in ("scan", "icp_iterations", "matches", "map_voxels", "diverged"):
            assert got[k] == want[k], k

    kf = pcd.read_pcd_xyz(str(tmp_path / "kf.pcd"))
    assert kf.shape == (lines[-1]["map_voxels"], 3)
    assert np.all(np.isfinite(kf))


def _write_scan_pcd(path, s):
    """A binary PCD with the x y z intensity ring time fields of one scan."""
    n = s["xyz"].shape[0]
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("intensity", "<f4"), ("ring", "<u2"), ("time", "<f4")])
    rec["x"], rec["y"], rec["z"] = s["xyz"].T
    rec["intensity"], rec["ring"], rec["time"] = s["intensity"], s["ring"], s["time"]
    header = ("VERSION 0.7\nFIELDS x y z intensity ring time\nSIZE 4 4 4 4 2 4\n"
              "TYPE F F F F U F\nCOUNT 1 1 1 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def test_cli_pcd_dir_matches_the_same_scans_simulated(tmp_path, capsys, tiny_yaml):
    """pcd-dir over the sim drive's scans saved as PCD files gives the sim
    subcommand's trajectory."""
    drive = simulate_sequence(num_scans=N_SCANS, width=TINY.scan_width, seed=3, speed=2.0,
                              yaw_rate=0.05)
    scans = tmp_path / "scans"
    scans.mkdir()
    for i, s in enumerate(drive.scans):
        _write_scan_pcd(scans / f"{i:04d}.pcd", s)
    cli.main(["--config", tiny_yaml, "pcd-dir", str(scans), "--device", "cpu", "--quiet",
              "--out", str(tmp_path / "dir.tum")])
    cli.main(["--config", tiny_yaml, "sim", "--scans", str(N_SCANS), "--seed", "3",
              "--speed", "2.0", "--device", "cpu", "--quiet", "--out", str(tmp_path / "sim.tum")])
    assert _json_lines(capsys.readouterr().err) == []  # --quiet
    _, t_dir, q_dir = read_tum(str(tmp_path / "dir.tum"))
    _, t_sim, q_sim = read_tum(str(tmp_path / "sim.tum"))
    np.testing.assert_array_equal(t_dir, t_sim)
    np.testing.assert_array_equal(q_dir, q_sim)


def test_cli_runs_on_the_card_by_default(monkeypatch):
    """Without --device the CLI asks for "cuda"; with no card that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["sim", "--scans", "1", "--quiet"])


def test_pcd_round_trip_matches_the_jax_copy(tmp_path, rng):
    xyz = rng.uniform(-50, 50, (300, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (300, 3)).astype(np.float32)
    xyz[7] = np.nan
    pcd.write_pcd(str(tmp_path / "a.pcd"), xyz, nrm)
    jpcd.write_pcd(str(tmp_path / "b.pcd"), xyz, nrm)
    assert (tmp_path / "a.pcd").read_bytes() == (tmp_path / "b.pcd").read_bytes()
    got, want = pcd.read_pcd(str(tmp_path / "a.pcd")), jpcd.read_pcd(str(tmp_path / "a.pcd"))
    assert got.keys() == want.keys() == {"x", "y", "z", "normal_x", "normal_y", "normal_z"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    back = pcd.read_pcd_xyz(str(tmp_path / "a.pcd"))
    assert back.shape == (299, 3)
    np.testing.assert_allclose(back, np.delete(xyz, 7, axis=0), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["vlp16_default", "vlp16_fast", "vlp16_high_accuracy",
                                  "tiny_test"])
def test_presets_match_the_jax_presets(name):
    assert getattr(presets, name)().to_dict() == getattr(jpresets, name)().to_dict()


def test_profiling_helpers_on_cpu(tmp_path):
    """The CLI's scans/s counter, and a recorder span under torch.profiler:
    its name is a range of the exported trace, and the span is drained."""
    rate = profiling.ScanRateCounter(window=3)
    assert rate.tick() == 0.0
    assert all(rate.tick() > 0 for _ in range(4)) and len(rate.stamps) == 3
    profiling.enable("cpu")
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            profiling.begin("odometry.scan")
            torch.ones(8).sum()
            profiling.end()
    finally:
        profiling.disable()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert '"odometry.scan"' in (tmp_path / "trace.json").read_text()
    spans = profiling.drain()
    assert [(s.name, s.scan) for s in spans.host] == [("odometry.scan", 0)]
    assert spans.device == [] and profiling.drain().host == []


def test_cli_fleet_matches_the_jax_cli(tmp_path, capsys, monkeypatch, tiny_yaml):
    """`fleet --batch 2 --scans 3` under TINY: one TUM per lane within 1e-4
    of the JAX CLI's (which shards the two lanes over its device mesh), and
    the same stderr lines."""
    monkeypatch.setattr(jcli, "_load_config", lambda args: JTINY)
    fleet = ["fleet", "--batch", "2", "--scans", "3"]
    jcli.main([*fleet, "--out-prefix", str(tmp_path / "j_")])
    jerr = capsys.readouterr().err
    cli.main(["--config", tiny_yaml, *fleet, "--device", "cpu",
              "--out-prefix", str(tmp_path / "t_")])
    captured = capsys.readouterr()
    assert "mesh: dp=1 x sp=1 over 1 devices" in captured.err
    assert "fleet: 2 sequences x 3 scans in " in captured.err and "mesh: " in jerr
    for b in range(2):
        assert f"lane {b}: {tmp_path / f't_{b}.tum'}  aligned ATE " in captured.out
        stamps, t, q = read_tum(str(tmp_path / f"t_{b}.tum"))
        jstamps, jt, jq = read_tum(str(tmp_path / f"j_{b}.tum"))
        assert t.shape == (3, 3) and np.array_equal(stamps, jstamps)
        np.testing.assert_allclose(t, jt, atol=1e-4, rtol=0)
        np.testing.assert_allclose(q, jq, atol=1e-4, rtol=0)


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--sp", "2"]])
def test_cli_fleet_mesh_flags_raise(tmp_path, capsys, tiny_yaml, flag):
    """The sharded modes are ported: `--dp 2` and `--sp 2` spawn two ranks
    (gloo on the CPU) and write every lane's TUM within 1e-5 of the dp=1
    run; only an impossible mesh raises and names the flag (a batch that
    --dp does not divide, an axis of no rank)."""
    fleet = ["--config", tiny_yaml, "fleet", "--batch", "2", "--scans", "2", "--device", "cpu"]
    cli.main([*fleet, "--out-prefix", str(tmp_path / "one_")])
    capsys.readouterr()
    cli.main([*fleet, *flag, "--out-prefix", str(tmp_path / "mesh_")])
    captured = capsys.readouterr()
    dp, sp = (2, 1) if flag[0] == "--dp" else (1, 2)
    assert f"mesh: dp={dp} x sp={sp} over 1 devices (2 ranks, backend gloo)" in captured.err
    for b in range(2):
        assert f"lane {b}: {tmp_path / f'mesh_{b}.tum'}  aligned ATE " in captured.out
        _, t, q = read_tum(str(tmp_path / f"mesh_{b}.tum"))
        _, t1, q1 = read_tum(str(tmp_path / f"one_{b}.tum"))
        np.testing.assert_allclose(t, t1, atol=1e-5, rtol=0)
        np.testing.assert_allclose(q, q1, atol=1e-5, rtol=0)
    bad = ["--batch", "3", "--dp", "2"] if flag[0] == "--dp" else ["--sp", "0"]
    with pytest.raises(SystemExit, match=bad[-2]):
        cli.main(["fleet", "--scans", "1", "--device", "cpu", *bad])


def test_cli_fleet_dp2_sp2_matches_the_jax_cli(tmp_path, capsys, monkeypatch, tiny_yaml):
    """`fleet --batch 2 --scans 3 --dp 2 --sp 2`, the JAX CLI's command line
    (its mesh over 4 of its 8 CPU devices; the port spawns 4 ranks): one
    TUM per lane within 1e-4 of the JAX CLI's, and its mesh line."""
    monkeypatch.setattr(jcli, "_load_config", lambda args: JTINY)
    fleet = ["fleet", "--batch", "2", "--scans", "3", "--dp", "2", "--sp", "2"]
    jcli.main([*fleet, "--out-prefix", str(tmp_path / "j_")])
    jerr = capsys.readouterr().err
    cli.main(["--config", tiny_yaml, *fleet, "--device", "cpu",
              "--out-prefix", str(tmp_path / "t_")])
    captured = capsys.readouterr()
    assert "mesh: dp=2 x sp=2 over " in jerr
    assert "mesh: dp=2 x sp=2 over 1 devices (4 ranks, backend gloo)" in captured.err
    assert "fleet: 2 sequences x 3 scans in " in captured.err
    for b in range(2):
        _, t, q = read_tum(str(tmp_path / f"t_{b}.tum"))
        _, jt, jq = read_tum(str(tmp_path / f"j_{b}.tum"))
        np.testing.assert_allclose(t, jt, atol=1e-4, rtol=0)
        np.testing.assert_allclose(q, jq, atol=1e-4, rtol=0)


def test_multicard_smoke_without_a_card_exits_non_zero():
    """multicard_smoke.py prints no result and exits non-zero without CUDA
    (and, on a machine with one card, raises: it needs a card per rank)."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(repo / "multicard_smoke.py")],
                          cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_reaps_the_processes_it_started():
    """chip_smoke.stop_helper_processes, which runs as the script exits, ends
    a spawned child still running and multiprocessing's resource tracker,
    and reaps both: neither outlives the script, not even as a zombie."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    script = f"""
import importlib.util, multiprocessing, os, time
from multiprocessing import resource_tracker

spec = importlib.util.spec_from_file_location("chip_smoke", {str(repo / "chip_smoke.py")!r})
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
child = multiprocessing.get_context("spawn").Process(target=time.sleep, args=(60,), daemon=True)
child.start()
pids = [resource_tracker._resource_tracker._pid, child.pid]
chip_smoke.stop_helper_processes()
for pid in pids:
    try:
        os.kill(pid, 0)
        print(pid, "alive")
    except ProcessLookupError:
        print(pid, "gone")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split("\n")[:2]
    assert [line.split()[1] for line in lines] == ["gone", "gone"], proc.stdout
