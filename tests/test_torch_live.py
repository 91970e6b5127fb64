"""Port parity for live ingestion: the native library (io/native.py, built
from native/lidar_native.cpp), the revolution assembler and `run_live`
(io/live.py) and the CLI's `live`, against the JAX package on the CPU at
TINY size (W = 128: 6 packets per scan).

Tolerances: the revolutions and the decoded arrays bitwise the JAX
package's; the native PCD reader within 1e-5 of io/pcd.py (the ascii
writer's 6 decimals); the port's run_live against the JAX run_live on the
same packet list t within 1e-5, q within 1e-6; a run over a loopback UDP
socket and the CLI against the port's own socket-free run within 1e-6
(the same packets, the same process). Every test skips when no C++
compiler is found.
"""

import dataclasses
import importlib.util
import os
import pathlib
import struct

import numpy as np
import pytest
import yaml

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io import live as jlive
from lidar_odometry_demo_tpu.io import native as jnative
from lidar_odometry_demo_tpu.pipeline import odometry as jodo
from lidar_odometry_demo_tpu_torch import cli
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.io import live, native, pcd
from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu_torch.io.trajectory import read_tum
from lidar_odometry_demo_tpu_torch.pipeline import odometry

N_SCANS = 6


def _load_smoke():
    """chip_smoke.py as a module: its packet encoder and UDP sender."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_smoke()


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("no C++ compiler: the native library cannot be built")
    native._load()
    return native


@pytest.fixture(scope="module")
def stream(lib):
    """A TINY drive's packets and the port's socket-free live run over them."""
    drive = simulate_sequence(num_scans=N_SCANS, width=TINY.scan_width, seed=3, speed=2.0,
                              yaw_rate=0.05, ramp_time=0.0)
    per_scan = smoke.encode_packets(
        dict(range_images=[(s["range_image"], s["scan_start"]) for s in drive.scans]))
    packets = [p for scan in per_scan for p in scan]
    odo = odometry.LidarOdometry(TINY, device="cpu")
    poses = []
    n = live.run_live(odo, iter(packets), flush_partial=True,
                      on_scan=lambda i, t, d: poses.append(odo.get_current_pose()))
    return per_scan, packets, n, poses


def test_native_library_is_built_from_the_source(lib):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("lidar_native-") and path.suffix == ".so"
    assert native.SOURCE.name == "lidar_native.cpp" and native.SOURCE.exists()
    assert "-march=native" not in native.CXX_FLAGS
    assert native._lib._name == str(path)  # never native/liblidar_native.so


def test_scan_assembler_cuts_revolutions(stream):
    """test_scan_assembler_cuts_revolutions on TINY scans: each encoded
    scan comes back as one revolution (within one packet), the same
    revolutions as the JAX assembler's."""
    per_scan, packets, _, _ = stream
    assert all(len(s) == 6 for s in per_scan)
    scans = list(live.scans_from_packet_stream(iter(packets)))
    assert scans == list(jlive.scans_from_packet_stream(iter(packets)))
    assert len(scans) == N_SCANS
    for s in scans:
        assert len(s) % live.PACKET_SIZE == 0
        assert abs(len(s) // live.PACKET_SIZE - 6) <= 1
    # packets 4.8 deg apart, one of them late (UDP reordering, 1 deg behind
    # its predecessor, inside the 2 deg guard): no early cut; the packet
    # that closes the 360 deg sweep cuts, as in the JAX assembler
    pkts = [_make_vlp16_packet(az, 5000, i) for i, az in
            enumerate([0, 480, 380, *range(960, 36000, 480), 0])]
    for asm in (live.ScanAssembler(), jlive.ScanAssembler()):
        cuts = [asm.add(p) for p in pkts]
        assert cuts[:-1] == [None] * (len(pkts) - 1)
        assert cuts[-1] == b"".join(pkts[:-1]) and asm.flush() == pkts[-1]
        assert asm.flush() is None
    with pytest.raises(ValueError, match="1206"):
        live.ScanAssembler().add(b"\x00" * 100)


def test_smoke_check_revolutions_rejects_foreign_and_missing_packets(stream):
    """chip_smoke.py's phase-8 check on TINY packets: the packets as sent
    pass; a packet no scan encoded (at the azimuth of the one it replaces),
    or one packet short, fails."""
    per_scan, packets, _, _ = stream
    assert smoke.check_revolutions(packets, packets, per_scan) == [6] * N_SCANS
    foreign = _make_vlp16_packet(live.packet_azimuth_centideg(packets[7]), 5000)
    for bad_received in (packets[:7] + [foreign] + packets[8:], packets[:-1]):
        with pytest.raises(AssertionError, match="not the packets sent"):
            smoke.check_revolutions(bad_received, packets, per_scan)
    with pytest.raises(AssertionError, match="revolution 1"):
        smoke.check_revolutions(packets[:7] + [foreign] + packets[8:],
                                packets[:7] + [foreign] + packets[8:], per_scan)


def _make_vlp16_packet(az_centideg: int, range_mm: int, stamp_us: int = 0) -> bytes:
    """tests/test_native.py's synthetic packet: all channels at one range."""
    pkt = b""
    for b in range(12):
        block = struct.pack("<BBH", 0xFF, 0xEE, (az_centideg + b * 40) % 36000)
        for _ in range(32):  # 2 sequences x 16 channels
            block += struct.pack("<HB", range_mm // 2, 100)  # 2 mm units
        pkt += block
    pkt += struct.pack("<I", stamp_us) + b"\x37\x22"
    assert len(pkt) == 1206
    return pkt


def test_vlp16_decode_geometry_matches_jax(lib):
    """tests/test_native.py's geometry checks, and the decode bitwise the
    JAX package's."""
    pkt = _make_vlp16_packet(az_centideg=0, range_mm=10000)
    xyz, inten, ring, t = native.decode_vlp16_packets(pkt)
    assert xyz.shape[0] == 12 * 2 * 16
    np.testing.assert_allclose(np.linalg.norm(xyz, axis=1), 10.0, atol=0.05)
    for r, elev in ((0, -15.0), (15, 15.0)):
        pts = xyz[ring == r]
        got = np.degrees(np.arcsin(pts[:, 2] / np.linalg.norm(pts, axis=1)))
        np.testing.assert_allclose(got, elev, atol=0.1)
    assert np.all(inten == 100.0) and t[-1] > t[0] and ring.dtype == np.int32
    if jnative.available():
        for a, b in zip((xyz, inten, ring, t), jnative.decode_vlp16_packets(pkt)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="multiple of 1206"):
        native.decode_vlp16_packets(pkt[:-1])


def test_vlp16_zero_range_skipped(lib):
    xyz, inten, ring, t = native.decode_vlp16_packets(_make_vlp16_packet(0, 0))
    assert xyz.shape == (0, 3) and inten.shape == ring.shape == t.shape == (0,)


def test_read_pcd_fields_matches_pcd_module(lib, tmp_path, rng):
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    nrm = rng.normal(size=(200, 3)).astype(np.float32)
    path = str(tmp_path / "t.pcd")
    pcd.write_pcd(path, xyz, nrm)
    out = native.read_pcd_fields(path, ["x", "y", "z", "normal_y"])
    ref = pcd.read_pcd(path)
    for f in ("x", "y", "z", "normal_y"):
        np.testing.assert_allclose(out[f], ref[f], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["normal_y"], nrm[:, 1], atol=1e-5)


def test_run_live_matches_jax_run_live(stream):
    """The same packet list through the JAX run_live (JAX engine, JAX
    decoder) and the port's (port engine on the CPU, port decoder)."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")
    _, packets, n, poses = stream
    jodo_ = jodo.LidarOdometry(JTINY)
    jposes = []
    jn = jlive.run_live(jodo_, iter(packets), flush_partial=True,
                        on_scan=lambda i, t, d: jposes.append(jodo_.get_current_pose()))
    assert n == jn == N_SCANS
    t, q = np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses])
    jt = np.stack([np.asarray(p[0]) for p in jposes])
    jq = np.stack([np.asarray(p[1]) for p in jposes])
    assert np.abs(t[-1]).max() > 0.01  # the estimate moves
    np.testing.assert_allclose(t, jt, atol=1e-5, rtol=0)
    np.testing.assert_allclose(q, jq, atol=1e-6, rtol=0)


def _sender(packets, port):
    """chip_smoke.py's sender as an unpaced thread: it sends `packets` to
    127.0.0.1:port once `started` is set (by the listener's first stop()
    call, after its bind). Returns (thread, started)."""
    th, started, _ = smoke.start_sender(packets, port, rate=float("inf"), process=False)
    return th, started


def test_udp_loopback_matches_socket_free_run(stream):
    """The live loop over a real UDP socket: the listener binds, then
    releases the sender from its first stop() call; the last revolution
    comes from the flush. Same trajectory as the socket-free run."""
    _, packets, n, poses = stream
    port = smoke.free_udp_port()
    th, started = _sender(packets, port)
    odo = odometry.LidarOdometry(TINY, device="cpu")
    got = []
    m = live.run_live(odo, live.udp_packets("127.0.0.1", port, timeout_s=1.0,
                                            stop=lambda: started.set() or False),
                      on_scan=lambda i, t, d: got.append(t), flush_partial=True)
    th.join(10.0)
    assert m == n == N_SCANS
    np.testing.assert_allclose(np.stack(got), np.stack([p[0] for p in poses]), atol=1e-6, rtol=0)


def test_cli_live_on_the_cpu(stream, tmp_path, capsys, monkeypatch):
    """`live --device cpu` under TINY: one JSON line per scan, a TUM of the
    scans it processed (the last revolution waits for a next scan that
    never comes), equal to the socket-free run."""
    _, packets, _, poses = stream
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(dataclasses.asdict(TINY)))
    port = smoke.free_udp_port()
    th, started = _sender(packets, port)
    bound = live.udp_packets
    monkeypatch.setattr(live, "udp_packets", lambda *a, **kw: bound(
        *a, stop=lambda: started.set() or False, **kw))
    out = str(tmp_path / "live.tum")
    cli.main(["--config", str(cfg), "live", "--host", "127.0.0.1", "--port", str(port),
              "--idle-timeout", "1", "--device", "cpu", "--out", out])
    th.join(10.0)
    captured = capsys.readouterr()
    assert f"processed {N_SCANS - 1} scans" in captured.err
    assert sum(line.startswith("{") for line in captured.err.splitlines()) == N_SCANS - 1
    assert f"wrote {out} ({N_SCANS - 1} poses)" in captured.out
    stamps, t, q = read_tum(out)
    assert np.all(np.diff(stamps) > 0) and os.path.exists(out)
    np.testing.assert_allclose(t, np.stack([p[0] for p in poses[:N_SCANS - 1]]), atol=1e-6)
    np.testing.assert_allclose(q, np.stack([p[1] for p in poses[:N_SCANS - 1]]), atol=1e-6)


def test_cli_live_runs_on_the_card_by_default(monkeypatch):
    """Without --device, `live` asks for "cuda"; with no card that raises
    before any socket is opened."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(live, "udp_packets", lambda *a, **kw: pytest.fail("socket opened"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["live", "--port", "1", "--idle-timeout", "0.2", "--quiet"])
