"""Live VLP16 ingestion: UDP packets -> scan assembly -> odometry online
(port of the JAX ``io/live.py``).

The reference's L4 is a live per-message loop: the ROS velodyne driver
assembles 1206-byte data packets into one-revolution PointCloud2 scans and
`onPointCloudCallback` runs the pipeline per scan (reference
src/lidar_odometry_node.cpp:45-108). This module is the standalone
analogue: a UDP listener (the VLP16 itself emits UDP to port 2368) feeds a
revolution assembler; each completed revolution is decoded on the host by
the native C++ packet decoder (io/native.py, native/lidar_native.cpp
ln_vlp16_decode) and handed to the port's `LidarOdometry`, which runs on
the card unless it was built for another device.

Scan cutting follows the velodyne driver: packets accumulate until the
azimuth has swept a full 360 degrees from the first packet of the scan
(each block header carries the azimuth in centidegrees at offset 2).
"""

from __future__ import annotations

import socket
import struct
from typing import Callable, Iterator

import numpy as np

PACKET_SIZE = 1206
_AZ = struct.Struct("<H")


def packet_azimuth_centideg(pkt: bytes) -> int:
    """Azimuth of the packet's first block (centidegrees, 0..35999)."""
    return _AZ.unpack_from(pkt, 2)[0]


class ScanAssembler:
    """Accumulates VLP16 data packets into one-revolution scans.

    add(packet) returns the completed revolution's packet buffer (bytes)
    when `packet` STARTS a new revolution (the velodyne driver's cut: the
    azimuth sweep since the scan's first packet reaches 360 deg), else
    None. The cutting packet begins the next scan.
    """

    def __init__(self):
        self._packets: list[bytes] = []
        self._swept = 0.0      # centidegrees swept since scan start
        self._last_az: int | None = None

    def add(self, pkt: bytes) -> bytes | None:
        if len(pkt) != PACKET_SIZE:
            raise ValueError(f"VLP16 data packets are {PACKET_SIZE} bytes, got {len(pkt)}")
        az = packet_azimuth_centideg(pkt)
        done = None
        if self._last_az is not None:
            delta = (az - self._last_az) % 36000
            # UDP does not keep order: a late packet whose azimuth sits
            # slightly BEHIND the previous one wraps to a near-full sweep
            # and would cut the revolution early. Reordering displaces
            # azimuth by a few packets at most (one packet spans well under
            # 1 deg at 10 Hz), so only deltas within 2 deg of a full wrap
            # count as reordering; a real forward gap (a burst of drops)
            # still accumulates and cuts the revolution on schedule.
            if delta > 35800:
                delta = 0
            self._swept += delta
            if self._swept >= 36000.0 and self._packets:
                done = b"".join(self._packets)
                self._packets = []
                self._swept = 0.0
        self._last_az = az
        self._packets.append(pkt)
        return done

    def flush(self) -> bytes | None:
        """Return the partial scan accumulated so far (stream end)."""
        if not self._packets:
            return None
        out = b"".join(self._packets)
        self._packets = []
        self._swept = 0.0
        self._last_az = None
        return out


def scans_from_packet_stream(packets: Iterator[bytes],
                             flush_partial: bool = True) -> Iterator[bytes]:
    """Iterate complete revolutions from a stream of 1206-byte packets."""
    asm = ScanAssembler()
    for pkt in packets:
        done = asm.add(pkt)
        if done is not None:
            yield done
    if flush_partial:
        tail = asm.flush()
        if tail is not None:
            yield tail


def udp_packets(host: str = "0.0.0.0", port: int = 2368, *,
                timeout_s: float | None = None,
                stop: Callable[[], bool] | None = None) -> Iterator[bytes]:
    """Yield VLP16 data packets from a UDP socket (the sensor's native
    transport: the VLP16 unicasts 1206-byte payloads to port 2368).

    Stops on `timeout_s` of silence or when `stop()` returns True (checked
    between packets; its first call comes after the socket is bound).
    """
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind((host, port))
    sock.settimeout(0.2)
    try:
        silent = 0.0
        while True:
            if stop is not None and stop():
                return
            try:
                data, _ = sock.recvfrom(2048)
            except socket.timeout:
                silent += 0.2
                if timeout_s is not None and silent >= timeout_s:
                    return
                continue
            silent = 0.0
            if len(data) == PACKET_SIZE:
                yield data
    finally:
        sock.close()


def run_live(odo, packet_iter: Iterator[bytes],
             on_scan: Callable[[int, np.ndarray, object], None] | None = None,
             max_scans: int | None = None, decode_capacity: int = 1 << 20,
             flush_partial: bool = False) -> int:
    """Drive a LidarOdometry engine from a live packet stream.

    For each completed revolution: native-decode to XYZIRT on the host, run
    `odo.process_cloud` (one upload per array), read the pose back (the
    loop's one synchronisation with the device), then call
    `on_scan(i, translation, diag)`. Returns the number of scans processed.
    Skips empty revolutions.
    """
    from lidar_odometry_demo_tpu_torch.io import native

    n = 0
    for scan_bytes in scans_from_packet_stream(packet_iter, flush_partial=flush_partial):
        xyz, inten, ring, t = native.decode_vlp16_packets(scan_bytes, capacity=decode_capacity)
        if xyz.shape[0] == 0:
            continue
        diag = odo.process_cloud(xyz, inten, ring, t)
        t_now = odo.get_current_pose()[0]
        if on_scan is not None:
            on_scan(n, t_now, diag)
        n += 1
        if max_scans is not None and n >= max_scans:
            break
    return n
