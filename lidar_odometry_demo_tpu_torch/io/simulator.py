"""Synthetic VLP16 world simulator (host-side NumPy).

The reference ships a single PCD fixture and expects live VLP16 data over
ROS (reference README.md:10-12, test/test_data); its large test scan is
absent from this mount (.MISSING_LARGE_BLOBS). This module generates
equivalent data with known ground truth: a procedural urban-ish world
(ground plane + axis-aligned boxes) raycast from a VLP16 beam pattern
(16 rings at -15..+15 deg, `width` azimuth steps) along a continuous
trajectory, producing XYZIRT scans — including intra-scan motion so the
deskew path is exercised — plus ground-truth poses for ATE evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from scipy.spatial.transform import Rotation, Slerp


@dataclass
class World:
    """Ground plane at z=0 plus axis-aligned boxes [xmin xmax ymin ymax zmin zmax]."""

    boxes: np.ndarray  # (B, 6)

    @staticmethod
    def urban(seed: int = 0, num_boxes: int = 40, extent: float = 120.0) -> "World":
        rng = np.random.default_rng(seed)
        centers = rng.uniform(-extent, extent, (num_boxes, 2))
        # keep a driving corridor along the x axis clear
        centers = centers[np.abs(centers[:, 1]) > 6.0]
        sizes = rng.uniform(3.0, 14.0, (centers.shape[0], 2))
        heights = rng.uniform(3.0, 12.0, centers.shape[0])
        boxes = np.stack(
            [
                centers[:, 0] - sizes[:, 0] / 2, centers[:, 0] + sizes[:, 0] / 2,
                centers[:, 1] - sizes[:, 1] / 2, centers[:, 1] + sizes[:, 1] / 2,
                np.zeros_like(heights), heights,
            ],
            axis=-1,
        )
        return World(boxes=boxes.astype(np.float64))


def _ray_hits(origins: np.ndarray, dirs: np.ndarray, world: World, max_range: float):
    """Vectorized nearest-hit of rays against ground plane + boxes.

    origins, dirs: (N, 3). Returns ranges (N,) (inf when no hit).
    """
    n = origins.shape[0]
    t_best = np.full(n, np.inf)

    # ground plane z=0 (hit only from above, ray pointing down)
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_g = -origins[:, 2] / dz
    ok = (dz < -1e-9) & (t_g > 0.05)
    t_best = np.where(ok, np.minimum(t_best, t_g), t_best)

    # boxes via slab method
    for b in world.boxes:
        lo = np.array([b[0], b[2], b[4]])
        hi = np.array([b[1], b[3], b[5]])
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs
        t1 = (lo[None, :] - origins) * inv
        t2 = (hi[None, :] - origins) * inv
        tmin = np.max(np.minimum(t1, t2), axis=-1)
        tmax = np.min(np.maximum(t1, t2), axis=-1)
        hit = (tmax >= tmin) & (tmax > 0.05) & (tmin > 0.05)
        t_best = np.where(hit, np.minimum(t_best, tmin), t_best)

    t_best = np.where(t_best <= max_range, t_best, np.inf)
    return t_best


@dataclass
class ScanStream:
    """A simulated drive: scans (list of dicts) + ground-truth poses."""

    scans: list = field(default_factory=list)
    gt_t: np.ndarray = None   # (S, 3) pose at scan END (time=1 point)
    gt_q: np.ndarray = None   # (S, 4) wxyz


def simulate_sequence(
    num_scans: int = 50,
    width: int = 900,
    seed: int = 0,
    speed: float = 2.0,
    yaw_rate: float = 0.05,
    max_range: float = 80.0,
    sensor_height: float = 1.8,
    scan_period: float = 0.1,
    range_noise: float = 0.004,
    ramp_time: float = 2.0,
) -> ScanStream:
    """Simulate a VLP16 drive with intra-scan motion.

    The sensor moves along a gently curving path; each scan's beams are cast
    from the interpolated pose at their per-column time, so raw clouds are
    skewed exactly the way a spinning lidar's are. Per-point `time` is the
    raw in-scan timestamp (seconds) — the pipeline's time normalization
    (reference point_time_normalize.h) sees realistic input.

    The drive accelerates from rest to `speed` over `ramp_time` seconds
    (constant-curvature path), like a real vehicle. Starting at full speed
    (ramp_time=0) makes the first inter-scan displacement speed*scan_period
    — at 5 m/s that is 0.5 m, beyond the odometry's 0.3 m correspondence
    gate (reference cloud_matcher.cpp:139) with a cold identity guess, an
    out-of-spec cold start for the reference algorithm itself (it assumes
    the constant-velocity prediction tracks, lidar_odometry.cpp:27-30).
    """
    rng = np.random.default_rng(seed + 100)
    world = World.urban(seed)
    elev = np.deg2rad(np.linspace(-15.0, 15.0, 16))  # VLP16 rings

    # continuous trajectory: constant-curvature path (kappa = yaw_rate/speed
    # so the steady-state yaw rate is `yaw_rate`), speed ramping linearly
    # from 0 to `speed` over `ramp_time` seconds. A constant-curvature path
    # is a circle in arc length s: yaw = kappa*s, x = r*sin(yaw),
    # y = r*(1-cos(yaw)) — exact for any speed profile.
    def _arc_length(t: float) -> float:
        if ramp_time <= 0.0:
            return speed * t
        if t < ramp_time:
            return speed * t * t / (2.0 * ramp_time)
        return speed * (t - 0.5 * ramp_time)

    def pose_at(t: float):
        s = _arc_length(t)
        if abs(yaw_rate) > 1e-9 and speed > 0:
            r = speed / yaw_rate  # 1/kappa
            yaw = s / r
            x = r * np.sin(yaw)
            y = r * (1.0 - np.cos(yaw))
        else:
            yaw = 0.0
            x, y = s, 0.0
        return np.array([x, y, sensor_height]), Rotation.from_euler("z", yaw)

    stream = ScanStream()
    gt_t, gt_q = [], []
    az = (np.arange(width) + 0.5) * (2 * np.pi / width)
    # beam azimuth in sensor frame: column c covers atan2(-y, x) = az
    # -> direction (cos(-az), sin(-az)) = (cos az, -sin az)
    dir_ring = np.stack(
        [
            np.cos(elev)[:, None] * np.cos(az)[None, :],
            -np.cos(elev)[:, None] * np.sin(az)[None, :],
            np.sin(elev)[:, None] * np.ones_like(az)[None, :],
        ],
        axis=-1,
    )  # (16, W, 3)

    for s in range(num_scans):
        t0 = s * scan_period
        col_time = t0 + (np.arange(width) / width) * scan_period  # (W,)
        # pose per column (position exact, rotation via slerp endpoints)
        p_start, r_start = pose_at(t0)
        p_end, r_end = pose_at(t0 + scan_period)
        sl = Slerp([t0, t0 + scan_period], Rotation.concatenate([r_start, r_end]))
        r_cols = sl(col_time)
        p_cols = np.stack([pose_at(tc)[0] for tc in col_time])  # (W, 3)

        xyz_rows, ring_rows, time_rows, inten_rows = [], [], [], []
        range_image = np.full((16, width), np.inf, np.float64)
        for ring in range(16):
            d_local = dir_ring[ring]  # (W, 3)
            d_world = r_cols.apply(d_local)
            ranges = _ray_hits(p_cols, d_world, world, max_range)
            hit = np.isfinite(ranges)
            ranges = ranges + rng.normal(0, range_noise, width)
            range_image[ring, hit] = ranges[hit]
            # point measured in the *sensor frame at its column time*
            pts_local = d_local * ranges[:, None]
            xyz_rows.append(pts_local[hit])
            ring_rows.append(np.full(hit.sum(), ring, np.int32))
            time_rows.append(col_time[hit] - t0)
            inten_rows.append(np.full(hit.sum(), 10.0, np.float32))

        # ...but a real lidar reports points in ONE frame: the frame of the
        # sensor at packet time == column time. Each column's points are
        # already in that column's sensor frame; the device streams them
        # as-is. The composite "scan" is therefore skewed: re-express all
        # points in the END-of-scan sensor frame is what deskew must undo.
        # We keep per-column frames (true VLP16 behavior).
        xyz = np.concatenate(xyz_rows).astype(np.float32)
        stream.scans.append(
            dict(
                xyz=xyz,
                intensity=np.concatenate(inten_rows),
                ring=np.concatenate(ring_rows),
                time=np.concatenate(time_rows).astype(np.float32),
                range_image=range_image,  # (16, W), inf = no return
                scan_start=t0,
            )
        )
        q = r_end.as_quat()  # xyzw
        gt_t.append(p_end)
        gt_q.append([q[3], q[0], q[1], q[2]])

    stream.gt_t = np.asarray(gt_t)
    stream.gt_q = np.asarray(gt_q)
    return stream


def encode_vlp16_packets(range_image: np.ndarray, scan_start: float,
                         intensity: int = 10) -> bytes:
    """Encode one scan's (16, W) range image as raw VLP16 data packets.

    Produces the wire format the reference consumes via the ROS velodyne
    driver (and that native/lidar_native.cpp:232-292 decodes): 1206-byte
    packets of 12 blocks x (0xFFEE, azimuth centideg, 32 x <range_2mm u16,
    intensity u8>) + a microsecond timestamp + factory bytes. Each block
    carries two firing sequences = two azimuth columns; channels are the
    interleaved Velodyne order (ring 0 = -15 deg = channel 0, ring 1 =
    channel 8, ...).

    Azimuth convention: the decoder maps azimuth az to x = r sin(az),
    y = r cos(az) (Velodyne +Y forward); the simulator's column c covers
    the sensor-frame angle atan2(-y, x) = az_c, so az = az_c + 90 deg.
    """
    import struct

    n_rings, width = range_image.shape
    assert n_rings == 16
    # channel of each ring (rings sorted by elevation; channels interleaved:
    # even = lower fan ring ch/2, odd = upper fan ring 8+(ch-1)/2)
    ch_of_ring = np.empty(16, np.int32)
    for ch in range(16):
        ring = ch // 2 if ch % 2 == 0 else 8 + (ch - 1) // 2
        ch_of_ring[ring] = ch

    az_c = (np.arange(width) + 0.5) * (360.0 / width)  # simulator column angle
    az_deg = (az_c + 90.0) % 360.0
    cols = []
    for c in range(width):
        rec = np.zeros((16, 2), np.int32)  # (channel,) -> [range_2mm, inten]
        for ring in range(16):
            r = range_image[ring, c]
            if np.isfinite(r) and r > 0:
                rec[ch_of_ring[ring], 0] = int(round(r / 0.002))
                rec[ch_of_ring[ring], 1] = intensity
        cols.append(rec)

    kSeqUs = 55.296e-6
    out = b""
    n_pkts = -(-width // 24)
    for p in range(n_pkts):
        pkt = b""
        t_pkt = scan_start + p * 24 * kSeqUs
        for b in range(12):
            c0 = p * 24 + b * 2
            az = az_deg[min(c0, width - 1)]
            pkt += struct.pack("<BBH", 0xFF, 0xEE, int(round(az * 100)) % 36000)
            for seq in range(2):
                c = c0 + seq
                rec = cols[c] if c < width else np.zeros((16, 2), np.int32)
                for ch in range(16):
                    pkt += struct.pack("<HB", int(rec[ch, 0]), int(rec[ch, 1]))
        pkt += struct.pack("<I", int(round(t_pkt * 1e6))) + b"\x37\x22"
        assert len(pkt) == 1206
        out += pkt
    return out


def sample_structured_cloud(
    seed: int = 0, n_per_plane: int = 1500
) -> tuple[np.ndarray, np.ndarray]:
    """Points + analytic normals sampled from a room-like plane arrangement.

    Stand-in for the reference MatchingTest fixture
    (test/test.cpp:191-263: a real scan + PCL NormalEstimation normals; the
    PCD is missing from the mount). Ground + 4 walls + 2 box faces give a
    well-constrained registration problem.
    """
    rng = np.random.default_rng(seed)
    planes = [
        # (origin, u, v, normal, extent_u, extent_v)
        ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), 20, 20),      # ground
        ((10, 0, 2.5), (0, 1, 0), (0, 0, 1), (-1, 0, 0), 20, 2.5),  # +x wall
        ((-10, 0, 2.5), (0, 1, 0), (0, 0, 1), (1, 0, 0), 20, 2.5),  # -x wall
        ((0, 10, 2.5), (1, 0, 0), (0, 0, 1), (0, -1, 0), 20, 2.5),  # +y wall
        ((0, -10, 2.5), (1, 0, 0), (0, 0, 1), (0, 1, 0), 20, 2.5),  # -y wall
        ((3, 2, 1.0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), 3, 1.0),    # box face
        ((-2, -4, 0.8), (1, 0, 0), (0, 0, 1), (0, 1, 0), 2.5, 0.8),  # box face
    ]
    pts, nrms = [], []
    for origin, u, v, n, eu, ev in planes:
        uu = rng.uniform(-eu / 2, eu / 2, n_per_plane)
        vv = rng.uniform(-ev / 2, ev / 2, n_per_plane)
        p = (
            np.asarray(origin)[None, :]
            + uu[:, None] * np.asarray(u)[None, :]
            + vv[:, None] * np.asarray(v)[None, :]
        )
        p = p + rng.normal(0, 0.004, p.shape)  # sensor-ish noise
        pts.append(p)
        nrms.append(np.tile(np.asarray(n, np.float64), (n_per_plane, 1)))
    return (
        np.concatenate(pts).astype(np.float32),
        np.concatenate(nrms).astype(np.float32),
    )
