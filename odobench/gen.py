"""Traffic generation: simulated drives of a spinning multi-beam LiDAR
(the VLP16 unless the configuration names its sensor), made on the card
from a seed.

A copy of the port's NumPy simulator (lidar_odometry_demo_tpu_torch/io/
simulator.py: `World.urban`, `simulate_sequence`, `encode_vlp16_packets`)
with the ray cast rewritten in torch: every ray of every scan of a drive is
cast at once (in chunks of scans), in float64 as the NumPy version casts.
The random draws (the world's boxes, the range noise) stay NumPy's, drawn
in bulk in the order the NumPy version draws them, so a drive here is the
NumPy drive of the same seed (test_odobench_traffic.py holds the two
together).

The sensor is its beam table: R elevations, lowest ring first, each cast
at W azimuths a scan (`elevation_deg`; None is the VLP16's 16 beams from
-15 to +15 degrees, the NumPy version's only sensor). At R = 16 with the
VLP16's table every draw and every output bit is the NumPy version's.

A drive comes out as padded scans with a leading scan axis, the layout of
the port's `LidarScan`: xyz (S, N, 3) float32, intensity, ring (int32),
time and valid (S, N), points in the NumPy version's order (ring-major,
then column, hits only), N = the config's `max_raw_points`. A VLP16 drive
made with its range images can be encoded as VLP16 packets
(`encode_packets`, a vectorised `encode_vlp16_packets`), the input of a
live mix (none is a cell yet).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

K_SEQ_S = 55.296e-6   # VLP16 firing-sequence period
PACKET_BYTES = 1206


def vlp16_elevation_deg() -> np.ndarray:
    """The VLP16's 16 beam elevations, lowest first (degrees)."""
    return np.linspace(-15.0, 15.0, 16)


class Motion(NamedTuple):
    """One drive's motion and sensor: a constant-curvature path whose speed
    ramps from rest (the NumPy `simulate_sequence` arguments)."""

    speed: float = 5.0
    yaw_rate: float = 0.08
    ramp_time: float = 2.0
    max_range: float = 80.0
    sensor_height: float = 1.8
    scan_period: float = 0.1
    range_noise: float = 0.004
    num_boxes: int = 40
    extent: float = 120.0


class Drive(NamedTuple):
    """Padded scans (S, N, ...) on the device, and the range images (S, R,
    W) float64 (inf where a beam has no return) when asked for."""

    xyz: torch.Tensor
    intensity: torch.Tensor
    ring: torch.Tensor
    time: torch.Tensor
    valid: torch.Tensor
    range_image: torch.Tensor | None


def drive_seed(seed: int, index: int) -> int:
    """The NumPy seed of drive `index` of a run with `seed` (any whole
    number >= 0, however large)."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1)[0])


def urban_boxes(seed: int, num_boxes: int = 40, extent: float = 120.0) -> np.ndarray:
    """The NumPy `World.urban(seed)`'s boxes (B, 6): xmin xmax ymin ymax
    zmin zmax, the driving corridor |y| <= 6 kept clear."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (num_boxes, 2))
    centers = centers[np.abs(centers[:, 1]) > 6.0]
    sizes = rng.uniform(3.0, 14.0, (centers.shape[0], 2))
    heights = rng.uniform(3.0, 12.0, centers.shape[0])
    return np.stack([centers[:, 0] - sizes[:, 0] / 2, centers[:, 0] + sizes[:, 0] / 2,
                     centers[:, 1] - sizes[:, 1] / 2, centers[:, 1] + sizes[:, 1] / 2,
                     np.zeros_like(heights), heights], axis=-1).astype(np.float64)


def _arc_length(t: torch.Tensor, m: Motion) -> torch.Tensor:
    if m.ramp_time <= 0.0:
        return m.speed * t
    return torch.where(t < m.ramp_time, m.speed * t * t / (2.0 * m.ramp_time),
                       m.speed * (t - 0.5 * m.ramp_time))


def _yaw_xy(t: torch.Tensor, m: Motion):
    """(yaw, x, y) of the path at times t (float64)."""
    s = _arc_length(t, m)
    if abs(m.yaw_rate) > 1e-9 and m.speed > 0:
        r = m.speed / m.yaw_rate
        yaw = s / r
        return yaw, r * torch.sin(yaw), r * (1.0 - torch.cos(yaw))
    return torch.zeros_like(t), s, torch.zeros_like(t)


def _ray_ranges(origins: torch.Tensor, dirs: torch.Tensor, boxes: torch.Tensor,
                max_range: float) -> torch.Tensor:
    """Nearest hit of rays (..., 3) against the ground plane z = 0 and the
    boxes (slab method), inf where none within max_range: the NumPy
    `_ray_hits`, operation for operation."""
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dirs.device)
    dz = dirs[..., 2]
    t_g = -origins[..., 2] / dz
    t_best = torch.where((dz < -1e-9) & (t_g > 0.05), torch.minimum(inf, t_g), inf)
    inv = 1.0 / dirs
    for b in boxes:
        t1 = (b[0::2] - origins) * inv
        t2 = (b[1::2] - origins) * inv
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        hit = (tmax >= tmin) & (tmax > 0.05) & (tmin > 0.05)
        t_best = torch.where(hit, torch.minimum(t_best, tmin), t_best)
    return torch.where(t_best <= max_range, t_best, inf)


def simulate_drive(seed: int, num_scans: int, width: int, capacity: int, motion: Motion,
                   device, first_scan: int = 0, with_range_image: bool = False,
                   chunk: int = 25, elevation_deg=None) -> Drive:
    """Scans first_scan .. first_scan + num_scans - 1 of the NumPy
    `simulate_sequence(num_scans, width, seed, speed, yaw_rate, ...)`
    drive, padded to `capacity` points, on `device`; the beams of
    `elevation_deg` (R degrees, lowest first; None: the VLP16's)."""
    m = motion
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    table = (vlp16_elevation_deg() if elevation_deg is None
             else np.asarray(elevation_deg, np.float64))
    R = table.shape[0]
    boxes = torch.as_tensor(urban_boxes(seed, m.num_boxes, m.extent), **f64)
    rng = np.random.default_rng(seed + 100)
    noise_all = rng.normal(0, m.range_noise, ((first_scan + num_scans) * R, width))
    noise_all = noise_all[first_scan * R:].reshape(num_scans, R, width)
    elev = torch.as_tensor(np.deg2rad(table), **f64)
    az = (torch.arange(width, **f64) + 0.5) * (2 * np.pi / width)
    dir_ring = torch.stack([torch.cos(elev)[:, None] * torch.cos(az)[None, :],
                            -torch.cos(elev)[:, None] * torch.sin(az)[None, :],
                            torch.sin(elev)[:, None] * torch.ones_like(az)[None, :]], -1)
    frac = torch.arange(width, **f64) / width
    n_pts = R * width
    if n_pts > capacity:
        raise ValueError(f"{n_pts} beams per scan do not fit {capacity} points")
    out = {k: [] for k in ("xyz", "time", "ring", "valid", "range_image")}
    ring_of = torch.arange(R, dtype=torch.int32, device=dev)[:, None].expand(R, width)
    for c0 in range(0, num_scans, chunk):
        s = torch.arange(first_scan + c0, first_scan + min(c0 + chunk, num_scans), **f64)
        t0 = s * m.scan_period                                          # (S,)
        col_time = t0[:, None] + frac[None, :] * m.scan_period          # (S, W)
        yaw0 = _yaw_xy(t0, m)[0]
        yaw1 = _yaw_xy(t0 + m.scan_period, m)[0]
        # the rotation's slerp between the scan's end poses: for the path's
        # rotations about z, the yaw interpolated linearly
        tau = (col_time - t0[:, None]) / m.scan_period
        yaw_c = yaw0[:, None] + tau * (yaw1 - yaw0)[:, None]
        _, px, py = _yaw_xy(col_time, m)
        origins = torch.stack([px, py, torch.full_like(px, m.sensor_height)], -1)  # (S, W, 3)
        cy, sy = torch.cos(yaw_c)[:, None], torch.sin(yaw_c)[:, None]           # (S, 1, W)
        d = dir_ring[None]                                                       # (1, R, W, 3)
        d_world = torch.stack([cy * d[..., 0] - sy * d[..., 1],
                               sy * d[..., 0] + cy * d[..., 1],
                               d[..., 2].expand(cy.shape[0], R, width)], -1)
        ranges = _ray_ranges(origins[:, None].expand_as(d_world), d_world, boxes,
                             m.max_range)                                        # (S, R, W)
        hit = torch.isfinite(ranges)
        noise = torch.as_tensor(noise_all[c0:c0 + s.shape[0]], **f64)
        ranges = ranges + noise
        image = torch.where(hit, ranges, float("inf"))
        pts = (dir_ring[None] * ranges[..., None]).to(torch.float32)            # (S, R, W, 3)
        rel_t = (col_time - t0[:, None]).to(torch.float32)                       # (S, W)
        S = s.shape[0]
        flat_hit = hit.reshape(S, n_pts)
        order = torch.argsort((~flat_hit).to(torch.int8), dim=-1, stable=True)
        count = flat_hit.sum(-1, keepdim=True)
        pad = capacity - n_pts
        keep = torch.arange(n_pts, device=dev)[None, :] < count

        def compact(x, fill=0):
            x = torch.gather(x.reshape(S, n_pts, *x.shape[3:]), 1,
                             order.reshape(S, n_pts, *([1] * (x.dim() - 3))).expand(
                                 S, n_pts, *x.shape[3:]))
            x = torch.where(keep.reshape(S, n_pts, *([1] * (x.dim() - 2))), x, fill)
            return torch.cat([x, x.new_full((S, pad, *x.shape[2:]), fill)], 1)

        out["xyz"].append(compact(pts))
        out["time"].append(compact(rel_t[:, None, :].expand(S, R, width)))
        out["ring"].append(compact(ring_of[None].expand(S, R, width)))
        out["valid"].append(torch.cat([keep, keep.new_zeros((S, pad))], 1))
        if with_range_image:
            out["range_image"].append(image)
    cat = {k: torch.cat(v) if v else None for k, v in out.items()}
    return Drive(xyz=cat["xyz"], intensity=torch.where(cat["valid"], 10.0, 0.0).to(torch.float32),
                 ring=cat["ring"], time=cat["time"], valid=cat["valid"],
                 range_image=cat["range_image"])


def channel_of_ring() -> np.ndarray:
    """VLP16 channel of each ring (rings by elevation; channels interleaved:
    even = lower fan, odd = upper fan)."""
    ch_of_ring = np.empty(16, np.int64)
    for ch in range(16):
        ch_of_ring[ch // 2 if ch % 2 == 0 else 8 + (ch - 1) // 2] = ch
    return ch_of_ring


def encode_packets(range_image: np.ndarray, first_scan: int, scan_period: float,
                   intensity: int = 10) -> np.ndarray:
    """Range images (S, 16, W) -> raw VLP16 data packets (S, P, 1206)
    uint8, P = ceil(W / 24): the NumPy `encode_vlp16_packets(image[s],
    (first_scan + s) * scan_period)` of every scan, vectorised."""
    S, n_rings, width = range_image.shape
    if n_rings != 16:
        raise ValueError("VLP16 range images have 16 rings")
    P = -(-width // 24)
    r = range_image
    ok = np.isfinite(r) & (r > 0)
    rng_2mm = np.where(ok, np.round(np.where(ok, r, 0.0) / 0.002), 0).astype(np.uint16)
    inten = np.where(ok, intensity, 0).astype(np.uint8)
    cols = P * 24
    rec = np.zeros((S, cols, 16, 3), np.uint8)   # per column, per channel: range lo, hi, intensity
    ch = channel_of_ring()
    rec[:, :width, ch, 0] = (rng_2mm & 0xFF).transpose(0, 2, 1)
    rec[:, :width, ch, 1] = (rng_2mm >> 8).transpose(0, 2, 1)
    rec[:, :width, ch, 2] = inten.transpose(0, 2, 1)
    az_deg = ((np.arange(width) + 0.5) * (360.0 / width) + 90.0) % 360.0
    c0 = np.arange(P)[:, None] * 24 + np.arange(12)[None, :] * 2                 # (P, 12)
    az = (np.round(az_deg[np.minimum(c0, width - 1)] * 100).astype(np.int64) % 36000)
    pkt = np.zeros((S, P, PACKET_BYTES), np.uint8)
    blocks = pkt[:, :, :1200].reshape(S, P, 12, 100)
    blocks[..., 0] = 0xFF
    blocks[..., 1] = 0xEE
    blocks[..., 2] = (az & 0xFF)[None]
    blocks[..., 3] = (az >> 8)[None]
    blocks[..., 4:] = rec.reshape(S, P, 12, 2 * 16 * 3)
    scan_start = (first_scan + np.arange(S)) * scan_period
    t_pkt = scan_start[:, None] + np.arange(P)[None, :] * 24 * K_SEQ_S
    stamp = np.round(t_pkt * 1e6).astype(np.int64).astype("<u4")
    pkt[..., 1200:1204] = stamp.view(np.uint8).reshape(S, P, 4)
    pkt[..., 1204] = 0x37
    pkt[..., 1205] = 0x22
    return pkt


