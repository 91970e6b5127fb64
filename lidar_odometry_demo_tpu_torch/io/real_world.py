"""Real-geometry VLP16 drives: splat a real point-cloud world along a
moving trajectory (port of the JAX ``io/real_world.py``; numpy, as there).

The synthetic simulator (io/simulator.py) raycasts a procedural box world.
This module produces multi-scan sequences from REAL geometry (the
reference's bundled BlenSor intersection scan, reference
test/test_data/intersection00056.pcd, 59,691 points; or any PCD) by Z-buffer
SPLATTING: for each scan, world points are projected into the VLP16 beam
grid (16 elevation rings x `width` azimuth columns) in the sensor frame and
the nearest range per cell wins. Intra-scan motion is modeled by splitting
the revolution into azimuth blocks, each projected from the pose
interpolated at its block time, so raw clouds are skewed like a real
spinning lidar's and the deskew path is exercised.

Splatting is the adjoint of raycasting against a point-sampled surface:
exact where the cloud densely samples surfaces, with dropout where sampling
is sparse, which the pipeline must tolerate anyway (real VLP16 returns drop
out too).

The fixture is read only from the C++ reference's checkout that the
environment variable LIDAR_ODOMETRY_REFERENCE_DIR names; with the variable
unset, REFERENCE_FIXTURE is None and load_fixture() returns None.
"""

from __future__ import annotations

import os

import numpy as np

from scipy.spatial.transform import Rotation

from lidar_odometry_demo_tpu_torch.io.simulator import ScanStream

REFERENCE_DIR = os.environ.get("LIDAR_ODOMETRY_REFERENCE_DIR")
REFERENCE_FIXTURE = (os.path.join(REFERENCE_DIR, "test", "test_data", "intersection00056.pcd")
                     if REFERENCE_DIR else None)

_ELEV = np.deg2rad(np.linspace(-15.0, 15.0, 16))  # VLP16 rings


def splat_scan(world_xyz: np.ndarray, poses_tq: list, width: int,
               max_range: float = 80.0, min_range: float = 1.0):
    """One revolution: project `world_xyz` (N, 3) into the (16, width)
    beam grid, nearest-per-cell; `poses_tq` is a list of
    (t (3,), R (3x3)) per azimuth block (len = n_blocks, equal spans).

    Returns (xyz (M,3) sensor-frame points at capture time, ring (M,),
    col (M,), time01 (M,) in-scan time fraction).
    """
    n_blocks = len(poses_tq)
    half_fan = np.deg2rad(30.0) / 16  # ring bin half-width (2 deg spacing)
    out_xyz, out_ring, out_col, out_t = [], [], [], []
    cols_per_block = width // n_blocks
    for b, (t, R) in enumerate(poses_tq):
        local = (world_xyz - t) @ R  # world -> sensor frame
        rng = np.linalg.norm(local, axis=1)
        ok = (rng > min_range) & (rng < max_range)
        local = local[ok]
        rng = rng[ok]
        elev = np.arcsin(np.clip(local[:, 2] / rng, -1, 1))
        ring = np.rint((elev - _ELEV[0]) / (_ELEV[1] - _ELEV[0])).astype(int)
        in_fan = (ring >= 0) & (ring < 16) & (
            np.abs(elev - _ELEV[np.clip(ring, 0, 15)]) < half_fan)
        # azimuth convention of the classifier/simulator:
        # col = floor((atan2(-y, x) + pi) * W / 2pi)
        az = np.arctan2(-local[:, 1], local[:, 0]) + np.pi
        col = np.floor(az * width / (2 * np.pi)).astype(int) % width
        # clamp the COLUMN side so the width % n_blocks remainder columns
        # fall into the last block (clamping b instead silently dropped
        # columns >= n_blocks * cols_per_block from every scan)
        sel = in_fan & (np.minimum(col // cols_per_block, n_blocks - 1) == b)
        local, rng, ring, col = local[sel], rng[sel], ring[sel], col[sel]
        # z-buffer: nearest point per (ring, col) cell
        cell = ring * width + col
        order = np.lexsort((rng, cell))
        cell_s, rng_s = cell[order], rng[order]
        first = np.ones(cell_s.shape[0], bool)
        first[1:] = cell_s[1:] != cell_s[:-1]
        keep = order[first]
        out_xyz.append(local[keep])
        out_ring.append(ring[keep])
        out_col.append(col[keep])
        out_t.append((col[keep] + 0.5) / width)
    return (np.concatenate(out_xyz).astype(np.float32),
            np.concatenate(out_ring).astype(np.int32),
            np.concatenate(out_col).astype(np.int32),
            np.concatenate(out_t).astype(np.float32))


def splat_sequence(world_xyz: np.ndarray, num_scans: int = 20,
                   width: int = 900, speed: float = 1.5,
                   yaw_rate: float = 0.03, scan_period: float = 0.1,
                   n_blocks: int = 8, start: np.ndarray | None = None,
                   sensor_height: float = 1.7) -> ScanStream:
    """Drive a constant-curvature path through `world_xyz`, splatting one
    revolution per scan with `n_blocks`-step intra-scan motion.

    Returns a ScanStream compatible with the simulator's (scans with
    xyz/intensity/ring/time + gt poses at scan end).
    """
    world_xyz = np.asarray(world_xyz, np.float64)
    if start is None:
        # start near the cloud centroid at sensor height above local ground
        c = np.median(world_xyz, axis=0)
        ground = np.percentile(world_xyz[:, 2], 5)
        start = np.array([c[0], c[1], ground + sensor_height])

    def pose_at(tm: float):
        # constant-curvature path in the xy plane
        yaw = yaw_rate * tm
        if abs(yaw_rate) > 1e-9:
            rr = speed / yaw_rate
            x = start[0] + rr * np.sin(yaw)
            y = start[1] + rr * (1 - np.cos(yaw))
        else:
            x, y = start[0] + speed * tm, start[1]
        t = np.array([x, y, start[2]])
        R = Rotation.from_euler("z", yaw).as_matrix()
        return t, R

    stream = ScanStream()
    gt_t, gt_q = [], []
    for s in range(num_scans):
        t0 = s * scan_period
        poses = [pose_at(t0 + (b + 0.5) / n_blocks * scan_period)
                 for b in range(n_blocks)]
        xyz, ring, col, t01 = splat_scan(world_xyz, poses, width)
        stream.scans.append(dict(
            xyz=xyz,
            intensity=np.full(xyz.shape[0], 10.0, np.float32),
            ring=ring,
            time=(t01 * scan_period).astype(np.float32),
            stamp=t0,
        ))
        te, Re = pose_at(t0 + scan_period)
        gt_t.append(te)
        q = Rotation.from_matrix(Re).as_quat()
        gt_q.append([q[3], q[0], q[1], q[2]])
    stream.gt_t = np.asarray(gt_t)
    stream.gt_q = np.asarray(gt_q)
    return stream


def load_fixture(path: str | None = REFERENCE_FIXTURE) -> np.ndarray | None:
    """The reference's intersection world cloud, or None if absent (or if
    no path is given and LIDAR_ODOMETRY_REFERENCE_DIR is unset).

    The BlenSor export is in a camera-style frame (y up: the raw extents
    are x in [-29, 45], y in [0.3, 4.6], z in [-63, 65]); remapped here
    to the z-up vehicle convention the pipeline uses: (x, y, z)_world =
    (x, z, y)_fixture."""
    if path is None or not os.path.exists(path):
        return None
    from lidar_odometry_demo_tpu_torch.io import pcd

    raw = pcd.read_pcd_xyz(path)
    return np.stack([raw[:, 0], raw[:, 2], raw[:, 1]], axis=1)
