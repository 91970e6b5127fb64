"""Inputs of the step's front end (kernels/prepare.py) for its tests: drive
scans and edge-case scans, as numpy arrays made from a seed, with the pose
pairs (previous, current) they are deskewed between. Shared by the CPU tests
(tests/test_torch_prepare.py) and the card tests
(tests/test_torch_kernels_card.py); imports neither JAX nor the card."""

from __future__ import annotations

import numpy as np

from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence

EDGE_CASES = ("still", "moving", "equal_time", "empty")

# a constant-velocity step of 0.5 m and 0.03 rad and its predecessor
MOVING = ((np.array([2.0, -1.0, 0.3]), np.array([0.03, 0.01, -0.02])),
          (np.array([2.5, -0.9, 0.31]), np.array([0.03, 0.012, 0.01])))


def quat(rotvec) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation vector, float32."""
    rv = np.asarray(rotvec, np.float64)
    th = np.linalg.norm(rv)
    axis = rv / th if th > 0 else np.zeros(3)
    return np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * axis]).astype(np.float32)


def pose(t, rotvec) -> tuple:
    return np.asarray(t, np.float32), quat(rotvec)


IDENTITY = (np.zeros(3, np.float32), np.array([1.0, 0.0, 0.0, 0.0], np.float32))


def drive_scans(cfg, n: int, seed: int) -> list:
    """(scan, previous, current) for scans 1 .. n-1 of a simulated drive at
    5 m/s (no ramp) turning at 0.08 rad/s, each deskewed between the ground
    truth of the two scans before it. A scan is a dict of the raw arrays
    padded to cfg.max_raw_points."""
    d = simulate_sequence(num_scans=n, width=cfg.scan_width, seed=seed, speed=5.0,
                          yaw_rate=0.08, ramp_time=0.0)
    gt = [(t.astype(np.float32), q.astype(np.float32)) for t, q in zip(d.gt_t, d.gt_q)]
    out = []
    for s in range(1, n):
        raw = d.scans[s]
        out.append((pad(cfg, raw["xyz"], raw["ring"], raw["time"]), gt[max(s - 2, 0)], gt[s - 1]))
    return out


def pad(cfg, xyz, ring, time, valid=None) -> dict:
    """Raw arrays padded to the configuration's capacity; `valid` defaults
    to every given point."""
    n, cap = len(xyz), cfg.max_raw_points
    if n > cap:
        raise ValueError(f"{n} points > capacity {cap}")
    out = dict(xyz=np.zeros((cap, 3), np.float32), intensity=np.zeros(cap, np.float32),
               ring=np.zeros(cap, np.int32), time=np.zeros(cap, np.float32),
               valid=np.zeros(cap, bool))
    out["xyz"][:n] = xyz
    out["ring"][:n] = ring
    out["time"][:n] = time
    out["valid"][:n] = True if valid is None else valid
    return out


def _row(W: int, ring: int, cols, rho: float, z: float, centre: int | None = None):
    """Points of one ring on a vertical cylinder of radius rho about the
    sensor, one in each of `cols`, a quarter column past the column's start
    (so each lands in its own column however the azimuth rounds); at column
    `centre` the point sits on the +x axis, (rho, 0, z)."""
    cols = np.asarray(cols)
    phi = (cols - W // 2 + 0.25) * (2 * np.pi / W)
    xyz = np.stack([rho * np.cos(phi), -rho * np.sin(phi), np.full(len(cols), z)], -1)
    if centre is not None:
        xyz[cols == centre] = (rho, 0.0, z)
    return xyz.astype(np.float32), np.full(len(cols), ring, np.int32), cols


class EdgeScan:
    """A scan built to reach the front end's edges (any configuration of
    16 rings and a width of at least 64), with the cells the tests look at:

    - cylinders of radius 4 m (rings 1-4) and 80 m (rings 9-12) over the 33
      columns about c0, the column of the +x axis (W/2 or next to it),
      planar, each with one point exactly at the range filter's bound:
      (4, 0, 0) in cell `at_min`, (80, 0, 0) in cell `at_max`;
    - two rings (6, 7) of points at random ranges over every column;
    - cells at both ends of the flattened image (ring 0 columns 0-7, ring
      15 the last eight);
    - three points in cell `shared`, the last in input order `winner_xyz`;
    - points of rings -1, 16 and 21 (`bad_xyz`), which go to no cell;
    - invalid points among the valid ones, and the padded tail.

    Times run with the azimuth over 0.1 s (`equal_time`: all 0.05)."""

    def __init__(self, cfg, seed: int = 0, equal_time: bool = False, empty: bool = False):
        R, W = cfg.num_rings, cfg.scan_width
        if R != 16 or W < 64:
            raise ValueError("the edge scan needs 16 rings and at least 64 columns")
        rng = np.random.default_rng(seed)
        # the column of a point on the +x axis, as float32 arithmetic finds it
        f32 = np.float32
        c0 = int(np.floor(f32(f32(np.pi) * f32(W)) / f32(2 * np.pi)))
        span = np.arange(c0 - 16, c0 + 17)
        parts = []
        for r, z in ((1, -0.8), (2, -0.4), (3, 0.0), (4, 0.4)):
            parts.append(_row(W, r, span, 4.0, z, c0))
        for r, z in ((9, -16.0), (10, -8.0), (11, 0.0), (12, 8.0)):
            parts.append(_row(W, r, span, 80.0, z, c0))
        for r in (6, 7):
            xyz, ring, cols = _row(W, r, np.arange(W), 1.0, 0.0)
            xyz[:, :2] *= rng.uniform(5.0, 30.0, (W, 1)).astype(np.float32)
            xyz[:, 2] = rng.uniform(-2.0, 2.0, W)
            parts.append((xyz, ring, cols))
        ends = np.arange(8)
        parts.append(_row(W, 0, ends, 12.0, -3.0))
        parts.append(_row(W, R - 1, W - 1 - ends, 15.0, 4.0))
        xyz = np.concatenate([p[0] for p in parts])
        ring = np.concatenate([p[1] for p in parts])
        cols = np.concatenate([p[2] for p in parts])
        # three points in one cell: one before the cylinder's, one after
        shared_col = c0 + 2
        first, _, _ = _row(W, 2, [shared_col], 4.3, -0.5)
        last, _, _ = _row(W, 2, [shared_col], 4.6, -0.3)
        xyz = np.concatenate([first, xyz, last])
        ring = np.concatenate([[2], ring, [2]]).astype(np.int32)
        cols = np.concatenate([[shared_col], cols, [shared_col]])
        # rings outside [0, R) on the cylinder's columns
        bad, _, _ = _row(W, 0, [c0 - 3, c0 + 5, c0 + 9], 4.0, 0.2)
        xyz = np.concatenate([xyz, bad])
        ring = np.concatenate([ring, [-1, R, R + 5]]).astype(np.int32)
        cols = np.concatenate([cols, [c0 - 3, c0 + 5, c0 + 9]])
        valid = np.ones(len(xyz), bool)
        # invalid points among the valid ones, away from the cells looked at
        loose = np.flatnonzero(np.isin(ring, (6, 7)))
        valid[rng.choice(loose, 16, replace=False)] = False
        if empty:
            valid[:] = False
        time = np.full(len(xyz), 0.05, np.float32) if equal_time else (
            (cols + 0.25) / W * 0.1).astype(np.float32)
        self.scan = pad(cfg, xyz, ring, time, valid)
        self.at_min = 3 * W + c0
        self.at_max = 11 * W + c0
        self.shared = 2 * W + shared_col
        self.winner_xyz = last[0]
        self.bad_xyz = bad


def edge_case(cfg, name: str):
    """(EdgeScan, previous, current) of one of EDGE_CASES: `still` at the
    identity (the deskew leaves every point as it is), `moving` between
    MOVING's poses, `equal_time` and `empty` moving too."""
    edge = EdgeScan(cfg, equal_time=name == "equal_time", empty=name == "empty")
    if name == "still":
        return edge, IDENTITY, IDENTITY
    (t0, r0), (t1, r1) = MOVING
    return edge, pose(t0, r0), pose(t1, r1)
