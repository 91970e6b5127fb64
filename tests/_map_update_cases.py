"""Inputs of the keyframe map's update (kernels/map_update.py) for its
tests: map states and incoming points as numpy arrays made from a seed, and
the states a drive reaches. Shared by the CPU tests
(tests/test_torch_map_update.py) and the card tests
(tests/test_torch_kernels_card.py); imports neither JAX nor the card.

A map state holds the format v6 table (ops/voxel_map.py `_lanes`): sorted
unique keys with the EMPTY_KEY tail, each live row's points, normals,
count lane and anchor (its first point), and random bits in every other
lane and row, as a table that has lived through evictions holds stale
data there.
"""

from __future__ import annotations

import numpy as np

from lidar_odometry_demo_tpu_torch.ops.voxel_map import EMPTY_KEY, _lanes

CASES = ("first_insert", "saturated", "rebase_q1", "rebase_q4", "tombstone_reuse", "over_cap",
         "all_empty", "cleanup", "insert", "spatial")
VOXEL = 0.5
_XOFF, _YOFF, _ZOFF = 1 << 10, 1 << 10, 1 << 8


def pack(rel: np.ndarray) -> np.ndarray:
    """Keys of voxel indices relative to the origin (pack_keys, in window)."""
    rx, ry, rz = (rel[:, 0] + _XOFF), (rel[:, 1] + _YOFF), (rel[:, 2] + _ZOFF)
    return ((rx << 20) | (ry << 9) | rz).astype(np.int32)


def points_in(rng, vox: np.ndarray) -> np.ndarray:
    """One float32 point inside each absolute voxel index (truncation toward
    zero), 0.2-0.8 of a voxel away from its faces."""
    off = np.where(vox >= 0, 1.0, -1.0) * rng.uniform(0.2, 0.8, vox.shape)
    return ((vox + off) * VOXEL).astype(np.float32)


def unit_normals(rng, n: int) -> np.ndarray:
    v = rng.normal(0, 1, (n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def map_state(rng, C: int, K: int, n_live: int, origin, spread: int, edge: int = 0) -> dict:
    """A map of `n_live` voxels (x, y within +-spread voxels of the origin,
    z within +-spread // 2; `edge` of them at the window's low x edge),
    counts 1..K, stale bits everywhere else."""
    origin = np.asarray(origin, np.int32)
    RW, MB, W = _lanes(K)
    tab = rng.integers(-(2 ** 31), 2 ** 31, (C, W), dtype=np.int64).astype(np.int32)
    keys = np.full(C, EMPTY_KEY, np.int32)
    count = np.zeros(C, np.int32)
    rel = set()
    while len(rel) < n_live - edge:
        rel.add((int(rng.integers(-spread, spread + 1)), int(rng.integers(-spread, spread + 1)),
                 int(rng.integers(-(spread // 2), spread // 2 + 1))))
    while len(rel) < n_live:
        rel.add((int(rng.integers(-512, -508)), int(rng.integers(-spread, spread + 1)),
                 int(rng.integers(-2, 3))))
    rel = np.array(sorted(rel), np.int32).reshape(-1, 3)
    k = pack(rel)
    order = np.argsort(k)
    rel, k = rel[order], k[order]
    n = len(k)
    keys[:n] = k
    count[:n] = rng.integers(1, K + 1, n)
    for i in range(n):
        c = count[i]
        pts = points_in(rng, np.repeat((rel[i] + origin)[None], c, 0))
        nrm = unit_normals(rng, c)
        for j in range(3):
            tab[i, j * K: j * K + c] = pts[:, j].view(np.int32)
        tab[i, 3 * K] = np.float32(c).view(np.int32)
        tab[i, RW: RW + 3 * c] = nrm.reshape(-1).view(np.int32)
        tab[i, MB: MB + 3] = pts[0].view(np.int32)
    return dict(tab=tab, keys=keys, count=count, origin=origin, K=K, rel=rel)


def empty_map(C: int, K: int) -> dict:
    """map_init's state."""
    _, _, W = _lanes(K)
    return dict(tab=np.zeros((C, W), np.int32), keys=np.full(C, EMPTY_KEY, np.int32),
                count=np.zeros(C, np.int32), origin=np.zeros(3, np.int32), K=K,
                rel=np.zeros((0, 3), np.int32))


def incoming(rng, m: dict, n: int, *, old_share: float, spread: int, per_voxel: int,
             invalid: float = 0.1, outside: int = 0, old_rows=None) -> tuple:
    """n points (xyz, normal, valid): about `old_share` of them in the map's
    voxels (`old_rows` where given), the rest in new voxels within +-spread
    of the origin, up to `per_voxel` points a voxel, `outside` points beyond
    the map window, `invalid` of them not valid."""
    origin = m["origin"]
    vox = []
    while sum(len(v) for v in vox) < n:
        if len(m["rel"]) and rng.random() < old_share:
            rows = np.arange(len(m["rel"])) if old_rows is None else old_rows
            rel = m["rel"][rng.choice(rows)]
        else:
            rel = rng.integers(-spread, spread + 1, 3)
            rel[2] //= 2
        vox.append(np.repeat((rel + origin)[None], rng.integers(1, per_voxel + 1), 0))
    vox = np.concatenate(vox)[:n]
    if outside:
        vox[rng.choice(n, outside, replace=False), 0] += 2000
    vox = vox[rng.permutation(n)]
    valid = rng.random(n) >= invalid
    return points_in(rng, vox), unit_normals(rng, n), valid


def make_case(name: str, seed: int) -> dict:
    """One lane of case `name`: the map (tab, keys, count, origin, K), the
    world points (xyz, normal, valid), center and radius (None for an
    insert), origin_quantum, owner (rank, size) or None."""
    rng = np.random.default_rng(seed)
    C, K, q, owner = 512, 4, 1, None
    origin = rng.integers(-40, 40, 3).astype(np.int32)
    shift = np.zeros(3)
    radius = 60.0
    if name == "first_insert":
        m = empty_map(C, K)
        origin = m["origin"]
        pts = incoming(rng, m, 300, old_share=0.0, spread=30, per_voxel=7)
    elif name == "saturated":  # full table, evictions, more new voxels than room
        C = 256
        m = map_state(rng, C, K, C, origin, 24)
        radius = 10.0
        pts = incoming(rng, m, 400, old_share=0.3, spread=24, per_voxel=3, outside=5)
    elif name in ("rebase_q1", "rebase_q4", "spatial"):  # the window's edge leaves the map
        q = 1 if name == "rebase_q1" else 4
        owner = (1, 4) if name == "spatial" else None
        m = map_state(rng, C, K, 300, origin, 30, edge=12)
        shift = np.array([7.3, -5.6, 1.2])
        pts = incoming(rng, m, 300, old_share=0.4, spread=30, per_voxel=4, outside=3)
    elif name == "tombstone_reuse":  # a small radius, evicted voxels touched again
        m = map_state(rng, C, K, 300, origin, 30)
        radius = 7.0
        far = np.flatnonzero(np.abs(m["rel"][:, :2]).max(axis=1) > 20)
        pts = incoming(rng, m, 300, old_share=0.7, spread=30, per_voxel=3, old_rows=far)
    elif name == "over_cap":  # groups beyond K into rows of K - 1 and K points
        m = map_state(rng, C, K, 200, origin, 20)
        m["count"][:200:2] = K
        m["count"][1:200:2] = K - 1
        _fix_count_lanes(m)
        pts = incoming(rng, m, 400, old_share=0.5, spread=20, per_voxel=12)
    elif name == "all_empty":
        m = map_state(rng, C, K, 300, origin, 30)
        radius = 12.0
        xyz, nrm, _ = incoming(rng, m, 200, old_share=0.5, spread=30, per_voxel=3)
        pts = (xyz, nrm, np.zeros(200, bool))
    elif name == "cleanup":  # radius_cleanup: no incoming points
        m = map_state(rng, C, K, 300, origin, 30)
        radius = 12.0
        shift = np.array([2.6, 1.1, 0.0])
        pts = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32), np.zeros(0, bool))
    elif name == "insert":  # map_insert: the origin kept, nothing evicted
        m = map_state(rng, C, K, 300, origin, 30)
        pts = incoming(rng, m, 300, old_share=0.4, spread=30, per_voxel=6, outside=4)
        radius = None
    else:
        raise ValueError(name)
    center = None if radius is None else (
        ((m["origin"] + shift + 0.5) * VOXEL).astype(np.float32))
    xyz, nrm, valid = pts
    return dict(tab=m["tab"], keys=m["keys"], count=m["count"], origin=m["origin"], K=K,
                xyz=xyz, normal=nrm, valid=valid, center=center, radius=radius, quantum=q,
                owner=owner)


def _fix_count_lanes(m: dict) -> None:
    """Rewrite the count lane of every live row from m["count"]."""
    K = m["K"]
    live = m["keys"] != EMPTY_KEY
    m["tab"][live, 3 * K] = m["count"][live].astype(np.float32).view(np.int32)


def stack_lanes(cases: list) -> dict:
    """Lanes of one case name (equal shapes), as one case with a lane axis."""
    out = dict(cases[0])
    for f in ("tab", "keys", "count", "origin", "xyz", "normal", "valid"):
        out[f] = np.stack([c[f] for c in cases])
    if out["center"] is not None:
        out["center"] = np.stack([c["center"] for c in cases])
    if out.get("pose") is not None:
        out["pose"] = tuple(np.stack([c["pose"][i] for c in cases]) for i in range(2))
    return out


def lanes_with_an_empty_map(seed: int, B: int = 8, empty_lane: int = 3) -> dict:
    """B lanes of 'over_cap'-sized updates, lane `empty_lane` on an empty
    map (a fleet's lane before its first scan's insert)."""
    cases = [make_case("rebase_q1", seed + b) for b in range(B)]
    e = empty_map(512, 4)
    cases[empty_lane] = dict(cases[empty_lane], tab=e["tab"], keys=e["keys"], count=e["count"])
    return stack_lanes(cases)


def torch_args(c: dict, device) -> tuple:
    """(map, points, keyword arguments of kernels/map_update.py's
    map_update) of a case, on `device`."""
    from types import SimpleNamespace

    import torch

    from lidar_odometry_demo_tpu_torch.ops.cloud import PointsWithNormals
    from lidar_odometry_demo_tpu_torch.ops.se3 import Pose
    from lidar_odometry_demo_tpu_torch.ops.voxel_map import VoxelMap

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    lead = c["keys"].shape[:-1]
    m = VoxelMap(tab=t(c["tab"]), keys=t(c["keys"]), count=t(c["count"]), origin=t(c["origin"]),
                 kdim=torch.zeros((*lead, 1, c["K"]), dtype=torch.int32, device=device))
    new = PointsWithNormals(xyz=t(c["xyz"]), normal=t(c["normal"]), valid=t(c["valid"]))
    owner = None if c["owner"] is None else SimpleNamespace(rank=c["owner"][0],
                                                            size=c["owner"][1])
    pose = None if c.get("pose") is None else Pose(t(c["pose"][0]), t(c["pose"][1]))
    kwargs = dict(voxel_size=c.get("voxel", VOXEL),
                  center=None if c["center"] is None else t(c["center"]), radius=c["radius"],
                  origin_quantum=c["quantum"], pose=pose, owner=owner)
    return m, new, kwargs


def drive_states(cfg, n_scans: int, seed: int, device) -> list:
    """The map update's arguments at each scan of a simulated drive (5 m/s,
    0.08 rad/s) through the port's eager step on `device`, recorded as
    numpy: the map, the update points in the scan frame, the pose (t, q),
    center and radius; scan 0's insert into the empty map first."""
    import torch

    from lidar_odometry_demo_tpu_torch.io.simulator import simulate_sequence
    from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy
    from lidar_odometry_demo_tpu_torch.pipeline import odometry

    drive = simulate_sequence(num_scans=n_scans, width=cfg.scan_width, seed=seed, speed=5.0,
                              yaw_rate=0.08, ramp_time=0.0)
    step = odometry.make_process_scan(cfg)
    state = odometry.init_state(cfg, device)
    recorded = []
    original = odometry.update_map

    def host(t):
        return t.detach().cpu().numpy().copy()

    def record(m, new, *, pose, **kwargs):
        recorded.append(dict(tab=host(m.tab), keys=host(m.keys), count=host(m.count),
                             origin=host(m.origin), K=m.max_points, xyz=host(new.xyz),
                             normal=host(new.normal), valid=host(new.valid),
                             pose=(host(pose.t), host(pose.q)), center=host(kwargs["center"]),
                             radius=kwargs["radius"], quantum=kwargs["origin_quantum"],
                             owner=None, voxel=kwargs["voxel_size"]))
        return original(m, new, pose=pose, **kwargs)

    odometry.update_map = record
    try:
        for s in drive.scans:
            scan = scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                                   cfg.max_raw_points, device)
            state, _ = step(state, scan)
    finally:
        odometry.update_map = original
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return recorded
