"""The plain reference: LiDAR odometry with the semantics of the port's
`OdometryConfig`, in plain torch, written from the algorithm's description
(the upstream node's processCloud, src/lidar_odometry.cpp:22-77, with the
port's documented beyond-reference options) and not from the port's code.
It imports nothing of the port or of the JAX package, and takes nothing
the port made: the benchmark hands it the same generated scans.

Per scan: time-normalise, deskew at constant velocity, LOAM planar
classification on the R x W range image, range filter, two first-point
voxel downsamples (0.1 m update, 0.3 m match; the `budget` smallest keys
kept), point-to-plane ICP (Huber IRLS, four Gauss-Newton steps per
correspondence round, translation prior, Levenberg damping; rounds to
convergence, stall or cap; the best pose on a non-converged exit; the
candidates of the 27 voxels around each query gathered once at the guess),
the angular divergence guard, then radius eviction, rebase and insertion
of the update points into the capped voxel map (first 20 points per
voxel; the C smallest voxel keys kept at overflow).

The map keeps voxels by absolute index in a sorted int64 key, with
variable-length tensors (host reads allowed: this is no graph). Point
rotations are matrix products and the normal equations J^T W J, as one
writes them in plain torch, so the precision of float32 matrix products
(TF32 off, `torch.backends.cuda.matmul.allow_tf32`) is what this reference
is computed at; the benchmark's control turns TF32 on.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# the map's key window: voxel x / y within +-512 of the origin voxel, z
# within +-128, packed 11 / 11 / 9 bits (out-of-range voxels are dropped)
XB, YB, ZB = 11, 11, 9
XOFF, YOFF, ZOFF = 1 << (XB - 1), 1 << (YB - 1), 1 << (ZB - 1)
GHALF, ZHALF = 512, 128
# (dx, dy) order of the 3 x 3 neighbour columns (voxel_grid.h:175-177)
COLUMNS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
_BIAS = 1 << 20


def abs_key(v: torch.Tensor) -> torch.Tensor:
    """Absolute voxel indices (..., 3) -> int64 keys, ordered as (x, y, z)
    lexicographically."""
    v = v.to(torch.int64) + _BIAS
    return (v[..., 0] << 42) | (v[..., 1] << 21) | v[..., 2]


def key_voxel(k: torch.Tensor) -> torch.Tensor:
    """abs_key's inverse."""
    m = (1 << 21) - 1
    return torch.stack([(k >> 42) & m, (k >> 21) & m, k & m], -1) - _BIAS


def in_key_range(rel: torch.Tensor, map_window: bool) -> torch.Tensor:
    """Voxels (..., 3) relative to the origin that the packed key holds;
    map_window: also within the keyframe map's window."""
    rx, ry, rz = rel[..., 0] + XOFF, rel[..., 1] + YOFF, rel[..., 2] + ZOFF
    ok = ((rx >= 0) & (rx < (1 << XB) - 1) & (ry >= 0) & (ry < (1 << YB) - 1)
          & (rz >= 0) & (rz < (1 << ZB) - 1))
    if map_window:
        ok = ok & ((rz >= ZOFF - ZHALF) & (rz < ZOFF + ZHALF)
                   & (rx >= XOFF - GHALF) & (rx < XOFF + GHALF)
                   & (ry >= YOFF - GHALF) & (ry < YOFF + GHALF))
    return ok


def voxel_of(xyz: torch.Tensor, size: float) -> torch.Tensor:
    """Voxel index by truncation toward zero of an IEEE division."""
    return torch.trunc(xyz / torch.tensor(size, dtype=xyz.dtype, device=xyz.device)).to(
        torch.int64)


# ---------------------------------------------------------------- rotations
# A pose's algebra (quaternions wxyz, the 6 x 6 solve) runs on the host in
# NumPy float32: a handful of numbers per step. Per-point work runs on the
# device in torch.

F32 = np.float32


def qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], F32)


def qconj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]], F32)


def qnormalize(q):
    return (q / max(F32(np.sqrt(np.sum(q * q, dtype=F32))), F32(1e-12))).astype(F32)


def qrotate(q, v):
    """v rotated by the unit quaternion q: v + 2w (u x v) + 2 u x (u x v)."""
    u, w = q[1:], q[0]
    uv = np.cross(u, v).astype(F32)
    return (v + F32(2.0) * (w * uv + np.cross(u, uv))).astype(F32)


def qmatrix(q):
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]], F32)


def qexp(w):
    """Rotation vector -> unit quaternion (sinc's Taylor series near 0)."""
    th2 = np.sum(w * w, dtype=F32)
    if th2 < 1e-12:
        return np.concatenate([[F32(1.0) - th2 / F32(8.0)], (F32(0.5) - th2 / F32(48.0)) * w]).astype(F32)
    th = np.sqrt(th2)
    return np.concatenate([[np.cos(F32(0.5) * th)], np.sin(F32(0.5) * th) / th * w]).astype(F32)


def euler_xyz_deg(R):
    """|Eigen's R.eulerAngles(0, 1, 2)| in degrees (lidar_odometry.cpp:54-58)."""
    a0 = np.arctan2(R[1, 2], R[2, 2])
    c2 = np.sqrt(R[0, 0] ** 2 + R[0, 1] ** 2)
    if a0 > 0:
        a0, c2 = a0 - np.pi, -c2
    a1 = np.arctan2(-R[0, 2], c2)
    s1, c1 = np.sin(a0), np.cos(a0)
    a2 = np.arctan2(s1 * R[2, 0] - c1 * R[1, 0], c1 * R[1, 1] - s1 * R[2, 1])
    return np.abs(np.array([a0, a1, a2])) * (180.0 / np.pi)


def slerp_points(q0, t):
    """Eigen's slerp from q0 to the identity at per-point times t (on the
    device), linear for nearly equal ends."""
    q1 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=t.device)
    q0 = torch.as_tensor(q0, device=t.device)
    d = q0[0]
    t = t[:, None]
    if abs(float(d)) >= 1.0 - 1e-7:
        s0, s1 = 1.0 - t, t
    else:
        th = torch.arccos(torch.clamp(d.abs(), -1.0, 1.0))
        s0, s1 = torch.sin((1.0 - t) * th) / torch.sin(th), torch.sin(t * th) / torch.sin(th)
    s1 = -s1 if float(d) < 0 else s1
    q = s0 * q0 + s1 * q1
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)


def rotate_each(q, v):
    """Points v (N, 3) rotated by per-point unit quaternions q (N, 4)."""
    u, w = q[:, 1:], q[:, :1]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def rotate_points(p: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Points (N, 3) rotated by a rotation matrix on the device, as a matrix
    product."""
    return p @ R.T


def pose_on(device, t, q):
    """A host pose -> (R (3, 3), t (3,)) on the device, in one copy."""
    x = torch.from_numpy(np.concatenate([qmatrix(q).reshape(-1), t]).astype(F32)).to(device)
    return x[:9].view(3, 3), x[9:]


def on(device, x):
    """A host float32 array -> a device tensor."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(device)


# ---------------------------------------------------------------- the map

class VoxelMap(NamedTuple):
    """keys (n,) sorted absolute voxel keys; pts, nrm (n, K, 3) the stored
    points and normals, first arrivals first (pts[:, 0] the eviction
    anchor); cnt (n,); origin (3,) the rebased origin voxel."""

    keys: torch.Tensor
    pts: torch.Tensor
    nrm: torch.Tensor
    cnt: torch.Tensor
    origin: torch.Tensor


def empty_map(K: int, device) -> VoxelMap:
    z = torch.zeros((0, K, 3), dtype=torch.float32, device=device)
    return VoxelMap(torch.zeros(0, dtype=torch.int64, device=device), z, z.clone(),
                    torch.zeros(0, dtype=torch.int64, device=device),
                    torch.zeros(3, dtype=torch.int64, device=device))


def _runs(sorted_keys: torch.Tensor):
    """(first index of each run, run length, rank of each element in its run)."""
    n = sorted_keys.shape[0]
    new = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    new[1:] = sorted_keys[1:] != sorted_keys[:-1]
    start = torch.nonzero(new)[:, 0]
    length = torch.diff(torch.cat([start, start.new_tensor([n])]))
    run_of = torch.cumsum(new.to(torch.int64), 0) - 1
    rank = torch.arange(n, device=sorted_keys.device) - start[run_of]
    return start, length, rank, run_of


def map_update(m: VoxelMap, xyz: torch.Tensor, nrm: torch.Tensor, center: torch.Tensor,
               cfg) -> VoxelMap:
    """Radius eviction and rebase at `center`, then insertion of world
    points xyz (N, 3) with normals (the upstream's radiusCleanup + addCloud,
    one pass): voxels whose first point lies beyond the cleanup range or
    outside the rebased window go; each incoming voxel appends its first
    points up to K (a new voxel's first point its anchor); the C smallest
    keys stay."""
    K, C, vs = cfg.keyframe_max_points_cnt, cfg.map_capacity, cfg.keyframe_voxel_size
    origin = voxel_of(center, vs)
    r2 = cfg.keyframe_cleanup_range * cfg.keyframe_cleanup_range
    d = m.pts[:, 0] - center
    keep = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]) <= r2) & in_key_range(
        key_voxel(m.keys) - origin, map_window=True)
    keys, pts, nrm_o, cnt = m.keys[keep], m.pts[keep].clone(), m.nrm[keep].clone(), m.cnt[keep].clone()

    vox = voxel_of(xyz, vs)
    ok = in_key_range(vox - origin, map_window=True)
    k_in = abs_key(vox[ok])
    order = torch.argsort(k_in, stable=True)
    sk, sp, sn = k_in[order], xyz[ok][order], nrm[ok][order]
    if sk.numel():
        start, length, rank, run_of = _runs(sk)
        gkey = sk[start]
        pos = torch.searchsorted(keys, gkey)
        found = pos < keys.numel()
        found[found.clone()] = keys[pos[found]] == gkey[found]
        # points of voxels already in the map: appended after their count
        f_el = found[run_of]
        row = pos[run_of]
        lane = rank.clone()
        if keys.numel():
            lane += torch.where(f_el, cnt[torch.clamp_max(row, keys.numel() - 1)], 0)
        put = f_el & (lane < K)
        pts[row[put], lane[put]] = sp[put]
        nrm_o[row[put], lane[put]] = sn[put]
        cnt[pos[found]] = torch.clamp_max(cnt[pos[found]] + length[found], K)
        # new voxels: their first K points
        fresh = ~found
        idx = torch.cumsum(fresh.to(torch.int64), 0) - 1
        n_new = int(fresh.sum())
        p_new = pts.new_zeros((n_new, K, 3))
        n_new_nrm = pts.new_zeros((n_new, K, 3))
        put = ~f_el & (rank < K)
        p_new[idx[run_of[put]], rank[put]] = sp[put]
        n_new_nrm[idx[run_of[put]], rank[put]] = sn[put]
        keys = torch.cat([keys, gkey[fresh]])
        pts = torch.cat([pts, p_new])
        nrm_o = torch.cat([nrm_o, n_new_nrm])
        cnt = torch.cat([cnt, torch.clamp_max(length[fresh], K)])
        order = torch.argsort(keys)[:C]
        keys, pts, nrm_o, cnt = keys[order], pts[order], nrm_o[order], cnt[order]
    return VoxelMap(keys, pts, nrm_o, cnt, origin)


# ---------------------------------------------------------------- preprocessing

def deskew(xyz, tn, start_t, start_q, forward: bool):
    """Undo the motion within the scan at constant velocity: each point
    moved by the start pose (the last scan's relative motion, inverted)
    slerped to the identity at its normalised time."""
    q_t = slerp_points(start_q, tn)
    w = (1.0 - tn) if forward else tn
    return rotate_each(q_t, xyz) + on(xyz.device, start_t) * w[:, None]


def planar_points(xyz, ring, valid, cfg):
    """LOAM planar features of the (R, W) range image (cloud_classifier.h:
    17-168): (points (R W, 3), normals, planar mask) in image order."""
    R, W = cfg.num_rings, cfg.scan_width
    dev = xyz.device
    az = torch.atan2(-xyz[:, 1], xyz[:, 0]) + math.pi
    col = torch.floor(torch.abs(az * W / torch.tensor(2.0 * math.pi, device=dev))).to(torch.int64)
    ok = valid & (col < W) & (ring >= 0) & (ring < R)
    cell = torch.where(ok, ring.to(torch.int64) * W + col, R * W)
    last = torch.full((R * W + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, cell, torch.arange(xyz.shape[0], device=dev), "amax")
    last = last[:R * W]
    img = torch.where((last >= 0)[:, None], xyz[last.clamp_min(0)], 0.0)        # (R W, 3)
    k = cfg.curvature_window
    acc = -img * (2.0 * k + 1.0)
    for w in range(-k, k + 1):
        acc = acc + torch.roll(img, -w, 0)
    r2 = torch.sum(img * img, -1)
    curv = torch.linalg.vector_norm(acc, dim=-1) / torch.where(r2 > 0, r2, 1.0)
    idx = torch.arange(R * W, device=dev)
    curv = torch.where((r2 < cfg.min_valid_range_sq) | (idx < k) | (idx >= R * W - k),
                       cfg.curvature_invalid_value, curv).reshape(R, W)
    flat = curv < cfg.flatness_threshold
    nflat = curv < cfg.flatness_threshold * cfg.neighbor_flatness_factor
    pts = img.reshape(R, W, 3)
    prev_pts, prev_flat = torch.roll(pts, 1, 0), torch.roll(nflat, 1, 0)
    k = cfg.normals_window

    def first_flat(offsets):
        pt, found = torch.zeros_like(pts), torch.zeros_like(flat)
        for off in offsets:
            cf = torch.roll(prev_flat, -off, 1)
            pt = torch.where((cf & ~found)[..., None], torch.roll(prev_pts, -off, 1), pt)
            found = found | cf
        return pt, found

    left, lf = first_flat(range(-k, 0))
    right, rf = first_flat(range(k, 0, -1))
    normal = torch.linalg.cross(left - pts, right - pts, dim=-1)
    nn = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.where(nn > 0, nn, 1.0)
    rows = torch.arange(R, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    planar = flat & lf & rf & (rows >= 1) & (cols >= k) & (cols < W - k) & (nn[..., 0] > 0)
    return img, normal.reshape(R * W, 3), planar.reshape(R * W)


def downsample(xyz, nrm, mask, size: float, budget: int):
    """First point (in input order) of each voxel of the grid, the
    `budget` smallest voxel keys kept, in key order."""
    vox = voxel_of(xyz, size)
    ok = mask & in_key_range(vox, map_window=False)
    keys = abs_key(vox[ok])
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    start = _runs(sk)[0][:budget] if sk.numel() else order[:0]
    src = torch.nonzero(ok)[:, 0][order[start]]
    return xyz[src], nrm[src]


# ---------------------------------------------------------------- ICP

class Candidates(NamedTuple):
    """Each query's candidate points of the 27 voxels around it at the
    guess, in (column, z, k) order: pts (Q, 27 K, 3), their map rows and
    lanes, and which exist."""

    pts: torch.Tensor
    row: torch.Tensor
    lane: torch.Tensor
    ok: torch.Tensor


def gather_candidates(m: VoxelMap, q_world: torch.Tensor, cfg) -> Candidates:
    K = cfg.keyframe_max_points_cnt
    dev = q_world.device
    v = voxel_of(q_world, cfg.keyframe_voxel_size)
    off = torch.tensor([(dx, dy, dz) for dx, dy in COLUMNS for dz in (-1, 0, 1)], device=dev)
    nk = abs_key(v[:, None, :] + off[None])                                       # (Q, 27)
    pos = torch.searchsorted(m.keys, nk)
    pos_c = torch.clamp_max(pos, max(m.keys.numel() - 1, 0))
    here = (pos < m.keys.numel()) & (m.keys[pos_c] == nk) if m.keys.numel() else pos < 0
    lane = torch.arange(K, device=dev)
    ok = here[..., None] & (lane < m.cnt[pos_c][..., None])                       # (Q, 27, K)
    Q = q_world.shape[0]
    return Candidates(m.pts[pos_c].reshape(Q, 27 * K, 3),
                      pos_c[..., None].expand(Q, 27, K).reshape(Q, 27 * K),
                      lane.expand(Q, 27, K).reshape(Q, 27 * K), ok.reshape(Q, 27 * K))


def match(m: VoxelMap, cand: Candidates, q_world: torch.Tensor, max_d2: float):
    """The nearest candidate under the strict distance gate, the first of
    equals in (column, z, k) order: (plane point, its normal, valid)."""
    d = cand.pts - q_world[:, None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(cand.ok & (d2 < max_d2), d2, math.inf)
    best = torch.argmin(d2, dim=1)
    valid = torch.gather(d2, 1, best[:, None])[:, 0] < max_d2
    ar = torch.arange(q_world.shape[0], device=q_world.device)
    o = cand.pts[ar, best]
    n = m.nrm[cand.row[ar, best], cand.lane[ar, best]]
    v = valid[:, None]
    return torch.where(v, o, 0.0), torch.where(v, n, 0.0), valid


def normal_equations(src, o, n, valid, R, t, delta_h, rp=None):
    """[H (6, 6) | b (6,)] as one (6, 7) product, of the Huber-weighted
    point-to-plane residuals at the pose (R, t on the device),
    J_i = [(R p_i) x n_i, n_i]."""
    rp = rotate_points(src, R) if rp is None else rp
    e = (rp + t - o) * n
    r = e[:, 0] + e[:, 1] + e[:, 2]
    a = r.abs()
    w = torch.where(valid, torch.where(a <= delta_h, 1.0, delta_h / torch.clamp_min(a, 1e-30)),
                    0.0)
    J = torch.cat([torch.linalg.cross(rp, n, dim=-1), n], -1)
    return (J * w[:, None]).T @ torch.cat([J, r[:, None]], -1)


def solve_step(H, b, t, q, guess_t, cfg):
    """One damped Gauss-Newton step from H, b (host float32): the
    translation prior NormalPrior(diag(1/sigma)) on t - guess, relative
    Levenberg damping, a Cholesky solve, the left-multiplicative update.
    Returns (t, q, |delta|)."""
    pw = F32(1.0 / cfg.icp_translation_prior_sigma) ** 2
    H = H + np.diag(np.array([0, 0, 0, pw, pw, pw], F32))
    b = b + pw * np.concatenate([np.zeros(3, F32), t - guess_t])
    H = H + F32(cfg.icp_damping) * np.diag(np.diag(H)) + F32(1e-9) * np.eye(6, dtype=F32)
    L = np.linalg.cholesky(H.astype(F32))
    delta = -np.linalg.solve(L.T, np.linalg.solve(L, b.astype(F32))).astype(F32)
    return ((t + delta[3:]).astype(F32), qnormalize(qmul(qexp(delta[:3]), q)),
            F32(np.sqrt(np.sum(delta * delta, dtype=F32))))


class IcpStats(NamedTuple):
    rounds: int
    matches: int
    present_slices: int   # voxels found among the 27 of the valid queries
    candidates: int       # points stored in them


def align(m: VoxelMap, src: torch.Tensor, guess_t, guess_q, cfg):
    """ICP from the guess (cloud_matcher.cpp:105-178 with the config's
    stall and best-pose exits): (t, q, stats), the pose on the host."""
    dev = src.device
    max_d2 = float(F32(cfg.icp_max_correspondence_distance * cfg.icp_max_correspondence_distance))
    delta_h = cfg.icp_huber_delta
    tol = F32(cfg.icp_convergence_step_norm)
    Rg, tg = pose_on(dev, guess_t, guess_q)
    cand = gather_candidates(m, rotate_points(src, Rg) + tg, cfg)
    t, q = guess_t, guess_q
    best = (guess_t, guess_q, 0)
    best_cost, stall, i, not_conv, step = F32(1e9), 0, 0, True, F32(1e9)
    n_matches = 0
    while (i < cfg.icp_max_outer_iterations
           and (not_conv or i <= cfg.icp_min_outer_iterations - 1)
           and stall < cfg.icp_stall_exit_rounds):
        R, td = pose_on(dev, t, q)
        rp = rotate_points(src, R)
        o, n, valid = match(m, cand, rp + td, max_d2)
        res = torch.sum((rp + td - o) * n, -1)
        a = res.abs()
        hub = torch.where(a <= delta_h, 0.5 * res * res, delta_h * (a - 0.5 * delta_h))
        for k in range(cfg.icp_inner_iterations):
            if k:
                R, td = pose_on(dev, t, q)
            parts = [normal_equations(src, o, n, valid, R, td, delta_h,
                                      rp if k == 0 else None).reshape(-1)]
            if k == 0:
                parts += [torch.sum(torch.where(valid, hub, 0.0))[None],
                          valid.sum().to(torch.float32)[None]]
            got = torch.cat(parts).cpu().numpy()
            Hb = got[:42].reshape(6, 7)
            if k == 0:
                cost_sum, nv = got[42], int(got[43])
                cost = F32(cost_sum) / F32(max(nv, 1))
                n_matches = nv
                if cost < best_cost * F32(1.0 - cfg.icp_stall_rel_tolerance):
                    best, best_cost, stall = (t, q, n_matches), cost, 0
                else:
                    stall += 1
            t, q, step = solve_step(Hb[:, :6], Hb[:, 6], t, q, guess_t, cfg)
        i += 1
        not_conv = step >= tol
    if cfg.icp_best_pose_exit and step >= tol:
        t, q, n_matches = best
    found = cand.ok.reshape(-1, 27, cfg.keyframe_max_points_cnt)
    stats = IcpStats(i, n_matches, int(found[..., 0].sum()), int(found.sum()))
    return t, qnormalize(q), stats


# ---------------------------------------------------------------- the step

class ScanResult(NamedTuple):
    t: np.ndarray
    q: np.ndarray
    stats: IcpStats | None


class Odometry:
    """The reference's state and its per-scan step."""

    def __init__(self, cfg, device):
        if not cfg.icp_cached_candidates:
            raise NotImplementedError("the reference gathers ICP candidates once per scan "
                                      "(icp_cached_candidates) only")
        self.cfg, self.device = cfg, torch.device(device)
        self.reset()

    def reset(self):
        self.map = empty_map(self.cfg.keyframe_max_points_cnt, self.device)
        self.cur_t, self.cur_q = np.zeros(3, F32), np.array([1, 0, 0, 0], F32)
        self.prev_t, self.prev_q = self.cur_t, self.cur_q

    def step(self, xyz, time, ring, valid) -> ScanResult:
        """One raw scan (padded device arrays; valid marks the points)."""
        cfg = self.cfg
        tv = time[valid]
        t0, t1 = tv.min(), tv.max()
        tn = (time - t0) / torch.where(t1 - t0 > 0, t1 - t0, 1.0)
        # the last scan's relative motion r = prev^-1 cur; the guess cur r
        iq = qconj(self.prev_q)
        rel_q = qmul(iq, self.cur_q)
        rel_t = qrotate(iq, self.cur_t - self.prev_t)
        start_q = qconj(rel_q)
        des = deskew(xyz, tn, qrotate(start_q, -rel_t), start_q, cfg.deskew_forward_translation)
        img, nrm, planar = planar_points(des, ring, valid, cfg)
        r2 = torch.sum(img * img, -1)
        planar = planar & (r2 >= cfg.lidar_min_range ** 2) & (r2 <= cfg.lidar_max_range ** 2)
        up_x, up_n = downsample(img, nrm, planar, cfg.keyframe_update_voxel_size,
                                cfg.max_update_points)
        q_x, _ = downsample(img, nrm, planar, cfg.keyframe_matching_voxel_size,
                            cfg.max_match_points)
        guess_t = (self.cur_t + qrotate(self.cur_q, rel_t)).astype(F32)
        guess_q = qmul(self.cur_q, rel_q)
        stats = None
        if self.map.keys.numel() == 0:
            t, q = self.cur_t, self.cur_q
        else:
            t, q, stats = align(self.map, q_x, guess_t, guess_q, cfg)
            ang = euler_xyz_deg(qmatrix(qmul(q, qconj(self.cur_q))))
            thr = cfg.angular_divergence_threshold
            if not bool(np.all((ang < thr) | (ang > 180.0 - thr))):
                t, q = guess_t, guess_q
        R, td = pose_on(self.device, t, q)
        self.map = map_update(self.map, rotate_points(up_x, R) + td, rotate_points(up_n, R),
                              td, cfg)
        self.prev_t, self.prev_q = self.cur_t, self.cur_q
        self.cur_t, self.cur_q = t, q
        return ScanResult(t, q, stats)
