"""SE(3) / quaternion geometry on tensors (port of the JAX ``ops/se3.py``).

Quaternions are (..., 4) tensors in (w, x, y, z) order; a `Pose` holds a
translation (..., 3) and a unit rotation quaternion (..., 4). Every function
broadcasts over leading batch dimensions (the batched path's lane axis)
and keeps the JAX package's arithmetic order, so results agree to float32
rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Pose(NamedTuple):
    """SE(3) pose: world_point = R(q) @ local_point + t."""

    t: torch.Tensor  # (..., 3)
    q: torch.Tensor  # (..., 4) wxyz, unit

    @staticmethod
    def identity(device) -> "Pose":
        return Pose(torch.zeros(3, device=device),
                    torch.tensor([1.0, 0.0, 0.0, 0.0], device=device))


def pose_where(pred: torch.Tensor, a: Pose, b: Pose) -> Pose:
    """Select pose `a` where the predicate holds, else `b`: one predicate
    per pose (a scalar, or (B,) over a lane axis)."""
    p = pred[..., None]
    return Pose(torch.where(p, a.t, b.t), torch.where(p, a.q, b.q))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross's formula, component by component."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def rot_pts(pts: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """pts @ R.T as element-wise float32 multiply-adds, never a matmul
    (the JAX package's `_rot_pts`: a TPU matmul rounds to bf16, and a
    Hopper one may take TF32). pts (..., N, 3) with R (3, 3), or one R
    per lane, (B, 3, 3) with pts (B, N, 3)."""
    return torch.stack(
        [pts[..., 0] * R[..., i, 0, None] + pts[..., 1] * R[..., i, 1, None]
         + pts[..., 2] * R[..., i, 2, None] for i in range(3)], dim=-1)


# ---------------------------------------------------------------------------
# quaternion primitives
# ---------------------------------------------------------------------------

def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp_min(norm(q, keepdim=True), eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4):
    v + 2*w*(u x v) + 2*(u x (u x v))."""
    u = q[..., 1:]
    w = q[..., :1]
    u, v = torch.broadcast_tensors(u, v)
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) of a unit quaternion."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def quat_from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """Unit quaternion for a rotation of `angle` radians about unit `axis`."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


def quat_exp(w: torch.Tensor) -> torch.Tensor:
    """so(3) exponential: rotation vector (..., 3) -> unit quaternion, with
    the sinc Taylor branch at ||w|| -> 0."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < 1e-12
    one = torch.ones_like(theta)
    k = torch.where(small, 0.5 - theta_sq / 48.0,
                    torch.sin(half) / torch.where(small, one, theta))
    cw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([cw, k * w], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (..., 3), the inverse of quat_exp,
    along the shortest path (w >= 0). At ||v|| < 1e-9 the small branch
    2 v / w applies, and the inner `where` keeps the division (and a
    forward-mode tangent through ||v|| at v = 0) finite."""
    w = q[..., :1]
    v = q[..., 1:]
    sign = torch.where(w < 0, -1.0, 1.0)
    w, v = w * sign, v * sign
    vn = norm(v, keepdim=True)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-9
    scale = torch.where(small, 2.0 / torch.clamp_min(w, 1e-12),
                        theta / torch.where(small, torch.ones_like(vn), vn))
    return v * scale


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Eigen-compatible slerp along the shortest arc, with the lerp branch
    for nearly aligned quaternions (reference cloud_transform.h:27)."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)[..., None]
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    abs_d = torch.abs(d)
    close = abs_d >= 1.0 - 1e-7
    theta = torch.arccos(torch.clamp(abs_d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    safe_sin = torch.where(close, torch.ones_like(sin_theta), sin_theta)
    scale0 = torch.where(close, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    scale1 = torch.where(close, t, torch.sin(t * theta) / safe_sin)
    scale1 = torch.where(d < 0, -scale1, scale1)
    return quat_normalize(scale0 * q0 + scale1 * q1)


# ---------------------------------------------------------------------------
# pose algebra (reference src/pose_3d.h:23-57)
# ---------------------------------------------------------------------------

def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: first apply b, then a."""
    return Pose(a.t + quat_rotate(a.q, b.t), quat_mul(a.q, b.q))


def inverse(p: Pose) -> Pose:
    qi = quat_conj(p.q)
    return Pose(quat_rotate(qi, -p.t), qi)


def relative_to(a: Pose, b: Pose) -> Pose:
    """a^-1 ∘ b."""
    return compose(inverse(a), b)


def transform_points(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """R @ pts + t over (..., N, 3)."""
    return quat_rotate(p.q[..., None, :], pts) + p.t[..., None, :]


def se3_exp(xi: torch.Tensor) -> Pose:
    """The solver's retraction: Pose(exp(omega), v) for xi = (omega, v)."""
    return Pose(xi[..., 3:], quat_exp(xi[..., :3]))


def apply_delta(p: Pose, xi: torch.Tensor) -> Pose:
    """Left-multiplicative update: R_new = exp(w) R, t_new = t + dt."""
    return Pose(p.t + xi[..., 3:], quat_normalize(quat_mul(quat_exp(xi[..., :3]), p.q)))


# ---------------------------------------------------------------------------
# Eigen-compatible eulerAngles(0,1,2) for the divergence guard
# ---------------------------------------------------------------------------

def euler_angles_xyz(R: torch.Tensor) -> torch.Tensor:
    """Eigen `mat.eulerAngles(0,1,2)` (reference lidar_odometry.cpp:54-58)."""
    def c(i, j):
        return R[..., i, j]

    res0_raw = torch.atan2(c(1, 2), c(2, 2))
    c2 = torch.sqrt(c(0, 0) ** 2 + c(0, 1) ** 2)
    flip = res0_raw > 0
    res0 = torch.where(flip, res0_raw - math.pi, res0_raw)
    res1 = torch.atan2(-c(0, 2), torch.where(flip, -c2, c2))
    s1, c1 = torch.sin(res0), torch.cos(res0)
    res2 = torch.atan2(s1 * c(2, 0) - c1 * c(1, 0), c1 * c(1, 1) - s1 * c(2, 1))
    return -torch.stack([res0, res1, res2], dim=-1)


def rotation_within_threshold(q_delta: torch.Tensor, threshold_deg) -> torch.Tensor:
    """True iff every eulerAngles(0,1,2) component of the delta rotation is
    within `threshold_deg` of 0 or of 180 degrees."""
    ang = torch.abs(euler_angles_xyz(quat_to_matrix(q_delta))) * (180.0 / math.pi)
    thr = float(threshold_deg)
    ok = (ang < thr) | (ang > 180.0 - thr)
    return torch.all(ok, dim=-1)
