"""Kernel K2 (``jtwj.cu``): one Gauss-Newton step of the point-to-plane ICP
in one launch, its plain PyTorch version, and its launch counter.

Replaces the TPU kernel ``lidar_odometry_demo_tpu/ops/pallas/jtwj.py``
(``_jtwj_kernel`` / ``jtwj_accumulate``) and the scalar work that followed
it on every step (the translation prior, the damping, the 6x6 solve and the
pose update). It runs at every Gauss-Newton step, four per ICP outer round.
One step moves ~0.3 MB at full width, so its time is the launch's, not the
bytes' or the flops'; the kernel is one thread-block cluster with a
fixed-order, atomic-free reduction through distributed shared memory, so
its result is bitwise repeatable (see the source's note).

Two entry points on the one kernel: `gn_step` (the whole step, the main
path) and `jtwj_accumulate` (H and b alone, the epilogue off). Both count
their launches in `jtwj_accumulate.launches`. On CPU tensors each runs its
plain version; on CUDA tensors it launches the kernel or raises. There is
no fallback between the two.

Lanes: every argument may carry a leading lane axis B (independent
systems); one launch runs B clusters. `gn_step` then takes a (B,) `active`
mask: an inactive lane keeps its pose and step norm (the ICP loop's frozen
lanes). The plain version runs its B = 1 body per lane.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lidar_odometry_demo_tpu_torch.kernels import _build
from lidar_odometry_demo_tpu_torch.kernels._build import check_tensors, lane_map, lanes
from lidar_odometry_demo_tpu_torch.ops import se3


def jtwj_plain(source_local, plane_origin, plane_normal, valid, R, t, *,
               huber_delta: float):
    """(H (6, 6), b (6,)) without the translation prior: the JAX package's
    XLA formulation (``icp._normal_equations``) in float32. With a lane
    axis, the B = 1 version per lane."""
    if source_local.dim() == 3:
        return lane_map(jtwj_plain, source_local.shape[0], source_local, plane_origin,
                        plane_normal, valid, R, t, huber_delta=huber_delta)
    rp = se3.rot_pts(source_local, R)
    e = (rp + t - plane_origin) * plane_normal
    # summed in a stated order, which the kernel repeats: with few
    # correspondences the damped solve amplifies an ulp of r by ~1e6
    r = e[:, 0] + e[:, 1] + e[:, 2]
    absr = torch.abs(r)
    # a tensor numerator: `float / tensor` would multiply by a reciprocal
    w = torch.where(absr <= huber_delta, 1.0,
                    torch.full_like(absr, huber_delta) / torch.clamp_min(absr, 1e-30))
    w = torch.where(valid, w, 0.0)
    n = plane_normal
    j_rot = torch.stack([rp[:, 1] * n[:, 2] - rp[:, 2] * n[:, 1],
                         rp[:, 2] * n[:, 0] - rp[:, 0] * n[:, 2],
                         rp[:, 0] * n[:, 1] - rp[:, 1] * n[:, 0]], dim=-1)
    J = torch.cat([j_rot, n], dim=-1)
    Jw = J * w[:, None]
    return J.T @ Jw, Jw.T @ r


def solve_spd_6x6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for SPD 6x6 by a fully unrolled Cholesky, with the JAX
    package's 1e-12 pivot guard (same operation order, so CPU results agree
    to rounding)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        diag = torch.sqrt(torch.clamp_min(s, 1e-12))
        L[j][j] = diag
        inv_d = 1.0 / diag
        for i in range(j + 1, n):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def prior_weight(cfg) -> float:
    """Weight of the translation prior NormalPrior(diag(1/sigma))
    (cloud_matcher.cpp:153-154)."""
    inv_sigma = 1.0 / cfg.icp_translation_prior_sigma
    return inv_sigma * inv_sigma


def add_prior(H, b, t, guess_t, prior_w: float):
    """H + diag(0, 0, 0, w, w, w), b + w (0, t - t_guess): the reference's
    translation prior on (t - t_guess)."""
    prior_diag = torch.diag(torch.tensor([0.0, 0.0, 0.0, prior_w, prior_w, prior_w],
                                         dtype=torch.float32, device=H.device))
    return H + prior_diag, b + prior_w * torch.cat([torch.zeros_like(t), t - guess_t])


def gn_step_plain(corr, pose: se3.Pose, guess_t: torch.Tensor, cfg, *,
                  step_norm: torch.Tensor | None = None,
                  active: torch.Tensor | None = None):
    """One Gauss-Newton step as tensor ops: the normal equations, the
    translation prior, H + damping diag(H) + 1e-9 I, solve_spd_6x6,
    apply_delta and |delta| (the JAX package's ``icp._gn_steps`` body).

    Returns (pose, step_norm, H, b), H and b before the prior and damping.
    With a lane axis, the B = 1 version per lane; where the (B,) `active`
    is false the lane's `pose` and `step_norm` come back unchanged.
    """
    if corr.source_local.dim() == 3:
        new_pose, norm, H, b = lane_map(gn_step_plain, corr.source_local.shape[0], corr,
                                        pose, guess_t, cfg)
        if active is not None:
            new_pose = se3.pose_where(active, new_pose, pose)
            norm = torch.where(active, norm, step_norm)
        return new_pose, norm, H, b
    R = se3.quat_to_matrix(pose.q)
    H0, b0 = jtwj_plain(corr.source_local, corr.plane_origin, corr.plane_normal,
                        corr.valid, R, pose.t, huber_delta=cfg.icp_huber_delta)
    H, b = add_prior(H0, b0, pose.t, guess_t, prior_weight(cfg))
    eye = torch.eye(6, dtype=torch.float32, device=H.device)
    H = H + cfg.icp_damping * torch.diag(torch.diag(H)) + 1e-9 * eye
    delta = -solve_spd_6x6(H, b)
    return se3.apply_delta(pose, delta), se3.norm(delta), H0, b0


class GnWork(NamedTuple):
    """Outputs of `steps` kernel steps, allocated once per ICP `align` and
    reused by every round: slot k of `poses` holds step k's (t, q, |delta|)
    of every lane; H and b the last step's. `slots` are the per-step
    (Pose, step_norm) views, made once."""

    poses: torch.Tensor  # (steps, *lead, 8) float32
    H: torch.Tensor      # (*lead, 6, 6)
    b: torch.Tensor      # (*lead, 6)
    slots: tuple

    @staticmethod
    def empty(steps: int, device, lead: tuple = ()) -> "GnWork":
        """Workspace of `steps` steps for the lanes `lead` (() or (B,))."""
        f32 = dict(dtype=torch.float32, device=device)
        poses = torch.empty((steps, *lead, 8), **f32)
        slots = tuple((se3.Pose(poses[k, ..., :3], poses[k, ..., 3:7]), poses[k, ..., 7])
                      for k in range(steps))
        return GnWork(poses, torch.empty((*lead, 6, 6), **f32), torch.empty((*lead, 6), **f32),
                      slots)


def _corr_specs(source_local, plane_origin, plane_normal, valid):
    """(lead, Q, check specs) of a correspondence set."""
    lead, Q = tuple(source_local.shape[:-2]), source_local.shape[-2]
    specs = [(x, name, torch.float32, (*lead, Q, 3))
             for name, x in (("source_local", source_local), ("plane_origin", plane_origin),
                             ("plane_normal", plane_normal))]
    return lead, Q, specs + [(valid, "valid", torch.bool, (*lead, Q))]


def _lane_stride(x: torch.Tensor, lead: tuple) -> int:
    return x.stride(0) if lead else 0


def _launcher():
    return _build.c_function("jtwj", "gn_step_launch",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p,
                                                      ctypes.c_int, ctypes.c_void_p,
                                                      ctypes.c_int]
                             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                             + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 4)


def gn_step(corr, pose: se3.Pose, guess_t: torch.Tensor, cfg, *,
            work: GnWork | None = None, slot: int = 0,
            step_norm: torch.Tensor | None = None, active: torch.Tensor | None = None):
    """K2, one whole Gauss-Newton step: the plain version on CPU tensors, one
    kernel launch on CUDA ones.

    corr: a Correspondence (source_local / plane_origin / plane_normal
    (Q, 3) float32, valid (Q,) bool); pose (t (3,), q (4,)) and guess_t
    (3,) float32; each may carry a leading lane axis B, and the pose may be
    an earlier step's view into `work`. With lanes, `active` (B,) bool and
    `step_norm` (B,) may be given: an inactive lane's pose and step norm
    come back unchanged. On CUDA the new pose, the step norm, H and b are
    views into `work` (slot `slot` for the pose), valid until the next step
    that writes them. Returns (pose, step_norm, H, b) as `gn_step_plain`.
    """
    if corr.source_local.device.type == "cpu":
        return gn_step_plain(corr, pose, guess_t, cfg, step_norm=step_norm, active=active)
    lead, Q, specs = _corr_specs(*corr)
    if active is not None:
        if not lead:
            raise ValueError("active needs a lane axis")
        if step_norm is None:
            raise ValueError("active needs the input step_norm of every lane")
        specs += [(active, "active", torch.bool, lead),
                  (step_norm, "step_norm", torch.float32, lead, 1)]
    dev = corr.source_local.device
    check_tensors(*specs, (pose.t, "pose.t", torch.float32, (*lead, 3), len(lead)),
                  (pose.q, "pose.q", torch.float32, (*lead, 4), len(lead)),
                  (guess_t, "guess_t", torch.float32, (*lead, 3)))
    if work is None:
        work = GnWork.empty(slot + 1, dev, lead)
    elif work.poses.shape[1:] != (*lead, 8) or work.H.shape != (*lead, 6, 6):
        raise ValueError(f"work holds lanes {tuple(work.H.shape[:-2])}, the step {lead}")
    _build.launch(_launcher(), dev, corr.source_local.data_ptr(),
                  corr.plane_origin.data_ptr(), corr.plane_normal.data_ptr(),
                  corr.valid.data_ptr(), None, pose.t.data_ptr(), _lane_stride(pose.t, lead),
                  pose.q.data_ptr(), _lane_stride(pose.q, lead),
                  None if active is None else step_norm.data_ptr(),
                  0 if active is None else _lane_stride(step_norm, lead),
                  None if active is None else active.data_ptr(), guess_t.data_ptr(),
                  lanes(lead), Q, float(cfg.icp_huber_delta), float(prior_weight(cfg)),
                  float(cfg.icp_damping), work.H.data_ptr(), work.b.data_ptr(),
                  work.poses[slot].data_ptr())
    jtwj_accumulate.launches += 1
    new_pose, step_norm = work.slots[slot]
    return new_pose, step_norm, work.H, work.b


def jtwj_accumulate(source_local, plane_origin, plane_normal, valid, R, t, *,
                    huber_delta: float):
    """K2 with the epilogue off, (H, b) without the prior: the plain version
    on CPU tensors, the CUDA kernel on CUDA ones.

    source_local / plane_origin / plane_normal (Q, 3) float32, valid (Q,)
    bool, R (3, 3) and t (3,) float32, each with an optional leading lane
    axis B; any Q.
    """
    if source_local.device.type == "cpu":
        return jtwj_plain(source_local, plane_origin, plane_normal, valid, R, t,
                          huber_delta=huber_delta)
    lead, Q, specs = _corr_specs(source_local, plane_origin, plane_normal, valid)
    check_tensors(*specs, (R, "R", torch.float32, (*lead, 3, 3)),
                  (t, "t", torch.float32, (*lead, 3)))
    dev = source_local.device
    H = torch.empty((*lead, 6, 6), dtype=torch.float32, device=dev)
    b = torch.empty((*lead, 6), dtype=torch.float32, device=dev)
    _build.launch(_launcher(), dev, source_local.data_ptr(), plane_origin.data_ptr(),
                  plane_normal.data_ptr(), valid.data_ptr(), R.data_ptr(), t.data_ptr(),
                  3, None, 0, None, 0, None, None, lanes(lead), Q, float(huber_delta), 0.0,
                  0.0, H.data_ptr(), b.data_ptr(), None)
    jtwj_accumulate.launches += 1
    return H, b


jtwj_accumulate.launches = 0
