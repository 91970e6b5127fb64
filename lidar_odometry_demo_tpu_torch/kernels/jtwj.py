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

Entry points, all at a pose (t, q; R derived from q in-kernel):
`gn_step` (the whole step, the main path) and `jtwj_accumulate` (H and b
alone, the epilogue off) count in `jtwj_accumulate.launches`. A step split
over a group of ranks (an sp or spatial group, ops/icp.py) sums the ranks'
H and b, gathered as "parts" (N, *lanes, 42) (the group's `gather_parts`),
in rank order inside the kernel, so every rank and backend gives the same
bits: a round's first step is `jtwj_accumulate`, each later one
`gn_sum_step` (the sum and the epilogue of the step before, then this
rank's part at the new pose, one launch; `gn_sum_step.launches`), and
after the last gather `gn_epilogue` (K2e: the sum and the epilogue alone,
one warp per lane; `gn_epilogue.launches`). A group of one keeps the
fused step. On CPU tensors each runs its plain version; on CUDA tensors
it launches its kernel or raises. There is no fallback between the two.

Lanes: every argument may carry a leading lane axis B (independent
systems); one launch runs B clusters. The step entry points then take a
(B,) `active` mask: an inactive lane keeps its pose and step norm (the ICP
loop's frozen lanes). The plain version runs its B = 1 body per lane.
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
    new_pose, norm = _solve_and_update(H0, b0, pose, guess_t, cfg)
    return new_pose, norm, H0, b0


def _solve_and_update(H0, b0, pose: se3.Pose, guess_t: torch.Tensor, cfg):
    """The step after the normal equations (one lane): the translation
    prior, H + damping diag(H) + 1e-9 I, solve_spd_6x6, apply_delta and
    |delta|."""
    H, b = add_prior(H0, b0, pose.t, guess_t, prior_weight(cfg))
    eye = torch.eye(6, dtype=torch.float32, device=H.device)
    H = H + cfg.icp_damping * torch.diag(torch.diag(H)) + 1e-9 * eye
    delta = -solve_spd_6x6(H, b)
    return se3.apply_delta(pose, delta), se3.norm(delta)


def gn_epilogue_plain(H, b, pose: se3.Pose, guess_t: torch.Tensor, cfg, *,
                      step_norm: torch.Tensor | None = None,
                      active: torch.Tensor | None = None):
    """The epilogue on a given H (6, 6) and b (6,) (before the prior):
    `gn_step_plain` after its normal equations, with H read from its upper
    triangle as the kernels read it (a sum over ranks need not keep H's two
    triangles bitwise equal). Returns (pose, step_norm); with a lane axis,
    per lane, holding an inactive lane's pose and step norm as
    `gn_step_plain` does."""
    if b.dim() == 2:
        new_pose, norm = lane_map(gn_epilogue_plain, b.shape[0], H, b, pose, guess_t, cfg)
        if active is not None:
            new_pose = se3.pose_where(active, new_pose, pose)
            norm = torch.where(active, norm, step_norm)
        return new_pose, norm
    upper = torch.ones((6, 6), dtype=torch.bool, device=H.device).triu()
    return _solve_and_update(torch.where(upper, H, H.T), b, pose, guess_t, cfg)


def sum_in_rank_order(parts: torch.Tensor) -> torch.Tensor:
    """parts[0] + parts[1] + ... in float32, in that order: the sum every
    rank of a group takes of what the group gathered (the kernels add the
    same way)."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def split_record(hb: torch.Tensor):
    """(H (..., 6, 6), b (..., 6)): views of the records (..., 42) a K2
    launch writes, each lane's H row-major, then its b."""
    return hb[..., :36].unflatten(-1, (6, 6)), hb[..., 36:]


def gn_epilogue_sum_plain(parts, pose: se3.Pose, guess_t: torch.Tensor, cfg, *,
                          step_norm: torch.Tensor | None = None,
                          active: torch.Tensor | None = None):
    """K2e's plain version: the N ranks' parts (N, *lanes, 42) added in rank
    order, then `gn_epilogue_plain` on the sums. Returns (pose,
    step_norm)."""
    H, b = split_record(sum_in_rank_order(parts))
    return gn_epilogue_plain(H, b, pose, guess_t, cfg, step_norm=step_norm, active=active)


def gn_sum_step_plain(parts, corr, pose: se3.Pose, guess_t: torch.Tensor, cfg, *,
                      step_norm: torch.Tensor | None = None,
                      active: torch.Tensor | None = None):
    """`gn_sum_step`'s plain version: the parts (N, *lanes, 42) of the step
    at `pose` added in rank order, `gn_epilogue_plain` on the sums, then
    `jtwj_plain` on this rank's correspondences at the new pose. Returns
    (pose, step_norm, H, b), H and b this rank's part at the new pose."""
    new_pose, norm = gn_epilogue_sum_plain(parts, pose, guess_t, cfg, step_norm=step_norm,
                                           active=active)
    H, b = jtwj_plain(*corr, se3.quat_to_matrix(new_pose.q), new_pose.t,
                      huber_delta=cfg.icp_huber_delta)
    return new_pose, norm, H, b


class GnWork(NamedTuple):
    """Outputs of `steps` kernel steps, allocated once per ICP `align` and
    reused by every round: slot k of `poses` holds step k's (t, q, |delta|)
    of every lane; `hb` the last launch's H and b. `slots` are the per-step
    (Pose, step_norm) views, made once. H and b are views into `hb`, one
    42-float record per lane (H row-major, then b), which is what a split
    step's group gathers."""

    poses: torch.Tensor  # (steps, *lead, 8) float32
    H: torch.Tensor      # (*lead, 6, 6), a view of hb
    b: torch.Tensor      # (*lead, 6), a view of hb
    slots: tuple
    hb: torch.Tensor     # (*lead, 42)

    @staticmethod
    def empty(steps: int, device, lead: tuple = ()) -> "GnWork":
        """Workspace of `steps` steps for the lanes `lead` (() or (B,))."""
        f32 = dict(dtype=torch.float32, device=device)
        poses = torch.empty((steps, *lead, 8), **f32)
        slots = tuple((se3.Pose(poses[k, ..., :3], poses[k, ..., 3:7]), poses[k, ..., 7])
                      for k in range(steps))
        hb = torch.empty((*lead, 42), **f32)
        return GnWork(poses, *split_record(hb), slots, hb)


def _corr_specs(source_local, plane_origin, plane_normal, valid):
    """(lead, Q, check specs) of a correspondence set."""
    lead, Q = tuple(source_local.shape[:-2]), source_local.shape[-2]
    specs = [(x, name, torch.float32, (*lead, Q, 3))
             for name, x in (("source_local", source_local), ("plane_origin", plane_origin),
                             ("plane_normal", plane_normal))]
    return lead, Q, specs + [(valid, "valid", torch.bool, (*lead, Q))]


def _step_specs(lead: tuple, pose: se3.Pose, guess_t, active, step_norm=None,
                needs_norm: bool = True) -> list:
    """Check specs of a step's pose, guess and (lanes) `active` and input
    step norm; raises where `active` comes without a lane axis or (a step
    that writes a pose, `needs_norm`) without the lanes' step norm."""
    specs = [(pose.t, "pose.t", torch.float32, (*lead, 3), len(lead)),
             (pose.q, "pose.q", torch.float32, (*lead, 4), len(lead))]
    if guess_t is not None:
        specs.append((guess_t, "guess_t", torch.float32, (*lead, 3)))
    if active is not None:
        if not lead:
            raise ValueError("active needs a lane axis")
        specs.append((active, "active", torch.bool, lead))
        if needs_norm:
            if step_norm is None:
                raise ValueError("active needs the input step_norm of every lane")
            specs.append((step_norm, "step_norm", torch.float32, lead, 1))
    return specs


def _parts_specs(parts: torch.Tensor, lead: tuple) -> list:
    """Check specs of a group's gathered parts (N, *lead, 42)."""
    if parts.dim() != len(lead) + 2 or parts.shape[0] < 1:
        raise ValueError(f"parts must have shape (N, {', '.join(map(str, lead))}"
                         f"{', ' if lead else ''}42), got {tuple(parts.shape)}")
    return [(parts, "parts", torch.float32, (parts.shape[0], *lead, 42))]


def _work_specs(work: GnWork, lead: tuple) -> list:
    """Check specs of a workspace for the lanes `lead` (its records, written
    by the launch); raises where its poses hold other lanes."""
    if work.poses.shape[1:] != (*lead, 8):
        raise ValueError(f"work holds lanes {tuple(work.poses.shape[1:-1])}, the step {lead}")
    return [(work.hb, "work.hb", torch.float32, (*lead, 42))]


def _lane_stride(x: torch.Tensor, lead: tuple) -> int:
    return x.stride(0) if lead else 0


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launcher():
    return _build.c_function("jtwj", "gn_step_launch",
                             [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                                      ctypes.c_int, ctypes.c_void_p,
                                                      ctypes.c_int]
                             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                             + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3)


def _launch_step(corr, pose: se3.Pose, lead: tuple, Q: int, work: GnWork, *, huber_delta,
                 prior_w=0.0, damping=0.0, guess_t=None, step_norm=None, active=None,
                 parts=None, pose_out=None) -> None:
    """One launch of gn_step_kernel (jtwj.cu gn_step_launch) in the mode its
    arguments select."""
    norm_in = None if active is None else step_norm  # read for an inactive lane alone
    _build.launch(_launcher(), corr.source_local.device, corr.source_local.data_ptr(),
                  corr.plane_origin.data_ptr(), corr.plane_normal.data_ptr(),
                  corr.valid.data_ptr(), pose.t.data_ptr(), _lane_stride(pose.t, lead),
                  pose.q.data_ptr(), _lane_stride(pose.q, lead), _ptr(norm_in),
                  0 if norm_in is None else _lane_stride(norm_in, lead), _ptr(active),
                  _ptr(guess_t), _ptr(parts), 0 if parts is None else parts.shape[0],
                  lanes(lead), Q, float(huber_delta), float(prior_w), float(damping),
                  work.hb.data_ptr(), _ptr(pose_out))


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
    if work is None:
        work = GnWork.empty(slot + 1, corr.source_local.device, lead)
    check_tensors(*specs, *_step_specs(lead, pose, guess_t, active, step_norm),
                  *_work_specs(work, lead))
    _launch_step(corr, pose, lead, Q, work, huber_delta=cfg.icp_huber_delta,
                 prior_w=prior_weight(cfg), damping=cfg.icp_damping, guess_t=guess_t,
                 step_norm=step_norm, active=active, pose_out=work.poses[slot])
    jtwj_accumulate.launches += 1
    new_pose, step_norm = work.slots[slot]
    return new_pose, step_norm, work.H, work.b


def jtwj_accumulate(corr, pose: se3.Pose, *, huber_delta: float, work: GnWork | None = None,
                    active: torch.Tensor | None = None):
    """K2 with the epilogue off: (H, b) without the prior at `pose`, R
    derived from pose.q as the whole step derives it (also a split step's
    first part). The plain version on CPU tensors, one launch on CUDA ones.

    corr: a Correspondence (source_local / plane_origin / plane_normal
    (Q, 3) float32, valid (Q,) bool, any Q); pose (t (3,), q (4,)); each
    may carry a leading lane axis B. H and b are written into `work.hb`
    where a workspace is given (a new one otherwise) and returned as its
    views. On CUDA an inactive lane (`active`, (B,) bool) writes nothing; on
    CPU tensors every lane is written.
    """
    if corr.source_local.device.type == "cpu":
        H, b = jtwj_plain(*corr, se3.quat_to_matrix(pose.q), pose.t, huber_delta=huber_delta)
        if work is None:
            return H, b
        work.H.copy_(H)
        work.b.copy_(b)
        return work.H, work.b
    lead, Q, specs = _corr_specs(*corr)
    if work is None:
        work = GnWork.empty(1, corr.source_local.device, lead)
    check_tensors(*specs, *_step_specs(lead, pose, None, active, needs_norm=False),
                  *_work_specs(work, lead))
    _launch_step(corr, pose, lead, Q, work, huber_delta=huber_delta, active=active)
    jtwj_accumulate.launches += 1
    return work.H, work.b


jtwj_accumulate.launches = 0


def gn_sum_step(parts, corr, pose: se3.Pose, guess_t: torch.Tensor, cfg, *, work: GnWork,
                slot: int = 0, step_norm: torch.Tensor | None = None,
                active: torch.Tensor | None = None):
    """K2's split-step entry point, steps 1 .. n-1 of a round under a group:
    the N ranks' parts (N, *lanes, 42) of the step at `pose` (gathered by the
    group, in group order) added in rank order, the prior, the damping, the
    solve and the pose update on the sums, then this rank's H and b (`corr`,
    its correspondences) at the new pose, in one launch. `pose`, `guess_t`,
    `active` and `step_norm` as `gn_step` takes them.

    On CUDA the new pose and step norm are written into slot `slot` of
    `work` and returned as views, and the new part into `work.hb` (active
    lanes only), where the next gather reads it. On CPU tensors
    `gn_sum_step_plain`, the part written for every lane. Returns (pose,
    step_norm)."""
    if corr.source_local.device.type == "cpu":
        new_pose, norm, H, b = gn_sum_step_plain(parts, corr, pose, guess_t, cfg,
                                                 step_norm=step_norm, active=active)
        work.H.copy_(H)
        work.b.copy_(b)
        return new_pose, norm
    lead, Q, specs = _corr_specs(*corr)
    check_tensors(*specs, *_step_specs(lead, pose, guess_t, active, step_norm),
                  *_parts_specs(parts, lead), *_work_specs(work, lead))
    _launch_step(corr, pose, lead, Q, work, huber_delta=cfg.icp_huber_delta,
                 prior_w=prior_weight(cfg), damping=cfg.icp_damping, guess_t=guess_t,
                 step_norm=step_norm, active=active, parts=parts,
                 pose_out=work.poses[slot])
    gn_sum_step.launches += 1
    return work.slots[slot]


gn_sum_step.launches = 0


def gn_epilogue(parts, pose: se3.Pose, guess_t: torch.Tensor, cfg, *, work: GnWork,
                slot: int = 0, step_norm: torch.Tensor | None = None,
                active: torch.Tensor | None = None):
    """K2e, the split step's last epilogue: the N ranks' parts (N, *lanes,
    42) added in rank order, then the prior, the damping, the 6x6 solve and
    the pose update of the step at `pose` (H's upper triangle is read), as
    `gn_sum_step` does before its accumulation. On the part of an
    epilogue-off launch alone (N = 1) it is the fused step's epilogue. On
    CUDA one launch (a warp per lane), the new pose and step norm written
    into slot `slot` of `work` and returned as views; on CPU tensors
    `gn_epilogue_sum_plain`. Returns (pose, step_norm)."""
    if parts.device.type == "cpu":
        return gn_epilogue_sum_plain(parts, pose, guess_t, cfg, step_norm=step_norm,
                                     active=active)
    lead = tuple(parts.shape[1:-1])
    check_tensors(*_parts_specs(parts, lead),
                  *_step_specs(lead, pose, guess_t, active, step_norm), *_work_specs(work, lead))
    fn = _build.c_function("jtwj", "gn_epilogue_launch",
                           [ctypes.c_void_p, ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                           + [ctypes.c_int] + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
    _build.launch(fn, parts.device, parts.data_ptr(), parts.shape[0], pose.t.data_ptr(),
                  _lane_stride(pose.t, lead), pose.q.data_ptr(), _lane_stride(pose.q, lead),
                  None if active is None else step_norm.data_ptr(),
                  0 if active is None else _lane_stride(step_norm, lead), _ptr(active),
                  guess_t.data_ptr(), lanes(lead), float(prior_weight(cfg)),
                  float(cfg.icp_damping), work.poses[slot].data_ptr())
    gn_epilogue.launches += 1
    return work.slots[slot]


gn_epilogue.launches = 0
