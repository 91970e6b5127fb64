"""Pose-graph refinement: Gauss-Newton over keyframe poses with a direct, a
Schur-complement and a block-sparse segment-Schur solver (port of the JAX
``parallel/pose_graph.py``), and the edge-sharded refinement over a mesh axis's
ranks, `make_refine_sharded`.

- nodes: keyframe poses X_i in SE(3) (a `Pose` with a (P,) batch),
- edges: relative-pose constraints Z_ij (odometry chain + loop closures),
  residual r_ij = [Log_SO3(R_z^T R_i^T R_j), R_z^T(R_i^T(t_j - t_i) - t_z)],
- per-edge 6x6 Jacobian blocks in closed form, for all edges at once (the
  JAX package takes `jax.jacfwd` of the residual under `jax.vmap`; the
  tests hold these against it), assembled into the dense block normal
  equations; the gauge is fixed by a strong prior on pose 0,
- solved directly (dense LU), by two-level Schur elimination (interior
  poses eliminated, the separator system solved), or by the segment Schur
  solver, which eliminates each interior segment's block-tridiagonal
  system with a block Thomas recursion, O(P 6^3) instead of O((6P)^3).

Every tensor of a graph lives on one device (the card unless
`chain_from_odometry` is asked for another). The algebra is float32 with
TF32 off (the device module turns it off), so a product on the card rounds
as on the CPU; the scatter-adds use `index_put_(accumulate=True)` and
`index_add_`, whose summation order on the card may differ from the CPU's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_odometry_demo_tpu_torch.device import resolve_device, to_torch
from lidar_odometry_demo_tpu_torch.ops import se3


class PoseGraph(NamedTuple):
    poses: se3.Pose            # (P,) node estimates
    edge_i: torch.Tensor       # (E,) int64 source node
    edge_j: torch.Tensor       # (E,) int64 target node
    edge_z: se3.Pose           # (E,) measured relative pose (i -> j)
    edge_w_rot: torch.Tensor   # (E,) rotation information weight
    edge_w_t: torch.Tensor     # (E,) translation information weight
    edge_valid: torch.Tensor   # (E,) mask


def edge_residual(xi_i, xi_j, pose_i: se3.Pose, pose_j: se3.Pose, z: se3.Pose):
    """6-dim residual of one edge (or a batch of edges) at local
    perturbations (xi_i, xi_j).

    Left-multiplicative: X <- (exp(w), dt) o X with w = xi[:3], dt = xi[3:].
    """
    pi = se3.apply_delta(pose_i, xi_i)
    pj = se3.apply_delta(pose_j, xi_j)
    rel = se3.relative_to(pi, pj)        # X_i^-1 X_j
    err = se3.relative_to(z, rel)        # Z^-1 (X_i^-1 X_j)
    return torch.cat([se3.quat_log(err.q), err.t], dim=-1)


def _hat(v: torch.Tensor) -> torch.Tensor:
    """Skew matrices (..., 3, 3) with hat(a) b = a x b."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(*v.shape[:-1], 3, 3)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """J_l(phi)^-1 = I - hat(phi)/2 + c hat(phi)^2 with
    c = 1/theta^2 - (1 + cos theta) / (2 theta sin theta), its Taylor
    series 1/12 + theta^2/720 below theta = 1e-3."""
    th2 = torch.sum(phi * phi, dim=-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-6
    safe = torch.where(small, torch.ones_like(th), th)
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    1.0 / (safe * safe) - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)))
    K = _hat(phi)
    return _eye(3, phi) - 0.5 * K + c[..., None, None] * (K @ K)


def _edge_system(pose_i, pose_j, z, w_rot, w_t):
    """Weighted (J_i, J_j, r) of a batch of edges, the Jacobians in closed
    form. With A = R_i R_z, d = t_j - t_i and phi the rotation residual,
    a left perturbation w_i turns the residual rotation into
    Exp(-A^T w_i) Exp(phi), so d phi / d w_i = -J_l(phi)^-1 A^T (and
    +J_l(phi)^-1 A^T for w_j); the translation residual A^T d - R_z^T t_z
    gives A^T hat(d) for w_i and -A^T / +A^T for dt_i / dt_j."""
    zero = torch.zeros((*pose_i.t.shape[:-1], 6), dtype=pose_i.t.dtype, device=pose_i.t.device)
    r = edge_residual(zero, zero, pose_i, pose_j, z)
    At = (se3.quat_to_matrix(pose_i.q) @ se3.quat_to_matrix(z.q)).transpose(-1, -2)
    rot = _so3_left_jacobian_inv(r[..., :3]) @ At
    J_i = torch.zeros((*r.shape, 6), dtype=r.dtype, device=r.device)
    J_j = torch.zeros_like(J_i)
    J_i[..., :3, :3] = -rot
    J_i[..., 3:, :3] = At @ _hat(pose_j.t - pose_i.t)
    J_i[..., 3:, 3:] = -At
    J_j[..., :3, :3] = rot
    J_j[..., 3:, 3:] = At
    w = torch.cat([w_rot[..., None].expand(*w_rot.shape, 3), w_t[..., None].expand(*w_t.shape, 3)],
                  dim=-1) ** 0.5
    return J_i * w[..., :, None], J_j * w[..., :, None], r * w


def edge_jacobians(g: PoseGraph):
    """Every edge's weighted (J_i, J_j, r), zero for an invalid edge:
    (E, 6, 6), (E, 6, 6), (E, 6)."""
    pi = se3.Pose(g.poses.t[g.edge_i], g.poses.q[g.edge_i])
    pj = se3.Pose(g.poses.t[g.edge_j], g.poses.q[g.edge_j])
    J_i, J_j, r = _edge_system(pi, pj, g.edge_z, g.edge_w_rot, g.edge_w_t)
    m = torch.where(g.edge_valid, 1.0, 0.0)
    return J_i * m[:, None, None], J_j * m[:, None, None], r * m[:, None]


def _edge_blocks(g: PoseGraph):
    J_i, J_j, r = edge_jacobians(g)
    Hii = torch.einsum("eab,eac->ebc", J_i, J_i)
    Hjj = torch.einsum("eab,eac->ebc", J_j, J_j)
    Hij = torch.einsum("eab,eac->ebc", J_i, J_j)
    bi = torch.einsum("eab,ea->eb", J_i, r)
    bj = torch.einsum("eab,ea->eb", J_j, r)
    return Hii, Hjj, Hij, bi, bj


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def build_normal_equations(g: PoseGraph, group=None):
    """Dense block normal equations H (P, P, 6, 6), b (P, 6) from all edges,
    with the gauge prior on pose 0. With a `group` (parallel/mesh.py), g
    holds this rank's share of the edges and H and b are summed over the
    group (one all-reduce each) before the prior: the edge-parallel
    pattern of `make_refine_sharded`."""
    P = g.poses.t.shape[0]
    Hii, Hjj, Hij, bi, bj = _edge_blocks(g)
    f32 = dict(dtype=Hii.dtype, device=Hii.device)
    H = torch.zeros((P, P, 6, 6), **f32)
    b = torch.zeros((P, 6), **f32)
    H.index_put_((g.edge_i, g.edge_i), Hii, accumulate=True)
    H.index_put_((g.edge_j, g.edge_j), Hjj, accumulate=True)
    H.index_put_((g.edge_i, g.edge_j), Hij, accumulate=True)
    H.index_put_((g.edge_j, g.edge_i), Hij.transpose(-1, -2), accumulate=True)
    b.index_add_(0, g.edge_i, bi)
    b.index_add_(0, g.edge_j, bj)
    if group is not None:
        group.psum(H, "H")
        group.psum(b, "b")
    H[0, 0] += 1e6 * _eye(6, H)  # gauge prior: pin pose 0
    return H, b


def _dense(H: torch.Tensor) -> torch.Tensor:
    P = H.shape[0]
    return H.permute(0, 2, 1, 3).reshape(P * 6, P * 6)


def solve_direct(H, b, damping: float = 1e-6):
    P = b.shape[0]
    Hd = _dense(H)
    Hd = Hd + damping * torch.diag(torch.diag(Hd)) + 1e-8 * _eye(P * 6, Hd)
    delta = torch.linalg.solve(Hd, -b.reshape(-1))
    return delta.reshape(P, 6)


def solve_schur(H, b, is_separator: torch.Tensor, damping: float = 1e-6):
    """Two-level Schur elimination: eliminate interior poses, solve the
    reduced separator system, back-substitute.

    S = H_SS - H_SI H_II^-1 H_IS ;  S dx_S = -(b_S - H_SI H_II^-1 b_I)
    dx_I = -H_II^-1 (b_I + H_IS dx_S)

    The cross blocks are zeroed with masks and the full-size matrices kept:
    the interior and separator systems stay (6P, 6P) but decouple exactly
    (the JAX package's static-shape form).
    """
    P = b.shape[0]
    sep = is_separator.to(H.dtype)
    interior = 1.0 - sep
    diag = torch.arange(P, device=H.device)

    mask_ii = interior[:, None] * interior[None, :]
    mask_ss = sep[:, None] * sep[None, :]
    mask_si = sep[:, None] * interior[None, :]
    mask_is = interior[:, None] * sep[None, :]

    # interior-interior blocks, with the identity on the separators'
    # diagonal blocks so that the dense system stays regular
    H_ii = H * mask_ii[:, :, None, None]
    H_ii.index_put_((diag, diag), sep[:, None, None] * _eye(6, H), accumulate=True)

    b_i = (b * interior[:, None]).reshape(-1)
    b_s = (b * sep[:, None]).reshape(-1)

    Hii_d = _dense(H_ii) + 1e-8 * _eye(P * 6, H)
    Hsi_d = _dense(H * mask_si[:, :, None, None])
    His_d = _dense(H * mask_is[:, :, None, None])

    Hii_inv_bi = torch.linalg.solve(Hii_d, b_i)
    Hii_inv_His = torch.linalg.solve(Hii_d, His_d)

    S = _dense(H * mask_ss[:, :, None, None]) - Hsi_d @ Hii_inv_His
    rhs = b_s - Hsi_d @ Hii_inv_bi
    sep6 = sep.repeat_interleave(6)
    S = (S + torch.diag(1.0 - sep6) + damping * torch.diag(torch.diag(S))
         + 1e-8 * _eye(P * 6, S))
    dx_s = torch.linalg.solve(S, -rhs) * sep6

    dx_i = torch.linalg.solve(Hii_d, -(b_i + His_d @ dx_s)) * interior.repeat_interleave(6)
    return (dx_s + dx_i).reshape(P, 6)


# ---------------------------------------------------------------------------
# block-sparse segment Schur: O(P * 6^3) instead of dense O((6P)^3)
# ---------------------------------------------------------------------------

def build_chain_system(g: PoseGraph, stride: int):
    """Block-sparse normal equations for a chain + separator-aligned
    closures.

    Returns (diag (P,6,6), off (P,6,6) [off[i] = H[i, i+1], off[P-1] unused],
    S_extra (n_sep+1, n_sep+1, 6, 6) closure cross-blocks in separator
    coordinates, b (P,6)). Every non-chain edge must join two separator
    poses (indices divisible by `stride`), which keeps each interior
    segment exactly block-tridiagonal.
    """
    P = g.poses.t.shape[0]
    n_sep = P // stride
    Hii, Hjj, Hij, bi, bj = _edge_blocks(g)
    f32 = dict(dtype=Hii.dtype, device=Hii.device)

    diag = torch.zeros((P, 6, 6), **f32)
    diag.index_add_(0, g.edge_i, Hii)
    diag.index_add_(0, g.edge_j, Hjj)
    b = torch.zeros((P, 6), **f32)
    b.index_add_(0, g.edge_i, bi)
    b.index_add_(0, g.edge_j, bj)

    is_chain = g.edge_j == g.edge_i + 1
    off = torch.zeros((P, 6, 6), **f32)
    off.index_add_(0, g.edge_i[is_chain], Hij[is_chain])  # the JAX scatter drops the rest

    # closure cross-blocks land directly in the separator system
    S_extra = torch.zeros((n_sep + 1, n_sep + 1, 6, 6), **f32)
    drop = is_chain | ~g.edge_valid
    ci = torch.where(drop, n_sep, g.edge_i // stride)  # the virtual row absorbs chain edges
    cj = torch.where(drop, n_sep, g.edge_j // stride)
    S_extra.index_put_((ci, cj), Hij, accumulate=True)
    S_extra.index_put_((cj, ci), Hij.transpose(-1, -2), accumulate=True)
    S_extra[n_sep, n_sep] = 0.0
    return diag, off, S_extra, b


def _tridiag_solve(D, O, RHS):
    """Block-tridiagonal solves (block Thomas), one per leading segment.

    D (n,L,6,6) diagonal blocks, O (n,L-1,6,6) with O[:, i] = H[i, i+1],
    RHS (n,L,6,K). Returns X (n,L,6,K) with H X = RHS per segment.
    """
    n, L = D.shape[:2]
    zero = torch.zeros((n, 1, 6, 6), dtype=D.dtype, device=D.device)
    # row i sees (O_{i-1}, O_i), with O_{-1} = O_{L-1} = 0
    O_pad = torch.cat([zero, O, zero], dim=1)
    G_prev, V_prev = zero[:, 0], torch.zeros_like(RHS[:, 0])
    Gs, Vs = [], []
    for i in range(L):
        O_prev_T = O_pad[:, i].transpose(-1, -2)
        # forward elimination: M_i = D_i - O_{i-1}^T M_{i-1}^-1 O_{i-1}
        M_i = D[:, i] - O_prev_T @ G_prev
        W_i = RHS[:, i] - O_prev_T @ V_prev
        G_prev = torch.linalg.solve(M_i, O_pad[:, i + 1])  # for the next row + back-sub
        V_prev = torch.linalg.solve(M_i, W_i)
        Gs.append(G_prev)
        Vs.append(V_prev)
    X_next = torch.zeros_like(RHS[:, 0])
    X = [None] * L
    for i in reversed(range(L)):  # back-substitution (the reverse scan)
        X_next = Vs[i] - Gs[i] @ X_next
        X[i] = X_next
    return torch.stack(X, dim=1)


def solve_segment_schur(diag, off, S_extra, b, stride: int, damping: float = 1e-6):
    """Schur solve on the block-sparse chain system.

    Poses are split into separators (every `stride`-th, plus a virtual
    terminal) and interior segments of length stride-1. Each segment's
    block-tridiagonal interior is eliminated (block Thomas, all segments at
    once), giving 2x2 block contributions onto its bounding separators; the
    small separator system (closures included) is solved densely; interiors
    back-substitute.
    """
    P = b.shape[0]
    n_sep = P // stride
    L = stride - 1
    eye6 = _eye(6, b)
    f32 = dict(dtype=b.dtype, device=b.device)

    dmp = 1.0 + damping
    diag = diag * torch.where(eye6.bool()[None], dmp, 1.0) + 1e-7 * eye6[None]

    # run k: interiors k*stride+1 .. k*stride+stride-1
    D_runs = diag.reshape(n_sep, stride, 6, 6)[:, 1:]
    b_runs = b.reshape(n_sep, stride, 6)[:, 1:]
    off_r = off.reshape(n_sep, stride, 6, 6)
    O_runs = off_r[:, 1:-1]
    A = off_r[:, 0]                      # H[s_k, s_k+1]  (left coupling)
    # H[s_{k+1}-1, s_{k+1}]: the last off of run k; for the last run this is
    # off[P-1], which is zero (the virtual separator)
    off_pad = torch.cat([off, torch.zeros((1, 6, 6), **f32)])
    C = off_pad[torch.arange(1, n_sep + 1, device=b.device) * stride - 1]

    # RHS per run: [b_I (1 col) | E_L = A^T at row 0 (6) | E_R = C at row L-1 (6)]
    E_L = torch.zeros((n_sep, L, 6, 6), **f32)
    E_L[:, 0] = A.transpose(-1, -2)
    E_R = torch.zeros((n_sep, L, 6, 6), **f32)
    E_R[:, L - 1] = C
    RHS = torch.cat([b_runs[..., None], E_L, E_R], dim=-1)  # (n,L,6,13)

    X = _tridiag_solve(D_runs, O_runs, RHS)  # (n,L,6,13)
    u_b = X[..., 0]          # (n, L, 6)
    X_L = X[..., 1:7]        # (n, L, 6, 6)
    X_R = X[..., 7:13]

    # separator system S (n_sep+1 blocks): S = H_SS - H_SI U H_IS
    ks = torch.arange(n_sep, device=b.device)
    sep_idx = ks * stride
    S = torch.zeros((n_sep + 1, n_sep + 1, 6, 6), **f32)
    S[ks, ks] = diag[sep_idx]
    S[n_sep, n_sep] = eye6
    S = S + S_extra

    AX_L = torch.einsum("kab,kbc->kac", A, X_L[:, 0])      # A_k U[0] A_k^T cols
    AX_R = torch.einsum("kab,kbc->kac", A, X_R[:, 0])
    CX_L = torch.einsum("kba,kbc->kac", C, X_L[:, L - 1])  # C^T U[L-1] ...
    CX_R = torch.einsum("kba,kbc->kac", C, X_R[:, L - 1])
    S.index_put_((ks, ks), -AX_L, accumulate=True)
    S.index_put_((ks, ks + 1), -AX_R, accumulate=True)
    S.index_put_((ks + 1, ks), -CX_L, accumulate=True)
    S.index_put_((ks + 1, ks + 1), -CX_R, accumulate=True)

    rhs_s = torch.zeros((n_sep + 1, 6), **f32)
    rhs_s[ks] = b[sep_idx]
    rhs_s.index_add_(0, ks, -torch.einsum("kab,kb->ka", A, u_b[:, 0]))
    rhs_s.index_add_(0, ks + 1, -torch.einsum("kba,kb->ka", C, u_b[:, L - 1]))

    S[0, 0] += 1e6 * eye6  # gauge prior on separator 0 (pose 0)

    Sd = S.permute(0, 2, 1, 3).reshape((n_sep + 1) * 6, (n_sep + 1) * 6)
    Sd = Sd + 1e-7 * _eye((n_sep + 1) * 6, Sd)
    dx_s = torch.linalg.solve(Sd, -rhs_s.reshape(-1)).reshape(n_sep + 1, 6)

    # back-substitute the interiors: dx_I = -u_b - X_L dx_{s_k} - X_R dx_{s_{k+1}}
    dx_i = (-u_b
            - torch.einsum("klab,kb->kla", X_L, dx_s[:n_sep])
            - torch.einsum("klab,kb->kla", X_R, dx_s[1:n_sep + 1]))
    dx = torch.zeros((P, 6), **f32)
    dx[sep_idx] = dx_s[:n_sep]
    interior_idx = (sep_idx[:, None] + 1 + torch.arange(L, device=b.device)[None, :]).reshape(-1)
    dx[interior_idx] = dx_i.reshape(-1, 6)
    return dx


def _step(g: PoseGraph, dx: torch.Tensor) -> PoseGraph:
    return g._replace(poses=se3.apply_delta(g.poses, dx))


def refine_segment(g: PoseGraph, stride: int = 8, iterations: int = 10) -> PoseGraph:
    """Gauss-Newton refinement through the segment-Schur solver. P must be a
    multiple of `stride`; every loop closure must join two separator poses
    (index % stride == 0)."""
    P = g.poses.t.shape[0]
    assert P % stride == 0, (P, stride)
    for _ in range(iterations):
        diag, off, S_extra, b = build_chain_system(g, stride)
        g = _step(g, solve_segment_schur(diag, off, S_extra, b, stride))
    return g


def pad_edges(g: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge arrays (masked invalid) to a multiple of `multiple`."""
    E = g.edge_i.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return g

    def zpad(x):
        return torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype, device=x.device)])

    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=g.edge_z.q.dtype, device=g.edge_z.q.device)
    return g._replace(
        edge_i=zpad(g.edge_i), edge_j=zpad(g.edge_j),
        edge_z=se3.Pose(zpad(g.edge_z.t), torch.cat([g.edge_z.q, ident.expand(pad, 4)])),
        edge_w_rot=zpad(g.edge_w_rot), edge_w_t=zpad(g.edge_w_t),
        edge_valid=zpad(g.edge_valid),
    )


def refine(g: PoseGraph, iterations: int = 10, use_schur: bool = False,
           separator_stride: int = 4) -> PoseGraph:
    """Gauss-Newton iterations on the pose graph; returns the refined graph."""
    P = g.poses.t.shape[0]
    is_sep = torch.arange(P, device=g.poses.t.device) % separator_stride == 0
    for _ in range(iterations):
        H, b = build_normal_equations(g)
        g = _step(g, solve_schur(H, b, is_sep) if use_schur else solve_direct(H, b))
    return g


def make_refine_sharded(mesh, axis: str = "dp", iterations: int = 10,
                        use_schur: bool = False, separator_stride: int = 4):
    """Edge-sharded refinement over the ranks of one mesh axis (the JAX
    `make_refine_sharded`). Returns run(g): g, the same on every rank of the
    axis, has its edges padded to a multiple of the axis size (pad_edges;
    padding is masked invalid). Each rank takes its contiguous 1/N of the
    edges and builds its part of the normal equations; one sum per
    Gauss-Newton iteration (of H, then of b) gives every rank the same
    system, and every rank solves it (direct or Schur). The poses stay
    replicated; run returns g with the refined poses."""
    group = mesh.axis(axis)

    def run(g: PoseGraph) -> PoseGraph:
        E, n = g.edge_i.shape[0], group.size
        if E % n:
            raise ValueError(f"pad edges to a multiple of {n} (got {E})")
        mine = slice(group.rank * (E // n), (group.rank + 1) * (E // n))
        local = g._replace(edge_i=g.edge_i[mine], edge_j=g.edge_j[mine],
                           edge_z=se3.Pose(g.edge_z.t[mine], g.edge_z.q[mine]),
                           edge_w_rot=g.edge_w_rot[mine], edge_w_t=g.edge_w_t[mine],
                           edge_valid=g.edge_valid[mine])
        P = g.poses.t.shape[0]
        is_sep = torch.arange(P, device=g.poses.t.device) % separator_stride == 0
        for _ in range(iterations):
            H, b = build_normal_equations(local, group)
            local = _step(local, solve_schur(H, b, is_sep) if use_schur
                          else solve_direct(H, b))
        return g._replace(poses=local.poses)

    return run


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def chain_from_odometry(poses_t, poses_q, closures=(), w_rot: float = 100.0,
                        w_t: float = 100.0, closure_w: float = 100.0,
                        device=None) -> PoseGraph:
    """Build a graph on `device` (default "cuda"): consecutive odometry
    edges + optional loop closures, a list of (i, j, Pose z_ij, weight).

    The edges are computed on the host in float32 and each array moves to
    the device once."""
    dev = resolve_device(device)
    pt, pq = _host(poses_t), _host(poses_q)
    P = pt.shape[0]
    host = lambda x: torch.from_numpy(x)  # noqa: E731
    z = se3.relative_to(se3.Pose(host(pt[:-1]), host(pq[:-1])),
                        se3.Pose(host(pt[1:]), host(pq[1:])))
    ei, ej = list(range(P - 1)), list(range(1, P))
    zt, zq = [z.t.numpy()], [z.q.numpy()]
    wr, wt = [w_rot] * (P - 1), [w_t] * (P - 1)
    for (i, j, zc, w) in closures:
        ei.append(i)
        ej.append(j)
        zt.append(_host(zc.t).reshape(1, 3))
        zq.append(_host(zc.q).reshape(1, 4))
        wr.append(w * closure_w)
        wt.append(w * closure_w)
    E = len(ei)
    return PoseGraph(
        poses=se3.Pose(to_torch(pt, dev), to_torch(pq, dev)),
        edge_i=to_torch(np.asarray(ei, np.int64), dev),
        edge_j=to_torch(np.asarray(ej, np.int64), dev),
        edge_z=se3.Pose(to_torch(np.concatenate(zt), dev), to_torch(np.concatenate(zq), dev)),
        edge_w_rot=to_torch(np.asarray(wr, np.float32), dev),
        edge_w_t=to_torch(np.asarray(wt, np.float32), dev),
        edge_valid=to_torch(np.ones(E, bool), dev),
    )
