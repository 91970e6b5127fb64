"""Point-to-plane ICP with a hand-rolled Gauss-Newton solver on SE(3)
(port of the JAX ``ops/icp.py``; reference src/cloud_matcher.cpp:105-178).

- residual r_i = n_i . (R p_i + t - o_i), Huber IRLS weights
  w_i = min(1, delta/|r_i|), Jacobian J_i = [(R p_i) x n_i, n_i];
- Gauss-Newton steps, four per correspondence set, each one launch of
  kernel K2 (kernels/jtwj.py) on the card: the normal equations
  H = J^T W J, b = J^T W r, the reference's translation prior, light
  Levenberg damping, a 6x6 unrolled Cholesky solve and the pose update;
- an outer loop of correspondence rounds with the reference's schedule:
  convergence on the step norm after the minimum rounds, the 35-round cap,
  the stall exit and the best-pose exit. Each round re-matches the
  candidates cached once per scan at the guess pose
  (``icp_cached_candidates``, the default) or re-searches the map at the
  current pose (the reference's findMatchingPairs per round: one launch of
  kernel K3's neighbourhood lookup); kernel K1 picks the winners either way.

The outer loop is Python control flow: each round reads its exit condition
from the device (one synchronisation per round).

Groups (the JAX package's `axis_name`): with a group of ranks (an sp group,
each rank holding a slice of the queries, or a spatial group, each rank
holding the queries it owns under a column-sharded map, `owner_fn`), the
round's match count and cost sum are gathered from the group in one
collective and added in rank order, and each Gauss-Newton step is split
around the sum of H and b over the group: the ranks' parts are gathered and
added in rank order inside kernel K2 (kernels/jtwj.py `jtwj_accumulate`,
then per step a gather and `gn_sum_step`, the last gather's sum in
`gn_epilogue`). So every rank takes the same step and reads the same exit
condition (a decision read from a rank's own values would desynchronise the
group's collectives), with the same bits on every backend and any group
size. A group of size 1 runs the fused step.

Lanes: `align` also takes B independent problems at once (a leading lane
axis on the map, the queries and the guess), as the JAX package's
`while_loop` under `vmap` does: rounds go on while any lane's condition
holds, and a finished lane is frozen (kernel K2 returns its pose and step
norm unchanged; every other update is masked). Each lane's round counter
and stall count live on the host, beside the one read per round, so a
round costs no device work for them and the single-sequence path runs no
extra operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.kernels.jtwj import (
    GnWork, gn_epilogue, gn_step, gn_sum_step, jtwj_accumulate, sum_in_rank_order)
from lidar_odometry_demo_tpu_torch.kernels.search import query_world
from lidar_odometry_demo_tpu_torch.ops import se3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm


class IcpResult(NamedTuple):
    pose: se3.Pose
    iterations: torch.Tensor   # outer iterations executed (int32)
    step_norm: torch.Tensor    # last GN step norm
    num_matches: torch.Tensor  # correspondences of the returned pose's round


def _gn_steps(corr: vm.Correspondence, pose: se3.Pose, guess_t: torch.Tensor,
              cfg: OdometryConfig, work: GnWork | None = None,
              step_norm: torch.Tensor | None = None, active: torch.Tensor | None = None,
              group=None):
    """cfg.icp_inner_iterations Gauss-Newton steps on a fixed
    correspondence set (cloud_matcher.cpp:111,156-158): one K2 launch each
    on CUDA, with no tensor operation between them; step k writes slot k of
    `work` (allocated here if the caller has none). Over a lane axis, a
    lane where `active` is false keeps `pose` and `step_norm`. With a
    `group` of more than one rank each step is split around the sum of the
    ranks' H and b: this rank's part at the round's pose
    (`jtwj_accumulate`), then per step the group's gather of the parts and
    one launch that adds them in rank order, takes the step and accumulates
    the next part at the new pose (`gn_sum_step`); the last gather's parts
    go to `gn_epilogue`. Per round: n K2 launches, n gathers and one K2e."""
    n = cfg.icp_inner_iterations
    if work is None:
        work = GnWork.empty(n, pose.t.device, tuple(guess_t.shape[:-1]))
    if group is None or group.size == 1:
        for k in range(n):
            pose, step_norm, _, _ = gn_step(corr, pose, guess_t, cfg, work=work, slot=k,
                                            step_norm=step_norm, active=active)
        return pose, step_norm
    jtwj_accumulate(corr, pose, huber_delta=cfg.icp_huber_delta, work=work, active=active)
    for k in range(n - 1):
        parts = group.gather_parts(work.hb, "H,b")
        pose, step_norm = gn_sum_step(parts, corr, pose, guess_t, cfg, work=work, slot=k,
                                      step_norm=step_norm, active=active)
    return gn_epilogue(group.gather_parts(work.hb, "H,b"), pose, guess_t, cfg, work=work,
                       slot=n - 1, step_norm=step_norm, active=active)


def make_align(cfg: OdometryConfig, group=None, owner_fn=None):
    """align(map, query_xyz (Q, 3) local, query_valid (Q,), guess)
    -> IcpResult, mirroring CloudMatcher::align (cloud_matcher.cpp:105-178):
    with cfg.icp_cached_candidates the candidates are gathered once at the
    guess pose; without it every round re-searches the map at its pose.
    Every argument may carry a leading lane axis B; the result then has it
    too (iterations, step norm and matches per lane).

    `group` (parallel/mesh.py Group): the ranks that share this problem,
    each with its own queries (and, under a column-sharded map, its own
    map view); the counts, cost sums, H and b are summed over it in rank
    order, so every rank returns the same result. `owner_fn(m, q_world) ->
    bool mask` restricts a rank to the queries it owns (parallel/spatial.py):
    at the guess pose for the cached candidates, at the round's pose on the
    exact path, so the queries stay partitioned at every pose."""
    voxel_size = cfg.keyframe_voxel_size
    max_dist = cfg.icp_max_correspondence_distance
    delta = cfg.icp_huber_delta

    def align(m: vm.VoxelMap, query_xyz: torch.Tensor, query_valid: torch.Tensor,
              guess: se3.Pose) -> IcpResult:
        dev = query_xyz.device
        f32 = dict(dtype=torch.float32, device=dev)
        lead = tuple(query_xyz.shape[:-2])
        Q = query_xyz.shape[-2]
        if cfg.icp_cached_candidates:
            Rg = se3.quat_to_matrix(guess.q)
            if owner_fn is not None:  # the queries this rank owns at the guess
                query_valid = query_valid & owner_fn(m, query_world(query_xyz, Rg, guess.t))
            cand = vm.gather_candidates(m, query_xyz, query_valid, guess.t, Rg,
                                        voxel_size=voxel_size)
        else:  # K3's candidates, rewritten every round
            cand_out = vm.CandidateSet.empty(Q, vm._lanes(m.max_points)[0], dev, lead)
        nrm_view = m.nrm  # derived once per scan, not once per round
        # K1's and K2's outputs, allocated once and rewritten every round
        match_out = vm.Match.empty(Q, dev, lead)
        gn_work = GnWork.empty(cfg.icp_inner_iterations, dev, lead)
        tol = torch.tensor(cfg.icp_convergence_step_norm, **f32)

        pose = guess
        step_norm = torch.full(lead, 1e9, **f32)
        n_matches = torch.zeros(lead, dtype=torch.int32, device=dev)
        best_cost = torch.full(lead, 1e9, **f32)
        best_pose = guess
        best_matches = n_matches
        # per lane, on the host: rounds run, rounds without improvement, and
        # the last round's convergence flag (the JAX loop's carry)
        n_lanes = lead[0] if lead else 1
        i, stall, not_converged = [0] * n_lanes, [0] * n_lanes, [True] * n_lanes
        while True:
            go = [i[b] < cfg.icp_max_outer_iterations
                  and (not_converged[b] or i[b] <= cfg.icp_min_outer_iterations - 1)
                  and stall[b] < cfg.icp_stall_exit_rounds for b in range(n_lanes)]
            if not any(go):
                break
            # a finished lane's carry stays as it is (None: every lane runs)
            active = None if all(go) else torch.tensor(go, device=dev)
            R = se3.quat_to_matrix(pose.q)
            # K2's pose is a view into its workspace: over lanes, at a stride
            # K1 and K3 do not take (one sequence's is contiguous already)
            t_now = pose.t.contiguous()
            if cfg.icp_cached_candidates:
                corr = vm.match_candidates(m, cand, query_xyz, query_valid, t_now, R,
                                           max_distance=max_dist, nrm_view=nrm_view,
                                           out=match_out)
            else:  # re-search the table at the current pose every round
                round_valid = query_valid if owner_fn is None else (
                    query_valid & owner_fn(m, query_world(query_xyz, R, t_now)))
                corr = vm.find_correspondences(m, query_xyz, round_valid, t_now, R,
                                               voxel_size=voxel_size, max_distance=max_dist,
                                               nrm_view=nrm_view, out=match_out,
                                               cand_out=cand_out)
            round_matches = torch.sum(corr.valid, dim=-1, dtype=torch.int32)
            # robust mean cost of this pose on its own correspondence set
            p_w = se3.rot_pts(corr.source_local, R) + pose.t[..., None, :]
            r = torch.sum((p_w - corr.plane_origin) * corr.plane_normal, dim=-1)
            absr = torch.abs(r)
            hub = torch.where(absr <= delta, 0.5 * r * r, delta * (absr - 0.5 * delta))
            cost_sum = torch.sum(torch.where(corr.valid, hub, 0.0), dim=-1)
            if group is not None and group.size > 1:  # one gather of both
                sums = sum_in_rank_order(group.gather_parts(
                    torch.stack([cost_sum, round_matches.to(torch.float32)]), "matches,cost"))
                cost_sum, round_matches = sums[0], sums[1].to(torch.int32)
            cost = cost_sum / torch.clamp_min(round_matches.to(torch.float32), 1.0)
            improved = cost < best_cost * (1.0 - cfg.icp_stall_rel_tolerance)
            if active is None:
                n_matches = round_matches
            else:
                improved = improved & active
                n_matches = torch.where(active, round_matches, n_matches)
            best_pose = se3.pose_where(improved, pose, best_pose)
            best_matches = torch.where(improved, round_matches, best_matches)
            best_cost = torch.where(improved, cost, best_cost)
            pose, step_norm = _gn_steps(corr, pose, guess.t, cfg, gn_work, step_norm, active,
                                        group)
            # the round's one device read: every lane's exit conditions
            flags = torch.stack([step_norm >= tol, improved]).reshape(2, n_lanes).tolist()
            for b in range(n_lanes):
                if go[b]:
                    i[b] += 1
                    not_converged[b] = flags[0][b]
                    stall[b] = 0 if flags[1][b] else stall[b] + 1

        if cfg.icp_best_pose_exit:
            converged = step_norm < tol
            pose = se3.pose_where(converged, pose, best_pose)
            n_matches = torch.where(converged, n_matches, best_matches)
        pose = se3.Pose(pose.t, se3.quat_normalize(pose.q))
        iters = torch.tensor(i if lead else i[0], dtype=torch.int32, device=dev)
        return IcpResult(pose, iters, step_norm, n_matches)

    return align


def align(m: vm.VoxelMap, query_xyz: torch.Tensor, query_valid: torch.Tensor,
          guess: se3.Pose, cfg: OdometryConfig) -> IcpResult:
    """Convenience entry point: `make_align(cfg)`, built once per config."""
    return _cached_align(cfg)(m, query_xyz, query_valid, guess)


_ALIGN_CACHE: dict[OdometryConfig, object] = {}


def _cached_align(cfg: OdometryConfig):
    fn = _ALIGN_CACHE.get(cfg)
    if fn is None:
        fn = make_align(cfg)
        _ALIGN_CACHE[cfg] = fn
    return fn
