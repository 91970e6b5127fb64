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

The outer loop is built of three parts, which a CUDA graph can capture
(pipeline/graphs.py): `Align.begin` (the candidate gather and the loop's
carry in buffers of its own), `Align.round` (one round, updating the carry
in place: the pose and step norm, the rounds run, the stall count and the
best-pose bookkeeping) and `Align.finish` (the best-pose exit). The JAX
loop's condition is `Align.condition` (kernels/loop.py, a kernel on the
card), which reads only the carry and writes `go`. One schedule runs the
loop: the condition, then while any lane goes a round and the condition.
On the card the captured step without a group runs it on the device, as a
CUDA graph WHILE node with no host read; every other driver (the eager
step, the captured step under an NCCL group) runs it from the host
(`run_rounds`), which reads `go` after each round's condition, one
synchronisation per round. No tensor is made from host data inside the
three parts or the condition.

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
norm unchanged; every other update is masked) through the carry's (B,)
`active` buffer, which is `go`: the condition writes it on every path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.device import HostFlags, constant
from lidar_odometry_demo_tpu_torch.kernels.jtwj import (
    GnWork, gn_epilogue, gn_step, gn_sum_step, jtwj_accumulate, sum_in_rank_order)
from lidar_odometry_demo_tpu_torch.kernels.loop import loop_condition, loop_condition_plain
from lidar_odometry_demo_tpu_torch.kernels.search import query_world
from lidar_odometry_demo_tpu_torch.ops import se3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm


class IcpResult(NamedTuple):
    pose: se3.Pose
    iterations: torch.Tensor   # outer iterations executed (int32)
    step_norm: torch.Tensor    # last GN step norm
    num_matches: torch.Tensor  # correspondences of the returned pose's round


class IcpLoop(NamedTuple):
    """One scan's ICP loop: the carry, which every round updates in place,
    and the round's inputs and workspaces. The pose and step norm being
    iterated are K2's last slot (`pose`, `step_norm`), where each round's
    last step writes them. The JAX loop's carry (pose, i, step_norm,
    n_matches, best_cost, best_pose, best_matches, stall) is all here."""

    query_xyz: torch.Tensor     # (..., Q, 3) local
    query_valid: torch.Tensor   # (..., Q), this rank's queries where owner_fn is given
    guess: se3.Pose
    cand: vm.CandidateSet       # gathered at the guess, or rewritten every round
    nrm_view: torch.Tensor      # the map's normal view, derived once per scan
    match_out: vm.Match         # K1's outputs, rewritten every round
    work: GnWork                # K2's outputs
    best_pose: se3.Pose
    best_cost: torch.Tensor
    best_matches: torch.Tensor
    n_matches: torch.Tensor     # the last round's matches (a frozen lane's last)
    iters: torch.Tensor         # rounds run, per lane (int32)
    stall: torch.Tensor         # rounds since the best cost last improved (int32)
    go: torch.Tensor            # the condition per lane (bool); over lanes `active` itself
    active: torch.Tensor | None  # (B,) over lanes: the lanes this round runs

    @property
    def pose(self) -> se3.Pose:
        return self.work.slots[-1][0]

    @property
    def step_norm(self) -> torch.Tensor:
        return self.work.slots[-1][1]


def _gn_steps(corr: vm.Correspondence, pose: se3.Pose, guess_t: torch.Tensor,
              cfg: OdometryConfig, work: GnWork | None = None,
              step_norm: torch.Tensor | None = None, active: torch.Tensor | None = None,
              group=None):
    """cfg.icp_inner_iterations Gauss-Newton steps on a fixed
    correspondence set (cloud_matcher.cpp:111,156-158): one K2 launch each
    on CUDA, with no tensor operation between them; step k writes slot k of
    `work` (allocated here if the caller has none), so the last step's pose
    and step norm are the views `work.slots[-1]`. Over a lane axis, a lane
    where `active` is false keeps `pose` and `step_norm`. With a `group` of
    more than one rank each step is split around the sum of the ranks' H
    and b: this rank's part at the round's pose (`jtwj_accumulate`), then
    per step the group's gather of the parts and one launch that adds them
    in rank order, takes the step and accumulates the next part at the new
    pose (`gn_sum_step`); the last gather's parts go to `gn_epilogue`. Per
    round: n K2 launches, n gathers and one K2e."""
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


class Align:
    """align(map, query_xyz (Q, 3) local, query_valid (Q,), guess)
    -> IcpResult, mirroring CloudMatcher::align (cloud_matcher.cpp:105-178):
    with cfg.icp_cached_candidates the candidates are gathered once at the
    guess pose; without it every round re-searches the map at its pose.
    Every argument may carry a leading lane axis B; the result then has it
    too (iterations, step norm and matches per lane).

    Calling it runs `begin`, the loop's schedule from the host
    (`run_rounds`), then `finish`; pipeline/graphs.py captures the three
    parts as CUDA graphs and, without a group, runs the same schedule on
    the device, under a WHILE node.

    `group` (parallel/mesh.py Group): the ranks that share this problem,
    each with its own queries (and, under a column-sharded map, its own
    map view); the counts, cost sums, H and b are summed over it in rank
    order, so every rank returns the same result. `owner_fn(m, q_world) ->
    bool mask` restricts a rank to the queries it owns (parallel/spatial.py):
    at the guess pose for the cached candidates, at the round's pose on the
    exact path, so the queries stay partitioned at every pose."""

    def __init__(self, cfg: OdometryConfig, group=None, owner_fn=None):
        self.cfg, self.group, self.owner_fn = cfg, group, owner_fn
        # the condition on `begin`'s carry (no round, no stall, step norm
        # 1e9), the same for every lane and known on the host
        self.starts = bool(loop_condition_plain(
            torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32),
            torch.tensor(1e9, dtype=torch.float32), cfg))
        self._go: dict = {}

    def begin(self, m: vm.VoxelMap, query_xyz: torch.Tensor, query_valid: torch.Tensor,
              guess: se3.Pose) -> IcpLoop:
        """The loop's start: the candidates at the guess (cached path) and
        the carry, in buffers of its own."""
        cfg = self.cfg
        dev = query_xyz.device
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        lead = tuple(query_xyz.shape[:-2])
        Q = query_xyz.shape[-2]
        if cfg.icp_cached_candidates:
            Rg = se3.quat_to_matrix(guess.q)
            if self.owner_fn is not None:  # the queries this rank owns at the guess
                query_valid = query_valid & self.owner_fn(
                    m, query_world(query_xyz, Rg, guess.t))
            cand = vm.gather_candidates(m, query_xyz, query_valid, guess.t, Rg,
                                        voxel_size=cfg.keyframe_voxel_size)
        else:  # K3's candidates, rewritten every round
            cand = vm.CandidateSet.empty(Q, vm._lanes(m.max_points)[0], dev, lead)
        work = GnWork.empty(cfg.icp_inner_iterations, dev, lead)
        pose, step_norm = work.slots[-1]
        pose.t.copy_(guess.t)
        pose.q.copy_(guess.q)
        step_norm.fill_(1e9)
        go = torch.ones(lead, dtype=torch.bool, device=dev)
        return IcpLoop(
            query_xyz=query_xyz, query_valid=query_valid, guess=guess, cand=cand,
            nrm_view=m.nrm, match_out=vm.Match.empty(Q, dev, lead), work=work,
            best_pose=se3.Pose(guess.t.clone(), guess.q.clone()),
            best_cost=torch.full(lead, 1e9, **f32), best_matches=torch.zeros(lead, **i32),
            n_matches=torch.zeros(lead, **i32), iters=torch.zeros(lead, **i32),
            stall=torch.zeros(lead, **i32), go=go, active=go if lead else None)

    def round(self, m: vm.VoxelMap, loop: IcpLoop) -> None:
        """One correspondence round on the lanes `loop.active` holds: the
        round's cost, the best-pose bookkeeping, the stall count and the
        Gauss-Newton steps, every result written into the carry."""
        cfg, group = self.cfg, self.group
        delta = cfg.icp_huber_delta
        pose, step_norm = loop.pose, loop.step_norm
        R = se3.quat_to_matrix(pose.q)
        # K2's pose is a view into its workspace: over lanes, at a stride
        # K1 and K3 do not take (one sequence's is contiguous already)
        t_now = pose.t.contiguous()
        if cfg.icp_cached_candidates:
            corr = vm.match_candidates(m, loop.cand, loop.query_xyz, loop.query_valid, t_now,
                                       R, max_distance=cfg.icp_max_correspondence_distance,
                                       nrm_view=loop.nrm_view, out=loop.match_out)
        else:  # re-search the table at the current pose every round
            round_valid = loop.query_valid if self.owner_fn is None else (
                loop.query_valid & self.owner_fn(m, query_world(loop.query_xyz, R, t_now)))
            corr = vm.find_correspondences(m, loop.query_xyz, round_valid, t_now, R,
                                           voxel_size=cfg.keyframe_voxel_size,
                                           max_distance=cfg.icp_max_correspondence_distance,
                                           nrm_view=loop.nrm_view, out=loop.match_out,
                                           cand_out=loop.cand)
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
        improved = cost < loop.best_cost * (1.0 - cfg.icp_stall_rel_tolerance)
        active = loop.active
        stall = torch.where(improved, 0, loop.stall + 1)
        if active is None:
            loop.n_matches.copy_(round_matches)
            loop.iters.add_(1)
            loop.stall.copy_(stall)
        else:  # a finished lane's carry stays as it is
            improved = improved & active
            torch.where(active, round_matches, loop.n_matches, out=loop.n_matches)
            loop.iters.add_(active)
            torch.where(active, stall, loop.stall, out=loop.stall)
        torch.where(improved[..., None], pose.t, loop.best_pose.t, out=loop.best_pose.t)
        torch.where(improved[..., None], pose.q, loop.best_pose.q, out=loop.best_pose.q)
        torch.where(improved, round_matches, loop.best_matches, out=loop.best_matches)
        torch.where(improved, cost, loop.best_cost, out=loop.best_cost)
        _gn_steps(corr, pose, loop.guess.t, cfg, loop.work, step_norm, active, group)

    def condition(self, loop: IcpLoop) -> torch.Tensor:
        """The JAX loop's condition per lane, from the carry, written to
        `loop.go` (over lanes the next round's `active`): one launch of the
        condition kernel on the card (kernels/loop.py)."""
        return loop_condition(loop.iters, loop.stall, loop.step_norm, self.cfg, out=loop.go)

    def run_rounds(self, loop: IcpLoop, round_fn) -> None:
        """The loop graph's schedule (kernels/loop.py `LoopGraph`) driven
        from the host: the condition, then while any lane goes
        `round_fn()` (which enqueues a round) and the condition, whose `go`
        the host reads, one wait per round. The first condition holds
        `self.starts` on every lane, so it is not read."""
        key = (loop.go.numel(), loop.go.device)
        go = self._go.get(key)
        if go is None:
            go = self._go[key] = HostFlags((loop.go.numel(),), torch.bool, loop.go.device)
        self.condition(loop)
        running = self.starts
        while running:
            round_fn()
            self.condition(loop)
            go.write(loop.go)
            go.mark()
            running = any(go.read())

    def finish(self, loop: IcpLoop) -> IcpResult:
        """The best-pose exit and the normalised pose."""
        pose, step_norm, n_matches = loop.pose, loop.step_norm, loop.n_matches
        if self.cfg.icp_best_pose_exit:
            tol = constant(float(self.cfg.icp_convergence_step_norm), torch.float32,
                           step_norm.device)
            converged = step_norm < tol
            pose = se3.pose_where(converged, pose, loop.best_pose)
            n_matches = torch.where(converged, n_matches, loop.best_matches)
        pose = se3.Pose(pose.t, se3.quat_normalize(pose.q))
        return IcpResult(pose, loop.iters, step_norm, n_matches)

    def __call__(self, m: vm.VoxelMap, query_xyz: torch.Tensor, query_valid: torch.Tensor,
                 guess: se3.Pose) -> IcpResult:
        loop = self.begin(m, query_xyz, query_valid, guess)
        self.run_rounds(loop, lambda: self.round(m, loop))
        return self.finish(loop)


def make_align(cfg: OdometryConfig, group=None, owner_fn=None) -> Align:
    """The ICP alignment of `cfg` (see Align)."""
    return Align(cfg, group=group, owner_fn=owner_fn)


def align(m: vm.VoxelMap, query_xyz: torch.Tensor, query_valid: torch.Tensor,
          guess: se3.Pose, cfg: OdometryConfig) -> IcpResult:
    """Convenience entry point: `make_align(cfg)`, built once per config."""
    return _cached_align(cfg)(m, query_xyz, query_valid, guess)


_ALIGN_CACHE: dict[OdometryConfig, Align] = {}


def _cached_align(cfg: OdometryConfig) -> Align:
    fn = _ALIGN_CACHE.get(cfg)
    if fn is None:
        fn = make_align(cfg)
        _ALIGN_CACHE[cfg] = fn
    return fn
