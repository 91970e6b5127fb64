"""The column-sharded keyframe map with a halo exchange (port of the JAX
``parallel/spatial.py``), one rank per shard.

The reference's keyframe map is one hash grid (src/voxel_grid.h:17-257),
and its 27-neighbourhood search (voxel_grid.h:164-204) reads the 3x3x3
voxels around every query. Sharding the map across ranks (BASELINE.json's
north star: the keyframe map's blocks partitioned across hosts) keeps that
search exact as follows.

**Interleaved column ownership.** Rank d of N owns every (x, y) map
column whose x index gx (the map window's, `column_gx`) has gx mod N == d,
and holds only those columns, in a sorted-key VoxelMap of capacity C/N.

**Rebase-stable ownership.** Keys are relative to the map's origin, and a
rebase by delta moves every column's gx by -delta_x. The sharded pipeline
therefore rebases in steps of N (`map_update(origin_quantum=N)`), so that
gx mod N never changes: no voxel ever moves between ranks.

**One halo exchange per scan.** A query owned by rank d (its centre
column's gx mod N == d) reads the columns gx - 1 and gx + 1, owned by ranks
d - 1 and d + 1 (mod N). The map is frozen for the whole ICP solve
(cloud_matcher.cpp:138-139), so each rank receives its two ring
neighbours' shards (tab, keys, count) once per scan (`Group.ppermute_from`)
and every ICP round then runs on its own rank.

**The composite view** is a redesign of the JAX module's. The JAX package
fuses the three blocks through its dense column directory and `desc` words;
the port has neither: kernel K3 searches sorted keys. So the port merges
the blocks' rows into one key-sorted table: a stable sort of the
concatenated keys (EMPTY_KEY, the largest int32, last), then the same
permutation of `tab` and `count`. Every column has exactly one owner, so
the blocks' keys are disjoint, and the merged table orders each column's
voxels as the replicated table does: K3's neighbourhood lookup and K1 run
on it unchanged and give the replicated search's correspondences, in the
same (column, z, k) first-minimum order. Its capacity, 2C/N or 3C/N rows,
need not be a power of two: K3 derives its search steps from C.

At N = 2 "next" and "prev" are one rank, whose block is taken once (the
merged table would hold its keys twice otherwise); at N = 1 the local map
is the view, with no exchange. map_update's group lookup keeps using the
local shard. The exchange moves whole shards, as the JAX package does.
"""

from __future__ import annotations

import torch

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.kernels.search import _GHALF
from lidar_odometry_demo_tpu_torch.ops import se3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan, rows_at
from lidar_odometry_demo_tpu_torch.pipeline import odometry


def column_gx(xyz: torch.Tensor, origin: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """x index of each point's map column in the map window: the voxel's x
    relative to the origin, plus the window's half width (JAX spatial.py
    `column_gx`). xyz (..., N, 3), origin (3,) or (B, 3) over lanes."""
    return vm.voxel_indices(xyz, voxel_size)[..., 0] - origin[..., 0:1] + _GHALF


def owner_mask(xyz: torch.Tensor, origin: torch.Tensor, voxel_size: float, group
               ) -> torch.Tensor:
    """True where this rank owns the point's column (gx mod N == rank in
    the group). Stable across rebases when the origin's x is a multiple of
    N (map_update's origin_quantum=N)."""
    gx = column_gx(xyz, origin, voxel_size)
    return torch.remainder(gx, group.size) == group.rank


def build_halo_view(m: vm.VoxelMap, group) -> vm.VoxelMap:
    """The composite view: this rank's shard merged with its ring
    neighbours' (ranks r + 1 and r - 1 of the group; one block at N = 2, the
    shard itself at N = 1) into one key-sorted VoxelMap of 2C/N or 3C/N
    rows. Every locally owned query finds its whole 3x3 column
    neighbourhood in it, in the replicated table's order."""
    n = group.size
    if n == 1:
        return m

    def from_rank(offset):  # rank r + offset's shard
        tab, keys, count = group.ppermute_from([m.tab, m.keys, m.count], offset)
        return m._replace(tab=tab, keys=keys, count=count)

    return merge_blocks([m, from_rank(1)] + ([from_rank(n - 1)] if n > 2 else []))


def merge_blocks(blocks: list[vm.VoxelMap]) -> vm.VoxelMap:
    """Shards with disjoint keys (and one origin) merged into one key-sorted
    VoxelMap: a stable sort of the concatenated keys (EMPTY_KEY last), the
    same permutation of their rows and counts."""
    keys, order = torch.sort(torch.cat([b.keys for b in blocks], dim=-1), dim=-1, stable=True)
    tab = rows_at(torch.cat([b.tab for b in blocks], dim=-2), order)
    count = torch.gather(torch.cat([b.count for b in blocks], dim=-1), -1, order)
    return blocks[0]._replace(tab=tab, keys=keys, count=count)


def _run_steps(step, state, scans):
    diags = []
    for scan in scans:
        state, diag = step(state, scan)
        diags.append(diag)
    return state, odometry.stack_diagnostics(diags)


def make_spatial_step(cfg: OdometryConfig, mesh):
    """(shard state, scan) -> (shard state, diagnostics): one odometry scan
    with the keyframe map column-sharded over the mesh's sp group. The state
    is this rank's shard (init_spatial_state); the scan is the same on
    every rank of the group, and so are the diagnostics (the pose is the
    group's, map_voxels the shards' sum)."""
    return odometry.make_process_scan(cfg, spatial_group=mesh.sp)


def make_spatial_sequence_runner(cfg: OdometryConfig, mesh):
    """run(shard state, scans) -> (final shard state, stacked diagnostics)
    over a list of LidarScans, one spatial step per scan."""
    step = make_spatial_step(cfg, mesh)

    def run(state: odometry.OdometryState, scans: list[LidarScan]):
        return _run_steps(step, state, scans)

    return run


def make_batched_spatial_sequence_runner(cfg: OdometryConfig, mesh):
    """The full mesh: independent sequences over dp, each sequence's map
    column-sharded over sp, with the halo exchange per scan.

    run(shard states, scans_b) -> (final shard states, diagnostics (S, L)):
    scans_b a LidarScan with leading (S, B, ...) axes, the same on every
    rank; this rank steps its dp index's L = B / dp lanes
    (`mesh.lanes(B)`), whose shard states (L, ...) it holds
    (init_batched_spatial_state(cfg, L, sp))."""
    step = odometry.make_process_scan(cfg, spatial_group=mesh.sp)

    def run(state_b: odometry.OdometryState, scans_b: LidarScan):
        mine = mesh.lanes(scans_b.xyz.shape[1])
        local = LidarScan(*(x[:, mine] for x in scans_b))
        return _run_steps(step, state_b, [LidarScan(*(x[s] for x in local))
                                          for s in range(local.xyz.shape[0])])

    return run


def init_spatial_state(cfg: OdometryConfig, n_shards: int, device=None
                       ) -> odometry.OdometryState:
    """This rank's fresh shard state: an empty map of capacity
    map_capacity // n_shards (every rank's is the same), identity poses, on
    `device` (default "cuda"). The shard capacity must be divisible by 16,
    as the JAX package requires (its composite directory's packed rows), so
    the two accept and refuse the same configurations."""
    shard_cap = cfg.map_capacity // n_shards
    if shard_cap % 16:
        raise ValueError(f"map_capacity // n_shards = {shard_cap} must be 16-divisible")
    one = odometry.init_state(cfg, device)
    return one._replace(keyframe=vm.map_init(shard_cap, cfg.keyframe_max_points_cnt,
                                             one.keyframe.tab.device))


def init_batched_spatial_state(cfg: OdometryConfig, lanes: int, n_shards: int, device=None
                               ) -> odometry.OdometryState:
    """`lanes` stacked shard states (init_spatial_state), a leading lane
    axis on every field: this rank's shards of its lanes' maps."""
    one = init_spatial_state(cfg, n_shards, device)

    def stacked(x):
        return x.expand(lanes, *x.shape).clone()

    return odometry.OdometryState(
        keyframe=vm.VoxelMap(*(stacked(x) for x in one.keyframe)),
        current=se3.Pose(*(stacked(x) for x in one.current)),
        previous=se3.Pose(*(stacked(x) for x in one.previous)))
