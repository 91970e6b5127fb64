"""The keyframe map's per-scan update (``map_update.cu``): evict, rebase and
insert (ops/voxel_map.py `map_update`, `map_insert`, `radius_cleanup`) with
the update points' world transform before it and the step's two map
diagnostics after it, as one call; its plain PyTorch version; its launch
counter.

Replaces no TPU kernel: the JAX package writes the update as array code and
leaves it to XLA. The port's plain version (`voxel_map._update_impl`, kept as
the CPU path and the reference) runs as ~280 PyTorch kernels a scan, among
them two single-row scans, a stable sort of the C + N keys and two passes
over an extended copy of the table. `map_update` runs it as four launches
around the incoming keys' library sort and K3's group lookup, for any
number of lanes (see the source's note); one call counts once in
`map_update.launches`. On CPU tensors it runs its plain version; on CUDA
tensors it launches the kernels or raises. There is no fallback between the
two. The output is bitwise the plain version's: the whole table (the lanes
beyond a row's count and the rows beyond the map's size included), keys,
count, origin and both diagnostics.

The map's keys must be sorted (the VoxelMap invariant), and a rebase moves
the origin by less than 512 voxels along x (a larger move takes every voxel
out of the map window; the key shift would then wrap int32 and the old rows'
order, which the merge uses, would not hold).

Lanes: the map, the points and the poses may carry a leading lane axis B
(independent sequences); one call serves all lanes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from lidar_odometry_demo_tpu_torch.kernels import _build
from lidar_odometry_demo_tpu_torch.kernels._build import check_tensors, lanes
from lidar_odometry_demo_tpu_torch.ops import preprocess, se3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.cloud import PointsWithNormals

# pass 1 takes 256 points a block (one dropped count each); passes 2 and 3
# take 1,024 rows or points a block and keep every block's count of a lane
# in shared memory (map_update.cu kThreads, kChunk, kMaxChunks)
_THREADS, _CHUNK, _MAX_CHUNKS = 256, 1024, 1024


class MapUpdate(NamedTuple):
    """The update's outputs, each with the map's lane axis, if any."""

    keyframe: vm.VoxelMap   # the new map
    size: torch.Tensor      # int32: its occupied voxels (vm.map_size)
    dropped: torch.Tensor   # int32: valid points outside the map window at the new origin


def map_update_plain(m: vm.VoxelMap, new: PointsWithNormals, *, voxel_size: float,
                     center: torch.Tensor | None = None, radius: float | None = None,
                     origin_quantum: int = 1, pose: se3.Pose | None = None, owner=None,
                     tab_out: torch.Tensor | None = None) -> MapUpdate:
    """The update as the composition of its functions (the step's map
    maintenance, lidar_odometry.cpp:67-70), on any device.

    pose: the points' frame, where they are not world points yet
    (preprocess.transform_with_normals). owner: a group (rank, size) whose
    rank inserts only the map columns it owns, at the map's old origin
    (parallel/spatial.py owner_mask). center None: map_insert (the origin
    kept, nothing evicted); else radius_cleanup and map_insert in one pass,
    rebased to `center` (vm.update_plain)."""
    if pose is not None:
        new = preprocess.transform_with_normals(new, pose)
    if owner is not None:
        from lidar_odometry_demo_tpu_torch.parallel import spatial

        new = new._replace(valid=new.valid & spatial.owner_mask(new.xyz, m.origin, voxel_size,
                                                                owner))
    keyframe = vm.update_plain(m, new, center, voxel_size=voxel_size, radius=radius,
                               origin_quantum=origin_quantum, tab_out=tab_out)
    keys = vm.pack_keys(vm.voxel_indices(new.xyz, voxel_size), keyframe.origin, new.valid,
                        map_window=True)
    dropped = torch.sum(new.valid & (keys == vm.EMPTY_KEY), dim=-1, dtype=torch.int32)
    return MapUpdate(keyframe=keyframe, size=vm.map_size(keyframe), dropped=dropped)


def map_update(m: vm.VoxelMap, new: PointsWithNormals, *, voxel_size: float,
               center: torch.Tensor | None = None, radius: float | None = None,
               origin_quantum: int = 1, pose: se3.Pose | None = None, owner=None,
               tab_out: torch.Tensor | None = None) -> MapUpdate:
    """The update: the plain version on CPU tensors, four kernel launches
    (and the library sort and K3's group lookup between them) on CUDA ones.

    m: the map, tab (C, W), keys and count (C,), origin (3,) int32; new: N
    points, xyz and normal (N, 3) float32, valid (N,) bool, in the frame of
    `pose` (t (3,), q (4,) float32) where it is given, else in the world;
    center (3,) float32 with radius, or neither; each may carry a leading
    lane axis B. tab_out: the buffer the new table is written into, m.tab
    itself allowed (then copied first to a scratch buffer); a new tensor
    where None. Arguments as map_update_plain's."""
    if m.keys.device.type == "cpu":
        return map_update_plain(m, new, voxel_size=voxel_size, center=center, radius=radius,
                                origin_quantum=origin_quantum, pose=pose, owner=owner,
                                tab_out=tab_out)
    lead = tuple(m.keys.shape[:-1])
    B, C, N, K = lanes(lead), m.keys.shape[-1], new.valid.shape[-1], m.max_points
    RW, MB, W = vm._lanes(K)
    specs = [(m.tab, "m.tab", torch.int32, (*lead, C, W)),
             (m.keys, "m.keys", torch.int32, (*lead, C)),
             (m.count, "m.count", torch.int32, (*lead, C)),
             (m.origin, "m.origin", torch.int32, (*lead, 3)),
             (new.xyz, "new.xyz", torch.float32, (*lead, N, 3)),
             (new.normal, "new.normal", torch.float32, (*lead, N, 3)),
             (new.valid, "new.valid", torch.bool, (*lead, N))]
    if pose is not None:
        specs += [(pose.t, "pose.t", torch.float32, (*lead, 3)),
                  (pose.q, "pose.q", torch.float32, (*lead, 4))]
    if center is not None:
        specs.append((center, "center", torch.float32, (*lead, 3)))
    if tab_out is not None:
        specs.append((tab_out, "tab_out", torch.int32, (*lead, C, W)))
    check_tensors(*specs)
    if (center is None) != (radius is None):
        raise ValueError("center and radius go together (neither: map_insert)")
    if C == 0 or K == 0:
        raise ValueError("the map update needs a table of at least one row and one point a row")
    if -(-C // _CHUNK) > _MAX_CHUNKS or -(-N // _CHUNK) > _MAX_CHUNKS:
        raise ValueError(f"at most {_CHUNK * _MAX_CHUNKS} rows and points, got C = {C}, N = {N}")
    if origin_quantum < 1:
        raise ValueError(f"origin_quantum must be at least 1, got {origin_quantum}")
    for t, name in ((m.tab, "m.tab"), (tab_out, "tab_out")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    dev = m.keys.device
    i32, u8 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.uint8, device=dev)
    out = vm.VoxelMap(tab=torch.empty_like(m.tab) if tab_out is None else tab_out,
                      keys=torch.empty((*lead, C), **i32), count=torch.empty((*lead, C), **i32),
                      origin=torch.empty((*lead, 3), **i32), kdim=m.kdim)
    size, dropped = torch.empty(lead, **i32), torch.empty(lead, **i32)
    if B == 0:
        return MapUpdate(out, size, dropped)
    in_place = (tab_out is not None and tab_out.untyped_storage().data_ptr()
                == m.tab.untyped_storage().data_ptr())
    scratch = torch.empty_like(m.tab) if in_place else None
    pts, nrm = ((torch.empty_like(new.xyz), torch.empty_like(new.normal)) if pose is not None
                else (new.xyz, new.normal))
    keys_in = torch.empty((*lead, N), **i32)
    keys1, row_flag = torch.empty((*lead, C), **i32), torch.empty((*lead, C), **u8)
    dropped_part = torch.empty((B, -(-N // _THREADS)), **i32)
    r2 = 0.0 if radius is None else float(radius) * float(radius)
    null = ctypes.c_void_p(None)

    def ptr(t):
        return null if t is None else t.data_ptr()

    prologue = _build.c_function("map_update", "map_update_prologue_launch",
                                 [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                                 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 9)
    _build.launch(prologue, dev, m.tab.data_ptr(), m.keys.data_ptr(), m.origin.data_ptr(),
                  new.xyz.data_ptr(), new.normal.data_ptr(), new.valid.data_ptr(),
                  ptr(None if pose is None else pose.t), ptr(None if pose is None else pose.q),
                  ptr(center), B, C, N, K, W, RW, MB, int(pose is not None),
                  int(center is not None), origin_quantum,
                  0 if owner is None else owner.rank, 0 if owner is None else owner.size,
                  float(np.float32(voxel_size)), r2, ptr(pts if pose is not None else None),
                  ptr(nrm if pose is not None else None), keys_in.data_ptr(),
                  dropped_part.data_ptr(), keys1.data_ptr(), row_flag.data_ptr(),
                  out.origin.data_ptr(), ptr(scratch))
    if N:
        skeys, perm = torch.sort(keys_in, dim=-1, stable=True)
        pos_c, found = vm.group_lookup(keys1, skeys)  # K3, as the plain version calls it
    else:
        skeys, perm = keys_in, torch.empty((*lead, 0), dtype=torch.int64, device=dev)
        pos_c, found = keys_in, torch.empty((*lead, 0), dtype=torch.bool, device=dev)
    nwr, nwn = -(-C // 32), -(-N // 32)
    live_words, fresh_words = torch.empty((B, nwr), **i32), torch.empty((B, nwn), **i32)
    live_count = torch.empty((B, -(-C // _CHUNK)), **i32)
    fresh_count = torch.empty((B, -(-N // _CHUNK)), **i32)
    desc = torch.empty((B, C, 4), **i32)
    finish = _build.c_function("map_update", "map_update_finish_launch",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p] * 18)
    _build.launch(finish, dev, (m.tab if scratch is None else scratch).data_ptr(),
                  m.count.data_ptr(), pts.data_ptr(), nrm.data_ptr(), B, C, N, K, W, RW, MB,
                  keys1.data_ptr(), row_flag.data_ptr(), skeys.data_ptr(), perm.data_ptr(),
                  pos_c.data_ptr(), found.data_ptr(), dropped_part.data_ptr(),
                  live_words.data_ptr(), live_count.data_ptr(), fresh_words.data_ptr(),
                  fresh_count.data_ptr(), desc.data_ptr(), out.tab.data_ptr(),
                  out.keys.data_ptr(), out.count.data_ptr(), size.data_ptr(),
                  dropped.data_ptr())
    map_update.launches += 1
    return MapUpdate(out, size, dropped)


map_update.launches = 0
