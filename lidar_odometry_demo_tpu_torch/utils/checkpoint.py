"""Checkpoint / resume of odometry state as npz (port of the JAX
``utils/checkpoint.py``: `save_npz`, `load_npz` and the v1-v5 migrations).

The reference has no persistence: keyframe map and poses live in RAM and
odometry restarts from identity on every launch (lidar_odometry.cpp:15-17).
Here the whole state is one named tuple of tensors, so it saves as one npz
of host arrays. The file format is the JAX package's, field for field and
version for version: a file written by either package loads in the other.
The migrations are this package's own numpy copy. A batched state (a
leading lane axis on every field) saves and loads the same way.

In place of the JAX package's orbax checkpoint (`save_orbax` /
`load_orbax`, multi-host) the sharded modes save with
torch.distributed.checkpoint (`save_sharded` / `load_sharded`): a
directory that every rank of a mesh writes together. Each rank writes its
map shard (a column shard under the spatial mode, its lanes' maps under
dp) and the poses of its lanes, which the ranks of one sp group hold
alike and which are written once; a resumed run continues as the
uninterrupted run would.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_odometry_demo_tpu_torch.device import resolve_device, to_torch
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.se3 import Pose
from lidar_odometry_demo_tpu_torch.pipeline.odometry import OdometryState

_FIELDS = (
    ["keyframe." + f for f in vm.VoxelMap._fields]
    + ["current.t", "current.q", "previous.t", "previous.q"]
)

# npz layout versions (the JAX package's):
#   (untagged)  round-1 layout: keyframe.{keys,count,pts,nrm,origin} with the
#               payload permuted into key order
#   2           keyframe.{meta,occ,pts,nrm,origin}: sorted logical index over
#               immutable physical rows
#   3           keyframe.{tab,origin,kdim}: fused sorted table, 136-lane rows
#               (int count lane at MB+1, anchor at MB+2..MB+4)
#   4           keyframe.{tab,origin,kdim}: fused table, 128-lane rows (key at
#               MB, anchor at MB+1..MB+3, f32 count lane at 3K); point lanes
#               interleaved xyzxyz
#   5           as v4 but point lanes planar (xx..yy..zz)
#   6           keyframe.{tab,keys,count,origin,kdim}: keys and counts in
#               separate (C,) vectors; anchor at MB..MB+3; the f32 lane at 3K
#               the search copy of the count (vm._lanes)
FORMAT_VERSION = 6


def _legacy_lanes_v45(k: int):
    """Row-lane layout of formats v4-v5 (key lane at MB, anchor MB+1..MB+4)."""
    def a8(n):
        return -(-n // 8) * 8

    rw = a8(3 * k + 1)
    mb = rw + 3 * k
    return rw, mb, a8(mb + 4)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_npz(path: str, state: OdometryState) -> None:
    """Write `state` (tensors on any device) as a format-v6 npz."""
    flat = {"keyframe." + f: getattr(state.keyframe, f) for f in vm.VoxelMap._fields}
    flat.update({
        "current.t": state.current.t,
        "current.q": state.current.q,
        "previous.t": state.previous.t,
        "previous.q": state.previous.q,
    })
    arrays = {k: _host(v) for k, v in flat.items()}
    arrays["format_version"] = np.int32(FORMAT_VERSION)
    np.savez_compressed(path, **arrays)


def _assemble_map(keys, count, pts, nrm, anchor, origin) -> dict:
    """A v6 map's fields from key-ordered columns (host numpy): pts
    (c, k, 3) interleaved in -> planar x/y/z lane blocks; count lands both in
    the count vector and the in-row f32 search lane."""
    c, k = pts.shape[0], pts.shape[1]
    rw, mb, w = vm._lanes(k)
    tab = np.zeros((c, w), np.int32)
    tab[:, : 3 * k] = np.swapaxes(pts, 1, 2).reshape(c, 3 * k).view(np.int32)
    tab[:, 3 * k] = count.astype(np.float32).view(np.int32)
    tab[:, rw : rw + 3 * k] = nrm.reshape(c, 3 * k).view(np.int32)
    tab[:, mb : mb + 3] = anchor.view(np.int32)
    return dict(tab=tab, keys=keys.astype(np.int32), count=count.astype(np.int32),
                origin=np.asarray(origin, np.int32), kdim=np.zeros((1, k), np.int32))


def _check_tab_width(z, version: int, expected: int) -> None:
    """A truncated or malformed table fails here, before any lane is read
    from the wrong place."""
    got = z["keyframe.tab"].shape[-1]
    if got != expected:
        k = np.asarray(z["keyframe.kdim"]).shape[-1]
        raise ValueError(
            f"v{version} checkpoint table width {got} does not match the "
            f"K={k} lane layout width {expected}"
        )


def _migrate_v3(z) -> dict:
    """Round-3 136-lane fused table (int count lane; interleaved points)."""
    k = np.asarray(z["keyframe.kdim"], np.int32).shape[-1]
    rw = -(-(3 * k + 1) // 8) * 8
    mb_old = -(-(rw + 3 * k) // 8) * 8  # v3: key, int count, anchor
    _check_tab_width(z, 3, -(-(mb_old + 5) // 8) * 8)
    tab_old = np.asarray(z["keyframe.tab"], np.int32)
    keys = tab_old[:, mb_old]
    count = tab_old[:, mb_old + 1]
    pts = tab_old[:, : 3 * k].view(np.float32).reshape(-1, k, 3)
    nrm = tab_old[:, rw : rw + 3 * k].view(np.float32).reshape(-1, k, 3)
    anchor = tab_old[:, mb_old + 2 : mb_old + 5].view(np.float32)
    return _assemble_map(keys, count, pts, nrm, anchor, z["keyframe.origin"])


def _migrate_v4(z, planar: bool) -> dict:
    """Round-4/5 128-lane tables (key at MB, anchor MB+1..MB+4, f32 count
    at 3K). planar=False (v4): point lanes interleaved xyzxyz;
    planar=True (v5): already planar."""
    k = np.asarray(z["keyframe.kdim"], np.int32).shape[-1]
    rw, mb, w_old = _legacy_lanes_v45(k)
    _check_tab_width(z, 5 if planar else 4, w_old)
    tab = np.asarray(z["keyframe.tab"], np.int32)
    keys = tab[:, mb]
    count = tab[:, 3 * k].view(np.float32).astype(np.int32)
    raw_pts = tab[:, : 3 * k].view(np.float32)
    if planar:
        pts = np.swapaxes(raw_pts.reshape(-1, 3, k), 1, 2)  # planar -> (c, k, 3)
    else:
        pts = raw_pts.reshape(-1, k, 3)
    nrm = tab[:, rw : rw + 3 * k].view(np.float32).reshape(-1, k, 3)
    anchor = tab[:, mb + 1 : mb + 4].view(np.float32)
    return _assemble_map(keys, count, pts, nrm, anchor, z["keyframe.origin"])


def _migrate_v1(z) -> dict:
    """Round-1 layout: payload already in key order."""
    pts = np.asarray(z["keyframe.pts"], np.float32)
    return _assemble_map(np.asarray(z["keyframe.keys"], np.int32),
                         np.asarray(z["keyframe.count"], np.int32), pts,
                         np.asarray(z["keyframe.nrm"], np.float32), pts[:, 0, :].copy(),
                         z["keyframe.origin"])


def _migrate_v2(z) -> dict:
    """Round-2 layout: sorted meta index over physical payload rows."""
    meta = np.asarray(z["keyframe.meta"], np.int32)
    pts = np.asarray(z["keyframe.pts"], np.float32)
    nrm = np.asarray(z["keyframe.nrm"], np.float32)
    keys, count, row = meta[:, 0], meta[:, 1], meta[:, 2]
    anchor = meta[:, 3:6].copy().view(np.float32)
    return _assemble_map(keys, count, pts[row], nrm[row], anchor, z["keyframe.origin"])


def _load_v6(z, version: int) -> dict:
    missing = [f for f in _FIELDS if f not in z]
    if missing:
        raise ValueError(f"checkpoint missing fields: {missing} (format version {version})")
    k = np.asarray(z["keyframe.kdim"]).shape[-1]
    _check_tab_width(z, version, vm._lanes(k)[2])
    rows = z["keyframe.tab"].shape[:-1]  # (C,), or (B, C) for a batched state
    for f in ("keys", "count"):
        if z["keyframe." + f].shape != rows:
            raise ValueError(
                f"v{version} checkpoint keyframe.{f} shape {z['keyframe.' + f].shape} "
                f"does not match the table capacity {rows}")
    return {f: np.asarray(z["keyframe." + f]) for f in vm.VoxelMap._fields}


def load_npz(path: str, device=None) -> OdometryState:
    """Read an npz of any format version (v1-v6) onto `device` (default
    "cuda"; raises if there is none). Raises ValueError on an unknown
    version or a malformed file."""
    dev = resolve_device(device)
    z = np.load(path)
    if "keyframe.tab" in z:
        # v3 vs v4 vs v5 branch on the stored format_version: their table
        # widths coincide for many max_points values, so a width compare
        # would read key, count and anchor from the wrong lanes
        version = int(z["format_version"]) if "format_version" in z else 3
        if version == 3:
            keyframe = _migrate_v3(z)
        elif version in (4, 5):
            keyframe = _migrate_v4(z, planar=version == 5)
        elif version == FORMAT_VERSION:
            keyframe = _load_v6(z, version)
        else:
            raise ValueError(
                f"unknown checkpoint format_version {version} "
                f"(this build reads v1-v{FORMAT_VERSION})"
            )
    elif "keyframe.meta" in z:
        keyframe = _migrate_v2(z)
    elif "keyframe.keys" in z and "keyframe.pts" in z:
        keyframe = _migrate_v1(z)
    else:
        raise ValueError(
            "unrecognized checkpoint layout: expected keyframe.tab (v3+), "
            "keyframe.meta (v2) or keyframe.keys+pts (v1); the voxel-map "
            "layout changed to a fused single-array sorted table in v3"
        )

    def leaf(x, dtype):
        return to_torch(np.asarray(x, dtype), dev)

    def pose(name):
        return Pose(leaf(z[name + ".t"], np.float32), leaf(z[name + ".q"], np.float32))

    return OdometryState(
        keyframe=vm.VoxelMap(**{f: leaf(keyframe[f], np.int32) for f in vm.VoxelMap._fields}),
        current=pose("current"), previous=pose("previous"))


def _sharded_names(state: OdometryState, mesh) -> dict:
    """`state`'s tensors by their names in a sharded checkpoint: the map
    under this rank's (dp, sp) place, the poses under its dp index (the
    same tensors on every rank of its sp group)."""
    dp, sp = mesh.dp_index, mesh.sp_index
    flat = {f"dp{dp}.sp{sp}.keyframe.{f}": getattr(state.keyframe, f)
            for f in vm.VoxelMap._fields}
    for name in ("current", "previous"):
        pose = getattr(state, name)
        flat[f"dp{dp}.{name}.t"] = pose.t
        flat[f"dp{dp}.{name}.q"] = pose.q
    return flat


def save_sharded(path: str, state: OdometryState, mesh) -> None:
    """Write this rank's `state` into the sharded checkpoint directory
    `path`: every rank of the mesh (parallel/mesh.py) calls this together
    with its own state (torch.distributed.checkpoint)."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_sharded_names(state, mesh), checkpoint_id=path)


def load_sharded(path: str, like: OdometryState, mesh) -> OdometryState:
    """Read this rank's state from the sharded checkpoint `path` into
    tensors shaped and placed as `like`'s (e.g. a fresh
    spatial.init_spatial_state); every rank calls this together."""
    import torch.distributed.checkpoint as dcp

    flat = {k: torch.empty_like(v) for k, v in _sharded_names(like, mesh).items()}
    dcp.load(flat, checkpoint_id=path)
    v = list(flat.values())  # in _sharded_names' order: the map, current, previous
    n = len(vm.VoxelMap._fields)
    return OdometryState(keyframe=vm.VoxelMap(*v[:n]), current=Pose(*v[n:n + 2]),
                         previous=Pose(*v[n + 2:]))
