"""The map update's plain version (kernels/map_update.py `map_update` on CPU
tensors, the reference its CUDA kernels are held to bitwise on the card)
against the JAX package's map_update / radius_cleanup / map_insert, on the
cases of tests/_map_update_cases.py (CPU).

Tolerances: keys, count, origin, the map's size and the points dropped at
the map window bitwise equal; the table on live rows only, on the point and
normal lanes below count plus the count and anchor lanes
(test_torch_voxel_map._assert_maps_equal: the other lanes of a row may hold
stale data by design). Points in a scan frame go to the world through the
port's transform and, for the spatial case, through the port's owner mask
before the JAX package sees them.
"""

import _map_update_cases as cases
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_voxel_map import _assert_maps_equal

from lidar_odometry_demo_tpu.ops import cloud as jcloud
from lidar_odometry_demo_tpu.ops import voxel_map as jvm
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.kernels.map_update import map_update
from lidar_odometry_demo_tpu_torch.ops import preprocess
from lidar_odometry_demo_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_demo_tpu_torch.ops.cloud import PointsWithNormals
from lidar_odometry_demo_tpu_torch.parallel.spatial import owner_mask

_DRIVE: list = []


def _jax_lane(m: tvm.VoxelMap, new: PointsWithNormals, kw: dict):
    """The JAX package's update of one lane; its world points and valid
    flags are the port's (transform, owner mask)."""
    if kw["pose"] is not None:
        new = preprocess.transform_with_normals(new, kw["pose"])
    if kw["owner"] is not None:
        new = new._replace(valid=new.valid & owner_mask(new.xyz, m.origin, kw["voxel_size"],
                                                        kw["owner"]))
    jm = jvm.VoxelMap(*(jnp.asarray(x.numpy()) for x in m))
    jp = jcloud.PointsWithNormals(*(jnp.asarray(x.numpy()) for x in new))
    vs = kw["voxel_size"]
    if kw["center"] is None:
        out = jvm.map_insert(jm, jp, voxel_size=vs)
    elif new.valid.shape[-1] == 0:
        out = jvm.radius_cleanup(jm, jnp.asarray(kw["center"].numpy()), radius=kw["radius"],
                                 voxel_size=vs)
    else:
        out = jvm.map_update(jm, jp, jnp.asarray(kw["center"].numpy()), voxel_size=vs,
                             radius=kw["radius"], origin_quantum=kw["quantum"])
    keys = jvm.pack_keys(jvm.voxel_indices(jp.xyz, vs), out.origin, jp.valid, map_window=True)
    dropped = int(np.sum(np.asarray(jp.valid) & (np.asarray(keys) == jvm.EMPTY_KEY)))
    return out, int(jvm.map_size(out)), dropped


def _lane(x, b):
    return None if x is None else type(x)(*(v[b] for v in x))


def _check(c: dict) -> int:
    """The port's plain update of case `c` against the JAX package's, lane
    by lane; returns the live voxels of the result."""
    m, new, kw = cases.torch_args(c, "cpu")
    got = map_update(m, new, **kw)
    lanes = m.keys.shape[0] if m.keys.dim() == 2 else 0
    kw_jax = dict(kw, quantum=kw.pop("origin_quantum"))
    live = 0
    for b in range(max(lanes, 1)):
        one = (lambda x: x) if not lanes else (lambda x, b=b: _lane(x, b))
        lane_kw = dict(kw_jax, pose=one(kw_jax["pose"]),
                       center=None if kw_jax["center"] is None else
                       (kw_jax["center"][b] if lanes else kw_jax["center"]))
        jm, size, dropped = _jax_lane(one(m), one(new), lane_kw)
        tm = one(got.keyframe)
        _assert_maps_equal(jm, tm)
        assert int(got.size[b] if lanes else got.size) == size
        assert int(got.dropped[b] if lanes else got.dropped) == dropped
        live += size
    return live


@pytest.mark.parametrize("name", [*cases.CASES, "lanes8", "drive"])
def test_map_update_plain_matches_jax(name):
    """Every case of tests/_map_update_cases.py (the first insert, a
    saturated map with evictions and the C-smallest cut, rebases at origin
    quantum 1 and 4 with the window's edge leaving, tombstone reuse, groups
    over the K cap, all-EMPTY points, radius_cleanup's N = 0, map_insert,
    the spatial owner mask; 8 lanes with an empty one; the states of a
    TINY drive) through the plain version and the JAX package."""
    if name == "lanes8":
        assert _check(cases.lanes_with_an_empty_map(seed=5)) > 0
    elif name == "drive":
        if not _DRIVE:
            _DRIVE.extend(cases.drive_states(TINY, 4, seed=3, device="cpu"))
        assert len(_DRIVE) == 4
        for c in _DRIVE:
            assert _check(c) > 0
    else:
        live = _check(cases.make_case(name, seed=11))
        assert live > 0
