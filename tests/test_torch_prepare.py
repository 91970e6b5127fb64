"""The step's front end (kernels/prepare.py) on the CPU: its plain version
against the JAX package's preprocess, se3, classifier and voxel-key
functions, on drive scans and edge cases, and the downsample on given keys.

Inputs are made with numpy from a seed and fed to both frameworks
(tests/_prepare_cases.py). Tolerances: the guess and the deskewed points
within 4 float32 ulps of their largest coordinate (XLA contracts
multiply-adds into FMAs where PyTorch's CPU kernels round each step, as in
tests/test_torch_se3_preprocess.py). The classification is held on the same
input, the port's deskewed points given to the JAX classifier: the image,
the planar mask, num_planar and both grids' keys bitwise, the normals within
atol 1e-5 on planar cells (as in tests/test_torch_classifier.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _prepare_cases import EDGE_CASES, drive_scans, edge_case
from lidar_odometry_demo_tpu.config import OdometryConfig as JConfig
from lidar_odometry_demo_tpu.ops import classifier as jcls
from lidar_odometry_demo_tpu.ops import cloud as jcloud
from lidar_odometry_demo_tpu.ops import preprocess as jpre
from lidar_odometry_demo_tpu.ops import se3 as jse3
from lidar_odometry_demo_tpu.ops import voxel_map as jvm
from lidar_odometry_demo_tpu_torch.config import TINY, OdometryConfig
from lidar_odometry_demo_tpu_torch.kernels.prepare import prepare, prepare_plain
from lidar_odometry_demo_tpu_torch.ops import se3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.ops.se3 import Pose

CONFIGS = {"tiny": TINY, "full": OdometryConfig()}
_DRIVES: dict = {}


def _drive(shape: str) -> list:
    if shape not in _DRIVES:
        _DRIVES[shape] = drive_scans(CONFIGS[shape], 4, seed=11)
    return _DRIVES[shape]


def torch_inputs(cases: list, lanes: bool):
    """(previous, current, raw) on the CPU from [(scan, previous, current)],
    stacked over a lane axis where `lanes`, else the first case alone."""
    def field(get):
        xs = [torch.from_numpy(np.ascontiguousarray(get(c))) for c in cases]
        return torch.stack(xs) if lanes else xs[0]

    raw = LidarScan(*(field(lambda c, f=f: c[0][f]) for f in LidarScan._fields))
    prev = Pose(field(lambda c: c[1][0]), field(lambda c: c[1][1]))
    cur = Pose(field(lambda c: c[2][0]), field(lambda c: c[2][1]))
    return prev, cur, raw


def _ulps4(want: np.ndarray) -> float:
    return 4 * float(np.spacing(np.float32(max(np.abs(want).max(), 1.0))))


def assert_matches_jax(fe, case, cfg, lane=None):
    """One lane of the port's front end against the JAX functions."""
    def at(x):
        x = x if lane is None else x[lane]
        return x.numpy()

    scan, (pt, pq), (ct, cq) = case
    jscan = jcloud.LidarScan(*(jnp.asarray(scan[f]) for f in LidarScan._fields))
    prev, cur = jse3.Pose(jnp.asarray(pt), jnp.asarray(pq)), jse3.Pose(jnp.asarray(ct),
                                                                       jnp.asarray(cq))
    rel = jse3.relative_to(prev, cur)
    guess = jse3.compose(cur, rel)
    for got, want in ((at(fe.guess.t), np.asarray(guess.t)), (at(fe.guess.q), np.asarray(guess.q))):
        np.testing.assert_allclose(got, want, atol=_ulps4(want), rtol=0)
    desk = jpre.deskew(jpre.time_normalize(jscan), jse3.inverse(rel), jse3.Pose.identity(),
                       forward_translation=cfg.deskew_forward_translation)
    want = np.asarray(desk.xyz)
    np.testing.assert_allclose(at(fe.deskewed_xyz), want, atol=_ulps4(want), rtol=0)

    # the classification, on the port's deskewed points
    jcfg = JConfig.from_dict(cfg.to_dict())
    planar, _, _ = jcls.classify(jscan._replace(xyz=jnp.asarray(at(fe.deskewed_xyz))), jcfg)
    planar = jpre.range_filter(planar, cfg.lidar_min_range, cfg.lidar_max_range)
    valid = np.asarray(planar.valid)
    np.testing.assert_array_equal(at(fe.planar.valid), valid)
    np.testing.assert_array_equal(at(fe.planar.xyz), np.asarray(planar.xyz))
    np.testing.assert_allclose(at(fe.planar.normal)[valid], np.asarray(planar.normal)[valid],
                               atol=1e-5, rtol=0)
    assert int(at(fe.num_planar)) == int(valid.sum())
    zero = jnp.zeros((3,), jnp.int32)
    for keys, vs in ((fe.update_keys, cfg.keyframe_update_voxel_size),
                     (fe.match_keys, cfg.keyframe_matching_voxel_size)):
        want = jvm.pack_keys(jvm.voxel_indices(planar.xyz, vs), zero, planar.valid)
        np.testing.assert_array_equal(at(keys), np.asarray(want))
    return valid


@pytest.mark.parametrize("forward", [True, False], ids=["forward", "backward"])
@pytest.mark.parametrize("lanes", [False, True], ids=["one", "B3"])
@pytest.mark.parametrize("shape", ["tiny", "full"])
def test_front_end_matches_jax(shape, lanes, forward):
    cfg = CONFIGS[shape].replace(deskew_forward_translation=forward)
    cases = _drive(shape)[:3 if lanes else 1]
    fe = prepare(*torch_inputs(cases, lanes), cfg, return_deskewed=True)
    for b, case in enumerate(cases):
        valid = assert_matches_jax(fe, case, cfg, b if lanes else None)
        assert valid.sum() > (300 if shape == "tiny" else 5000)  # real planar points


@pytest.mark.parametrize("name", EDGE_CASES)
@pytest.mark.parametrize("shape", ["tiny", "full"])
def test_front_end_edges_match_jax(shape, name):
    """The edges the kernel reproduces: two points in one cell (the last
    wins), rings outside [0, R), an all-equal time, an empty scan, points at
    exactly 4 m and 80 m, cells at the flattened image's ends."""
    cfg = CONFIGS[shape]
    edge, prev, cur = edge_case(cfg, name)
    case = (edge.scan, prev, cur)
    fe = prepare(*torch_inputs([case], False), cfg, return_deskewed=True)
    valid = assert_matches_jax(fe, case, cfg)
    xyz = fe.planar.xyz.numpy()
    keys = (fe.update_keys.numpy(), fe.match_keys.numpy())
    if name == "empty":
        assert not valid.any() and int(fe.num_planar) == 0 and not xyz.any()
        assert all((k == tvm.EMPTY_KEY).all() for k in keys)
        return
    assert not np.isin(xyz, edge.bad_xyz).all(-1).any()  # no ring outside [0, R) landed
    if name == "still":  # the deskew leaves every point where it was
        np.testing.assert_array_equal(fe.deskewed_xyz.numpy(), edge.scan["xyz"])
        np.testing.assert_array_equal(xyz[edge.shared], edge.winner_xyz)
        np.testing.assert_array_equal(xyz[[edge.at_min, edge.at_max]],
                                      [[4.0, 0.0, 0.0], [80.0, 0.0, 0.0]])
        assert valid[edge.at_min] and valid[edge.at_max]  # range filter bounds kept
        assert xyz[0].any() and xyz[-1].any()  # the flattened image's ends hold points
    if name == "equal_time":  # time range 1: every point at time 0, the start pose
        p, c, raw = torch_inputs([case], False)
        start = se3.inverse(se3.relative_to(p, c))
        v = edge.scan["valid"]
        np.testing.assert_allclose(fe.deskewed_xyz.numpy()[v],
                                   se3.transform_points(start, raw.xyz).numpy()[v], atol=1e-4)


@pytest.mark.parametrize("grid", ["update", "match"])
@pytest.mark.parametrize("lanes", [False, True], ids=["one", "B3"])
def test_downsample_on_given_keys_is_downsample(grid, lanes):
    cfg = TINY
    cases = _drive("tiny")[:3 if lanes else 1]
    fe = prepare(*torch_inputs(cases, lanes), cfg)
    vs, budget, keys = ((cfg.keyframe_update_voxel_size, cfg.max_update_points, fe.update_keys)
                        if grid == "update" else
                        (cfg.keyframe_matching_voxel_size, cfg.max_match_points, fe.match_keys))
    got = tvm.downsample(fe.planar, vs, budget, keys=keys)
    want = tvm.downsample(fe.planar, vs, budget)
    for g, w in zip(tvm.PointsWithNormals._fields, want[0]):
        assert torch.equal(getattr(got[0], g), w), g
    assert torch.equal(got[1], want[1])
    assert got[0].valid.sum() > 100


def test_prepare_on_cpu_tensors_is_its_plain_version():
    cases = _drive("tiny")[:2]
    args = (*torch_inputs(cases, True), TINY, True)
    got, want = prepare(*args), prepare_plain(*args)

    def fields(fe):
        return [*fe.guess, *fe.planar, fe.num_planar, fe.update_keys, fe.match_keys,
                fe.deskewed_xyz]

    assert all(torch.equal(g, w) for g, w in zip(fields(got), fields(want)))
