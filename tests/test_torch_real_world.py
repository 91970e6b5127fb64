"""Port parity for real-geometry drives (io/real_world.py) against the JAX
package on the CPU.

The reference's intersection fixture is not mounted here, so the splats
run over a `sample_structured_cloud` world (numpy on both sides: bitwise
equal), and a short TINY drive over that world through the port's runner
is held against the JAX runner with the bar of
tests/test_torch_pipeline.py's TINY drive (per-scan t within 1e-4 m, equal
ICP iterations). The port's counterpart of tests/test_real_drive.py reads the
fixture from LIDAR_ODOMETRY_REFERENCE_DIR and skips when the variable is
unset or the file is absent.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io import real_world as jreal
from lidar_odometry_demo_tpu.io.simulator import sample_structured_cloud
from lidar_odometry_demo_tpu.ops.cloud import scan_from_numpy as jax_scan
from lidar_odometry_demo_tpu.pipeline import odometry as jodo
from lidar_odometry_demo_tpu_torch.config import TINY, OdometryConfig
from lidar_odometry_demo_tpu_torch.io import real_world
from lidar_odometry_demo_tpu_torch.io.trajectory import ate_rmse
from lidar_odometry_demo_tpu_torch.ops.cloud import scan_from_numpy as port_scan
from lidar_odometry_demo_tpu_torch.pipeline import odometry

DRIVE = dict(num_scans=5, width=TINY.scan_width, speed=1.5, yaw_rate=0.03)


@pytest.fixture(scope="module")
def world():
    xyz, _ = sample_structured_cloud(seed=2, n_per_plane=1500)
    return xyz


def _same_stream(got, want):
    assert len(got.scans) == len(want.scans)
    for a, b in zip(got.scans, want.scans):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    np.testing.assert_array_equal(got.gt_t, want.gt_t)
    np.testing.assert_array_equal(got.gt_q, want.gt_q)


def test_splat_scan_matches_jax(world):
    R = Rotation.from_euler("z", 0.3).as_matrix()
    poses = [(np.array([0.5 * b, 0.2, 1.7]), R) for b in range(3)]
    for width in (TINY.scan_width, 100):  # 100 % 3 != 0: the remainder columns
        got = real_world.splat_scan(world, poses, width)
        want = jreal.splat_scan(world, poses, width)
        assert got[0].shape[0] > 300
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_splat_sequence_matches_jax(world):
    got = real_world.splat_sequence(world, **DRIVE)
    _same_stream(got, jreal.splat_sequence(world, **DRIVE))
    assert min(s["xyz"].shape[0] for s in got.scans) > 500
    start = np.array([1.0, -2.0, 1.5])
    _same_stream(real_world.splat_sequence(world, num_scans=2, width=64, start=start,
                                           yaw_rate=0.0),
                 jreal.splat_sequence(world, num_scans=2, width=64, start=start, yaw_rate=0.0))


def test_tiny_drive_over_the_world_matches_jax(world):
    drive = real_world.splat_sequence(world, **DRIVE)
    raw = [(s["xyz"], s["intensity"], s["ring"], s["time"]) for s in drive.scans]
    scans = [jax_scan(*r, JTINY.max_raw_points) for r in raw]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *scans)
    _, jdiag = jodo.make_sequence_runner(JTINY)(jodo.init_state(JTINY), stacked)
    _, tdiag = odometry.make_sequence_runner(TINY)(
        odometry.init_state(TINY, "cpu"), [port_scan(*r, TINY.max_raw_points, "cpu") for r in raw])
    jt = np.asarray(jdiag.pose.t)
    assert np.abs(jt[-1]).max() > 0.01  # the estimate moves
    np.testing.assert_allclose(tdiag.pose.t.numpy(), jt, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tdiag.icp_iterations.numpy(), np.asarray(jdiag.icp_iterations))
    np.testing.assert_array_equal(tdiag.map_voxels.numpy(), np.asarray(jdiag.map_voxels))
    assert not tdiag.diverged.any()


def test_load_fixture_absent_is_none(tmp_path):
    assert real_world.load_fixture(str(tmp_path / "missing.pcd")) is None
    assert real_world.load_fixture(None) is None
    if real_world.REFERENCE_DIR:
        assert real_world.REFERENCE_FIXTURE == os.path.join(
            real_world.REFERENCE_DIR, "test", "test_data", "intersection00056.pcd")
    else:
        assert real_world.REFERENCE_FIXTURE is None


# the configuration of tests/test_real_drive.py
REAL_CFG = OdometryConfig(scan_width=900, max_raw_points=16384, max_planar_points=8192,
                          max_match_points=4096, max_update_points=8192, map_capacity=65536)


def test_real_geometry_drive_ate():
    """tests/test_real_drive.py's 12-scan drive through the port on the CPU:
    aligned ATE under 0.1 m, a map of real structure."""
    path = real_world.REFERENCE_FIXTURE
    if path is None or not os.path.exists(path):
        pytest.skip("LIDAR_ODOMETRY_REFERENCE_DIR unset or its intersection fixture absent")
    world = real_world.load_fixture(path)
    np.testing.assert_array_equal(world, jreal.load_fixture(path))
    assert world.shape[0] > 50000
    drive = real_world.splat_sequence(world, num_scans=12, width=REAL_CFG.scan_width, speed=1.5,
                                      yaw_rate=0.03)
    assert min(s["xyz"].shape[0] for s in drive.scans) > 2000
    odo = odometry.LidarOdometry(REAL_CFG, device="cpu")
    est = []
    for s in drive.scans:
        odo.process_cloud(s["xyz"], s["intensity"], s["ring"], s["time"])
        est.append(odo.get_current_pose()[0])
    g0 = Rotation.from_quat([drive.gt_q[0][1], drive.gt_q[0][2], drive.gt_q[0][3],
                             drive.gt_q[0][0]])
    gt_rel = g0.inv().apply(drive.gt_t - drive.gt_t[0])
    assert np.linalg.norm(gt_rel[-1]) > 1.0
    assert ate_rmse(np.asarray(est), gt_rel, align=True) < 0.1
    assert int(odo.state.keyframe.count.sum()) > 10000
