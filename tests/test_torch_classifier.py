"""Port parity: the planar classifier against the JAX package (CPU).

Tolerances: every mask bitwise equal; normals within atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io.simulator import simulate_sequence
from lidar_odometry_demo_tpu.ops import classifier as jcls
from lidar_odometry_demo_tpu.ops import cloud as jcloud
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.ops import classifier as tcls
from lidar_odometry_demo_tpu_torch.ops import cloud as tcloud


def _scans(seed):
    drive = simulate_sequence(num_scans=2, width=TINY.scan_width, seed=seed,
                              speed=3.0, yaw_rate=0.05)
    s = drive.scans[-1]
    args = (s["xyz"], s["intensity"], s["ring"], s["time"], TINY.max_raw_points)
    return jcloud.scan_from_numpy(*args), tcloud.scan_from_numpy(*args, device="cpu")


@pytest.mark.parametrize("seed", [0, 7])
def test_classify_matches_jax(seed):
    js, ts = _scans(seed)
    jp, jorg, jcurv = jcls.classify(js, JTINY)
    tp, torg, tcurv = tcls.classify(ts, TINY)
    np.testing.assert_array_equal(torg.valid.numpy(), np.asarray(jorg.valid))
    np.testing.assert_array_equal(torg.xyz.numpy(), np.asarray(jorg.xyz))
    np.testing.assert_array_equal(
        (tcurv < TINY.flatness_threshold).numpy(),
        np.asarray(jcurv < JTINY.flatness_threshold))
    valid = np.asarray(jp.valid)
    assert valid.sum() > 100  # the scan exercises real planar points
    np.testing.assert_array_equal(tp.valid.numpy(), valid)
    np.testing.assert_allclose(tp.normal.numpy()[valid], np.asarray(jp.normal)[valid],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        tcls.unclassified_mask(tp.valid, tcurv, TINY).numpy(),
        np.asarray(jcls.unclassified_mask(jp.valid, jcurv, JTINY)))


def test_organize_last_point_wins_like_jax(rng):
    """Several points per cell, invalid and out-of-range rings: the last
    valid point in input order owns each cell, as in the JAX package."""
    n = 900
    az = rng.integers(0, 16, n) * (2 * np.pi / TINY.scan_width) + 0.01
    r = rng.uniform(5, 20, n)
    xyz = np.stack([r * np.cos(az), -r * np.sin(az), rng.normal(0, 1, n)], -1).astype(np.float32)
    ring = rng.integers(-1, 18, n).astype(np.int32)
    args = (xyz, np.zeros(n, np.float32), ring, np.zeros(n, np.float32), 1024)
    js = jcloud.scan_from_numpy(*args)
    ts = tcloud.scan_from_numpy(*args, device="cpu")
    ts = ts._replace(valid=ts.valid & torch.from_numpy(rng.random(1024) < 0.8))
    js = js._replace(valid=jnp.asarray(ts.valid.numpy()))
    jorg, torg = jcls.organize(js, JTINY), tcls.organize(ts, TINY)
    assert 20 < np.asarray(jorg.valid).sum() < n
    np.testing.assert_array_equal(torg.valid.numpy(), np.asarray(jorg.valid))
    np.testing.assert_array_equal(torg.xyz.numpy(), np.asarray(jorg.xyz))
