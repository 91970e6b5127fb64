"""The plain reference against the port's eager step at TINY on a short
drive (CPU): poses and iterations agree to float32 rounding, the maps to a
voxel or two (a point on a voxel boundary may land on either side)."""

import numpy as np
import pytest
import torch

import _paths  # noqa: F401
import gen
from reference import odometry as ref

from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.pipeline.odometry import LidarOdometry


def _port_keys(keyframe) -> torch.Tensor:
    keys = keyframe.keys[keyframe.keys != 0x7FFFFFFF].to(torch.int64)
    vox = torch.stack([(keys >> 20) & 2047, (keys >> 9) & 2047, keys & 511], -1)
    return ref.abs_key(vox - torch.tensor([1024, 1024, 256]) + keyframe.origin.to(torch.int64))


@pytest.mark.parametrize("cfg", [TINY, TINY.replace(map_capacity=1024),
                                 TINY.replace(deskew_forward_translation=False)],
                         ids=["tiny", "tiny-saturated-map", "tiny-backward-deskew"])
def test_reference_follows_the_port(cfg):
    torch.manual_seed(0)
    S = 12
    d = gen.simulate_drive(7, S, cfg.scan_width, cfg.max_raw_points, gen.Motion(), "cpu")
    port = LidarOdometry(cfg, device="cpu")
    odo = ref.Odometry(_ns(cfg), "cpu")
    worst = 0.0
    for s in range(S):
        diag = port.process_scan(LidarScan(d.xyz[s], d.intensity[s], d.ring[s], d.time[s],
                                           d.valid[s]))
        r = odo.step(d.xyz[s], d.time[s], d.ring[s], d.valid[s])
        t, q = port.get_current_pose()
        worst = max(worst, float(np.abs(t - r.t).max()))
        assert float(np.abs(np.abs(np.dot(q, r.q)) - 1.0)) < 1e-6
        assert int(diag.icp_iterations) == (r.stats.rounds if r.stats else 0)
        # a point on a voxel boundary may land on either side of it
        assert abs(int(diag.map_voxels) - odo.map.keys.numel()) <= 2
    assert worst < 1e-5
    mine, theirs = _port_keys(port.state.keyframe).numpy(), odo.map.keys.numpy()
    assert np.setxor1d(mine, theirs).size <= 0.002 * np.union1d(mine, theirs).size


def _ns(cfg):
    from types import SimpleNamespace
    return SimpleNamespace(**cfg.to_dict())
