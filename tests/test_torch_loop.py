"""The ICP loop's one schedule (ops/icp.py `Align.run_rounds`, the loop
graph's: the condition, then while any lane goes a round and the
condition, kernels/loop.py) against the JAX package (CPU).

Here the condition is the plain version (the wrapper on CPU tensors). The
loop is driven by `run_rounds` from `begin` with each round's lanes (the
`go` the condition wrote before it) recorded, and its carry (rounds, stall
count, step norm per lane) is read from the device.

Tolerances: every lane's rounds equal to the rounds it ran in (each
lane's `go` before the round), every lane running the first round, its
condition false at the end; against the JAX package's `make_align`
(unbatched, per lane) equal iterations, t within 1e-5 m and q within 1e-6,
the bar of tests/test_torch_icp.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu.config import TINY as JTINY
from lidar_odometry_demo_tpu.io.simulator import sample_structured_cloud
from lidar_odometry_demo_tpu.ops import cloud as jcloud
from lidar_odometry_demo_tpu.ops import icp as jicp
from lidar_odometry_demo_tpu.ops import se3 as jse3
from lidar_odometry_demo_tpu.ops import voxel_map as jvm
from lidar_odometry_demo_tpu_torch.config import TINY
from lidar_odometry_demo_tpu_torch.kernels.loop import loop_condition_plain
from lidar_odometry_demo_tpu_torch.ops import icp as ticp
from lidar_odometry_demo_tpu_torch.ops import se3 as tse3
from lidar_odometry_demo_tpu_torch.ops import voxel_map as tvm

# name -> (config changes, each lane's guess offset in m): the loop ends by
# convergence, by the stall exit (no convergence at a tolerance of 0, and
# a round that cuts the best cost by less than half a stall), at the round
# cap, and on B = 3 lanes at different rounds (one round at least, so each
# lane stops when it converges)
CASES = {
    "converging": ({}, (0.08,)),
    "stall_exit": ({"icp_stall_exit_rounds": 1, "icp_stall_rel_tolerance": 0.5,
                    "icp_convergence_step_norm": 0.0}, (0.2,)),
    "round_cap": ({"icp_max_outer_iterations": 3, "icp_convergence_step_norm": 0.0}, (0.2,)),
    "lanes": ({"icp_min_outer_iterations": 1}, (0.0, 0.08, 0.3)),
}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scene():
    """The map and queries of tests/test_torch_icp.py's align setup (seed 5)."""
    rng = np.random.default_rng(1234)
    xyz, nrm = sample_structured_cloud(seed=5, n_per_plane=400)
    jp = jcloud.PointsWithNormals(jnp.asarray(xyz), jnp.asarray(nrm),
                                  jnp.ones(xyz.shape[0], bool))
    jm = jvm.map_insert(jvm.map_init(8192, 20), jp, voxel_size=0.2)
    n_q = TINY.max_match_points
    q = xyz[:n_q] + rng.normal(0, 0.02, (n_q, 3)).astype(np.float32)
    return jm, q, np.ones(n_q, bool)


def _guess(offset):
    return (np.array([offset, -offset / 2, 0.0], np.float32),
            np.array([1.0, 0.0, 0.0, 0.0], np.float32))


def _port_inputs(scene, offsets):
    """The port's map, queries and guess: one sequence, or a lane per
    offset (the same map and queries in each)."""
    jm, q, qv = scene
    m = tvm.VoxelMap(*(_t(np.asarray(x)) for x in jm))
    guesses = [_guess(o) for o in offsets]
    if len(offsets) == 1:
        return m, _t(q), _t(qv), tse3.Pose(*(_t(g) for g in guesses[0]))
    B = len(offsets)
    m = tvm.VoxelMap(*(torch.stack([x] * B) for x in m))
    guess = tse3.Pose(*(torch.stack([_t(g[k]) for g in guesses]) for k in range(2)))
    return m, torch.stack([_t(q)] * B), torch.stack([_t(qv)] * B), guess


def _device_loop(align, m, q, qv, guess):
    """The loop from `begin` through `run_rounds`: (result, carry, each
    round's `go` as it ran)."""
    loop = align.begin(m, q, qv, guess)
    ran = []

    def round_fn():
        ran.append(loop.go.reshape(-1).tolist())
        align.round(m, loop)

    align.run_rounds(loop, round_fn)
    return align.finish(loop), loop, ran


@pytest.mark.parametrize("case", list(CASES))
def test_device_loop_is_the_host_loop_and_jax(scene, case):
    """The host-driven loop holds the loop graph's schedule (the rounds
    each lane ran against the `go` recorded before each round, the final
    condition false), and its device carry and pose equal the JAX
    package's align, per lane."""
    changes, offsets = CASES[case]
    cfg, jcfg = TINY.replace(**changes), JTINY.replace(**changes)
    align = ticp.make_align(cfg)
    got, loop, ran = _device_loop(align, *_port_inputs(scene, offsets))
    lanes = len(offsets)
    iters, stall = loop.iters.reshape(lanes), loop.stall.reshape(lanes)
    step_norm = loop.step_norm.reshape(lanes)
    assert align.starts and ran and ran[0] == [True] * lanes
    assert iters.tolist() == [sum(r[b] for r in ran) for b in range(lanes)]
    assert not bool(loop_condition_plain(loop.iters, loop.stall, loop.step_norm, cfg).any())
    assert loop.go.reshape(-1).tolist() == [False] * lanes

    jm, q, qv = scene
    jalign = jicp.make_align(jcfg)
    t, quat = got.pose.t.reshape(lanes, 3).numpy(), got.pose.q.reshape(lanes, 4).numpy()
    for b, offset in enumerate(offsets):
        gt, gq = _guess(offset)
        jres = jalign(jm, jnp.asarray(q), jnp.asarray(qv),
                      jse3.Pose(jnp.asarray(gt), jnp.asarray(gq)))
        assert int(iters[b]) == int(jres.iterations)
        np.testing.assert_allclose(t[b], np.asarray(jres.pose.t), atol=1e-5, rtol=0)
        np.testing.assert_allclose(quat[b], np.asarray(jres.pose.q), atol=1e-6, rtol=0)

    # each case ends the way it is named
    if case == "converging":
        assert 0 < int(iters[0]) < cfg.icp_max_outer_iterations
        assert float(step_norm[0]) < cfg.icp_convergence_step_norm
    elif case == "stall_exit":
        assert int(stall[0]) >= cfg.icp_stall_exit_rounds
        assert int(iters[0]) < cfg.icp_max_outer_iterations
    elif case == "round_cap":
        assert iters.tolist() == [cfg.icp_max_outer_iterations]
    else:  # the frozen-lane path: lanes stop at different rounds
        assert len(set(iters.tolist())) > 1
