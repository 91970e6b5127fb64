"""Port parity for the pose graph (parallel/pose_graph.py) and the CLI's
`refine`, against the JAX package on the CPU.

Each JAX test of tests/test_pose_graph.py (drift correction, Schur and
segment Schur against the direct solve, the perfect-odometry fixed point,
the segment solver at P = 256) runs on the port with the JAX test's bars;
beside them the pieces are held against the JAX functions on the same
inputs. Tolerances: the odometry edges' z.t within 8 float32 ulps of the
largest coordinate (fused multiply-adds in XLA, separate roundings here),
everything else in the graph within 1e-6; the Jacobians (closed form here,
forward-mode autodiff there) within 1e-4 of their largest entry (of 1 for
residuals at zero); H and b within 1e-5 of their largest
edge entry (float32 sums in another order); the solvers, fed the JAX
package's own H and b, within 5e-3 of the step scale (the JAX tests' bar
for float32 dense elimination); refined poses within 1e-4 m of the JAX
refine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from lidar_odometry_demo_tpu import cli as jcli
from lidar_odometry_demo_tpu.io import trajectory as jtraj
from lidar_odometry_demo_tpu.ops import se3 as jse3
from lidar_odometry_demo_tpu.parallel import pose_graph as jpg
from lidar_odometry_demo_tpu_torch import cli
from lidar_odometry_demo_tpu_torch.io.trajectory import read_tum
from lidar_odometry_demo_tpu_torch.ops import se3 as tse3
from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg

# the JAX functions compiled once (their eager dispatch costs seconds per call)
j_normal_equations = jax.jit(jpg.build_normal_equations)
j_chain_system = jax.jit(jpg.build_chain_system, static_argnums=1)
j_refine_segment = jax.jit(jpg.refine_segment, static_argnames=("stride", "iterations"))
j_segment_schur = jax.jit(jpg.solve_segment_schur, static_argnames=("stride", "damping"))


def _make_noisy_loop(P_n=32, drift=0.03, seed=0):
    """tests/test_pose_graph.py's loop: a circle returning to start, odometry
    = the true relative poses with noise, integrated; the loop closure is
    the true relative pose from the last pose to the first (JAX se3)."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, P_n, endpoint=False)
    radius = 10.0
    gt_t = np.stack([radius * np.cos(angles), radius * np.sin(angles), np.zeros(P_n)], -1)
    gt_q = []
    for a in angles:
        q = Rotation.from_euler("z", a + np.pi / 2).as_quat()
        gt_q.append([q[3], q[0], q[1], q[2]])
    gt_q = np.asarray(gt_q)
    est_t, est_q = [gt_t[0]], [gt_q[0]]
    for k in range(P_n - 1):
        z = _jclosure(gt_t, gt_q, k, k + 1)
        noise_t = rng.normal(0, drift, 3).astype(np.float32)
        noise_w = rng.normal(0, drift * 0.3, 3).astype(np.float32)
        z_noisy = jse3.Pose(z.t + noise_t, jse3.quat_mul(jse3.quat_exp(jnp.asarray(noise_w)), z.q))
        nxt = jse3.compose(jse3.Pose(jnp.asarray(est_t[-1]), jnp.asarray(est_q[-1])), z_noisy)
        est_t.append(np.asarray(nxt.t))
        est_q.append(np.asarray(nxt.q))
    return gt_t, gt_q, np.asarray(est_t), np.asarray(est_q)


def _jclosure(gt_t, gt_q, i, j):
    a = jse3.Pose(jnp.asarray(gt_t[i], jnp.float32), jnp.asarray(gt_q[i], jnp.float32))
    b = jse3.Pose(jnp.asarray(gt_t[j], jnp.float32), jnp.asarray(gt_q[j], jnp.float32))
    return jse3.relative_to(a, b)


def _tclosure(z):
    return tse3.Pose(torch.from_numpy(np.array(z.t)), torch.from_numpy(np.array(z.q)))


def _graphs(est_t, est_q, gt_t, gt_q, closures=()):
    """The same graph in both packages; closures as (i, j) pairs, measured
    from the ground truth with weight 1."""
    jc = [(i, j, _jclosure(gt_t, gt_q, i, j), 1.0) for i, j in closures]
    tc = [(i, j, _tclosure(z), w) for i, j, z, w in jc]
    return (jpg.chain_from_odometry(est_t, est_q, closures=jc),
            pg.chain_from_odometry(est_t, est_q, closures=tc, device="cpu"))


def _rms(t, gt_t):
    return float(np.sqrt(np.mean(np.sum((np.asarray(t) - gt_t) ** 2, -1))))


@pytest.fixture(scope="module")
def loop32():
    gt_t, gt_q, est_t, est_q = _make_noisy_loop()
    return gt_t, gt_q, est_t, est_q, *_graphs(est_t, est_q, gt_t, gt_q, [(31, 0)])


def test_loop_closure_reduces_drift(loop32):
    """The bar of test_loop_closure_reduces_drift, and the JAX refine's
    poses within 1e-4 m."""
    gt_t, _, est_t, _, jg, tg = loop32
    refined = pg.refine(tg, iterations=10)
    after_t = refined.poses.t.numpy()
    assert _rms(after_t, gt_t) < 0.5 * _rms(est_t, gt_t)
    np.testing.assert_allclose(after_t[0], est_t[0], atol=1e-3)
    want = np.asarray(jpg.refine(jg, iterations=10).poses.t)
    np.testing.assert_allclose(after_t, want, atol=1e-4, rtol=0)


def test_chain_from_odometry_matches_jax(loop32):
    *_, jg, tg = loop32
    np.testing.assert_array_equal(tg.edge_i.numpy(), np.asarray(jg.edge_i))
    np.testing.assert_array_equal(tg.edge_j.numpy(), np.asarray(jg.edge_j))
    for a, b in ((tg.poses.t, jg.poses.t), (tg.poses.q, jg.poses.q), (tg.edge_z.q, jg.edge_z.q),
                 (tg.edge_w_rot, jg.edge_w_rot), (tg.edge_w_t, jg.edge_w_t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    # z.t = R_i^T (t_j - t_i) cancels 10 m coordinates: XLA's fused
    # multiply-adds against PyTorch's separate roundings leave a few ulps
    # of them (8 ulps of the largest coordinate, two rotations deep)
    ulps = 8 * float(np.spacing(np.float32(np.abs(np.asarray(jg.poses.t)).max())))
    np.testing.assert_allclose(tg.edge_z.t.numpy(), np.asarray(jg.edge_z.t), atol=ulps, rtol=0)
    assert tg.edge_valid.all() and tg.edge_i.shape == (32,)


@pytest.mark.parametrize("drift", [0.03, 0.0])
def test_edge_jacobians_match_jax_jacfwd(drift):
    """The closed-form Jacobians against jax.jacfwd under vmap, on the
    noisy loop and at zero residual (perfect odometry: quat_log's small
    branch, where J_l^-1 takes its Taylor series). Within 1e-4 of the
    largest entry, and of 1 where the residuals sit at zero."""
    gt_t, gt_q, est_t, est_q = _make_noisy_loop(P_n=16, drift=drift)
    jg, tg = _graphs(est_t, est_q, gt_t, gt_q, [(15, 0)])

    def jax_edge(i, j, zt, zq, wr, wt):
        return jpg._edge_system(jse3.Pose(jg.poses.t[i], jg.poses.q[i]),
                                jse3.Pose(jg.poses.t[j], jg.poses.q[j]),
                                jse3.Pose(zt, zq), wr, wt)

    want = jax.jit(jax.vmap(jax_edge))(jg.edge_i, jg.edge_j, jg.edge_z.t, jg.edge_z.q,
                              jg.edge_w_rot, jg.edge_w_t)
    got = pg.edge_jacobians(tg)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.all(np.isfinite(g.numpy()))
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(np.abs(w).max(), 1.0), rtol=0)
    if drift == 0.0:
        assert np.abs(got[2].numpy()).max() < 1e-3  # the residuals sit at zero


def test_normal_equations_and_chain_system_match_jax(loop32):
    *_, jg, tg = loop32
    jH, jb = j_normal_equations(jg)
    H, b = pg.build_normal_equations(tg)
    jH, jb = np.asarray(jH), np.asarray(jb)
    edges_only = jH.copy()
    edges_only[0, 0] -= 1e6 * np.eye(6, dtype=np.float32)  # without the gauge prior
    edge_scale = np.abs(edges_only).max()
    np.testing.assert_allclose(H.numpy(), jH, atol=1e-5 * edge_scale, rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), jb, atol=1e-5 * np.abs(jb).max(), rtol=0)
    for stride in (4, 8):
        want = [np.asarray(x) for x in j_chain_system(jg, stride)]
        got = pg.build_chain_system(tg, stride)
        for name, g, w in zip(("diag", "off", "S_extra", "b"), got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * max(np.abs(w).max(), 1.0),
                                       rtol=1e-5, err_msg=name)


def test_solvers_match_jax_on_the_same_system(loop32):
    """Each solver fed the JAX package's own H and b (or chain system)."""
    *_, jg, _ = loop32
    jH, jb = j_normal_equations(jg)
    H, b = torch.from_numpy(np.array(jH)), torch.from_numpy(np.array(jb))
    is_sep = np.arange(32) % 4 == 0
    for damping in (0.0, 1e-6):
        want = np.asarray(jpg.solve_direct(jH, jb, damping=damping))
        scale = np.abs(want).max()
        got = pg.solve_direct(H, b, damping=damping).numpy()
        np.testing.assert_allclose(got, want, atol=5e-3 * scale, rtol=0)
        want_s = np.asarray(jpg.solve_schur(jH, jb, jnp.asarray(is_sep), damping=damping))
        got_s = pg.solve_schur(H, b, torch.from_numpy(is_sep), damping=damping).numpy()
        np.testing.assert_allclose(got_s, want_s, atol=5e-3 * scale, rtol=0)
    sys_j = j_chain_system(jg, 8)
    want = np.asarray(j_segment_schur(*sys_j, stride=8, damping=0.0))
    got = pg.solve_segment_schur(*(torch.from_numpy(np.array(x)) for x in sys_j),
                                 stride=8, damping=0.0).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3 * np.abs(want).max(), rtol=0)


def test_schur_matches_direct():
    """The bar of test_schur_matches_direct (P = 16, separators every 4th)."""
    gt_t, gt_q, est_t, est_q = _make_noisy_loop(P_n=16)
    _, tg = _graphs(est_t, est_q, gt_t, gt_q, [(15, 0)])
    H, b = pg.build_normal_equations(tg)
    dx_direct = pg.solve_direct(H, b, damping=0.0).numpy()
    dx_schur = pg.solve_schur(H, b, torch.arange(16) % 4 == 0, damping=0.0).numpy()
    np.testing.assert_allclose(dx_schur, dx_direct, atol=5e-3 * np.abs(dx_direct).max())


def test_perfect_odometry_is_fixed_point():
    gt_t, gt_q, _, _ = _make_noisy_loop(drift=0.0)
    g = pg.chain_from_odometry(gt_t, gt_q, device="cpu")
    for use_schur in (False, True):
        refined = pg.refine(g, iterations=3, use_schur=use_schur)
        np.testing.assert_allclose(refined.poses.t.numpy(), gt_t, atol=1e-3)
    np.testing.assert_allclose(pg.refine_segment(g, stride=8, iterations=3).poses.t.numpy(),
                               gt_t, atol=1e-3)


def test_segment_schur_matches_direct():
    """The bar of test_segment_schur_matches_direct: stride 8, closures at
    0/8/16/24."""
    gt_t, gt_q, est_t, est_q = _make_noisy_loop(P_n=32)
    _, tg = _graphs(est_t, est_q, gt_t, gt_q, [(24, 0), (16, 8)])
    H, b = pg.build_normal_equations(tg)
    dx_direct = pg.solve_direct(H, b, damping=0.0).numpy()
    diag, off, S_extra, bb = pg.build_chain_system(tg, stride=8)
    np.testing.assert_allclose(bb.numpy(), b.numpy(), atol=1e-5)
    dx_seg = pg.solve_segment_schur(diag, off, S_extra, bb, stride=8, damping=0.0).numpy()
    np.testing.assert_allclose(dx_seg, dx_direct, atol=5e-3 * np.abs(dx_direct).max())


def test_refine_segment_scales_past_64_poses():
    """The bar of test_refine_segment_scales_past_64_poses (P = 256, stride
    8), and the JAX refine_segment's poses within 1e-4 m."""
    gt_t, gt_q, est_t, est_q = _make_noisy_loop(P_n=256, drift=0.02)
    jg, tg = _graphs(est_t, est_q, gt_t, gt_q, [(248, 0), (128, 0)])
    after_t = pg.refine_segment(tg, stride=8, iterations=10).poses.t.numpy()
    assert _rms(after_t, gt_t) < 0.5 * _rms(est_t, gt_t)
    np.testing.assert_allclose(after_t[0], est_t[0], atol=1e-3)
    want = np.asarray(j_refine_segment(jg, stride=8, iterations=10).poses.t)
    np.testing.assert_allclose(after_t, want, atol=1e-4, rtol=0)


def test_refine_schur_matches_jax(loop32):
    *_, jg, tg = loop32
    got = pg.refine(tg, iterations=5, use_schur=True, separator_stride=4)
    want = jpg.refine(jg, iterations=5, use_schur=True, separator_stride=4)
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.poses.q.numpy(), np.asarray(want.poses.q), atol=1e-4, rtol=0)


def test_pad_edges_matches_jax(loop32):
    *_, jg, tg = loop32
    want, got = jpg.pad_edges(jg, 5), pg.pad_edges(tg, 5)
    assert got.edge_i.shape == (35,) and pg.pad_edges(got, 5) is got
    for f in ("edge_i", "edge_j", "edge_w_rot", "edge_w_t", "edge_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.edge_z.q[32:].numpy(), np.asarray(want.edge_z.q)[32:])
    H, b = pg.build_normal_equations(got)
    H0, b0 = pg.build_normal_equations(tg)
    assert torch.equal(H, H0) and torch.equal(b, b0)  # padding adds nothing


@pytest.mark.parametrize("schur", [False, True])
def test_cli_refine_matches_the_jax_cli(tmp_path, capsys, schur):
    gt_t, _, est_t, est_q = _make_noisy_loop(P_n=24)
    src = str(tmp_path / "odo.tum")
    jtraj.write_tum(src, [0.1 * i for i in range(24)], est_t, est_q)
    flags = ["--iterations", "4"] + (["--schur"] if schur else [])
    jcli.main(["refine", src, "--out", str(tmp_path / "j.tum"), *flags])
    cli.main(["refine", src, "--out", str(tmp_path / "t.tum"), "--device", "cpu", *flags])
    assert f"wrote {tmp_path / 't.tum'}" in capsys.readouterr().out
    stamps, t, q = read_tum(str(tmp_path / "t.tum"))
    jstamps, jt, jq = read_tum(str(tmp_path / "j.tum"))
    np.testing.assert_array_equal(stamps, jstamps)
    np.testing.assert_allclose(t, jt, atol=1e-4, rtol=0)
    np.testing.assert_allclose(q, jq, atol=1e-4, rtol=0)


def test_refine_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.chain_from_odometry(np.zeros((3, 3)), np.tile([1.0, 0, 0, 0], (3, 1)))
    src = str(tmp_path / "odo.tum")
    jtraj.write_tum(src, [0.0, 0.1], np.zeros((2, 3)), np.tile([1.0, 0, 0, 0], (2, 1)))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["refine", src, "--out", str(tmp_path / "r.tum")])


def test_smoke_noisy_loop_is_the_jax_tests_loop():
    """chip_smoke.py's noisy loop (the port's se3) is tests/test_pose_graph.py's
    (the JAX se3) within 1e-5 m: the card phase refines the same graph."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gt_t, gt_q, est_t, est_q, closure = smoke.make_noisy_loop(32)
    want = _make_noisy_loop(32)
    for got, ref in zip((gt_t, gt_q, est_t, est_q), want):
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    z, jz = closure(31, 0), _jclosure(want[0], want[1], 31, 0)
    np.testing.assert_allclose(z.t.numpy(), np.asarray(jz.t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(z.q.numpy(), np.asarray(jz.q), atol=1e-6, rtol=0)
