"""The port's CUDA kernels and main path on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
without JAX, with the repository's conftest left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_card.py

Tolerances: K1 index equal where valid, point and d2 within atol 1e-6 of
its plain version; K1 in pose mode index and valid equal, origin, normal
and d2 within atol 1e-6; K2 within rtol 2e-5 / atol 1e-4 of its plain
version and bitwise equal across two runs; K2's whole step likewise for H
and b, the pose within 1e-6 and the step norm within rtol 1e-5, bitwise
equal across two runs and across 100 steps on one workspace; K2 split
around a sum over ranks (the epilogue off, then K2e on that one part)
bitwise the whole step, and within 1e-6 of the epilogue's plain version;
K2's split-step entry points on the parts of N = 1, 2, 4 fake ranks
(`gn_sum_step`, and K2e on the N parts) bitwise the sequence they replace
(the torch rank-order sum, K2e on it, `jtwj_accumulate` at its pose), the
pose within 1e-6, the step norm within rtol 1e-5 and the new part within
K2's tolerances of their plain versions; the column-sharded map's composite view searched by K3
and K1 bitwise the replicated map's search; K3 equal to
its plain version and to
torch.searchsorted at every index, and its neighbourhood and group lookups
bitwise equal to their plain versions (base and n_present everywhere, the
present candidate rows, pos_c and found); the TINY drives on the card (default and
reference_parity) within 1e-4 m of the same drive through the port on the
CPU, with equal ICP iteration counts and launch counts equal to the
schedule; the step's front end (kernels/prepare.py) bitwise its plain
version on the card, every output (the normals on planar cells), on drive
scans and on tests/_prepare_cases.py's edge scans; the map update
(kernels/map_update.py) bitwise its plain version on the card, the whole
table, keys, count, origin, size and dropped count, on the cases of
tests/_map_update_cases.py and on drive states.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from lidar_odometry_demo_tpu_torch.config import TINY, OdometryConfig, reference_parity
from lidar_odometry_demo_tpu_torch.io.simulator import sample_structured_cloud, simulate_sequence
from lidar_odometry_demo_tpu_torch.kernels.correspondence import (
    match_correspondences, match_correspondences_plain, match_rows, match_rows_plain)
from lidar_odometry_demo_tpu_torch.kernels.jtwj import (
    GnWork, gn_epilogue, gn_epilogue_plain, gn_epilogue_sum_plain, gn_step, gn_step_plain,
    gn_sum_step, gn_sum_step_plain, jtwj_accumulate, jtwj_plain, sum_in_rank_order)
from lidar_odometry_demo_tpu_torch.kernels.search import (
    group_lookup, group_lookup_plain, neighborhood_lookup, neighborhood_lookup_plain,
    search_sorted, search_sorted_plain)
from lidar_odometry_demo_tpu_torch.ops import voxel_map as tvm
from lidar_odometry_demo_tpu_torch.ops.cloud import PointsWithNormals, scan_from_numpy
from lidar_odometry_demo_tpu_torch.ops.se3 import Pose, quat_to_matrix
from lidar_odometry_demo_tpu_torch.ops.voxel_map import (
    EMPTY_KEY, CandidateSet, Correspondence, _lanes)
from lidar_odometry_demo_tpu_torch.pipeline import odometry

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")


def _candidates(rng, Q, K):
    RW, _, _ = _lanes(K)
    q = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    rows = np.zeros((3, 9, Q, RW), np.float32)
    pts = q[None, None, :, None, :] + rng.normal(0, 0.25, (3, 9, Q, K, 3))
    for i in range(3):
        rows[..., i * K:(i + 1) * K] = pts[..., i]
    rows[..., 3 * K] = rng.integers(0, K + 1, (3, 9, Q))
    rows_z = tuple(torch.from_numpy(rows[s].reshape(9 * Q, RW).view(np.int32).copy()).cuda()
                   for s in range(3))
    n_present = torch.from_numpy(rng.integers(0, 4, (9, Q)).astype(np.int32)).cuda()
    return torch.from_numpy(q).cuda(), rows_z, n_present


def _system(rng, Q):
    sl = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    pn = rng.normal(0, 1, (Q, 3)).astype(np.float32)
    pn /= np.linalg.norm(pn, axis=1, keepdims=True)
    R = Rotation.from_euler("xyz", [0.02, -0.01, 0.3]).as_matrix().astype(np.float32)
    t = np.array([1.5, -0.2, 0.1], np.float32)
    po = (sl @ R.T + t + rng.normal(0, 0.03, (Q, 3))).astype(np.float32)
    valid = rng.random(Q) < 0.8
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (sl, po, pn, valid, R, t)]


def test_match_rows_kernel_matches_plain(rng):
    _need_card()
    max_d2 = float(np.float32(0.09))
    q, rows_z, n_present = _candidates(rng, 8192, 20)
    before = match_rows.launches
    ko, ki, kd = match_rows(q, rows_z, n_present, max_d2=max_d2, max_points=20)
    assert match_rows.launches == before + 1
    po, pi, pd = match_rows_plain(q, rows_z, n_present, max_d2=max_d2, max_points=20)
    valid = pd < max_d2
    assert int(valid.sum()) > 4096
    assert torch.equal(ki[valid], pi[valid])
    assert torch.allclose(kd, pd, atol=1e-6, rtol=0)
    assert torch.allclose(ko[valid], po[valid], atol=1e-6, rtol=0)


@pytest.mark.parametrize("Q", [8192, 8115, 1])
def test_jtwj_kernel_matches_plain_and_repeats(rng, Q):
    _need_card()
    corr, pose, _ = _step_inputs(rng, Q)
    H, b = jtwj_accumulate(corr, pose, huber_delta=0.15)
    H2, b2 = jtwj_accumulate(corr, pose, huber_delta=0.15)
    Hp, bp = jtwj_plain(*corr, quat_to_matrix(pose.q), pose.t, huber_delta=0.15)
    assert torch.equal(H, H2) and torch.equal(b, b2)
    assert torch.allclose(H, Hp, rtol=2e-5, atol=1e-4)
    assert torch.allclose(b, bp, rtol=2e-5, atol=1e-4)


def _step_inputs(rng, Q):
    sl, po, pn, valid, R, t = _system(rng, Q)
    q = Rotation.from_matrix(R.cpu().numpy().astype(np.float64)).as_quat()[[3, 0, 1, 2]]
    pose = Pose(t, torch.from_numpy(q.astype(np.float32)).cuda())
    return Correspondence(sl, po, pn, valid), pose, t + 0.05


def _snapshot(step):
    pose, norm, H, b = step
    return [x.clone() for x in (pose.t, pose.q, norm, H, b)]


@pytest.mark.parametrize("Q", [8192, 8115, 1])
def test_gn_step_kernel_matches_plain_and_repeats(rng, Q):
    _need_card()
    cfg = OdometryConfig()
    corr, pose, guess_t = _step_inputs(rng, Q)
    work = GnWork.empty(2, "cuda")
    before = jtwj_accumulate.launches
    first = _snapshot(gn_step(corr, pose, guess_t, cfg, work=work, slot=1))
    second = _snapshot(gn_step(corr, pose, guess_t, cfg, work=work, slot=1))
    assert jtwj_accumulate.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    (pt, pq), pnorm, pH, pb = gn_step_plain(corr, pose, guess_t, cfg)
    t, q, norm, H, b = first
    assert torch.allclose(H, pH, rtol=2e-5, atol=1e-4)
    assert torch.allclose(b, pb, rtol=2e-5, atol=1e-4)
    assert torch.allclose(t, pt, atol=1e-6, rtol=0)
    assert torch.allclose(q, pq, atol=1e-6, rtol=0)
    assert torch.allclose(norm, pnorm, rtol=1e-5, atol=0)


def test_gn_step_reuses_its_workspace(rng):
    """The cluster's reduction and the workspace, 100 steps back to back."""
    _need_card()
    cfg = OdometryConfig()
    corr, pose, guess_t = _step_inputs(rng, 8192)
    work = GnWork.empty(1, "cuda")
    first = _snapshot(gn_step(corr, pose, guess_t, cfg, work=work))
    for _ in range(100):
        out = gn_step(corr, pose, guess_t, cfg, work=work)
    assert all(torch.equal(x, y) for x, y in zip(first, _snapshot(out)))


def _fused(rng, Q, K, C=4096):
    """K1's pose-mode inputs: candidates around each query's world position,
    random column bases, a table of random normal lanes."""
    RW, _, W = _lanes(K)
    R = Rotation.from_euler("xyz", [0.03, -0.02, 0.4]).as_matrix().astype(np.float32)
    t = np.array([2.0, -1.0, 0.3], np.float32)
    local = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    q_world = local @ R.T + t
    rows = np.zeros((3, 9, Q, RW), np.float32)
    pts = q_world[None, None, :, None, :] + rng.normal(0, 0.25, (3, 9, Q, K, 3))
    for i in range(3):
        rows[..., i * K:(i + 1) * K] = pts[..., i]
    rows[..., 3 * K] = rng.integers(0, K + 1, (3, 9, Q))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    cand = CandidateSet(
        rows_z=tuple(up(rows[s].reshape(9 * Q, RW).view(np.int32)) for s in range(3)),
        base=up(rng.integers(0, C, (9, Q)).astype(np.int32)),
        n_present=up(rng.integers(0, 4, (9, Q)).astype(np.int32)))
    tab = up(rng.normal(0, 1, (C, W)).astype(np.float32).view(np.int32))
    nrm_view = tab[:, RW:RW + 3 * K].view(torch.float32).reshape(C, K, 3)
    return [up(local), up(rng.random(Q) < 0.9), up(t), up(R), cand], tab, nrm_view


@pytest.mark.parametrize("shift", [0.0, 100.0])
def test_match_correspondences_kernel_matches_plain(rng, shift):
    """100 m away no query has a valid candidate."""
    _need_card()
    args, tab, nrm_view = _fused(rng, 8192, 20)
    args[2] = args[2] + shift
    max_d2 = float(np.float32(0.09))
    before = match_rows.launches
    got = match_correspondences(*args, tab, nrm_view, max_d2=max_d2, max_points=20)
    assert match_rows.launches == before + 1
    ref = match_correspondences_plain(*args, nrm_view, max_d2=max_d2, max_points=20)
    n_valid = int(ref.valid.sum())
    assert n_valid > 4096 if shift == 0.0 else n_valid == 0
    assert torch.equal(got.index, ref.index) and torch.equal(got.valid, ref.valid)
    for f in ("plane_origin", "plane_normal", "d2"):
        assert torch.allclose(getattr(got, f), getattr(ref, f), atol=1e-6, rtol=0), f


def test_wrappers_check_their_inputs_on_card(rng):
    _need_card()
    q, rows_z, n_present = _candidates(rng, 64, 20)
    with pytest.raises(ValueError, match="int32"):
        match_rows(q, rows_z, n_present.long(), max_d2=0.09, max_points=20)
    with pytest.raises(ValueError, match="contiguous"):
        match_rows(q.T.contiguous().T, rows_z, n_present, max_d2=0.09, max_points=20)
    corr, pose, guess_t = _step_inputs(rng, 64)
    with pytest.raises(ValueError, match="shape"):
        jtwj_accumulate(corr._replace(valid=corr.valid[:32]), pose, huber_delta=0.15)
    with pytest.raises(ValueError, match="shape"):
        gn_step(corr, Pose(pose.t, pose.q[:3]), guess_t, OdometryConfig())
    args, tab, nrm_view = _fused(rng, 64, 20)
    with pytest.raises(ValueError, match="normal lanes"):
        match_correspondences(*args, tab[:, :64].contiguous(), nrm_view, max_d2=0.09,
                              max_points=20)


def _counts() -> tuple:
    """K1, K2 and K3's launch counters, the captured loops' rounds added
    (pipeline/graphs.py settle_launches)."""
    from lidar_odometry_demo_tpu_torch.pipeline import graphs

    graphs.settle_launches()
    return match_rows.launches, jtwj_accumulate.launches, search_sorted.launches


def _drive_cpu_and_card(cfg, n_scans=5):
    d = simulate_sequence(num_scans=n_scans, width=TINY.scan_width, seed=3, speed=2.0,
                          yaw_rate=0.05, ramp_time=0.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                                 TINY.max_raw_points, dev) for s in d.scans]
        before = _counts()
        _, diag = odometry.make_sequence_runner(cfg)(odometry.init_state(cfg, dev), scans)
        launched = tuple(x - b for x, b in zip(_counts(), before))
        runs[dev] = (diag.pose.t.cpu().numpy(), diag.icp_iterations.cpu().numpy(), launched)
    (t_cpu, it_cpu, _), (t_gpu, it_gpu, launched) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(t_gpu, t_cpu, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(it_gpu, it_cpu)
    return it_gpu, launched


def test_tiny_drive_on_card_matches_cpu():
    _need_card()
    iters, launched = _drive_cpu_and_card(TINY)
    rounds = iters.sum()
    # K3: one neighbourhood lookup per ICP scan, one per map_update (every scan)
    assert launched == (rounds, TINY.icp_inner_iterations * rounds,
                        np.sum(iters > 0) + len(iters))


def test_reference_parity_tiny_drive_on_card_matches_cpu():
    _need_card()
    cfg = reference_parity(TINY)
    iters, launched = _drive_cpu_and_card(cfg)
    rounds = iters.sum()
    # K3: one lookup per ICP round (the exact search), one per map_update
    assert launched == (rounds, cfg.icp_inner_iterations * rounds, rounds + len(iters))


def _edge_queries(keys: np.ndarray, n_live: int) -> np.ndarray:
    """Below, at and just above keys[0]; keys[1]; a key; the last live key
    and one above it; the EMPTY_KEY run; the largest int32."""
    k0, k1, last = int(keys[0]), int(keys[1]), int(keys[n_live - 1])
    return np.array([k0 - 1, k0, k0 + 1, k1, int(keys[100]), last, last + 1,
                     EMPTY_KEY, 2**31 - 1], np.int32)


@pytest.mark.parametrize("tail", [True, False])
def test_search_kernel_matches_plain_and_searchsorted(rng, tail):
    _need_card()
    C = 131072
    n_live = 88923 if tail else C
    live = np.sort(rng.choice(2**30, n_live, replace=False)).astype(np.int32)
    keys_np = np.concatenate([live, np.full(C - n_live, EMPTY_KEY, np.int32)])
    q_np = np.concatenate([_edge_queries(keys_np, n_live),
                           rng.integers(0, 2**31, 8192 * 9).astype(np.int32),
                           keys_np[rng.integers(0, C, 4096)]])
    keys, q = torch.from_numpy(keys_np).cuda(), torch.from_numpy(q_np).cuda()
    before = search_sorted.launches
    got = search_sorted(keys, q)
    assert search_sorted.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == q.shape
    assert torch.equal(got, search_sorted_plain(keys, q))
    assert torch.equal(got, torch.searchsorted(keys, q, side="left", out_int32=True))
    if not tail:
        assert int(got[6]) == C  # above every key: C, never C + 1


def test_search_kernel_small_tables_and_no_queries(rng):
    _need_card()
    for C in (0, 1, 2, 3, 7, 8, 9, 1000):
        keys = torch.from_numpy(np.sort(rng.integers(0, 50, C)).astype(np.int32)).cuda()
        q = torch.arange(-2, 53, dtype=torch.int32, device="cuda")
        assert torch.equal(search_sorted(keys, q),
                           torch.searchsorted(keys, q, side="left", out_int32=True))
    before = search_sorted.launches
    out = search_sorted(keys, torch.zeros(0, dtype=torch.int32, device="cuda"))
    assert out.shape == (0,) and search_sorted.launches == before  # no launch
    with pytest.raises(ValueError, match="int32"):
        search_sorted(keys.long(), q)


# (capacity, points per plane of the structured cloud, queries): the bench
# drive's map and match budget, and TINY's
_LOOKUP_SHAPES = {"bench": (131072, 6000, 8192), "tiny": (TINY.map_capacity, 300,
                                                         TINY.max_match_points)}


def _card_map(capacity, n_per_plane, seed=4):
    """A keyframe map built on the card (map_insert, voxel 0.2 m, K = 20)
    from a structured cloud, and the cloud."""
    xyz, nrm = sample_structured_cloud(seed=seed, n_per_plane=n_per_plane)
    pts = PointsWithNormals(torch.from_numpy(xyz).cuda(), torch.from_numpy(nrm).cuda(),
                            torch.ones(xyz.shape[0], dtype=torch.bool, device="cuda"))
    m = tvm.map_insert(tvm.map_init(capacity, 20, "cuda"), pts, voxel_size=0.2)
    return m, xyz


def _lookup_args(rng, m, xyz, Q, turn):
    """Local queries near stored points under a pose turned by `turn` and
    shifted, with some outside the column window, some beyond the z window
    and about 5 % invalid; the lookup's positional arguments."""
    R = Rotation.from_euler("z", turn).as_matrix().astype(np.float32)
    t = np.array([turn, -2 * turn, 0.1 * turn], np.float32)
    world = xyz[rng.integers(0, xyz.shape[0], Q)] + rng.normal(0, 0.15, (Q, 3))
    world[:16] += 150.0
    world[16:32, 2] += rng.uniform(-30, 30, 16)
    local = ((world.astype(np.float32) - t) @ R).astype(np.float32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return (m.tab, m.keys, m.origin, up(local), up(rng.random(Q) < 0.95), up(t), up(R))


def _assert_same_candidates(got, ref):
    """base and n_present equal everywhere, present rows bitwise."""
    assert torch.equal(got.base, ref.base)
    assert torch.equal(got.n_present, ref.n_present)
    npres = ref.n_present.reshape(-1)
    for s in range(3):
        live = npres > s
        assert torch.equal(got.rows_z[s][live], ref.rows_z[s][live]), f"slice {s}"


@pytest.mark.parametrize("turn", [0.0, 0.3])
@pytest.mark.parametrize("shape", ["bench", "tiny"])
def test_neighborhood_lookup_kernel_matches_plain(rng, shape, turn):
    _need_card()
    capacity, n_per_plane, Q = _LOOKUP_SHAPES[shape]
    m, xyz = _card_map(capacity, n_per_plane)
    args = _lookup_args(rng, m, xyz, Q, turn)
    RW, _, _ = _lanes(20)
    before = search_sorted.launches
    got = neighborhood_lookup(*args, voxel_size=0.2, row_width=RW)
    assert search_sorted.launches == before + 1
    ref = neighborhood_lookup_plain(*args, voxel_size=0.2, row_width=RW)
    n = ref.n_present.cpu().numpy()
    assert (n == 3).sum() > Q // 4 and (n == 0).sum() > 16
    _assert_same_candidates(got, ref)


def test_neighborhood_lookup_on_voxel_boundaries(rng):
    """Queries whose world points fall exactly on voxel boundaries, and one
    ulp to either side, after a quarter turn (exact in float32) and a
    shift: a division by the reciprocal would move some of them a voxel."""
    _need_card()
    m, _ = _card_map(*_LOOKUP_SHAPES["bench"][:2])
    R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    t = np.array([0.4, -0.2, 0.0], np.float32)
    k = np.concatenate([rng.integers(-40, 40, (2048, 2)), rng.integers(0, 2, (2048, 1))], 1)
    world = (k * np.float32(0.2)).astype(np.float32)  # z on the ground's voxels
    world = np.concatenate([world, np.nextafter(world, np.inf), np.nextafter(world, -np.inf)])
    local = ((world - t) @ R).astype(np.float32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    args = (m.tab, m.keys, m.origin, up(local), up(np.ones(len(local), bool)), up(t), up(R))
    RW, _, _ = _lanes(20)
    got = neighborhood_lookup(*args, voxel_size=0.2, row_width=RW)
    ref = neighborhood_lookup_plain(*args, voxel_size=0.2, row_width=RW)
    assert int((ref.n_present > 0).sum()) > 2 * len(local)
    _assert_same_candidates(got, ref)


def test_neighborhood_lookup_reuses_its_output(rng):
    """100 back-to-back lookups into one preallocated CandidateSet (the
    exact-search loop's) equal the first."""
    _need_card()
    capacity, n_per_plane, Q = _LOOKUP_SHAPES["bench"]
    m, xyz = _card_map(capacity, n_per_plane)
    args = _lookup_args(rng, m, xyz, Q, 0.3)
    RW, _, _ = _lanes(20)
    out = tvm.CandidateSet.empty(Q, RW, "cuda")
    first = neighborhood_lookup(*args, voxel_size=0.2, row_width=RW)
    first = tvm.CandidateSet(tuple(r.clone() for r in first.rows_z), first.base.clone(),
                             first.n_present.clone())
    for _ in range(100):
        got = neighborhood_lookup(*args, voxel_size=0.2, row_width=RW, out=out)
    assert got is out
    _assert_same_candidates(got, first)


@pytest.mark.parametrize("shape", ["bench", "tiny"])
def test_group_lookup_kernel_matches_plain(rng, shape):
    """map_update's lookup: an EMPTY_KEY tail in the table and in the sorted
    queries, groups absent from the table, the last live key; N = 0 gives
    no launch."""
    _need_card()
    C, N = (131072, 16384) if shape == "bench" else (TINY.map_capacity,
                                                      TINY.max_update_points)
    n_live = int(C * 0.68)
    live = np.sort(rng.choice(2**30, n_live, replace=False)).astype(np.int32)
    keys_np = np.concatenate([live, np.full(C - n_live, EMPTY_KEY, np.int32)])
    n_valid = int(N * 0.9)
    q_np = np.concatenate([live[rng.integers(0, n_live, n_valid // 2)],
                           rng.integers(0, 2**30, n_valid - n_valid // 2 - 1).astype(np.int32),
                           [live[-1]], np.full(N - n_valid, EMPTY_KEY, np.int32)])
    keys, q = torch.from_numpy(keys_np).cuda(), torch.from_numpy(np.sort(q_np)).cuda()
    before = search_sorted.launches
    pos_c, found = group_lookup(keys, q)
    assert search_sorted.launches == before + 1
    ref_pos, ref_found = group_lookup_plain(keys, q)
    assert torch.equal(pos_c, ref_pos) and torch.equal(found, ref_found)
    assert int(found.sum()) >= n_valid // 2 and not bool(found[q == EMPTY_KEY].any())
    assert bool(found[q == int(live[-1])].all())
    empty = group_lookup(keys, q[:0])
    assert empty[0].shape == empty[1].shape == (0,) and search_sorted.launches == before + 1


def test_lookup_wrappers_check_their_inputs_on_card(rng):
    _need_card()
    m, xyz = _card_map(4096, 300)
    args = list(_lookup_args(rng, m, xyz, 64, 0.0))
    RW, _, _ = _lanes(20)
    with pytest.raises(ValueError, match="float32"):
        neighborhood_lookup(*args[:3], args[3].double(), *args[4:], voxel_size=0.2,
                            row_width=RW)
    with pytest.raises(ValueError, match="shape"):
        neighborhood_lookup(*args, voxel_size=0.2, row_width=RW,
                            out=tvm.CandidateSet.empty(32, RW, "cuda"))
    with pytest.raises(ValueError, match="int32"):
        group_lookup(m.keys.long(), m.keys)
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        group_lookup(meta, meta)


# ---------------------------------------------------------------------------
# the lane axis: B sequences in one launch
# ---------------------------------------------------------------------------

def _lanes_of(trees):
    """Stack B single-lane argument lists (tensors, tuples, CandidateSets)
    into one with a leading lane axis."""
    def stack(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs).contiguous()
        items = [stack([x[i] for x in xs]) for i in range(len(xs[0]))]
        return type(xs[0])(*items) if hasattr(xs[0], "_fields") else tuple(items)

    return [stack([t[i] for t in trees]) for i in range(len(trees[0]))]


def _lane(x, b):
    if isinstance(x, torch.Tensor):
        return x[b]
    items = [_lane(v, b) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def test_match_correspondences_over_lanes(rng):
    """K1 at B = 3: each lane bitwise its B = 1 launch, and the plain
    version's index and valid, floats within 1e-6."""
    _need_card()
    per = [_fused(rng, 2048, 20) for _ in range(3)]
    args = _lanes_of([p[0] for p in per])
    tab = torch.stack([p[1] for p in per])
    nrm = torch.stack([p[2] for p in per])
    before = match_rows.launches
    got = match_correspondences(*args, tab, nrm, max_d2=0.09, max_points=20)
    assert match_rows.launches == before + 1
    ref = match_correspondences_plain(*args, nrm, max_d2=0.09, max_points=20)
    assert torch.equal(got.index, ref.index) and torch.equal(got.valid, ref.valid)
    for f in ("plane_origin", "plane_normal", "d2"):
        assert torch.allclose(getattr(got, f), getattr(ref, f), atol=1e-6, rtol=0), f
    for b, (a1, t1, n1) in enumerate(per):
        one = match_correspondences(*a1, t1, n1, max_d2=0.09, max_points=20)
        assert all(torch.equal(x[b], y) for x, y in zip(got, one))


def test_gn_step_over_lanes_with_an_inactive_lane(rng):
    """K2 at B = 3 with lane 1 inactive: the active lanes bitwise their
    B = 1 launches, the inactive lane's pose and step norm unchanged."""
    _need_card()
    cfg = OdometryConfig()
    per = [_step_inputs(rng, 8192) for _ in range(3)]
    corr = Correspondence(*(torch.stack(xs) for xs in zip(*[p[0] for p in per])))
    pose = Pose(torch.stack([p[1].t for p in per]), torch.stack([p[1].q for p in per]))
    guess_t = torch.stack([p[2] for p in per])
    norm_in = torch.tensor([0.5, 0.25, 0.125], device="cuda")
    active = torch.tensor([True, False, True], device="cuda")
    work = GnWork.empty(1, "cuda", (3,))
    new, norm, H, b = gn_step(corr, pose, guess_t, cfg, work=work, step_norm=norm_in,
                              active=active)
    assert torch.equal(new.t[1], pose.t[1]) and torch.equal(new.q[1], pose.q[1])
    assert float(norm[1]) == 0.25
    plain = gn_step_plain(corr, pose, guess_t, cfg, step_norm=norm_in, active=active)
    assert torch.allclose(new.t, plain[0].t, atol=1e-6, rtol=0)
    assert torch.allclose(new.q, plain[0].q, atol=1e-6, rtol=0)
    for lane in (0, 2):
        one = _snapshot(gn_step(*per[lane], cfg))
        assert all(torch.equal(x, y) for x, y in
                   zip([new.t[lane], new.q[lane], norm[lane], H[lane], b[lane]], one))



def _split_step(corr, pose, guess_t, cfg, work, **lane_args):
    H, b = jtwj_accumulate(corr, pose, huber_delta=cfg.icp_huber_delta, work=work,
                           active=lane_args.get("active"))
    new, norm = gn_epilogue(work.hb[None], pose, guess_t, cfg, work=work, **lane_args)
    return new, norm, H, b


@pytest.mark.parametrize("Q", [8192, 8115, 1])
def test_split_step_is_the_fused_step(rng, Q):
    """K2 split as under an sp or spatial group (of one rank here): the
    epilogue-off launch at the pose, then the epilogue entry point on its H
    and b, gives the fused step's H, b, pose and step norm bitwise, one
    launch each, and the epilogue's plain version's pose within 1e-6."""
    _need_card()
    cfg = OdometryConfig()
    corr, pose, guess_t = _step_inputs(rng, Q)
    fused = _snapshot(gn_step(corr, pose, guess_t, cfg, work=GnWork.empty(1, "cuda")))
    before = (jtwj_accumulate.launches, gn_epilogue.launches)
    split = _snapshot(_split_step(corr, pose, guess_t, cfg, GnWork.empty(1, "cuda")))
    assert (jtwj_accumulate.launches, gn_epilogue.launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.equal(x, y) for x, y in zip(split, fused))
    (pt, pq), pnorm = gn_epilogue_plain(split[3], split[4], pose, guess_t, cfg)
    assert torch.allclose(split[0], pt, atol=1e-6, rtol=0)
    assert torch.allclose(split[1], pq, atol=1e-6, rtol=0)
    assert torch.allclose(split[2], pnorm, rtol=1e-5, atol=0)


def test_split_step_over_lanes_with_an_inactive_lane(rng):
    """The split step at B = 3 with lane 1 inactive: bitwise the fused
    step at B = 3 (the inactive lane's pose and step norm unchanged), and
    the epilogue's plain version's poses within 1e-6."""
    _need_card()
    cfg = OdometryConfig()
    per = [_step_inputs(rng, 8192) for _ in range(3)]
    corr = Correspondence(*(torch.stack(xs) for xs in zip(*[p[0] for p in per])))
    pose = Pose(torch.stack([p[1].t for p in per]), torch.stack([p[1].q for p in per]))
    guess_t = torch.stack([p[2] for p in per])
    lane_args = dict(step_norm=torch.tensor([0.5, 0.25, 0.125], device="cuda"),
                     active=torch.tensor([True, False, True], device="cuda"))
    fused = _snapshot(gn_step(corr, pose, guess_t, cfg, work=GnWork.empty(1, "cuda", (3,)),
                              **lane_args))
    split = _snapshot(_split_step(corr, pose, guess_t, cfg, GnWork.empty(1, "cuda", (3,)),
                                  **lane_args))
    for x, y in zip(split[:3], fused[:3]):
        assert torch.equal(x, y)
    for x, y in zip(split[3:], fused[3:]):  # H and b of the active lanes
        assert torch.equal(x[0::2], y[0::2])
    assert torch.equal(split[0][1], pose.t[1]) and float(split[2][1]) == 0.25
    (pt, pq), _ = gn_epilogue_plain(split[3], split[4], pose, guess_t, cfg, **lane_args)
    assert torch.allclose(split[0], pt, atol=1e-6, rtol=0)
    assert torch.allclose(split[1], pq, atol=1e-6, rtol=0)


def _lanes_of_parts(rng, n):
    """B = 3 lanes at Q = 8192 (lane 1 inactive) cut into the row slices of
    n fake ranks, each slice's part at the pose from jtwj_accumulate:
    (slices, parts (n, 3, 42), pose, guess_t, lane_args)."""
    per = [_step_inputs(rng, 8192) for _ in range(3)]
    corr = Correspondence(*(torch.stack(xs) for xs in zip(*[p[0] for p in per])))
    pose = Pose(torch.stack([p[1].t for p in per]), torch.stack([p[1].q for p in per]))
    guess_t = torch.stack([p[2] for p in per])
    lane_args = dict(step_norm=torch.tensor([0.5, 0.25, 0.125], device="cuda"),
                     active=torch.tensor([True, False, True], device="cuda"))
    rows = [slice(r * 8192 // n, (r + 1) * 8192 // n) for r in range(n)]
    slices = [Correspondence(*(x[:, s].contiguous() for x in corr)) for s in rows]
    parts = []
    for part_corr in slices:
        work = GnWork.empty(1, "cuda", (3,))
        jtwj_accumulate(part_corr, pose, huber_delta=0.15, work=work,
                        active=lane_args["active"])
        parts.append(work.hb)
    return slices, torch.stack(parts), pose, guess_t, lane_args


@pytest.mark.parametrize("n", [1, 2, 4])
def test_gn_epilogue_on_parts_is_the_epilogue_on_their_sum(rng, n):
    """K2e on n ranks' parts (B = 3, lane 1 inactive): bitwise K2e on their
    rank-order sum by torch (one part), the inactive lane held; the pose
    within 1e-6 and the step norm within rtol 1e-5 of its plain version;
    one launch."""
    _need_card()
    cfg = OdometryConfig()
    _, parts, pose, guess_t, lane_args = _lanes_of_parts(rng, n)
    total = sum_in_rank_order(parts)
    want = _snapshot((*gn_epilogue(total[None], pose, guess_t, cfg,
                                   work=GnWork.empty(1, "cuda", (3,)), **lane_args), total, total))
    before = gn_epilogue.launches
    got = _snapshot((*gn_epilogue(parts, pose, guess_t, cfg, work=GnWork.empty(1, "cuda", (3,)),
                                  **lane_args), total, total))
    assert gn_epilogue.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
    assert torch.equal(got[0][1], pose.t[1]) and float(got[2][1]) == 0.25
    (pt, pq), pnorm = gn_epilogue_sum_plain(parts, pose, guess_t, cfg, **lane_args)
    assert torch.allclose(got[0], pt, atol=1e-6, rtol=0)
    assert torch.allclose(got[1], pq, atol=1e-6, rtol=0)
    assert torch.allclose(got[2], pnorm, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_gn_sum_step_is_the_launch_sequence_it_replaces(rng, n):
    """gn_sum_step on n ranks' parts, for every rank's slice (B = 3, lane 1
    inactive): pose and step norm bitwise K2e on the torch rank-order sum,
    and the part it writes bitwise `jtwj_accumulate` at that pose (the
    active lanes); within 1e-6 (pose) and rtol 1e-5 (step norm) of its plain
    version, and the part, entry by entry, within 4 eps sqrt(Q / n) of its
    terms' magnitudes (chip_smoke.abs_terms_sum) of `jtwj_plain` at the
    kernel's pose; one launch, counted apart from K2's others."""
    _need_card()
    cfg = OdometryConfig()
    abs_terms_sum = _smoke().abs_terms_sum
    eps = float(np.finfo(np.float32).eps)
    slices, parts, pose, guess_t, lane_args = _lanes_of_parts(rng, n)
    total = sum_in_rank_order(parts)
    old_work = GnWork.empty(1, "cuda", (3,))
    old_pose, old_norm = gn_epilogue(total[None], pose, guess_t, cfg, work=old_work, **lane_args)
    for part_corr in slices:
        acc = GnWork.empty(1, "cuda", (3,))
        jtwj_accumulate(part_corr, old_pose, huber_delta=cfg.icp_huber_delta, work=acc,
                        active=lane_args["active"])
        work = GnWork.empty(1, "cuda", (3,))
        before = (gn_sum_step.launches, jtwj_accumulate.launches)
        new, norm = gn_sum_step(parts, part_corr, pose, guess_t, cfg, work=work, **lane_args)
        assert (gn_sum_step.launches, jtwj_accumulate.launches) == (before[0] + 1, before[1])
        assert torch.equal(new.t, old_pose.t) and torch.equal(new.q, old_pose.q)
        assert torch.equal(norm, old_norm) and float(norm[1]) == 0.25
        assert torch.equal(work.hb[0::2], acc.hb[0::2])
        pp, pn, _, _ = gn_sum_step_plain(parts, part_corr, pose, guess_t, cfg, **lane_args)
        assert torch.allclose(new.t, pp.t, atol=1e-6, rtol=0)
        assert torch.allclose(new.q, pp.q, atol=1e-6, rtol=0)
        assert torch.allclose(norm, pn, rtol=1e-5, atol=1e-7)
        H, b = jtwj_plain(*part_corr, quat_to_matrix(new.q), new.t,
                          huber_delta=cfg.icp_huber_delta)
        want = torch.cat([H.flatten(-2), b], -1)
        bar = 4 * eps * (8192 // n) ** 0.5 * abs_terms_sum(part_corr, new, cfg.icp_huber_delta)
        assert bool(((work.hb - want).abs() <= bar)[0::2].all())


@pytest.mark.parametrize("n", [2, 4])
def test_composite_view_search_on_card(n):
    """The column-sharded map's composite view (parallel/spatial.py) on the
    card: a TINY drive's map split into n shards, each rank's view merged
    from its shard and its ring neighbours' (3C/4 rows at n = 4, no power of
    two), searched by K3 and K1 for the queries it owns: bitwise the
    replicated map's search (chip_smoke.composite_search_check)."""
    _need_card()
    smoke = _smoke()
    cfg = TINY.replace(map_capacity=8192)
    drive = simulate_sequence(num_scans=6, width=cfg.scan_width, seed=3, speed=2.0,
                              yaw_rate=0.05)
    scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             cfg.max_raw_points, "cuda") for s in drive.scans]
    odo = odometry.LidarOdometry(cfg, device="cuda")
    for scan in scans[:-1]:
        odo.process_scan(scan)
    lookup = smoke.path_lookups(odo, scans[-1])["neighbourhood"][0][0]
    out = smoke.composite_search_check(odo.state.keyframe, lookup, n, cfg)
    assert out["rows"] == min(n, 3) * cfg.map_capacity // n and out["matches"] > 100

def test_lookups_over_lanes(rng):
    """K3's neighbourhood and group lookups at B = 3 (three maps built on
    the card): bitwise their plain versions and their B = 1 launches."""
    _need_card()
    built = [_card_map(4096, 300, seed=s) for s in (4, 5, 6)]
    maps = [m for m, _ in built]
    per = [_lookup_args(rng, m, x, 1024, 0.1 * i) for i, (m, x) in enumerate(built)]
    args = _lanes_of(per)
    RW, _, _ = _lanes(20)
    before = search_sorted.launches
    got = neighborhood_lookup(*args, voxel_size=0.2, row_width=RW)
    assert search_sorted.launches == before + 1
    ref = neighborhood_lookup_plain(*args, voxel_size=0.2, row_width=RW)
    for b in range(3):
        _assert_same_candidates(_lane(got, b), _lane(ref, b))
        _assert_same_candidates(_lane(got, b),
                                neighborhood_lookup(*per[b], voxel_size=0.2, row_width=RW))
    keys = args[1]
    q = torch.sort(torch.stack([m.keys[torch.randperm(4096, device="cuda")[:512]]
                                for m in maps]), dim=-1).values
    pos_c, found = group_lookup(keys, q)
    ref = group_lookup_plain(keys, q)
    assert torch.equal(pos_c, ref[0]) and torch.equal(found, ref[1])
    for b in range(3):
        p1, f1 = group_lookup(keys[b], q[b])
        assert torch.equal(pos_c[b], p1) and torch.equal(found[b], f1)


def test_tiny_fleet_on_card_matches_cpu():
    """The batched runner at B = 3 (two drives, the first twice) on the card
    against the same on the CPU; launches: K1 once per batched round (the
    slowest lane's), K2 four times that, K3 once per ICP step and once per
    map_update step."""
    _need_card()
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
    from lidar_odometry_demo_tpu_torch.parallel import batched

    drives = [simulate_sequence(num_scans=5, width=TINY.scan_width, seed=s, speed=2.0,
                                yaw_rate=0.05, ramp_time=0.0) for s in (3, 2, 3)]
    runs = {}
    for dev in ("cpu", "cuda"):
        lanes = [[scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                                  TINY.max_raw_points, dev) for s in d.scans] for d in drives]
        scans_b = LidarScan(*(torch.stack([torch.stack([getattr(lane[i], f) for lane in lanes])
                                           for i in range(5)]) for f in LidarScan._fields))
        before = _counts()
        state, diag = batched.make_batched_sequence_runner(TINY)(
            batched.init_batched_state(TINY, 3, dev), scans_b)
        launched = tuple(x - b for x, b in zip(_counts(), before))
        runs[dev] = (state, diag, launched)
    (s_cpu, d_cpu, _), (s_gpu, d_gpu, launched) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(d_gpu.pose.t.cpu().numpy(), d_cpu.pose.t.numpy(), atol=1e-4, rtol=0)
    assert torch.equal(d_gpu.icp_iterations.cpu(), d_cpu.icp_iterations)
    assert torch.equal(d_gpu.pose.t[:, 0], d_gpu.pose.t[:, 2])
    assert torch.equal(s_gpu.keyframe.tab[0], s_gpu.keyframe.tab[2])
    iters = d_gpu.icp_iterations.cpu().numpy()
    rounds = int(iters.max(axis=1).sum())
    assert launched == (rounds, TINY.icp_inner_iterations * rounds,
                        int((iters.max(axis=1) > 0).sum()) + 5)


def test_fleet_ranks_asked_for_the_cpu_stay_on_it():
    """`fleet --dp 2 --device cpu` on a host with a card: both spawned
    ranks lay their tensors on the CPU (gloo), none on the card."""
    _need_card()
    import argparse

    from lidar_odometry_demo_tpu_torch import cli
    from lidar_odometry_demo_tpu_torch.parallel import mesh as mesh_lib

    args = argparse.Namespace(batch=2, scans=2, seed=0, speed=3.0, dp=2, sp=1)
    res = mesh_lib.run_ranks(cli._fleet_rank, 2, TINY, args, device="cpu", timeout=300)
    assert res[0]["devices"] == ["cpu", "cpu"] and res[0]["backend"] == "gloo"
    assert np.all(np.isfinite(res[0]["t"])) and res[0]["t"].shape == (2, 2, 3)


# ---------------------------------------------------------------------------
# live ingestion and the pose graph on the card
# ---------------------------------------------------------------------------

def test_tiny_run_live_on_card_matches_cpu():
    """run_live over a TINY drive's packets (no socket) on the card against
    the same on the CPU: t within 1e-4 m, equal iterations, and the main
    path's launch schedule."""
    _need_card()
    from lidar_odometry_demo_tpu_torch.io import live, native
    from lidar_odometry_demo_tpu_torch.io.simulator import encode_vlp16_packets

    if not native.available():
        pytest.skip("no C++ compiler: the native library cannot be built")
    d = simulate_sequence(num_scans=6, width=TINY.scan_width, seed=3, speed=2.0, yaw_rate=0.05,
                          ramp_time=0.0)
    packets = b"".join(encode_vlp16_packets(s["range_image"], s["scan_start"]) for s in d.scans)
    packets = [packets[i:i + live.PACKET_SIZE] for i in range(0, len(packets), live.PACKET_SIZE)]
    runs = {}
    for dev in ("cpu", "cuda"):
        odo = odometry.LidarOdometry(TINY, device=dev)
        ts, iters = [], []
        before = _counts()
        n = live.run_live(odo, iter(packets), flush_partial=True,
                          on_scan=lambda i, t, diag: (ts.append(t),
                                                      iters.append(int(diag.icp_iterations))))
        launched = tuple(x - b for x, b in zip(_counts(), before))
        runs[dev] = (n, np.stack(ts), np.array(iters), launched)
    (n_cpu, t_cpu, it_cpu, _), (n_gpu, t_gpu, it_gpu, launched) = runs["cpu"], runs["cuda"]
    assert n_cpu == n_gpu == 6
    np.testing.assert_allclose(t_gpu, t_cpu, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(it_gpu, it_cpu)
    rounds = int(it_gpu.sum())
    assert launched == (rounds, TINY.icp_inner_iterations * rounds,
                        int(np.sum(it_gpu > 0)) + n_gpu)


def _smoke():
    """chip_smoke.py as a module: its noisy loop and its system scale."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("solver", ["direct", "schur", "segment"])
def test_refine_on_card_matches_cpu(solver):
    """The pose graph on the card against the CPU: the first Gauss-Newton
    system's H and b within 1e-5 of their scale, the refined poses within
    5e-3 of the correction's scale (the JAX tests' bar for float32 dense
    elimination), the drift halved and pose 0 held."""
    _need_card()
    from lidar_odometry_demo_tpu_torch.parallel import pose_graph as pg

    smoke = _smoke()
    P_n, pairs = (256, [(248, 0), (128, 0)]) if solver == "segment" else (32, [(31, 0)])
    gt_t, _, est_t, est_q, closure = smoke.make_noisy_loop(
        P_n, drift=0.02 if solver == "segment" else 0.03)
    closures = [(i, j, closure(i, j), 1.0) for i, j in pairs]
    out = {}
    for dev in ("cpu", "cuda"):
        g = pg.chain_from_odometry(est_t, est_q, closures=closures, device=dev)
        if solver == "segment":
            system = pg.build_chain_system(g, 8)
            refined = pg.refine_segment(g, stride=8, iterations=10)
        else:
            system = pg.build_normal_equations(g)
            refined = pg.refine(g, iterations=10, use_schur=solver == "schur")
        out[dev] = ([x.cpu().numpy() for x in system], refined.poses.t.cpu().numpy(),
                    refined.poses.q.cpu().numpy())
    (sys_c, t_c, q_c), (sys_g, t_g, q_g) = out["cpu"], out["cuda"]
    for a, b in zip(sys_g, sys_c):
        np.testing.assert_allclose(a, b, atol=1e-5 * smoke._edge_scale(b), rtol=1e-5)
    step = np.abs(t_c - est_t).max()
    np.testing.assert_allclose(t_g, t_c, atol=5e-3 * step, rtol=0)
    np.testing.assert_allclose(q_g, q_c, atol=5e-3 * max(np.abs(q_c - est_q).max(), 1e-3),
                               rtol=0)
    rms = lambda t: np.sqrt(np.mean(np.sum((t - gt_t) ** 2, -1)))  # noqa: E731
    assert rms(t_g) < 0.5 * rms(est_t)
    np.testing.assert_allclose(t_g[0], est_t[0], atol=1e-3)


# ---------------------------------------------------------------------------
# the step's front end (kernels/prepare.py)
# ---------------------------------------------------------------------------

_FRONT_END_DRIVES: dict = {}
_FRONT_END_CONFIGS = {"full": OdometryConfig(), "tiny": TINY,
                      "parity": reference_parity(OdometryConfig())}


def _front_end_cases(shape: str, lanes: int) -> list:
    """`lanes` (scan, previous, current) of a 5-scan drive, cycled."""
    cfg = _FRONT_END_CONFIGS[shape]
    key = (cfg.scan_width, cfg.max_raw_points)
    if key not in _FRONT_END_DRIVES:
        from _prepare_cases import drive_scans

        _FRONT_END_DRIVES[key] = drive_scans(cfg, 5, seed=21)
    cases = _FRONT_END_DRIVES[key]
    return [cases[b % len(cases)] for b in range(lanes)]


def _front_end_args(cases: list, lead: bool, device):
    """(previous, current, raw) on `device`, with a lane axis where `lead`."""
    def field(get):
        xs = [torch.from_numpy(np.ascontiguousarray(get(c))).to(device) for c in cases]
        return torch.stack(xs) if lead else xs[0]

    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan

    raw = LidarScan(*(field(lambda c, f=f: c[0][f]) for f in LidarScan._fields))
    return (Pose(field(lambda c: c[1][0]), field(lambda c: c[1][1])),
            Pose(field(lambda c: c[2][0]), field(lambda c: c[2][1])), raw)


def _assert_front_end_equal(got, want):
    """Bitwise, every output; the normals on planar cells (outside the
    normals window the kernel writes zeros where the plain version computes
    from wrapped rows, and no reader takes them)."""
    v = want.planar.valid
    assert torch.equal(got.planar.valid, v)
    assert torch.equal(got.planar.xyz, want.planar.xyz)
    assert torch.equal(got.planar.normal[v], want.planar.normal[v])
    assert torch.equal(got.num_planar, want.num_planar)
    assert torch.equal(got.update_keys, want.update_keys)
    assert torch.equal(got.match_keys, want.match_keys)
    assert torch.equal(got.guess.t, want.guess.t) and torch.equal(got.guess.q, want.guess.q)
    assert torch.equal(got.deskewed_xyz, want.deskewed_xyz)


@pytest.mark.parametrize("lanes", [0, 1, 3, 8], ids=["one", "B1", "B3", "B8"])
@pytest.mark.parametrize("shape", ["full", "tiny", "parity"])
def test_front_end_kernel_matches_plain(shape, lanes):
    """The front end on drive scans bitwise its plain version on the card,
    two calls bitwise equal, and each lane of a batch bitwise its lone call."""
    _need_card()
    from lidar_odometry_demo_tpu_torch.kernels.prepare import prepare, prepare_plain

    cfg = _FRONT_END_CONFIGS[shape]
    cases = _front_end_cases(shape, max(lanes, 1))
    args = (*_front_end_args(cases, lanes > 0, "cuda"), cfg, True)
    got = prepare(*args)
    _assert_front_end_equal(got, prepare_plain(*args))
    _assert_front_end_equal(prepare(*args), got)
    assert int(got.num_planar.sum()) > (300 if shape == "tiny" else 5000) * max(lanes, 1)
    for b in range(lanes if lanes > 1 else 0):
        one = prepare(*_front_end_args(cases[b:b + 1], False, "cuda"), cfg, True)
        _assert_front_end_equal(_lane(got, b), one)


@pytest.mark.parametrize("name", ["still", "moving", "equal_time", "empty"])
@pytest.mark.parametrize("shape", ["full", "tiny"])
def test_front_end_kernel_edges(shape, name):
    """The edge scans (tests/_prepare_cases.py: two points in a cell, rings
    outside [0, R), an all-equal time, an empty scan, points at exactly 4 m
    and 80 m, cells at the flattened image's ends) bitwise the plain
    version on the card."""
    _need_card()
    from _prepare_cases import edge_case

    from lidar_odometry_demo_tpu_torch.kernels.prepare import prepare, prepare_plain

    cfg = _FRONT_END_CONFIGS[shape]
    edge, prev, cur = edge_case(cfg, name)
    args = (*_front_end_args([(edge.scan, prev, cur)], False, "cuda"), cfg, True)
    got = prepare(*args)
    _assert_front_end_equal(got, prepare_plain(*args))
    if name == "still":
        assert bool(got.planar.valid[edge.at_min]) and bool(got.planar.valid[edge.at_max])


def test_front_end_wrapper_checks_its_inputs():
    _need_card()
    from lidar_odometry_demo_tpu_torch.kernels.prepare import prepare

    cfg = TINY
    prev, cur, raw = _front_end_args(_front_end_cases("tiny", 1), False, "cuda")
    with pytest.raises(ValueError, match="int32"):
        prepare(prev, cur, raw._replace(ring=raw.ring.long()), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        prepare(prev, cur, raw._replace(xyz=raw.xyz.T.contiguous().T), cfg)
    with pytest.raises(ValueError, match="shape"):
        prepare(Pose(prev.t, prev.q[:3]), cur, raw, cfg)
    with pytest.raises(ValueError, match="shape"):  # the poses' lanes are the scan's
        prepare(Pose(prev.t[None], prev.q[None]), cur, raw, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        prepare(Pose(prev.t.cpu(), prev.q), cur, raw, cfg)
    with pytest.raises(ValueError, match="curvature_window"):
        prepare(prev, cur, raw, cfg.replace(curvature_window=5000))


@pytest.mark.parametrize("lanes", [0, 3], ids=["one", "B3"])
def test_front_end_counts_one_call_per_step(lanes):
    """`prepare.launches` counts one call a step on the card, eager scans
    and captured replays alike (pipeline/graphs.py COUNTED)."""
    _need_card()
    from lidar_odometry_demo_tpu_torch.kernels.prepare import prepare
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
    from lidar_odometry_demo_tpu_torch.parallel import batched

    d = simulate_sequence(num_scans=6, width=TINY.scan_width, seed=3, speed=2.0,
                          yaw_rate=0.05, ramp_time=0.0)
    scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             TINY.max_raw_points, "cuda") for s in d.scans]
    _counts()
    before = prepare.launches
    if lanes:
        scans_b = LidarScan(*(torch.stack([torch.stack([getattr(s, f)] * lanes) for s in scans])
                              for f in LidarScan._fields))
        batched.make_batched_sequence_runner(TINY)(
            batched.init_batched_state(TINY, lanes, "cuda"), scans_b)
    else:
        odometry.make_sequence_runner(TINY)(odometry.init_state(TINY, "cuda"), scans)
    _counts()
    assert prepare.launches - before == len(scans)


# --------------------------------------------------------------------------
# the map update (kernels/map_update.py)
# --------------------------------------------------------------------------

_MAP_UPDATE_DRIVES: dict = {}


def _map_update_cases(name: str, lanes: int):
    """Cases of tests/_map_update_cases.py: one lane (no axis) or `lanes`
    seeds stacked; "lanes8" 8 lanes with an empty map; "drive" /
    "drive_tiny" the recorded states of a 6-scan drive on the card at full
    width / TINY, each alone, or two stacks of `lanes` of them (cycled)."""
    import _map_update_cases as cases

    if name == "lanes8":
        return [cases.lanes_with_an_empty_map(seed=7)]
    if name.startswith("drive"):
        cfg = TINY if name == "drive_tiny" else OdometryConfig()
        if name not in _MAP_UPDATE_DRIVES:
            _MAP_UPDATE_DRIVES[name] = cases.drive_states(cfg, 6, seed=21, device="cuda")
        states = _MAP_UPDATE_DRIVES[name]
        if not lanes:
            return states
        return (cases.stack_lanes([states[(s + b) % len(states)] for b in range(lanes)])
                for s in (0, 3))
    if not lanes:
        return [cases.make_case(name, seed=11)]
    return [cases.stack_lanes([cases.make_case(name, seed=11 + b) for b in range(lanes)])]


def _assert_update_equal(got, want):
    """Bitwise: the whole table (every lane of every row), keys, count,
    origin, the size and the dropped count."""
    for f in ("tab", "keys", "count", "origin"):
        assert torch.equal(getattr(got.keyframe, f), getattr(want.keyframe, f)), f
    assert torch.equal(got.size, want.size) and torch.equal(got.dropped, want.dropped)


@pytest.mark.parametrize("lanes", [0, 8], ids=["one", "B8"])
@pytest.mark.parametrize("name", ["first_insert", "saturated", "rebase_q1", "rebase_q4",
                                  "tombstone_reuse", "over_cap", "all_empty", "cleanup",
                                  "insert", "spatial", "lanes8", "drive", "drive_tiny"])
def test_map_update_kernel_matches_plain(name, lanes):
    """The map update bitwise its plain version on the card, on every case
    of tests/_map_update_cases.py with no lane axis and at B = 8 (each lane
    its lone call), into a new table and in place (tab_out = m.tab), one
    count a call in `map_update.launches`."""
    _need_card()
    import _map_update_cases as cases

    from lidar_odometry_demo_tpu_torch.kernels.map_update import map_update, map_update_plain

    if name == "lanes8" and not lanes:
        pytest.skip("the empty lane is a lane of 8")
    for c in _map_update_cases(name, lanes):
        m, new, kw = cases.torch_args(c, "cuda")
        want = map_update_plain(m, new, **kw)
        before = map_update.launches
        got = map_update(m, new, **kw)
        assert map_update.launches - before == 1
        _assert_update_equal(got, want)
        tab = m.tab.clone()
        inplace = map_update(m._replace(tab=tab), new, **kw, tab_out=tab)
        assert inplace.keyframe.tab.data_ptr() == tab.data_ptr()
        _assert_update_equal(inplace, want)
        for b in range(lanes):
            one = map_update(*(_lane(x, b) for x in (m, new)),
                             **dict(kw, pose=_lane(kw["pose"], b) if kw["pose"] else None,
                                    center=None if kw["center"] is None else kw["center"][b]))
            _assert_update_equal(_lane(got, b), one)
        assert int(got.size.sum()) > 0


def test_map_update_wrapper_checks_its_inputs():
    _need_card()
    import _map_update_cases as cases

    from lidar_odometry_demo_tpu_torch.kernels.map_update import map_update

    m, new, kw = cases.torch_args(cases.make_case("rebase_q1", seed=11), "cuda")
    with pytest.raises(ValueError, match="int32"):
        map_update(m._replace(keys=m.keys.long()), new, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        map_update(m, new._replace(xyz=new.xyz.T.contiguous().T), **kw)
    with pytest.raises(ValueError, match="shape"):
        map_update(m, new._replace(valid=new.valid[:-1]), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        map_update(m, new, **dict(kw, center=kw["center"].cpu()))
    with pytest.raises(ValueError, match="center and radius"):
        map_update(m, new, **dict(kw, radius=None))
    with pytest.raises(ValueError, match="origin_quantum"):
        map_update(m, new, **dict(kw, origin_quantum=0))


@pytest.mark.parametrize("lanes", [0, 3], ids=["one", "B3"])
def test_map_update_counts_one_call_per_step(lanes):
    """`map_update.launches` counts one call a step on the card, eager scans
    and captured replays alike (pipeline/graphs.py COUNTED)."""
    _need_card()
    from lidar_odometry_demo_tpu_torch.kernels.map_update import map_update
    from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
    from lidar_odometry_demo_tpu_torch.parallel import batched

    d = simulate_sequence(num_scans=6, width=TINY.scan_width, seed=3, speed=2.0,
                          yaw_rate=0.05, ramp_time=0.0)
    scans = [scan_from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                             TINY.max_raw_points, "cuda") for s in d.scans]
    _counts()
    before = map_update.launches
    if lanes:
        scans_b = LidarScan(*(torch.stack([torch.stack([getattr(s, f)] * lanes) for s in scans])
                              for f in LidarScan._fields))
        batched.make_batched_sequence_runner(TINY)(
            batched.init_batched_state(TINY, lanes, "cuda"), scans_b)
    else:
        odometry.make_sequence_runner(TINY)(odometry.init_state(TINY, "cuda"), scans)
    _counts()
    assert map_update.launches - before == len(scans)
