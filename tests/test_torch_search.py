"""Port parity: kernel K3's plain versions (the sorted-key lookup) against
`jnp.searchsorted` (the TPU script's own yardstick,
scripts/pallas_search_exp.py:62) and `torch.searchsorted` (CPU): the bare
search, and map_update's group lookup against the JAX `_update_impl`'s.

Tolerance: none; every index and flag is equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_odometry_demo_tpu_torch.kernels.search import (
    group_lookup, group_lookup_plain, neighborhood_lookup, search_sorted, search_sorted_plain,
    search_steps)
from lidar_odometry_demo_tpu_torch.ops.voxel_map import EMPTY_KEY

C_MAP = 131072  # the full map's capacity, 2^17


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _assert_all_agree(keys, queries):
    got = search_sorted(_t(keys), _t(queries))
    assert got.dtype == torch.int32 and got.shape == (len(queries),)
    want_torch = torch.searchsorted(_t(keys), _t(queries), side="left", out_int32=True)
    want_jax = np.asarray(jnp.searchsorted(jnp.asarray(keys), jnp.asarray(queries)))
    np.testing.assert_array_equal(got.numpy(), want_torch.numpy())
    np.testing.assert_array_equal(got.numpy(), want_jax)
    return got.numpy()


def _script_loop(keys, q, steps):
    """The TPU script's kernel body, scripts/pallas_search_exp.py:26-34, in
    numpy: `steps` unguarded lo / hi / mid updates."""
    C = keys.shape[0]
    lo = np.zeros(q.shape, np.int64)
    hi = np.full(q.shape, C, np.int64)
    for _ in range(steps):
        mid = (lo + hi) // 2
        less = keys[np.minimum(mid, C - 1)] < q
        lo = np.where(less, mid + 1, lo)
        hi = np.where(less, hi, mid)
    return lo


def test_script_fixture_matches_searchsorted():
    """The TPU script's own fixture: 131,072 sorted keys and 8192 x 27
    queries in [0, 2^31), rng seed 0."""
    rng = np.random.default_rng(0)
    keys = np.sort(rng.integers(0, 2**31, C_MAP)).astype(np.int32)
    q = rng.integers(0, 2**31, 8192 * 27).astype(np.int32)
    _assert_all_agree(keys, q)


def _map_like_keys(rng, C, n_live):
    """Sorted live keys with an EMPTY_KEY tail, as the voxel map holds them."""
    live = np.sort(rng.choice(2**30, n_live, replace=False)).astype(np.int32)
    return np.concatenate([live, np.full(C - n_live, EMPTY_KEY, np.int32)])


def test_edges_on_a_map_like_table(rng):
    keys = _map_like_keys(rng, C_MAP, 88923)
    k0, k1 = int(keys[0]), int(keys[1])
    assert k1 - k0 > 1
    q = np.array([
        k0 - 1, 0,               # below keys[0]
        k0,                      # equal to keys[0]
        k0 + 1, k1 - 1, k1,      # keys[0] < q <= keys[1]
        int(keys[500]), int(keys[88922]),   # equal to a key, the last live key
        int(keys[88922]) + 1,    # between the last live key and the EMPTY run
        EMPTY_KEY,               # equal to the EMPTY run: its lower bound
    ], np.int32)
    got = _assert_all_agree(keys, q)
    np.testing.assert_array_equal(got, [0, 0, 0, 1, 1, 1, 500, 88922, 88923, 88923])


def test_edges_without_a_tail_and_with_runs(rng):
    keys = np.sort(rng.integers(0, 1000, C_MAP)).astype(np.int32)  # long runs
    q = np.concatenate([np.arange(-3, 1004), [keys[0], keys[-1], keys[-1] + 1,
                                              2**31 - 1]]).astype(np.int32)
    got = _assert_all_agree(keys, q)
    assert got[-1] == C_MAP and got[-2] == C_MAP  # above every key: C, never C + 1


@pytest.mark.parametrize("C", [0, 1, 2, 3, 4, 5, 7, 8, 9, 255, 256, 257, 4096])
def test_every_table_size(rng, C):
    keys = np.sort(rng.integers(0, 50, C)).astype(np.int32)
    q = np.arange(-2, 53, dtype=np.int32)
    _assert_all_agree(keys, q)


def test_no_queries():
    keys = np.arange(16, dtype=np.int32)
    got = search_sorted(_t(keys), _t(np.zeros(0, np.int32)))
    assert got.shape == (0,) and got.dtype == torch.int32


def test_the_script_step_count_is_one_short(rng):
    """scripts/pallas_search_exp.py:67 runs 17 steps for C = 2^17: a query
    with keys[0] < q <= keys[1] then stops at 0; 18 unguarded steps send a
    query above every key to C + 1. The port runs 18 guarded steps."""
    assert search_steps(C_MAP) == 18
    keys = np.sort(rng.choice(2**30, C_MAP, replace=False)).astype(np.int32)
    q = np.array([keys[0] + 1, keys[-1] + 1], np.int32)
    assert _script_loop(keys, q, 17)[0] == 0
    assert _script_loop(keys, q, 18)[1] == C_MAP + 1
    np.testing.assert_array_equal(search_sorted_plain(_t(keys), _t(q)).numpy(), [1, C_MAP])


def test_search_wrapper_refuses_non_cuda_devices():
    """Off the CPU the wrapper launches the CUDA kernel or raises."""
    keys = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        search_sorted(keys, torch.zeros(4, dtype=torch.int32, device="meta"))


def _group_case(rng, C, n_live):
    """map_update's group lookup inputs: a table with an EMPTY_KEY tail and
    sorted incoming keys holding groups present in it, groups absent from
    it, the last live key, keys above it and an EMPTY_KEY tail."""
    keys = _map_like_keys(rng, C, n_live)
    live = keys[:n_live]
    present = live[rng.integers(0, n_live, 300)]
    absent = np.setdiff1d(rng.integers(0, 2**30, 300).astype(np.int32), live)
    q = np.concatenate([present, present[:50], absent, [live[-1], live[-1], live[0]],
                        [live[-1] + 1], np.full(40, EMPTY_KEY, np.int32)])
    return keys, np.sort(q).astype(np.int32)


@pytest.mark.parametrize("C,n_live", [(4096, 2900), (C_MAP, 88923), (512, 512)])
def test_group_lookup_plain_matches_jax(rng, C, n_live):
    """K3's group lookup against jnp.searchsorted and the found test of the
    JAX _update_impl (lidar_odometry_demo_tpu/ops/voxel_map.py:762-764)."""
    keys, q = _group_case(rng, C, n_live)
    pos = jnp.searchsorted(jnp.asarray(keys), jnp.asarray(q)).astype(jnp.int32)
    jpos_c = jnp.minimum(pos, C - 1)
    jfound = (jnp.asarray(q) != EMPTY_KEY) & (jnp.asarray(keys)[jpos_c] == jnp.asarray(q))
    for fn in (group_lookup_plain, group_lookup):
        pos_c, found = fn(_t(keys), _t(q))
        assert pos_c.dtype == torch.int32 and found.dtype == torch.bool
        np.testing.assert_array_equal(pos_c.numpy(), np.asarray(jpos_c))
        np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    found = found.numpy()
    assert found.sum() >= 350 and not found[q == EMPTY_KEY].any()
    last = q == keys[n_live - 1]
    assert found[last].all() and (pos_c.numpy()[last] == n_live - 1).all()
    assert not found[np.isin(q, keys, invert=True)].any()


def test_group_lookup_without_queries():
    keys = np.arange(16, dtype=np.int32)
    pos_c, found = group_lookup(_t(keys), _t(np.zeros(0, np.int32)))
    assert pos_c.shape == found.shape == (0,)
    assert pos_c.dtype == torch.int32 and found.dtype == torch.bool


def test_lookup_wrappers_refuse_non_cuda_devices():
    """Off the CPU the neighbourhood and group lookups launch the CUDA
    kernel or raise; they never run the plain version on another device."""
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        group_lookup(torch.zeros(8, **i32), torch.zeros(4, **i32))
    with pytest.raises(ValueError, match="CUDA"):
        neighborhood_lookup(torch.zeros((64, 128), **i32), torch.zeros(64, **i32),
                            torch.zeros(3, **i32), torch.zeros((8, 3), **meta),
                            torch.zeros(8, dtype=torch.bool, **meta), torch.zeros(3, **meta),
                            torch.zeros((3, 3), **meta), voxel_size=0.2, row_width=64)
