"""Parity of the PyTorch port's binning (and K1's plain version) with the JAX
package. The JAX side runs its Pallas emission kernel in interpret mode."""

import jax
import numpy as np
import pytest
import torch

from sage3d_tpu.ops import binning as jbin
from sage3d_tpu.ops.projection import project_gaussians
from sage3d_tpu.renderer.camera import make_camera
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.ops import binning as tbin
from sage3d_tpu_torch.ops.projection import ProjectedGaussians


def _port_proj(proj):
    """The JAX projection's arrays as the port's ProjectedGaussians, so both
    binnings see the same inputs."""
    return ProjectedGaussians(*(torch.from_numpy(np.array(x)) for x in proj))


def _case(n, seed, pos, fwd, width, height):
    scene = synthetic_room(num_gaussians=n, seed=seed)
    cam = make_camera(position=pos, forward=fwd, width=width, height=height)
    return project_gaussians(scene, cam)


CASES = {
    "64x48": (400, 5, [0.0, -4.0, 1.2], [0.0, 1.0, -0.1], 64, 48),
    "320x256-fused": (500, 4, [0.0, -4.0, 1.2], [0.0, 1.0, -0.1], 320, 256),
    "3840x2160-two-key": (500, 4, [0.0, -4.0, 1.2], [0.0, 1.0, -0.1], 3840, 2160),
}


def _assert_bins_equal(tb, jb):
    jb = jax.device_get(jb)
    assert int(tb.n_pairs) == int(jb.n_pairs)
    assert int(tb.overflow) == int(jb.overflow)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    np.testing.assert_array_equal(tb.tile_start.numpy(), np.asarray(jb.tile_start))
    np.testing.assert_array_equal(tb.tile_count.numpy(), np.asarray(jb.tile_count))
    # the port sorts only the kept pairs; the JAX list has a padding tail
    assert tb.pair_gauss.shape == (int(jb.n_pairs),)
    assert tb.pair_gauss.shape[0] <= jb.pair_gauss.shape[0]
    # the key sort is unstable in both packages, so only each tile's valid
    # range is compared (valid keys are unique), never the padding tail
    tg, jg = tb.pair_gauss.numpy(), np.asarray(jb.pair_gauss)
    for s, c in zip(np.asarray(jb.tile_start), np.asarray(jb.tile_count)):
        np.testing.assert_array_equal(tg[s:s + c], jg[s:s + c])


@pytest.mark.parametrize("name", list(CASES))
def test_bin_gaussians_matches_with_suggested_budgets(name):
    n, seed, pos, fwd, width, height = CASES[name]
    proj = _case(n, seed, pos, fwd, width, height)
    tproj = _port_proj(proj)
    budgets = jbin.suggest_budgets(proj, width, height)
    assert tbin.suggest_budgets(tproj, width, height) == budgets
    kw = {k: budgets[k] for k in tbin.EMIT_BUDGET_KEYS}
    tb = tbin.bin_gaussians(tproj, width, height, **kw)
    _assert_bins_equal(tb, jbin.bin_gaussians(proj, width, height, **kw))
    assert int(tb.overflow) == 0 and int(tb.n_pairs) > 0


@pytest.mark.parametrize("kw", [
    dict(k_small=2, m_big=4, k_big=4),                    # clipped + dropped
    dict(k_small=4, m_big=16, k_big=64, m_mid=64, k_mid=16),   # three tiers
])
def test_bin_gaussians_matches_with_tiny_budgets(kw):
    # test_pallas_stress.py's spill case: 8x8 tiles with real spanners
    proj = _case(300, 11, [0.0, -2.0, 1.0], [0.0, 1.0, 0.0], 256, 256)
    tb = tbin.bin_gaussians(_port_proj(proj), 256, 256, **kw)
    _assert_bins_equal(tb, jbin.bin_gaussians(proj, 256, 256, **kw))
    if kw["k_small"] == 2:
        assert int(tb.overflow) > 0


@pytest.mark.parametrize("mode", ["fused", "two-key"])
@pytest.mark.parametrize("kw", [
    dict(k_small=2, m_big=4, k_big=4),                    # two tiers
    dict(k_small=4, m_big=16, k_big=64, m_mid=64, k_mid=16),   # three tiers
], ids=["2-tier", "3-tier"])
def test_emit_tile_pairs_plain_matches_pallas_kept_slots(kw, mode):
    """K1's plain version walks the live slots of every tier at once: its
    (key, Gaussian) pairs are, as a multiset, the kept slots of the JAX
    kernel run on each tier's padded table."""
    width = height = 256
    proj = _case(300, 11, [0.0, -2.0, 1.0], [0.0, 1.0, 0.0], width, height)
    plan = tbin.emission_plan(_port_proj(proj), width, height, **kw)
    assert len(plan.tiers) == (3 if "m_mid" in kw else 2)
    n_tiles = plan.tiles_x * plan.tiles_y
    mult = plan.mult if mode == "fused" else 0
    assert plan.mult > 0
    want_keys, want_gauss = [], []
    for tier in plan.tiers:
        attrs, rank, gauss = (x.numpy() for x in tbin.padded_tier(plan, tier))
        out, n_pad = jbin._emit_fused(attrs, rank, plan.tiles_x, n_tiles, 32,
                                      32, tier.k_budget, mult)
        out = np.asarray(out)
        assert n_pad == attrs.shape[1]
        _, col = np.nonzero(out != (tbin.INVALID_KEY if mult else n_tiles))
        key = out[out != (tbin.INVALID_KEY if mult else n_tiles)]
        if not mult:
            key = (key.astype(np.int64) << 31) | rank[col].astype(np.int64)
        want_keys.append(key)
        want_gauss.append(gauss[col])
    want_keys = np.concatenate(want_keys)
    want_gauss = np.concatenate(want_gauss)
    keys, gauss, n_kept = tbin.emit_tile_pairs_plain(
        plan.table, plan.offsets, plan.n_live, plan.tiles_x, mult)
    assert keys.dtype == (torch.int32 if mult else torch.int64)
    assert int(n_kept) == keys.shape[0] == gauss.shape[0] == len(want_keys) > 0
    assert plan.n_live >= int(n_kept)
    got = np.argsort(keys.numpy(), kind="stable")
    want = np.argsort(want_keys, kind="stable")
    np.testing.assert_array_equal(keys.numpy()[got], want_keys[want])
    np.testing.assert_array_equal(gauss.numpy()[got], want_gauss[want])
    assert len(np.unique(want_keys)) == len(want_keys)   # keys are unique


def test_bin_gaussians_with_nothing_in_view():
    # the camera stands outside the room and looks away: no pair is kept
    proj = _case(400, 5, [0.0, -8.0, 1.2], [0.0, -1.0, 0.0], 64, 48)
    tb = tbin.bin_gaussians(_port_proj(proj), 64, 48)
    _assert_bins_equal(tb, jbin.bin_gaussians(proj, 64, 48))
    assert tb.pair_gauss.shape == (0,) and int(tb.tile_count.sum()) == 0


def test_pair_count_stats_match():
    n, seed, pos, fwd, width, height = CASES["320x256-fused"]
    proj = _case(n, seed, pos, fwd, width, height)
    got = tbin.pair_count_stats(_port_proj(proj), width, height)
    want = jax.device_get(jbin.pair_count_stats(proj, width, height))
    assert int(got["n_visible"]) == int(want["n_visible"])
    assert int(got["max_count"]) == int(want["max_count"])
    np.testing.assert_array_equal(got["exceed"].numpy(), want["exceed"])
    assert int(got["sum_count_parts"].sum()) == int(want["sum_count_parts"].sum())


def test_pick_budgets_copy_matches():
    stats = {"max_count": 700, "sum_count_parts": [123456, 654321],
             "exceed": [90000, 40000, 12000, 3000, 800, 90]}
    for n in (1000, 200_000, 1_000_000):
        assert tbin._pick_budgets(stats, n) == jbin._pick_budgets(stats, n)
    for x in (0, 1, 2, 3, 1000, 1024, 1025):
        assert tbin._pow2_at_least(x) == jbin._pow2_at_least(x)


def _emit_inputs(rng, n, tiles_x, tiles_y):
    """A random (16, n) attribute table in the emission layout."""
    x0 = rng.integers(0, tiles_x, n)
    y0 = rng.integers(0, tiles_y, n)
    nx = rng.integers(1, 6, n)
    count = nx * rng.integers(1, 6, n)
    count[rng.uniform(size=n) < 0.1] = 0
    a = rng.uniform(1e-3, 0.05, n)
    c = rng.uniform(1e-3, 0.05, n)
    b = rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
    attrs = np.zeros((16, n), np.float32)
    attrs[0], attrs[1], attrs[2], attrs[3] = x0, y0, nx, count
    attrs[4] = (x0 + rng.uniform(0, 2, n)) * 32
    attrs[5] = (y0 + rng.uniform(0, 2, n)) * 32
    attrs[6] = 2 * np.log(rng.uniform(0.01, 0.99, n) * 255)
    attrs[8], attrs[9], attrs[10] = a, b, c
    rank = rng.permutation(n).astype(np.int32)
    attrs[7] = rank.view(np.float32)
    return attrs, rank


@pytest.mark.parametrize("fused", [True, False])
def test_emit_plain_matches_pallas_kernel(fused, rng):
    """K1's plain version against the JAX emission kernel: keys bit-equal."""
    tiles_x, tiles_y = (20, 12) if fused else (120, 68)
    n_tiles = tiles_x * tiles_y
    n, k_budget = 1024, 24
    attrs, rank = _emit_inputs(rng, n, tiles_x, tiles_y)
    mult = 1 << 20 if fused else 0
    want, n_pad = jbin._emit_fused(attrs, rank, tiles_x, n_tiles, 32, 32,
                                   k_budget, mult)
    assert n_pad == n
    got = tbin.emit_tile_keys_plain(torch.from_numpy(attrs),
                                    torch.from_numpy(rank), k_budget, tiles_x,
                                    n_tiles, mult)
    assert got.dtype == torch.int32 and got.shape == (k_budget, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    invalid = tbin.INVALID_KEY if fused else n_tiles
    assert 0 < (got.numpy() != invalid).sum() < k_budget * n


def test_emit_wrapper_checks_inputs():
    table = torch.zeros((8, tbin.LIVE_COLS))
    offsets = torch.zeros((9,), dtype=torch.int64)
    with pytest.raises(ValueError):
        tbin.emit_tile_pairs(table[:, :11], offsets, 0, 2, 0)
    with pytest.raises(TypeError):
        tbin.emit_tile_pairs(table.double(), offsets, 0, 2, 0)
    with pytest.raises(TypeError):
        tbin.emit_tile_pairs(table, offsets.int(), 0, 2, 0)
    with pytest.raises(ValueError):
        tbin.emit_tile_pairs(table, offsets[:4], 0, 2, 0)
    with pytest.raises(ValueError):
        tbin.emit_tile_pairs(table, offsets, -1, 2, 0)
    misaligned = torch.zeros(8 * tbin.LIVE_COLS + 1)[1:].view(8, tbin.LIVE_COLS)
    assert misaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tbin.emit_tile_pairs(misaligned, offsets, 0, 2, 0)
    before = tbin.emit_tile_pairs.launches
    for mult, dtype in ((1 << 20, torch.int32), (0, torch.int64)):
        keys, gauss, n_kept = tbin.emit_tile_pairs(table, offsets, 0, 2, mult)
        assert keys.dtype == dtype and gauss.dtype == torch.int32
        assert keys.shape == gauss.shape == (0,) and int(n_kept) == 0
    assert tbin.emit_tile_pairs.launches == before   # the plain version ran
