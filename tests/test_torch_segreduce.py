"""The port's segment sum (K4's plain version on the CPU) against the JAX
package's ``segment_reduce_sorted`` (Pallas in interpret mode), on every case
of ``tests/test_segreduce.py``."""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.ops import segreduce as jseg
from sage3d_tpu_torch.ops import segreduce as tseg

SEG_G, SEG_R = jseg.SEG_G, jseg.SEG_R


def _both(gids, payload, n_out):
    """(port, JAX) outputs on the same sorted ids and payload columns."""
    gids = np.asarray(gids, np.int32)
    payload = [np.asarray(v, np.float32) for v in payload]
    want = jseg.segment_reduce_sorted(jnp.asarray(gids),
                                      tuple(jnp.asarray(v) for v in payload),
                                      n_out)
    got = tseg.segment_reduce_sorted(torch.from_numpy(gids),
                                     [torch.from_numpy(v) for v in payload],
                                     n_out)
    assert got.shape == (n_out, len(payload)) and got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


def _run(gids, payload, n_out):
    got, want = _both(np.sort(np.asarray(gids)), payload, n_out)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("n_out,p", [
    (100, 1000),
    (SEG_G * 3 + 17, 4096),
    (2000, SEG_R * 4),
    (50, 37),
])
def test_matches_jax_segment_reduce(n_out, p):
    rng = np.random.default_rng(n_out + p)
    gids = rng.integers(0, n_out, p)
    _run(gids, [rng.normal(size=p) for _ in range(10)], n_out)


def test_empty_segments_and_all_same():
    rng = np.random.default_rng(0)
    p = 1500
    payload = [rng.normal(size=p).astype(np.float32)]
    out = _run(np.full(p, 777), payload, 2000)
    assert np.count_nonzero(out) == 1
    assert float(np.abs(out).sum()) == pytest.approx(
        float(abs(payload[0].sum())), rel=1e-5)


def test_block_boundary_ids():
    ids = [i for b in range(5) for i in (b * SEG_G - 1, b * SEG_G, b * SEG_G + 1)
           if i >= 0]
    _run(ids, [np.ones(len(ids), np.float32)], 5 * SEG_G)


def test_garbage_ids_with_zero_payload_are_harmless():
    rng = np.random.default_rng(3)
    p = 2048
    gids = np.sort(rng.integers(0, 300, p))
    payload = [rng.normal(size=p).astype(np.float32) for _ in range(3)]
    base = _run(gids, payload, 300)
    extra_ids = np.sort(np.concatenate([gids, rng.integers(0, 300, 512)]))
    want = Counter(gids)
    mask = np.zeros(len(extra_ids), bool)
    for i, g in enumerate(extra_ids):
        if want[g] > 0:
            want[g] -= 1
            mask[i] = True
    payload2 = []
    for v in payload:
        w = np.zeros(len(extra_ids), np.float32)
        w[mask] = v
        payload2.append(w)
    got, jax_got = _both(extra_ids, payload2, 300)
    np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jax_got, base, rtol=1e-5, atol=1e-5)


def test_large_random_many_payloads():
    rng = np.random.default_rng(9)
    p = SEG_R * 23 + 311
    n_out = 3 * SEG_G + 5
    _run(rng.integers(0, n_out, p), [rng.normal(size=p) for _ in range(10)],
         n_out)


def test_out_of_range_ids_add_nothing_and_perm_reads_through():
    rng = np.random.default_rng(5)
    p, n_out = 3000, 200
    gids = np.sort(rng.integers(-20, n_out + 20, p)).astype(np.int32)
    rows = rng.normal(size=(p, 4)).astype(np.float32)
    got = tseg.segment_reduce_sorted(torch.from_numpy(gids),
                                     torch.from_numpy(rows), n_out)
    want = np.zeros((n_out, 4), np.float64)
    ok = (gids >= 0) & (gids < n_out)
    np.add.at(want, gids[ok], rows[ok])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the same rows read through a permutation, from a strided column slice
    perm = rng.permutation(p)
    wide = np.zeros((p, 16), np.float32)
    wide[perm, :4] = rows
    via = tseg.segment_reduce_sorted(torch.from_numpy(gids),
                                     torch.from_numpy(wide)[:, :4], n_out,
                                     perm=torch.from_numpy(perm))
    assert torch.equal(via, got)


def test_sums_do_not_depend_on_where_a_segment_starts():
    # extra zero rows at the end of segment 0 (untouched gradient slots) shift
    # every later segment; the sums stay the same bit for bit
    rng = np.random.default_rng(11)
    gids = np.sort(rng.integers(0, 50, 5000)).astype(np.int32)
    rows = rng.normal(size=(5000, 3)).astype(np.float32)
    base = tseg.segment_reduce_sorted(torch.from_numpy(gids),
                                      torch.from_numpy(rows), 50)
    n0 = int((gids == 0).sum())
    gids2 = np.concatenate([gids[:n0], np.zeros(700, np.int32), gids[n0:]])
    rows2 = np.concatenate([rows[:n0], np.zeros((700, 3), np.float32),
                            rows[n0:]])
    again = tseg.segment_reduce_sorted(torch.from_numpy(gids2),
                                       torch.from_numpy(rows2), 50)
    assert torch.equal(again, base)


def test_wrapper_checks_inputs():
    ids = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        tseg.segment_reduce_sorted(ids.long(), torch.zeros((4, 2)), 3)
    with pytest.raises(ValueError):
        tseg.segment_reduce_sorted(ids, torch.zeros((4, 16)), 3)
    with pytest.raises(ValueError):
        tseg.segment_reduce_sorted(ids, torch.zeros((5, 2)), 3)
    with pytest.raises(ValueError):
        tseg.segment_reduce_sorted(ids, torch.zeros((5, 2)), 3,
                                   perm=torch.zeros((4,), dtype=torch.int32))
    before = tseg.segment_reduce_sorted.launches
    out = tseg.segment_reduce_sorted(ids, torch.ones((4, 2)), 3)
    assert tseg.segment_reduce_sorted.launches == before   # the plain version
    assert out.tolist() == [[4.0, 4.0], [0.0, 0.0], [0.0, 0.0]]
