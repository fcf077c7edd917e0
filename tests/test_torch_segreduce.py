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
L = tseg.SHORT


def _kernel_order(rows):
    """One segment's sum in K4's order, in float32: serially from zero for
    at most L rows; else lane r % 32 sums rows r, r + 32, ... from zero and
    the 32 lanes are added by halving."""
    zero = np.zeros(rows.shape[1], np.float32)
    if len(rows) <= L:
        acc = zero
        for x in rows:
            acc = acc + x
        return acc
    lanes = []
    for lane in range(tseg.LANES):
        acc = zero
        for x in rows[lane::tseg.LANES]:
            acc = acc + x
        lanes.append(acc)
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + half] for i in range(half)]
    return lanes[0]


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


@pytest.mark.parametrize("length", [1, 2, L - 1, L, L + 1, 2 * L + 1, 100, 1000])
def test_plain_order_is_the_kernels(length):
    # segments of `length` rows between neighbours of 1 and L + 1 rows: the
    # sums equal K4's order of additions bit for bit, and agree with JAX
    rng = np.random.default_rng(length)
    sizes = [1, length, L + 1, length, 3]
    gids = np.repeat(np.arange(0, 2 * len(sizes), 2), sizes).astype(np.int32)
    rows = (rng.normal(size=(len(gids), 5)) * 10.0 ** rng.integers(
        -3, 4, size=(len(gids), 1))).astype(np.float32)
    got = tseg.segment_reduce_sorted(torch.from_numpy(gids),
                                     torch.from_numpy(rows), 2 * len(sizes))
    want = np.zeros((2 * len(sizes), 5), np.float32)
    for g in np.unique(gids):
        want[g] = _kernel_order(rows[gids == g])
    assert got.numpy().tobytes() == want.tobytes()
    _, jax_out = _both(gids, list(rows.T), 2 * len(sizes))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length", [L, L + 1])
@pytest.mark.parametrize("shift", [1, 31, 32, 255])
def test_sums_at_the_short_limit_do_not_depend_on_where_they_start(length,
                                                                    shift):
    rng = np.random.default_rng(length * 1000 + shift)
    rows = rng.normal(size=(length, 4)).astype(np.float32)
    base = tseg.segment_reduce_sorted(
        torch.full((length,), 3, dtype=torch.int32), torch.from_numpy(rows), 5)
    ids = np.concatenate([np.full(shift, 1), np.full(length, 3)]).astype(np.int32)
    pad = np.concatenate([rng.normal(size=(shift, 4)).astype(np.float32), rows])
    moved = tseg.segment_reduce_sorted(torch.from_numpy(ids),
                                       torch.from_numpy(pad), 5)
    assert torch.equal(moved[3], base[3])
    assert moved[3].numpy().tobytes() == _kernel_order(rows).tobytes()


def test_subnormal_sums_are_kept():
    # the kernel's adds keep subnormals; so does the plain version, which
    # adds without float atomics (those flush them to zero on the card)
    ids = np.repeat(np.arange(4), [1, 3, L + 1, 4]).astype(np.int32)
    rows = np.full((len(ids), 2), 1e-40, np.float32)
    got = tseg.segment_reduce_sorted(torch.from_numpy(ids),
                                     torch.from_numpy(rows), 4)
    want = np.stack([_kernel_order(rows[ids == g]) for g in range(4)])
    assert got.numpy().tobytes() == want.tobytes()
    assert (np.abs(got.numpy()) > 0).all()
