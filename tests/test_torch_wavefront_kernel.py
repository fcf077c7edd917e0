"""K5's plain twin (``relax_tiles_plain`` in
``sage3d_tpu_torch/data/astar.py``, the CPU path of ``relax_tiles``)
against the JAX package's ``wavefront_distances`` on the CPU: the fields
bitwise equal and the
relaxation counts equal, on grids whose sides are not multiples of the
kernel's 32-cell tile, batches of 1 to 17 sources, sources in walls and on
the border, a blocked grid and a path that needs many launches.

JAX's relaxation count is read from the final carry of its ``while_loop``:
the JAX function runs unjitted with ``jax.lax.while_loop`` wrapped to record
the carry it returns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.data import astar as jastar
from sage3d_tpu_torch.data import astar as tastar


def _jax_field(free, sources, monkeypatch):
    """JAX's fields and the relaxations its loop ran."""
    carries = []
    loop = jax.lax.while_loop

    def recording(cond, body, init):
        out = loop(cond, body, init)
        carries.append(out)
        return out

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "while_loop", recording)
        field = jastar.wavefront_distances.__wrapped__(
            jnp.asarray(free), jnp.asarray(np.asarray(sources, np.int32)))
    (carry,) = carries
    return np.asarray(field), int(carry[2])


def _same(free, sources, monkeypatch):
    want, n_want = _jax_field(free, sources, monkeypatch)
    got, n_got = tastar.wavefront_distances(free, np.asarray(sources),
                                            device="cpu",
                                            return_relaxations=True)
    got = got.numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
        np.abs(got - want).max()
    assert n_got == n_want and n_got % tastar.CHECK_EVERY == 0
    return got, n_got


def _random_case(h, w, b, seed):
    rng = np.random.default_rng(seed)
    free = rng.uniform(size=(h, w)) > 0.2
    ys, xs = np.nonzero(free)
    pick = rng.integers(0, len(ys), b)
    return free, np.stack([ys[pick], xs[pick]], 1)


@pytest.mark.parametrize("h,w,b", [(37, 53, 1), (37, 53, 3), (37, 53, 17),
                                   (1, 64, 3), (64, 1, 3), (70, 33, 2)])
def test_plain_twin_is_bitwise_jax(h, w, b, monkeypatch):
    """Sides that are not multiples of 32, a single row and column, B = 1,
    3, 17; the 70x33 grid spans three tiles down and two across."""
    free, src = _random_case(h, w, b, seed=h * 100 + w + b)
    _same(free, src, monkeypatch)


def test_sources_in_a_wall_and_on_the_border(monkeypatch):
    free, src = _random_case(45, 40, 2, seed=5)
    free[7, 9] = False
    free[0, :] = True
    field, _ = _same(free, [(7, 9), (0, 39), (44, 0), tuple(src[0])],
                     monkeypatch)
    assert (field[0] == tastar.INF).all()        # the wall source: unreachable
    assert field[1][0, 39] == 0.0 and field[1][0, 38] == 1.0


def test_fully_blocked_grid(monkeypatch):
    """Every cell a wall: all INF. The first check still sees the walls drop
    from INF + INF to INF, so two launches run, in JAX as here."""
    field, n = _same(np.zeros((33, 34), bool), [(0, 0), (16, 17)], monkeypatch)
    assert (field == tastar.INF).all() and n == 2 * tastar.CHECK_EVERY


def test_serpentine_path_needs_many_launches(monkeypatch):
    """A corridor winding across the grid: the far end is hundreds of cells
    from the source, many tiles' halos away."""
    h, w = 48, 40
    free = np.ones((h, w), bool)
    for i, r in enumerate(range(2, h - 2, 4)):
        if i % 2 == 0:
            free[r, : w - 1] = False
        else:
            free[r, 1:] = False
    field, n = _same(free, [(0, 0), (h - 1, w - 1)], monkeypatch)
    assert field[0][h - 1, w - 1] > 8 * w
    assert n > 20 * tastar.CHECK_EVERY


@pytest.mark.parametrize("chain", [1, 3])
def test_chain_length_changes_nothing(chain, monkeypatch):
    """Queueing 1 or 3 launches between flag reads, instead of CHAIN: the
    same fields and count (the launches after convergence do nothing)."""
    free, src = _random_case(50, 45, 4, seed=9)
    want, n_want = tastar.wavefront_distances(free, src, device="cpu",
                                              return_relaxations=True)
    monkeypatch.setattr(tastar, "CHAIN", chain)
    got, n_got = tastar.wavefront_distances(free, src, device="cpu",
                                            return_relaxations=True)
    assert n_got == n_want and torch.equal(got, want)


def _relax_once(dist, free_f):
    """One untiled relaxation of (B, H, W), JAX's arithmetic."""
    b, h, w = dist.shape
    pad = torch.full((b, h + 2, w + 2), tastar.INF)
    pad[:, 1:-1, 1:-1] = dist
    best = dist.clone()
    for dy, dx, cost in tastar._NEIGHBORS:
        best = torch.minimum(best, pad[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
                             + torch.tensor(cost, dtype=torch.float32))
    return torch.minimum(best + free_f, torch.tensor(tastar.INF))


def test_one_launch_is_eight_relaxations_and_the_flag():
    free, src = _random_case(40, 70, 3, seed=2)
    free_t = torch.from_numpy(free)
    free_f = torch.where(free_t, 0.0, tastar.INF).float()
    dist = torch.full((3, 40, 70), tastar.INF)
    dist[torch.arange(3), src[:, 0], src[:, 1]] = 0.0
    dist += free_f
    want = dist
    for _ in range(tastar.CHECK_EVERY):
        want = _relax_once(want, free_f)
    dst = torch.empty_like(dist)
    flags = torch.zeros(2, dtype=torch.int32)
    tastar.relax_tiles(dist, dst, free_t, None, flags[0])
    assert torch.equal(dst, want) and int(flags[0]) == 1
    # a converged field: no flag; after a flag of 0 the launch does nothing
    for _ in range(40):
        tastar.relax_tiles(dst, dist, free_t, None, flags[1])
        dist, dst = dst, dist
    flags.zero_()
    tastar.relax_tiles(dist, dst, free_t, None, flags[0])
    assert int(flags[0]) == 0 and torch.equal(dst, dist)
    untouched = torch.full_like(dist, -1.0)
    tastar.relax_tiles(dist, untouched, free_t, flags[0], flags[1])
    assert int(flags[1]) == 0 and bool((untouched == -1.0).all())


def test_relax_tiles_takes_the_plain_path_only_on_the_cpu():
    free = torch.ones((8, 8), dtype=torch.bool)
    f32 = dict(dtype=torch.float32)
    flag = torch.zeros((), dtype=torch.int32)
    meta = [torch.empty((1, 8, 8), device="meta", **f32),
            torch.empty((1, 8, 8), device="meta", **f32),
            torch.ones((8, 8), dtype=torch.bool, device="meta"), None,
            torch.zeros((), dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        tastar.relax_tiles(*meta)
    src = torch.zeros((1, 8, 8), **f32)
    for bad in ([torch.zeros((8, 8), **f32), src, free, None, flag],
                [src, torch.zeros((1, 8, 9), **f32), free, None, flag],
                [src, src.clone(), free.float(), None, flag],
                [src, src.clone(), free, None, flag.long()],
                [src, src.clone(), meta[2], None, flag]):
        with pytest.raises(ValueError):
            tastar.relax_tiles(*bad)
    before = tastar.relax_tiles.launches
    tastar.relax_tiles(src, src.clone(), free, None, flag)
    assert tastar.relax_tiles.launches == before    # the plain twin ran
