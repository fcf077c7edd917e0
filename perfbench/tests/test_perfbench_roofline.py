"""The roofline's counts on cases counted by hand."""

import pytest
import torch

from perfbench.reference import render as rr
from perfbench.roofline import counts, peaks


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == (1.0, "bytes")
    assert peaks.least_seconds(0, 67e12) == (1.0, "operations")


def test_k2_k3_k6_by_hand():
    # one tile, 2 pairs, 3 hits, 2 Gaussians
    b2 = 2 * 11 * 4 + 2 * 4 + 8 + 8 * 1024 * 4 + 4
    o2 = 2 * 1024 * 18 + 3 * 14
    assert counts.k2_seconds(2, 3, 2, 1) == pytest.approx(
        max(b2 / 3.35e12, o2 / 67e12))
    b3 = 2 * 12 * 4 + 2 * 4 + 2 * 6 * 1024 * 4 + 2 * 16 * 4
    o3 = 2 * 1024 * 18 + 3 * 32
    assert counts.k3_seconds(2, 3, 2, 1) == pytest.approx(
        max(b3 / 3.35e12, o3 / 67e12))
    b6 = 10 * 44 + 2 * 40 + 4
    o6 = 10 * 5 + 4 * 59 + 2 * 4 * 60
    assert counts.k6_seconds(10, 4, 2) == pytest.approx(
        max(b6 / 3.35e12, o6 / 33.5e12))


def _one_gaussian(x, y, opacity, scale=0.05):
    """A round Gaussian 2 m in front of a 64 x 32 camera (fx = 100) whose
    centre lands on pixel (x, y)."""
    fx = 100.0
    z = 2.0
    pos = torch.tensor([[(x - 32.0) * z / fx, z, -(y - 16.0) * z / fx]])
    f = {"means": pos, "log_scales": torch.log(torch.full((1, 3), scale)),
         "quats": torch.tensor([[1.0, 0, 0, 0]]),
         "opacity_logits": torch.logit(torch.tensor([opacity])),
         "sh": torch.zeros((1, 1, 3)),
         "semantic_ids": torch.tensor([3], dtype=torch.int32)}
    rot = torch.tensor([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])  # looking +y
    cam = rr.Cam(torch.zeros(3), rot, fx, fx, 32.0, 16.0, 64, 32)
    return f, cam


def test_counts_of_one_gaussian_by_hand():
    f, cam = _one_gaussian(16.0, 16.0, 0.9)
    out = rr.render(f, cam, count=True)
    c = out["counts"]
    # a 2.5 px Gaussian in the middle of the left tile: one pair needed,
    # its hits are the pixels it lights, the image's two tiles counted
    assert (c.pairs, c.gaussians, c.tiles) == (1, 1, 2)
    assert c.hits == int((out["alpha"] > 0).sum())
    assert out["semantic"][16, 16] == 3 and out["semantic"][0, 63] == -1


def test_a_saturated_tile_needs_nothing_more():
    # four near-opaque wide Gaussians in front (T under 1e-4 behind them
    # across the left tile) hide a small one 1 m behind them: not needed
    parts = []
    for k in range(4):
        f, cam = _one_gaussian(16.0, 16.0, 0.999, scale=1.5)
        f["means"][:, 1] += 0.1 * k
        parts.append(f)
    small, _ = _one_gaussian(16.0, 16.0, 0.9)
    small["means"][:, 1] += 1.0
    f = {k: torch.cat([p[k] for p in parts + [small]]) for k in small}
    c = rr.render(f, cam, count=True)["counts"]
    assert (c.pairs, c.gaussians, c.tiles) == (8, 4, 2)
    assert 3 * 64 * 32 <= c.hits <= 4 * 64 * 32
