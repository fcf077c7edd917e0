"""The large-scene inputs, drawn from the seed: a synthetic site (120 m
across at the configuration's extent) that stands in for a drone capture
(Mill-19's Rubble), and drone views over it.

The site has the room's distributions (``scene.room_fields``) laid out over
open ground: a quarter of the Gaussians is the ground, a terrain of gentle
undulations (semantic id 0), the rest rubble piles of 0.3-2 m around the
layout's pile centres (ids 1 to ``num_objects``); uniform rotations,
opacities in [0.3, 0.95], colours in [0.05, 0.95] as the SH DC term and
0.02 x normal higher bands, scales as the room's. It is drawn on the card
by one ``torch.Generator``, a field at a time and in place, so that 40M
Gaussians at SH 3 take their 9.5 GB and little more.

The views are a drone's: ``count`` poses at 25-35 m over the site, each
looking down 50-65 degrees across it, so that every view sees a partial,
overlapping area and every row of its frame sees ground. The
configuration's ``layout_seed`` fixes the piles and the views; the run's
seed only orders the views. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .scene import SH_C0

GROUND_SHARE = 0.25


def pile_centres(extent: float, num_objects: int, layout_seed: int):
    """(num_objects, 3) pile centres and (num_objects,) radii, fixed by the
    layout seed."""
    rng = np.random.default_rng(layout_seed)
    c = rng.uniform(-extent * 0.9, extent * 0.9, (num_objects, 3))
    r = rng.uniform(0.3, 2.0, num_objects)
    c[:, 2] = 0.5 * r
    return c.astype(np.float32), r.astype(np.float32)


def terrain(x: torch.Tensor, y: torch.Tensor, extent: float) -> torch.Tensor:
    """The ground's height (m) at (x, y): undulations of up to 1.5 m."""
    k = 2 * math.pi / extent
    return (0.8 * torch.sin(0.7 * k * x) * torch.cos(0.5 * k * y)
            + 0.4 * torch.sin(2.3 * k * x + 1.0) * torch.sin(1.9 * k * y))


def site_fields(n: int, seed: int, extent: float, sh_degree: int,
                num_objects: int, layout_seed: int, device) -> dict:
    """The six scene fields of a synthetic site of ``n`` Gaussians on
    ``device`` (module docstring), over [-extent, extent]^2 m."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(device=device, dtype=torch.float32)

    def uniform_(t, lo, hi):
        return t.uniform_(lo, hi, generator=gen)

    n_ground = int(n * GROUND_SHARE)
    n_obj = n - n_ground
    means = torch.empty((n, 3), **f32)
    g = means[:n_ground]
    uniform_(g[:, :2], -extent, extent)
    g[:, 2] = terrain(g[:, 0], g[:, 1], extent) + 0.02 * torch.randn(
        (n_ground,), generator=gen, **f32).abs()
    centres, radii = pile_centres(extent, num_objects, layout_seed)
    obj_of = torch.randint(0, num_objects, (n_obj,), generator=gen,
                           device=device)
    c = torch.as_tensor(centres, **f32)[obj_of]
    r = torch.as_tensor(radii, **f32)[obj_of]
    o = means[n_ground:]
    o.normal_(generator=gen)
    o.mul_(0.5 * r[:, None]).add_(c)
    o[:, 2] = o[:, 2].abs() + terrain(c[:, 0], c[:, 1], extent)
    del c, r

    log_scales = torch.empty((n, 3), **f32)
    uniform_(log_scales[:n_ground], 0.05, 0.25)
    uniform_(log_scales[n_ground:], 0.02, 0.15)
    log_scales.log_()

    u = torch.rand((n, 3), generator=gen, **f32)
    quats = torch.stack([
        torch.sqrt(1 - u[:, 0]) * torch.cos(2 * math.pi * u[:, 1]),
        torch.sqrt(1 - u[:, 0]) * torch.sin(2 * math.pi * u[:, 1]),
        torch.sqrt(u[:, 0]) * torch.sin(2 * math.pi * u[:, 2]),
        torch.sqrt(u[:, 0]) * torch.cos(2 * math.pi * u[:, 2]),
    ], 1)
    del u
    opacity = uniform_(torch.empty((n,), **f32), 0.3, 0.95)
    k = (sh_degree + 1) ** 2
    sh = torch.empty((n, k, 3), **f32)
    uniform_(sh[:, 0], 0.05, 0.95)
    sh[:, 0].sub_(0.5).div_(SH_C0)
    if k > 1:
        sh[:, 1:].normal_(generator=gen).mul_(0.02)
    return {
        "means": means,
        "log_scales": log_scales,
        "quats": quats,
        "opacity_logits": torch.log(opacity / (1.0 - opacity)),
        "sh": sh,
        "semantic_ids": torch.cat([
            torch.zeros((n_ground,), dtype=torch.int32, device=device),
            (obj_of + 1).to(torch.int32)]),
    }


def jittered(fields: dict, seed: int, colour_jitter: float,
             opacity_jitter: float) -> dict:
    """The target site: ``fields`` with normal jitter on the colours' DC
    term and the opacity logits (the other fields shared)."""
    dev = fields["means"].device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    sh = fields["sh"].clone()
    sh[:, 0] += colour_jitter * torch.randn(sh[:, 0].shape, generator=gen,
                                            device=dev)
    op = fields["opacity_logits"] + opacity_jitter * torch.randn(
        fields["opacity_logits"].shape, generator=gen, device=dev)
    return dict(fields, sh=sh, opacity_logits=op)


def drone_views(count: int, extent: float, layout_seed: int) -> list:
    """``count`` (position, forward) drone views: at 25-35 m, around the
    site at 0.3-0.8 of its half-extent from the centre, each looking down
    50-65 degrees towards the centre (within 0.5 rad), fixed by the layout
    seed."""
    rng = np.random.default_rng(layout_seed + 1)
    views = []
    for i in range(count):
        ang = 2 * math.pi * (i + rng.uniform(-0.3, 0.3)) / count
        rad = rng.uniform(0.3, 0.8) * extent
        pos = np.array([rad * math.cos(ang), rad * math.sin(ang),
                        rng.uniform(25.0, 35.0)])
        yaw = ang + math.pi + rng.uniform(-0.5, 0.5)
        pitch = math.radians(rng.uniform(50.0, 65.0))
        look = np.array([math.cos(yaw) * math.cos(pitch),
                         math.sin(yaw) * math.cos(pitch), -math.sin(pitch)])
        views.append((pos.astype(np.float32), look))
    return views
