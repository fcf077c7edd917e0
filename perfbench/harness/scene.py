"""The benchmark's inputs, drawn from the seed: the room, its semantic map,
camera poses and episodes.

The room has ``synthetic_room``'s distributions (a floor, four walls and
object blobs with semantic ids), drawn on the card by one
``torch.Generator`` in a few large calls. What sets the amount of work is
fixed by the configuration: its ``scene_seed`` draws the Gaussians, its
``layout_seed`` the objects' centres, the camera poses and the episodes.
The run's seed only sets the order in which the poses and episodes come
and which outputs the check samples, so every seed gives the same work.

Nothing here imports the program: the scene is returned as plain tensors,
which the traffic drivers hand to the program and to the reference alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814
FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh",
          "semantic_ids")


def object_centres(extent: float, num_objects: int, layout_seed: int):
    """(num_objects, 3) blob centres, fixed by the layout seed."""
    rng = np.random.default_rng(layout_seed)
    c = rng.uniform(-extent * 0.7, extent * 0.7, (num_objects, 3))
    c[:, 2] = rng.uniform(0.2, 1.5, num_objects)
    return c.astype(np.float32)


def room_fields(n: int, seed: int, extent: float, sh_degree: int,
                num_objects: int, layout_seed: int, device) -> dict:
    """The six scene fields of a synthetic room of ``n`` Gaussians on
    ``device``: a quarter structure (floor and four walls, semantic id 0),
    the rest in blobs of 0.3 m around the layout's object centres (ids 1 to
    ``num_objects``); uniform rotations, opacities in [0.3, 0.95], colours in
    [0.05, 0.95] as the SH DC term and 0.02 x normal higher bands."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(device=device, dtype=torch.float32)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    n_struct = n // 4
    n_obj = n - n_struct
    sp = uniform((n_struct, 3), -extent, extent)
    which = torch.randint(0, 5, (n_struct,), generator=gen, device=device)
    floor_z = torch.randn((n_struct,), generator=gen, **f32).abs() * 0.02
    wall_z = uniform((n_struct,), 0.0, 3.0)
    sp[:, 0] = torch.where(which == 1, -extent,
                           torch.where(which == 2, extent, sp[:, 0]))
    sp[:, 1] = torch.where(which == 3, -extent,
                           torch.where(which == 4, extent, sp[:, 1]))
    sp[:, 2] = torch.where(which == 0, floor_z, wall_z)
    struct_scales = uniform((n_struct, 3), 0.05, 0.25)

    centres = torch.as_tensor(object_centres(extent, num_objects,
                                             layout_seed), **f32)
    obj_of = torch.randint(0, num_objects, (n_obj,), generator=gen,
                           device=device)
    op_ = centres[obj_of] + 0.3 * torch.randn((n_obj, 3), generator=gen,
                                              **f32)
    obj_scales = uniform((n_obj, 3), 0.02, 0.15)

    u = torch.rand((n, 3), generator=gen, **f32)
    quats = torch.stack([
        torch.sqrt(1 - u[:, 0]) * torch.cos(2 * math.pi * u[:, 1]),
        torch.sqrt(1 - u[:, 0]) * torch.sin(2 * math.pi * u[:, 1]),
        torch.sqrt(u[:, 0]) * torch.sin(2 * math.pi * u[:, 2]),
        torch.sqrt(u[:, 0]) * torch.cos(2 * math.pi * u[:, 2]),
    ], 1)
    opacity = uniform((n,), 0.3, 0.95)
    colours = uniform((n, 3), 0.05, 0.95)
    k = (sh_degree + 1) ** 2
    sh = torch.empty((n, k, 3), **f32)
    sh[:, 0] = (colours - 0.5) / SH_C0
    if k > 1:
        sh[:, 1:] = 0.02 * torch.randn((n, k - 1, 3), generator=gen, **f32)
    return {
        "means": torch.cat([sp, op_]),
        "log_scales": torch.log(torch.cat([struct_scales, obj_scales])),
        "quats": quats,
        "opacity_logits": torch.log(opacity / (1.0 - opacity)),
        "sh": sh,
        "semantic_ids": torch.cat([
            torch.zeros((n_struct,), dtype=torch.int32, device=device),
            (obj_of + 1).to(torch.int32)]),
    }


def semantic_map(extent: float, num_objects: int, layout_seed: int,
                 object_radius: float, scale: float) -> list:
    """The room's 2D semantic map, in the schema of the reference's
    semantic-map builder: the four walls (category ``wall``) as points every
    ``scale`` m along the boundary, and each object's footprint, a disk of
    ``object_radius`` m, as ``unable area``. ``mask_coords_m`` are (y, x)."""
    ticks = np.round(np.arange(-extent, extent + scale / 2, scale), 6)
    walls = ([(float(t), -extent) for t in ticks]
             + [(float(t), extent) for t in ticks]
             + [(-extent, float(t)) for t in ticks]
             + [(extent, float(t)) for t in ticks])
    out = [{"category_label": "wall", "mask_coords_m": walls}]
    r = object_radius
    offs = np.round(np.arange(-r, r + scale / 2, scale), 6)
    for c in object_centres(extent, num_objects, layout_seed):
        pts = [(float(c[1] + dy), float(c[0] + dx)) for dy in offs
               for dx in offs if dx * dx + dy * dy <= r * r]
        out.append({"category_label": "unable area", "mask_coords_m": pts})
    return out


def look_rotation(forward) -> np.ndarray:
    """cam_to_world (3, 3) float32 with the camera's +z along ``forward`` in a
    z-up world: columns right, down (image y), forward."""
    f = np.asarray(forward, np.float64)
    f = f / np.linalg.norm(f)
    right = np.cross(f, [0.0, 0.0, 1.0])
    right = right / np.linalg.norm(right)
    down = np.cross(f, right)
    return np.stack([right, down / np.linalg.norm(down), f], 1).astype(
        np.float32)


def orbit_views(count: int, extent: float, layout_seed: int) -> list:
    """``count`` (position, forward) views of the room: half from outside
    its walls looking in, half from inside at eye height towards a wall or
    an object, fixed by the layout seed."""
    rng = np.random.default_rng(layout_seed + 1)
    views = []
    for i in range(count):
        ang = 2 * math.pi * i / count
        if i % 2 == 0:
            pos = np.array([1.25 * extent * math.cos(ang),
                            1.25 * extent * math.sin(ang),
                            rng.uniform(1.5, 2.5)])
            look = np.array([0.0, 0.0, 1.0]) - pos
        else:
            pos = np.array([*(rng.uniform(-0.6, 0.6, 2) * extent), 1.2])
            look = np.array([math.cos(ang), math.sin(ang),
                             rng.uniform(-0.3, 0.0)])
        views.append((pos.astype(np.float32), look))
    return views


def free_points(free: np.ndarray, origin, scale: float, rng,
                count: int) -> np.ndarray:
    """``count`` world (x, y) points at the centres of free cells of an
    occupancy mask (``free`` (H, W) bool, rows along y; cell (0, 0) at the
    world point ``origin``)."""
    ys, xs = np.nonzero(free)
    pick = rng.integers(0, ys.shape[0], count)
    return np.stack([origin[0] + xs[pick] * scale,
                     origin[1] + ys[pick] * scale], 1).astype(np.float32)


def episodes(free: np.ndarray, origin, scale: float, count: int,
             layout_seed: int, min_m: float = 2.0, max_m: float = 20.0):
    """``count`` episodes (start (2,), yaw, goal (2,)) between free cells
    ``min_m`` to ``max_m`` apart, drawn as the SAGE-Bench trajectory
    generator draws its start and goal pairs, fixed by the layout seed."""
    rng = np.random.default_rng(layout_seed + 2)
    out = []
    while len(out) < count:
        s, g = free_points(free, origin, scale, rng, 2)
        d = float(np.hypot(*(g - s)))
        if min_m <= d <= max_m:
            out.append((s, float(rng.uniform(-math.pi, math.pi)), g))
    return out


def route_poses(eps, spacing: float) -> list:
    """((x, y), yaw) poses every ``spacing`` m along each episode's straight
    route from start to goal, facing along it."""
    poses = []
    for s, _, g in eps:
        d = g - s
        length = float(np.hypot(*d))
        yaw = math.atan2(float(d[1]), float(d[0]))
        for t in np.arange(0.0, length + 1e-6, spacing):
            p = s + d * (t / length)
            poses.append(((float(p[0]), float(p[1])), yaw))
    return poses


def order(n: int, seed: int) -> np.ndarray:
    """The run seed's order of ``n`` items (a permutation)."""
    return np.random.default_rng(int(seed)).permutation(n)
