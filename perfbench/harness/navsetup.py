"""What the navigation cells share: the room, its semantic map and
occupancy grid (the program's, and the reference's own from the same map),
the pool of episodes, and budgets over the poses an agent reaches."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import nav as rn
from ..reference import render as rr
from . import port, scene as hs


class NavInputs:
    """The cells' inputs from the seed, made without the program: the room,
    its semantic map, the reference's grid and the pool of episodes."""

    def __init__(self, ctx):
        cfg, p = ctx.config, ctx.params
        dev = ctx.device
        self.cfg = cfg
        self.width, self.height = cfg["width"], cfg["height"]
        self.fields = hs.room_fields(
            cfg["num_gaussians"], cfg["scene_seed"], cfg["extent_m"],
            cfg["sh_degree"], cfg["num_objects"], cfg["layout_seed"], dev)
        self.instances = hs.semantic_map(
            cfg["extent_m"], cfg["num_objects"], cfg["layout_seed"],
            cfg["object_radius_m"], cfg["grid_scale_m"])
        mask, bounds = rn.occupancy(self.instances, cfg["grid_scale_m"],
                                    cfg["robot_radius_m"])
        self.ref_grid = rn.Grid(mask, bounds, cfg["grid_scale_m"], dev)
        # the world point of cell (0, 0): the map frame mirrored back
        origin = (-bounds[1], -bounds[3])
        self.eps = hs.episodes(mask == 0, origin, cfg["grid_scale_m"],
                               p["episode_pool"], cfg["layout_seed"],
                               cfg["goal_min_m"], cfg["goal_max_m"])
        self.order = hs.order(len(self.eps), ctx.seed)

    def episode(self, i: int):
        """The i-th episode of the run, in the seed's order."""
        return self.eps[int(self.order[i % len(self.order)])]

    def ref_cam(self, x: float, y: float, yaw: float):
        return rr.agent_cam(x, y, yaw, self.width, self.height,
                            self.cfg["focal_mm"], self.cfg["eye_height_m"],
                            device=self.fields["means"].device)

    def control_poses(self, seed: int, count: int):
        """``count`` (x, y, yaw, goal) agent poses drawn by ``seed`` from
        the episodes' routes, each with its episode's goal."""
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(count):
            s, _, g = self.eps[int(rng.integers(len(self.eps)))]
            t = float(rng.uniform(0.0, 1.0))
            p = s + (g - s) * t
            out.append((float(p[0]), float(p[1]),
                        math.atan2(float(g[1] - s[1]), float(g[0] - s[0]))
                        + float(rng.normal(0.0, 0.3)), g))
        return out


class Nav(NavInputs):
    """The inputs and what the program makes of them at set-up: its scene,
    its occupancy grid from the same semantic map, and budgets from
    ``autotune_poses`` over the poses an agent reaches."""

    def __init__(self, ctx):
        from sage3d_tpu_torch.physics.occupancy import grid_from_semantic_map
        from sage3d_tpu_torch.renderer.camera import agent_camera_t
        from sage3d_tpu_torch.renderer.render import (autotune_poses,
                                                      budget_kwargs)
        super().__init__(ctx)
        cfg, p = ctx.config, ctx.params
        dev = ctx.device
        self.scene = port.gaussian_scene(self.fields)
        self.grid = grid_from_semantic_map(
            self.instances, robot_radius_m=cfg["robot_radius_m"],
            scale=cfg["grid_scale_m"], device=dev)
        # budgets over the poses an agent reaches: a grid of free points
        # at 8 headings and the routes' poses
        step = p["probe_spacing_m"]
        pts = [(x, y) for x in np.arange(-cfg["extent_m"] + step / 2,
                                         cfg["extent_m"], step)
               for y in np.arange(-cfg["extent_m"] + step / 2,
                                  cfg["extent_m"], step)]
        pts = [q for q in pts if not bool(self.ref_grid.blocked(
            torch.tensor(q, dtype=torch.float32, device=dev)))]
        poses = [(q, k * math.pi / 4) for q in pts for k in range(8)]
        poses += hs.route_poses(self.eps, p["route_spacing_m"])
        xy = torch.tensor([q for q, _ in poses], dtype=torch.float32,
                          device=dev)
        yaw = torch.tensor([w for _, w in poses], dtype=torch.float32,
                           device=dev)
        cams = agent_camera_t(xy, yaw, width=self.width, height=self.height,
                              focal_mm=cfg["focal_mm"])
        self.budgets = autotune_poses(self.scene, cams,
                                      pair_margin=p["pair_margin"])
        self.bk = budget_kwargs(self.budgets)
        self.bk.pop("grad_capacity", None)
        self.n_probe = len(poses)
