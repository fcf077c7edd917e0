"""Semantic image generation: a closed loop of forward-only batched renders
through the program's ``render_batch(..., backend="cuda",
sequential=False)``.

A unit is one batch of ``batch`` cameras whose poses are drawn, in the
seed's order, from the layout's pool of poses at the agent's eye height
along episode routes; its RGB (as bytes, by the program's
``rgb_to_uint8``) and semantic ids are copied to the host. Budgets come
from ``autotune_poses`` over the pool.

Checked: on a sample of batches kept by a reservoir drawn from the seed,
some of their frames against the reference's render of the same camera
(RGB bytes, depth, alpha and semantic ids); the pairs dropped over every
batch.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from perfbench.harness import port, scene as hs, stats
from perfbench.reference import nav as rn
from perfbench.reference import render as rr
from perfbench.roofline import counts as rc


class Inputs:
    """The cell's inputs, made without the program: the room, the pool of
    poses and the run seed's draws of batches from it."""

    def __init__(self, ctx):
        p, cfg = ctx.params, ctx.config
        dev = ctx.device
        self.width, self.height = cfg["width"], cfg["height"]
        self.fields = hs.room_fields(
            cfg["num_gaussians"], cfg["scene_seed"], cfg["extent_m"],
            cfg["sh_degree"], cfg["num_objects"], cfg["layout_seed"], dev)
        inst = hs.semantic_map(cfg["extent_m"], cfg["num_objects"],
                               cfg["layout_seed"], p["object_radius_m"],
                               p["grid_scale_m"])
        mask, bounds = rn.occupancy(inst, p["grid_scale_m"],
                                    p["robot_radius_m"])
        eps = hs.episodes(mask == 0, (-bounds[1], -bounds[3]),
                          p["grid_scale_m"], p["routes"], cfg["layout_seed"])
        poses = hs.route_poses(eps, p["route_spacing_m"])
        pick = np.random.default_rng(cfg["layout_seed"] + 3).choice(
            len(poses), p["pool"], replace=False)
        views = []
        for i in pick:
            (x, y), yaw = poses[i]
            views.append((np.array([x, y, p["eye_height_m"]], np.float32),
                          np.array([math.cos(yaw), math.sin(yaw), 0.0])))
        self.views = views
        self.batch = p["batch"]
        rng = np.random.default_rng(ctx.seed)
        self.draws = [torch.tensor(rng.choice(p["pool"], self.batch,
                                              replace=False), device=dev)
                      for _ in range(p["draws"])]


class Session(Inputs):
    def __init__(self, ctx):
        from sage3d_tpu_torch.renderer.render import (autotune_poses,
                                                      budget_kwargs,
                                                      render_batch,
                                                      rgb_to_uint8)
        super().__init__(ctx)
        self.ctx, p, cfg = ctx, ctx.params, ctx.config
        dev = ctx.device
        self.render_batch, self.to_u8 = render_batch, rgb_to_uint8
        self.scene = port.gaussian_scene(self.fields)
        self.cams, self.ref_cams = port.cameras(
            self.views, self.width, self.height, cfg["focal_mm"], dev)
        self.bk = budget_kwargs(autotune_poses(self.scene, self.cams,
                                               pair_margin=p["pair_margin"]))
        self.bk.pop("grad_capacity", None)
        self.keep, self.rng = p["sampled_batches"], random.Random(ctx.seed)
        self.frames_checked = p["frames_checked"]
        self.kept, self.seen, self.j = [], 0, 0
        self.overflow = torch.zeros((), dtype=torch.int64, device=dev)
        self.record = False
        for _ in range(p["warmup_batches"]):
            self.unit()
        self.record = True

    def _cams(self, idx):
        c = self.cams
        return c._replace(position=c.position[idx],
                          cam_to_world=c.cam_to_world[idx], fx=c.fx[idx],
                          fy=c.fy[idx], cx=c.cx[idx], cy=c.cy[idx])

    def unit(self) -> dict:
        idx = self.draws[self.j % len(self.draws)]
        self.j += 1
        with torch.no_grad():
            with self.ctx.spans("render_batch"):
                out = self.render_batch(self.scene, self._cams(idx),
                                        backend="cuda", sequential=False,
                                        **self.bk)
            with self.ctx.spans("copy_to_host"):
                rgb = self.to_u8(out["rgb"]).cpu().numpy()
                sem = out["semantic"].cpu().numpy()
        if self.record:
            self.overflow += out["overflow"].sum()
            self.seen += 1
            item = (idx, rgb, sem, out["depth"], out["alpha"])
            if len(self.kept) < self.keep:
                self.kept.append(item)
            else:
                k = self.rng.randrange(self.seen)
                if k < self.keep:
                    self.kept[k] = item
        return {"frames": self.batch, "idx": idx}

    def sync(self) -> None:
        port.sync(self.ctx.device)

    def work(self, records) -> dict:
        return {"units": len(records),
                "frames": sum(r["frames"] for r in records)}

    def end_to_end(self, records, window_s: float) -> dict:
        return {"render_frames_s": stats.rate(self.work(records)["frames"],
                                              window_s)}

    def trace_extra(self, records) -> dict:
        """K2's least time for the traced batches (the reference's counts
        of every frame), and the device time of projection and binning
        alone on their cameras."""
        from perfbench.harness import trace
        from sage3d_tpu_torch.ops.binning import (EMIT_BUDGET_KEYS,
                                                  bin_gaussians)
        from sage3d_tpu_torch.ops.projection import project_gaussians
        k2 = 0.0
        with torch.no_grad():
            for r in records:
                for i in r["idx"].tolist():
                    c = rr.render(self.fields, self.ref_cams[i],
                                  count=True)["counts"]
                    k2 += rc.k2_seconds(*c)
        emit = {k: self.bk[k] for k in EMIT_BUDGET_KEYS}

        def probe():
            with torch.no_grad():
                for r in records:
                    bin_gaussians(project_gaussians(self.scene,
                                                    self._cams(r["idx"])),
                                  self.width, self.height, **emit)

        ev, _, _ = trace.profile(probe, trace.Spans())
        return {"k2_least_s": k2,
                "binning_device_s": sum(e - s for _, s, e in ev),
                "binning_env_steps": sum(r["frames"] for r in records)}

    def check(self) -> list:
        lim = self.ctx.limits
        overflow = int(self.overflow)
        kept = self.kept
        del self.scene
        port.free()
        pick = random.Random(self.ctx.seed + 1)
        rgb_gap = depth_gap = alpha_gap = sem_gap = 0.0
        for idx, rgb, sem, depth, alpha in kept:
            for b in sorted(pick.sample(range(self.batch),
                                        self.frames_checked)):
                ref = rr.render(self.fields, self.ref_cams[int(idx[b])])
                u8 = (torch.clamp(ref["rgb"], 0.0, 1.0) * 255.0 + 0.5).to(
                    torch.uint8).cpu().numpy()
                rgb_gap = max(rgb_gap, float(np.abs(
                    u8.astype(np.int16) - rgb[b].astype(np.int16)).max()))
                depth_gap = max(depth_gap, float(
                    (ref["depth"] - depth[b]).abs().max()))
                alpha_gap = max(alpha_gap, float(
                    (ref["alpha"] - alpha[b]).abs().max()))
                sem_gap = max(sem_gap, float(np.mean(
                    ref["semantic"].cpu().numpy() != sem[b])))
        vals = {"rgb_gap": rgb_gap, "depth_gap": depth_gap,
                "alpha_gap": alpha_gap, "semantic_gap": sem_gap,
                "overflow": overflow}
        return [{"name": k, "value": v, "limit": lim[k], "ok": v <= lim[k]}
                for k, v in vals.items()]


def setup(ctx) -> Session:
    return Session(ctx)


def _u8(rgb):
    return (torch.clamp(rgb.float(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def control(ctx) -> list:
    """The reference in bfloat16 put in the program's place: as many frames
    as a run checks, drawn by the seed from its batches, against the
    float32 reference's renders."""
    inp = Inputs(ctx)
    p = ctx.params
    _, cams = port.cameras(inp.views, inp.width, inp.height,
                           ctx.config["focal_mm"], ctx.device, program=False)
    pick = random.Random(ctx.seed)
    gaps = dict(rgb_gap=0.0, depth_gap=0.0, alpha_gap=0.0, semantic_gap=0.0)
    for idx in pick.sample(inp.draws, p["sampled_batches"]):
        for b in pick.sample(range(inp.batch), p["frames_checked"]):
            ref = rr.render(inp.fields, cams[int(idx[b])])
            low = rr.render(inp.fields, cams[int(idx[b])],
                            dtype=torch.bfloat16)
            gaps["rgb_gap"] = max(gaps["rgb_gap"], float(
                (_u8(ref["rgb"]).int() - _u8(low["rgb"]).int()).abs().max()))
            for k in ("depth", "alpha"):
                gaps[k + "_gap"] = max(gaps[k + "_gap"], float(
                    (ref[k] - low[k].float()).abs().max()))
            gaps["semantic_gap"] = max(gaps["semantic_gap"], float(
                (ref["semantic"] != low["semantic"]).float().mean()))
    gaps["overflow"] = 0
    return [{"name": k, "value": v, "limit": ctx.limits[k],
             "ok": v <= ctx.limits[k]} for k, v in gaps.items()]
