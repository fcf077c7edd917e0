"""The per-step path an external VLN policy sees: one agent, episode after
episode, through the program's ``GaussianVLNEnv`` step API.

A unit is one env step: ``apply_cmd_for`` of the action, then the next
observation on the host (``get_rgbd``'s RGB and depth, the agent's
position and yaw). Its latency runs from the action's issue to the
observation's arrival. The benchmark's own host policy, a NumPy copy of
the depth-seek rule, then picks the next action from that observation, as a
policy server would; its time is in the window but in no step's latency.
An episode starts at its start pose with an observation and lasts
``episode_steps`` steps.

Checked: every step's pose against the reference's motion from the pose
before it and the same action; on a sample of steps drawn from the seed,
the observation (RGB as bytes and depth) against the reference's render at
the pose the program reports; each episode's collision count; the pairs
dropped.
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from perfbench.harness import navsetup, port, stats
from perfbench.reference import nav as rn
from perfbench.reference import render as rr
from perfbench.roofline import counts as rc


def start_quat(yaw: float):
    """The stored (x, y, z, w) start quaternion whose decode (the env's
    ``set_start_pose``: 2 atan2(-qx, qw) - pi) is ``yaw``."""
    half = 0.5 * (yaw + math.pi)
    return [-math.sin(half), 0.0, 0.0, math.cos(half)]


class Session:
    def __init__(self, ctx):
        from sage3d_tpu_torch.env.vln_env import GaussianVLNEnv
        from sage3d_tpu_torch.ops.composite_cuda import composite_fwd
        self.k2 = composite_fwd        # its launch counter
        self.ctx, p, cfg = ctx, ctx.params, ctx.config
        self.nav = navsetup.Nav(ctx)
        self.env = GaussianVLNEnv(
            self.nav.scene, map_json=self.nav.grid, width=cfg["width"],
            height=cfg["height"], focal_mm=cfg["focal_mm"],
            robot_radius_m=cfg["robot_radius_m"],
            camera_height=cfg["eye_height_m"], device=ctx.device,
            budgets=self.nav.budgets)
        self.n_steps = cfg["episode_steps"]
        self.duration = cfg["duration_s"]
        self.keep, self.rng = p["sampled_steps"], random.Random(ctx.seed)
        self.steps, self.sampled, self.episodes, self.seen = [], [], [], 0
        self.e = 0
        self.record = False
        self._reset()
        for _ in range(p["warmup_steps"]):
            self.unit()
        self.record = True
        self._reset()

    def _observe(self):
        rgb, depth = self.env.get_rgbd()
        return rgb, depth, self.env.get_agent_pos(), self.env.get_yaw()

    def _reset(self):
        if self.record and self.episodes:
            self.episodes[-1]["collisions"] = self.env.get_collision_count()
        s, yaw, g = self.nav.episode(self.e)
        self.e += 1
        self.env.set_start_pose([float(s[0]), float(s[1]), 0.5],
                                start_quat(yaw))
        self.t = 0
        self.goal = g
        self.obs = self._observe()
        self.action = rn.policy_np(self.obs[1], self.obs[2], self.obs[3], g)
        if self.record:
            self.episodes.append({"first": len(self.steps)})

    def unit(self) -> dict:
        vx, yaw_rate = self.action
        before = self.obs
        t0 = time.perf_counter()
        with self.ctx.spans("apply_cmd_for"):
            self.env.apply_cmd_for(vx, 0.0, yaw_rate, self.duration)
        with self.ctx.spans("get_rgbd"):
            self.obs = self._observe()
        latency = time.perf_counter() - t0
        k2 = self.k2.launches
        with self.ctx.spans("host_policy"):
            self.action = rn.policy_np(self.obs[1], self.obs[2],
                                       self.obs[3], self.goal)
        if self.record:
            self.steps.append((before[2], before[3], vx, yaw_rate,
                               self.obs[2], self.obs[3]))
            self.seen += 1
            item = (len(self.steps) - 1, self.obs[0], self.obs[1])
            if len(self.sampled) < self.keep:
                self.sampled.append(item)
            else:
                j = self.rng.randrange(self.seen)
                if j < self.keep:
                    self.sampled[j] = item
        self.t += 1
        if self.t == self.n_steps:
            with self.ctx.spans("reset"):
                self._reset()
        return {"latency_s": latency, "k2": k2, "step": len(self.steps) - 1}

    def sync(self) -> None:
        port.sync(self.ctx.device)

    def work(self, records) -> dict:
        return {"units": len(records), "env_steps": len(records)}

    def end_to_end(self, records, window_s: float) -> dict:
        lat = [r["latency_s"] * 1e3 for r in records]
        return {"env_steps_s.single": stats.rate(len(records), window_s),
                "env_step_p95_ms": stats.percentile(lat, 95)}

    def trace_extra(self, records) -> dict:
        """The device time of projection and binning alone at the traced
        steps' poses (the last ``len(records)`` observations)."""
        from perfbench.harness import trace
        from sage3d_tpu_torch.ops.binning import (EMIT_BUDGET_KEYS,
                                                  bin_gaussians)
        from sage3d_tpu_torch.ops.projection import project_gaussians
        from sage3d_tpu_torch.renderer.camera import agent_camera_t
        cfg = self.ctx.config
        poses = [s[4:6] for s in self.steps[-len(records):]]
        dev = self.ctx.device
        emit = {k: self.nav.bk[k] for k in EMIT_BUDGET_KEYS}

        def probe():
            with torch.no_grad():
                for xy, yaw in poses:
                    cam = agent_camera_t(
                        torch.tensor(xy[:2], device=dev),
                        torch.tensor(yaw, device=dev), width=cfg["width"],
                        height=cfg["height"], focal_mm=cfg["focal_mm"],
                        camera_height=cfg["eye_height_m"])
                    bin_gaussians(project_gaussians(self.nav.scene, cam),
                                  cfg["width"], cfg["height"], **emit)

        ev, _, _ = trace.profile(probe, trace.Spans())
        # K2's least time for a sample of the traced steps' observations,
        # each beside its own launch (the stretch's launches counted from
        # its first: one a step, one more at an episode's start)
        base = records[0]["k2"] - 1
        pick = sorted(random.Random(self.ctx.seed).sample(
            range(len(records)), min(self.ctx.params["roofline_steps"],
                                     len(records))))
        k2 = 0.0
        for i in pick:
            xy, yaw = self.steps[records[i]["step"]][4:6]
            cam = self.nav.ref_cam(float(xy[0]), float(xy[1]), float(yaw))
            k2 += rc.k2_seconds(*rr.render(self.nav.fields, cam,
                                           count=True)["counts"])
        return {"binning_device_s": sum(e - s for _, s, e in ev),
                "binning_env_steps": len(poses), "k2_least_s": k2,
                "k2_launches": [records[i]["k2"] - base - 1 for i in pick]}

    def check(self) -> list:
        lim, cfg = self.ctx.limits, self.ctx.config
        dev = self.ctx.device
        overflow = int(self.env.total_overflow)
        last = self.env.get_collision_count()
        del self.env
        port.free()
        g = self.nav.ref_grid
        f32 = dict(dtype=torch.float32, device=dev)
        pos0 = torch.tensor(np.stack([s[0] for s in self.steps]), **f32)
        yaw0 = torch.tensor([s[1] for s in self.steps], **f32)
        vx = torch.tensor([s[2] for s in self.steps], **f32)
        yr = torch.tensor([s[3] for s in self.steps], **f32)
        pos1 = torch.tensor(np.stack([s[4] for s in self.steps]), **f32)
        yaw1 = torch.tensor([s[5] for s in self.steps], **f32)
        zero = torch.zeros(yaw0.shape, dtype=torch.int32, device=dev)
        pos, yaw, _, hit = rn.move(g, pos0, yaw0, zero, vx, 0.0, yr,
                                   self.duration)
        pose_gap = float((pos - pos1).abs().max())
        yaw_gap = float(torch.remainder(yaw - yaw1 + np.pi, 2 * np.pi)
                        .sub(np.pi).abs().max())
        hits = hit.cpu().numpy()
        self.episodes[-1]["collisions"] = last
        coll_gap = 0
        for k, ep in enumerate(self.episodes):
            end = (self.episodes[k + 1]["first"] if k + 1 < len(self.episodes)
                   else len(self.steps))
            coll_gap += abs(int(hits[ep["first"]:end].sum())
                            - ep["collisions"])
        rgb_gap = depth_gap = 0.0
        for i, rgb, depth in self.sampled:
            xy, w = self.steps[i][4], self.steps[i][5]
            cam = rr.agent_cam(float(xy[0]), float(xy[1]), float(w),
                               cfg["width"], cfg["height"], cfg["focal_mm"],
                               cfg["eye_height_m"], device=dev)
            ref = rr.render(self.nav.fields, cam)
            u8 = (torch.clamp(ref["rgb"], 0.0, 1.0) * 255.0 + 0.5).to(
                torch.uint8).cpu().numpy()
            rgb_gap = max(rgb_gap, float(np.abs(u8.astype(np.int16)
                                                - rgb.astype(np.int16)).max()))
            depth_gap = max(depth_gap, float(np.abs(
                ref["depth"].cpu().numpy() - depth).max()))
        vals = {"rgb_gap": rgb_gap, "depth_gap": depth_gap,
                "pose_gap": pose_gap, "yaw_gap": yaw_gap,
                "collisions_gap": coll_gap, "overflow": overflow}
        return [{"name": k, "value": v, "limit": lim[k], "ok": v <= lim[k]}
                for k, v in vals.items()]


def setup(ctx) -> Session:
    return Session(ctx)


def _u8(rgb):
    return (torch.clamp(rgb.float(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def control(ctx) -> list:
    """The reference in bfloat16 put in the program's place: at poses drawn
    by the seed along the episodes' routes, its observation and its motion
    under the float32 reference's action, against the float32 reference's."""
    inp = navsetup.NavInputs(ctx)
    dev, dur = ctx.device, ctx.config["duration_s"]
    gaps = dict(rgb_gap=0.0, depth_gap=0.0, pose_gap=0.0, yaw_gap=0.0,
                collisions_gap=0)
    for x, y, yaw, goal in inp.control_poses(ctx.seed,
                                            ctx.params["sampled_steps"]):
        cam = inp.ref_cam(x, y, yaw)
        ref = rr.render(inp.fields, cam)
        low = rr.render(inp.fields, cam, dtype=torch.bfloat16)
        gaps["rgb_gap"] = max(gaps["rgb_gap"], float(
            (_u8(ref["rgb"]).int() - _u8(low["rgb"]).int()).abs().max()))
        gaps["depth_gap"] = max(gaps["depth_gap"], float(
            (ref["depth"] - low["depth"]).abs().max()))
        vx, yr = rn.policy_np(ref["depth"].cpu().numpy(), (x, y), yaw, goal)
        pos = torch.tensor([[x, y, 0.5]], device=dev)
        w = torch.tensor([yaw], device=dev)
        c = torch.zeros(1, dtype=torch.int32, device=dev)
        a = rn.move(inp.ref_grid, pos, w, c, [vx], [0.0], [yr], dur)
        b = rn.move(inp.ref_grid, pos, w, c, [vx], [0.0], [yr], dur,
                    dtype=torch.bfloat16)
        gaps["pose_gap"] = max(gaps["pose_gap"], float(
            (a[0] - b[0].float()).abs().max()))
        gaps["yaw_gap"] = max(gaps["yaw_gap"], float(torch.remainder(
            a[1] - b[1].float() + np.pi, 2 * np.pi).sub(np.pi).abs().max()))
        gaps["collisions_gap"] += int((a[3] != b[3]).sum())
    gaps["overflow"] = 0
    return [{"name": k, "value": v, "limit": ctx.limits[k],
             "ok": v <= ctx.limits[k]} for k, v in gaps.items()]
