"""SAGE-Bench's evaluation loop: a closed loop of lockstep episode
batches through the program's ``rollout_batch(..., batch_mode="vmap")``.

A unit is one batch of ``agents`` episodes of ``episode_steps`` steps, the
episodes in the seed's order from the layout's pool; each step is one
batched render of the agents' cameras, the in-graph depth-seek policy, one
batched ``apply_cmd`` and one capsule query (K6) of all agents. The window
closes at the end of the batch running when its seconds run out.

The rollout's step loop is inside the program, so the benchmark records
each step at the calls the loop makes into the layers below it (the
camera, the render, the motion and the capsule query, looked up in the
rollout module's namespace) and keeps references to their inputs and
outputs: no copy, no sync. The check then follows the program step by step
from the program's own states: every step's motion and capsule clearance,
and on a sample of steps drawn from the seed the depth each agent's policy
read, its mean and the command the policy gave; and each episode's
collision count and the pairs dropped.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from perfbench.harness import navsetup, port, stats
from perfbench.reference import nav as rn
from perfbench.reference import render as rr
from perfbench.roofline import counts as rc

SPANS = {"render_batch": "rollout.render", "apply_cmd": "rollout.motion",
         "capsule_query": "rollout.capsule_query"}


class Recorder:
    """Wraps the rollout module's calls into its layers. Each step keeps
    the pose the camera was built from, the render's overflow and (only on
    sampled steps) its depth, the motion's state and command, and the
    capsule query's endpoints and clearance."""

    def __init__(self, mod, spans, keep: int, rng: random.Random):
        self.mod, self.spans = mod, spans
        self.keep, self.rng = keep, rng
        self.steps, self.sampled, self.seen = [], [], 0
        self.on = True
        self.orig = {k: getattr(mod, k) for k in
                     ("agent_camera_t", "render_batch", "apply_cmd",
                      "capsule_query")}
        for name, fn in self.orig.items():
            setattr(mod, name, self._wrap(name, fn))

    def restore(self):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)

    def _wrap(self, name, fn):
        span = SPANS.get(name)

        def call(*args, **kw):
            if span is not None:
                with self.spans(span):
                    out = fn(*args, **kw)
            else:
                out = fn(*args, **kw)
            if self.on:
                getattr(self, "_" + name)(args, kw, out)
            return out
        return call

    def _agent_camera_t(self, args, kw, out):
        self.cur = {"xy": args[0], "yaw": args[1]}

    def _render_batch(self, args, kw, out):
        self.cur["overflow"] = out["overflow"]
        # reservoir sample of steps whose depth images are kept
        self.seen += 1
        if len(self.sampled) < self.keep:
            self.sampled.append((len(self.steps), out["depth"]))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.keep:
                self.sampled[j] = (len(self.steps), out["depth"])

    def _apply_cmd(self, args, kw, out):
        state, _, vx, _, yaw_rate, duration = args
        self.cur.update(pos=state.pos, yaw_in=state.yaw,
                        coll=state.total_collisions, vx=vx,
                        yaw_rate=yaw_rate, duration=float(duration),
                        pos_out=out.pos, yaw_out=out.yaw,
                        coll_out=out.total_collisions)

    def _capsule_query(self, args, kw, out):
        self.cur.update(p0=args[1], p1=args[2], radius=args[3],
                        clearance=out["clearance"])
        self.steps.append(self.cur)


class Session:
    def __init__(self, ctx):
        import sage3d_tpu_torch.env.rollout as rollout_mod
        from sage3d_tpu_torch.env.rollout import rollout_batch
        self.ctx, p = ctx, ctx.params
        self.nav = navsetup.Nav(ctx)
        self.rollout_batch = rollout_batch
        self.agents = p["agents"]
        self.n_steps = ctx.config["episode_steps"]
        self.rec = Recorder(rollout_mod, ctx.spans, p["sampled_steps"],
                            random.Random(ctx.seed))
        self.batches, self.b = [], 0
        self.kw = dict(width=self.nav.width, height=self.nav.height,
                       duration_s=ctx.config["duration_s"],
                       device=ctx.device, **self.nav.bk)
        # warm-up: the batch's shapes, not recorded
        self.rec.on = False
        self._run(p["warmup_steps"])
        self.sync()
        self.rec.on = True

    def _episodes(self):
        eps = [self.nav.episode(self.b * self.agents + a)
               for a in range(self.agents)]
        self.b += 1
        return eps

    def _run(self, n_steps):
        eps = self._episodes()
        dev = self.ctx.device
        starts = torch.tensor(np.stack([e[0] for e in eps]), device=dev)
        yaws = torch.tensor([e[1] for e in eps], dtype=torch.float32,
                            device=dev)
        goals = torch.tensor(np.stack([e[2] for e in eps]), device=dev)
        first = len(self.rec.steps)
        out = self.rollout_batch(self.nav.scene, self.nav.grid, starts, yaws,
                                 goals, batch_mode="vmap", n_steps=n_steps,
                                 **self.kw)
        return {"goals": goals, "first": first, "out": out}

    def unit(self) -> dict:
        with self.ctx.spans("rollout_batch"):
            r = self._run(self.n_steps)
        if self.rec.on:
            self.batches.append(r)
        return {"steps": self.n_steps * self.agents, "first": r["first"]}

    def sync(self) -> None:
        port.sync(self.ctx.device)

    def work(self, records) -> dict:
        return {"units": len(records),
                "env_steps": sum(r["steps"] for r in records),
                "lockstep_steps": len(records) * self.n_steps}

    def end_to_end(self, records, window_s: float) -> dict:
        return {"env_steps_s": stats.rate(self.work(records)["env_steps"],
                                          window_s)}

    def trace_extra(self, records) -> dict:
        """K6's least time for the traced steps' queries, and K2's for a
        sample of traced steps with the device time of their own K2
        launches; the device time of projection and binning alone on those
        steps' cameras."""
        from perfbench.harness import trace
        from sage3d_tpu_torch.ops.binning import (EMIT_BUDGET_KEYS,
                                                  bin_gaussians)
        from sage3d_tpu_torch.ops.projection import project_gaussians
        from sage3d_tpu_torch.renderer.camera import agent_camera_t
        f = self.nav.fields
        n_solid = int((torch.sigmoid(f["opacity_logits"]) >= 0.5).sum())
        n_steps = sum(self.n_steps for _ in records)
        k6 = n_steps * rc.k6_seconds(f["means"].shape[0], n_solid,
                                     self.agents)
        first = records[0]["first"]
        steps = self.rec.steps[first:first + n_steps]
        pick = sorted(random.Random(self.ctx.seed).sample(
            range(len(steps)), min(self.ctx.params["roofline_steps"],
                                   len(steps))))
        k2 = 0.0
        for i in pick:
            for a in range(self.agents):
                cam = self._ref_cam(steps[i], a)
                c = rr.render(f, cam, count=True)["counts"]
                k2 += rc.k2_seconds(*c)
        emit = {k: self.nav.bk[k] for k in EMIT_BUDGET_KEYS}

        def probe():
            with torch.no_grad():
                for i in pick:
                    cams = agent_camera_t(steps[i]["xy"], steps[i]["yaw"],
                                          width=self.nav.width,
                                          height=self.nav.height,
                                          focal_mm=self.ctx.config["focal_mm"])
                    bin_gaussians(project_gaussians(self.nav.scene, cams),
                                  self.nav.width, self.nav.height, **emit)

        ev, _, _ = trace.profile(probe, trace.Spans())
        return {"k6_least_s": k6, "k2_least_s": k2, "k2_launches": pick,
                "binning_device_s": sum(e - s for _, s, e in ev),
                "binning_env_steps": len(pick) * self.agents}

    def _ref_cam(self, step, a):
        xy = step["xy"][a].double().cpu().tolist()
        return rr.agent_cam(xy[0], xy[1], float(step["yaw"][a]),
                            self.nav.width, self.nav.height,
                            self.ctx.config["focal_mm"],
                            self.ctx.config["eye_height_m"],
                            device=self.ctx.device)

    def check(self) -> list:
        """Follow every recorded step from the program's own state."""
        self.rec.restore()
        steps, sampled = self.rec.steps, self.rec.sampled
        self.rec.steps = []
        lim, cfg = self.ctx.limits, self.ctx.config
        g = self.nav.ref_grid
        cat = {k: torch.stack([s[k] for s in steps]) for k in
               ("pos", "yaw_in", "coll", "vx", "yaw_rate", "pos_out",
                "yaw_out", "coll_out", "p0", "p1", "clearance", "overflow")}
        pos, yaw, coll, hit = rn.move(g, cat["pos"], cat["yaw_in"],
                                      cat["coll"], cat["vx"], 0.0,
                                      cat["yaw_rate"], cfg["duration_s"])
        pose_gap = float((pos - cat["pos_out"]).abs().max())
        yaw_gap = float(torch.remainder(yaw - cat["yaw_out"] + np.pi,
                                        2 * np.pi).sub(np.pi).abs().max())
        coll_gap = int((coll != cat["coll_out"]).sum())
        s, a = cat["p0"].shape[:2]
        clear = rn.clearance(self.nav.fields, cat["p0"].reshape(s * a, 3),
                             cat["p1"].reshape(s * a, 3),
                             float(steps[0]["radius"]))
        clear_gap = float((clear - cat["clearance"].reshape(-1).double())
                          .abs().max())
        sums = 0
        for r in self.batches:
            tot = r["out"]["total_collisions"]
            last = steps[r["first"] + self.n_steps - 1]["coll_out"]
            sums += int((tot != last).sum())
        depth_gap = mean_gap = cmd_gap = 0.0
        for i, depth in sampled:
            st = steps[i]
            b = next(r for r in reversed(self.batches) if r["first"] <= i)
            for a in range(self.agents):
                ref = rr.render(self.nav.fields, self._ref_cam(st, a))
                d_r = ref["depth"]
                depth_gap = max(depth_gap, float((depth[a] - d_r).abs().max()))
                mean_gap = max(mean_gap, abs(float(
                    b["out"]["mean_depth"][a, i - b["first"]])
                    - float(d_r.double().mean())))
                # the policy stage by itself, on the program's own depth
                vx, yr = rn.policy(depth[a], st["xy"][a], st["yaw"][a],
                                   b["goals"][a])
                cmd_gap = max(cmd_gap, abs(float(vx) - float(st["vx"][a])),
                              abs(float(yr) - float(st["yaw_rate"][a])))
        vals = {"depth_gap": depth_gap, "depth_mean_gap": mean_gap,
                "command_gap": cmd_gap, "pose_gap": pose_gap,
                "yaw_gap": yaw_gap, "clearance_gap": clear_gap,
                "collisions_gap": coll_gap + sums,
                "overflow": int(cat["overflow"].sum())}
        return [{"name": k, "value": v, "limit": lim[k], "ok": v <= lim[k]}
                for k, v in vals.items()]


def setup(ctx) -> Session:
    return Session(ctx)


def control(ctx) -> list:
    """The reference in bfloat16 put in the program's place: one lockstep
    step from agent poses drawn by the seed along the episodes' routes (its
    depth, the depth's mean, the policy's command, the motion under the
    float32 reference's command and the capsule clearance after it),
    against the float32 reference's."""
    inp = navsetup.NavInputs(ctx)
    cfg, dev = ctx.config, ctx.device
    n = ctx.params["sampled_steps"] * ctx.params["agents"]
    poses = inp.control_poses(ctx.seed, n)
    gaps = dict(depth_gap=0.0, depth_mean_gap=0.0, command_gap=0.0)
    xy = torch.tensor([[x, y] for x, y, _, _ in poses], device=dev)
    yaw = torch.tensor([w for _, _, w, _ in poses], device=dev)
    goal = torch.tensor(np.stack([g for _, _, _, g in poses]), device=dev)
    vx = torch.empty(n, device=dev)
    yr = torch.empty(n, device=dev)
    for i, (x, y, w, _) in enumerate(poses):
        cam = inp.ref_cam(x, y, w)
        d = rr.render(inp.fields, cam)["depth"]
        dl = rr.render(inp.fields, cam, dtype=torch.bfloat16)["depth"]
        gaps["depth_gap"] = max(gaps["depth_gap"], float((d - dl).abs().max()))
        gaps["depth_mean_gap"] = max(gaps["depth_mean_gap"], abs(
            float(d.double().mean()) - float(dl.double().mean())))
        # the policy stage by itself, as the check takes it: on one depth
        a = rn.policy(d, xy[i], yaw[i], goal[i])
        b = rn.policy(d, xy[i], yaw[i], goal[i], dtype=torch.bfloat16)
        vx[i], yr[i] = a
        gaps["command_gap"] = max(gaps["command_gap"],
                                  *(abs(float(u) - float(v))
                                    for u, v in zip(a, b)))
    pos = torch.cat([xy, torch.full((n, 1), 0.5, device=dev)], 1)
    c = torch.zeros(n, dtype=torch.int32, device=dev)
    a = rn.move(inp.ref_grid, pos, yaw, c, vx, 0.0, yr, cfg["duration_s"])
    b = rn.move(inp.ref_grid, pos, yaw, c, vx, 0.0, yr, cfg["duration_s"],
                dtype=torch.bfloat16)
    gaps["pose_gap"] = float((a[0] - b[0].float()).abs().max())
    gaps["yaw_gap"] = float(torch.remainder(a[1] - b[1].float() + np.pi,
                                            2 * np.pi).sub(np.pi).abs().max())
    p0 = torch.cat([a[0][:, :2], torch.full((n, 1), 0.1, device=dev)], 1)
    p1 = torch.cat([a[0][:, :2], torch.full((n, 1), 0.7, device=dev)], 1)
    r = cfg["capsule_radius_m"]
    gaps["clearance_gap"] = float((rn.clearance(inp.fields, p0, p1, r)
                                   - rn.clearance(inp.fields, p0, p1, r,
                                                  dtype=torch.bfloat16))
                                  .abs().max())
    gaps["collisions_gap"] = int((a[3] != b[3]).sum())
    gaps["overflow"] = 0
    return [{"name": k, "value": v, "limit": ctx.limits[k],
             "ok": v <= ctx.limits[k]} for k, v in gaps.items()]
