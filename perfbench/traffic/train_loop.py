"""Scene fitting: a closed loop of the program's train step.

Set-up draws the room and a target scene (the room with its colours and
opacities jittered) from the configuration's scene seed, renders the
targets of the cell's views
once with the program, takes overflow-free budgets from
``autotune_poses`` over the views, builds ONE train state and step
(``make_train_step(..., backend="cuda")`` with the 3DGS per-group Adam),
and drives it through ``warmup_steps`` steps, the views in the seed's
order; the reference follows the first three. The window then runs that
same state on, a step a unit, a view a step, in the same order.

Checked: each of the first three steps' loss, each group's gradient norm at
step 1 as the optimizer holds it (Adam's first moment / (1 - b1)), and each
group's change after step 3, against the reference's own three steps from
the same start; and no pair dropped by the budgets, on the targets and on
the state the window leaves.
"""

from __future__ import annotations

import torch

from perfbench.harness import port, scene as hs, stats
from perfbench.reference import render as rr
from perfbench.reference import train as rt
from perfbench.roofline import counts as rc

CHECKED_STEPS = 3


class Inputs:
    """The cell's inputs, made without the program: the room, the target
    room, the views and the run seed's order of them."""

    def __init__(self, ctx):
        cfg, p = ctx.config, ctx.params
        dev = ctx.device
        self.width, self.height = cfg["width"], cfg["height"]
        self.fields = hs.room_fields(
            cfg["num_gaussians"], cfg["scene_seed"], cfg["extent_m"],
            cfg["sh_degree"], cfg["num_objects"], cfg["layout_seed"], dev)
        gen = torch.Generator(device=dev).manual_seed(cfg["scene_seed"] + 1)
        target = dict(self.fields)
        sh = self.fields["sh"].clone()
        sh[:, 0] += p["target_colour_jitter"] * torch.randn(
            sh[:, 0].shape, generator=gen, device=dev)
        target["sh"] = sh
        target["opacity_logits"] = self.fields["opacity_logits"] + \
            p["target_opacity_jitter"] * torch.randn(
                self.fields["opacity_logits"].shape, generator=gen, device=dev)
        self.target = target
        self.views = hs.orbit_views(cfg["views"], cfg["extent_m"],
                                    cfg["layout_seed"])
        self.order = hs.order(cfg["views"], ctx.seed)
        self.lrs = cfg["group_lrs"]


class Session(Inputs):
    def __init__(self, ctx):
        from sage3d_tpu_torch.parallel.train import (init_train_state,
                                                     make_group_optimizer,
                                                     make_train_step)
        from sage3d_tpu_torch.renderer.camera import slice_cameras
        from sage3d_tpu_torch.renderer.render import (autotune_poses,
                                                      budget_kwargs,
                                                      render_batch)
        super().__init__(ctx)
        self.ctx = ctx
        cfg, p = ctx.config, ctx.params
        dev = ctx.device
        target = self.target
        self.cams, self.ref_cams = port.cameras(
            self.views, self.width, self.height, cfg["focal_mm"], dev)
        scene = port.gaussian_scene(self.fields)
        budgets = autotune_poses(scene, self.cams,
                                 pair_margin=p["pair_margin"],
                                 grad_margin=p["grad_margin"])
        self.bk = budget_kwargs(budgets)
        self.views = [slice_cameras(self.cams, slice(i, i + 1))
                      for i in range(cfg["views"])]
        self.targets, self.overflow = [], 0
        tscene = port.gaussian_scene(target)
        with torch.no_grad():
            for i in range(0, cfg["views"], p["render_group"]):
                tgt = render_batch(tscene, slice_cameras(
                    self.cams, slice(i, i + p["render_group"])),
                    backend="cuda", **self.bk)
                self.targets.append(tgt["rgb"])
                self.overflow += int(tgt["overflow"].sum())
        self.targets = torch.cat(self.targets)
        del tgt, tscene
        # a host span around the step's forward render (its call into the
        # render layer, looked up in the train module's namespace)
        import sage3d_tpu_torch.parallel.train as train_mod
        self.train_mod, self.forward = train_mod, train_mod.render_batch

        def forward(*a, **k):
            with ctx.spans("train.forward"):
                return self.forward(*a, **k)

        train_mod.render_batch = forward
        self.step, _ = make_train_step(
            scene, self.cams, backend="cuda",
            optimizer=make_group_optimizer(extent=cfg["extent_m"]),
            **self.bk)
        self.state = init_train_state(
            scene, make_group_optimizer(extent=cfg["extent_m"]))
        self.i = 0
        # the first steps, through the window's own call and feed
        self.losses = []
        for k in range(p["warmup_steps"]):
            loss = self.unit()["loss"]
            if k < CHECKED_STEPS:
                self.losses.append(loss)
            if k == 0:
                self.grad1 = self._first_grad_norms()
            if k == CHECKED_STEPS - 1:
                self.change = {n: float(torch.linalg.vector_norm(
                    (self.state.params[n].detach() - self.fields[n]).double()))
                    for n in rt.GROUPS}
        self.losses = [float(x) for x in self.losses]

    def _first_grad_norms(self) -> dict:
        """Each group's gradient as Adam holds it after its first step:
        exp_avg / (1 - b1)."""
        out = {}
        for group in self.state.opt_state.param_groups:
            p = group["params"][0]
            m = self.state.opt_state.state.get(p, {}).get("exp_avg")
            out[group["name"]] = (0.0 if m is None else float(
                torch.linalg.vector_norm(m.double()
                                         / (1.0 - group["betas"][0]))))
        return out

    def unit(self) -> dict:
        v = int(self.order[self.i % len(self.order)])
        self.i += 1
        with self.ctx.spans("train_step"):
            self.state, loss = self.step(self.state, self.views[v],
                                         self.targets[v:v + 1])
        return {"view": v, "loss": loss}

    def sync(self) -> None:
        port.sync(self.ctx.device)

    def work(self, records) -> dict:
        return {"units": len(records), "steps": len(records),
                "pixels": len(records) * self.width * self.height}

    def end_to_end(self, records, window_s: float) -> dict:
        px = self.work(records)["pixels"]
        return {"train_mpix_s": stats.rate(px / 1e6, window_s)}

    def trace_extra(self, records) -> dict:
        """The compositor's least work for the traced steps' views (the
        reference's counts on the state the stretch left), and the device
        time of projection and binning alone on those views."""
        from sage3d_tpu_torch.ops.binning import EMIT_BUDGET_KEYS, bin_gaussians
        from sage3d_tpu_torch.ops.projection import project_gaussians
        from perfbench.harness import trace
        live = dict(self.fields, **{k: v.detach() for k, v in
                                    self.state.params.items()})
        k2 = k3 = 0.0
        with torch.no_grad():
            for r in records:
                c = rr.render(live, self.ref_cams[r["view"]], count=True)[
                    "counts"]
                k2 += rc.k2_seconds(*c)
                k3 += rc.k3_seconds(*c)
        scene = port.gaussian_scene(live)
        emit = {k: self.bk[k] for k in EMIT_BUDGET_KEYS}

        def probe():
            with torch.no_grad():
                for r in records:
                    proj = project_gaussians(scene, self.views[r["view"]])
                    bin_gaussians(proj, self.width, self.height, **emit)

        ev, t0, t1 = trace.profile(probe, trace.Spans())
        binning = sum(e - s for _, s, e in ev)
        return {"k2_least_s": k2, "k3_least_s": k3,
                "binning_device_s": binning, "binning_env_steps": len(records)}

    def check(self) -> list:
        """Free the program's state, then run the reference's three steps."""
        from sage3d_tpu_torch.renderer.render import render_batch
        self.train_mod.render_batch = self.forward
        lim = self.ctx.limits
        live = port.gaussian_scene(dict(self.fields, **{
            k: v.detach() for k, v in self.state.params.items()}))
        from sage3d_tpu_torch.renderer.camera import slice_cameras
        g = self.ctx.params["render_group"]
        with torch.no_grad():
            after = sum(int(render_batch(
                live, slice_cameras(self.cams, slice(i, i + g)),
                backend="cuda", **self.bk)["overflow"].sum())
                for i in range(0, len(self.views), g))
        del live, self.state, self.step, self.targets
        port.free()
        ref = rt.fit_steps(self.fields, self.target,
                           [self.ref_cams[int(v)]
                            for v in self.order[:CHECKED_STEPS]], self.lrs)
        return compare({"loss": self.losses, "grad": self.grad1,
                        "change": self.change,
                        "overflow": self.overflow + after}, ref, lim)


def compare(prog: dict, ref: dict, lim: dict) -> list:
    """The compared numbers of a fit: the worst step's loss gap, the worst
    group's gradient-norm gap at step 1 and change-norm gap after step 3,
    and the pairs dropped."""
    vals = {
        "loss_gap": rt.finite(rt.loss_gap(prog["loss"], ref["loss"])),
        "grad_gap": rt.finite(rt.worst_leaf_gap(prog["grad"], ref["grad"])),
        "change_gap": rt.finite(rt.worst_leaf_gap(
            prog["change"], ref["change"], ref_grad=ref["grad"])),
        "overflow": prog["overflow"],
    }
    return [{"name": k, "value": v, "limit": lim[k], "ok": v <= lim[k]}
            for k, v in vals.items()]


def setup(ctx) -> Session:
    return Session(ctx)


def control(ctx) -> list:
    """The reference in bfloat16 put in the program's place: its three
    steps against the float32 reference's, by the cell's comparison."""
    inp = Inputs(ctx)
    _, cams = port.cameras(inp.views, inp.width, inp.height,
                           ctx.config["focal_mm"], ctx.device, program=False)
    cams = [cams[int(v)] for v in inp.order[:CHECKED_STEPS]]
    ref = rt.fit_steps(inp.fields, inp.target, cams, inp.lrs)
    low = rt.fit_steps(inp.fields, inp.target, cams, inp.lrs,
                       dtype=torch.bfloat16)
    return compare(dict(low, overflow=0), ref, ctx.limits)


def faults(ctx) -> dict:
    """What the check reads of each fault a train step can have, planted in
    the reference put in the program's place (a state left unchanged reads
    1 by the change's measure and needs no run)."""
    inp = Inputs(ctx)
    _, cams = port.cameras(inp.views, inp.width, inp.height,
                           ctx.config["focal_mm"], ctx.device, program=False)
    cams = [cams[int(v)] for v in inp.order[:CHECKED_STEPS]]
    ref = rt.fit_steps(inp.fields, inp.target, cams, inp.lrs)
    return {f: compare(dict(rt.fit_steps(inp.fields, inp.target, cams,
                                         inp.lrs, fault=f), overflow=0),
                       ref, ctx.limits) for f in rt.FAULTS}
