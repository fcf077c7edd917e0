"""Sharded scene fitting: a closed loop of the program's sharded train step
on a (data x tile) mesh of processes, one card each, over NCCL.

This process is rank 0, on card 0: set-up starts ranks 1 .. n - 1 (this
module run as ``python -m perfbench.traffic.train_loop_mesh``, one process
a card), and each unit of work on rank 0 first tells them, by a line on
their standard input, to run the same unit; they follow its units in
lockstep and wait on their input between them. Every rank draws the
configuration's site on its own card (``harness/site.py``), renders its
band of the targets (the site with its colours and opacities jittered) with
the program, takes its band's budgets from ``autotune_poses`` over the
views, keeps its row shard of the parameters and Adam's moments
(``init_train_state``) and builds the step
(``make_train_step(..., mesh=<Mesh>, backend="cuda", gather=...)``). The
ranks then take ``warmup_steps`` steps, the views in the seed's order; the
reference follows the first three. The window runs that same state on, a
step a unit, a view a step.

Failure: a rank that raises, or that any other rank sees die, stops every
rank. Rank 0 watches the others' processes and kills them all, and itself,
at the first that exits unasked or at any exception of its own; the others
exit when rank 0's process goes away (their parent-death signal and a
watch on their parent) or their input closes. NCCL waits for ever on a
rank that is gone; nothing here waits on it.

Checked: what ``train_loop`` checks, with the reference computed in blocks
(``reference/blocked.py``) on rank 0's card once every rank has freed its
state: each of the first three steps' loss, each group's gradient norm at
step 1 as Adam holds it (over all the shards), each group's change after
step 3, and no pair dropped by the budgets on the targets and on the
state the window leaves (every band of every view, summed over ranks).
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import traceback

import torch

from perfbench.harness import port, registry, site, stats, trace
from perfbench.harness import scene as hs
from perfbench.reference import blocked as rb
from perfbench.roofline import counts as rc

CHECKED_STEPS = 3
MODULE = "perfbench.traffic.train_loop_mesh"
EXIT_WAIT_S = 30          # a rank's clean exit after "exit"


def _fit():
    """``train_loop``: the fit's comparison, which this cell shares."""
    return registry.traffic("train_loop")


class Inputs:
    """The cell's inputs, made without the program: the site, the target
    site, the views and the run seed's order of them."""

    def __init__(self, ctx, device):
        cfg, p = ctx.config, ctx.params
        self.width, self.height = cfg["width"], cfg["height"]
        self.fields = site.site_fields(
            cfg["num_gaussians"], cfg["scene_seed"], cfg["extent_m"],
            cfg["sh_degree"], cfg["num_objects"], cfg["layout_seed"], device)
        self.views = site.drone_views(cfg["views"], cfg["extent_m"],
                                      cfg["layout_seed"])
        self.order = hs.order(cfg["views"], ctx.seed)
        self.lrs = cfg["group_lrs"]

    def target(self, ctx) -> dict:
        p = ctx.params
        return site.jittered(self.fields, ctx.config["scene_seed"] + 1,
                             p["target_colour_jitter"],
                             p["target_opacity_jitter"])


def reference_inputs(ctx, device, views):
    """The fields, the reference's cameras of ``views`` (indices) and their
    target renders, by the reference alone."""
    inp = Inputs(ctx, device)
    _, cams = port.cameras(inp.views, inp.width, inp.height,
                           ctx.config["focal_mm"], device, program=False)
    cams = [cams[int(v)] for v in views]
    target = inp.target(ctx)
    block = ctx.params["ref_block"]
    with torch.no_grad():
        targets = [rb.render(target, c, block=block)["rgb"] for c in cams]
    del target
    port.free()
    return inp, cams, targets


class RankCtx:
    """What a rank other than 0 is given of rank 0's context: the cell's
    and its configuration's files as rank 0 read them, the seed and the
    device; its host spans stay off."""

    def __init__(self, spec: dict, device):
        self.cell, self.seed = spec["cell"], int(spec["seed"])
        self.workload, self.config = spec["workload"], spec["config"]
        self.params = self.workload["params"]
        self.limits = self.workload.get("limits", {})
        self.device = device
        self.spans = trace.Spans()

    @staticmethod
    def log(msg: str) -> None:
        sys.stderr.write(msg + "\n")       # one write: ranks share the pipe
        sys.stderr.flush()


class Ranks:
    """Ranks 1 .. n - 1 as child processes of rank 0, and rank 0's watch
    over them (module docstring)."""

    def __init__(self, ctx, world: int, init: str):
        self.done = False
        self.procs = []
        spec = registry.ROOT / "build" / "mesh" / (
            init.rsplit("/", 1)[1] + ".json")
        spec.write_text(json.dumps({"cell": ctx.cell, "seed": ctx.seed,
                                    "workload": ctx.workload,
                                    "config": ctx.config}))
        self.spec = spec
        dev = "cpu" if ctx.device.type == "cpu" else "cuda"
        for rank in range(1, world):
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", MODULE, "--spec", str(spec),
                 "--rank", str(rank), "--world", str(world), "--init", init,
                 "--device", dev],
                cwd=str(registry.ROOT), stdin=subprocess.PIPE,
                stdout=sys.stderr.fileno(), text=True))
        self._hook = sys.excepthook
        sys.excepthook = self._excepthook
        threading.Thread(target=self._watch, daemon=True).start()

    def abort(self, why: str) -> None:
        """Kill every rank, this one last."""
        print(f"perfbench: {why}; stopping every rank", file=sys.stderr,
              flush=True)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)

    def _excepthook(self, kind, value, tb) -> None:
        self._hook(kind, value, tb)
        self.abort("rank 0 failed")

    def _watch(self) -> None:
        while True:
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code is not None and (code != 0 or not self.done):
                    self.abort(f"rank {r} exited with code {code}")
            time.sleep(0.2)

    def send(self, cmd: str) -> None:
        try:
            for p in self.procs:
                p.stdin.write(cmd + "\n")
                p.stdin.flush()
        except OSError as e:
            self.abort(f"a rank no longer reads its commands ({e})")

    def close(self) -> None:
        """End the process group with the other ranks, as every rank must
        at once, and wait for them to exit."""
        self.done = True
        self.send("exit")
        if not _end_group(EXIT_WAIT_S):
            self.abort("the process group did not end")
        t0 = time.monotonic()
        for r, p in enumerate(self.procs, 1):
            try:
                p.wait(timeout=max(1.0, EXIT_WAIT_S - (time.monotonic()
                                                       - t0)))
            except subprocess.TimeoutExpired:
                self.abort(f"rank {r} did not exit")
        sys.excepthook = self._hook
        self.spec.unlink(missing_ok=True)


def _end_group(timeout_s: float) -> bool:
    """``destroy_process_group`` (every rank calls it at the same time),
    given ``timeout_s``; whether it ended."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return True
    t = threading.Thread(target=dist.destroy_process_group, daemon=True)
    t.start()
    t.join(timeout_s)
    return not t.is_alive()


def _need_program():
    """The program's sharded step with the layouts this cell asks for, or a
    clear error before any rank starts."""
    from sage3d_tpu_torch.parallel import train
    if "gather" not in inspect.signature(train.make_train_step).parameters:
        raise RuntimeError("the program's make_train_step has no 'gather' "
                           "argument: it cannot run this cell's layout")


def _rendezvous() -> str:
    """A fresh ``file://`` rendezvous inside the checkout's build folder."""
    d = registry.ROOT / "build" / "mesh"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"rendezvous-{os.getpid()}-{time.time_ns()}"
    path.unlink(missing_ok=True)
    return f"file://{path}"


class Session:
    """One rank's part of the cell. ``ranks``: rank 0's children (None on
    the others)."""

    def __init__(self, ctx, rank: int, world: int, init: str, ranks=None):
        from sage3d_tpu_torch.parallel.mesh import (initialize_distributed,
                                                    make_mesh)
        from sage3d_tpu_torch.parallel.train import (Optimizer,
                                                     init_train_state,
                                                     make_train_step,
                                                     pad_scene_to)
        from sage3d_tpu_torch.renderer.camera import slice_cameras
        from sage3d_tpu_torch.renderer.render import (autotune_poses,
                                                      budget_kwargs, render)
        self.ctx, self.ranks, self.rank = ctx, ranks, rank
        cfg, p = ctx.config, ctx.params
        dev = initialize_distributed(init, world, rank, device=ctx.device,
                                     timeout_s=p["rank_timeout_s"])
        self.dev = dev
        self.mesh = make_mesh(tuple(p["mesh"]), device=dev,
                              timeout_s=p["rank_timeout_s"])
        n_tile = self.mesh.shape["tile"]
        self.band = self.mesh.axis_index("tile")
        inp = Inputs(ctx, dev)
        self.width, self.height = inp.width, inp.height
        self.order, self.lrs = inp.order, inp.lrs
        tiles_h = -(-self.height // 32)             # the step's 32-row tiles
        self.band_h = -(-tiles_h // n_tile) * 32
        self.y0 = self.band * self.band_h
        self.cams, self.ref_cams = port.cameras(
            inp.views, self.width, self.height, cfg["focal_mm"], dev)
        band_cams = self.cams._replace(cy=self.cams.cy - self.y0,
                                       height=self.band_h)
        frame = (self.width, self.height)
        buckets = p["grad_buckets"]
        scene = pad_scene_to(port.gaussian_scene(inp.fields),
                             n_tile * buckets)
        n = scene.num_gaussians
        self.sem = scene.semantic_ids
        budgets = autotune_poses(scene, band_cams,
                                 pair_margin=p["pair_margin"],
                                 grad_margin=p["grad_margin"],
                                 clamp_dims=frame)
        self.bk = budget_kwargs(budgets)
        # this band's rows of each view's target, in a frame of the band grid
        tscene = pad_scene_to(port.gaussian_scene(inp.target(ctx)),
                              n_tile * buckets)
        self.targets = torch.zeros((cfg["views"], n_tile * self.band_h,
                                    self.width, 3), device=dev)
        over = torch.zeros((), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for v in range(cfg["views"]):
                out = render(tscene, slice_cameras(band_cams, slice(v, v + 1)),
                             backend="cuda", clamp_dims=frame, **self.bk)
                self.targets[v, self.y0:self.y0 + self.band_h] = out["rgb"][0]
                over += out["overflow"].sum()
        self.overflow = over
        del tscene, out
        self.views = [slice_cameras(self.cams, slice(v, v + 1))
                      for v in range(cfg["views"])]
        # the 3DGS group rates of the configuration, as the reference's
        self.opt = Optimizer(group_lrs=dict(cfg["group_lrs"]))
        self.state = init_train_state(scene, self.opt, self.mesh)
        start = {k: v.detach().clone() for k, v in self.state.params.items()}
        # the step reads only the template's semantic ids and shapes: a
        # template of one expanded row keeps the full scene off the card
        light = scene._replace(**{k: getattr(scene, k)[:1].clone().expand(
            (n,) + tuple(getattr(scene, k).shape[1:]))
            for k in ("means", "log_scales", "quats", "opacity_logits", "sh")})
        del scene, inp
        port.free()
        self.step, _ = make_train_step(
            light, self.cams, mesh=self.mesh, optimizer=self.opt,
            backend="cuda", grad_buckets=buckets, gather=p["gather"],
            **self.bk)
        self.i = 0
        self.losses = []
        for k in range(p["warmup_steps"]):
            loss = self._step()["loss"]
            if k < CHECKED_STEPS:
                self.losses.append(loss)
            if k == 0:
                self.grad1 = self._first_grad_norms()
            if k == CHECKED_STEPS - 1:
                self.change = self._sum_groups(
                    lambda g, x: (x.detach() - start[g]).double().pow(2)
                    .sum())
                del start
        self.losses = [float(x) for x in self.losses]

    # -- the step -------------------------------------------------------------
    def _step(self) -> dict:
        v = int(self.order[self.i % len(self.order)])
        self.i += 1
        with self.ctx.spans("train_step"):
            self.state, loss = self.step(self.state, self.views[v],
                                         self.targets[v:v + 1])
        return {"view": v, "loss": loss}

    def unit(self) -> dict:
        if self.ranks is not None:
            self.ranks.send("unit")
        return self._step()

    def sync(self) -> None:
        port.sync(self.dev)

    def _sum_groups(self, fn) -> dict:
        """Each group's 2-norm over every rank's shard: ``fn(group, shard)``
        is the shard's sum of squares (float64)."""
        import torch.distributed as dist
        parts = torch.stack([fn(g, x) for g, x in
                             self.state.params.items()])
        if dist.is_initialized():
            dist.all_reduce(parts)
        return {g: float(s) ** 0.5 for g, s in zip(self.state.params,
                                                  parts.tolist())}

    def _first_grad_norms(self) -> dict:
        """Each group's gradient as Adam holds it after its first step:
        exp_avg / (1 - b1), over every shard."""
        opt = self.state.opt_state
        m = {grp["name"]: (opt.state[grp["params"][0]]["exp_avg"],
                           grp["betas"][0]) for grp in opt.param_groups}
        return self._sum_groups(lambda g, x: (m[g][0].double()
                                              / (1.0 - m[g][1])).pow(2).sum())

    # -- what the benchmark reads --------------------------------------------
    def work(self, records) -> dict:
        return {"units": len(records), "steps": len(records),
                "pixels": len(records) * self.width * self.height}

    def end_to_end(self, records, window_s: float) -> dict:
        px = self.work(records)["pixels"]
        return {"train_mpix_s": stats.rate(px / 1e6, window_s)}

    def gather_live(self):
        """Every rank's shard of the live parameters, group by group, kept
        on rank 0 (None on the others): the state as it stands. An
        all-gather, which NCCL and the card's gloo both take."""
        import torch.distributed as dist
        out = {}
        for g, x in self.state.params.items():
            x = x.detach().contiguous()
            parts = [torch.empty_like(x) for _ in range(self.mesh.size)]
            if dist.is_initialized():
                dist.all_gather(parts, x)
            else:
                parts = [x]
            if self.rank == 0:
                out[g] = torch.cat(parts)
            del parts
        return out if self.rank == 0 else None

    def trace_extra(self, records) -> dict:
        """K3's least work for the traced steps on rank 0's band: the
        reference's counts on the state the stretch left."""
        self.ranks.send("gather")
        fields = dict(self.gather_live(), semantic_ids=self.sem)
        k3 = 0.0
        with torch.no_grad():
            for r in records:
                c = rb.render(fields, self.ref_cams[r["view"]],
                              block=self.ctx.params["ref_block"],
                              band=(self.y0, self.band_h),
                              count=True)["counts"]
                k3 += rc.k3_seconds(*c)
        del fields
        port.free()
        return {"k3_least_s": k3}

    def window_overflow(self):
        """Pairs the budgets drop on the state the window left: every
        view's band rendered from the gathered splats, summed here."""
        from sage3d_tpu_torch.ops.projection import project_gaussians
        from sage3d_tpu_torch.parallel.mesh import shard_rows
        from sage3d_tpu_torch.parallel.train import (all_gather_bucketed,
                                                     band_splats, pack_splats)
        from sage3d_tpu_torch.renderer.render import render_projected
        from sage3d_tpu_torch.renderer.scene import GaussianScene
        p = self.ctx.params
        sem = self.sem
        shard = GaussianScene(**{k: v.detach() for k, v in
                                 self.state.params.items()},
                              semantic_ids=shard_rows(sem, self.mesh,
                                                      "tile"))
        over = torch.zeros((), dtype=torch.int64, device=self.dev)
        with torch.no_grad():
            for cam in self.views:
                proj = project_gaussians(shard, cam,
                                         clamp_dims=(self.width, self.height))
                diff, meta = pack_splats(proj)
                full = all_gather_bucketed(diff, self.mesh, "tile",
                                           p["grad_buckets"])
                full_meta = all_gather_bucketed(meta, self.mesh, "tile",
                                                p["grad_buckets"])
                splats = band_splats(full, full_meta, 1, self.y0, self.band_h)
                out = render_projected(
                    splats, sem, cam._replace(cy=cam.cy - self.y0,
                                              height=self.band_h),
                    backend="cuda", **self.bk)
                over += out["overflow"].sum()
        return over

    def check_part(self):
        """Every rank: the pairs dropped on the targets and on the window's
        state, summed over the ranks; then this rank's state freed."""
        import torch.distributed as dist
        if self.dev.type == "cuda":
            self.ctx.log(f"perfbench: rank {self.rank} peak memory "
                         f"{torch.cuda.max_memory_allocated(self.dev)} bytes")
        over = self.overflow + self.window_overflow()
        if dist.is_initialized():
            dist.all_reduce(over)
        over = int(over)
        del self.state, self.step, self.targets
        port.free()
        return over

    def check(self) -> list:
        """Free every rank's state and end ranks 1 .. n - 1, then run the
        reference's three steps here."""
        t0 = time.perf_counter()
        self.ranks.send("check")
        overflow = self.check_part()
        self.ranks.close()
        port.free()
        t1 = time.perf_counter()
        views = self.order[:CHECKED_STEPS]
        inp, cams, targets = reference_inputs(self.ctx, self.dev, views)
        t2 = time.perf_counter()
        ref = rb.fit_steps(inp.fields, targets, cams, self.lrs,
                           block=self.ctx.params["ref_block"])
        self.ctx.log(f"perfbench: check: ranks' overflow and exit "
                     f"{t1 - t0:.3f} s, reference targets {t2 - t1:.3f} s, "
                     f"reference steps {time.perf_counter() - t2:.3f} s")
        return _fit().compare({"loss": self.losses, "grad": self.grad1,
                               "change": self.change, "overflow": overflow},
                              ref, self.ctx.limits)


def setup(ctx) -> Session:
    _need_program()
    world = math.prod(ctx.params["mesh"])
    init = _rendezvous()
    ranks = Ranks(ctx, world, init)
    return Session(ctx, 0, world, init, ranks)


def control(ctx) -> list:
    """The reference in bfloat16 put in the program's place: its three
    steps against the float32 reference's, by the cell's comparison (on
    one card: the reference needs no mesh)."""
    p = ctx.params
    views = hs.order(ctx.config["views"], ctx.seed)[:CHECKED_STEPS]
    inp, cams, targets = reference_inputs(ctx, ctx.device, views)
    ref = rb.fit_steps(inp.fields, targets, cams, inp.lrs,
                       block=p["ref_block"])
    low = rb.fit_steps(inp.fields, targets, cams, inp.lrs,
                       dtype=torch.bfloat16, block=p["ref_block"])
    if ctx.device.type == "cuda":
        ctx.log(f"perfbench: the reference's peak memory "
                f"{torch.cuda.max_memory_allocated(ctx.device) / 2**30:.2f}"
                " GiB")
    return _fit().compare(dict(low, overflow=0), ref, ctx.limits)


def faults(ctx) -> dict:
    """What the check reads of each fault a train step can have, planted in
    the reference put in the program's place."""
    from perfbench.reference import train as rt
    p = ctx.params
    views = hs.order(ctx.config["views"], ctx.seed)[:CHECKED_STEPS]
    inp, cams, targets = reference_inputs(ctx, ctx.device, views)
    ref = rb.fit_steps(inp.fields, targets, cams, inp.lrs,
                       block=p["ref_block"])
    return {f: _fit().compare(dict(rb.fit_steps(
        inp.fields, targets, cams, inp.lrs, fault=f, block=p["ref_block"]),
        overflow=0), ref, ctx.limits) for f in rt.FAULTS}


# -- ranks 1 .. n - 1 --------------------------------------------------------

def _watch_parent() -> None:
    """Exit when rank 0's process goes away: the kernel's parent-death
    signal, and a watch on the parent for where that is not to be had."""
    parent = os.getppid()
    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)     # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def rank_main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one rank of a mesh cell")
    for a in ("--spec", "--init", "--device"):
        ap.add_argument(a, required=True)
    for a in ("--rank", "--world"):
        ap.add_argument(a, type=int, required=True)
    args = ap.parse_args(argv)
    _watch_parent()
    try:
        torch.set_num_threads(1)
        with open(args.spec) as f:
            ctx = RankCtx(json.load(f), torch.device(args.device))
        session = Session(ctx, args.rank, args.world, args.init)
        for line in sys.stdin:
            cmd = line.strip()
            if cmd == "unit":
                session._step()
            elif cmd == "gather":
                session.gather_live()
            elif cmd == "check":
                session.check_part()
            elif cmd == "exit":
                break
            else:
                raise RuntimeError(f"unknown command {cmd!r}")
        _end_group(EXIT_WAIT_S)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    rank_main()
