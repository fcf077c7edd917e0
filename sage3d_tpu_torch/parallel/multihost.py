"""Multi-host execution of the sharded train step: separate processes, one
per rank, joined only through ``torch.distributed``.

PyTorch counterpart of ``sage3d_tpu/parallel/multihost.py``. A "host" is a
block of ``ranks_per_host`` consecutive ranks; the mesh is (hosts x ranks a
host), so "data" runs across hosts and "tile" within one. Each host derives
the same global episode table, keeps only its own episodes
(``process_local_episodes``), builds only their cameras and targets, and
feeds them to the mesh through ``global_batch_from_local``.

``dryrun_multihost()`` starts one OS process per rank
(``python -m sage3d_tpu_torch.parallel.multihost --rank ...``), each given
its rank, the world size and a ``file://`` rendezvous, as separate hosts
would be, and runs the sharded step on targets rendered from the scene
itself, from a start with seeded noise on its colours and opacities (the
JAX dry run fits random targets). It checks what the JAX dry run checks:
every rank reports the same losses, the hosts' episode slices partition the
table, and the collectives of a step meet the audit's minimum; and, on rank
0, that the first step's gathered gradients agree with the direct step's on
the whole batch.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

GRAD_REL = 5e-4         # sharded vs direct first-step gradients, of the max


def _episode_table(n_episodes: int) -> List[Dict]:
    """A small deterministic global episode list every host derives
    identically (hosts never exchange episode data)."""
    return [{"episode_id": f"ep-{i:03d}", "start_xy": (-3.0 + 0.5 * i, -4.0),
             "yaw": 1.5 + 0.05 * i} for i in range(n_episodes)]


def _camera(ep: Dict, width: int, height: int, device):
    """An episode's camera: the agent's at ``start_xy``/``yaw``, or a free
    camera at ``position`` looking along ``forward``."""
    from ..renderer.camera import agent_camera, make_camera
    if "position" in ep:
        return make_camera(ep["position"], ep["forward"], width=width,
                           height=height, focal_mm=ep.get("focal_mm", 8.0),
                           device=device)
    return agent_camera(ep["start_xy"], yaw=ep["yaw"], width=width,
                        height=height, device=device)


class _Clock:
    """Milliseconds of a call: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn):
        import torch
        if self.cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            return out, a.elapsed_time(b)
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3


def worker_main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--ranks-per-host", type=int, required=True)
    p.add_argument("--init-method", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-gauss", type=int, default=256)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--episodes", default=None,
                   help="JSON file of the global episode table")
    p.add_argument("--timeout-s", type=float, default=300.0)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..ops import binning, composite_cuda, segreduce
    from ..renderer.camera import stack_cameras
    from ..renderer.render import autotune_poses, budget_kwargs, render
    from ..renderer.scene import synthetic_room
    from .mesh import (all_gather, global_batch_from_local,
                       initialize_distributed, make_mesh,
                       process_local_episodes)
    from .sharded_render import render_tile_sharded
    from .train import (TRAINABLE, init_train_state, make_group_optimizer,
                        make_train_step, pad_scene_to, with_params)

    dev = initialize_distributed(args.init_method, args.world_size,
                                 args.rank, device=args.device,
                                 timeout_s=args.timeout_s)
    if dev.type == "cpu":       # the ranks share the host's cores
        torch.set_num_threads(1)
    rph = args.ranks_per_host
    n_hosts = args.world_size // rph
    host = args.rank // rph
    mesh = make_mesh((n_hosts, rph), device=dev, timeout_s=args.timeout_s)
    backend = "cuda" if dev.type == "cuda" else "torch"
    w, h = args.width, args.height

    # --- host-local episode sharding -----------------------------------------
    if args.episodes:
        with open(args.episodes) as f:
            episodes = json.load(f)
    else:
        episodes = _episode_table(2 * n_hosts)
    mine = process_local_episodes(episodes, process_index=host,
                                  process_count=n_hosts)

    # --- the scene, its budgets and this host's batch -------------------------
    room = pad_scene_to(synthetic_room(args.n_gauss, seed=args.seed,
                                       device=dev), rph * 4)
    rng = np.random.default_rng(args.seed)
    start = room._replace(
        sh=room.sh + torch.from_numpy(rng.normal(
            0.0, 1.0, tuple(room.sh.shape)).astype(np.float32)).to(dev),
        opacity_logits=room.opacity_logits + torch.from_numpy(rng.normal(
            0.0, 0.5, tuple(room.opacity_logits.shape)).astype(
                np.float32)).to(dev))
    all_cams = stack_cameras([_camera(ep, w, h, dev) for ep in episodes])
    bk = budget_kwargs(autotune_poses(room, all_cams, pair_margin=1.5,
                                      grad_margin=1.5 if backend == "cuda"
                                      else None))
    local_cams = stack_cameras([_camera(ep, w, h, dev) for ep in mine])
    with torch.no_grad():
        local_targets = torch.stack([
            render(room, c, backend=backend, **bk)["rgb"]
            for c in (_camera(ep, w, h, dev) for ep in mine)])
    cams = global_batch_from_local(mesh, local_cams)
    targets = global_batch_from_local(mesh, local_targets)

    # --- the sharded train step over the (hosts x ranks a host) mesh ---------
    opt = make_group_optimizer(extent=1.0)
    step, _ = make_train_step(start, cams, mesh, optimizer=opt,
                              backend=backend, grad_buckets=4, **bk)
    state = init_train_state(start, opt, mesh)
    clock = _Clock(dev)
    kernels = {"emit": binning.emit_tile_pairs,
               "composite_fwd": composite_cuda.composite_fwd,
               "composite_bwd": composite_cuda.composite_bwd,
               "segreduce": segreduce.segment_reduce_sorted}
    for fn in kernels.values():
        fn.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, grads = [], [], None
    for i in range(args.steps):
        last = i == args.steps - 1
        mesh.counter.reset()
        mesh.counter.timed = last       # the last step: collective times
        (state, loss), ms = clock(lambda: step(state, cams, targets))
        mesh.counter.timed = False
        losses.append(float(loss))
        step_ms.append(ms)
        if i == 0:
            written = mesh.counter.counts(apart=("loss",))
            grads = {k: all_gather(state.params[k].grad, mesh, "tile")
                     for k in TRAINABLE}
    launches = {k: fn.launches for k, fn in kernels.items()}
    summary = mesh.counter.summary()    # the last step's collectives
    peak = (torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None)
    _, adam_ms = clock(state.opt_state.step)

    with torch.no_grad():
        last_scene = with_params(start, {k: all_gather(
            v.detach(), mesh, "tile") for k, v in state.params.items()})
        overflow = [int(render_tile_sharded(s, c, mesh, backend=backend,
                                            **bk)["overflow"])
                    for s in (start, last_scene)
                    for c in (_camera(ep, w, h, dev) for ep in episodes)]

    report = {
        "rank": args.rank, "host": host, "world_size": args.world_size,
        "mesh": dict(mesh.shape), "transport": mesh.transport,
        "device": str(dev),
        "episodes_local": [ep["episode_id"] for ep in mine],
        "losses": losses, "step_ms": step_ms, "adam_ms": adam_ms,
        "written_collectives": written,
        "collectives_last_step": summary,
        "shard_rows": {k: int(v.shape[0]) for k, v in state.params.items()},
        "total_rows": start.num_gaussians,
        "overflow_first_last": overflow, "launches": launches,
        "peak_memory": peak, "budgets": bk,
    }
    # rank 0: the direct step on the whole batch from the same start
    if args.rank == 0:
        g_targets = torch.stack([render(room, c, backend=backend, **bk)["rgb"]
                                 for c in (_camera(ep, w, h, dev)
                                           for ep in episodes)])
        d_step, _ = make_train_step(start, all_cams, optimizer=opt,
                                    backend=backend, **bk)
        d_state = init_train_state(start, opt)
        d_ms = []
        for i in range(max(args.steps, 1)):
            (d_state, _), ms = clock(lambda: d_step(d_state, all_cams,
                                                    g_targets))
            d_ms.append(ms)
            if i == 0:
                report["grad_rel"] = {
                    k: float((grads[k] - d_state.params[k].grad).abs().max())
                    / max(float(d_state.params[k].grad.abs().max()), 1e-30)
                    for k in TRAINABLE}
        report["direct_step_ms"] = d_ms
        report["direct_step_median_ms"] = statistics.median(d_ms[2:] or d_ms)
    mesh.barrier()
    print("MULTIHOST_RESULT " + json.dumps(report), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()


def dryrun_multihost(num_hosts: int = 2, ranks_per_host: int = 2,
                     n_gauss: int = 256, image=64, steps: int = 2,
                     device=None, timeout_s: float = 600.0, seed: int = 3,
                     episodes: Optional[List[Dict]] = None) -> Dict:
    """Start ``num_hosts * ranks_per_host`` OS processes, one per rank, and
    run ``steps`` sharded train steps over the (hosts x ranks a host) mesh
    on ``synthetic_room(n_gauss, seed)`` at ``image`` (a side, or (width,
    height)). ``episodes``: the global episode table (agent ``start_xy`` and
    ``yaw``, or a camera ``position`` and ``forward``); default 2 a host.
    ``device`` None: the card. Returns the merged report; raises when a rank
    fails or times out, when the ranks disagree on the loss, when the
    episode slices do not partition the table, when a step issues fewer
    collectives than the audit's minimum, or when the first step's
    gradients differ from the direct step's by more than ``GRAD_REL`` of
    their max."""
    from ..renderer.scene import resolve_device
    dev = resolve_device(device)
    width, height = (image, image) if isinstance(image, int) else image
    world = num_hosts * ranks_per_host
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    table = episodes if episodes is not None else _episode_table(
        2 * num_hosts)
    with tempfile.TemporaryDirectory(prefix="sage3d_multihost_") as tmp:
        ep_file = os.path.join(tmp, "episodes.json")
        with open(ep_file, "w") as f:
            json.dump(table, f)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "sage3d_tpu_torch.parallel.multihost",
             "--rank", str(r), "--world-size", str(world),
             "--ranks-per-host", str(ranks_per_host),
             "--init-method", f"file://{tmp}/rendezvous",
             "--device", dev.type, "--n-gauss", str(n_gauss),
             "--width", str(width), "--height", str(height),
             "--steps", str(steps), "--seed", str(seed),
             "--episodes", ep_file, "--timeout-s", str(timeout_s)],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        reports, failures = [], []
        deadline = time.monotonic() + timeout_s
        try:
            for r, p in enumerate(procs):
                try:
                    out, _ = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    failures.append(f"rank {r}: no result after {timeout_s} "
                                    f"s\n{out[-2000:]}")
                    continue
                line = [x for x in out.splitlines()
                        if x.startswith("MULTIHOST_RESULT ")]
                if p.returncode != 0 or not line:
                    failures.append(f"rank {r}: rc={p.returncode}\n"
                                    f"{out[-2000:]}")
                    deadline = time.monotonic()   # the others will not finish
                    continue
                reports.append(json.loads(line[-1][len("MULTIHOST_RESULT "):]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    if failures:
        raise RuntimeError("multihost dry run failed:\n" + "\n".join(failures))

    losses = [tuple(r["losses"]) for r in reports]
    if len(set(losses)) != 1:
        raise RuntimeError(f"ranks disagree on the loss: {losses}")
    by_host = [reports[h * ranks_per_host]["episodes_local"]
               for h in range(num_hosts)]
    flat = [e for eps in by_host for e in eps]
    same_in_host = all(r["episodes_local"] == by_host[r["host"]]
                       for r in reports)
    if not same_in_host or sorted(flat) != sorted(
            ep["episode_id"] for ep in table) or len(set(flat)) != len(flat):
        raise RuntimeError(f"episode slices do not partition the table: "
                           f"{by_host}")
    wc = reports[0]["written_collectives"]
    if wc.get("all_gather", 0) < 20 or wc.get("reduce_scatter", 0) < 20:
        raise RuntimeError(f"a step issued too few collectives: {wc}")
    bad = {k: v for k, v in reports[0]["grad_rel"].items() if v > GRAD_REL}
    if bad:
        raise RuntimeError(f"first-step gradients differ from the direct "
                           f"step's by more than {GRAD_REL} of the max: {bad}")
    return {"num_hosts": num_hosts, "ranks_per_host": ranks_per_host,
            "losses": list(losses[0]), "episodes_by_host": by_host,
            "written_collectives": wc, "ranks": reports, "ok": True}


if __name__ == "__main__":
    worker_main()
