#!/usr/bin/env python3
"""Drive the PyTorch port's forward render path on one CUDA card, at full size.

    python3 chip_smoke.py

Phases, in order (any failed check makes the script exit non-zero and print
no result line):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from ``sage3d_tpu_torch/csrc`` with nvcc,
     one process per source, all at once;
  3. K1 (``csrc/emit.cu``) against its plain PyTorch version on the emission
     tables of the 1080p frame of a 1M-Gaussian scene, fused key (mult > 0)
     and two-key (mult == 0) modes: the keys must be equal;
  4. K2 (``csrc/composite_fwd.cu``) against its plain version on the same
     binned frame, with the tolerances stated below;
  5. the main path: ``render(backend="cuda")`` on three frames (1920x1080
     and 3840x2160 of the 1M-Gaussian room, and the 640x480 agent view of a
     200k room; ``smoke_frames``) with
     ``autotune_all(pair_margin=1.05)`` budgets, each with its launch
     counters set to 0 just before and read just after; overflow must be 0.
     The 1080p frame is also rendered by the ``torch`` backend, and a small
     frame is held against the exact per-pixel oracle;
  6. times: per-stage medians over 20 runs after 3 warm-ups (CUDA events);
     the device's busy time per frame and per stage, from torch.profiler
     traces (CUDA activity only) of unsynchronized loops, and the idle share
     of a ``render()`` frame; each kernel against its plain version at the
     1080p frame, with the least time the card could take for the same work.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# Tolerances of the kernels against their plain versions on the card.
K2_ATOL = 2e-4          # rgb, alpha, trans: f32 sums in another order
K2_DEPTH_TOL = 1e-3     # depth_acc (rtol and atol): depths reach ~50
SEM_MIN = 0.995         # semantic agreement: near-equal weights may swap
KEND_MAX_DIFF = 0.001   # share of tiles whose k_end may differ
BACKEND_ATOL = 5e-4     # cuda vs torch backend: log-space vs product blend

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per unit of work, counted from the kernels' source:
# K1, one live slot: the reciprocal walk with its fixup, the tile rect, four
# edge minima of the conic quadratic, the cull test and the key (~90).
# K2, one pair-pixel evaluation: the quadratic (10), the exp (counted as 4),
# the clamps and cutoff (4), w and the five accumulations (11), the best
# test (1) and the transmittance update (2).
K1_OPS_PER_SLOT = 90
K2_OPS_PER_EVAL = 32

FAILURES: list = []
PROFILE_REPS = 10       # frames per torch.profiler trace


def check(ok: bool, what: str) -> None:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events around
    each run, after ``warmup`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def smoke_frames(device) -> dict:
    """The three frames, as label -> (scene, camera):

      a: ``synthetic_room(1_000_000, seed=0)`` at 1920x1080 with bench.py's
         camera (2040 tiles: the fused-key sort);
      b: the same room and camera at 3840x2160 (8160 tiles: the two-key sort);
      c: ``synthetic_room(200_000, seed=7)`` at 640x480 from
         ``agent_camera((0, -3.5), yaw=1.57)``, the README's env frame.
    """
    from sage3d_tpu_torch.renderer.camera import agent_camera, make_camera
    from sage3d_tpu_torch.renderer.scene import synthetic_room
    room = synthetic_room(1_000_000, seed=0, device=device)
    bench_cam = dict(position=[0.0, -6.0, 1.5], forward=[0.0, 1.0, -0.05],
                     focal_mm=14.0, device=device)
    return {
        "a_1080p_1M": (room, make_camera(width=1920, height=1080, **bench_cam)),
        "b_4k_1M": (room, make_camera(width=3840, height=2160, **bench_cam)),
        "c_env_640x480_200k": (
            synthetic_room(200_000, seed=7, device=device),
            agent_camera((0.0, -3.5), yaw=1.57, width=640, height=480,
                         device=device)),
    }


def device_busy(fn, reps: int = PROFILE_REPS):
    """Device time per call of ``fn`` in ms, the kernels and copies per call,
    and the kernels that took the most device time, as [name, ms per call,
    launches per call]. From a torch.profiler trace with CUDA activity only
    (no host tracing) of ``reps`` calls, unsynchronized between calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def us(e):
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    top = [[e.key[:72], us(e) / 1e3 / reps, e.count / reps]
           for e in sorted(evts, key=us, reverse=True)[:6]]
    return (sum(us(e) for e in evts) / 1e3 / reps,
            sum(e.count for e in evts) / reps, top)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2

    from sage3d_tpu_torch.ops import _build, binning, composite_cuda
    from sage3d_tpu_torch.ops.projection import project_gaussians
    from sage3d_tpu_torch.renderer.camera import make_camera
    from sage3d_tpu_torch.renderer.render import (autotune_all, budget_kwargs,
                                                  render)
    from sage3d_tpu_torch.renderer.scene import synthetic_room

    # 1. device ---------------------------------------------------------------
    smi = nvidia_smi_line()
    card = f"[{smi}]"
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"total {time.perf_counter() - t0:.2f} s", flush=True)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    frames = smoke_frames(device=dev)
    print(f"scenes built in {time.perf_counter() - t0:.1f} s", flush=True)
    budgets = {}
    for key, (scene, cam) in frames.items():
        budgets[key] = autotune_all(scene, cam, pair_margin=1.05)
        print(f"budgets {key}: {json.dumps(budgets[key])}", flush=True)

    scene_a, cam_a = frames["a_1080p_1M"]
    bk_a = budget_kwargs(budgets["a_1080p_1M"])
    with torch.no_grad():
        proj_a = project_gaussians(scene_a, cam_a)
        emit_kw = {k: bk_a[k] for k in binning.EMIT_BUDGET_KEYS}
        plan = binning.emission_plan(proj_a, cam_a.width, cam_a.height,
                                     **emit_kw)
        bins_a = binning.bin_gaussians(proj_a, cam_a.width, cam_a.height,
                                       **emit_kw)

    # 3. K1 against its plain version -----------------------------------------
    n_tiles_a = plan.tiles_x * plan.tiles_y
    k1_equal = True
    for mult in (plan.mult, 0):
        for i, t in enumerate(plan.tiers):
            got = binning.emit_tile_keys(t.attrs, t.rank, t.k_budget,
                                         plan.tiles_x, n_tiles_a, mult)
            want = binning.emit_tile_keys_plain(t.attrs, t.rank, t.k_budget,
                                                plan.tiles_x, n_tiles_a, mult)
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            k1_equal &= n_diff == 0
            print(f"K1 tier {i} (k={t.k_budget}, n={t.attrs.shape[1]}, "
                  f"mult={mult}): {n_diff} keys differ", flush=True)
    check(plan.mult > 0, "frame a takes the fused-key path")
    check(k1_equal, "K1 keys equal the plain version's (fused and two-key)")

    # 4. K2 against its plain version -----------------------------------------
    attrs_a = composite_cuda.attribute_table(proj_a, scene_a.semantic_ids)
    pg, start, count, _ = composite_cuda.trim_to_capacity(
        bins_a, bk_a["pair_capacity"])
    count = torch.clamp(count, max=bk_a["tile_capacity"])
    k2_args = (attrs_a, pg, start, count, plan.tiles_x)
    out_k, kend_k = composite_cuda.composite_fwd(*k2_args)
    out_p, kend_p = composite_cuda.composite_fwd_plain(*k2_args)
    torch.cuda.synchronize()
    k2_err = max(float((out_k[:, ch] - out_p[:, ch]).abs().max())
                 for ch in (0, 1, 2, 4, 5))
    depth_ok = bool(torch.allclose(out_k[:, 3], out_p[:, 3], rtol=K2_DEPTH_TOL,
                                   atol=K2_DEPTH_TOL))
    sem_agree = float((out_k[:, 7] == out_p[:, 7]).float().mean())
    kend_diff = int((kend_k != kend_p).sum())
    print(f"K2 vs plain: max_abs rgb/alpha/trans {k2_err:.3e}, semantic "
          f"agreement {sem_agree:.6f}, k_end differs on {kend_diff} of "
          f"{n_tiles_a} tiles, sum k_end {int(kend_k.sum())}", flush=True)
    check(k2_err <= K2_ATOL, f"K2 rgb/alpha/trans within {K2_ATOL}")
    check(depth_ok, f"K2 depth_acc within rtol=atol={K2_DEPTH_TOL}")
    check(sem_agree >= SEM_MIN, f"K2 semantic agreement >= {SEM_MIN}")
    check(kend_diff <= KEND_MAX_DIFF * n_tiles_a,
          f"K2 k_end differs on <= {KEND_MAX_DIFF:.1%} of tiles")

    # 5. the main path ----------------------------------------------------------
    launches = {"emit": 0, "composite_fwd": 0}
    outs = {}
    for key, (scene, cam) in frames.items():
        bk = budget_kwargs(budgets[key])
        binning.emit_tile_keys.launches = 0
        composite_cuda.composite_fwd.launches = 0
        with torch.no_grad():
            out = render(scene, cam, backend="cuda", **bk)
        torch.cuda.synchronize()
        n_emit = binning.emit_tile_keys.launches
        n_comp = composite_cuda.composite_fwd.launches
        launches["emit"] += n_emit
        launches["composite_fwd"] += n_comp
        outs[key] = out
        finite = all(bool(torch.isfinite(out[k]).all())
                     for k in ("rgb", "depth", "alpha", "trans"))
        shape_ok = out["rgb"].shape == (cam.height, cam.width, 3)
        hit = float((out["semantic"] >= 0).float().mean())
        print(f"frame {key}: overflow {int(out['overflow'])}, grad_chunks "
              f"{int(out['grad_chunks'])}, launches K1 {n_emit} K2 {n_comp}, "
              f"mean rgb {float(out['rgb'].mean()):.4f}, covered {hit:.3f}",
              flush=True)
        check(int(out["overflow"]) == 0, f"frame {key}: overflow == 0")
        check(finite and shape_ok, f"frame {key}: finite outputs of shape "
              f"({cam.height}, {cam.width})")
        check(n_emit > 0 and n_comp > 0,
              f"frame {key}: the main path launched K1 and K2")

    with torch.no_grad():
        ref = render(scene_a, cam_a, backend="torch", **bk_a)
    cu = outs["a_1080p_1M"]
    backend_err = max(float((cu[k] - ref[k]).abs().max())
                      for k in ("rgb", "alpha", "trans"))
    backend_sem = float((cu["semantic"] == ref["semantic"]).float().mean())
    print(f"frame a, cuda vs torch backend: max_abs {backend_err:.3e}, "
          f"semantic agreement {backend_sem:.6f}", flush=True)
    check(backend_err <= BACKEND_ATOL, f"cuda vs torch max_abs <= {BACKEND_ATOL}")
    check(backend_sem >= SEM_MIN, f"cuda vs torch semantic >= {SEM_MIN}")

    small = synthetic_room(400, seed=5, device=dev)
    small_cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], 64, 48,
                            device=dev)
    with torch.no_grad():
        s_cu = render(small, small_cam, backend="cuda", pair_capacity=1 << 14)
        s_or = render(small, small_cam, backend="oracle")
    oracle_err = max(float((s_cu[k] - s_or[k]).abs().max())
                     for k in ("rgb", "alpha", "trans"))
    oracle_ok = all(bool(torch.allclose(s_cu[k], s_or[k], rtol=1e-4, atol=1e-4))
                    for k in ("rgb", "alpha", "trans"))
    check(oracle_ok and int(s_cu["overflow"]) == 0,
          "64x48 frame: cuda backend within rtol=atol=1e-4 of the oracle "
          f"(max_abs {oracle_err:.2e})")

    # 6. times -------------------------------------------------------------------
    from sage3d_tpu_torch.ops.composite_cuda import composite_tiles_cuda
    for key, (scene, cam) in frames.items():
        bk = budget_kwargs(budgets[key])
        ekw = {k: bk[k] for k in binning.EMIT_BUDGET_KEYS}
        stage = {"projection": [], "binning": [], "composite": [], "total": []}
        with torch.no_grad():
            for it in range(23):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                proj = project_gaussians(scene, cam)
                ev[1].record()
                bins = binning.bin_gaussians(proj, cam.width, cam.height, **ekw)
                ev[2].record()
                composite_tiles_cuda(proj, scene.semantic_ids, bins, cam.width,
                                     cam.height,
                                     tile_capacity=bk["tile_capacity"],
                                     pair_capacity=bk["pair_capacity"])
                ev[3].record()
                ev[3].synchronize()
                if it >= 3:
                    stage["projection"].append(ev[0].elapsed_time(ev[1]))
                    stage["binning"].append(ev[1].elapsed_time(ev[2]))
                    stage["composite"].append(ev[2].elapsed_time(ev[3]))
            stage["total"] = [cuda_ms(lambda: render(scene, cam, backend="cuda",
                                                     **bk), reps=20, warmup=3)]
        med = {k: statistics.median(v) for k, v in stage.items()}
        mpix = cam.width * cam.height / (med["total"] * 1e3)
        print(f"time {key} {card}: projection {med['projection']:.3f} ms, "
              f"binning incl. K1 {med['binning']:.3f} ms, composite incl. K2 "
              f"{med['composite']:.3f} ms, render total {med['total']:.3f} ms "
              f"= {mpix:.2f} Mpix/s (median of 20 after 3 warm-ups)",
              flush=True)

        # Device busy time: each stage alone, then whole render() frames, each
        # loop unsynchronized; the idle share is that of the frame time above.
        with torch.no_grad():
            proj = project_gaussians(scene, cam)
            bins = binning.bin_gaussians(proj, cam.width, cam.height, **ekw)
            dev_ms = {
                "projection": device_busy(
                    lambda: project_gaussians(scene, cam))[0],
                "binning": device_busy(lambda: binning.bin_gaussians(
                    proj, cam.width, cam.height, **ekw))[0],
                "composite": device_busy(lambda: composite_tiles_cuda(
                    proj, scene.semantic_ids, bins, cam.width, cam.height,
                    tile_capacity=bk["tile_capacity"],
                    pair_capacity=bk["pair_capacity"]))[0],
            }
            busy, n_ops, top = device_busy(
                lambda: render(scene, cam, backend="cuda", **bk))
        check(busy > 0, f"frame {key}: the profiler saw device time")
        print(f"device {key} {card}: busy {busy:.3f} ms per render() frame "
              f"of {med['total']:.3f} ms, idle share "
              f"{1.0 - busy / med['total']:.3f}; {n_ops:.0f} kernels and "
              f"copies per frame; stage device ms: projection "
              f"{dev_ms['projection']:.3f}, binning {dev_ms['binning']:.3f}, "
              f"composite {dev_ms['composite']:.3f} (torch.profiler, CUDA "
              f"activity only, {PROFILE_REPS} unsynchronized frames)",
              flush=True)
        for kname, kms, kn in top:
            print(f"  top kernel {key}: {kms:.3f} ms, {kn:g} launches: "
                  f"{kname}", flush=True)

    # Kernel against plain version at frame a, with the bound of the work.
    def k1_run():
        for t in plan.tiers:
            binning.emit_tile_keys(t.attrs, t.rank, t.k_budget, plan.tiles_x,
                                   n_tiles_a, plan.mult)

    def k1_plain():
        for t in plan.tiers:
            binning.emit_tile_keys_plain(t.attrs, t.rank, t.k_budget,
                                         plan.tiles_x, n_tiles_a, plan.mult)

    k1_ms = cuda_ms(k1_run, reps=20, warmup=3)
    k1_plain_ms = cuda_ms(k1_plain, reps=5, warmup=1)
    # Bytes K1 must move: every key written once; the count row read for
    # every column; the nine geometry rows (and the rank, in the fused-key
    # mode) only for columns with a live slot.
    k1_bytes = sum(
        4 * t.attrs.shape[1] * (t.k_budget + 1)
        + 4 * int((t.attrs[3] > 0).sum()) * (9 + (plan.mult > 0))
        for t in plan.tiers)
    k1_live = sum(float(torch.clamp(t.attrs[3], max=t.k_budget).sum())
                  for t in plan.tiers)
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S,
                   k1_live * K1_OPS_PER_SLOT / FP32_OPS_PER_S) * 1e3
    k1_by = ("bytes" if k1_bytes / HBM_BYTES_PER_S
             >= k1_live * K1_OPS_PER_SLOT / FP32_OPS_PER_S else "operations")

    k2_ms = cuda_ms(lambda: composite_cuda.composite_fwd(*k2_args), reps=20,
                    warmup=3)
    k2_plain_ms = cuda_ms(lambda: composite_cuda.composite_fwd_plain(*k2_args),
                          reps=3, warmup=1)
    # Bytes K2 must move: the pair ids of the chunks it walked, columns 0-10
    # of each Gaussian they name, the tile ranges, the images and k_end.
    n_t = start.shape[0]
    walked = torch.minimum(count, kend_k * composite_cuda.CHUNK)
    edges = torch.zeros(pg.shape[0] + 1, dtype=torch.int32, device=dev)
    edges.index_add_(0, start.long(), torch.ones_like(walked))
    edges.index_add_(0, (start + walked).long(), -torch.ones_like(walked))
    seen = torch.cumsum(edges, 0, dtype=torch.int32)[:-1] > 0
    n_read = int(torch.unique(pg[seen]).numel())
    k2_bytes = (n_read * 11 * 4 + int(walked.sum()) * 4 + n_t * 8
                + n_t * composite_cuda.NCH * composite_cuda.NPIX * 4 + n_t * 4)
    k2_evals = float(walked.double().sum()) * composite_cuda.NPIX
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S,
                   k2_evals * K2_OPS_PER_EVAL / FP32_OPS_PER_S) * 1e3
    k2_by = ("bytes" if k2_bytes / HBM_BYTES_PER_S
             >= k2_evals * K2_OPS_PER_EVAL / FP32_OPS_PER_S else "operations")
    print(f"K1 at frame a {card}: kernel {k1_ms:.3f} ms for {len(plan.tiers)} "
          f"launches, plain {k1_plain_ms:.3f} ms, bound {k1_bound:.3f} ms "
          f"({k1_by}: {k1_bytes / 1e6:.1f} MB, {k1_live:.3e} live slots)",
          flush=True)
    print(f"K2 at frame a {card}: kernel {k2_ms:.3f} ms, plain "
          f"{k2_plain_ms:.3f} ms, bound {k2_bound:.3f} ms ({k2_by}: "
          f"{k2_bytes / 1e6:.1f} MB, {k2_evals:.4e} pair-pixel evaluations)",
          flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)

    kernels = [
        {"name": "K1 emit_tile_keys", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/emit.cu",
         "replaces": "sage3d_tpu/ops/binning.py:153",
         "launches": launches["emit"], "max_abs_err": 0.0 if k1_equal else None,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "K2 composite_fwd", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/composite_fwd.cu",
         "replaces": "sage3d_tpu/ops/composite_pallas.py:156",
         "launches": launches["composite_fwd"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    check(all(k["launches"] > 0 for k in kernels),
          "every kernel of the path launched on the main path")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
