#!/usr/bin/env python3
"""Drive the PyTorch port's render and training paths on one CUDA card, at
full size.

    python3 chip_smoke.py

Phases, in order (any failed check makes the script exit non-zero and print
no result line):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from ``sage3d_tpu_torch/csrc`` with nvcc,
     one process per source, all at once;
  3. K1 (``csrc/emit.cu``) against its plain PyTorch version on the live
     slots of the 1080p frame of a 1M-Gaussian scene, fused key (mult > 0)
     and two-key (mult == 0) modes: the pairs, sorted by key, must be equal;
  4. K2 (``csrc/composite_fwd.cu``) against its plain version on the same
     binned frame, with the tolerances stated below, and bitwise against the
     anatomy probe's production variant (K2 line for line); then, on the same
     frame
     and K2's k_end with a seeded cotangent, K3 (``csrc/composite_bwd.cu``)
     against its plain version, and K4 (``csrc/segreduce.cu``) bitwise
     against its plain version on K3's id-sorted gradient rows, launched
     twice (the two results must be bitwise equal); then the backward's
     d_attrs through K3, the id sort and K4 with the tight gradient buffer
     (Σk_end chunks) and with the safe bound, which must be bitwise equal;
  5. the render path: ``render(backend="cuda")`` on three frames (1920x1080
     and 3840x2160 of the 1M-Gaussian room, and the 640x480 agent view of a
     200k room; ``smoke_frames``) with
     ``autotune_all(pair_margin=1.05)`` budgets, each with its launch
     counters set to 0 just before and read just after; overflow must be 0
     and K1 must launch once a frame. Frame b's own peak device memory is
     read around its render (``reset_peak_memory_stats``).
     The 1080p frame is also rendered by the ``torch`` backend, and a small
     frame is held against the exact per-pixel oracle. Gradients of all five
     trainable groups through ``render(backend="cuda")`` are held against the
     ``torch`` backend's at 320x256 and against the oracle's at 64x48;
  5b. the training path: ``make_train_step(backend="cuda")`` with the
     per-group Adam takes ``TRAIN_STEPS`` steps on the 1080p frame of the 1M
     room towards the room's own render, from the room with seeded noise on
     its colours and opacities (geometry as is), with
     ``autotune_all(pair_margin=1.5, grad_margin=1.5)`` budgets;
     every step must launch K1-K4 (counters set to 0 before each step), the
     loss must stay finite and fall, and renders of the first and last
     parameters must not overflow. Step time (CUDA events), Mpix/s, and the
     device's busy time, idle share and top kernels per step (torch.profiler);
  5c. the start with SH noise 0.1 alone, whose loss the group Adam raises:
     at 1080p/1M, 10 steps at the group rates and at a tenth of them, and
     each group's first-order loss change along its ``cuda`` gradient held
     against the change measured by rendering, at the step lengths of
     ``SLOPE_STEPS`` (one of them must agree within ``SLOPE_TOL``); at
     320x256, 10 steps each with the ``cuda`` and the ``torch`` backend;
  6. times: per-stage medians over 20 runs after 3 warm-ups (CUDA events);
     the device's busy time per frame and per stage, from torch.profiler
     traces (CUDA activity only) of unsynchronized loops, and the idle share
     of a ``render()`` frame; each kernel against its plain version at the
     1080p frame, with the least time the card could take for the same work:
     the ``kernels`` line's ``ms`` (and ``library_ms``) is the median
     CUDA-event time around one call, the wrapper's host path included, and
     ``back_to_back_ms`` (``library_back_to_back_ms``) the time per call with
     20 calls queued back to back behind a spin of the card, the device's
     time alone, and ``host_ms`` (``library_host_ms``) the host's time per
     call queueing them;
  7. the bench path (``sage3d_tpu_torch.benchmarks.bench.run``): the
     1920x1080 frame of ``bench.py``'s 1M-Gaussian box with ``autotune``
     budgets; the ``cuda`` fwd+bwd step in the f32, f16 and bf16 gradient
     sorts, the ``torch`` step, parity of ``cuda`` against ``torch`` at
     800x800 and 1080p (each ``allclose``, overflow 0) and the SH3 step,
     with K1-K4 counted from 0; its full and compact result lines; then the
     device's busy time, idle share, K3's and K4's time and the top kernels
     of a ``cuda`` step in each gradient-sort mode (torch.profiler);
  8. the K2 anatomy probe (``csrc/composite_anatomy.cu``) on the bench
     frame: each of its six variants against its plain version, the
     production variant (early stop on, every block) bitwise against K2;
     then ``kernel_anatomy.measure``, counted from 0: the variants' times
     and registers per thread, the batch-of-4 ratio and the five deltas,
     and the probe's bound (K2's bytes and operations over every chunk).

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

# Tolerances of the kernels against their plain versions on the card.
K2_ATOL = 2e-4          # rgb, alpha, trans: f32 sums in another order
K2_DEPTH_TOL = 1e-3     # depth_acc (rtol and atol): depths reach ~50
SEM_MIN = 0.995         # semantic agreement: near-equal weights may swap
KEND_MAX_DIFF = 0.001   # share of tiles whose k_end may differ
BACKEND_ATOL = 5e-4     # cuda vs torch backend: log-space vs product blend
K3_REL = 2e-4           # K3 channels, over the channel's max |plain|: sums of
                        # 1024 pixels in another order
GRAD_REL = 5e-4         # cuda vs torch backend gradients over max |torch|
                        # (bench.py's gate)
ORACLE_GRAD = 3e-4      # cuda backend vs oracle gradients over max |oracle|
SLOPE_STEPS = (1e-2, 1e-3, 1e-4)  # 5c: each group's steps lower the loss by
                        # these shares of it to first order. Too long a step
                        # leaves the linear regime (curvature), too short a
                        # one meets the render's jumps (a Gaussian crossing a
                        # cull or cutoff changes a pixel by a fixed amount).
SLOPE_TOL = 0.5         # 5c: |measured / first-order change - 1| at most this
TRAIN_STEPS = 10        # full-width training steps; 3 are warm-ups
TRAINABLE = ("means", "log_scales", "quats", "opacity_logits", "sh")

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per unit of work, counted from the kernels' source:
# K1, one live slot: the reciprocal walk with its fixup, the tile rect, four
# edge minima of the conic quadratic, the cull test and the key (~90; the
# search for the slot's Gaussian is not counted).
# K2 and K3 need the rest of their work only where alpha > 0 (a hit): where
# alpha is 0, w and every gradient term are exact zeros and T stays.
# K2, every pair-pixel evaluation: the quadratic (10), the exp (counted as
# 4), the clamps and cutoff (4); every hit: w and the five accumulations
# (11), the best test (1) and the transmittance update (2).
# K3, every evaluation: K2's alpha (18); every hit: 1 - alpha, w and T (3),
# c (4 FMAs, 8), the running sum of c*w (2), dalpha with its division (4),
# dpower, dy and dpower*dy (3), the three running geometry sums (4) and the
# four colour sums (8); the per-pair channels are linear in those sums, so
# the rest is once per pair and column, not per pixel.
K1_OPS_PER_SLOT = 90
K2_OPS_PER_EVAL, K2_OPS_PER_HIT = 18, 14
K3_OPS_PER_EVAL, K3_OPS_PER_HIT = 18, 32

FAILURES: list = []
PROFILE_REPS = 10       # frames per torch.profiler trace
SPIN_CYCLES = 100_000_000   # back_to_back_ms's spin: ~57 ms at 1.755 GHz


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


def back_to_back_ms(fn, reps: int = 20):
    """(device, host) milliseconds per call of ``fn`` with the card running
    ``reps`` calls back to back: CUDA events around them, all queued behind
    a ~50 ms spin kernel, so the host's launch path adds no gap; and the
    host's clock around queueing them (the call's host path: checks,
    allocation, launches), which the spin keeps from waiting on the card.
    After one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, host


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


def device_busy(fn, reps: int = PROFILE_REPS, n_top: int = 6):
    """Device time per call of ``fn`` in ms, the kernels and copies per call,
    and the ``n_top`` kernels that took the most device time, as [name, ms
    per call, launches per call]. From a torch.profiler trace with CUDA
    activity only (no host tracing) of ``reps`` calls, unsynchronized between
    calls."""
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
           for e in sorted(evts, key=us, reverse=True)[:n_top]]
    return (sum(us(e) for e in evts) / 1e3 / reps,
            sum(e.count for e in evts) / reps, top)


def walked_pairs(pg, start, count, chunks):
    """Pairs walked per tile in ``chunks[t]`` chunks of a frame's pair list,
    and the number of distinct Gaussians they name."""
    import torch
    from sage3d_tpu_torch.ops.composite_cuda import CHUNK
    walked = torch.minimum(count, chunks * CHUNK)
    edges = torch.zeros(pg.shape[0] + 1, dtype=torch.int32, device=pg.device)
    edges.index_add_(0, start.long(), torch.ones_like(walked))
    edges.index_add_(0, (start + walked).long(), -torch.ones_like(walked))
    seen = torch.cumsum(edges, 0, dtype=torch.int32)[:-1] > 0
    return walked, int(torch.unique(pg[seen]).numel())


def alpha_hits(attrs, pg, start, count, tiles_x, chunks) -> int:
    """Pair-pixel evaluations with alpha > 0 in the first ``chunks[t]``
    chunks of every tile, by the plain versions' alpha."""
    import torch
    from sage3d_tpu_torch.ops import composite_cuda as cc
    dev = attrs.device
    n_t = start.shape[0]
    px, py = cc._pixel_centers(dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for t0 in range(0, n_t, 64):
            tid = torch.arange(t0, min(t0 + 64, n_t), device=dev)
            ox = ((tid % tiles_x) * cc.TILE_W).float()[:, None, None]
            oy = ((tid // tiles_x) * cc.TILE_H).float()[:, None, None]
            walk = chunks[tid].long()
            for k in range(int(walk.max())):
                alpha = cc._plain_chunk(attrs, pg, start[tid].long(),
                                        count[tid].long(), k, ox, oy, px,
                                        py)[2]
                hits += ((alpha > 0) & (k < walk)[:, None, None]).sum()
    return int(hits)


def ops_bound(n_bytes, evals, per_eval, hits, per_hit):
    """The least time in ms for ``n_bytes`` moved and the operations of
    ``evals`` pair-pixel evaluations and ``hits`` of them with alpha > 0,
    and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = (evals * per_eval + hits * per_hit) / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, (
        "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2

    import numpy as np
    from sage3d_tpu_torch.benchmarks import bench, kernel_anatomy
    from sage3d_tpu_torch.benchmarks._util import nvidia_smi_line
    from sage3d_tpu_torch.ops import _build, binning, composite_cuda, segreduce
    from sage3d_tpu_torch.ops.projection import project_gaussians
    from sage3d_tpu_torch.parallel import train
    from sage3d_tpu_torch.renderer.camera import make_camera, stack_cameras
    from sage3d_tpu_torch.renderer.render import (autotune_all, budget_kwargs,
                                                  render)
    from sage3d_tpu_torch.renderer.scene import synthetic_room
    cc = composite_cuda

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
    # the training budgets: margins for parameters that move
    budgets_train = autotune_all(*frames["a_1080p_1M"], pair_margin=1.5,
                                 grad_margin=1.5)
    print(f"budgets train a: {json.dumps(budgets_train)}", flush=True)

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
    # The kernel writes the kept pairs in no particular order and the plain
    # version in slot order; keys are unique, so both are compared sorted.
    def sorted_pairs(keys, gauss, n_kept):
        n = int(n_kept)
        keys, perm = torch.sort(keys[:n])
        return keys, gauss[:n][perm]

    n_tiles_a = plan.tiles_x * plan.tiles_y
    k1_args = (plan.table, plan.offsets, plan.n_live, plan.tiles_x)
    k1_equal = True
    for mult in (plan.mult, 0):
        got = sorted_pairs(*binning.emit_tile_pairs(*k1_args, mult))
        want = sorted_pairs(*binning.emit_tile_pairs_plain(*k1_args, mult))
        torch.cuda.synchronize()
        equal = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        k1_equal &= equal
        print(f"K1 at frame a (mult={mult}): {plan.n_live} live slots, "
              f"{len(got[0])} kept pairs (plain {len(want[0])}); sorted pairs "
              f"equal: {equal}", flush=True)
        del got, want

    def padded_slots(tier):   # the JAX kernel's padded emission: n_pad columns
        m = tier.gauss.shape[0]
        gb = min(binning.EMIT_GB, max(128, m))
        return -(-m // gb) * gb, tier.k_budget

    budgeted = sum(n * k for n, k in map(padded_slots, plan.tiers))
    print(f"K1 at frame a: {len(plan.tiers)} tiers, {budgeted} budgeted slots "
          f"(the padded emission's), {plan.n_live} live, "
          f"{int(bins_a.n_pairs)} kept", flush=True)
    check(plan.mult > 0, "frame a takes the fused-key path")
    check(k1_equal, "K1's pairs sorted by key equal the plain version's "
          "(fused and two-key)")

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
          f"{n_tiles_a} tiles, sum k_end {int(kend_k.sum())}, max k_end "
          f"{int(kend_k.max())} (one block walks a tile's chunks in order)",
          flush=True)
    check(k2_err <= K2_ATOL, f"K2 rgb/alpha/trans within {K2_ATOL}")
    check(depth_ok, f"K2 depth_acc within rtol=atol={K2_DEPTH_TOL}")
    check(sem_agree >= SEM_MIN, f"K2 semantic agreement >= {SEM_MIN}")
    check(kend_diff <= KEND_MAX_DIFF * n_tiles_a,
          f"K2 k_end differs on <= {KEND_MAX_DIFF:.1%} of tiles")
    probe_a = kernel_anatomy.make_variant(
        n_tiles_a, plan.tiles_x,
        **kernel_anatomy.VARIANTS[kernel_anatomy.PRODUCTION])(*k2_args[:4])
    torch.cuda.synchronize()
    print(f"K2 vs the probe's production variant at frame a: "
          f"{int((probe_a != out_k).sum())} values differ", flush=True)
    check(torch.equal(probe_a, out_k),
          "probe, early stop on, all blocks: bitwise equal to K2 at frame a")
    del probe_a, out_p

    # 4b. K3 against its plain version ----------------------------------------
    c_cap_a = int(budgets_train["grad_capacity"])
    chunk0_a, allowed_a = cc.slot_ranges(kend_k, c_cap_a)
    gen = torch.Generator(device=dev).manual_seed(0)
    gout_a = torch.randn(out_k.shape, generator=gen, device=dev)
    k3_args = (attrs_a, pg, start, count, chunk0_a, allowed_a, out_k, gout_a,
               c_cap_a, plan.tiles_x)
    slots_k = cc.composite_bwd(*k3_args)
    slots_p = cc.composite_bwd_plain(*k3_args)
    torch.cuda.synchronize()
    used = int(allowed_a.sum()) * cc.CHUNK
    n_a = attrs_a.shape[0]
    k3_err = max(float((slots_k[:, ch] - slots_p[:, ch]).abs().max())
                 for ch in range(cc.NGRAD))
    k3_rel = max(float((slots_k[:, ch] - slots_p[:, ch]).abs().max())
                 / max(float(slots_p[:, ch].abs().max()), 1e-30)
                 for ch in range(cc.NGRAD))
    ids_equal = torch.equal(slots_k[:, cc.GID_COL], slots_p[:, cc.GID_COL])
    tail_unfilled = used == len(slots_k) or (
        float(slots_k[used:, :cc.NGRAD].abs().max()) == 0.0
        and bool((slots_k[used:, cc.GID_COL] == n_a).all()))
    print(f"K3 vs plain: max_abs {k3_err:.3e}, max over channels of "
          f"max_abs / max|plain| {k3_rel:.3e}, {used} slot rows of "
          f"{len(slots_k)} (c_cap {c_cap_a})", flush=True)
    check(c_cap_a >= int(kend_k.sum()), "training grad_capacity >= sum k_end")
    check(k3_rel <= K3_REL, f"K3 channels within {K3_REL} x channel max")
    check(ids_equal, "K3 id column equal to the plain version's")
    check(tail_unfilled, "K3 slots past sum(allowed): zero payload, id N")

    # 4c. K4 against its plain version, and determinism, on the rows the
    # backward gives it: every slot row, sorted by id (the unfilled rows,
    # id N, sort last and add nothing) ---------------------------------------
    ids_a, perm_a = torch.sort(slots_k[:, cc.GID_COL].to(torch.int32),
                               stable=True)
    rows_a = slots_k[:, :cc.NGRAD]
    n_in = int((ids_a < n_a).sum())
    k4_args = (ids_a, rows_a, n_a)
    seg_k = segreduce.segment_reduce_sorted(*k4_args, perm=perm_a)
    seg_k2 = segreduce.segment_reduce_sorted(*k4_args, perm=perm_a)
    seg_p = segreduce.segment_reduce_plain(*k4_args, perm=perm_a)
    torch.cuda.synchronize()
    k4_err = float((seg_k - seg_p).abs().max())
    seg_len = torch.bincount(ids_a[:n_in].long(), minlength=n_a)
    print(f"K4 vs plain: max_abs {k4_err:.3e}, {int((seg_k != seg_p).sum())} "
          f"values differ, over {n_a} Gaussians, {len(ids_a)} rows ({n_in} "
          f"with an id below N); {int((seg_len > 0).sum())} segments, "
          f"{int((seg_len > segreduce.SHORT).sum())} longer than "
          f"{segreduce.SHORT} rows, the longest {int(seg_len.max())}",
          flush=True)
    check(torch.equal(seg_k, seg_p), "K4 bitwise equal to its plain version")
    check(torch.equal(seg_k, seg_k2), "K4 twice on one input: bitwise equal")
    del seg_len

    # 4d. the gradient buffer: tight (Σk_end chunks) against the safe bound,
    # through the card's K3, id sort and K4 --------------------------------
    tight_a = int(kend_k.sum())
    safe_a = pg.shape[0] // cc.CHUNK + n_tiles_a
    d_tight, d_safe = (cc.composite_vjp(attrs_a, pg, start, count, kend_k,
                                        out_k, gout_a, plan.tiles_x, c)
                       for c in (tight_a, safe_a))
    torch.cuda.synchronize()
    print(f"d_attrs at frame a, grad_capacity {tight_a} (tight) vs {safe_a} "
          f"(safe) chunks: {int((d_tight != d_safe).sum())} values differ, "
          f"max |d_attrs| {float(d_tight.abs().max()):.3e}", flush=True)
    check(tight_a < safe_a and float(d_tight.abs().max()) > 0
          and torch.equal(d_tight, d_safe),
          "tight and safe grad_capacity: d_attrs bitwise equal (K3, sort, K4)")
    del d_tight, d_safe

    # 5. the main path ----------------------------------------------------------
    launches = {"emit": 0, "composite_fwd": 0}
    outs = {}
    script_peak = 0
    for key, (scene, cam) in frames.items():
        bk = budget_kwargs(budgets[key])
        if key == "b_4k_1M":   # the frame's own peak, beside the script's
            torch.cuda.synchronize()
            script_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        binning.emit_tile_pairs.launches = 0
        composite_cuda.composite_fwd.launches = 0
        with torch.no_grad():
            out = render(scene, cam, backend="cuda", **bk)
        torch.cuda.synchronize()
        if key == "b_4k_1M":
            peak_b = torch.cuda.max_memory_allocated()
            print(f"frame {key} peak device memory {card}: "
                  f"{peak_b / 2**30:.2f} GiB, of which {held / 2**30:.2f} GiB "
                  f"held before its render()", flush=True)
        n_emit = binning.emit_tile_pairs.launches
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
        check(n_emit == 1 and n_comp > 0,
              f"frame {key}: the main path launched K1 once and K2")

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

    # Gradients of the render path, all five trainable groups.
    def grads_of(scene, cam, backend, **kw):
        params = {k: getattr(scene, k).clone().requires_grad_()
                  for k in TRAINABLE}
        out = render(scene._replace(**params), cam, backend=backend, **kw)
        (torch.mean((out["rgb"] - 0.5) ** 2) + 0.05 * torch.mean(
            out["depth_acc"]) + 0.02 * torch.mean(out["alpha"])
         + 0.01 * torch.mean(out["trans"])).backward()
        return {k: params[k].grad for k in TRAINABLE}, int(out["overflow"])

    def grad_rel(got, ref):
        return max(float((got[k] - ref[k]).abs().max())
                   / max(float(ref[k].abs().max()), 1e-30) for k in TRAINABLE)

    g_scene = synthetic_room(20_000, seed=5, device=dev)
    g_cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], 320, 256,
                        device=dev)
    g_bk = budget_kwargs(autotune_all(g_scene, g_cam))
    g_cu, ovf_cu = grads_of(g_scene, g_cam, "cuda", **g_bk)
    g_to, ovf_to = grads_of(g_scene, g_cam, "torch", **g_bk)
    rel_torch = grad_rel(g_cu, g_to)
    g_cu_s, _ = grads_of(small, small_cam, "cuda", pair_capacity=1 << 14)
    g_or_s, _ = grads_of(small, small_cam, "oracle")
    rel_oracle = grad_rel(g_cu_s, g_or_s)
    print(f"gradients, cuda vs torch backend at 320x256: max over groups of "
          f"max_abs / max|torch| {rel_torch:.3e}; cuda vs oracle at 64x48: "
          f"{rel_oracle:.3e}", flush=True)
    check(ovf_cu == 0 and ovf_to == 0, "320x256 gradient frame: overflow 0")
    check(rel_torch <= GRAD_REL, f"cuda vs torch gradients within {GRAD_REL}")
    check(rel_oracle <= ORACLE_GRAD,
          f"cuda vs oracle gradients within {ORACLE_GRAD}")

    # 5b. the training path ------------------------------------------------------
    bk_t = budget_kwargs(budgets_train)
    with torch.no_grad():
        target = render(scene_a, cam_a, backend="cuda", **bk_t)["rgb"][None]
    # The start: the room with noise on its SH (sigma 1) and opacity logits
    # (sigma 0.5). Adam's first steps move every parameter by about its rate;
    # from a start this far off they lower the loss, where from a start whose
    # error is much smaller than such a step (SH noise 0.1 alone) they raise
    # it (phase 5c).
    rng = np.random.default_rng(1)
    sh_noise = rng.normal(0.0, 1.0, tuple(scene_a.sh.shape)).astype(np.float32)
    op_noise = rng.normal(0.0, 0.5, tuple(scene_a.opacity_logits.shape))
    start_scene = scene_a._replace(
        sh=scene_a.sh + torch.from_numpy(sh_noise).to(dev),
        opacity_logits=scene_a.opacity_logits
        + torch.from_numpy(op_noise.astype(np.float32)).to(dev))
    cams_t = stack_cameras([cam_a])
    opt = train.make_group_optimizer(extent=1.0)
    step_fn, _ = train.make_train_step(start_scene, cam_a, optimizer=opt,
                                       backend="cuda", **bk_t)
    state = train.init_train_state(start_scene, opt)
    counters = {"emit": binning.emit_tile_pairs,
                "composite_fwd": cc.composite_fwd,
                "composite_bwd": cc.composite_bwd,
                "segreduce": segreduce.segment_reduce_sorted}
    with torch.no_grad():
        ovf_first = int(render(start_scene, cam_a, backend="cuda",
                               **bk_t)["overflow"])
    losses, step_ms = [], []
    launches_train = {k: 0 for k in counters}
    every_step = True
    for i in range(TRAIN_STEPS):
        for fn in counters.values():
            fn.launches = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, loss = step_fn(state, cams_t, target)
        ev[1].record()
        ev[1].synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(loss))
        n = {k: fn.launches for k, fn in counters.items()}
        every_step &= all(v > 0 for v in n.values())
        for k in counters:
            launches_train[k] += n[k]
        print(f"train step {i + 1}: loss {losses[-1]:.6e}, {step_ms[-1]:.3f} ms,"
              f" launches {json.dumps(n)}", flush=True)
    with torch.no_grad():
        last = train.with_params(start_scene, {k: v.detach() for k, v in
                                               state.params.items()})
        ovf_last = int(render(last, cam_a, backend="cuda", **bk_t)["overflow"])
    step_med = statistics.median(step_ms[3:])
    mpix = cam_a.width * cam_a.height / (step_med * 1e3)
    print(f"train {card}: step {step_med:.3f} ms median of "
          f"{TRAIN_STEPS - 3} after 3 warm-ups = {mpix:.2f} Mpix/s; loss "
          f"{losses[0]:.6e} -> {losses[-1]:.6e}; overflow first/last "
          f"{ovf_first}/{ovf_last}", flush=True)
    check(every_step, "every training step launched K1, K2, K3 and K4")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "training loss finite and falling")
    check(ovf_first == 0 and ovf_last == 0,
          "training frame: overflow 0 with the first and last parameters")

    holder = [state]

    def one_step():
        holder[0], _ = step_fn(holder[0], cams_t, target)

    busy_t, n_ops_t, top_t = device_busy(one_step, reps=5)
    check(busy_t > 0, "training: the profiler saw device time")
    print(f"device train {card}: busy {busy_t:.3f} ms per step of "
          f"{step_med:.3f} ms, idle share {1.0 - busy_t / step_med:.3f}; "
          f"{n_ops_t:.0f} kernels and copies per step (torch.profiler, CUDA "
          f"activity only, 5 unsynchronized steps)", flush=True)
    for kname, kms, kn in top_t:
        print(f"  top kernel train: {kms:.3f} ms, {kn:g} launches: {kname}",
              flush=True)

    # 5c. the start with SH noise 0.1 alone --------------------------------------
    # Adam moves every parameter by about its rate on its first steps. From a
    # start whose error is far below what such steps add, the group rates
    # raise the loss, where a tenth of them need not. Whether the gradient is
    # at fault is read from the loss itself: each group steps along its
    # negative gradient by the lengths that lower the loss by SLOPE_STEPS of
    # it to first order, and at one of them the change measured by rendering
    # must agree. A gradient of the wrong sign or size fails at every length.
    def sh_noisy(scene, seed):
        noise = np.random.default_rng(seed).normal(
            0.0, 0.1, tuple(scene.sh.shape)).astype(np.float32)
        return scene._replace(sh=scene.sh + torch.from_numpy(noise).to(dev))

    def run_steps(start, cam, tgt, optimizer, backend, bk):
        fn, _ = train.make_train_step(start, cam, optimizer=optimizer,
                                      backend=backend, **bk)
        st = train.init_train_state(start, optimizer)
        losses_run = []
        for _ in range(TRAIN_STEPS):
            st, l_run = fn(st, stack_cameras([cam]), tgt)
            losses_run.append(float(l_run))
        return losses_run

    def fmt(ls):
        return " ".join(f"{x:.4e}" for x in ls)

    sh_start = sh_noisy(scene_a, 2)
    group = train.make_group_optimizer(extent=1.0)
    tenth = train.make_group_optimizer(
        extent=1.0, lrs={k: 0.1 * v for k, v in train.GROUP_LRS.items()})
    l_rates = run_steps(sh_start, cam_a, target, group, "cuda", bk_t)
    l_tenth = run_steps(sh_start, cam_a, target, tenth, "cuda", bk_t)
    print(f"start SH noise 0.1, 1080p/1M, cuda, loss per step: group rates "
          f"{fmt(l_rates)}; a tenth of the rates {fmt(l_tenth)}", flush=True)

    def slope_ratios(start, cam, tgt, backend, bk):
        """Per group, the loss change measured by rendering over its
        first-order prediction, at each step length of SLOPE_STEPS."""
        def loss_of(params):
            out = render(start._replace(**params), cam, backend=backend, **bk)
            return torch.sum((out["rgb"] - tgt[0]) ** 2) / tgt[0].numel()

        leaves = {k: getattr(start, k).clone().requires_grad_()
                  for k in TRAINABLE}
        loss0 = loss_of(leaves)
        loss0.backward()
        base = float(loss0.detach())
        ratios = {}
        with torch.no_grad():
            for k in TRAINABLE:
                g = leaves[k].grad
                ratios[k] = []
                for share in SLOPE_STEPS:
                    eta = share * base / float((g.double() ** 2).sum())
                    moved = {q: v.detach() for q, v in leaves.items()}
                    moved[k] = moved[k] - eta * g
                    ratios[k].append((float(loss_of(moved)) - base)
                                     / (-share * base))
        return ratios

    def fmt_ratios(ratios):
        return "; ".join(f"{k} " + ", ".join(f"{r:.4f}" for r in rs)
                         for k, rs in ratios.items())

    slopes = slope_ratios(sh_start, cam_a, target, "cuda", bk_t)
    print(f"start SH noise 0.1, 1080p/1M, cuda: measured / first-order loss "
          f"change along -grad at step lengths {SLOPE_STEPS}: "
          f"{fmt_ratios(slopes)}", flush=True)
    check(all(min(abs(r - 1.0) for r in rs) <= SLOPE_TOL
              for rs in slopes.values()),
          f"1080p/1M: every group's loss change within {SLOPE_TOL} of its "
          "gradient's first-order prediction at one step length")

    bk_g = budget_kwargs(autotune_all(g_scene, g_cam, pair_margin=1.5,
                                      grad_margin=1.5))
    with torch.no_grad():
        g_target = render(g_scene, g_cam, backend="cuda", **bk_g)["rgb"][None]
    g_start = sh_noisy(g_scene, 3)
    l_cu = run_steps(g_start, g_cam, g_target, group, "cuda", bk_g)
    l_to = run_steps(g_start, g_cam, g_target, group, "torch", bk_g)
    rel_traj = max(abs(a - b) / abs(b) for a, b in zip(l_cu, l_to))
    print(f"start SH noise 0.1, 320x256/20k, group rates, loss per step: "
          f"cuda {fmt(l_cu)}; torch {fmt(l_to)}; max |cuda - torch| / torch "
          f"{rel_traj:.3e}", flush=True)
    # The same slopes where the torch backend's autograd gradient can be
    # taken: a departure from 1 that both backends show belongs to the render
    # (its cutoffs), not to the cuda backward.
    for backend in ("cuda", "torch"):
        ratios = slope_ratios(g_start, g_cam, g_target, backend, bk_g)
        print(f"start SH noise 0.1, 320x256/20k, {backend}: measured / "
              f"first-order loss change along -grad: {fmt_ratios(ratios)}",
              flush=True)

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
            n_live = binning.emission_plan(proj, cam.width, cam.height,
                                           **ekw).n_live
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
              f"activity only, {PROFILE_REPS} unsynchronized frames); K1 "
              f"walks {n_live} live slots for {int(bins.n_pairs)} kept pairs",
              flush=True)
        for kname, kms, kn in top:
            print(f"  top kernel {key}: {kms:.3f} ms, {kn:g} launches: "
                  f"{kname}", flush=True)

    # Kernel against plain version at frame a, with the bound of the work.
    def k1_run():
        binning.emit_tile_pairs(*k1_args, plan.mult)

    k1_ms = cuda_ms(k1_run, reps=20, warmup=3)
    k1_plain_ms = cuda_ms(lambda: binning.emit_tile_pairs_plain(
        *k1_args, plan.mult), reps=5, warmup=1)
    # Bytes K1 must move: the offsets, read once; ten 4-byte values (the
    # rect, mean, cut2, rank and conic) of each Gaussian with a live slot;
    # each kept pair's key and Gaussian id written once. Operations:
    # K1_OPS_PER_SLOT per live slot.
    n_live_g = int((plan.offsets[1:] > plan.offsets[:-1]).sum())
    kept_a = int(bins_a.n_pairs)
    k1_bytes = (plan.offsets.numel() * 8 + n_live_g * 10 * 4
                + kept_a * ((4 if plan.mult else 8) + 4))
    k1_ops = plan.n_live * K1_OPS_PER_SLOT
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_OPS_PER_S) * 1e3
    k1_by = ("bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / FP32_OPS_PER_S
             else "operations")
    # The count for the JAX kernel's padded emission, for the record: a
    # 4-byte key per budgeted slot, the count row of every column, nine
    # geometry rows and the rank for columns with a live slot.
    k1_padded_bytes = sum(
        4 * padded_slots(t)[0] * (t.k_budget + 1)
        + 4 * int((t.count > 0).sum()) * (9 + (plan.mult > 0))
        for t in plan.tiers)

    k2_ms = cuda_ms(lambda: composite_cuda.composite_fwd(*k2_args), reps=20,
                    warmup=3)
    k2_plain_ms = cuda_ms(lambda: composite_cuda.composite_fwd_plain(*k2_args),
                          reps=3, warmup=1)
    # Bytes K2 must move: the pair ids of the chunks it walked, columns 0-10
    # of each Gaussian they name, the tile ranges, the images and k_end.
    n_t = start.shape[0]
    walked, n_read = walked_pairs(pg, start, count, kend_k)
    k2_bytes = (n_read * 11 * 4 + int(walked.sum()) * 4 + n_t * 8
                + n_t * composite_cuda.NCH * composite_cuda.NPIX * 4 + n_t * 4)
    k2_evals = float(walked.double().sum()) * composite_cuda.NPIX
    k2_hits = alpha_hits(attrs_a, pg, start, count, plan.tiles_x, kend_k)
    k2_bound, k2_by = ops_bound(k2_bytes, k2_evals, K2_OPS_PER_EVAL, k2_hits,
                                K2_OPS_PER_HIT)
    print(f"K1 at frame a {card}: kernel {k1_ms:.3f} ms (one launch), plain "
          f"{k1_plain_ms:.3f} ms, bound {k1_bound:.4f} ms ({k1_by}: "
          f"{k1_bytes / 1e6:.1f} MB, {k1_ops:.3e} operations for "
          f"{plan.n_live} live slots of {n_live_g} Gaussians, {kept_a} kept "
          f"pairs); the padded emission's byte count "
          f"{k1_padded_bytes / 1e6:.1f} MB", flush=True)
    print(f"K2 at frame a {card}: kernel {k2_ms:.3f} ms, plain "
          f"{k2_plain_ms:.3f} ms, bound {k2_bound:.3f} ms ({k2_by}: "
          f"{k2_bytes / 1e6:.1f} MB, {k2_evals:.4e} pair-pixel evaluations, "
          f"{k2_hits:.4e} with alpha > 0)", flush=True)

    k3_ms = cuda_ms(lambda: cc.composite_bwd(*k3_args), reps=20, warmup=3)
    k3_plain_ms = cuda_ms(lambda: cc.composite_bwd_plain(*k3_args), reps=2,
                          warmup=1)
    # Bytes K3 must move: the pair ids of the chunks it walks, columns 0-11
    # of each Gaussian they name, channels 0-5 of the forward's images and of
    # their cotangent, and one 16-float slot row written per walked pair;
    # operations: K3_OPS_PER_EVAL per pair-pixel evaluation of its walk and
    # K3_OPS_PER_HIT more per evaluation with alpha > 0.
    walked3, n_read3 = walked_pairs(pg, start, count, allowed_a)
    n_walked3 = int(walked3.sum())
    k3_bytes = (n_read3 * 12 * 4 + n_walked3 * 4
                + 2 * n_t * 6 * cc.NPIX * 4 + n_walked3 * cc.NFEAT * 4)
    k3_evals = float(walked3.double().sum()) * cc.NPIX
    k3_hits = alpha_hits(attrs_a, pg, start, count, plan.tiles_x, allowed_a)
    k3_bound, k3_by = ops_bound(k3_bytes, k3_evals, K3_OPS_PER_EVAL, k3_hits,
                                K3_OPS_PER_HIT)
    k3_regs = cc.composite_bwd_registers()

    k4_ms = cuda_ms(lambda: segreduce.segment_reduce_sorted(*k4_args,
                                                            perm=perm_a),
                    reps=20, warmup=3)
    k4_plain_ms = cuda_ms(lambda: segreduce.segment_reduce_plain(
        *k4_args, perm=perm_a), reps=2, warmup=1)
    # index_add_ takes only ids below N: the sorted rows' prefix
    ids_in, rows_in = ids_a[:n_in], rows_a[perm_a[:n_in]]
    k4_lib_ms = cuda_ms(lambda: torch.zeros((n_a, cc.NGRAD), device=dev)
                        .index_add_(0, ids_in, rows_in), reps=20, warmup=3)
    # Bytes K4 must move: every row's id read once, the sort's index (8
    # bytes) and the payload of the rows with an id below N read once, the
    # output written once; one add per such payload value.
    k4_bytes = (len(ids_a) * 4 + n_in * (8 + cc.NGRAD * 4)
                + n_a * cc.NGRAD * 4)
    k4_ops = n_in * cc.NGRAD
    k4_bound = max(k4_bytes / HBM_BYTES_PER_S, k4_ops / FP32_OPS_PER_S) * 1e3
    k4_by = ("bytes" if k4_bytes / HBM_BYTES_PER_S >= k4_ops / FP32_OPS_PER_S
             else "operations")
    sort_ms = cuda_ms(lambda: torch.sort(slots_k[:, cc.GID_COL].to(
        torch.int32), stable=True), reps=20, warmup=3)
    # Device time per call, the calls run back to back: the CUDA-event time
    # around one call above also holds the wrapper's host path, during which
    # the card waits (at K4's size a third of that time).
    with torch.no_grad():
        b2b = {name: back_to_back_ms(fn) for name, fn in (
            ("K1", k1_run),
            ("K2", lambda: composite_cuda.composite_fwd(*k2_args)),
            ("K3", lambda: cc.composite_bwd(*k3_args)),
            ("K4", lambda: segreduce.segment_reduce_sorted(*k4_args,
                                                           perm=perm_a)),
            ("index_add_", lambda: torch.zeros((n_a, cc.NGRAD), device=dev)
             .index_add_(0, ids_in, rows_in)))}
    dev_ms = {name: v[0] for name, v in b2b.items()}
    host_ms = {name: v[1] for name, v in b2b.items()}
    print(f"device ms per call at frame a {card} (CUDA events around 20 "
          f"calls queued behind a spin of the card): {json.dumps(dev_ms)}; "
          f"host ms per call queueing them: {json.dumps(host_ms)}",
          flush=True)
    print(f"K3 at frame a {card}: kernel {k3_ms:.3f} ms (events around one "
          f"call), {dev_ms['K3']:.3f} ms back to back, {k3_regs} registers "
          f"per thread, plain {k3_plain_ms:.3f} ms, bound {k3_bound:.3f} ms "
          f"({k3_by}: "
          f"{k3_bytes / 1e6:.1f} MB, {k3_evals:.4e} pair-pixel evaluations, "
          f"{k3_hits:.4e} with alpha > 0)", flush=True)
    print(f"id sort at frame a {card}: {sort_ms:.3f} ms for {len(slots_k)} "
          f"slot rows (stable torch.sort of the id column, as the backward "
          f"does)", flush=True)
    print(f"K4 at frame a {card}: kernel {k4_ms:.4f} ms (events around one "
          f"call), {dev_ms['K4']:.4f} ms back to back; index_add_ "
          f"{k4_lib_ms:.4f} ms (events), {dev_ms['index_add_']:.4f} ms back to "
          f"back; K4 / index_add_ {k4_ms / k4_lib_ms:.3f} (events), "
          f"{dev_ms['K4'] / dev_ms['index_add_']:.3f} (back to back); plain "
          f"{k4_plain_ms:.3f} ms, bound "
          f"{k4_bound:.4f} ms ({k4_by}: {k4_bytes / 1e6:.1f} MB)", flush=True)

    # 7. the bench path -----------------------------------------------------------
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = bench.run(device=dev)
    torch.cuda.synchronize()
    launches_bench = {k: fn.launches for k, fn in counters.items()}
    print(json.dumps(result))
    print(json.dumps(bench.compact(result)), flush=True)
    det = result["detail"]
    print(f"bench {card}: {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(launches_bench)}", flush=True)
    for res in ("800x800", "1080p"):
        check(det["PARITY"][res]["allclose"],
              f"bench parity {res}: cuda (f32, f16, bf16 sorts) allclose to "
              "torch")
    check(det["overflow_pairs"] == 0, "bench frame: overflow_pairs == 0")
    check(all(np.isfinite(det[k]) and det[k] > 0 for k in
              ("cuda_step_s", "cuda_f16_sort_step_s", "cuda_bf16_sort_step_s",
               "torch_step_s", "sh3_step_s")), "bench step times finite")
    check(all(v > 0 for v in launches_bench.values()),
          "the bench path launched K1, K2, K3 and K4")

    # Where the bench step's time goes: device busy per cuda step in each
    # gradient-sort mode (the same seeded scene and budgets), against the
    # step's median time above; K3's and K4's device time in the step.
    scene_b = bench.make_bench_scene(device=dev)
    cam_b = bench.bench_camera(device=dev)
    budgets_b = bench.autotune(scene_b, cam_b)
    for mode, key in (("f32", "cuda_step_median_s"),
                      ("f16", "cuda_f16_sort_step_median_s"),
                      ("bf16", "cuda_bf16_sort_step_median_s")):
        def bench_step():
            leaf = scene_b.opacity_logits.detach().requires_grad_()
            loss = bench.bench_loss(scene_b._replace(opacity_logits=leaf),
                                    cam_b, "cuda", budgets_b, grad_sort=mode)
            torch.autograd.grad(loss, leaf)

        busy_b, n_ops_b, top_b = device_busy(bench_step, reps=5, n_top=1000)
        step_b = det[key] * 1e3
        k34 = {name: sum(kms for kname, kms, _ in top_b if pat in kname)
               for name, pat in (("K3", "composite_bwd_kernel"),
                                 ("K4", "segment_sum_kernel"))}
        print(f"device bench {mode} {card}: busy {busy_b:.3f} ms per cuda "
              f"{mode} step of {step_b:.3f} ms (median), idle share "
              f"{1.0 - busy_b / step_b:.3f}; {n_ops_b:.0f} kernels and copies "
              f"per step; K3 {k34['K3']:.4f} ms, K4 {k34['K4']:.4f} ms a step "
              f"(torch.profiler, CUDA activity only, 5 unsynchronized steps)",
              flush=True)
        for kname, kms, kn in top_b[:6]:
            print(f"  top kernel bench {mode}: {kms:.3f} ms, {kn:g} launches: "
                  f"{kname}", flush=True)

    # 8. the anatomy probe ---------------------------------------------------------
    # Each variant against its plain version on the bench frame (the
    # tolerances of K2's CPU parity tests), the production variant bitwise
    # against K2; then the timed variants, counted as the main path.
    inp = kernel_anatomy.prepare(scene_b, cam_b, budgets_b)
    del scene_b
    p_args = (inp["attrs"], inp["pair_gauss"], inp["tile_start"],
              inp["tile_count"])
    probe_err = 0.0
    for name, flags in kernel_anatomy.VARIANTS.items():
        got = kernel_anatomy.make_variant(inp["n_tiles"], inp["tiles_x"],
                                          **flags)(*p_args)
        want = kernel_anatomy.variant_plain(*p_args, inp["tiles_x"], **flags)
        torch.cuda.synchronize()
        err = max(float((got[:, ch] - want[:, ch]).abs().max())
                  for ch in (0, 1, 2, 4, 5))
        probe_err = max(probe_err, err)
        close = (all(torch.allclose(got[:, ch], want[:, ch], rtol=1e-4,
                                    atol=1e-4) for ch in (0, 1, 2, 4, 5, 6))
                 and torch.allclose(got[:, 3], want[:, 3], rtol=1e-3,
                                    atol=1e-3))
        sem = float((got[:, 7] == want[:, 7]).float().mean())
        print(f"probe {name} vs plain: max_abs rgb/alpha/trans {err:.3e}, "
              f"semantic agreement {sem:.6f}", flush=True)
        check(close and sem >= SEM_MIN,
              f"probe {name}: within rtol=atol=1e-4 (depth 1e-3) of plain")
        if name == kernel_anatomy.PRODUCTION:
            k2_out, k2_kend = composite_cuda.composite_fwd(*p_args,
                                                           inp["tiles_x"])
            check(torch.equal(got, k2_out),
                  "probe, early stop on, all blocks: bitwise equal to K2 on "
                  "the bench frame")
    probe_plain_ms = cuda_ms(lambda: kernel_anatomy.variant_plain(
        *p_args, inp["tiles_x"], **kernel_anatomy.BASE), reps=2, warmup=1)
    kernel_anatomy.composite_anatomy.launches = 0
    anatomy = kernel_anatomy.measure(inp)
    torch.cuda.synchronize()
    probe_launches = kernel_anatomy.composite_anatomy.launches
    # The bound of the early-stop-off full variant: K2's bytes and operations
    # (K2_OPS_PER_EVAL, K2_OPS_PER_HIT) over every chunk of every tile.
    p_count = inp["tile_count"]
    all_chunks = (p_count + cc.CHUNK - 1) // cc.CHUNK
    p_walked, p_read = walked_pairs(inp["pair_gauss"], inp["tile_start"],
                                    p_count, all_chunks)
    n_tb = p_count.shape[0]
    p_bytes = (p_read * 11 * 4 + int(p_walked.sum()) * 4 + n_tb * 8
               + n_tb * cc.NCH * cc.NPIX * 4)
    p_evals = float(p_walked.double().sum()) * cc.NPIX
    p_hits = alpha_hits(inp["attrs"], inp["pair_gauss"], inp["tile_start"],
                        p_count, inp["tiles_x"], all_chunks)
    probe_bound, probe_by = ops_bound(p_bytes, p_evals, K2_OPS_PER_EVAL,
                                      p_hits, K2_OPS_PER_HIT)
    k2_bench_walk = float(walked_pairs(inp["pair_gauss"], inp["tile_start"],
                                       p_count, k2_kend)[0].double().sum())
    base_ms = anatomy["variants"][kernel_anatomy.BASELINE]["ms"]
    print(f"probe at the bench frame {card}: {probe_launches} launches; "
          f"early stop off, all blocks {base_ms:.3f} ms, plain "
          f"{probe_plain_ms:.3f} ms, bound {probe_bound:.3f} ms ({probe_by}: "
          f"{p_bytes / 1e6:.1f} MB, {p_evals:.4e} pair-pixel evaluations, "
          f"{p_hits:.4e} with alpha > 0); {int(p_count.sum())} pairs, "
          f"{n_tb} tiles, K2 walks {k2_bench_walk:.0f} pairs "
          f"(sum k_end {int(k2_kend.sum())})", flush=True)
    check(probe_launches > 0, "the anatomy run launched the probe kernel")
    script_peak = max(script_peak, torch.cuda.max_memory_allocated())
    print(f"peak device memory {card}: {script_peak / 2**30:.2f} GiB for the "
          f"script, {peak_b / 2**30:.2f} GiB at frame b's render", flush=True)

    kernels = [
        {"name": "K1 emit_tile_pairs", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/emit.cu",
         "replaces": "sage3d_tpu/ops/binning.py:153",
         "launches": launches["emit"] + launches_train["emit"]
         + launches_bench["emit"],
         "max_abs_err": 0.0 if k1_equal else None,
         "ms": k1_ms, "back_to_back_ms": dev_ms["K1"],
         "host_ms": host_ms["K1"],
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "K2 composite_fwd", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/composite_fwd.cu",
         "replaces": "sage3d_tpu/ops/composite_pallas.py:156",
         "launches": launches["composite_fwd"]
         + launches_train["composite_fwd"] + launches_bench["composite_fwd"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "back_to_back_ms": dev_ms["K2"],
         "host_ms": host_ms["K2"],
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "K3 composite_bwd", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/composite_bwd.cu",
         "replaces": "sage3d_tpu/ops/composite_pallas.py:249",
         "launches": launches_train["composite_bwd"]
         + launches_bench["composite_bwd"], "max_abs_err": k3_err,
         "ms": k3_ms, "back_to_back_ms": dev_ms["K3"],
         "host_ms": host_ms["K3"],
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None, "registers": k3_regs},
        {"name": "K4 segment_reduce_sorted", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/segreduce.cu",
         "replaces": "sage3d_tpu/ops/segreduce.py:55",
         "launches": launches_train["segreduce"] + launches_bench["segreduce"],
         "max_abs_err": k4_err,
         "ms": k4_ms, "back_to_back_ms": dev_ms["K4"],
         "host_ms": host_ms["K4"],
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": k4_lib_ms,
         "library_back_to_back_ms": dev_ms["index_add_"],
         "library_host_ms": host_ms["index_add_"]},
        {"name": "K2 anatomy probe", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/composite_anatomy.cu",
         "replaces": "benchmarks/kernel_anatomy.py:44",
         "launches": probe_launches, "max_abs_err": probe_err,
         "ms": base_ms, "plain_ms": probe_plain_ms, "bound_ms": probe_bound,
         "bound_by": probe_by, "library_ms": None,
         "variant_ms": {n: v["ms"] for n, v in anatomy["variants"].items()},
         "registers": {n: v["registers"]
                       for n, v in anatomy["variants"].items()}},
    ]
    check(all(k["launches"] > 0 for k in kernels),
          "every kernel of the path launched on the main path")
    print(f"chip_smoke ran {time.perf_counter() - t_script:.1f} s", flush=True)
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
