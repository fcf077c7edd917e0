#!/usr/bin/env python3
"""Drive the PyTorch port's render, training, navigation, data, serving,
density-control and sharded paths on one CUDA card, at full size.

    python3 chip_smoke.py

Phases, in order (any failed check makes the script exit non-zero and print
no result line):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the seven CUDA sources of ``sage3d_tpu_torch/csrc``
     (K1-K6 and the K2 anatomy probe) with nvcc, one process per source, all
     at once;
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
  5d. the same 1080p/1M start through the ``torch`` backend over the chunks
     the ``cuda`` forward walked (each tile cut at its ``k_end``: the
     ``cuda`` backend's function): the gradients of all five trainable
     groups must agree with the ``cuda`` ones within ``GRAD_REL`` of
     max |torch|;
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
     and the probe's bound (K2's bytes and operations over every chunk);
  9. the navigation path on the 1M room of frames a and b (``navigation``):
     9a, ``build_collision_accel(chunk=8192)`` (123 chunks) and 64 agent
     capsules on a grid inside the walls: the dense ``capsule_query`` and the
     pruned query must agree below the margin (hit, hit_count, nearest_id
     equal, clearance within ``NAV_CLEAR_TOL``), on the card and against the
     same port code on a CPU copy of the scene; the clearance's gradient
     w.r.t. ``p0`` must be finite; K6's solid-test sigmoid bitwise
     ``torch.sigmoid`` over the room's logits and a sweep across 0; K6
     (``csrc/capsule.cu``) against its plain twin on the card, dense and
     pruned at B = 1, 4, 64 and 257 (``K6_BS``; both schedules, two query
     tiles), in the room and in its adversarial copy
     (``tests/capsule_cases.py``): the winning index, hit_count,
     chunks_visited, hit and nearest_id equal, the clearance within
     ``NAV_CLEAR_TOL``; per query through the entry points: ms (events),
     back-to-back and host ms, device busy, kernels and copies, one K6
     launch, host syncs (the pruned query none), peak memory; K6 alone at
     the rollout's B = 1 and at B = 64, each with its bound;
     9b, ``rollout`` for ``NAV_STEPS`` steps at 640x480 (the env's frame)
     over a 200x200 wall grid, budgets from ``autotune_poses`` over 16 poses
     (``pair_margin=1.5``), dense and pruned: overflow 0, K1, K2 and K6
     launched once a step (counted from 0 around the call), positions equal, the
     agent moves > 0.3 m; env-steps/s, the step split into render, policy
     and physics, and collision (CUDA events over a replay of the loop),
     device busy and idle share a step, peak memory; ``rollout_batch`` B = 4
     in both modes, each equal to the single rollouts; K1 and K2 against
     their plain versions, with the gates of phases 3 and 4, at the densest
     of the 16 probe poses and at the rollout frame that walked the most
     chunks, with the 9b budgets;
     9c, ``run_benchmark`` with ``OraclePolicy`` over 4 GVLN episodes in
     ``GaussianVLNEnv(map_json=...)`` at 640x480: no failure, a success, a
     policy answer on every step, overflow 0; one episode through
     ``ScriptedPolicyServer`` and ``make_socket_policy`` whose STOP is
     honoured; ms a step, ``get_rgb`` and ``apply_cmd_for``, host syncs a step;
 10. the SAGE-Bench data path (``data_path``): 10a, the wavefront planner
     (``sage3d_tpu_torch.benchmarks.planner_bench``) on its 240x240 indoor
     grid and at 400x400 (a 20x20 m apartment at 0.05 m/px), 64 pairs each,
     K5 (``csrc/wavefront.cu``) counted from 0 around each run:
     reachability equal to host A*'s and path lengths within max(2, 2%), the
     card's distance fields bitwise the CPU's and K5's plain twin's on the
     card with the same relaxation count, one launch's field and flag
     bitwise; pairs/s, ms, relaxations, K5 launches (at most one per 8
     relaxations plus the chain's 7), host syncs and device busy a batch of
     16, and the bound of its relaxations; K5 alone at 240x240; 10b, ``process_scene`` with ``MockLLMClient`` on a
     semantic map of the 1M room (its walls, its 8 objects as 0.8 m
     squares): the batched planner runs, every point lies on a free cell;
     trajectories/s and the planner's share; 10c, ``transform_2d3d``, merge,
     ``actions``, ``generate_scene_images`` at 1024x768 over 8 trajectories
     with ``autotune_poses`` budgets over every waypoint camera, and the
     NaVILA set: overflow 0, K1 and K2 once a frame, a batch of ``cuda``
     frames within ``BACKEND_ATOL`` of the ``torch`` backend's, K1 and K2
     against their plain versions at the densest waypoint frame; frames/s,
     Mpix/s, a frame's split (render, uint8 and copy, JPEG), device busy;
     10d, ``run_batch_benchmark`` on one env over bundles of the 1M room and
     the 200k room (``build_scene_bundle``, labels from the 8 objects'
     boxes), 5 oracle episodes a scene (4 routes and a Goal-less one), each
     scene with its own ``autotune_poses`` budgets: every step answered,
     overflow 0 on both scenes, the 13 measures in both files' results; ms an
     env step per scene and each hot swap's ``load_scene`` time;
 11. serving (``serving``): 11a, the CNN policy of ``serve/torch_policy.py``
     at its defaults (96x128, 4 frames) on the card against its CPU copy, 8
     seeded frame stacks: logits within ``TF32_REL`` of max |logit|, the
     same action where the top two are clear; 11b, ``run_benchmark`` over
     phase 9c's 4 episodes at 640x480 in the 1M room with the policy served
     by ``make_torch_policy_server(device="cuda")`` in a thread, reached
     through ``make_socket_policy``, ``max_steps`` ``SERVE_STEPS``: no
     failure, a policy answer on every step, overflow 0, K1 and K2 once a
     frame; ms an env step, a request's p50 and p99 split into decode +
     ``prep_frames`` and the device call, host syncs a step; 11c,
     ``from_torch_policy(max_batch=8)`` and the unbatched server under 8
     client threads of 16 requests: valid answers, fewer batches than
     requests, a batch of 2 or more; requests/s, latency p50 and p99; 11d,
     a compressed PLY of the 1M room (``tests/splat_transform_port.py``):
     the native decoder in use and within 1e-5 of the Python one,
     ``load_ply(device="cuda")`` ms, frame a of it with overflow 0, ``cli
     validate-ply`` exits 0, ``cli run-benchmark`` on a compressed 20k room
     against the policy server with render's default budgets and with
     ``--budgets``: both exit 0 and print ``total_overflow``, 0 with
     ``--budgets``;
 12. ADC training (``adc_training``): ``fit_scene_adaptive(backend="cuda")``
     from ``importance_subset`` (100k) of frame c's 200k room towards its
     renders from 4 orbit views at 640x480 (budgets from
     ``autotune_poses(pair_margin=1.5)``), capacity 200k, 60 steps, density
     control every 20, one opacity reset after step 40, each step and
     round observed through the trainer module's names: K1-K4 every step,
     the loss finite and falling between control events, ``n_alive``
     growing, overflow 0 at the start, after each round and at the end, one
     Adam throughout with the opacity moments zero after the reset, each
     ``densify_prune`` round equal to it on a CPU copy with the same
     generator state; step ms, Mpix/s, round ms, launches, device busy and
     idle share of a step, peak memory;
 13. the sharded path (``sharded_path``), its ranks processes that share
     the card over gloo (NCCL refuses two ranks on one device, so their
     collectives run through the host, not NVLink), each run counting K1-K4
     on the ranks from 0: 13a, frame a through ``render_tile_sharded`` on
     (1, 2) and (1, 4) meshes: overflow 0 in every band, K1 and K2 once a
     band, rgb/alpha within ``K2_ATOL`` of phase 5's unsharded frame, and
     the tiles whose k_end differs; ms a frame and its split (scene gather,
     band render, band gather); 13b, the sharded train step through
     ``dryrun_multihost`` on (1, 2), (2, 1) and (2, 2) meshes (hosts x ranks
     a host) with frame a's camera and one 0.3 m beside it at 1920x1080, the
     group Adam and 4 gather buckets: every rank's losses bitwise equal (the
     dry run raises otherwise), the first step's gathered gradients within
     5e-4 of each group's max of the direct step's, the loss falling,
     ``SHARD_COUNTS`` collectives a step, N / n_tile shard rows, overflow 0
     with the first and last parameters; step ms split into collectives,
     Adam and the rest, bytes, transport and peak memory a rank; 13c, the
     collective path on a one-rank NCCL mesh (``force_shard_map``) bitwise
     the direct step over 3 steps at frame a, and its cost a step; 13d,
     ``fit_scene_adaptive`` on a (1, 2) mesh at cell adc's sizes (20 steps,
     rounds after 10 and 20): the trainer's bitwise check of every rank's
     scene after each round, the fitted scenes bitwise equal, the loss
     falling between rounds; step and round ms.

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
# K5 and K6 build with -fmad=false and do no FMA: each f32 operation is one
# instruction a lane, at half the FMA rate.
FP32_NONFMA_OPS_PER_S = 33.5e12
# K5, one cell of one relaxation: 8 neighbour adds and 8 minima, the
# obstacle add and the clamp.
K5_OPS_PER_CELL = 18
# K6, a division, a sqrtf or an exp counted as one operation: every
# Gaussian, the opacity's sigmoid and the solid test (5); every solid one,
# the quaternion's norm and normalisation, the rotation's nine entries and
# three exps (59: K6 returns after the solid test for the others); every
# pair with a solid Gaussian, t and the closest point, dist, the three
# rotated coordinates and their squares, maha, support, the clearance, the
# contact test and the minimum's test (60). The scene's bytes: means,
# quats, log-scales and the opacity logit, 44 a Gaussian; a query's: p0 and
# p1 in, the clearance, index and contacts out (40).
K6_OPS_PER_GAUSSIAN, K6_OPS_PER_SOLID, K6_OPS_PER_PAIR = 5, 59, 60
K6_BYTES_PER_GAUSSIAN, K6_BYTES_PER_QUERY = 44, 40
K6_BS = (1, 4, 64, 257)  # 9a: K6 against its twin and each query's cost

# Phase 9, the navigation path on the 1M room.
NAV_W, NAV_H = 640, 480  # the env's own frame (vln_env.py's defaults)
NAV_STEPS = 100         # rollout steps (the JAX rollout's default)
NAV_BATCH_STEPS = 25    # steps of each episode of the B = 4 batches
NAV_RUNNER_STEPS = 80   # the runner's max_steps per episode
NAV_MARGIN = 2.0        # the pruned query's prune_margin (its default)
NAV_CLEAR_TOL = 1e-5    # clearance and positions: dense vs pruned, card vs CPU
NAV_START, NAV_YAW, NAV_GOAL = [3.0, -3.0], 2.4, [-3.0, 3.0]
NAV_STARTS = ((-3.0, -3.0), (3.0, -3.5), (-3.5, 3.0), (0.0, -1.0))  # runner

# Phase 10, the SAGE-Bench data path on the 1M room.
PLANNER_GRIDS = ((240, 64, 64), (400, 64, 16))  # grid side, pairs, of them
                        # also planned by host A* (~0.8 s a pair at 400)
BATCH_PLAN = 16         # plan_many's sources a wavefront (its default)
DATA_W, DATA_H = 1024, 768  # the waypoint frame (images.py's)
DATA_BATCH = 8          # generate_scene_images' batch_size (its default)
DATA_TRAJS = 8          # trajectories rendered to waypoint images
DATA_LABELS = ("table", "sofa", "wardrobe", "plant", "chair", "lamp", "tv",
               "refrigerator")  # the 8 objects' categories
# Phase 11, serving on the 1M room.
TF32_REL = 1e-2         # CNN logits, card vs CPU, over max |logit|: cuDNN may
                        # run the convolutions in TF32 (10-bit mantissa)
SERVE_STEPS = 50        # the runner's max_steps: a random CNN rarely stops
SERVE_CLIENTS = 8       # 11c: client threads ...
SERVE_REQUESTS = 16     # ... of this many requests each

# Phase 12, ADC training on frame c's 200k room.
ADC_N = 200_000         # slot capacity (the target's size)
ADC_START = 100_000     # importance_subset of the target: the start
ADC_VIEWS, ADC_W, ADC_H = 4, 640, 480   # orbit views inside the walls
ADC_STEPS = 60
ADC_EVERY = 20          # densify_every: rounds after steps 20, 40 and 60
ADC_RESET = 40          # opacity_reset_every: one reset, after step 40
ADC_GRAD = 1e-7         # grad_threshold on the mean |d loss / d mean| (the
                        # JAX test's); the loss is a per-pixel mean
SPLIT_MEAN_TOL = 1e-6   # split offspring means, card vs CPU: exp and the
                        # rotation's 3-term sums round differently there

# Phase 13, the sharded path: the ranks of a mesh are processes sharing the
# one card, joined over gloo (NCCL refuses two ranks on one device), so their
# collectives run through the host, not NVLink.
SHARD_MESHES = ((1, 2), (1, 4))   # 13a: band rendering
SHARD_FRAMES = 10       # 13a: frames timed a mesh (CUDA events on rank 0)
SHARD_STEP_MESHES = ((1, 2), (2, 1), (2, 2))  # 13b: hosts x ranks a host
SHARD_STEPS = 8         # 13b: 2 warm-ups, 5 timed, the last with collective
                        # times (the device synchronized around each)
SHARD_CAM_OFFSET = 0.3  # 13b: the second camera, beside frame a's (m)
SHARD_COUNTS = {"all_gather": 20, "reduce_scatter": 20, "all_reduce": 5,
                "loss_all_reduce": 1}   # a step, grad_buckets 4: JAX's
                        # written counts (MULTICHIP_r05.json) and the loss
ONE_RANK_STEPS = 3      # 13c: steps held bitwise, direct vs one-rank NCCL
ONE_RANK_TIMED = 9      # 13c: steps timed each way, in turns, after 2
                        # warm-ups
ADC_MESH_STEPS, ADC_MESH_EVERY = 20, 10   # 13d: rounds after 10 and 20
SHARD_TIMEOUT = 600     # a spawned mesh or a dry run (s)

MEASURES = {"distance_to_goal", "success", "oracle_success", "path_length",
            "spl", "navigation_error", "collision_count",
            "continuous_success_ratio", "integrated_collision_penalty",
            "path_smoothness", "episode_time", "explored_areas",
            "exploration_coverage"}

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


BENCH_CAM = dict(position=[0.0, -6.0, 1.5], forward=[0.0, 1.0, -0.05],
                 focal_mm=14.0)     # bench.py:228-229's camera
FRAME_A = (1_000_000, 1920, 1080)   # frame a: Gaussians, width, height


def frame_a(device):
    """Frame a: ``synthetic_room(1_000_000, seed=0)`` and bench.py's camera
    at 1920x1080."""
    from sage3d_tpu_torch.renderer.camera import make_camera
    from sage3d_tpu_torch.renderer.scene import synthetic_room
    n, width, height = FRAME_A
    return (synthetic_room(n, seed=0, device=device),
            make_camera(width=width, height=height, **BENCH_CAM,
                        device=device))


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
    room, cam_a = frame_a(device)
    return {
        "a_1080p_1M": (room, cam_a),
        "b_4k_1M": (room, make_camera(width=3840, height=2160,
                                      **BENCH_CAM, device=device)),
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


def counting_syncs(fn):
    """``fn()`` and the host syncs it made (torch.cuda.set_sync_debug_mode;
    its one-time notice that the mode is a prototype is not a sync)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message)
                    and "prototype" not in str(w.message) for w in caught)


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


def k6_bound(n_g: int, n_solid: int, b: int):
    """K6's least time in ms for B dense queries over ``n_g`` Gaussians of
    which ``n_solid`` are solid (the non-FMA rate), and what sets it."""
    t_b = (n_g * K6_BYTES_PER_GAUSSIAN + b * K6_BYTES_PER_QUERY + 4) \
        / HBM_BYTES_PER_S
    t_o = (n_g * K6_OPS_PER_GAUSSIAN + n_solid * K6_OPS_PER_SOLID
           + b * n_solid * K6_OPS_PER_PAIR) / FP32_NONFMA_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def ops_bound(n_bytes, evals, per_eval, hits, per_hit):
    """The least time in ms for ``n_bytes`` moved and the operations of
    ``evals`` pair-pixel evaluations and ``hits`` of them with alpha > 0,
    and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = (evals * per_eval + hits * per_hit) / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, (
        "bytes" if t_bytes >= t_ops else "operations")


def k1_k2_against_plain(scene, cam, bk, label: str) -> dict:
    """K1 and K2 against their plain versions at one frame, on the inputs
    ``render`` gives them with the budgets ``bk``, with the gates of frame a.
    K1 in both key modes: the kernel writes the kept pairs in no particular
    order and the plain version in slot order; keys are unique, so both are
    compared sorted. K2 on the kept pairs cut to the budgets. Returns the
    frame's projection, plan, bins, the kernels' arguments and K2's output
    for the phases that follow."""
    import torch
    from sage3d_tpu_torch.ops import binning, composite_cuda
    from sage3d_tpu_torch.ops.projection import project_gaussians
    with torch.no_grad():
        proj = project_gaussians(scene, cam)
        emit_kw = {k: bk[k] for k in binning.EMIT_BUDGET_KEYS}
        plan = binning.emission_plan(proj, cam.width, cam.height, **emit_kw)
        bins = binning.bin_gaussians(proj, cam.width, cam.height, **emit_kw)

    def sorted_pairs(keys, gauss, n_kept):
        n = int(n_kept)
        keys, perm = torch.sort(keys[:n])
        return keys, gauss[:n][perm]

    n_tiles = plan.tiles_x * plan.tiles_y
    k1_args = (plan.table, plan.offsets, plan.n_live, plan.tiles_x)
    k1_equal = True
    for mult in (plan.mult, 0):
        got = sorted_pairs(*binning.emit_tile_pairs(*k1_args, mult))
        want = sorted_pairs(*binning.emit_tile_pairs_plain(*k1_args, mult))
        torch.cuda.synchronize()
        equal = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        k1_equal &= equal
        print(f"K1 at {label} (mult={mult}): {plan.n_live} live slots, "
              f"{len(got[0])} kept pairs (plain {len(want[0])}); sorted pairs "
              f"equal: {equal}", flush=True)
        del got, want
    check(k1_equal, f"{label}: K1's pairs sorted by key equal the plain "
          "version's (fused and two-key)")

    attrs = composite_cuda.attribute_table(proj, scene.semantic_ids)
    pg, start, count, _ = composite_cuda.trim_to_capacity(
        bins, bk["pair_capacity"])
    count = torch.clamp(count, max=bk["tile_capacity"])
    k2_args = (attrs, pg, start, count, plan.tiles_x)
    out_k, kend_k = composite_cuda.composite_fwd(*k2_args)
    out_p, kend_p = composite_cuda.composite_fwd_plain(*k2_args)
    torch.cuda.synchronize()
    k2_err = max(float((out_k[:, ch] - out_p[:, ch]).abs().max())
                 for ch in (0, 1, 2, 4, 5))
    depth_ok = bool(torch.allclose(out_k[:, 3], out_p[:, 3], rtol=K2_DEPTH_TOL,
                                   atol=K2_DEPTH_TOL))
    sem_agree = float((out_k[:, 7] == out_p[:, 7]).float().mean())
    kend_diff = int((kend_k != kend_p).sum())
    print(f"K2 vs plain at {label}: max_abs rgb/alpha/trans {k2_err:.3e}, "
          f"semantic agreement {sem_agree:.6f}, k_end differs on {kend_diff} "
          f"of {n_tiles} tiles, sum k_end {int(kend_k.sum())}, max k_end "
          f"{int(kend_k.max())} a tile (one block walks a tile's chunks in "
          f"order)", flush=True)
    check(k2_err <= K2_ATOL, f"{label}: K2 rgb/alpha/trans within {K2_ATOL}")
    check(depth_ok, f"{label}: K2 depth_acc within rtol=atol={K2_DEPTH_TOL}")
    check(sem_agree >= SEM_MIN, f"{label}: K2 semantic agreement >= {SEM_MIN}")
    check(kend_diff <= KEND_MAX_DIFF * n_tiles,
          f"{label}: K2 k_end differs on <= {KEND_MAX_DIFF:.1%} of tiles")
    return dict(proj=proj, plan=plan, bins=bins, k1_args=k1_args,
                k1_equal=k1_equal, attrs=attrs, k2_args=k2_args,
                k2_err=k2_err, out_k=out_k, kend_k=kend_k)


def nav_semantic_map() -> list:
    """The 1M room's 2D semantic map: walls on its x = +-5 and y = +-5 m
    walls, one table at world (3, 2.5), floor points; map bounds [-5, 5] on
    both axes, so map and world coordinates coincide."""
    import numpy as np
    edge = np.round(np.linspace(-5.0, 5.0, 201), 4).tolist()
    wall = [p for t in edge for p in ([-5.0, t], [5.0, t], [t, -5.0],
                                      [t, 5.0])]       # [y, x] pairs
    table = [[round(y, 2), round(x, 2)] for y in np.arange(2.0, 3.001, 0.1)
             for x in np.arange(2.5, 3.501, 0.1)]
    floor = [[y, x] for y in edge[::20] for x in edge[::20]]
    return [
        {"category_label": "Wall", "instance_id": 0, "item_id": "label_0",
         "mask_coords_m": wall, "bbox_m": [-5.0, -5.0, 5.0, 5.0]},
        {"category_label": "Table", "instance_id": 3, "item_id": "label_3",
         "mask_coords_m": table, "bbox_m": [2.5, 2.0, 3.5, 3.0]},
        {"category_label": "floor", "instance_id": 9, "item_id": "label_9",
         "mask_coords_m": floor, "bbox_m": [-5.0, -5.0, 5.0, 5.0]},
    ]


def nav_episodes(tmp, scene_name: str = "room1m",
                 traj_name: str = "trajectories_room.json",
                 goal_less: bool = False) -> tuple:
    """A GVLN trajectory file of straight routes from NAV_STARTS to the table
    (with ``goal_less``, route 0 also carries a Goal-less instruction: one
    more episode, the no-goal measures), and the semantic map, written under
    ``tmp``; returns their paths."""
    import math
    from sage3d_tpu_torch.utils.transforms import world_quat_from_map_yaw
    goal = (3.0, 2.5)
    samples = []
    for i, start in enumerate(NAV_STARTS):
        pts = [(start[0] + (goal[0] - start[0]) * k / 4,
                start[1] + (goal[1] - start[1]) * k / 4) for k in range(5)]
        yaw = math.atan2(goal[1] - start[1], goal[0] - start[0])
        points = [{"position": [x, y, 0.5],
                   "rotation": list(world_quat_from_map_yaw(yaw))
                   if k < 4 else [0.0, 0.0, 0.0, 1.0]}
                  for k, (x, y) in enumerate(pts)]
        samples.append({"trajectory_id": str(i), "points": points,
                        "instructions": [{
                            "generated_instruction":
                                f"Walk to the table (route {i}, "
                                f"{scene_name}).",
                            "instruction_type": "AC", "start": "label_0",
                            "end": "label_3"}]})
    if goal_less:
        samples[0]["instructions"].append({
            "generated_instruction": f"Explore the room freely ({scene_name}).",
            "instruction_type": "Goal-less", "start": "label_0",
            "end": "label_0"})
    traj = tmp / traj_name
    traj.write_text(json.dumps({"scenes": [{
        "scene_id": 1, "scene_name": scene_name, "samples": samples}]}))
    map_path = tmp / f"2D_Semantic_Map_{scene_name}_Complete.json"
    map_path.write_text(json.dumps(nav_semantic_map()))
    return traj, map_path


def probe_poses(room) -> list:
    """16 probe poses, as ((x, y), yaw): the densest frames an agent in a
    synthetic room sees. The occupancy grid holds only the walls, so an
    agent walks through the room's objects: a pose at each object's centre
    (8), 4 close up facing a wall, and 4 anywhere inside the walls."""
    import numpy as np
    rng = np.random.default_rng(6)
    sem = room.semantic_ids
    poses = [((float(c[0]), float(c[1])), float(w)) for c, w in zip(
        [room.means[sem == k].mean(0).tolist()
         for k in range(1, int(sem.max()) + 1)],
        rng.uniform(-np.pi, np.pi, 8))]
    for i in range(4):
        ang = i * np.pi / 2 + np.pi / 4
        poses.append(((4.6 * np.cos(ang), 4.6 * np.sin(ang)), float(ang)))
    poses += [((float(x), float(y)), float(w)) for x, y, w in zip(
        rng.uniform(-4.0, 4.0, 4), rng.uniform(-4.0, 4.0, 4),
        rng.uniform(-np.pi, np.pi, 4))]
    return poses


def route_poses(episodes, spacing: float = 0.2) -> list:
    """Poses along episodes' reference paths, as ((x, y), yaw): every
    ``spacing`` m of each segment (an agent's step is up to 0.2 m), facing
    along it, and the last gt location: the views an agent that follows the
    route sees, walking through the objects in its way."""
    import math
    poses = []
    for ep in episodes:
        pts = [p[:2] for p in ep["gt_locations"]]
        yaw = 0.0
        for a, b in zip(pts, pts[1:]):
            yaw = math.atan2(b[1] - a[1], b[0] - a[0])
            n = max(1, math.ceil(math.dist(a, b) / spacing))
            poses += [((a[0] + (b[0] - a[0]) * k / n,
                        a[1] + (b[1] - a[1]) * k / n), yaw) for k in range(n)]
        poses.append(((float(pts[-1][0]), float(pts[-1][1])), yaw))
    return poses


def k6_phase(room, accel, xy, card: str, reset_peak) -> dict:
    """Phase 9a's K6 part on the 1M room and its accel, with the grid
    capsules ``xy``: the sigmoid gate, K6 against its plain twin, each
    query's cost through the entry points, and K6 alone with its bounds.
    Returns the ``kernels`` line's K6 numbers (launches aside)."""
    from pathlib import Path

    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from capsule_cases import adversarial_room, capsules
    from sage3d_tpu_torch.ops import collision
    from sage3d_tpu_torch.ops.collision import (agent_capsule,
                                                build_collision_accel,
                                                capsule_query,
                                                capsule_query_pruned)
    dev = room.means.device
    n_chunks = accel.aabb_min.shape[0]
    # K6 against its plain twin on the card, on the inputs the queries give
    # it, in the room and in its adversarial copy (tests/capsule_cases.py):
    # the indices, contact counts, visited chunks and the assembled result
    # equal, the clearances the same f32 operations (0 expected). B = 257
    # adds draws inside the walls to the 64 grid capsules.
    xy_all = np.concatenate([xy, np.random.default_rng(5).uniform(
        -4.2, 4.2, (max(K6_BS) - len(xy), 2))])
    p0, p1, r = agent_capsule(xy_all)
    sig = torch.cat([room.opacity_logits,
                     torch.linspace(-1e-5, 1e-5, 1 << 16, device=dev)])
    same_sig = torch.equal(collision.capsule_sigmoid(sig).view(torch.int32),
                           torch.sigmoid(sig).view(torch.int32))
    print(f"9a K6's solid-test sigmoid vs torch.sigmoid on the card over "
          f"{sig.numel()} logits (the room's and a sweep across 0): bitwise "
          f"{same_sig}", flush=True)
    check(same_sig, "9a: K6's sigmoid equals torch.sigmoid bitwise")
    adv = adversarial_room(room)
    adv_accel = build_collision_accel(adv, chunk=8192)
    xy_adv = capsules(max(K6_BS))
    k6 = {"max_abs_err": 0.0}
    for label, sc, acc, pts in (("room", room, accel, (p0, p1)),
                                ("adversarial room", adv, adv_accel,
                                 agent_capsule(xy_adv)[:2])):
        for b in K6_BS:
            q = collision._queries(pts[0][:b], pts[1][:b], r, dev)
            for name, sc_k, prune in (
                    ("dense", sc, None),
                    ("pruned", acc.scene, (acc.aabb_min, acc.aabb_max,
                                           acc.max_scale, NAV_MARGIN))):
                cols_k, ids = collision._columns(sc_k), sc_k.semantic_ids
                got = collision.capsule_best(q, cols_k, prune=prune, ids=ids)
                want = collision.capsule_best_plain(q, cols_k, prune=prune,
                                                    ids=ids)
                torch.cuda.synchronize()
                err = max(float((got[k] - want[k]).abs().max())
                          for k in (0, 6))
                same = all(torch.equal(got[k], want[k])
                           for k in (1, 2, 3, 4, 5))
                k6["max_abs_err"] = max(k6["max_abs_err"], err)
                print(f"9a K6 {label} {name} B={b} vs its plain twin on the "
                      f"card: index, hit_count, chunks_visited, hit, "
                      f"nearest_id equal {same}, max |clearance diff| "
                      f"{err:.3e}", flush=True)
                check(same and err <= NAV_CLEAR_TOL,
                      f"9a K6 {label} {name} B={b}: index, hit_count, chunks "
                      f"visited and the result equal to the plain twin's on "
                      f"the card, clearance within {NAV_CLEAR_TOL}")
    del adv, adv_accel
    for b in K6_BS:
        for name, fn in (
                ("dense", lambda: capsule_query(room, p0[:b], p1[:b], r)),
                ("pruned", lambda: capsule_query_pruned(
                    accel, p0[:b], p1[:b], r, prune_margin=NAV_MARGIN))):
            ms = cuda_ms(fn, reps=10, warmup=2)
            b2b, host = back_to_back_ms(fn)
            busy, n_ops, _ = device_busy(fn, reps=5)
            _, k6_n = launches_of([collision.capsule_best], fn)
            _, syncs = counting_syncs(fn)
            held = reset_peak()
            res = fn()
            torch.cuda.synchronize()
            q_peak = torch.cuda.max_memory_allocated() - held
            visited = (f", chunks_visited {int(res['chunks_visited'])} of "
                       f"{n_chunks}" if name == "pruned" else "")
            del res
            schedule = "many" if b > collision.FEW_MAX else "few"
            print(f"9a capsule query {name} B={b} ({schedule}-query "
                  f"schedule) {card}: {ms:.3f} ms a query "
                  f"(CUDA events, median of 10), {b2b:.4f} ms back to back, "
                  f"host {host:.4f} ms, device busy {busy:.4f} ms, "
                  f"{n_ops:.0f} kernels and copies a query, K6 launches "
                  f"{k6_n[0]}, host syncs {syncs}{visited}, peak "
                  f"device memory {q_peak / 2**20:.1f} MiB above what was "
                  f"held", flush=True)
            check(k6_n[0] == 1, f"9a {name} B={b}: one K6 launch a query")
            if name == "pruned":
                check(syncs == 0, f"9a pruned B={b}: no host sync")

    # K6 alone at the rollout's query (B = 1, dense) and at B = 64, for the
    # kernels line.
    cols_d = collision._columns(room)
    n_g = room.num_gaussians
    n_solid = int((torch.sigmoid(cols_d[3])
                   >= collision.DEFAULT_OPACITY_THRESH).sum())
    q1 = collision._queries(p0[:1], p1[:1], r, dev)
    q64 = collision._queries(p0[:64], p1[:64], r, dev)
    k6["ms"] = cuda_ms(lambda: collision.capsule_best(q1, cols_d), reps=20,
                       warmup=3)
    k6["back_to_back_ms"], k6["host_ms"] = back_to_back_ms(
        lambda: collision.capsule_best(q1, cols_d))
    k6["plain_ms"] = cuda_ms(lambda: collision.capsule_best_plain(
        q1, cols_d), reps=5, warmup=1)
    k6["bound_ms"], k6["bound_by"] = k6_bound(n_g, n_solid, 1)
    k6["b64_back_to_back_ms"], b64_host = back_to_back_ms(
        lambda: collision.capsule_best(q64, cols_d))
    k6["b64_bound_ms"], b64_by = k6_bound(n_g, n_solid, 64)
    print(f"K6 dense B=1 {card}: {k6['ms']:.4f} ms (events around one "
          f"call), {k6['back_to_back_ms']:.4f} ms back to back, host "
          f"{k6['host_ms']:.4f} ms; plain twin {k6['plain_ms']:.3f} ms; bound "
          f"{k6['bound_ms']:.4f} ms ({k6['bound_by']}, {n_solid} solid of "
          f"{n_g}), share {k6['bound_ms'] / k6['back_to_back_ms']:.3f}; "
          f"B=64: {k6['b64_back_to_back_ms']:.4f} ms back to back, host "
          f"{b64_host:.4f} ms, bound {k6['b64_bound_ms']:.4f} ms ({b64_by}), "
          f"share {k6['b64_bound_ms'] / k6['b64_back_to_back_ms']:.3f}",
          flush=True)

    return k6


def navigation(room, card: str) -> list:
    """Phase 9, the navigation path on the 1M room (see the module
    docstring). Returns K1's and K2's launches on its main-path runs, each
    counted from 0 just before the run and read just after, and the phase's
    peak device memory."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from sage3d_tpu_torch.bench.episodes import adapt_gvln_to_episodes
    from sage3d_tpu_torch.bench.runner import run_benchmark, run_episode
    from sage3d_tpu_torch.bench.tasks import (TaskTypeManager,
                                              adapt_episode_for_task)
    from sage3d_tpu_torch.env.rollout import (depth_seek_policy, rollout,
                                              rollout_batch)
    from sage3d_tpu_torch.env.vln_env import GaussianVLNEnv
    from sage3d_tpu_torch.ops import binning, collision, composite_cuda
    from sage3d_tpu_torch.ops.collision import (agent_capsule,
                                                build_collision_accel,
                                                capsule_query,
                                                capsule_query_pruned)
    from sage3d_tpu_torch.physics.agent import apply_cmd, init_agent
    from sage3d_tpu_torch.physics.occupancy import grid_from_mask
    from sage3d_tpu_torch.renderer.camera import (agent_camera,
                                                  agent_camera_t,
                                                  stack_cameras)
    from sage3d_tpu_torch.renderer.render import (autotune_poses,
                                                  budget_kwargs, render)
    from sage3d_tpu_torch.renderer.scene import GaussianScene
    from sage3d_tpu_torch.serve.policy import OraclePolicy, make_socket_policy
    from sage3d_tpu_torch.serve.scripted_server import ScriptedPolicyServer

    dev = room.device
    kernels = (binning.emit_tile_pairs, composite_cuda.composite_fwd,
               collision.capsule_best)
    launched = [0, 0, 0]
    peak = [torch.cuda.max_memory_allocated()]     # the phase's, over resets

    def reset_peak() -> int:
        """Fold the peak so far into the phase's, reset it, and return the
        memory held now."""
        torch.cuda.synchronize()
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def counted(fn):
        """``fn()`` with K1's, K2's and K6's counters set to 0 just before
        and read just after; the counts join the phase's launches."""
        for k in kernels:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = [k.launches for k in kernels]
        for i, v in enumerate(n):
            launched[i] += v
        return out, n

    # 9a. collision at full size ---------------------------------------------
    t0 = time.perf_counter()
    accel = build_collision_accel(room, chunk=8192)
    torch.cuda.synchronize()
    accel_first = (time.perf_counter() - t0) * 1e3
    accel_ms = cuda_ms(lambda: build_collision_accel(room, chunk=8192),
                       reps=3, warmup=0)
    n_chunks = accel.aabb_min.shape[0]
    print(f"9a build_collision_accel(1M, chunk=8192) {card}: {n_chunks} "
          f"chunks, first call {accel_first:.1f} ms, then {accel_ms:.2f} ms "
          f"(median of 3, CUDA events)", flush=True)
    check(n_chunks == 123, "9a: the 1M room's accel has 123 chunks of 8192")
    g = np.linspace(-4.2, 4.2, 8)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    p0, p1, r = agent_capsule(xy)
    dense = capsule_query(room, p0, p1, r)
    pruned = capsule_query_pruned(accel, p0, p1, r, prune_margin=NAV_MARGIN)

    def agree(got, want, what, ids=True):
        """hit and hit_count equal, clearance below the margin within
        NAV_CLEAR_TOL, and with ``ids`` nearest_id below the margin equal
        (across devices a near-tie of two Gaussians may order either way)."""
        got = {k: v.cpu() for k, v in got.items()}
        want = {k: v.cpu() for k, v in want.items()}
        below = want["clearance"] < NAV_MARGIN
        err = float((got["clearance"][below] - want["clearance"][below]
                     ).abs().max()) if bool(below.any()) else 0.0
        same = (torch.equal(got["hit"], want["hit"])
                and torch.equal(got["hit_count"], want["hit_count"])
                and (not ids or torch.equal(got["nearest_id"][below],
                                            want["nearest_id"][below])))
        print(f"9a {what}: hits {int(got['hit'].sum())}/64, hit_count "
              f"{int(got['hit_count'].sum())}, {int(below.sum())} below the "
              f"margin, max |clearance diff| {err:.3e}", flush=True)
        check(same and err <= NAV_CLEAR_TOL,
              f"9a {what}: hit, hit_count" + (" and nearest_id below the "
                                              "margin" if ids else "")
              + f" equal, clearance within {NAV_CLEAR_TOL}")

    agree(pruned, dense, "pruned vs dense on the card")
    cpu_room = GaussianScene(*(t.cpu() for t in room))
    cp0, cp1 = p0.cpu(), p1.cpu()
    dense_cpu = capsule_query(cpu_room, cp0, cp1, r, device="cpu")
    accel_cpu = build_collision_accel(cpu_room, chunk=8192, device="cpu")
    pruned_cpu = capsule_query_pruned(accel_cpu, cp0, cp1, r,
                                      prune_margin=NAV_MARGIN, device="cpu")
    agree(dense, dense_cpu, "dense, card vs CPU", ids=False)
    agree(pruned, pruned_cpu, "pruned, card vs CPU", ids=False)
    check(torch.equal(accel.scene.means.cpu(), accel_cpu.scene.means)
          and torch.equal(accel.aabb_min.cpu(), accel_cpu.aabb_min),
          "9a: the accel's Morton order and AABBs equal on the card and CPU")
    del cpu_room, accel_cpu
    leaf = p0.clone().requires_grad_()
    (grad,) = torch.autograd.grad(
        capsule_query(room, leaf, p1, r)["clearance"].sum(), leaf)
    check(bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0,
          "9a: the clearance's gradient w.r.t. p0 is finite and non-zero")
    k6 = k6_phase(room, accel, xy, card, reset_peak)

    # 9b. rollouts -----------------------------------------------------------
    mask = np.zeros((200, 200), np.uint8)
    mask[:2, :] = mask[-2:, :] = 1
    mask[:, :2] = mask[:, -2:] = 1
    grid = grid_from_mask(mask, bounds=[-5.0, 5.0, -5.0, 5.0])
    poses = probe_poses(room)
    cams = stack_cameras([agent_camera(xy_, yaw_, width=NAV_W, height=NAV_H,
                                       device=dev) for xy_, yaw_ in poses])
    budgets = autotune_poses(room, cams, pair_margin=1.5)
    bk = budget_kwargs(budgets)
    print(f"9b budgets (autotune_poses, 16 poses, pair_margin 1.5): "
          f"{json.dumps(budgets)}", flush=True)
    size = dict(width=NAV_W, height=NAV_H, **bk)
    nav = dict(start_xy=NAV_START, start_yaw=NAV_YAW, goal_xy=NAV_GOAL, **size)
    rollout(room, grid, **{**nav, "n_steps": 3})           # warm-up
    reset_peak()
    t0 = time.perf_counter()
    out, n = counted(lambda: rollout(room, grid, n_steps=NAV_STEPS, **nav))
    wall = time.perf_counter() - t0
    roll_peak = torch.cuda.max_memory_allocated()
    step_ms = wall * 1e3 / NAV_STEPS
    moved = float(torch.linalg.vector_norm(
        out["final_pos"][:2] - torch.tensor(NAV_START, device=dev)))
    print(f"9b rollout dense, {NAV_STEPS} steps at {NAV_W}x{NAV_H} on the "
          f"room "
          f"{card}: {NAV_STEPS / wall:.2f} env-steps/s ({step_ms:.3f} ms a "
          f"step), launches K1 {n[0]} K2 {n[1]} K6 {n[2]}, total_overflow "
          f"{int(out['total_overflow'])}, moved {moved:.3f} m, goal distance "
          f"{float(out['goal_distance'][0]):.3f} -> "
          f"{float(out['goal_distance'][-1]):.3f} m, collisions "
          f"{int(out['total_collisions'])}, min clearance "
          f"{float(out['min_clearance'].min()):.3f} m, peak device memory "
          f"{roll_peak / 2**30:.2f} GiB", flush=True)
    check(int(out["total_overflow"]) == 0, "9b: overflow 0 on every step")
    check(n == [NAV_STEPS] * 3, "9b: K1, K2 and K6 launched once a step")
    check(moved > 0.3, "9b: the agent moves more than 0.3 m")
    check(all(bool(torch.isfinite(out[k]).all()) for k in
              ("positions", "min_clearance", "goal_distance", "mean_depth")),
          "9b: finite rollout metrics")
    t0 = time.perf_counter()
    out_p, n_p = counted(lambda: rollout(room, grid, n_steps=NAV_STEPS,
                                         collision_accel=accel,
                                         prune_margin=NAV_MARGIN, **nav))
    wall_p = time.perf_counter() - t0
    dc, pc = out["min_clearance"], out_p["min_clearance"]
    below = dc < NAV_MARGIN
    pos_err = float((out_p["positions"] - out["positions"]).abs().max())
    clear_err = float((pc[below] - dc[below]).abs().max()) \
        if bool(below.any()) else 0.0
    print(f"9b rollout pruned {card}: {NAV_STEPS / wall_p:.2f} env-steps/s "
          f"({wall_p * 1e3 / NAV_STEPS:.3f} ms a step), launches K1 {n_p[0]} "
          f"K2 {n_p[1]} K6 {n_p[2]}, positions "
          f"max |diff| {pos_err:.3e}, clearance below the margin max |diff| "
          f"{clear_err:.3e} ({int(below.sum())} steps)", flush=True)
    check(pos_err <= NAV_CLEAR_TOL and clear_err <= NAV_CLEAR_TOL
          and int(out_p["total_overflow"]) == 0 and n_p == [NAV_STEPS] * 3,
          "9b: pruned rollout's positions and clearance equal the dense "
          f"one's within {NAV_CLEAR_TOL}, overflow 0, K1, K2 and K6 once a "
          "step")

    # Where a step's time goes: the rollout's loop replayed with CUDA events
    # between its stages (its positions must be the rollout's).
    spans = {"render": [], "policy and physics": [], "collision dense": [],
             "collision pruned": []}
    walked = []     # a frame's sum of k_end: the chunks K2 walked
    st = init_agent([*NAV_START, 0.5], NAV_YAW)
    goal = torch.tensor(NAV_GOAL, device=dev)
    same = True
    with torch.no_grad():
        for i in range(NAV_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            pose = (st.pos[:2].clone(), st.yaw.clone())
            ev[0].record()
            frame = render(room, agent_camera_t(st.pos[:2], st.yaw,
                                                width=NAV_W, height=NAV_H),
                           **bk)
            ev[1].record()
            vx, wr = depth_seek_policy(frame["depth"], st.pos[:2], st.yaw,
                                       goal)
            st = apply_cmd(st, grid, vx, 0.0, wr, 1.0)
            ev[2].record()
            q0, q1, qr = agent_capsule(st.pos[None, :2])
            capsule_query(room, q0, q1, qr)
            ev[3].record()
            capsule_query_pruned(accel, q0, q1, qr, prune_margin=NAV_MARGIN)
            ev[4].record()
            ev[4].synchronize()
            for k, (a, b) in zip(spans, zip(ev, ev[1:])):
                spans[k].append(a.elapsed_time(b))
            n_walk = int(frame["grad_chunks"])
            if n_walk > max(walked, default=-1):
                densest = (i, pose)
            walked.append(n_walk)
            same &= torch.equal(st.pos, out["positions"][i])
    med = {k: statistics.median(v) for k, v in spans.items()}
    print(f"9b step split {card} (CUDA events, median of {NAV_STEPS} "
          f"replayed steps): " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in med.items())
          + f"; K2 walked {statistics.median(walked):.0f} chunks a frame "
          f"(median; {min(walked)}-{max(walked)}) over "
          f"{-(-NAV_W // 32) * -(-NAV_H // 32)} tiles", flush=True)
    check(same, "9b: the timed replay follows the rollout's positions")
    busy, n_ops, top = device_busy(
        lambda: rollout(room, grid, **{**nav, "n_steps": 10}), reps=1)
    print(f"9b device {card}: busy {busy / 10:.3f} ms a dense rollout step "
          f"of {step_ms:.3f} ms, idle share {1.0 - busy / 10 / step_ms:.3f}; "
          f"{n_ops / 10:.0f} kernels and copies a step (torch.profiler, CUDA "
          f"activity only, one unsynchronized 10-step rollout)", flush=True)
    for kname, kms, kn in top:
        print(f"  top kernel rollout: {kms / 10:.3f} ms, {kn / 10:g} launches "
              f"a step: {kname}", flush=True)

    starts = np.array([NAV_START, [-3.0, -3.0], [3.0, 3.0], [0.0, -4.0]],
                      np.float32)
    yaws = np.array([NAV_YAW, 0.8, -2.4, 1.57], np.float32)
    goals = np.array([NAV_GOAL, [3.0, 3.0], [-3.0, -3.0], [0.0, 4.0]],
                     np.float32)
    kw = dict(n_steps=NAV_BATCH_STEPS, **size)
    singles = [counted(lambda: rollout(room, grid, starts[b], yaws[b],
                                       goals[b], **kw))[0] for b in range(4)]
    # Both modes run the episodes one after another; each is held against
    # the single rollouts, so the two equal each other too.
    for mode in ("vmap", "map"):
        batch, n_b = counted(lambda: rollout_batch(
            room, grid, starts, yaws, goals, batch_mode=mode, **kw))
        worst, bitwise = 0.0, True
        for key, v in batch.items():
            other = torch.stack([s_[key] for s_ in singles])
            bitwise &= torch.equal(v, other)
            worst = max(worst, float((v.double() - other.double()
                                      ).abs().max()))
        print(f"9b rollout_batch {mode} B=4, {NAV_BATCH_STEPS} steps: "
              f"launches K1 {n_b[0]} K2 {n_b[1]} K6 {n_b[2]}, total_overflow "
              f"per episode "
              f"{batch['total_overflow'].tolist()}, vs the single rollouts "
              f"max |diff| {worst:.3e}, bitwise {bitwise}", flush=True)
        check(n_b == [4 * NAV_BATCH_STEPS] * 3
              and int(batch["total_overflow"].sum()) == 0
              and worst <= NAV_CLEAR_TOL,
              f"9b rollout_batch {mode}: K1, K2 and K6 once a step, overflow "
              "0, equal to the single rollouts")

    # K1 and K2 against their plain versions at this path's own shapes and
    # budgets: the densest probe pose (the most chunks walked) and the
    # rollout frame that walked the most.
    with torch.no_grad():
        walked_probe = [int(render(room, agent_camera(
            xy_, yaw_, width=NAV_W, height=NAV_H, device=dev),
            **bk)["grad_chunks"]) for xy_, yaw_ in poses]
    i_probe = int(np.argmax(walked_probe))
    xy_, yaw_ = poses[i_probe]
    print(f"9b chunks walked per probe pose: {walked_probe}", flush=True)
    k1_k2_against_plain(room, agent_camera(xy_, yaw_, width=NAV_W,
                                           height=NAV_H, device=dev), bk,
                        f"9b probe pose {i_probe} ({xy_[0]:.2f}, "
                        f"{xy_[1]:.2f}, yaw {yaw_:.2f})")
    k1_k2_against_plain(room, agent_camera_t(*densest[1], width=NAV_W,
                                             height=NAV_H), bk,
                        f"9b rollout step {densest[0]}")

    # 9c. the benchmark runner -----------------------------------------------
    have = {}
    for mod in ("PIL", "matplotlib", "requests"):
        try:
            __import__(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    print(f"9c packages: {json.dumps(have)}", flush=True)
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_nav_")
    tmp = Path(tmpdir.name)
    traj, map_path = nav_episodes(tmp)
    episodes = adapt_gvln_to_episodes(traj, "room1m.ply")
    env = GaussianVLNEnv(room, map_json=str(map_path), width=NAV_W,
                         height=NAV_H, budgets=budgets)

    def instruction_of(ep):
        task_type = TaskTypeManager.infer_task_type(ep)
        return TaskTypeManager.create_task(task_type, {}).get_instruction(
            adapt_episode_for_task(ep, task_type))

    oracles = {instruction_of(ep): OraclePolicy(env, ep) for ep in episodes}
    answers = {k: 0 for k in oracles}

    def policy(images, instruction, current_yaw=0.0, depth_images=None,
               **kw_):
        resp = oracles[instruction](images=images, instruction=instruction,
                                    current_yaw=current_yaw,
                                    depth_images=depth_images)
        answers[instruction] += 1
        return resp

    spent = {"get_rgb": 0.0, "apply_cmd_for": 0.0}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            res = fn(*a, **k)
            spent[name] += time.perf_counter() - t
            return res
        return run

    env.get_rgb = timed("get_rgb", env.get_rgb)
    env.apply_cmd_for = timed("apply_cmd_for", env.apply_cmd_for)
    out_dir = tmp / "runs"
    t0 = time.perf_counter()
    (summary, n_r), syncs = counting_syncs(lambda: counted(
        lambda: run_benchmark(env, episodes, policy, output_dir=str(out_dir),
                              max_steps=NAV_RUNNER_STEPS)))
    wall = time.perf_counter() - t0
    steps = {}
    for ep in episodes:
        eid = ep["episode_id"]
        rec = json.loads((out_dir / ep["scene_name"] / eid / "measurements"
                          / f"{eid}.json").read_text()) \
            if (out_dir / ep["scene_name"] / eid).exists() else None
        steps[eid] = (rec["episode_info"]["steps_run"] if rec else None,
                      answers[instruction_of(ep)])
    n_steps = sum(s for s, _ in steps.values() if s)
    print(f"9c run_benchmark, OraclePolicy, {len(episodes)} episodes at "
          f"{NAV_W}x{NAV_H} on the 1M room {card}: {json.dumps(summary)}",
          flush=True)
    print(f"9c steps_run and policy answers per episode: {json.dumps(steps)};"
          f" launches K1 {n_r[0]} K2 {n_r[1]}; env total_overflow "
          f"{int(env.total_overflow)}", flush=True)
    if n_steps:
        print(f"9c per env step {card}: {wall * 1e3 / n_steps:.3f} ms wall, "
              f"get_rgb {spent['get_rgb'] * 1e3 / n_steps:.3f} ms, "
              f"apply_cmd_for {spent['apply_cmd_for'] * 1e3 / n_steps:.3f} ms "
              f"(host clock; apply_cmd_for only queues its work), "
              f"{syncs / n_steps:.2f} host syncs a step "
              f"(torch.cuda.set_sync_debug_mode), {n_steps} steps",
              flush=True)
    check(summary["num_failures"] == 0 and summary["num_episodes"] == 4,
          "9c: the runner ran the 4 episodes without a failure")
    check(summary["num_success"] >= 1, "9c: at least one success")
    check(all(s is not None and s == a for s, a in steps.values()),
          "9c: the policy answered on every runner step (no fallback)")
    check(int(env.total_overflow) == 0, "9c: the env's frames overflow 0")
    check(n_r[0] == n_r[1] == n_steps, "9c: K1 and K2 once a frame")

    scripted = {"answers": 0}
    with ScriptedPolicyServer(script=["MOVE_FORWARD", "TURN_LEFT",
                                      "MOVE_FORWARD", "STOP"]) as srv:
        sock = make_socket_policy(host="127.0.0.1", port=srv.port)

        def socket_policy(**kw_):
            resp = sock(**kw_)
            scripted["answers"] += 1
            return resp

        rec, n_s = counted(lambda: run_episode(env, episodes[0],
                                               socket_policy, max_steps=10))
    info = rec["episode_info"]
    print(f"9c scripted socket server: steps_run {info['steps_run']}, "
          f"stop_called {info['stop_called']}, answers "
          f"{scripted['answers']}, launches K1 {n_s[0]} K2 {n_s[1]}",
          flush=True)
    check(info["stop_called"] and info["steps_run"] == 4
          and scripted["answers"] == 4,
          "9c: the scripted server's STOP is honoured on step 4")
    tmpdir.cleanup()
    reset_peak()
    return launched, peak[0], budgets, k6


def data_semantic_map(room) -> list:
    """The data path's 2D semantic map of a synthetic room: its walls at
    x, y = +-5 m (``nav_semantic_map``'s) and its 8 objects as instances,
    0.8 m squares at the mean of each object's Gaussians, labelled with
    ``DATA_LABELS`` (no two of one category or similar group)."""
    import numpy as np
    records = [nav_semantic_map()[0]]
    sem = room.semantic_ids
    half = np.round(np.arange(-0.4, 0.4001, 0.05), 4)
    for k, label in enumerate(DATA_LABELS, start=1):
        cx, cy = (round(float(v), 2) for v in room.means[sem == k].mean(0)[:2])
        records.append({
            "category_label": label, "instance_id": k,
            "item_id": f"label_{k}",
            "mask_coords_m": [[round(cy + dy, 4), round(cx + dx, 4)]
                              for dy in half for dx in half],
            "bbox_m": [cx - 0.4, cy - 0.4, cx + 0.4, cy + 0.4]})
    return records


def object_labels(scene) -> list:
    """labels.json records of a synthetic room: each object's box (the AABB
    of its Gaussians' means), as InteriorGS writes them."""
    labels = []
    for k, label in enumerate(DATA_LABELS, start=1):
        means = scene.means[scene.semantic_ids == k]
        lo, hi = means.min(0).values.tolist(), means.max(0).values.tolist()
        labels.append({"label": label, "ins_id": k, "bounding_box": [
            {"x": x, "y": y, "z": z} for x in (lo[0], hi[0])
            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]})
    return labels


def data_path(room, room_200k, card: str) -> list:
    """Phase 10, the SAGE-Bench data path (see the module docstring): the
    planner, trajectory generation, actions, waypoint images and NaVILA on
    the 1M room, and the batch benchmark's hot swap between bundles of the
    1M and the 200k room. Returns K1's and K2's launches on its main-path
    runs (the images and the batch), each counted from 0 just before the
    run and read just after."""
    import tempfile
    from io import BytesIO
    from pathlib import Path

    import numpy as np
    import torch
    from PIL import Image
    from sage3d_tpu_torch.bench.batch import run_batch_benchmark
    from sage3d_tpu_torch.bench.episodes import adapt_gvln_to_episodes
    from sage3d_tpu_torch.bench.tasks import (TaskTypeManager,
                                              adapt_episode_for_task)
    from sage3d_tpu_torch.benchmarks import planner_bench
    from sage3d_tpu_torch.data import (actions, astar, images, merge, navila,
                                       scene_build, trajectory_gen,
                                       transform_2d3d)
    from sage3d_tpu_torch.data.llm import MockLLMClient
    from sage3d_tpu_torch.env.vln_env import GaussianVLNEnv
    from sage3d_tpu_torch.ops import binning, composite_cuda
    from sage3d_tpu_torch.renderer.camera import (agent_camera,
                                                  stack_cameras,
                                                  unstack_cameras)
    from sage3d_tpu_torch.renderer.render import (autotune_poses,
                                                  budget_kwargs, render,
                                                  render_batch, rgb_to_uint8)
    from sage3d_tpu_torch.renderer.scene import save_ply
    from sage3d_tpu_torch.serve.policy import OraclePolicy

    dev = room.device
    kernels = (binning.emit_tile_pairs, composite_cuda.composite_fwd)
    launched = [0, 0]

    def counted(fn):
        for k in kernels:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = [k.launches for k in kernels]
        launched[0] += n[0]
        launched[1] += n[1]
        return out, n

    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_data_")
    tmp = Path(tmpdir.name)

    # 10a. the planner ----------------------------------------------------------
    k5 = {"launches": 0, "max_abs_err": 0.0}
    for size, n_pairs, n_astar in PLANNER_GRIDS:
        astar.relax_tiles.launches = 0
        res = planner_bench.run(size, n_pairs, device=dev, n_astar=n_astar)
        k5["launches"] += astar.relax_tiles.launches
        print(f"10a planner_bench {size}x{size} {card}: {json.dumps(res)}",
              flush=True)
        check(res["reachability_agree"] == n_astar
              and res["reach_astar"] == res["reach_wavefront"],
              f"10a {size}x{size}: reachability equals host A*'s and path "
              "lengths agree within max(2, 2%) on every pair")
        g = planner_bench.make_grid(size)
        pairs = planner_bench.sample_free(g, n_pairs)
        src, dst = pairs[:BATCH_PLAN, 0], pairs[:BATCH_PLAN, 1]
        d_card, n_card = astar.wavefront_distances(g == 0, src, device=dev,
                                                   return_relaxations=True)
        d_cpu, n_cpu = astar.wavefront_distances(g == 0, src, device="cpu",
                                                 return_relaxations=True)
        same = torch.equal(d_card.cpu(), d_cpu) and n_card == n_cpu
        check(same, f"10a {size}x{size}: the card's distance fields are "
              "bitwise the CPU's (16 sources), relaxation counts equal")
        # K5 against its plain twin on the card: the whole loop, and one
        # launch from the first field
        free_t = torch.as_tensor(g == 0, device=dev)
        src_t = torch.as_tensor(src, device=dev).long()
        d_plain, n_plain = astar._relax_until_converged(
            free_t, src_t, astar.relax_tiles_plain)
        same = torch.equal(d_card, d_plain) and n_card == n_plain
        first = torch.full_like(d_card, astar.INF)
        first[torch.arange(BATCH_PLAN, device=dev), src_t[:, 0],
              src_t[:, 1]] = 0.0
        outs = [torch.empty_like(first), torch.empty_like(first)]
        flags = torch.zeros((2,), dtype=torch.int32, device=dev)
        astar.relax_tiles(first, outs[0], free_t, None, flags[0])
        astar.relax_tiles_plain(first, outs[1], free_t, None, flags[1])
        torch.cuda.synchronize()
        err = float((outs[0] - outs[1]).abs().max())
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        print(f"10a K5 {size}x{size} vs its plain twin on the card: fields "
              f"bitwise {same}, relaxations {n_card} and {n_plain}; one "
              f"launch max |diff| {err:.3e}, flags {flags.tolist()}",
              flush=True)
        check(same and err == 0.0 and flags.tolist() == [1, 1],
              f"10a {size}x{size}: K5's fields and flags bitwise its plain "
              "twin's on the card, relaxation counts equal")
        if size == PLANNER_GRIDS[0][0]:
            # one launch at the planner's batch, for the kernels line
            def k5_run():
                astar.relax_tiles(first, outs[0], free_t, None, flags[0])

            k5["ms"] = cuda_ms(k5_run, reps=20, warmup=3)
            k5["back_to_back_ms"], k5["host_ms"] = back_to_back_ms(k5_run)
            k5["plain_ms"] = cuda_ms(lambda: astar.relax_tiles_plain(
                first, outs[1], free_t, None, flags[1]), reps=5, warmup=1)
            cells = BATCH_PLAN * size * size
            t_b = (2 * cells * 4 + size * size) / HBM_BYTES_PER_S
            t_o = astar.CHECK_EVERY * cells * K5_OPS_PER_CELL \
                / FP32_NONFMA_OPS_PER_S
            k5["bound_ms"] = max(t_b, t_o) * 1e3
            k5["bound_by"] = "bytes" if t_b >= t_o else "operations"
            print(f"K5 one launch, {BATCH_PLAN} sources at {size}x{size} "
                  f"{card}: {k5['ms']:.4f} ms (events around one call), "
                  f"{k5['back_to_back_ms']:.4f} ms back to back, host "
                  f"{k5['host_ms']:.4f} ms; plain twin {k5['plain_ms']:.3f} "
                  f"ms; bound {k5['bound_ms']:.4f} ms ({k5['bound_by']}: "
                  f"bytes {t_b * 1e3:.4f} ms, operations {t_o * 1e3:.4f} ms "
                  f"at the non-FMA rate)", flush=True)
        del d_card, d_cpu, d_plain, first, outs

        def one_batch():
            return astar.plan_many(g == 0, src, dst, device=dev)

        one_batch()
        t0 = time.perf_counter()
        (_, k5_n), syncs = counting_syncs(
            lambda: launches_of([astar.relax_tiles], one_batch))
        batch_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        one_batch()
        batch_ms = min(batch_ms, (time.perf_counter() - t0) * 1e3)
        busy, n_ops, top = device_busy(one_batch, reps=1)
        cells = BATCH_PLAN * size * size
        launch_bytes = 2 * cells * 4 + size * size
        bound = n_card // astar.CHECK_EVERY * max(
            launch_bytes / HBM_BYTES_PER_S, astar.CHECK_EVERY * cells
            * K5_OPS_PER_CELL / FP32_NONFMA_OPS_PER_S) * 1e3
        print(f"10a one batch of {BATCH_PLAN} at {size}x{size} {card}: "
              f"{batch_ms:.3f} ms (host clock, the fields' copy included), "
              f"{n_card} relaxations, K5 launches {k5_n[0]} "
              f"({n_card // astar.CHECK_EVERY} that relax), {n_ops:.0f} "
              f"kernels and copies, {syncs} host syncs; device busy "
              f"{busy:.3f} ms, idle share {1.0 - busy / batch_ms:.3f}; bound "
              f"of the relaxations {bound:.4f} ms (per launch the larger of "
              f"{launch_bytes / 1e6:.2f} MB read and written at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s and "
              f"{K5_OPS_PER_CELL} operations a cell and relaxation at "
              f"{FP32_NONFMA_OPS_PER_S / 1e12:.1f} T/s)", flush=True)
        check(k5_n[0] <= n_card // astar.CHECK_EVERY + astar.CHAIN - 1,
              f"10a {size}x{size}: at most one K5 launch per "
              f"{astar.CHECK_EVERY} relaxations, plus the chain's "
              f"{astar.CHAIN - 1} after convergence")
        for kname, kms, kn in top[:3]:
            print(f"  top kernel planner {size}: {kms:.3f} ms, {kn:g} "
                  f"launches a batch: {kname}", flush=True)

    # 10b. trajectory generation ------------------------------------------------
    sem_data = data_semantic_map(room)
    maps = tmp / "maps"
    maps.mkdir()
    (maps / "2D_Semantic_Map_room1m_Complete.json").write_text(
        json.dumps(sem_data))
    grid, scale, min_x, min_y = trajectory_gen.build_2d_map(
        json.loads(json.dumps(sem_data)))
    index = trajectory_gen.item_index(sem_data)
    items = [r["item_id"] for r in sem_data[1:]]
    allowed = trajectory_gen.filter_pairs(
        [(a, b) for a in items for b in items if a != b], index)
    min_trajs = min(trajectory_gen.MIN_TRAJS_PER_SCENE, len(allowed))
    planned = []
    plan_many = trajectory_gen.plan_many

    def timed_plan_many(*a, **k):
        t = time.perf_counter()
        out = plan_many(*a, **k)
        planned.append((len(a[1]), time.perf_counter() - t))
        return out

    trajectory_gen.plan_many = timed_plan_many
    t0 = time.perf_counter()
    try:
        summary = trajectory_gen.process_scene(
            "room1m", json.loads(json.dumps(sem_data)), tmp / "traj",
            client=MockLLMClient(), min_trajs=min_trajs, seed=0,
            visualize=False, device=dev)
    finally:
        trajectory_gen.plan_many = plan_many
    gen_s = time.perf_counter() - t0
    plan_s = sum(t for _, t in planned)
    n_traj = summary["trajectories"]
    off_grid = 0
    n_points = 0
    parts = sorted((tmp / "traj" / "room1m").glob("trajectories_*_part*.json"))
    for part in parts:
        for sample in json.loads(part.read_text())["scenes"][0]["samples"]:
            for pt in sample["points"]:
                x = int(round((pt["position"][0] - min_x) / scale - 0.5))
                y = int(round((pt["position"][1] - min_y) / scale - 0.5))
                off_grid += int(grid[y, x] != 0)
                n_points += 1
    print(f"10b process_scene on the 1M room's map ({grid.shape[0]}x"
          f"{grid.shape[1]} grid, {len(items)} objects, {len(allowed)} pairs "
          f"the map allows, min_trajs {min_trajs}) {card}: {json.dumps(summary)}"
          f" in {gen_s:.3f} s, {n_traj / gen_s:.2f} trajectories/s; the "
          f"wavefront planner {plan_s:.3f} s ({plan_s / gen_s:.1%}) over "
          f"{len(planned)} call(s) of {[n for n, _ in planned]} pairs; "
          f"{n_points} points in {len(parts)} part file(s)", flush=True)
    check(len(planned) >= 1, "10b: the batched wavefront branch ran")
    check(n_traj >= 1 and n_points > 0 and off_grid == 0,
          "10b: every trajectory point lies on a free cell")

    # 10c. actions, waypoint images, NaVILA -------------------------------------
    scene_dir = tmp / "traj" / "room1m"
    check(transform_2d3d.process_scene(scene_dir, maps) == len(parts),
          "10c: every part file transformed to the world frame")
    merged = merge.merge_scene(scene_dir, prefix="gvln")
    gt_path = actions.process_trajectory_file(merged, tmp / "actions" /
                                              "room1m")
    gt = json.loads(gt_path.read_text())["trajectories"][:DATA_TRAJS]
    points = [pt for rec in gt for pt in rec["sampled_points"]]
    n_frames = len(points)
    cams = images.waypoint_cameras(points, DATA_W, DATA_H, device=dev)
    t0 = time.perf_counter()
    budgets = autotune_poses(room, cams, pair_margin=1.5)
    bk = budget_kwargs(budgets)
    print(f"10c budgets (autotune_poses over the {n_frames} waypoint cameras "
          f"of {len(gt)} trajectories, pair_margin 1.5, "
          f"{time.perf_counter() - t0:.1f} s): {json.dumps(budgets)}",
          flush=True)
    t0 = time.perf_counter()
    meta, n_i = counted(lambda: images.generate_scene_images(
        room, gt_path, tmp / "images", "room1m", batch_size=DATA_BATCH,
        max_trajectories=DATA_TRAJS, width=DATA_W, height=DATA_H, device=dev,
        **bk))
    img_s = time.perf_counter() - t0
    frames_done = sum(t["num_frames"] for t in meta["trajectories"].values())
    print(f"10c generate_scene_images, {len(meta['trajectories'])} "
          f"trajectories, {frames_done} frames at {DATA_W}x{DATA_H}, batch "
          f"{DATA_BATCH} {card}: {img_s:.3f} s, {frames_done / img_s:.2f} "
          f"frames/s, {frames_done * DATA_W * DATA_H / img_s / 1e6:.2f} "
          f"Mpix/s (host clock, JPEG encode included), launches K1 {n_i[0]} "
          f"K2 {n_i[1]} ({n_i[0] / frames_done:g} and {n_i[1] / frames_done:g}"
          f" a frame), total_overflow {meta['total_overflow']}", flush=True)
    check(frames_done == n_frames >= DATA_BATCH,
          "10c: a frame for every waypoint")
    check(meta["total_overflow"] == 0, "10c: overflow 0 on every frame")
    check(n_i == [frames_done, frames_done], "10c: K1 and K2 once a frame")

    # Where a frame's time goes: the first trajectory's batches replayed
    # with CUDA events around the render and the uint8 conversion with its
    # copy to the host; the JPEG encode on the host clock.
    split = {"render": [], "uint8 and copy": [], "jpeg": []}
    first = gt[0]["sampled_points"]
    for start in range(0, len(first), DATA_BATCH):
        chunk = first[start:start + DATA_BATCH]
        bc = images.waypoint_cameras(chunk, DATA_W, DATA_H, device=dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.no_grad():
            ev[0].record()
            out = render_batch(room, bc, backend="cuda", **bk)
            ev[1].record()
            rgb = rgb_to_uint8(out["rgb"]).cpu().numpy()
            ev[2].record()
        ev[2].synchronize()
        t = time.perf_counter()
        for frame in rgb:
            Image.fromarray(frame).save(BytesIO(), format="JPEG", quality=92)
        split["jpeg"].append((time.perf_counter() - t) * 1e3 / len(chunk))
        split["render"].append(ev[0].elapsed_time(ev[1]) / len(chunk))
        split["uint8 and copy"].append(ev[1].elapsed_time(ev[2]) / len(chunk))
    med = {k: statistics.median(v) for k, v in split.items()}
    bc = images.waypoint_cameras(first[:DATA_BATCH], DATA_W, DATA_H,
                                 device=dev)
    n_b = bc.position.shape[0]
    with torch.no_grad():
        busy, n_ops, top = device_busy(
            lambda: render_batch(room, bc, backend="cuda", **bk), reps=1)
    frame_ms = sum(med.values())
    print(f"10c a frame's split {card} (medians over the first trajectory's "
          f"batches): " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
          + f"; device busy {busy / n_b:.3f} ms a frame, idle share of the "
          f"frame's {frame_ms:.3f} ms {1.0 - busy / n_b / frame_ms:.3f}, "
          f"{n_ops / n_b:.0f} kernels and copies a frame (torch.profiler, "
          f"one unsynchronized batch of {n_b})", flush=True)
    for kname, kms, kn in top[:3]:
        print(f"  top kernel waypoint batch: {kms / n_b:.3f} ms, "
              f"{kn / n_b:g} launches a frame: {kname}", flush=True)

    # The cuda frames of one batch against the torch backend's.
    with torch.no_grad():
        cu = render_batch(room, bc, backend="cuda", **bk)
        tb = render_batch(room, bc, backend="torch", **bk)
    err = float((cu["rgb"] - tb["rgb"]).abs().max())
    print(f"10c cuda vs torch backend, {n_b} waypoint frames: rgb max |diff| "
          f"{err:.3e}, overflow {int(cu['overflow'].sum())} / "
          f"{int(tb['overflow'].sum())}", flush=True)
    check(err <= BACKEND_ATOL and int(cu["overflow"].sum()) == 0,
          f"10c: a batch of cuda waypoint frames within {BACKEND_ATOL} of "
          "the torch backend's")
    del cu, tb, out

    # K1 and K2 against their plain versions at the densest waypoint frame.
    cam_list = unstack_cameras(cams)
    with torch.no_grad():
        walked = [int(render(room, c, **bk)["grad_chunks"]) for c in cam_list]
    i_dense = int(np.argmax(walked))
    print(f"10c chunks walked per waypoint frame: median "
          f"{statistics.median(walked):.0f}, max {walked[i_dense]} "
          f"(frame {i_dense})", flush=True)
    k1_k2_against_plain(room, cam_list[i_dense], bk,
                        f"10c waypoint frame {i_dense}")

    info = navila.create_dataset([{
        "scene_id": "room1m", "actions_path": gt_path,
        "images_metadata_path": tmp / "images" / "room1m" /
        "image_metadata.json", "trajectories_path": merged}], tmp / "navila")
    print(f"10c NaVILA: {info['total_samples']} samples in "
          f"{info['num_parts']} part file(s)", flush=True)
    check(info["total_samples"] > 0, "10c: the NaVILA set has samples")

    # 10d. the multi-scene batch ------------------------------------------------
    scenes_dir, bundles, tests_dir = (tmp / "scenes", tmp / "bundles",
                                      tmp / "tests")
    for d in (scenes_dir, bundles, tests_dir):
        d.mkdir()
    named = {"room1m": room, "room200k": room_200k}
    budgets_of, t_build, episodes = {}, {}, {}
    for name, scene in named.items():
        t0 = time.perf_counter()
        save_ply(scene, scenes_dir / f"{name}.ply")
        labels = scenes_dir / f"{name}_labels.json"
        labels.write_text(json.dumps(object_labels(scene)))
        _, map_path = nav_episodes(tests_dir, scene_name=name,
                                   traj_name=f"test_{name}.json",
                                   goal_less=True)
        map_path.rename(maps / map_path.name)
        manifest = scene_build.build_scene_bundle(
            scenes_dir / f"{name}.ply", labels, maps / map_path.name, bundles,
            scene_id=name, device=dev)
        t_build[name] = time.perf_counter() - t0
        m = json.loads(manifest.read_text())
        print(f"10d bundle {name}: {m['num_gaussians']} Gaussians, "
              f"{m['num_labeled_gaussians']} labelled in "
              f"{m['num_instances']} instances, PLY + bundle "
              f"{t_build[name]:.2f} s", flush=True)
        # The probes: the room's 16, and every 0.2 m of the episodes'
        # routes (the agent walks through objects the map does not hold).
        episodes[name] = adapt_gvln_to_episodes(
            tests_dir / f"test_{name}.json", str(manifest))
        probes = probe_poses(scene) + route_poses(episodes[name])
        budgets_of[name] = autotune_poses(scene, stack_cameras([
            agent_camera(xy, yaw, width=NAV_W, height=NAV_H, device=dev)
            for xy, yaw in probes]), pair_margin=1.5)
        print(f"10d budgets {name} (autotune_poses over {len(probes)} "
              f"probes, pair_margin 1.5): {json.dumps(budgets_of[name])}",
              flush=True)
    env = GaussianVLNEnv(str(bundles / "room200k" / "manifest.json"),
                         map_json=str(maps / "2D_Semantic_Map_room200k_"
                                      "Complete.json"),
                         width=NAV_W, height=NAV_H,
                         budgets=budgets_of["room200k"], device=dev)

    def instruction_of(ep):
        task_type = TaskTypeManager.infer_task_type(ep)
        return TaskTypeManager.create_task(task_type, {}).get_instruction(
            adapt_episode_for_task(ep, task_type))

    # The oracles by (scene, instruction): the no-goal episodes of both
    # scenes get the same default instruction.
    oracles = {}
    for name in named:
        for ep in episodes[name]:
            oracles[name, instruction_of(ep)] = OraclePolicy(env, ep)
    answers = {k: 0 for k in oracles}
    marks = []      # at each hot swap: the scene, the swap's time, the clock,
                    # the env's overflow and the policy's answers so far

    def policy(images, instruction, current_yaw=0.0, depth_images=None,
               **kw_):
        key = (marks[-1][0], instruction)
        resp = oracles[key](images=images, instruction=instruction,
                            current_yaw=current_yaw,
                            depth_images=depth_images)
        answers[key] += 1
        return resp

    # The runner finds each bundle's scene.ply (matched before its
    # manifest.json, as in the JAX package) and swaps it into the env.
    load_scene = env.load_scene

    def timed_load(scene):
        t = time.perf_counter()
        load_scene(scene)
        torch.cuda.synchronize()
        marks.append((Path(str(scene)).parent.name, time.perf_counter() - t,
                      t, int(env.total_overflow), sum(answers.values())))

    env.load_scene = timed_load
    summary, n_r = counted(lambda: run_batch_benchmark(
        env, tests_dir, bundles, maps, policy, tmp / "batch_runs",
        max_steps=NAV_RUNNER_STEPS, budgets=budgets_of))
    marks.append(("end", 0.0, time.perf_counter(), int(env.total_overflow),
                  sum(answers.values())))
    print(f"10d run_batch_benchmark, hot swap room200k -> "
          + " -> ".join(m[0] for m in marks[:-1]) + f" {card}: "
          f"{json.dumps(summary['batch_summary'])}; launches K1 {n_r[0]} K2 "
          f"{n_r[1]}, env total_overflow {int(env.total_overflow)}",
          flush=True)
    for (name, load_s, t_a, ovf_a, n_a), (_, _, t_b, ovf_b, n_b) in zip(
            marks, marks[1:]):
        steps = n_b - n_a
        print(f"10d scene {name} {card}: load_scene {load_s * 1e3:.1f}"
              f" ms, {steps} env steps, {(t_b - t_a) * 1e3 / max(steps, 1):.3f}"
              f" ms an env step (host clock from the swap to the next, the "
              f"runner's file work included), overflow {ovf_b - ovf_a}",
              flush=True)
        check(ovf_b == ovf_a, f"10d: overflow 0 on {name}'s frames")
    steps_run = {}
    for name in named:
        for ep in episodes[name]:
            eid = ep["episode_id"]
            rec = tmp / "batch_runs" / name / eid / "measurements" / \
                f"{eid}.json"
            steps_run[f"{name}/{eid}"] = (
                json.loads(rec.read_text())["episode_info"]["steps_run"]
                if rec.exists() else None, answers[name, instruction_of(ep)])
    print(f"10d steps_run and policy answers per episode: "
          f"{json.dumps(steps_run)}", flush=True)
    results = summary["file_results"]
    check([r["status"] for r in results] == ["ok", "ok"]
          and summary["batch_summary"]["failed_episodes"] == 0,
          "10d: both files ran without a failure")
    check(all(s is not None and s == a for s, a in steps_run.values()),
          "10d: the policy answered on every step of every episode")
    check(all(set(r.get("metrics", {})) == MEASURES for r in results),
          "10d: all 13 measures in both scenes' results")
    n_steps = sum(s for s, _ in steps_run.values())
    check(n_r[0] == n_r[1] == n_steps, "10d: K1 and K2 once a frame")
    check([m[0] for m in marks[:-1]] == sorted(named)
          and env.render_kw == budget_kwargs(budgets_of[marks[-2][0]]),
          "10d: each file hot-swapped its scene in; the env ends with the last"
          " scene's budgets")
    tmpdir.cleanup()
    return launched, k5


def launches_of(kernels, fn):
    """``fn()`` with the counters of ``kernels`` set to 0 just before and
    read just after (host counts: no wait on the card)."""
    for k in kernels:
        k.launches = 0
    out = fn()
    return out, [k.launches for k in kernels]


def percentile(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, float), q)) if xs else float("nan")


def serving(room, cam_a, budgets, card) -> list:
    """Phase 11, serving (see the module docstring): the CNN policy on the
    card against its CPU copy, ``run_benchmark`` against the policy server,
    the micro-batching server under concurrent clients, and the compressed
    PLY path with the CLI. Returns K1's and K2's launches on its main-path
    runs, each counted from 0 just before the run and read just after."""
    import collections
    import contextlib
    import io
    import tempfile
    import threading
    from pathlib import Path

    import numpy as np
    import torch
    from sage3d_tpu_torch import cli
    from sage3d_tpu_torch.bench.episodes import adapt_gvln_to_episodes
    from sage3d_tpu_torch.bench.runner import run_benchmark
    from sage3d_tpu_torch.env.vln_env import GaussianVLNEnv
    from sage3d_tpu_torch.ops import binning, composite_cuda
    from sage3d_tpu_torch.renderer.camera import agent_camera, stack_cameras
    from sage3d_tpu_torch.renderer.render import (autotune_all,
                                                  autotune_poses,
                                                  budget_kwargs, render,
                                                  rgb_to_uint8)
    from sage3d_tpu_torch.renderer.scene import (load_ply, scene_to_numpy,
                                                 synthetic_room)
    from sage3d_tpu_torch.serve import mllm_server
    from sage3d_tpu_torch.serve import torch_policy as tp
    from sage3d_tpu_torch.serve.batch_server import from_torch_policy
    from sage3d_tpu_torch.serve.client import create_vlm_client
    from sage3d_tpu_torch.serve.policy import make_socket_policy
    from sage3d_tpu_torch.utils import plyio_native as pn
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from splat_transform_port import write_compressed_ply_splat_transform

    kernels = (binning.emit_tile_pairs, composite_cuda.composite_fwd)
    launched = [0, 0]

    def counted(fn):
        out, n = launches_of(kernels, fn)
        launched[0] += n[0]
        launched[1] += n[1]
        return out, n

    # 11a. the CNN on the card against its CPU copy --------------------------
    params = tp.init_cnn_policy(device="cpu",
                                generator=torch.Generator().manual_seed(0))
    card_params = {k: v.cuda() for k, v in params.items()}
    x = torch.rand((8, 4, 96, 128, 3),
                   generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = tp.CNNPolicy(params)(x)
        got = tp.CNNPolicy(card_params)(x.cuda()).cpu()
        b1_ms = cuda_ms(lambda: tp.cnn_policy_apply(card_params, x[0].cuda()),
                        reps=20, warmup=3)
        xb = x.cuda()
        b8_ms = cuda_ms(lambda: tp.CNNPolicy(card_params)(xb), reps=20,
                        warmup=3)
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * TF32_REL * scale
    same = bool(torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear]))
    print(f"11a CNN 96x128, 4 frames, channels (16, 32, 64), hidden 128 "
          f"{card}: card vs CPU max |diff| / max |logit| {rel:.3e} over 8 "
          f"frame stacks (cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}),"
          f" argmax equal on {int(clear.sum())} of 8 with a clear top two; "
          f"{b1_ms:.3f} ms a request (B=1), {b8_ms:.3f} ms a batch of 8 "
          f"(CUDA events)", flush=True)
    check(rel <= TF32_REL and same,
          f"11a: the card's logits within {TF32_REL} of max |logit| of the "
          "CPU's, the same action where the top two are clear")

    # 11b. run_benchmark against the policy server -------------------------------
    # Phase 9's budgets cover its probe poses and the oracle's routes; a
    # policy that turns in place at a start sees every yaw there. Where
    # those views overflow phase 9's budgets, the phase takes budgets over
    # both sets of views.
    dev = room.device
    start_views = [(xy_, float(yaw_)) for xy_ in NAV_STARTS for yaw_ in
                   np.linspace(-np.pi, np.pi, 12, endpoint=False)]
    with torch.no_grad():
        ovf9 = [int(render(room, agent_camera(xy_, yaw_, width=NAV_W,
                                              height=NAV_H, device=dev),
                           **budget_kwargs(budgets))["overflow"])
                for xy_, yaw_ in start_views]
    if sum(ovf9):
        budgets = autotune_poses(room, stack_cameras([
            agent_camera(xy_, yaw_, width=NAV_W, height=NAV_H, device=dev)
            for xy_, yaw_ in probe_poses(room) + start_views]),
            pair_margin=1.5)
    print(f"11b phase 9's budgets at the 4 starts x 12 yaws: overflow "
          f"{sum(ovf9)} (max {max(ovf9)} a view); budgets used "
          f"{json.dumps(budgets)}", flush=True)
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")
    tmp = Path(tmpdir.name)
    traj, map_path = nav_episodes(tmp)
    episodes = adapt_gvln_to_episodes(traj, "room1m.ply")
    env = GaussianVLNEnv(room, map_json=str(map_path), width=NAV_W,
                         height=NAV_H, budgets=budgets)
    server = tp.make_torch_policy_server(port=0, params=params,
                                         device="cuda").start()
    # per request: JPEG decoding of its frames, prep_frames, and the device
    # call (the adapter's call less prep_frames; it ends in the argmax read)
    spans = {"decode": [], "prep": [], "call": []}
    pending = {"decode": 0.0, "prep": 0.0}
    orig_decode = mllm_server.decode_image_b64
    orig_prep, orig_generate = server.adapter._prep, \
        server.adapter.generate_response

    def decode(data):
        t = time.perf_counter()
        img = orig_decode(data)
        pending["decode"] += time.perf_counter() - t
        return img

    def prep(images):
        t = time.perf_counter()
        out = orig_prep(images)
        pending["prep"] = time.perf_counter() - t
        return out

    def generate(images, instruction):
        t = time.perf_counter()
        out = orig_generate(images, instruction)
        spans["call"].append(time.perf_counter() - t - pending["prep"])
        spans["decode"].append(pending["decode"])
        spans["prep"].append(pending["prep"])
        pending["decode"] = 0.0
        return out

    mllm_server.decode_image_b64 = decode
    server.adapter._prep, server.adapter.generate_response = prep, generate
    sock = make_socket_policy(host="127.0.0.1", port=server.port)
    answers = collections.Counter()

    def policy(**kw_):
        resp = sock(**kw_)
        answers[resp.get("raw_response")] += 1
        return resp

    out_dir = tmp / "runs"
    try:
        t0 = time.perf_counter()
        (summary, n_r), syncs = counting_syncs(lambda: counted(
            lambda: run_benchmark(env, episodes, policy,
                                  output_dir=str(out_dir),
                                  max_steps=SERVE_STEPS)))
        wall = time.perf_counter() - t0
    finally:
        mllm_server.decode_image_b64 = orig_decode
        server.stop()
    steps = {}
    for ep in episodes:
        eid = ep["episode_id"]
        path = out_dir / ep["scene_name"] / eid / "measurements" / f"{eid}.json"
        steps[eid] = (json.loads(path.read_text())["episode_info"]["steps_run"]
                      if path.exists() else None)
    n_steps = sum(s for s in steps.values() if s)
    n_answers = sum(answers.values())
    per_req = [a + b + c for a, b, c in zip(spans["decode"], spans["prep"],
                                            spans["call"])]
    host_part = [a + b for a, b in zip(spans["decode"], spans["prep"])]
    print(f"11b run_benchmark, the CNN served on the card, {len(episodes)} "
          f"episodes at {NAV_W}x{NAV_H} on the 1M room (max_steps "
          f"{SERVE_STEPS}) {card}: {json.dumps(summary)}", flush=True)
    print(f"11b steps_run per episode {json.dumps(steps)}, answers "
          f"{dict(answers)}, server requests {server.stats['requests']}, "
          f"launches K1 {n_r[0]} K2 {n_r[1]}, env total_overflow "
          f"{int(env.total_overflow)}", flush=True)
    if n_steps:
        print(f"11b per env step {card}: {wall * 1e3 / n_steps:.3f} ms wall "
              f"(runner, render, JPEG, socket and policy), "
              f"{syncs / n_steps:.2f} host syncs a step (runner and server "
              f"threads); per policy request: p50 {percentile(per_req, 50) * 1e3:.3f}"
              f" ms, p99 {percentile(per_req, 99) * 1e3:.3f} ms, of which "
              f"decode + prep_frames p50 "
              f"{percentile(host_part, 50) * 1e3:.3f} ms, p99 "
              f"{percentile(host_part, 99) * 1e3:.3f} ms (decode p50 "
              f"{percentile(spans['decode'], 50) * 1e3:.3f} ms) and the "
              f"device call p50 {percentile(spans['call'], 50) * 1e3:.3f} ms,"
              f" p99 {percentile(spans['call'], 99) * 1e3:.3f} ms (host "
              f"clock), {n_steps} steps", flush=True)
    check(summary["num_failures"] == 0 and summary["num_episodes"] == 4,
          "11b: the runner ran the 4 episodes without a failure")
    check(n_steps > 0 and n_answers == n_steps
          and server.stats["requests"] == n_steps
          and set(answers) <= set(tp.ACTIONS),
          "11b: the policy server answered every runner step with an action")
    check(int(env.total_overflow) == 0, "11b: the env's frames overflow 0")
    check(n_r[0] == n_r[1] == n_steps, "11b: K1 and K2 once a frame")

    # 11c. the micro-batching server under concurrent clients ---------------------
    with torch.no_grad():
        frames = [rgb_to_uint8(render(room, agent_camera(
            xy_, yaw_, width=NAV_W, height=NAV_H, device=room.device),
            **budget_kwargs(budgets))["rgb"]).cpu().numpy()
            for xy_, yaw_ in probe_poses(room)[:SERVE_CLIENTS]]

    def drive(port):
        lat, got_ = [], []

        def client(i):
            c = create_vlm_client(input_type="rgb", output_type="text",
                                  protocol="socket", host="127.0.0.1",
                                  port=port)
            for r in range(SERVE_REQUESTS):
                t = time.perf_counter()
                resp = c.query([frames[(i + r) % len(frames)]], "go",
                               current_yaw=0.0)
                lat.append(time.perf_counter() - t)
                got_.append(resp.get("raw_response"))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        return time.perf_counter() - t, lat, got_

    n_req = SERVE_CLIENTS * SERVE_REQUESTS
    with tp.make_torch_policy_server(port=0, params=params,
                                     device="cuda") as single:
        wall_1, lat_1, got_1 = drive(single.port)
    with from_torch_policy(params=params, max_batch=8, device="cuda",
                           port=0) as batched:
        wall_b, lat_b, got_b = drive(batched.port)
    stats = dict(batched.stats)
    for name, wall_, lat, got_ in (("unbatched", wall_1, lat_1, got_1),
                                   ("batched", wall_b, lat_b, got_b)):
        print(f"11c {name} server, {SERVE_CLIENTS} clients x "
              f"{SERVE_REQUESTS} requests of one {NAV_W}x{NAV_H} JPEG "
              f"(8-frame client history) {card}: {len(got_) / wall_:.2f} "
              f"requests/s, latency p50 {percentile(lat, 50) * 1e3:.3f} ms, "
              f"p99 {percentile(lat, 99) * 1e3:.3f} ms (host clock), "
              f"answers {dict(collections.Counter(got_))}", flush=True)
    print(f"11c batch server stats: {json.dumps(stats)}", flush=True)
    check(len(got_b) == n_req and set(got_b) <= set(tp.ACTIONS)
          and len(got_1) == n_req and set(got_1) <= set(tp.ACTIONS),
          "11c: every answer of both servers is a valid action")
    check(stats["requests"] == n_req and stats["batches"] < n_req
          and stats["max_batch_seen"] >= 2,
          "11c: fewer batches than requests, max_batch_seen >= 2")

    # 11d. the compressed PLY path and the CLI ---------------------------------
    arr = scene_to_numpy(room)
    ply = tmp / "room1m_compressed.ply"
    t0 = time.perf_counter()
    write_compressed_ply_splat_transform(ply, arr["means"], arr["log_scales"],
                                         arr["quats"], arr["opacity_logits"],
                                         arr["sh"])
    write_s = time.perf_counter() - t0
    check(pn.native_available(), "11d: the native decoder builds and is in "
          "use")
    print(f"11d native decoder built with {' '.join(pn.native_flags() or ())}"
          f" into {pn.BUILD_DIR}", flush=True)
    t0 = time.perf_counter()
    nat = pn.read_compressed_ply(ply, use_native=True)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = pn.read_compressed_ply(ply, use_native=False)
    py_s = time.perf_counter() - t0
    dec_err = max(float(np.abs(nat[k] - py[k]).max()) for k in py)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene_c = load_ply(ply, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n = scene_c.num_gaussians
    print(f"11d compressed PLY of the 1M room {card}: "
          f"{ply.stat().st_size / 2**20:.1f} MiB written in {write_s:.2f} s "
          f"(tests/splat_transform_port.py); decode native {nat_s * 1e3:.1f} "
          f"ms, Python {py_s * 1e3:.1f} ms, max |native - Python| "
          f"{dec_err:.3e}; load_ply(device='cuda') {load_s * 1e3:.1f} ms, "
          f"{n / load_s / 1e6:.2f} M Gaussians/s", flush=True)
    check(dec_err <= 1e-5, "11d: the native decoder equals the Python one "
          "(atol 1e-5, the JAX test's)")
    b_c = autotune_all(scene_c, cam_a, pair_margin=1.05)
    with torch.no_grad():
        out, n_c = counted(lambda: render(scene_c, cam_a, backend="cuda",
                                          **budget_kwargs(b_c)))
        orig = render(room, cam_a, backend="cuda",
                      **budget_kwargs(autotune_all(room, cam_a,
                                                   pair_margin=1.05)))
    diff = float((out["rgb"] - orig["rgb"]).abs().mean())
    print(f"11d frame a of the loaded scene: overflow {int(out['overflow'])}, "
          f"launches K1 {n_c[0]} K2 {n_c[1]}, mean |rgb - the uncompressed "
          f"room's| {diff:.4e}", flush=True)
    check(n == room.num_gaussians and int(out["overflow"]) == 0
          and n_c == [1, 1] and bool(torch.isfinite(out["rgb"]).all()),
          "11d: load_ply loads the compressed room; frame a renders with "
          "overflow 0")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["validate-ply", str(ply)])
    report = json.loads(buf.getvalue())
    print(f"11d cli validate-ply: rc {rc}, failed "
          f"{[c['check'] for c in report['checks'] if not c['ok']]}",
          flush=True)
    check(rc == 0, "11d: cli validate-ply exits 0 on the file")

    # run-benchmark through the CLI on a compressed 20k room: with render's
    # default budgets (the JAX CLI's env), then with --budgets from
    # autotune_poses over the starts' views and the probe poses
    small = tmp / "room20k_compressed.ply"
    arr = scene_to_numpy(synthetic_room(20_000, seed=7, device="cpu"))
    write_compressed_ply_splat_transform(small, arr["means"],
                                         arr["log_scales"], arr["quats"],
                                         arr["opacity_logits"], arr["sh"])
    room_s = load_ply(small, device="cuda")
    b_s = autotune_poses(room_s, stack_cameras([
        agent_camera(xy_, yaw_, width=640, height=480, device=dev)
        for xy_, yaw_ in probe_poses(room_s) + start_views]),
        pair_margin=1.5)
    (tmp / "budgets.json").write_text(json.dumps(b_s))
    del room_s
    for label, extra in (("render's defaults", []),
                         ("--budgets", ["--budgets",
                                        str(tmp / "budgets.json")])):
        buf = io.StringIO()
        with tp.make_torch_policy_server(port=0, params=params,
                                         device="cuda") as srv:
            with contextlib.redirect_stdout(buf):
                rc, n_cli = counted(lambda: cli.main([
                    "run-benchmark", "--scene", str(small), "--map",
                    str(map_path), "--test-json", str(traj), "--output-dir",
                    str(tmp / f"cli{len(extra)}"), "--port", str(srv.port),
                    "--max-episodes", "1", "--max-steps", "20"] + extra))
        ovf = [int(line.split()[-1]) for line in buf.getvalue().splitlines()
               if line.startswith("[INFO] total_overflow")]
        print(f"11d cli run-benchmark on the compressed 20k room at 640x480, "
              f"{label}: rc {rc}, total_overflow {ovf}, server requests "
              f"{srv.stats['requests']}, launches K1 {n_cli[0]} K2 "
              f"{n_cli[1]}", flush=True)
        check(rc == 0 and len(ovf) == 1 and srv.stats["requests"] > 0,
              f"11d: cli run-benchmark ({label}) exits 0 against the torch "
              "policy server and prints total_overflow")
    print(f"11d --budgets: {json.dumps(b_s)}", flush=True)
    check(ovf == [0], "11d: with --budgets the CLI's frames overflow 0")
    tmpdir.cleanup()
    return launched


def adc_training(target, card) -> dict:
    """Phase 12, ADC training (see the module docstring):
    ``fit_scene_adaptive(backend="cuda")`` with each train step and each
    ``densify_prune`` round observed through the trainer module's names.
    Returns K1-K4's launches over its steps, each step counted from 0 just
    before it and read just after."""
    import numpy as np
    import torch
    from sage3d_tpu_torch.ops import binning, composite_cuda, segreduce
    from sage3d_tpu_torch.parallel import trainer as tr
    from sage3d_tpu_torch.parallel.densify import DensifyState
    from sage3d_tpu_torch.renderer.camera import make_camera, stack_cameras
    from sage3d_tpu_torch.renderer.render import (autotune_poses,
                                                  budget_kwargs, render)
    from sage3d_tpu_torch.renderer.scene import importance_subset

    dev = target.device
    names = ("emit", "composite_fwd", "composite_bwd", "segreduce")
    kernels = (binning.emit_tile_pairs, composite_cuda.composite_fwd,
               composite_cuda.composite_bwd, segreduce.segment_reduce_sorted)
    cams_l = []
    for i in range(ADC_VIEWS):
        ang = 2 * np.pi * i / ADC_VIEWS + np.pi / 4
        cams_l.append(make_camera(
            [3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.4],
            [-np.cos(ang), -np.sin(ang), -0.1], width=ADC_W, height=ADC_H,
            device=dev))
    cams = stack_cameras(cams_l)
    budgets = autotune_poses(target, cams, pair_margin=1.5)
    bk = budget_kwargs(budgets)
    print(f"12 budgets (autotune_poses, {ADC_VIEWS} orbit views, pair_margin "
          f"1.5): {json.dumps(budgets)}", flush=True)
    with torch.no_grad():
        outs = [render(target, c, backend="cuda", **bk) for c in cams_l]
    targets = torch.stack([o["rgb"] for o in outs])
    check(all(int(o["overflow"]) == 0 for o in outs),
          "12: the targets render with overflow 0")
    start = importance_subset(target, ADC_START)

    def overflow_of(params_or_scene) -> list:
        scene = params_or_scene
        with torch.no_grad():
            return [int(render(scene, c, backend="cuda", **bk)["overflow"])
                    for c in cams_l]

    pc_only = {"pair_capacity": bk["pair_capacity"],
               "tile_capacity": bk["tile_capacity"]}
    with torch.no_grad():
        default_tiers = [int(render(tr.with_capacity(start, ADC_N), c,
                                    backend="cuda", **pc_only)["overflow"])
                         for c in cams_l]
    ovf_start = overflow_of(tr.with_capacity(start, ADC_N))
    print(f"12 start: importance_subset({ADC_N}, {ADC_START}) at capacity "
          f"{ADC_N}: overflow per view {ovf_start} with the budgets, "
          f"{default_tiers} with only pair_capacity and tile_capacity "
          f"(render's default emission tiers)", flush=True)

    steps, rounds, resets = [], [], []
    real_make, real_dp, real_zero = (tr.make_train_step, tr.densify_prune,
                                     tr.zero_opacity_moments)

    def make_train_step(*a, **k):
        step_fn, opt = real_make(*a, **k)
        real_adc = step_fn.adc

        def adc(state, cam_batch, tgt):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out, n = launches_of(kernels, lambda: real_adc(state, cam_batch,
                                                           tgt))
            ev[1].record()
            steps.append({"launches": n, "events": ev, "loss": out[1],
                          "opt": out[0].opt_state, "params": out[0].params})
            return out

        step_fn.adc = adc
        return step_fn, opt

    def densify_prune(params, dstate, gen, cfg, opt_state=None,
                      semantic_ids=None):
        cpu_params = {k: v.detach().cpu().clone() for k, v in params.items()}
        cpu_state = DensifyState(dstate.grad_accum.cpu(), dstate.n_steps)
        cpu_gen = torch.Generator()
        cpu_gen.set_state(gen.get_state())
        avg = dstate.grad_accum / max(dstate.n_steps, 1)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out, n = launches_of(kernels, lambda: real_dp(
            params, dstate, gen, cfg, opt_state=opt_state,
            semantic_ids=semantic_ids))
        ev[1].record()
        ev[1].synchronize()
        cpu = real_dp(cpu_params, cpu_state, cpu_gen, cfg,
                      semantic_ids=semantic_ids.cpu())
        info = {k: int(v) for k, v in out[4].items()}
        same_info = info == {k: int(v) for k, v in cpu[4].items()}
        bitwise = all(torch.equal(out[0][k].detach().cpu(), cpu[0][k])
                      for k in ("quats", "opacity_logits", "sh")) \
            and torch.equal(out[3].cpu(), cpu[3])

        def ulps(k):
            a = out[0][k].detach().cpu().contiguous().view(torch.int32)
            b = cpu[0][k].contiguous().view(torch.int32)
            return int((a.long() - b.long()).abs().max())

        u_ls = ulps("log_scales")
        mu_card = out[0]["means"].detach().cpu()
        mu_diff = int((mu_card != cpu[0]["means"]).any(-1).sum())
        mu_abs = float((mu_card - cpu[0]["means"]).abs().max())
        scene = tr.with_params(tr.with_capacity(start, ADC_N),
                               {k: v.detach() for k, v in params.items()})
        rounds.append({"info": info, "ms": ev[0].elapsed_time(ev[1]),
                       "launches": n, "same_info": same_info,
                       "bitwise": bitwise, "ulp_log_scales": u_ls,
                       "means_max_abs_diff": mu_abs,
                       "means_rows_differ": mu_diff,
                       "overflow": overflow_of(scene),
                       "avg_grad_q": [float(q) for q in torch.quantile(
                           avg[avg > 0][:1 << 20].float(),
                           torch.tensor([0.1, 0.5, 0.9], device=dev))]
                       if bool((avg > 0).any()) else []})
        return out

    def zero_opacity_moments(opt_state):
        out = real_zero(opt_state)
        op = [g["params"][0] for g in opt_state.param_groups
              if g.get("name") == "opacity_logits"][0]
        others = [g["params"][0] for g in opt_state.param_groups
                  if g.get("name") != "opacity_logits"]
        resets.append({
            "step": len(steps),
            "opacity_zero": all(float(v.abs().max()) == 0.0
                                for k, v in opt_state.state[op].items()
                                if k != "step"),
            "others_kept": all(float(opt_state.state[p]["exp_avg_sq"].abs()
                                     .max()) > 0 for p in others)})
        return out

    cfg = tr.TrainerConfig(steps=ADC_STEPS, log_every=ADC_EVERY,
                           backend="cuda", group_lrs=True,
                           pair_capacity=budgets["pair_capacity"],
                           tile_capacity=budgets["tile_capacity"],
                           budgets=budgets)
    adaptive = tr.AdaptiveConfig(densify_every=ADC_EVERY,
                                 opacity_reset_every=ADC_RESET,
                                 grad_threshold=ADC_GRAD)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr.make_train_step, tr.densify_prune, tr.zero_opacity_moments = \
        make_train_step, densify_prune, zero_opacity_moments
    t0 = time.perf_counter()
    try:
        fitted, history = tr.fit_scene_adaptive(
            start, cams, targets, cfg, adaptive, capacity=ADC_N, seed=0,
            verbose=False)
        torch.cuda.synchronize()
    finally:
        tr.make_train_step, tr.densify_prune, tr.zero_opacity_moments = \
            real_make, real_dp, real_zero
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held

    losses = [float(s["loss"]) for s in steps]
    step_ms = [s["events"][0].elapsed_time(s["events"][1]) for s in steps]
    every = all(all(x > 0 for x in s["launches"]) for s in steps)
    per_step = [s["launches"] for s in steps]
    total = [sum(c[i] for c in per_step) for i in range(4)]
    opt0 = steps[0]["opt"]
    same_adam = all(s["opt"] is opt0 for s in steps) and all(
        g["params"][0] is steps[-1]["params"][g["name"]]
        for g in opt0.param_groups)
    adam_steps = int(opt0.state[steps[-1]["params"]["means"]]["step"])
    ovf_end = overflow_of(fitted)
    # the loss between control events: densify rounds after steps
    # ADC_EVERY, 2 * ADC_EVERY, ... and the opacity reset after ADC_RESET
    cuts = sorted({0, len(losses)} | {e for e in range(
        ADC_EVERY, len(losses), ADC_EVERY)} | {ADC_RESET})
    segments = [(a, b - 1, losses[a], losses[b - 1])
                for a, b in zip(cuts, cuts[1:])]
    med = statistics.median(step_ms[3:])
    mpix = ADC_VIEWS * ADC_W * ADC_H / (med * 1e3)
    for r in rounds:
        print(f"12 densify_prune round {card}: {json.dumps(r)}", flush=True)
    print(f"12 losses {[f'{v:.5e}' for v in losses]}", flush=True)
    print(f"12 fit_scene_adaptive, {ADC_STEPS} steps of {ADC_VIEWS} views at "
          f"{ADC_W}x{ADC_H}, capacity {ADC_N}, start {ADC_START} {card}: "
          f"{wall:.2f} s wall; step {med:.3f} ms median of steps 4-"
          f"{len(step_ms)} (CUDA events), {mpix:.2f} Mpix/s; launches a step "
          f"{dict(zip(names, per_step[0]))} (first) "
          f"{dict(zip(names, per_step[-1]))} (last); densify_prune "
          f"{[round(r['ms'], 3) for r in rounds]} ms a round, launches "
          f"{[r['launches'] for r in rounds]}; resets {resets}; Adam steps "
          f"{adam_steps}; overflow start {ovf_start}, end {ovf_end}; peak "
          f"device memory {peak / 2**30:.2f} GiB above what was held; "
          f"history {json.dumps(history)}", flush=True)
    print(f"12 loss between control events (first step, last step, loss, "
          f"loss): {segments}", flush=True)
    check(every and len(steps) == ADC_STEPS,
          "12: every ADC step launched K1-K4")
    check(all(np.isfinite(losses)) and all(b < a for _, _, a, b in segments),
          "12: the loss stays finite and falls between control events")
    alive = [r["info"]["n_alive"] for r in rounds]
    check(len(rounds) == ADC_STEPS // ADC_EVERY
          and all(b > a for a, b in zip([ADC_START] + alive, alive)),
          f"12: n_alive grows across the rounds ({alive})")
    check(sum(ovf_start) == 0 and sum(ovf_end) == 0
          and all(sum(r["overflow"]) == 0 for r in rounds),
          "12: renders of the start, after each round and of the end "
          "overflow 0")
    check(same_adam and adam_steps == ADC_STEPS and len(resets) == 1
          and resets[0]["opacity_zero"] and resets[0]["others_kept"],
          "12: one Adam steps throughout; its opacity moments are zero right "
          "after the reset, the others kept")
    check(all(r["same_info"] and r["bitwise"] and r["ulp_log_scales"] <= 1
              and r["means_max_abs_diff"] <= SPLIT_MEAN_TOL
              and r["means_rows_differ"] <= r["info"]["n_split"]
              for r in rounds),
          "12: densify_prune on the card equals it on a CPU copy (counters, "
          "ids, quats, opacities, SH bitwise; log_scales within 1 ulp; only "
          f"split offspring's means differ, within {SPLIT_MEAN_TOL})")

    # the device's busy time and idle share of a step, on the fitted scene
    step_fn, opt = real_make(fitted, cams_l[0], mesh=cfg.mesh_shape,
                             optimizer=cfg.make_opt(), backend="cuda",
                             **cfg.render_kw())
    state = tr.init_train_state(fitted, opt)
    busy, n_ops, top = device_busy(lambda: step_fn.adc(state, cams, targets),
                                   reps=5)
    prof_ms = cuda_ms(lambda: step_fn.adc(state, cams, targets), reps=5,
                      warmup=1)
    print(f"12 a step on the fitted scene {card}: {prof_ms:.3f} ms (CUDA "
          f"events, median of 5), device busy {busy:.3f} ms, idle share "
          f"{1 - busy / prof_ms:.3f}, {n_ops:.0f} kernels and copies a step; "
          f"top {json.dumps(top)}", flush=True)
    return dict(zip(names, total))


# --- phase 13: the sharded path -----------------------------------------------
# The workers run on the ranks of a mesh (spawn_mesh starts them, one process
# each, and passes the mesh as the keyword ``mesh``); they return rank 0's
# view.

def _rank_stats(mesh, values) -> list:
    """``values`` (ints) of every rank, rank-major, gathered."""
    import torch
    from sage3d_tpu_torch.parallel.mesh import all_gather
    t = torch.tensor([list(values)], dtype=torch.int64, device=mesh.device)
    return all_gather(t, mesh, None, tag="report").tolist()


def _events_ms(fn) -> float:
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def band_worker(budgets, mesh=None) -> dict:
    """13a on one rank: frame a through ``render_tile_sharded`` (counters of
    K1 and K2 from 0 around the first frame), this band's k_end through the
    same projection, binning and K2, then frames timed without and with the
    collectives' times."""
    import torch
    from sage3d_tpu_torch.ops import binning, composite_cuda as cc
    from sage3d_tpu_torch.ops.projection import project_gaussians
    from sage3d_tpu_torch.parallel.mesh import all_gather
    from sage3d_tpu_torch.parallel.sharded_render import (band_height,
                                                          render_tile_sharded)
    from sage3d_tpu_torch.renderer.render import budget_kwargs, render
    room, cam = frame_a(mesh.device)
    bk = budget_kwargs(budgets)
    kernels = (binning.emit_tile_pairs, cc.composite_fwd)

    def frame():
        with torch.no_grad():
            return render_tile_sharded(room, cam, mesh, backend="cuda", **bk)

    torch.cuda.synchronize()
    for fn in kernels:
        fn.launches = 0
    out = frame()
    torch.cuda.synchronize()
    launches = [fn.launches for fn in kernels]
    band_h = band_height(cam.height, mesh.shape["tile"])
    y0 = mesh.axis_index("tile") * band_h
    with torch.no_grad():
        band_cam = cam._replace(cy=cam.cy - y0, height=band_h)
        proj = project_gaussians(room, band_cam,
                                 clamp_dims=(cam.width, cam.height))
        bins = binning.bin_gaussians(proj, cam.width, band_h, **{
            k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
        pg, start, count, _ = cc.trim_to_capacity(bins, bk["pair_capacity"])
        _, kend = cc.composite_fwd(
            cc.attribute_table(proj, room.semantic_ids), pg, start,
            torch.clamp(count, max=bk["tile_capacity"]), bins.tiles_x)
        band_overflow = int(render(room, band_cam, backend="cuda",
                                   clamp_dims=(cam.width, cam.height),
                                   **bk)["overflow"])
    kends = all_gather(kend.to(torch.int32), mesh, "tile", tag="report")
    for _ in range(2):
        frame()
    frame_ms = statistics.median(_events_ms(frame)
                                 for _ in range(SHARD_FRAMES))
    mesh.counter.reset()
    mesh.counter.timed = True
    timed_ms = statistics.median(_events_ms(frame) for _ in range(3))
    mesh.counter.timed = False
    split = {tag: mesh.counter.summary(tag) for tag in ("scene", "band")}
    ranks = _rank_stats(mesh, launches + [
        band_overflow, torch.cuda.max_memory_allocated(mesh.device)])
    return {"rgb": out["rgb"], "alpha": out["alpha"],
            "semantic": out["semantic"], "overflow": int(out["overflow"]),
            "kend": kends, "band_h": band_h, "frame_ms": frame_ms,
            "timed_frame_ms": timed_ms,
            "gather_ms": sum(k["ms"] for k in split["scene"].values()) / 3,
            "band_gather_ms": sum(k["ms"] for k in split["band"].values()) / 3,
            "bytes": sum(k["bytes"] for v in split.values()
                         for k in v.values()) // 3,
            "transport": mesh.transport, "ranks": ranks}


def _noisy(scene, seed: int = 1):
    """Phase 5b's start: seeded noise on SH (sigma 1) and opacity logits
    (sigma 0.5)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dev = scene.device
    return scene._replace(
        sh=scene.sh + torch.from_numpy(rng.normal(
            0.0, 1.0, tuple(scene.sh.shape)).astype(np.float32)).to(dev),
        opacity_logits=scene.opacity_logits + torch.from_numpy(rng.normal(
            0.0, 0.5, tuple(scene.opacity_logits.shape)).astype(
                np.float32)).to(dev))


def one_rank_worker(budgets, mesh=None) -> dict:
    """13c on a one-rank NCCL mesh: the direct step and the collective path
    (``force_shard_map``) from the same start at frame a, ``ONE_RANK_STEPS``
    each (K1-K4 counted from 0 around them), then timed."""
    import torch
    from sage3d_tpu_torch.ops import binning, composite_cuda as cc, segreduce
    from sage3d_tpu_torch.parallel import train
    from sage3d_tpu_torch.renderer.camera import stack_cameras
    from sage3d_tpu_torch.renderer.render import budget_kwargs, render
    room, cam = frame_a(mesh.device)
    bk = budget_kwargs(budgets)
    with torch.no_grad():
        target = render(room, cam, backend="cuda", **bk)["rgb"][None]
    start, cams = _noisy(room), stack_cameras([cam])
    opt = train.make_group_optimizer(extent=1.0)
    kernels = (binning.emit_tile_pairs, cc.composite_fwd, cc.composite_bwd,
               segreduce.segment_reduce_sorted)
    runs = {}
    for name, kw in (("direct", {}),
                     ("one-rank mesh", {"mesh": mesh,
                                        "force_shard_map": True})):
        step, _ = train.make_train_step(start, cam, optimizer=opt,
                                        backend="cuda", **kw, **bk)
        state = train.init_train_state(start, opt, kw.get("mesh"))
        torch.cuda.synchronize()
        for fn in kernels:
            fn.launches = 0
        mesh.counter.reset()
        losses = [float(step(state, cams, target)[1])
                  for _ in range(ONE_RANK_STEPS)]
        runs[name] = {"step": step, "state": state, "losses": losses,
                      "counts": mesh.counter.counts(), "ms": [],
                      "params": {k: v.detach().clone()
                                 for k, v in state.params.items()},
                      "launches": [fn.launches for fn in kernels]}
    # timed in turns, direct and mesh, after 2 warm-ups each
    for i in range(2 + ONE_RANK_TIMED):
        for r in runs.values():
            ms = _events_ms(lambda: r["step"](r["state"], cams, target))
            if i >= 2:
                r["ms"].append(ms)
    d, m = runs["direct"], runs["one-rank mesh"]
    return {"bitwise": all(torch.equal(d["params"][k], m["params"][k])
                           for k in d["params"]) and d["losses"] == m["losses"],
            "losses": m["losses"], "direct_ms": statistics.median(d["ms"]),
            "mesh_ms": statistics.median(m["ms"]), "counts": m["counts"],
            "transport": mesh.transport,
            "launches": [a + b for a, b in zip(d["launches"], m["launches"])]}


def adc_mesh_worker(mesh=None) -> dict:
    """13d on one rank: ``fit_scene_adaptive`` on the (1, 2) mesh at cell
    adc's sizes, ``ADC_MESH_STEPS`` steps, rounds every ``ADC_MESH_EVERY``,
    each step logged (one host read a step); then every rank's fitted scene
    gathered and held bitwise to rank 0's."""
    import numpy as np
    import torch
    from sage3d_tpu_torch.ops import binning, composite_cuda as cc, segreduce
    from sage3d_tpu_torch.parallel import trainer as tr
    from sage3d_tpu_torch.parallel.mesh import all_gather
    from sage3d_tpu_torch.renderer.camera import make_camera, stack_cameras
    from sage3d_tpu_torch.renderer.render import (autotune_poses,
                                                  budget_kwargs, render)
    from sage3d_tpu_torch.renderer.scene import (importance_subset,
                                                 synthetic_room)
    dev = mesh.device
    target = synthetic_room(ADC_N, seed=7, device=dev)
    cams_l = []
    for i in range(ADC_VIEWS):
        ang = 2 * np.pi * i / ADC_VIEWS + np.pi / 4
        cams_l.append(make_camera(
            [3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.4],
            [-np.cos(ang), -np.sin(ang), -0.1], width=ADC_W, height=ADC_H,
            device=dev))
    cams = stack_cameras(cams_l)
    budgets = autotune_poses(target, cams, pair_margin=1.5)
    bk = budget_kwargs(budgets)
    with torch.no_grad():
        targets = torch.stack([render(target, c, backend="cuda", **bk)["rgb"]
                               for c in cams_l])
    start = importance_subset(target, ADC_START)
    cfg = tr.TrainerConfig(steps=ADC_MESH_STEPS, log_every=1, backend="cuda",
                           group_lrs=True, mesh_shape=tuple(mesh.shape.values()),
                           pair_capacity=budgets["pair_capacity"],
                           tile_capacity=budgets["tile_capacity"],
                           budgets=budgets)
    adaptive = tr.AdaptiveConfig(densify_every=ADC_MESH_EVERY,
                                 grad_threshold=ADC_GRAD)
    kernels = (binning.emit_tile_pairs, cc.composite_fwd, cc.composite_bwd,
               segreduce.segment_reduce_sorted)
    torch.cuda.synchronize()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    fitted, history = tr.fit_scene_adaptive(start, cams, targets, cfg,
                                            adaptive, capacity=ADC_N, seed=0,
                                            verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    bits = torch.cat([getattr(fitted, k).reshape(-1).view(torch.int32)
                      for k in TRAINABLE] + [fitted.semantic_ids.reshape(-1)])
    every = all_gather(bits[None], mesh, None, tag="report")
    same = all(torch.equal(every[0], every[r]) for r in range(len(every)))
    ranks = _rank_stats(mesh, launches + [
        torch.cuda.max_memory_allocated(dev)])
    return {"history": history, "wall_s": wall, "ranks_equal": same,
            "ranks": ranks, "budgets": budgets}


def sharded_path(ref_a, kend_a, budgets_a, budgets_train, card) -> dict:
    """Phase 13, the sharded path (see the module docstring). Returns K1-K4's
    launches on the ranks' main-path runs, summed over the ranks."""
    import functools
    import torch
    from sage3d_tpu_torch.parallel.mesh import spawn_mesh
    from sage3d_tpu_torch.parallel.multihost import GRAD_REL as SHARD_GRAD
    from sage3d_tpu_torch.parallel.multihost import dryrun_multihost
    names = ("emit", "composite_fwd", "composite_bwd", "segreduce")
    total = dict.fromkeys(names, 0)
    torch.cuda.empty_cache()       # the ranks share the card with this process

    def attempt(label, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except RuntimeError as e:   # a rank failed: the phase fails
            print(f"{label}: {e}", flush=True)
            check(False, f"{label} ran")
            return None
        print(f"{label} {card}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    # 13a. band rendering of frame a --------------------------------------------
    tiles_x = -(-ref_a["rgb"].shape[1] // 32)
    tiles_y = -(-ref_a["rgb"].shape[0] // 32)
    for shape in SHARD_MESHES:
        r = attempt(f"13a {shape}", lambda: spawn_mesh(
            functools.partial(band_worker, budgets_a), shape,
            timeout_s=SHARD_TIMEOUT))
        if r is None:
            continue
        err = max(float((r[k] - ref_a[k]).abs().max()) for k in ("rgb",
                                                                  "alpha"))
        sem = float((r["semantic"] == ref_a["semantic"]).float().mean())
        kend = r["kend"].view(-1, tiles_x)[:tiles_y].reshape(-1)
        kend_diff = int((kend != kend_a.to(kend.device)).sum())
        ranks = r["ranks"]
        for k, i in (("emit", 0), ("composite_fwd", 1)):
            total[k] += sum(x[i] for x in ranks)
        print(f"13a band render {shape} {card}: {r['band_h']} rows a band; "
              f"vs the unsharded frame max_abs rgb/alpha {err:.3e}, semantic "
              f"agreement {sem:.6f}, k_end differs on {kend_diff} of "
              f"{tiles_x * tiles_y} tiles; overflow {r['overflow']}, per band "
              f"{[x[2] for x in ranks]}; K1, K2 per rank "
              f"{[x[:2] for x in ranks]}; frame {r['frame_ms']:.3f} ms "
              f"(median of {SHARD_FRAMES}, events on rank 0); with collective "
              f"times {r['timed_frame_ms']:.3f} ms: scene gather "
              f"{r['gather_ms']:.3f}, band gather {r['band_gather_ms']:.3f}, "
              f"render {r['timed_frame_ms'] - r['gather_ms'] - r['band_gather_ms']:.3f}"
              f" ms; {r['bytes'] / 1e6:.1f} MB gathered a frame on rank 0, "
              f"transport "
              f"{r['transport']} (ranks share the card: host path, not "
              f"NVLink); peak memory per rank "
              f"{[round(x[3] / 2**30, 2) for x in ranks]} GiB", flush=True)
        check(r["overflow"] == 0 and all(x[2] == 0 for x in ranks),
              f"13a {shape}: every band's overflow is 0")
        check(all(x[0] == 1 and x[1] == 1 for x in ranks),
              f"13a {shape}: K1 and K2 launched once a band")
        check(err <= K2_ATOL,
              f"13a {shape}: rgb/alpha within {K2_ATOL} of the unsharded frame")

    # 13b. the sharded train step at full width ---------------------------------
    episodes = [{"episode_id": f"a+{dx}", "position": [
        BENCH_CAM["position"][0] + dx] + BENCH_CAM["position"][1:],
        "forward": BENCH_CAM["forward"], "focal_mm": BENCH_CAM["focal_mm"]}
        for dx in (0.0, SHARD_CAM_OFFSET)]
    for hosts, per_host in SHARD_STEP_MESHES:
        rep = attempt(f"13b ({hosts}, {per_host})", lambda: dryrun_multihost(
            hosts, per_host, n_gauss=FRAME_A[0], image=FRAME_A[1:],
            steps=SHARD_STEPS, seed=0, episodes=episodes,
            timeout_s=SHARD_TIMEOUT))
        if rep is None:
            continue
        r0 = rep["ranks"][0]
        for rank in rep["ranks"]:
            for k in names:
                total[k] += rank["launches"][k]
        coll = r0["collectives_last_step"]
        coll_ms = sum(v["ms"] for v in coll.values())
        step_ms = statistics.median(r0["step_ms"][2:-1] or r0["step_ms"])
        last_ms = r0["step_ms"][-1]
        print(f"13b train step ({hosts}, {per_host}) {card}: losses "
              f"{[f'{v:.6e}' for v in rep['losses']]} (every rank's bitwise "
              f"equal); first-step gradients vs the direct step's, max_abs / "
              f"group max {json.dumps(r0['grad_rel'])}; step {step_ms:.3f} ms "
              f"(median of steps 3-{SHARD_STEPS - 1}, events on rank 0; "
              f"direct step {r0['direct_step_median_ms']:.3f} ms on the same "
              f"2 cameras); the last step, each collective synchronized, "
              f"{last_ms:.3f} ms: collectives {coll_ms:.3f} ms "
              f"({json.dumps(coll)}), Adam {r0['adam_ms']:.3f} ms (an Adam "
              f"step timed alone), render fwd+bwd and glue "
              f"{last_ms - coll_ms - r0['adam_ms']:.3f} ms; collectives a step "
              f"{json.dumps(r0['written_collectives'])};"
              f" transport {r0['transport']} (ranks share the card: host "
              f"path, not NVLink); shard rows {r0['shard_rows']['means']} of "
              f"{r0['total_rows']}; overflow first/last "
              f"{[x['overflow_first_last'] for x in rep['ranks']]}; peak "
              f"memory per rank "
              f"{[round((x['peak_memory'] or 0) / 2**30, 2) for x in rep['ranks']]}"
              f" GiB; K1-K4 per rank "
              f"{[list(x['launches'].values()) for x in rep['ranks']]}",
              flush=True)
        losses = rep["losses"]
        check(all(v <= SHARD_GRAD for v in r0["grad_rel"].values()),
              f"13b ({hosts}, {per_host}): first-step gradients within "
              f"{SHARD_GRAD} of each group's max of the direct step's")
        check(losses[-1] < losses[0],
              f"13b ({hosts}, {per_host}): the loss falls")
        check(all(x["written_collectives"] == SHARD_COUNTS
                  for x in rep["ranks"]),
              f"13b ({hosts}, {per_host}): {SHARD_COUNTS} a step")
        check(all(x["shard_rows"]["means"] * per_host == x["total_rows"]
                  for x in rep["ranks"]),
              f"13b ({hosts}, {per_host}): shard rows N / n_tile")
        check(all(v == 0 for x in rep["ranks"]
                  for v in x["overflow_first_last"]),
              f"13b ({hosts}, {per_host}): overflow 0")

    # 13c. the wrapper's cost: a one-rank NCCL group ------------------------
    r = attempt("13c", lambda: spawn_mesh(
        functools.partial(one_rank_worker, budgets_train), (1, 1),
        backend="nccl", timeout_s=SHARD_TIMEOUT))
    if r is not None:
        for k, n in zip(names, r["launches"]):
            total[k] += n
        print(f"13c one-rank {r['transport']} mesh vs the direct step at "
              f"frame a {card}: {ONE_RANK_STEPS} steps bitwise equal: "
              f"{r['bitwise']} (losses {[f'{v:.6e}' for v in r['losses']]});"
              f" step {r['mesh_ms']:.3f} ms vs {r['direct_ms']:.3f} ms direct"
              f" (medians of {ONE_RANK_TIMED} steps each, in turns, events):"
              f" the wrapper costs "
              f"{r['mesh_ms'] - r['direct_ms']:.3f} ms; collectives over the "
              f"{ONE_RANK_STEPS} steps {json.dumps(r['counts'])}", flush=True)
        check(r["bitwise"] and r["transport"] == "nccl",
              "13c: the one-rank NCCL step is bitwise the direct step")

    # 13d. density control on a tile mesh ---------------------------------------
    r = attempt("13d (1, 2)", lambda: spawn_mesh(adc_mesh_worker, (1, 2),
                                                 timeout_s=SHARD_TIMEOUT))
    if r is not None:
        for rank in r["ranks"]:
            for k, n in zip(names, rank[:4]):
                total[k] += n
        hist = r["history"]
        t = [hist[0]["elapsed_s"]] + [
            b["elapsed_s"] - a["elapsed_s"] for a, b in zip(hist, hist[1:])]
        rounds = [h for h in hist if "n_alive" in h]
        plain = [ms for h, ms in zip(hist, t) if "n_alive" not in h][2:]
        step_ms = statistics.median(plain) * 1e3
        round_ms = [(ms - statistics.median(plain)) * 1e3
                    for h, ms in zip(hist, t) if "n_alive" in h]
        mse = [h["mse"] for h in hist]
        e = ADC_MESH_EVERY
        segments = [(mse[a], mse[a + e - 1]) for a in range(0, len(mse), e)]
        print(f"13d fit_scene_adaptive (1, 2) {card}: {r['wall_s']:.2f} s "
              f"wall, {ADC_MESH_STEPS} steps of {ADC_VIEWS} views at "
              f"{ADC_W}x{ADC_H}; step {step_ms:.3f} ms (median, host clock, "
              f"one loss read a step); a round {[round(x, 3) for x in round_ms]}"
              f" ms above a step; rounds "
              f"{[{k: h[k] for k in ('step', 'n_alive', 'n_new', 'n_pruned')} for h in rounds]};"
              f" loss (first, last) between rounds {segments}; ranks' fitted "
              f"scenes bitwise equal: {r['ranks_equal']}; K1-K4 and peak "
              f"memory per rank {r['ranks']}", flush=True)
        check(r["ranks_equal"] and len(rounds) == ADC_MESH_STEPS // e,
              "13d: the ranks' scenes are bitwise equal after each round "
              "(the trainer checks each round; the fitted scenes here)")
        check(all(b < a for a, b in segments),
              "13d: the loss falls between rounds")
    return total


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
    from sage3d_tpu_torch.ops.composite_torch import composite_tiles
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
    check(len(secs) == 7 and all(_build._target(k).exists() for k in secs),
          "build: the seven CUDA sources (K1-K6 and the K2 probe) built")

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

    # 3, 4. K1 and K2 against their plain versions at frame a ----------------
    fa = k1_k2_against_plain(scene_a, cam_a, bk_a, "frame a")
    plan, bins_a = fa["plan"], fa["bins"]
    k1_args, k1_equal = fa["k1_args"], fa["k1_equal"]
    attrs_a, k2_args, k2_err = fa["attrs"], fa["k2_args"], fa["k2_err"]
    pg, start, count = k2_args[1:4]
    out_k, kend_k = fa["out_k"], fa["kend_k"]
    n_tiles_a = plan.tiles_x * plan.tiles_y

    def padded_slots(tier):   # the JAX kernel's padded emission: n_pad columns
        m = tier.gauss.shape[0]
        gb = min(binning.EMIT_GB, max(128, m))
        return -(-m // gb) * gb, tier.k_budget

    budgeted = sum(n * k for n, k in map(padded_slots, plan.tiers))
    print(f"K1 at frame a: {len(plan.tiers)} tiers, {budgeted} budgeted slots "
          f"(the padded emission's), {plan.n_live} live, "
          f"{int(bins_a.n_pairs)} kept", flush=True)
    check(plan.mult > 0, "frame a takes the fused-key path")
    probe_a = kernel_anatomy.make_variant(
        n_tiles_a, plan.tiles_x,
        **kernel_anatomy.VARIANTS[kernel_anatomy.PRODUCTION])(*k2_args[:4])
    torch.cuda.synchronize()
    print(f"K2 vs the probe's production variant at frame a: "
          f"{int((probe_a != out_k).sum())} values differ", flush=True)
    check(torch.equal(probe_a, out_k),
          "probe, early stop on, all blocks: bitwise equal to K2 at frame a")
    del probe_a

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
        first-order prediction, at each step length of SLOPE_STEPS; and the
        gradients."""
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
        return ratios, {k: leaves[k].grad for k in TRAINABLE}

    def fmt_ratios(ratios):
        return "; ".join(f"{k} " + ", ".join(f"{r:.4f}" for r in rs)
                         for k, rs in ratios.items())

    slopes, grads_full = slope_ratios(sh_start, cam_a, target, "cuda", bk_t)
    print(f"start SH noise 0.1, 1080p/1M, cuda: measured / first-order loss "
          f"change along -grad at step lengths {SLOPE_STEPS}: "
          f"{fmt_ratios(slopes)}", flush=True)
    check(all(min(abs(r - 1.0) for r in rs) <= SLOPE_TOL
              for rs in slopes.values()),
          f"1080p/1M: every group's loss change within {SLOPE_TOL} of its "
          "gradient's first-order prediction at one step length")

    # 5d. the same start through the torch backend at 1080p/1M ------------------
    # The torch backend walks every chunk of a tile; the cuda forward stops a
    # tile once its max T <= 1e-4 (K2's contract, as the JAX Pallas kernel's),
    # so at a frame this dense the two are different functions of the scene.
    # The torch backend over the chunks the cuda forward walked (each tile's
    # pairs cut at its k_end chunks) is the cuda backend's function: there
    # the gradients of all five groups must agree.
    t0 = time.perf_counter()
    ekw_t = {k: bk_t[k] for k in binning.EMIT_BUDGET_KEYS}
    with torch.no_grad():
        proj_s = project_gaussians(sh_start, cam_a)
        bins_s = binning.bin_gaussians(proj_s, cam_a.width, cam_a.height,
                                       **ekw_t)
        pg_s, start_s, count_s, _ = cc.trim_to_capacity(
            bins_s, bk_t["pair_capacity"])
        _, kend_s = cc.composite_fwd(
            cc.attribute_table(proj_s, sh_start.semantic_ids), pg_s, start_s,
            torch.clamp(count_s, max=bk_t["tile_capacity"]), bins_s.tiles_x)
    leaves = {k: getattr(sh_start, k).clone().requires_grad_()
              for k in TRAINABLE}
    walk_scene = sh_start._replace(**leaves)
    proj_w = project_gaussians(walk_scene, cam_a)
    bins_w = binning.bin_gaussians(proj_w, cam_a.width, cam_a.height, **ekw_t)
    cut = bins_w._replace(tile_count=torch.minimum(
        bins_w.tile_count, kend_s.to(bins_w.tile_count.dtype) * cc.CHUNK))
    rgb_w = composite_tiles(proj_w, walk_scene.semantic_ids, cut,
                            cam_a.width, cam_a.height,
                            tile_capacity=bk_t["tile_capacity"])["rgb"]
    (torch.sum((rgb_w - target[0]) ** 2) / target[0].numel()).backward()

    def rel(got, ref):
        return {k: float((got[k] - ref[k]).abs().max())
                / max(float(ref[k].abs().max()), 1e-30) for k in TRAINABLE}

    rel_walk = rel(grads_full, {k: leaves[k].grad for k in TRAINABLE})
    print(f"5d start SH noise 0.1, 1080p/1M {card}: cuda vs torch gradients "
          f"over the chunks the cuda forward walked (sum k_end "
          f"{int(kend_s.sum())}), max_abs / max|torch| per group "
          f"{json.dumps(rel_walk)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(max(rel_walk.values()) <= GRAD_REL,
          f"1080p/1M: cuda gradients of all five groups within {GRAD_REL} "
          "of the torch backend's over the same chunks")
    print(f"peak device memory after 5d {card}: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

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
        ratios, _ = slope_ratios(g_start, g_cam, g_target, backend, bk_g)
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

    # 9. the navigation path --------------------------------------------------------
    script_peak = max(script_peak, torch.cuda.max_memory_allocated())
    t0 = time.perf_counter()
    launches_nav, nav_peak, nav_budgets, k6 = navigation(
        frames["a_1080p_1M"][0], card)
    print(f"navigation phase {card}: {time.perf_counter() - t0:.1f} s, "
          f"launches K1 {launches_nav[0]} K2 {launches_nav[1]} K6 "
          f"{launches_nav[2]}, peak device "
          f"memory {nav_peak / 2**30:.2f} GiB", flush=True)
    script_peak = max(script_peak, nav_peak)

    # 10. the data path -------------------------------------------------------------
    t0 = time.perf_counter()
    launches_data, k5 = data_path(frames["a_1080p_1M"][0],
                                  frames["c_env_640x480_200k"][0], card)
    print(f"data phase {card}: {time.perf_counter() - t0:.1f} s, launches "
          f"K1 {launches_data[0]} K2 {launches_data[1]} K5 "
          f"{k5['launches']}", flush=True)
    script_peak = max(script_peak, torch.cuda.max_memory_allocated())

    # 11. serving ---------------------------------------------------------------------
    t0 = time.perf_counter()
    launches_serve = serving(frames["a_1080p_1M"][0], cam_a, nav_budgets, card)
    print(f"serving phase {card}: {time.perf_counter() - t0:.1f} s, launches "
          f"K1 {launches_serve[0]} K2 {launches_serve[1]}", flush=True)
    script_peak = max(script_peak, torch.cuda.max_memory_allocated())

    # 12. ADC training ----------------------------------------------------------------
    t0 = time.perf_counter()
    launches_adc = adc_training(frames["c_env_640x480_200k"][0], card)
    print(f"ADC phase {card}: {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps(launches_adc)}", flush=True)
    script_peak = max(script_peak, torch.cuda.max_memory_allocated())
    print(f"peak device memory {card}: {script_peak / 2**30:.2f} GiB for the "
          f"script, {peak_b / 2**30:.2f} GiB at frame b's render", flush=True)

    # 13. the sharded path --------------------------------------------------------------
    t0 = time.perf_counter()
    launches_mesh = sharded_path(outs["a_1080p_1M"], kend_k,
                                 budgets["a_1080p_1M"], budgets_train, card)
    print(f"sharded phase {card}: {time.perf_counter() - t0:.1f} s, launches "
          f"summed over the ranks {json.dumps(launches_mesh)}", flush=True)

    kernels = [
        {"name": "K1 emit_tile_pairs", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/emit.cu",
         "replaces": "sage3d_tpu/ops/binning.py:153",
         "launches": launches["emit"] + launches_train["emit"]
         + launches_bench["emit"] + launches_nav[0] + launches_data[0]
         + launches_serve[0] + launches_adc["emit"]
         + launches_mesh["emit"],
         "max_abs_err": 0.0 if k1_equal else None,
         "ms": k1_ms, "back_to_back_ms": dev_ms["K1"],
         "host_ms": host_ms["K1"],
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "K2 composite_fwd", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/composite_fwd.cu",
         "replaces": "sage3d_tpu/ops/composite_pallas.py:156",
         "launches": launches["composite_fwd"]
         + launches_train["composite_fwd"] + launches_bench["composite_fwd"]
         + launches_nav[1] + launches_data[1] + launches_serve[1]
         + launches_adc["composite_fwd"]
         + launches_mesh["composite_fwd"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "back_to_back_ms": dev_ms["K2"],
         "host_ms": host_ms["K2"],
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "K3 composite_bwd", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/composite_bwd.cu",
         "replaces": "sage3d_tpu/ops/composite_pallas.py:249",
         "launches": launches_train["composite_bwd"]
         + launches_bench["composite_bwd"] + launches_adc["composite_bwd"]
         + launches_mesh["composite_bwd"],
         "max_abs_err": k3_err,
         "ms": k3_ms, "back_to_back_ms": dev_ms["K3"],
         "host_ms": host_ms["K3"],
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None, "registers": k3_regs},
        {"name": "K4 segment_reduce_sorted", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/segreduce.cu",
         "replaces": "sage3d_tpu/ops/segreduce.py:55",
         "launches": launches_train["segreduce"] + launches_bench["segreduce"]
         + launches_adc["segreduce"]
         + launches_mesh["segreduce"],
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
        {"name": "K5 relax_tiles", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/wavefront.cu",
         "replaces": "sage3d_tpu/data/astar.py:147",
         "launches": k5["launches"], "max_abs_err": k5["max_abs_err"],
         "ms": k5["ms"], "back_to_back_ms": k5["back_to_back_ms"],
         "host_ms": k5["host_ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None},
        {"name": "K6 capsule_best", "route": "cuda",
         "source": "sage3d_tpu_torch/csrc/capsule.cu",
         "replaces": "sage3d_tpu/ops/collision.py:41",
         "launches": launches_nav[2], "max_abs_err": k6["max_abs_err"],
         "ms": k6["ms"], "back_to_back_ms": k6["back_to_back_ms"],
         "host_ms": k6["host_ms"], "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
         "b64_back_to_back_ms": k6["b64_back_to_back_ms"],
         "b64_bound_ms": k6["b64_bound_ms"], "library_ms": None},
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
