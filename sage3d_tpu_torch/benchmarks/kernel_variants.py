"""Design variants of K1 (``csrc/emit.cu``), K2 (``csrc/composite_fwd.cu``),
K3 (``csrc/composite_bwd.cu``), K4 (``csrc/segreduce.cu``) and K6
(``csrc/capsule.cu``), timed against the kernels as built, on the inputs the
render and its backward give them at the 1920x1080 frame of the 1M-Gaussian
room (``chip_smoke.py``'s frame a), and for K6 on 64, 4 and 1 capsules
against that room (the many- and few-query schedules). Card only:

    python -m sage3d_tpu_torch.benchmarks.kernel_variants [K1 K2 K3 K4 K6] [--tree PATH]

(the kernels named, all five by default). ``--tree PATH`` adds the K2 of
another checkout (e.g. the parent commit unpacked with ``git archive``) as
one more variant of K2: held bitwise to the K2 built here and timed beside
it in the same call (a checkout whose K2 takes ``cam_tiles``, the tiles of
one camera of a batch, as this one's does). For K6 it imports that checkout's ``ops/collision.py``
as a package of its own (``tree_collision``; its C interface may differ):
its K6 at each B, held bitwise to the K6 built here, and the dense query
at B = 1 and 64 and the pruned one at B = 1 through both checkouts' entry
points, all timed in the same turns. Each other variant is the kernel's
source with one or two of its constants edited (the edits are listed in
``VARIANTS``), built with the kernels' own ``nvcc`` flags (plus ``-Xptxas
-v`` for the register count) into ``build/variants/``. Each must give the
built kernel's output bit for bit; K1's pairs, whose order is free, are
compared sorted by key. Times, in turns over ``ROUNDS`` rounds: the median
CUDA-event time around one call, and the time per call of 20 calls queued
back to back behind a spin of the card; K4's beside ``index_add_`` on the
same rows. Prints one JSON line.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, binning, collision, composite_cuda as cc, segreduce
from ..ops.projection import project_gaussians
from ..renderer.camera import make_camera
from ..renderer.render import autotune_all, budget_kwargs
from ..renderer.scene import synthetic_room
from . import bench, kernel_anatomy
from ._util import log, nvidia_smi_line

ROUNDS = 2
SPIN_CYCLES = 100_000_000   # ~57 ms at 1.755 GHz

# name -> (kernel, {source text: replacement}, extra nvcc flags)
_K1_BLOCK = "constexpr int kBlock = 128;"
_K1_SLOTS = "constexpr int kSlots = 8;"
_K1_SEARCH = "constexpr bool kBlockSearch = true;"
_K2_PIX = "constexpr int kPix = 8;"
_K2_BLOCKS = "constexpr int kMinBlocks = 3;"
_K2_SKIP = "constexpr bool kSkipMisses = false;"
_K4_THREADS = "constexpr int kThreads = 64;"
_K4_UNROLL = "constexpr int kUnroll = 2;"
_K3_BOUNDS = "__launch_bounds__(kThreads, 4)"
_K6_WAVES = "constexpr int kManyWaves = 4;"
_K6_FEW = "constexpr int kFewMax = 4;"
_K6_BOUNDS = "__launch_bounds__(kThreads)\ncapsule_many("
_K6_LOOP = "        for (int j = my_lane; j < total; j += n_lanes) {"
VARIANTS = {
    "K1 as built (128 threads a block, 8 slots a thread, block window search)":
        ("emit", {}, ()),
    "K1, 4 slots a thread": ("emit", {_K1_SLOTS: "constexpr int kSlots = 4;"}, ()),
    "K1, 16 slots a thread": ("emit", {_K1_SLOTS: "constexpr int kSlots = 16;"}, ()),
    "K1, 64 threads a block": ("emit", {_K1_BLOCK: "constexpr int kBlock = 64;"}, ()),
    "K1, 256 threads a block": ("emit", {_K1_BLOCK: "constexpr int kBlock = 256;"}, ()),
    "K1, per-thread search over all Gaussians":
        ("emit", {_K1_SEARCH: "constexpr bool kBlockSearch = false;"}, ()),
    "K2 as built (8 pixels a thread, __launch_bounds__(128, 3))":
        ("composite_fwd", {}, ()),
    "K2, a warp skips pairs that miss its pixels":
        ("composite_fwd", {_K2_SKIP: "constexpr bool kSkipMisses = true;"}, ()),
    "K2, __launch_bounds__(128, 4)":
        ("composite_fwd", {_K2_BLOCKS: "constexpr int kMinBlocks = 4;"}, ()),
    "K2, __launch_bounds__(128, 2)":
        ("composite_fwd", {_K2_BLOCKS: "constexpr int kMinBlocks = 2;"}, ()),
    "K2, 4 pixels a thread, __launch_bounds__(256, 2)":
        ("composite_fwd", {_K2_PIX: "constexpr int kPix = 4;",
                           _K2_BLOCKS: "constexpr int kMinBlocks = 2;"}, ()),
    "K4 as built (64 threads a block, 2 rows in flight)":
        ("segreduce", {}, ()),
    "K4, 1 row in flight": ("segreduce", {_K4_UNROLL: "constexpr int kUnroll = 1;"}, ()),
    "K4, 4 rows in flight": ("segreduce", {_K4_UNROLL: "constexpr int kUnroll = 4;"}, ()),
    "K4, 4 rows in flight, at most 64 registers":
        ("segreduce", {_K4_UNROLL: "constexpr int kUnroll = 4;"},
         ("-maxrregcount=64",)),
    "K4, 32 threads a block": ("segreduce", {_K4_THREADS: "constexpr int kThreads = 32;"}, ()),
    "K4, 128 threads a block": ("segreduce", {_K4_THREADS: "constexpr int kThreads = 128;"}, ()),
    "K4, 256 threads a block, 4 rows in flight":
        ("segreduce", {_K4_THREADS: "constexpr int kThreads = 256;",
                       _K4_UNROLL: "constexpr int kUnroll = 4;"}, ()),
    "K6 as built (many queries: 4 waves of blocks)": ("capsule", {}, ()),
    "K6, the many-query schedule at every B":
        ("capsule", {_K6_FEW: "constexpr int kFewMax = 0;"}, ()),
    "K6, 1 wave": ("capsule", {_K6_WAVES: "constexpr int kManyWaves = 1;"}, ()),
    "K6, 2 waves": ("capsule", {_K6_WAVES: "constexpr int kManyWaves = 2;"}, ()),
    "K6, pair loop unrolled by 2":
        ("capsule", {_K6_LOOP: "#pragma unroll 2\n" + _K6_LOOP}, ()),
    "K6, __launch_bounds__(256, 3)":
        ("capsule", {_K6_BOUNDS: "__launch_bounds__(kThreads, 3)\ncapsule_many("},
         ()),
    "K3 as built (__launch_bounds__(128, 4))": ("composite_bwd", {}, ()),
    "K3, __launch_bounds__(128, 3)":
        ("composite_bwd", {_K3_BOUNDS: "__launch_bounds__(kThreads, 3)"}, ()),
    "K3, __launch_bounds__(128)":
        ("composite_bwd", {_K3_BOUNDS: "__launch_bounds__(kThreads)"}, ()),
}


def _start_build(name: str, kernel: str, edits: dict, flags: tuple,
                 csrc=None):
    src = ((csrc or _build.CSRC) / _build.KERNELS[kernel][0]).read_text()
    for old, new in edits.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in the source once")
        src = src.replace(old, new)
    digest = hashlib.sha256((src + " ".join(flags)).encode()).hexdigest()[:12]
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{kernel}-{digest}.cu"
    cu.write_text(src)
    lib = out_dir / f"lib{kernel}-{digest}.so"
    cmd = [_build._nvcc(), *_build._COMMON_FLAGS, *flags, "-Xptxas", "-v",
           "-o", str(lib), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), lib


def _finish_build(name: str, kernel: str, job):
    proc, lib_path = job
    log_text = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log_text}")
    import ctypes
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _build.KERNELS[kernel][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                              log_text)})
    return lib, regs


def _event_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
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


def _back_to_back_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def frame_a_inputs(dev):
    """The kernels' arguments at ``chip_smoke.py``'s frame a, with its
    budgets, by kernel: K1's (the emission table, offsets, live slots,
    tiles_x, the fused key's mult), K2's (the attribute table, the pair list,
    the tile ranges, tiles_x), K3's, and K4's (sorted ids, slot rows, N, sort
    index)."""
    scene = synthetic_room(1_000_000, seed=0, device=dev)
    cam = make_camera(position=[0.0, -6.0, 1.5], forward=[0.0, 1.0, -0.05],
                      focal_mm=14.0, width=1920, height=1080, device=dev)
    bk = budget_kwargs(autotune_all(scene, cam, pair_margin=1.05))
    c_cap = int(autotune_all(scene, cam, pair_margin=1.5,
                             grad_margin=1.5)["grad_capacity"])
    with torch.no_grad():
        proj = project_gaussians(scene, cam)
        ekw = {k: bk[k] for k in binning.EMIT_BUDGET_KEYS}
        plan = binning.emission_plan(proj, cam.width, cam.height, **ekw)
        bins = binning.bin_gaussians(proj, cam.width, cam.height, **ekw)
    attrs = cc.attribute_table(proj, scene.semantic_ids)
    pg, start, count, _ = cc.trim_to_capacity(bins, bk["pair_capacity"])
    count = torch.clamp(count, max=bk["tile_capacity"])
    k2_args = (attrs, pg, start, count, bins.tiles_x)
    out, kend = cc.composite_fwd(*k2_args)
    chunk0, allowed = cc.slot_ranges(kend, c_cap)
    gen = torch.Generator(device=dev).manual_seed(0)
    gout = torch.randn(out.shape, generator=gen, device=dev)
    k3_args = (attrs, pg, start, count, chunk0, allowed, out, gout, c_cap,
               bins.tiles_x)
    slots = cc.composite_bwd(*k3_args)
    ids, perm = torch.sort(slots[:, cc.GID_COL].to(torch.int32), stable=True)
    box_scene = bench.make_bench_scene(device=dev)
    box_cam = bench.bench_camera(device=dev)
    box = kernel_anatomy.prepare(box_scene, box_cam,
                                 bench.autotune(box_scene, box_cam))
    return {"emit": (plan.table, plan.offsets, plan.n_live, plan.tiles_x,
                     plan.mult),
            "composite_fwd": k2_args,
            "composite_fwd box": tuple(box[k] for k in (
                "attrs", "pair_gauss", "tile_start", "tile_count", "tiles_x")),
            "composite_bwd": k3_args,
            "segreduce": (ids, slots[:, :cc.NGRAD], attrs.shape[0], perm)}


def _k1_call(lib, k1_args):
    """K1's kept pairs, sorted by key (their order is free)."""
    table, offsets, n_live, tiles_x, mult = k1_args
    dev = table.device
    keys = torch.empty((n_live,), dtype=torch.int32 if mult else torch.int64,
                       device=dev)
    gauss = torch.empty((n_live,), dtype=torch.int32, device=dev)
    n_kept = torch.empty((), dtype=torch.int64, device=dev)
    err = _build.launch(
        lib.sage3d_emit_tile_pairs, dev, table.data_ptr(), offsets.data_ptr(),
        table.shape[0], n_live, tiles_x, mult, keys.data_ptr(),
        gauss.data_ptr(), n_kept.data_ptr())
    _build.check(err, "emit_tile_pairs variant")
    return keys, gauss, n_kept


def _sorted(pairs):
    keys, gauss, n_kept = pairs
    n = int(n_kept)
    keys, perm = torch.sort(keys[:n])
    return keys, gauss[:n][perm]


def _k2_call(lib, k2_args):
    attrs, pg, start, count, tiles_x = k2_args
    n_tiles = start.shape[0]
    out = torch.empty((n_tiles, cc.NCH, cc.NPIX), dtype=torch.float32,
                      device=attrs.device)
    kend = torch.empty((n_tiles,), dtype=torch.int32, device=attrs.device)
    err = _build.launch(
        lib.sage3d_composite_fwd, attrs.device, attrs.data_ptr(),
        pg.data_ptr(), start.data_ptr(), count.data_ptr(), out.data_ptr(),
        kend.data_ptr(), None, 0, n_tiles, tiles_x, n_tiles, attrs.shape[0],
        pg.shape[0])
    _build.check(err, "composite_fwd variant")
    return out, kend


def _k3_call(lib, k3_args):
    attrs, pg, start, count, chunk0, allowed, out, gout, c_cap, tiles_x = k3_args
    slots = cc._slot_buffer(c_cap, attrs.shape[0], attrs.device)
    n_tiles = start.shape[0]
    work = torch.empty((2 * n_tiles,), dtype=torch.int32, device=attrs.device)
    err = _build.launch(
        lib.sage3d_composite_bwd, attrs.device, attrs.data_ptr(),
        pg.data_ptr(), start.data_ptr(), count.data_ptr(), chunk0.data_ptr(),
        allowed.data_ptr(), out.data_ptr(), gout.data_ptr(), None,
        work.data_ptr(), slots.data_ptr(), n_tiles, tiles_x, n_tiles,
        attrs.shape[0], pg.shape[0], c_cap, 0, n_tiles)
    _build.check(err, "composite_bwd variant")
    return slots


def _k4_call(lib, k4_args):
    ids, rows, n_out, perm = k4_args
    out = torch.empty((n_out, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    err = _build.launch(
        lib.sage3d_segment_reduce, rows.device, ids.data_ptr(),
        perm.data_ptr(), rows.data_ptr(), out.data_ptr(), ids.shape[0],
        rows.shape[0], rows.stride(0), rows.shape[1], n_out)
    _build.check(err, "segment_reduce variant")
    return out


K6_BS = (64, 4, 1)      # K6's query counts: both schedules


def capsule_inputs(dev):
    """The 1M room and ``max(K6_BS)`` agent capsules at positions drawn
    inside its walls (``np.random.default_rng(5)``): (room, p0, p1,
    radius), the radius a number as the entry points take it."""
    room = synthetic_room(1_000_000, seed=0, device=dev)
    xy = np.random.default_rng(5).uniform(-4.2, 4.2, (max(K6_BS), 2))
    return (room, *collision.agent_capsule(xy, device=dev))


def tree_collision(tree):
    """``ops/collision.py`` of the checkout ``tree``, imported as a package
    of its own (``sage3d_tree``) beside this one: its wrapper loads that
    checkout's ``csrc/capsule.cu``, built into its own ``build/``, through
    that checkout's C interface."""
    import importlib
    import importlib.util
    pkg = Path(tree).resolve() / "sage3d_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "sage3d_tree", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["sage3d_tree"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("sage3d_tree.ops.collision")


def tree_k6_calls(tree, room, p0, p1, r) -> dict:
    """The calls that set K6 of the checkout ``tree`` beside the one built
    here, by label: its K6 alone at each B of ``K6_BS`` through its own
    wrapper and columns (an earlier tree may read other columns), and the
    dense query at B = 1 and 64 and the pruned one at B = 1 (chunks of 8192,
    margin 2) through each tree's entry points. Each value is (the call,
    the key in ``measure``'s ``want`` that it must equal bit for bit, or
    None)."""
    other = tree_collision(tree)
    dev = room.means.device
    calls = {}
    cols = other._columns(room)
    for b in K6_BS:
        q = other._queries(p0[:b], p1[:b], r, dev)
        calls[f"K6 of {tree} [B={b}]"] = (
            lambda q=q: tuple(other.capsule_best(q, cols)[:4]),
            f"capsule B={b}")
    for label, mod in (("built", collision), (str(tree), other)):
        accel = mod.build_collision_accel(room, chunk=8192, device=dev)
        for name, fn in (
                ("dense query B=1", lambda mod=mod: mod.capsule_query(
                    room, p0[:1], p1[:1], r, device=dev)),
                ("dense query B=64", lambda mod=mod: mod.capsule_query(
                    room, p0[:64], p1[:64], r, device=dev)),
                ("pruned query B=1", lambda mod=mod, accel=accel:
                    mod.capsule_query_pruned(accel, p0[:1], p1[:1], r,
                                             prune_margin=2.0, device=dev))):
            calls[f"{name} of {label}"] = (fn, None)
    return calls


def _k6_call(lib, k6_args):
    """K6's (clear, idx, hits, visited) through its wrapper, ``lib`` loaded
    as the kernel for the call."""
    built = _build.load("capsule")
    _build._LIBS["capsule"] = lib
    try:
        return tuple(collision.capsule_best(*k6_args)[:4])
    finally:
        _build._LIBS["capsule"] = built


KERNEL_OF = {"K1": "emit", "K2": "composite_fwd", "K3": "composite_bwd",
             "K4": "segreduce", "K6": "capsule"}


def measure(dev, kernels=tuple(KERNEL_OF), tree=None) -> dict:
    """Build, check and time the variants of the kernels named (``K1`` ..
    ``K4``, ``K6``), and with ``tree`` the K2 and K6 of that checkout."""
    wanted = {KERNEL_OF[k] for k in kernels}
    variants = {name: (kernel, edits, flags, None)
                for name, (kernel, edits, flags) in VARIANTS.items()
                if kernel in wanted}
    if tree is not None and "composite_fwd" in wanted:
        variants[f"K2 of {tree}"] = (
            "composite_fwd", {}, (), Path(tree) / "sage3d_tpu_torch" / "csrc")
    jobs = {name: (kernel, _start_build(name, kernel, edits, flags, csrc))
            for name, (kernel, edits, flags, csrc) in variants.items()}
    built = {name: (kernel, *_finish_build(name, kernel, job))
             for name, (kernel, job) in jobs.items()}
    log(f"built {len(built)} variants")
    args = frame_a_inputs(dev) if wanted - {"capsule"} else {}
    if "capsule" in wanted:
        k6_in = capsule_inputs(dev)
        room, p0, p1, r = k6_in
        for b in K6_BS:
            args[f"capsule B={b}"] = (collision._queries(p0[:b], p1[:b], r,
                                                         dev),
                                      collision._columns(room))
    call_of = {"emit": lambda lib: _k1_call(lib, args["emit"]),
               "composite_fwd": lambda lib: _k2_call(lib, args["composite_fwd"]),
               "composite_bwd": lambda lib: _k3_call(lib, args["composite_bwd"]),
               "segreduce": lambda lib: _k4_call(lib, args["segreduce"]),
               **{f"capsule B={b}": (lambda lib, b=b: _k6_call(
                   lib, args[f"capsule B={b}"])) for b in K6_BS}}
    call_of["composite_fwd box"] = (
        lambda lib: _k2_call(lib, args["composite_fwd box"]))
    # What each kernel as built gives, in the form the variants are held to.
    check_of = {"emit": _sorted, "composite_fwd": tuple,
                "composite_fwd box": tuple, "composite_bwd": lambda x: (x,),
                "segreduce": lambda x: (x,),
                **{f"capsule B={b}": tuple for b in K6_BS}}
    want = {}
    if args.get("emit") is not None:
        ids, rows, n_out, perm = args["segreduce"]
        want = {"emit": binning.emit_tile_pairs(*args["emit"]),
                "composite_fwd": cc.composite_fwd(*args["composite_fwd"]),
                "composite_fwd box": cc.composite_fwd(
                    *args["composite_fwd box"]),
                "composite_bwd": cc.composite_bwd(*args["composite_bwd"]),
                "segreduce": segreduce.segment_reduce_sorted(
                    ids, rows, n_out, perm=perm)}
    if "capsule" in wanted:
        for b in K6_BS:
            want[f"capsule B={b}"] = collision.capsule_best(
                *args[f"capsule B={b}"])[:4]
    calls, regs_of = {}, {}
    for name, (kernel, lib, regs) in built.items():
        # K2's variants also run on the bench box, a sparse frame.
        runs = ([f"capsule B={b}" for b in K6_BS] if kernel == "capsule"
                else [kernel] + (["composite_fwd box"]
                                 if kernel == "composite_fwd" else []))
        for run in runs:
            label = name + (f" [{run[8:]}]" if kernel == "capsule" else
                            " [bench box frame]" if run != kernel else "")
            calls[label] = (lambda lib=lib, run=run: call_of[run](lib))
            regs_of[label] = regs
            got = check_of[run](calls[label]())
            ref = check_of[run](want[run])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError(f"{label}: not bitwise equal to the built "
                                   "kernel")
    if tree is not None and "capsule" in wanted:
        for label, (fn, same_as) in tree_k6_calls(tree, *k6_in).items():
            calls[label] = fn
            if same_as is not None:
                got, ref = fn(), want[same_as]
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise RuntimeError(f"{label}: not bitwise equal to "
                                       f"{same_as}")
    if "segreduce" in wanted:
        n_in = int((ids < n_out).sum())
        ids_in, rows_in = ids[:n_in], rows[perm[:n_in]]
        calls["index_add_ (K4's rows, gathered)"] = (
            lambda: torch.zeros((n_out, rows.shape[1]), device=dev)
            .index_add_(0, ids_in, rows_in))
    times = {name: {"event_ms": [], "back_to_back_ms": []} for name in calls}
    with torch.no_grad():
        for _ in range(ROUNDS):
            for name, fn in calls.items():
                times[name]["event_ms"].append(_event_ms(fn))
                times[name]["back_to_back_ms"].append(_back_to_back_ms(fn))
    result = {"device": nvidia_smi_line(), "rounds": ROUNDS, "variants": {}}
    for name, t in times.items():
        regs = regs_of.get(name)
        result["variants"][name] = dict(t, registers=regs)
        log(f"{name}: events {t['event_ms']}, back to back "
            f"{t['back_to_back_ms']} ms, registers {regs}")
    return result


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    tree = None
    if "--tree" in argv:
        i = argv.index("--tree")
        tree = argv[i + 1] if i + 1 < len(argv) else None
        del argv[i:i + 2]
        if tree is None or not (Path(tree) / "sage3d_tpu_torch").is_dir():
            print("kernel_variants: --tree takes a checkout of the repo",
                  file=sys.stderr)
            return 2
    if any(k not in KERNEL_OF for k in argv):
        print(f"kernel_variants: the kernels are {list(KERNEL_OF)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; the variants are CUDA "
              "kernels", file=sys.stderr)
        return 2
    print(json.dumps(measure(torch.device("cuda"), argv or tuple(KERNEL_OF),
                             tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
