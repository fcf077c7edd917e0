"""Design variants of K3 (``csrc/composite_bwd.cu``) and K4
(``csrc/segreduce.cu``), timed against the kernels as built, on the inputs the
backward gives them at the 1920x1080 frame of the 1M-Gaussian room
(``chip_smoke.py``'s frame a). Card only:

    python -m sage3d_tpu_torch.benchmarks.backward_variants

Each variant is the kernel's source with one or two of its constants edited
(the edits are listed in ``VARIANTS``), built with the kernels' own ``nvcc``
flags (plus ``-Xptxas -v`` for the register count) into ``build/variants/``.
Each must give the built kernel's output bit for bit. Times, in turns over
``ROUNDS`` rounds: the median CUDA-event time around one call, and the time
per call of 20 calls queued back to back behind a spin of the card; K4's
beside ``index_add_`` on the same rows. Prints one JSON line.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys

import torch

from ..ops import _build, binning, composite_cuda as cc, segreduce
from ..ops.projection import project_gaussians
from ..renderer.camera import make_camera
from ..renderer.render import autotune_all, budget_kwargs
from ..renderer.scene import synthetic_room
from ._util import log, nvidia_smi_line

ROUNDS = 2
SPIN_CYCLES = 100_000_000   # ~57 ms at 1.755 GHz

# name -> (kernel, {source text: replacement}, extra nvcc flags)
_K4_THREADS = "constexpr int kThreads = 64;"
_K4_UNROLL = "constexpr int kUnroll = 2;"
_K3_BOUNDS = "__launch_bounds__(kThreads, 4)"
VARIANTS = {
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
    "K3 as built (__launch_bounds__(128, 4))": ("composite_bwd", {}, ()),
    "K3, __launch_bounds__(128, 3)":
        ("composite_bwd", {_K3_BOUNDS: "__launch_bounds__(kThreads, 3)"}, ()),
    "K3, __launch_bounds__(128)":
        ("composite_bwd", {_K3_BOUNDS: "__launch_bounds__(kThreads)"}, ()),
}


def _start_build(name: str, kernel: str, edits: dict, flags: tuple):
    src = (_build.CSRC / _build.KERNELS[kernel][0]).read_text()
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
    """K3's arguments and K4's (sorted ids, slot rows, N, sort index) at
    ``chip_smoke.py``'s frame a, with its budgets."""
    scene = synthetic_room(1_000_000, seed=0, device=dev)
    cam = make_camera(position=[0.0, -6.0, 1.5], forward=[0.0, 1.0, -0.05],
                      focal_mm=14.0, width=1920, height=1080, device=dev)
    bk = budget_kwargs(autotune_all(scene, cam, pair_margin=1.05))
    c_cap = int(autotune_all(scene, cam, pair_margin=1.5,
                             grad_margin=1.5)["grad_capacity"])
    with torch.no_grad():
        proj = project_gaussians(scene, cam)
        bins = binning.bin_gaussians(
            proj, cam.width, cam.height,
            **{k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
    attrs = cc.attribute_table(proj, scene.semantic_ids)
    pg, start, count, _ = cc.trim_to_capacity(bins, bk["pair_capacity"])
    count = torch.clamp(count, max=bk["tile_capacity"])
    out, kend = cc.composite_fwd(attrs, pg, start, count, bins.tiles_x)
    chunk0, allowed = cc.slot_ranges(kend, c_cap)
    gen = torch.Generator(device=dev).manual_seed(0)
    gout = torch.randn(out.shape, generator=gen, device=dev)
    k3_args = (attrs, pg, start, count, chunk0, allowed, out, gout, c_cap,
               bins.tiles_x)
    slots = cc.composite_bwd(*k3_args)
    ids, perm = torch.sort(slots[:, cc.GID_COL].to(torch.int32), stable=True)
    return k3_args, (ids, slots[:, :cc.NGRAD], attrs.shape[0], perm)


def _k3_call(lib, k3_args):
    attrs, pg, start, count, chunk0, allowed, out, gout, c_cap, tiles_x = k3_args
    slots = cc._slot_buffer(c_cap, attrs.shape[0], attrs.device)
    err = _build.launch(
        lib.sage3d_composite_bwd, attrs.device, attrs.data_ptr(),
        pg.data_ptr(), start.data_ptr(), count.data_ptr(), chunk0.data_ptr(),
        allowed.data_ptr(), out.data_ptr(), gout.data_ptr(), slots.data_ptr(),
        start.shape[0], tiles_x, attrs.shape[0], pg.shape[0], c_cap)
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


def measure(dev) -> dict:
    jobs = {name: (kernel, _start_build(name, kernel, edits, flags))
            for name, (kernel, edits, flags) in VARIANTS.items()}
    built = {name: (kernel, *_finish_build(name, kernel, job))
             for name, (kernel, job) in jobs.items()}
    log(f"built {len(built)} variants")
    k3_args, k4_args = frame_a_inputs(dev)
    ids, rows, n_out, perm = k4_args
    want = {"composite_bwd": cc.composite_bwd(*k3_args),
            "segreduce": segreduce.segment_reduce_sorted(ids, rows, n_out,
                                                         perm=perm)}
    calls = {}
    for name, (kernel, lib, regs) in built.items():
        if kernel == "composite_bwd":
            calls[name] = (lambda lib=lib: _k3_call(lib, k3_args))
        else:
            calls[name] = (lambda lib=lib: _k4_call(lib, k4_args))
        got = calls[name]()
        torch.cuda.synchronize()
        if not torch.equal(got, want[kernel]):
            raise RuntimeError(f"{name}: not bitwise equal to the built kernel")
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
        regs = built[name][2] if name in built else None
        result["variants"][name] = dict(t, registers=regs)
        log(f"{name}: events {t['event_ms']}, back to back "
            f"{t['back_to_back_ms']} ms, registers {regs}")
    return result


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("backward_variants: no CUDA device; the variants are CUDA "
              "kernels", file=sys.stderr)
        return 2
    print(json.dumps(measure(torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
