"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so a
build takes seconds. It is compiled at first use into ``build/`` at the root
of the checkout, under a name that carries a hash of its source and flags, so
an edited source is never served from a stale library. ``build_all`` starts one
``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# -fmad=false: the kernels mirror f32 decisions of the JAX kernels (the
# emit cull margin, the power > 0 and alpha < 1/255 cutoffs), and K3 must
# replay K2's transmittance bit for bit; contracting a multiply and an add
# into one FMA would round differently from the plain PyTorch versions and
# can move a tile across the cull margin. Where a fused multiply-add is
# wanted (K3's gradient arithmetic) the source writes __fmaf_rn.
# No --use_fast_math: 1/x, sqrtf and expf stay IEEE (K5's fields and K6's
# clearances are the plain versions' bit for bit).
_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

# name -> (source file, C entry points with their ctypes argument types)
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
KERNELS = {
    "emit": ("emit.cu", {
        # table (column 11: each row's camera tile base), offsets, n,
        # n_live, tiles_x, mult, keys, gauss, counter, stream
        "sage3d_emit_tile_pairs": [_P, _P, _I, _L, _I, _I, _P, _P, _P, _P],
    }),
    "composite_fwd": ("composite_fwd.cu", {
        # attrs, pair_gauss, tile_start, tile_count, out, kend, ckpt (or
        # NULL), seg, n_tiles, tiles_x, cam_tiles, n_gauss, n_pairs, stream
        "sage3d_composite_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _P],
    }),
    "composite_bwd": ("composite_bwd.cu", {
        # attrs, pair_gauss, tile_start, tile_count, chunk0, allowed, fwd_out,
        # gout, ckpt (or NULL), work, slots, n_tiles, tiles_x, cam_tiles,
        # n_gauss, n_pairs, c_cap, seg, n_items, stream
        "sage3d_composite_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # int* registers
        "sage3d_composite_bwd_regs": [ctypes.POINTER(ctypes.c_int)],
        # int* blocks an SM holds
        "sage3d_composite_bwd_occupancy": [ctypes.POINTER(ctypes.c_int)],
    }),
    "composite_anatomy": ("composite_anatomy.cu", {
        # attrs, pair_gauss, tile_start, tile_count, out, n_tiles, tiles_x,
        # n_gauss, n_pairs, batch, early_term, do_exp, do_scan, do_blend,
        # do_argmax, stream
        "sage3d_composite_anatomy": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _P],
        # early_term, do_exp, do_scan, do_blend, do_argmax, int* registers
        "sage3d_composite_anatomy_regs": [_I, _I, _I, _I, _I,
                                          ctypes.POINTER(ctypes.c_int)],
    }),
    "segreduce": ("segreduce.cu", {
        # ids, perm (or NULL), rows, out, n_rows, n_src_rows, row_stride,
        # n_payload, n_out, stream
        "sage3d_segment_reduce": [_P, _P, _P, _P, _L, _L, _L, _I, _I, _P],
    }),
    "wavefront": ("wavefront.cu", {
        # src, dst, free, b, h, w, prev_flag (or NULL), flag, stream
        "sage3d_wavefront_relax": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    }),
    "capsule": ("capsule.cu", {
        # p0, p1, radius, b, means, quats, log_scales, logits, n, chunk,
        # aabb_min (or NULL), aabb_max, max_scale, margin, opacity_thresh,
        # sigma_cut, ids (or NULL), state, clear, idx, hits, visited, hit,
        # nearest, clipped (or NULL), stream
        "sage3d_capsule_query": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                 _P, _P, _P, _F, _F, _F, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P],
        # logits, out, n, stream
        "sage3d_capsule_sigmoid": [_P, _P, _I, _P],
    }),
    "project": ("project.cu", {
        # means, log_scales, quats, logits, sh, n, sh_row, sh_vec, degree,
        # position, cam_to_world, fx, fy, cx, cy, b, half_w, half_h, width,
        # height, near, far, means2d, conics, depths, radii, colors,
        # opacities, visible, extents, stream
        "sage3d_project": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                           _P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P],
        # K8: the same scene and camera arguments up to far; then for each
        # of the gradients of means2d, conics, depths, colors, opacities
        # its pointer (or NULL) and its camera and Gaussian strides in
        # floats; then the gradients of means, log_scales, quats, logits,
        # sh; stream
        "sage3d_project_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                               _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _F,
                               *[_P, _L, _L] * 5, _P, _P, _P, _P, _P, _P],
    }),
}

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_COMMON_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_COMMON_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log.decode(errors='replace')}")
    os.replace(tmp, out)


def build_all() -> dict:
    """Compile every kernel not built yet, one ``nvcc`` per source, all in
    parallel. Returns the wall seconds spent, per kernel (0 where cached)."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in KERNELS}
    seconds = {}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
        seconds[name] = time.perf_counter() - t0 if job is not None else 0.0
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    job = _start(name)
    if job is not None:
        _finish(name, job)
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in KERNELS[name][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def launch(fn, device: torch.device, *args) -> int:
    """Call the C entry point ``fn`` with ``args`` and then the current
    stream of ``device`` (a CUDA device with its index), as the raw
    ``cudaStream_t`` (``torch.cuda.current_stream`` builds a Python stream
    object, ~15 us of host time a launch). The device is made current only
    where it is not already: entering ``torch.cuda.device`` costs host time
    on every launch. Returns ``fn``'s ``cudaError_t``."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
