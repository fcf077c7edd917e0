"""Anatomy of the forward compositor K2 at the 1920x1080, 1M-Gaussian bench
frame: K2 with one cost block stubbed out at a time.

    python -m sage3d_tpu_torch.benchmarks.kernel_anatomy [--tiny] [--device cpu]

The counterpart of the JAX package's ``benchmarks/kernel_anatomy.py``. The
probe kernel (``csrc/composite_anatomy.cu``) is K2 with five switches:

  early_term  stop a tile once every pixel has T <= 1e-4 (K2) or walk all
              of its chunks;
  do_exp      K2's alpha, or a quadratic stub with no exp and no cutoffs;
  do_scan     the per-pair transmittance product, or T at the chunk's start
              for every pair and one update by the chunk's largest alpha;
  do_blend    the five weighted sums, or 1e-9 x the first pair's weight;
  do_argmax   the semantic argmax, or none.

A variant with a block stubbed out computes something else by design: it
exists to be timed. Every variant but the production one walks every chunk
(early stop off), so they all do the same chunk count and their differences
from the full kernel with early stop off are the cost of each block.

``make_variant`` returns a variant as a callable on K2's inputs; it launches
the probe kernel on CUDA tensors and runs ``variant_plain``, the plain
PyTorch version, on CPU tensors. ``main`` times the six variants and the
production variant over a batch of 4 copies, with each variant's registers
per thread, and logs the deltas. ``--tiny``: 20k Gaussians at 256x256.
``--device cpu``: the plain versions on the CPU, host clock (a check of the
script, not a measurement of the card).
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from ..ops import _build
from ..ops import composite_cuda as cc
from ..ops.binning import EMIT_BUDGET_KEYS, bin_gaussians
from ..ops.projection import project_gaussians
from ..renderer.render import budget_kwargs
from ..renderer.scene import resolve_device
from ._util import log, nvidia_smi_line, timed_best
from .bench import N_GAUSS, WIDTH, HEIGHT, autotune, bench_camera, make_bench_scene

FLAGS = ("early_term", "do_exp", "do_scan", "do_blend", "do_argmax")
BASE = dict(early_term=False, do_exp=True, do_scan=True, do_blend=True,
            do_argmax=True)
# The variants the probe times, in order; the kernel is built for these only.
VARIANTS = {
    "full kernel, early stop on (production)": {**BASE, "early_term": True},
    "full kernel, early stop off (anatomy baseline)": BASE,
    "no semantic-argmax block": {**BASE, "do_argmax": False},
    "no transmittance scan": {**BASE, "do_scan": False},
    "no blend sums": {**BASE, "do_blend": False},
    "no exp (quadratic stub)": {**BASE, "do_exp": False},
}
PRODUCTION, BASELINE = list(VARIANTS)[:2]
DELTAS = {   # delta name -> the variant whose time the baseline's exceeds
    "early stop saves": PRODUCTION,
    "argmax block": "no semantic-argmax block",
    "scan block": "no transmittance scan",
    "blend sums": "no blend sums",
    "alpha exp etc": "no exp (quadratic stub)",
}
STUB_ALPHA_SCALE, STUB_ALPHA_MAX = 1e-3, 0.5   # the no-exp stub's alpha
STUB_BLEND_SCALE = 1e-9                        # the no-blend stub's weight


def _flag_tuple(flags: dict) -> tuple:
    if set(flags) != set(FLAGS):
        raise ValueError(f"the flags are {FLAGS}, got {sorted(flags)}")
    key = tuple(bool(flags[f]) for f in FLAGS)
    if key not in {tuple(v[f] for f in FLAGS) for v in VARIANTS.values()}:
        raise ValueError(f"no probe variant for the flags {flags}")
    return key


def variant_plain(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  tiles_x: int, *, early_term: bool, do_exp: bool,
                  do_scan: bool, do_blend: bool, do_argmax: bool,
                  tile_batch: int = 128) -> torch.Tensor:
    """Plain PyTorch version of the probe: ``composite_fwd_plain`` with the
    five switches (module docstring), vectorized over tiles in batches.
    With every switch on it is ``composite_fwd_plain`` op for op. Returns
    (T, NCH, NPIX) float32: rgb, depth, alpha, T, best weight, best id."""
    dev = attrs.device
    n_tiles = tile_start.shape[0]
    px, py = cc._pixel_centers(dev)
    outs = []
    for t0 in range(0, n_tiles, tile_batch):
        tid = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        b = tid.shape[0]
        start = tile_start[tid].long()
        count = tile_count[tid].long()
        n_chunks = (count + cc.CHUNK - 1) // cc.CHUNK
        ox = ((tid % tiles_x) * cc.TILE_W).to(torch.float32)[:, None, None]
        oy = ((tid // tiles_x) * cc.TILE_H).to(torch.float32)[:, None, None]
        trans = torch.ones((b, cc.NPIX), device=dev)
        acc = torch.zeros((b, 5, cc.NPIX), device=dev)
        best_w = torch.zeros((b, cc.NPIX), device=dev)
        best_id = torch.full((b, cc.NPIX), -1.0, device=dev)
        active = torch.ones((b,), dtype=torch.bool, device=dev)
        for k in range(int(n_chunks.max()) if b else 0):
            active = active & (k < n_chunks)
            if early_term:
                active = active & (trans.amax(-1) > cc.TRANS_EPS)
            if not bool(active.any()):
                break
            co, valid, alpha, _ = cc._plain_chunk(attrs, pair_gauss, start,
                                                  count, k, ox, oy, px, py)
            if not do_exp:
                alpha = torch.clamp(torch.abs(
                    co[..., 5:6] * (co[..., 0:1] * px + co[..., 2:3] * py
                                    + co[..., 1:2])) * STUB_ALPHA_SCALE,
                    max=STUB_ALPHA_MAX)
                alpha = torch.where(valid[..., None], alpha, 0.0)
            if do_scan:
                # T before each pair: a running product seeded with the
                # tile's transmittance, in the kernel's left-to-right order.
                t_run = torch.cumprod(
                    torch.cat([trans[:, None, :], 1.0 - alpha], 1), 1)
                w = alpha * t_run[:, :-1]
                new_trans = t_run[:, -1]
            else:
                w = alpha * trans[:, None, :]
                new_trans = trans * (1.0 - alpha.amax(1))
            if do_blend:
                acc_new = acc + torch.stack(
                    [(w * co[..., ch:ch + 1]).sum(1) for ch in (6, 7, 8, 9)]
                    + [w.sum(1)], dim=1)
            else:
                acc_new = acc + (w[:, 0] * STUB_BLEND_SCALE)[:, None, :]
            act = active[:, None]
            acc = torch.where(act[..., None], acc_new, acc)
            if do_argmax:
                cmax, first = torch.max(w, dim=1)     # first max in depth order
                sel = torch.gather(co[..., 10], 1, first)
                better = cmax > best_w
                best_id = torch.where(act & better, sel, best_id)
                best_w = torch.where(act & better, cmax, best_w)
            trans = torch.where(act, new_trans, trans)
        outs.append(torch.cat([acc, trans[:, None], best_w[:, None],
                               best_id[:, None]], 1))
    if not outs:
        return torch.zeros((0, cc.NCH, cc.NPIX), device=dev)
    return torch.cat(outs)


def composite_anatomy(attrs: torch.Tensor, pair_gauss: torch.Tensor,
                      tile_start: torch.Tensor, tile_count: torch.Tensor,
                      tiles_x: int, **flags) -> torch.Tensor:
    """The probe wrapper: (T, NCH, NPIX) float32 for K2's inputs, or
    (b, T, NCH, NPIX) for b stacked copies of them ((b, N, NFEAT) attrs,
    (b, P) pair_gauss, (b, T) tile ranges). ``flags``: the five switches,
    one of the sets of ``VARIANTS``. A CPU tensor takes ``variant_plain``; a
    CUDA tensor launches ``csrc/composite_anatomy.cu``, all copies in one
    launch."""
    key = _flag_tuple(flags)
    batched = attrs.dim() == 3
    want = 1 if batched else 0
    tensors = (attrs, pair_gauss, tile_start, tile_count)
    if (attrs.dim() - want != 2 or attrs.shape[-1] != cc.NFEAT
            or attrs.dtype != torch.float32):
        raise ValueError(f"attrs must be ([b,] N, {cc.NFEAT}) float32")
    if any(x.dtype != torch.int32 or x.dim() != 1 + want for x in tensors[1:]):
        raise ValueError("pair_gauss, tile_start and tile_count must be int32 "
                         "with the batch dimension of attrs")
    if tile_start.shape != tile_count.shape:
        raise ValueError("tile_start and tile_count differ in shape")
    if batched and len({x.shape[0] for x in tensors}) != 1:
        raise ValueError("the copies differ in number")
    if any(x.device != attrs.device for x in tensors):
        raise ValueError("composite_anatomy: inputs on different devices")
    if attrs.device.type == "cpu":
        if batched:
            return torch.stack([variant_plain(*(x[i] for x in tensors),
                                              tiles_x, **flags)
                                for i in range(attrs.shape[0])])
        return variant_plain(*tensors, tiles_x, **flags)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_anatomy: unsupported device {attrs.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("composite_anatomy: inputs must be contiguous")
    b = attrs.shape[0] if batched else 1
    n_tiles = tile_start.shape[-1]
    if max(attrs.numel(), pair_gauss.numel(), b * n_tiles) >= 2**31:
        raise ValueError("composite_anatomy: sizes must fit int32")
    out = torch.empty((b, n_tiles, cc.NCH, cc.NPIX), dtype=torch.float32,
                      device=attrs.device)
    err = _build.launch(
        _build.load("composite_anatomy").sage3d_composite_anatomy,
        attrs.device, attrs.data_ptr(), pair_gauss.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), out.data_ptr(), n_tiles,
        tiles_x, attrs.shape[-2], pair_gauss.shape[-1], b,
        *(int(f) for f in key))
    _build.check(err, "composite_anatomy")
    composite_anatomy.launches += 1
    return out if batched else out[0]


composite_anatomy.launches = 0


def variant_registers(**flags) -> int:
    """Registers per thread of a variant's kernel (cudaFuncGetAttributes)."""
    key = _flag_tuple(flags)
    regs = ctypes.c_int(0)
    _build.check(_build.load("composite_anatomy").sage3d_composite_anatomy_regs(
        *(int(f) for f in key), ctypes.byref(regs)), "composite_anatomy_regs")
    return regs.value


def make_variant(n_tiles: int, tiles_x: int, *, early_term: bool,
                 do_exp: bool, do_scan: bool, do_blend: bool,
                 do_argmax: bool, batch: int = 1):
    """One variant as ``call(attrs, pair_gauss, tile_start, tile_count)`` on
    K2's inputs for ``n_tiles`` tiles; with ``batch`` > 1 the inputs carry a
    leading dimension of ``batch`` copies and so does the output."""
    flags = dict(early_term=early_term, do_exp=do_exp, do_scan=do_scan,
                 do_blend=do_blend, do_argmax=do_argmax)
    _flag_tuple(flags)

    def call(attrs, pair_gauss, tile_start, tile_count):
        lead = tuple(tile_start.shape[:-1])
        if lead != ((batch,) if batch > 1 else ()) \
                or tile_start.shape[-1] != n_tiles:
            raise ValueError(f"this variant takes {n_tiles} tiles in "
                             f"{batch} cop{'ies' if batch > 1 else 'y'}")
        return composite_anatomy(attrs, pair_gauss, tile_start, tile_count,
                                 tiles_x, **flags)

    return call


def prepare(scene, camera, budgets: dict) -> dict:
    """K2's inputs for one frame, as the ``cuda`` backend builds them: the
    attribute table, the pair list trimmed to ``pair_capacity``, the tile
    ranges with counts clipped to ``tile_capacity``."""
    bk = budget_kwargs(budgets)
    with torch.no_grad():
        proj = project_gaussians(scene, camera)
        bins = bin_gaussians(proj, camera.width, camera.height,
                             **{k: bk[k] for k in EMIT_BUDGET_KEYS})
    pg, start, count, _ = cc.trim_to_capacity(bins, bk["pair_capacity"])
    return {"attrs": cc.attribute_table(proj, scene.semantic_ids),
            "pair_gauss": pg, "tile_start": start,
            "tile_count": torch.clamp(count, max=bk["tile_capacity"]),
            "tiles_x": bins.tiles_x, "n_tiles": bins.tiles_x * bins.tiles_y}


def measure(inputs: dict, iters: int = 6, batch: int = 4) -> dict:
    """Times every variant (least ms per call over 3 loops of ``iters``
    chained calls, after a warm-up loop) and the production variant over
    ``batch`` copies; logs each with its registers per thread, the batch
    ratio and the deltas. Returns them as a dict."""
    args = (inputs["attrs"], inputs["pair_gauss"], inputs["tile_start"],
            inputs["tile_count"])
    dev = args[0].device
    on_card = dev.type == "cuda"
    where = f"[{nvidia_smi_line()}]" if on_card else \
        "[cpu: plain versions, host clock]"

    def best_ms(call, call_args):
        def fn(c):
            return call(*call_args)[..., 0:5, ::128].sum() * 1e-9
        return timed_best(fn, iters, dev)[0]

    result = {"variants": {}}
    for name, flags in VARIANTS.items():
        call = make_variant(inputs["n_tiles"], inputs["tiles_x"], **flags)
        ms = best_ms(call, args)
        regs = variant_registers(**flags) if on_card else None
        result["variants"][name] = {"ms": ms, "registers": regs}
        log(f"{name} {where}: {ms:.3f} ms"
            + (f", {regs} registers per thread" if on_card else ""))
    copies = [x[None].expand(batch, *x.shape).contiguous() for x in args]
    call = make_variant(inputs["n_tiles"], inputs["tiles_x"], batch=batch,
                        **VARIANTS[PRODUCTION])
    t_b = best_ms(call, copies)
    t_prod = result["variants"][PRODUCTION]["ms"]
    result["batch"] = {"copies": batch, "ms": t_b,
                       "ratio_to_single": t_b / (batch * t_prod)}
    log(f"{PRODUCTION}, batch of {batch} copies {where}: {t_b:.3f} ms, "
        f"{t_b / (batch * t_prod):.3f} of {batch} single launches")
    t_base = result["variants"][BASELINE]["ms"]
    result["deltas_ms"] = {d: t_base - result["variants"][v]["ms"]
                           for d, v in DELTAS.items()}
    log(f"--- anatomy {where}: deltas against the early-stop-off baseline "
        f"({t_base:.3f} ms) ---")
    for d, ms in result["deltas_ms"].items():
        log(f"{d} {where}: {ms:.3f} ms")
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tiny = "--tiny" in argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else None
    if device is None and not torch.cuda.is_available():
        print("kernel_anatomy: no CUDA device; pass --device cpu for the "
              "plain versions", file=sys.stderr)
        return 2
    dev = resolve_device(device)
    scene = make_bench_scene(20_000 if tiny else N_GAUSS, device=dev)
    camera = bench_camera(256 if tiny else WIDTH, 256 if tiny else HEIGHT,
                          device=dev)
    budgets = autotune(scene, camera)
    log(f"budgets: {budgets}")
    result = measure(prepare(scene, camera, budgets))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
