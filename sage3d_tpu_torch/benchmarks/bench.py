"""Headline benchmark of the port: fwd+bwd rendering throughput at 1920x1080
with 1M Gaussians, on one CUDA card.

    python -m sage3d_tpu_torch.benchmarks.bench

The counterpart of the JAX package's ``bench.py``, on the port's backends:
``cuda`` (the hand-written kernels K1-K4; the JAX ``pallas``) and ``torch``
(plain PyTorch with autograd; the JAX ``xla``). One step is the loss of
``bench_loss`` and its gradient w.r.t. the opacity logits. Budgets come from
``autotune`` (``autotune_all(pair_margin=1.05, grad_margin=1.2)``), so the
measured run drops no pair; the parity block reports ``overflow_pairs``.

Measured: the ``cuda`` step in the three gradient-sort modes (``f32``, the
default, ``f16`` and ``bf16``), the ``torch`` step (2 chained steps a loop),
the parity of ``cuda`` against ``torch`` at 800x800 and 1920x1080 (forward
images and gradients in every sort mode, with ``bench.py``'s keys,
tolerances and ``allclose`` rule), and the SH degree 3 scene with gradients
to all 16 bands. A step time is the least, over 3 loops of ``iters`` chained
steps timed with CUDA events, of the loop's time per step, after one
warm-up loop; the median of the 3 is printed beside it.

Prints the full result as one JSON line, then a compact line of the
headline. Exits non-zero when there is no CUDA device.

The scene has ``bench.py``'s distributions (``make_bench_scene``), drawn
from a seeded ``torch.Generator``: the same distributions, other draws than
the JAX package's.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..renderer.camera import make_camera
from ..renderer.render import autotune_all, budget_kwargs, render
from ..renderer.scene import SH_C0, GaussianScene, resolve_device
from ._util import log, nvidia_smi_line, timed_best

WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 1_000_000
CAMERA = dict(position=[0.0, -6.0, 1.5], forward=[0.0, 1.0, -0.05],
              focal_mm=14.0)
SORT_MODES = ("f32", "f16", "bf16")
PARITY_PARAMS = ("opacity_logits", "means")


def bench_camera(width: int = WIDTH, height: int = HEIGHT, device=None):
    """``bench.py``'s camera: 1.5 m up, 6 m in front of the box, 14 mm."""
    return make_camera(width=width, height=height, device=device, **CAMERA)


def make_bench_scene(n: int = N_GAUSS, seed: int = 0, sh_degree: int = 0,
                     device=None) -> GaussianScene:
    """``bench.py``'s synthetic scene, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: means uniform in
    [-5,5]x[-4,4]x[0,3], scales uniform in [0.01, 0.05], normalised normal
    quaternions, opacities uniform in [0.2, 0.9] (as logits), SH DC from a
    uniform colour, higher bands 0.1 x normal, semantic ids in [0, 200).
    The higher bands are drawn last, so the ``sh_degree=3`` scene of a seed
    is its degree 0 twin with bands added."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    means = uniform((n, 3), torch.tensor([-5.0, -4.0, 0.0], device=dev),
                    torch.tensor([5.0, 4.0, 3.0], device=dev))
    scales = uniform((n, 3), 0.01, 0.05)
    q = torch.randn((n, 4), generator=gen, device=dev)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    op = uniform((n,), 0.2, 0.9)
    col = torch.rand((n, 3), generator=gen, device=dev)
    sem = torch.randint(0, 200, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    k = (sh_degree + 1) ** 2
    sh = torch.zeros((n, k, 3), device=dev)
    sh[:, 0, :] = (col - 0.5) / SH_C0
    if k > 1:
        sh[:, 1:, :] = 0.1 * torch.randn((n, k - 1, 3), generator=gen,
                                         device=dev)
    return GaussianScene(means=means, log_scales=torch.log(scales), quats=q,
                         opacity_logits=torch.log(op / (1 - op)), sh=sh,
                         semantic_ids=sem)


def autotune(scene: GaussianScene, camera) -> dict:
    """Overflow-free budgets for the fixed (scene, camera): the pair capacity
    at the measured post-cull count + 5%, the gradient buffer at the
    forward's measured chunk count + 20% (``bench.py``'s margins)."""
    return autotune_all(scene, camera, pair_margin=1.05, grad_margin=1.2)


def bench_loss(scene: GaussianScene, camera, backend: str, budgets: dict,
               grad_sort=None) -> torch.Tensor:
    """``bench.py``'s loss: sum(rgb^2) 1e-9 + sum(depth_acc) 1e-12 +
    sum(alpha) 1e-12."""
    out = render(scene, camera, backend=backend, grad_sort=grad_sort,
                 **budget_kwargs(budgets))
    return (torch.sum(out["rgb"] ** 2) * 1e-9
            + torch.sum(out["depth_acc"]) * 1e-12
            + torch.sum(out["alpha"]) * 1e-12)


def sh3_loss(scene: GaussianScene, camera, budgets: dict) -> torch.Tensor:
    """The SH3 scene's loss: sum(rgb^2) 1e-9 through the ``cuda`` backend."""
    out = render(scene, camera, backend="cuda", **budget_kwargs(budgets))
    return torch.sum(out["rgb"] ** 2) * 1e-9


def bench_backend(scene: GaussianScene, camera, backend: str, budgets: dict,
                  iters: int = 12, grad_sort=None):
    """One step: ``bench_loss`` and its gradient w.r.t. the opacity logits,
    whose first entry feeds the next step. Returns (Mpix/s at the least step
    time, least s/step, median s/step) over 3 timed loops of ``iters``
    chained steps after a warm-up loop."""
    def step(c):
        leaf = scene.opacity_logits.detach().requires_grad_()
        loss = bench_loss(scene._replace(opacity_logits=leaf + c * 0), camera,
                          backend, budgets, grad_sort)
        return torch.autograd.grad(loss, leaf)[0][0]

    best, med = (ms / 1e3 for ms in timed_best(step, iters, scene.device))
    return camera.width * camera.height / best / 1e6, best, med


def bench_sh3(scene: GaussianScene, camera, budgets: dict, iters: int = 12):
    """As ``bench_backend`` for ``sh3_loss``, with gradients w.r.t. the SH
    coefficients (all bands) and the opacity logits."""
    def step(c):
        sh = scene.sh.detach().requires_grad_()
        op = scene.opacity_logits.detach().requires_grad_()
        loss = sh3_loss(scene._replace(sh=sh, opacity_logits=op + c * 0),
                        camera, budgets)
        g_sh, g_op = torch.autograd.grad(loss, (sh, op))
        return g_op[0] + torch.sum(g_sh[0]) * 1e-6

    best, med = (ms / 1e3 for ms in timed_best(step, iters, scene.device))
    return camera.width * camera.height / best / 1e6, best, med


def _diff_stats(a: np.ndarray, b: np.ndarray) -> dict:
    denom = max(float(np.abs(b).max()), 1e-12)
    return {"max_abs": float(np.abs(a - b).max()),
            "max_rel": float(np.abs(a - b).max() / denom)}


def parity_check(scene: GaussianScene, camera, budgets: dict,
                 grad_scale: float = 1e-6) -> dict:
    """``cuda`` against ``torch`` on one frame: the forward images, and the
    gradients w.r.t. the opacity logits and the means in every sort mode
    against the ``torch`` gradient. Keys, tolerances and the ``allclose``
    rule are ``bench.py``'s, whose ``pallas`` is ``cuda`` here and whose
    ``xla`` is ``torch``."""
    kw = budget_kwargs(budgets)
    outs = {}
    with torch.no_grad():
        for name, backend in (("pallas", "cuda"), ("xla", "torch")):
            o = render(scene, camera, backend=backend, **kw)
            outs[name] = {k: o[k].cpu().numpy()
                          for k in ("rgb", "depth_acc", "alpha", "trans")}
            outs[name]["overflow"] = int(o["overflow"])

    def grads(backend, mode):
        params = {k: getattr(scene, k).detach().clone().requires_grad_()
                  for k in PARITY_PARAMS}
        o = render(scene._replace(**params), camera, backend=backend,
                   grad_sort=mode, **kw)
        ((torch.sum(o["rgb"] ** 2) + 0.05 * torch.sum(o["depth_acc"])
          + 0.02 * torch.sum(o["alpha"])) * grad_scale).backward()
        return {k: p.grad.cpu().numpy() for k, p in params.items()}

    gx = grads("torch", "f32")
    g = {mode: grads("cuda", mode) for mode in SORT_MODES}
    report = {"overflow_pallas": outs["pallas"]["overflow"],
              "overflow_xla": outs["xla"]["overflow"]}
    for k in ("rgb", "depth_acc", "alpha", "trans"):
        report[f"fwd_{k}"] = _diff_stats(outs["pallas"][k], outs["xla"][k])
    for k in PARITY_PARAMS:
        report[f"grad_{k}"] = _diff_stats(g["f32"][k], gx[k])   # the default
        for mode in ("f16", "bf16"):
            report[f"grad_{k}_{mode}sort"] = _diff_stats(g[mode][k], gx[k])
    # bench.py's rule: images within 1e-3 relative, the transmittance within
    # 2 x TRANS_EPS absolute (the cuda backend stops a tile at T <= 1e-4, the
    # torch backend does not), gradients within 5e-4 (f32 sort), 2e-3
    # (scaled f16: one 2^-11 rounding) and 5e-3 (bf16: one 2^-8 rounding) of
    # the torch gradient's max.
    report["allclose"] = bool(
        all(report[f"fwd_{k}"]["max_rel"] < 1e-3
            for k in ("rgb", "depth_acc", "alpha"))
        and report["fwd_trans"]["max_abs"] < 2e-4
        and all(report[f"grad_{k}"]["max_rel"] < 5e-4 for k in PARITY_PARAMS)
        and all(report[f"grad_{k}_f16sort"]["max_rel"] < 2e-3
                for k in PARITY_PARAMS)
        and all(report[f"grad_{k}_bf16sort"]["max_rel"] < 5e-3
                for k in PARITY_PARAMS))
    return report


def run(device=None) -> dict:
    """Every measurement of the benchmark on one card; returns the full
    result. Logs each stage as it ends."""
    dev = resolve_device(device)
    card = nvidia_smi_line()
    scene = make_bench_scene(device=dev)
    camera = bench_camera(device=dev)
    budgets = autotune(scene, camera)
    log(f"autotuned budgets: {budgets}")

    steps = {}
    for mode in SORT_MODES:
        steps[mode] = bench_backend(scene, camera, "cuda", budgets,
                                    grad_sort=mode)
        mpix, best, med = steps[mode]
        log(f"cuda, {mode} gradient sort [{card}]: {best * 1e3:.3f} ms/step "
            f"(median {med * 1e3:.3f}) = {mpix:.2f} Mpix/s")
    # The torch baseline walks every chunk of every tile with no early stop
    # and recomputes each chunk in its backward: 2 chained steps a loop.
    torch_mpix, torch_dt, torch_med = bench_backend(scene, camera, "torch",
                                                    budgets, iters=2)
    log(f"torch [{card}]: {torch_dt * 1e3:.3f} ms/step (median "
        f"{torch_med * 1e3:.3f}) = {torch_mpix:.2f} Mpix/s")

    cam800 = bench_camera(800, 800, device=dev)
    budgets800 = autotune(scene, cam800)
    log(f"800x800 budgets: {budgets800}")
    parity_800 = parity_check(scene, cam800, budgets800)
    log(f"parity 800x800: {parity_800}")
    parity_1080 = parity_check(scene, camera, budgets)
    log(f"parity 1080p: {parity_1080}")

    scene_sh3 = make_bench_scene(sh_degree=3, device=dev)
    budgets_sh3 = autotune(scene_sh3, camera)
    sh3_mpix, sh3_dt, sh3_med = bench_sh3(scene_sh3, camera, budgets_sh3)
    log(f"cuda SH3, grads to all 16 bands [{card}]: {sh3_dt * 1e3:.3f} "
        f"ms/step (median {sh3_med * 1e3:.3f}) = {sh3_mpix:.2f} Mpix/s")

    cuda_mpix, cuda_dt, cuda_med = steps["f32"]
    detail = {
        "cuda_step_s": cuda_dt,
        "cuda_step_median_s": cuda_med,
        "grad_sort": "exact f32 (the default); f16 scaled and bf16 options",
    }
    for mode in ("f16", "bf16"):
        mpix, best, med = steps[mode]
        detail[f"cuda_{mode}_sort_step_s"] = best
        detail[f"cuda_{mode}_sort_step_median_s"] = med
        detail[f"cuda_{mode}_sort_mpix_per_s"] = mpix
    detail.update({
        "torch_step_s": torch_dt,
        "torch_step_median_s": torch_med,
        "torch_mpix_per_s": torch_mpix,
        "overflow_pairs": parity_1080["overflow_pallas"],
        "autotuned_budgets": budgets,
        "sh3_step_s": sh3_dt,
        "sh3_step_median_s": sh3_med,
        "sh3_mpix_per_s": sh3_mpix,
        "sh3_budgets": budgets_sh3,
        "n_gaussians": scene.num_gaussians,
        "device": card,
        "PARITY": {"800x800": parity_800, "1080p": parity_1080},
    })
    return {"metric": "mpix_per_s_fwd_bwd_1080p_1m_gauss",
            "value": cuda_mpix, "unit": "Mpix/s",
            "vs_baseline": cuda_mpix / max(torch_mpix, 1e-9),
            "detail": detail}


def compact(result: dict) -> dict:
    """The headline of a ``run`` result, for the last line."""
    out = {k: result[k] for k in ("metric", "value", "unit", "vs_baseline")}
    d = result["detail"]
    out["detail"] = {k: d[k] for k in (
        "cuda_step_s", "overflow_pairs", "n_gaussians", "device",
        "cuda_f16_sort_mpix_per_s", "cuda_bf16_sort_mpix_per_s",
        "sh3_mpix_per_s")}
    out["detail"]["parity_allclose_800_1080"] = [
        d["PARITY"]["800x800"]["allclose"], d["PARITY"]["1080p"]["allclose"]]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device; this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    result = run()
    print(json.dumps(result))
    print(json.dumps(compact(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
