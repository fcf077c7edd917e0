"""Device time of the bench step (``bench.py``'s 1M-Gaussian box at
1920x1080, ``bench_loss`` and its gradient w.r.t. the opacity logits, the
``cuda`` backend) in each gradient-sort mode, from ``torch.profiler`` traces
with CUDA activity only. Card only; run as a file, so that ``--tree`` can
name another checkout whose package is measured (two trees in one run of
the card):

    python sage3d_tpu_torch/benchmarks/sort_mode_profile.py [--tree PATH]

It uses only ``bench.py``'s ``make_bench_scene``, ``bench_camera``,
``autotune`` and ``bench_loss``. Per mode, in turns over ``ROUNDS`` rounds:
the device's busy time per step over ``STEPS`` unsynchronized steps, the
kernels and copies per step, and K3's and K4's device time per step. Prints
one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROUNDS = 2
STEPS = 5
MODES = ("f32", "f16", "bf16")
KERNELS = {"K3": "composite_bwd_kernel", "K4": "segment_sum_kernel"}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tree = (Path(argv[argv.index("--tree") + 1]).resolve() if "--tree" in argv
            else Path(__file__).resolve().parents[2])
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("sort_mode_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import sage3d_tpu_torch
    from sage3d_tpu_torch.benchmarks import bench
    from sage3d_tpu_torch.benchmarks._util import log, nvidia_smi_line
    pkg = Path(sage3d_tpu_torch.__file__).resolve().parent
    if pkg.parent != tree:
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")

    dev = torch.device("cuda")
    scene = bench.make_bench_scene(device=dev)
    cam = bench.bench_camera(device=dev)
    budgets = bench.autotune(scene, cam)

    def step(mode):
        leaf = scene.opacity_logits.detach().requires_grad_()
        loss = bench.bench_loss(scene._replace(opacity_logits=leaf), cam,
                                "cuda", budgets, grad_sort=mode)
        torch.autograd.grad(loss, leaf)

    def us(e):
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    res = {m: {"busy_ms": [], "ops": [], "K3_ms": [], "K4_ms": []}
           for m in MODES}
    for _ in range(ROUNDS):
        for mode in MODES:
            step(mode)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(STEPS):
                    step(mode)
                torch.cuda.synchronize()
            evts = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            r = res[mode]
            r["busy_ms"].append(sum(us(e) for e in evts) / 1e3 / STEPS)
            r["ops"].append(sum(e.count for e in evts) / STEPS)
            for name, pat in KERNELS.items():
                r[f"{name}_ms"].append(sum(us(e) for e in evts
                                           if pat in e.key) / 1e3 / STEPS)
            log(f"{mode}: busy {r['busy_ms'][-1]:.4f} ms a step, "
                f"{r['ops'][-1]:.0f} kernels and copies, K3 "
                f"{r['K3_ms'][-1]:.4f} ms, K4 {r['K4_ms'][-1]:.4f} ms")
    print(json.dumps({"tree": str(tree), "device": nvidia_smi_line(),
                      "steps": STEPS, "modes": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
