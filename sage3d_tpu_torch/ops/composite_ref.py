"""Reference (oracle) compositor: exact per-pixel front-to-back alpha blending.

PyTorch counterpart of ``sage3d_tpu/ops/composite_ref.py`` and the port's own
ground truth: every pixel blends ALL Gaussians in global depth order —
O(H*W*N) — so it runs only on small scenes and resolutions. Differentiable
through autograd.
"""

from __future__ import annotations

from typing import Dict

import torch

from .projection import ProjectedGaussians, alpha_at


def composite_reference(
    proj: ProjectedGaussians,
    semantic_ids: torch.Tensor,
    width: int,
    height: int,
    pixel_chunk: int = 4096,
) -> Dict[str, torch.Tensor]:
    """Composite projected Gaussians over every pixel, exactly.

    Returns dict with:
      rgb:       (H, W, 3) accumulated color (premultiplied; add bg * T outside)
      depth_acc: (H, W) sum of w_i * depth_i
      alpha:     (H, W) sum of w_i (1 - final transmittance)
      trans:     (H, W) final transmittance T
      semantic:  (H, W) int32 argmax-weight semantic ID (-1 where nothing hit)
    """
    dev = proj.depths.device
    inf = torch.tensor(float("inf"), device=dev)
    # Global depth order, ties by index (stable); invisible Gaussians last.
    order = torch.argsort(torch.where(proj.visible, proj.depths, inf),
                          stable=True)
    proj_sorted = ProjectedGaussians(*(x[order] for x in proj))
    sem_sorted = semantic_ids[order]

    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    # Pixel centers at integer coords + 0.5 (classic 3DGS convention).
    px = (xs.reshape(-1) + 0.5).to(torch.float32)
    py = (ys.reshape(-1) + 0.5).to(torch.float32)

    parts = []
    for s in range(0, px.shape[0], pixel_chunk):
        alpha = alpha_at(proj_sorted, px[s:s + pixel_chunk],
                         py[s:s + pixel_chunk])                  # (P, N)
        one_minus = 1.0 - alpha
        trans_excl = torch.cat(
            [torch.ones_like(alpha[:, :1]),
             torch.cumprod(one_minus, dim=-1)[:, :-1]], dim=-1)
        w = alpha * trans_excl                                   # (P, N)
        rgb = w @ proj_sorted.colors
        depth_acc = w @ proj_sorted.depths
        acc = torch.sum(w, dim=-1)
        trans = torch.prod(one_minus, dim=-1)
        wmax, best = torch.max(w, dim=-1)
        sem = torch.where(wmax > 0.0, sem_sorted[best], -1)
        parts.append((rgb, depth_acc, acc, trans, sem))

    rgb, depth_acc, acc, trans, sem = (torch.cat(p, 0) for p in zip(*parts))
    return {
        "rgb": rgb.reshape(height, width, 3),
        "depth_acc": depth_acc.reshape(height, width),
        "alpha": acc.reshape(height, width),
        "trans": trans.reshape(height, width),
        "semantic": sem.reshape(height, width).to(torch.int32),
    }
