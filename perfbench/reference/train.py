"""The plain reference of a scene-fitting step: the mean squared error of
one rendered view against its target, its gradient by autograd through the
reference renderer, and Adam (Kingma and Ba; b1 0.9, b2 0.999, eps 1e-8)
with one learning rate per parameter group, as the 3DGS recipe sets them.
Imports nothing of the program."""

from __future__ import annotations

import math

import torch

from . import render as rr

GROUPS = ("means", "log_scales", "quats", "opacity_logits", "sh")


class Adam:
    """Adam over a dict of leaf tensors, one rate a group."""

    def __init__(self, params: dict, lrs: dict, dtype=torch.float32,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lrs = params, lrs
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k].to(self.m[k].dtype)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            p.sub_((self.lrs[k] * upd).to(p.dtype))


FAULTS = ("half", "altered")


def fit_steps(fields: dict, target_fields: dict, cams: list, lrs: dict,
              dtype=torch.float32, fault=None) -> dict:
    """``len(cams)`` steps from ``fields``, one camera each, against the
    target scene's renders of the same cameras. Returns the loss of each
    step, each group's gradient norm at the first step, and each group's
    change after the last (all float64 numbers).

    ``fault`` plants one in the steps, to read what the check sees of it:
    ``"half"`` takes the error over the top half of the rows alone, its
    mean over those (half of the batch left out); ``"altered"`` offsets the
    render's red channel by 0.1 where it is made (as the target's by
    -0.1: the error is the same)."""
    params = {k: fields[k].detach().to(dtype).clone().requires_grad_(True)
              for k in GROUPS}
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(params, lrs, dtype=dtype)
    losses, grad_norms = [], None
    for cam in cams:
        with torch.no_grad():
            target = rr.render(target_fields, cam, dtype=dtype)["rgb"].float()
        if fault == "half":
            cam = cam._replace(height=cam.height // 2)
            target = target[:cam.height].contiguous()
        elif fault == "altered":
            target = target.clone()
            target[..., 0] -= 0.1
        for p in params.values():
            p.grad = None
        live = dict(fields, **params)
        n_px = cam.width * cam.height * 3
        out = rr.render(live, cam, dtype=dtype, loss_targets=target,
                        loss_scale=1.0 / n_px)
        losses.append(out["loss"])
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(g.double()))
                          for k, g in grads.items()}
        opt.step(grads)
        del out, target
    change = {k: float(torch.linalg.vector_norm(
        (params[k].detach() - start[k]).double())) for k in GROUPS}
    return {"loss": losses, "grad": grad_norms, "change": change}


def worst_leaf_gap(prog: dict, ref: dict, floor_share: float = 1e-3,
                   ref_grad: dict = None) -> float:
    """The largest |prog norm - ref norm| over the groups, each against the
    larger of its reference norm and the median group's. Groups whose
    reference gradient is under ``floor_share`` of the median group's
    (moved by round-off alone under Adam) are left out."""
    keys = list(ref)
    if ref_grad is not None:
        med_g = sorted(ref_grad.values())[len(ref_grad) // 2]
        keys = [k for k in keys if ref_grad[k] >= floor_share * med_g]
    med = sorted(ref[k] for k in ref)[len(ref) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def loss_gap(prog: list, ref: list) -> float:
    """The largest relative gap of the steps' losses."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")
