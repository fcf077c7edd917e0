"""The plain reference of scene fitting at a scale no single pass holds:
``train.fit_steps``'s mathematics (the squared error of one view against
its target over its pixels, its gradient, Adam with one rate a group) and
``render.render``'s, computed in blocks so that 40M Gaussians fit on one
card:

- the projection (``render.project``, unchanged) runs on blocks of
  ``block`` Gaussians: forward without a graph; for the backward, each
  block again under autograd, given its rows of the screen-space gradient
  (recomputation);
- compositing runs tile group by tile group as ``render.render`` does, on
  the blocks' screen-space Gaussians, and backpropagates each group into
  them;
- Adam steps each group in row blocks (the same elementwise arithmetic as
  ``train.Adam``).

A band (``band=(y0, rows)``) renders rows y0 .. y0 + rows of the frame:
the frame's projection with its means moved up by y0, each Gaussian
visible where it is in the frame and its extent box reaches the band.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import render as rr
from . import train as rt

BLOCK = 1 << 22              # Gaussians a projection block
KEYS = ("means2d", "conic", "opacity", "colour", "depth")


def project_blocks(fields: dict, cam: rr.Cam, dtype=torch.float32,
                   block: int = BLOCK) -> dict:
    """``render.project`` of every Gaussian, block by block, without a
    graph: the same dict of (N, ...) screen-space tensors."""
    n = fields["means"].shape[0]
    out = None
    with torch.no_grad():
        for a in range(0, n, block):
            part = rr.project({k: v[a:a + block] for k, v in fields.items()
                               if k != "semantic_ids"}, cam, dtype)
            if out is None:
                out = {k: v.new_empty((n,) + tuple(v.shape[1:]))
                       for k, v in part.items()}
            for k, v in part.items():
                out[k][a:a + v.shape[0]] = v
    return out


def to_band(proj: dict, y0: int, rows: int) -> dict:
    """The frame's projection as the band of ``rows`` image rows from row
    ``y0`` sees it (module docstring)."""
    m = proj["means2d"].clone()
    m[:, 1] -= y0
    ext_y = proj["ext"][:, 1]
    visible = proj["visible"] & (m[:, 1] + ext_y > 0) & (m[:, 1] - ext_y
                                                          < rows)
    return dict(proj, means2d=m, visible=visible)


def _chunk(carry, attrs, px, py):
    """``render._chunk``, its transmittance copied out of the chunk's
    running product, whose view would keep the whole (tiles, pixels, pairs)
    product alive."""
    (T, acc, best_w, best_id), alpha, before = rr._chunk(carry, attrs, px, py)
    return (T.clone(), acc, best_w, best_id), alpha, before


def composite(proj: dict, sem: torch.Tensor, width: int, height: int,
              far: float, dtype=torch.float32, group: int = 64,
              loss_targets: Optional[torch.Tensor] = None, loss_scale=1.0,
              count: bool = False, bg=(0.0, 0.0, 0.0)):
    """``render.render``'s compositing of screen-space Gaussians. Returns
    (the images as ``render.render`` gives them, with ``loss`` and
    ``counts`` where asked, and under ``loss_targets`` the gradient of the
    loss in each of ``KEYS`` (None otherwise)).

    Two departures from ``render.render``, for a frame whose tiles hold
    10^5 pairs: a tile stops once every pixel of it has T <= 1e-4 (as the
    3DGS compositors stop; ``render.render`` stops a group of tiles once all
    of them have), and each chunk walks the group's live tiles alone. Under
    ``loss_targets`` each tile group differentiates a compact copy of the
    Gaussians its pairs name, whose gradient is then added into the whole
    table's: indexing the whole table under autograd would spend a
    table-sized gradient on every chunk."""
    dev = proj["depth"].device
    grad = loss_targets is not None
    pairs = rr.pair_lists(proj, width, height)
    sem = sem.to(dtype)
    leaves = {k: proj[k].detach() for k in KEYS}
    screen = None
    if grad:
        screen = {k: torch.zeros_like(v) for k, v in leaves.items()}
        pos = torch.empty(sem.shape[0], dtype=torch.int64, device=dev)
    tx, ty = pairs.tiles_x, pairs.tiles_y
    n_tiles = tx * ty
    cnt = pairs.start[1:] - pairs.start[:-1]
    tile_order = torch.argsort(cnt, descending=True).cpu()
    lanes = torch.arange(rr.CHUNK, device=dev)
    pix = torch.arange(rr.NPIX, device=dev)
    out = torch.zeros((n_tiles, rr.NPIX, 7), dtype=torch.float32, device=dev)
    loss = 0.0
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    needed = []
    T_ = rr.TILE
    for g0 in range(0, n_tiles, group):
        tid_h = tile_order[g0:g0 + group]
        tid = tid_h.to(dev)
        G = tid.shape[0]
        px = ((tid % tx) * T_)[:, None, None].to(dtype) \
            + (pix % T_)[None, :, None].to(dtype) + 0.5
        py = ((tid // tx) * T_)[:, None, None].to(dtype) \
            + (pix // T_)[None, :, None].to(dtype) + 0.5
        start = pairs.start[tid]
        c_t = cnt[tid]
        local, lsem, look = leaves, sem, None
        if grad:    # the group's Gaussians, and where each lies among them
            total = int(c_t.sum())
            first = torch.repeat_interleave(start, c_t, output_size=total)
            skip = torch.repeat_interleave(torch.cumsum(c_t, 0) - c_t, c_t,
                                           output_size=total)
            uniq = torch.unique(pairs.gauss[
                first + torch.arange(total, device=dev) - skip])
            pos[uniq] = torch.arange(uniq.shape[0], device=dev)
            local = {k: v[uniq].requires_grad_(True)
                     for k, v in leaves.items()}
            lsem, look = sem[uniq], pos
        carry = (torch.ones((G, rr.NPIX), dtype=dtype, device=dev),
                 torch.zeros((G, rr.NPIX, 4), dtype=dtype, device=dev),
                 torch.zeros((G, rr.NPIX), dtype=dtype, device=dev),
                 torch.full((G, rr.NPIX), -1.0, dtype=dtype, device=dev))
        n_chunks = (c_t + rr.CHUNK - 1) // rr.CHUNK
        act = torch.nonzero(n_chunks > 0).squeeze(1)    # the live tiles
        k = 0
        with torch.set_grad_enabled(grad):
            while act.numel():
                a_cnt = c_t[act]
                valid = (k * rr.CHUNK + lanes)[None, :] < a_cnt[:, None]
                idx = torch.clamp(start[act][:, None] + k * rr.CHUNK + lanes,
                                  max=max(pairs.gauss.shape[0] - 1, 0))
                gi = pairs.gauss[idx] if pairs.gauss.numel() else idx
                li = gi if look is None else torch.where(valid, look[gi], 0)
                vm = valid.to(dtype)[..., None]
                attrs = torch.cat([
                    local["means2d"][li], local["conic"][li],
                    local["opacity"][li][..., None] * vm,
                    local["colour"][li], local["depth"][li][..., None],
                    torch.where(valid, lsem[li], -1.0)[..., None]], -1)
                sub = tuple(c[act] for c in carry)
                if grad:
                    new, alpha, before = checkpoint(
                        _chunk, sub, attrs, px[act], py[act],
                        use_reentrant=False)
                else:
                    new, alpha, before = _chunk(sub, attrs, px[act], py[act])
                carry = tuple(c.index_copy(0, act, n)
                              for c, n in zip(carry, new))
                if count:
                    live = (before > rr.TRANS_EPS) & (alpha > 0)
                    hits += live.sum()
                    need = (alpha > 0).any(1) & (before > rr.TRANS_EPS).any(1)
                    needed.append(gi[need])
                k += 1
                act = act[(new[0] > rr.TRANS_EPS).any(1)
                          & (k < n_chunks[act])]
            T, acc, _, best_id = carry
            rgb = acc[..., 0:3] + T[..., None] * torch.tensor(
                bg, dtype=dtype, device=dev)
            if grad:
                yy = (tid // tx)[:, None] * T_ + pix[None, :] // T_
                xx = (tid % tx)[:, None] * T_ + pix[None, :] % T_
                inside = (yy < height) & (xx < width)
                tgt = loss_targets[torch.clamp(yy, max=height - 1),
                                   torch.clamp(xx, max=width - 1)]
                part = (((rgb.float() - tgt) ** 2).sum(-1)
                        * inside).sum() * loss_scale
                if part.requires_grad:      # else no pair in the group
                    part.backward()
                    for k, v in local.items():
                        if v.grad is not None:
                            screen[k].index_add_(0, uniq, v.grad)
                loss += float(part.detach().double())
        out[tid] = torch.cat([
            rgb.detach(), (acc[..., 3] + T * far).detach()[..., None],
            (1.0 - T).detach()[..., None], best_id.detach()[..., None],
            T.detach()[..., None]], -1).float()
    img = out.reshape(ty, tx, T_, T_, 7).permute(0, 2, 1, 3, 4).reshape(
        ty * T_, tx * T_, 7)[:height, :width]
    res = {"rgb": img[..., 0:3], "depth": img[..., 3], "alpha": img[..., 4],
           "semantic": img[..., 5].round().long(), "trans": img[..., 6]}
    if grad:
        res["loss"] = loss
    if count:
        g = torch.cat(needed) if needed else torch.zeros(0, dtype=torch.long)
        res["counts"] = rr.Counts(int(g.numel()), int(hits),
                                  int(torch.unique(g).numel()), n_tiles)
    return res, screen


def project_backward(fields: dict, cam: rr.Cam, screen_grads: dict,
                     dtype=torch.float32, block: int = BLOCK) -> dict:
    """The gradient of the loss in each trainable group, from its
    screen-space gradient: each block projected again under autograd and
    backpropagated with its rows of ``screen_grads``."""
    n = fields["means"].shape[0]
    grads = {k: torch.zeros_like(fields[k], dtype=dtype) for k in rt.GROUPS}
    for a in range(0, n, block):
        blk = {k: fields[k][a:a + block].detach().to(dtype).requires_grad_(
            True) for k in rt.GROUPS}
        with torch.enable_grad():
            proj = rr.project(blk, cam, dtype)
            torch.autograd.backward(
                [proj[k] for k in KEYS],
                [screen_grads[k][a:a + block].to(proj[k].dtype)
                 for k in KEYS])
        for k in rt.GROUPS:
            if blk[k].grad is not None:
                grads[k][a:a + block] = blk[k].grad
    return grads


def render(fields: dict, cam: rr.Cam, dtype=torch.float32,
           block: int = BLOCK, band=None, **kw):
    """``render.render`` of one camera in blocks (module docstring), or of
    its band ``band=(y0, rows)``; ``kw`` as ``composite`` takes them. Under
    ``loss_targets`` the result also holds ``grads``, the gradient of the
    loss in each trainable group."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    try:
        proj = project_blocks(fields, cam, dtype, block)
        height = cam.height
        if band is not None:
            proj = to_band(proj, *band)
            height = band[1]
        res, screen = composite(proj, fields["semantic_ids"], cam.width,
                                height, cam.far, dtype, **kw)
        del proj
        if screen is not None:
            res["grads"] = project_backward(fields, cam, screen, dtype, block)
        return res
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class BlockAdam(rt.Adam):
    """``train.Adam``, each group stepped in row blocks (the same
    elementwise arithmetic, in less memory)."""

    def __init__(self, params: dict, lrs: dict, dtype=torch.float32,
                 block: int = BLOCK):
        super().__init__(params, lrs, dtype=dtype)
        self.block = block

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            for a in range(0, p.shape[0], self.block):
                sl = slice(a, a + self.block)
                m, v = self.m[k][sl], self.v[k][sl]
                g = grads[k][sl].to(m.dtype)
                m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
                upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
                p[sl].sub_((self.lrs[k] * upd).to(p.dtype))


def norm(t: torch.Tensor, block: int = BLOCK) -> float:
    """The 2-norm of ``t`` in float64, summed in row blocks."""
    return float(sum((t[a:a + block].double() ** 2).sum()
                     for a in range(0, t.shape[0], block)) ** 0.5)


def fit_steps(fields: dict, targets: list, cams: list, lrs: dict,
              dtype=torch.float32, fault=None, block: int = BLOCK) -> dict:
    """``train.fit_steps`` in blocks: ``len(cams)`` steps from ``fields``,
    one camera each, against ``targets`` (each camera's target render,
    (H, W, 3), made beforehand so that the target scene need not stay on
    the card). Returns the loss of each step, each group's gradient norm at
    the first step and each group's change after the last; ``fault`` as
    ``train.fit_steps`` plants it."""
    params = {k: fields[k].detach().to(dtype).clone() for k in rt.GROUPS}
    opt = BlockAdam(params, lrs, dtype=dtype, block=block)
    losses, grad_norms = [], None
    for cam, target in zip(cams, targets):
        if fault == "half":
            cam = cam._replace(height=cam.height // 2)
            target = target[:cam.height].contiguous()
        elif fault == "altered":
            target = target.clone()
            target[..., 0] -= 0.1
        live = dict(fields, **params)
        n_px = cam.width * cam.height * 3
        out = render(live, cam, dtype, block, loss_targets=target,
                     loss_scale=1.0 / n_px)
        losses.append(out["loss"])
        grads = out.pop("grads")
        del out
        if grad_norms is None:
            grad_norms = {k: norm(g, block) for k, g in grads.items()}
        opt.step(grads)
        del grads
    for k in rt.GROUPS:             # the change, in place of the params
        for a in range(0, params[k].shape[0], block):
            params[k][a:a + block] -= fields[k][a:a + block].to(dtype)
    change = {k: norm(params[k], block) for k in rt.GROUPS}
    return {"loss": losses, "grad": grad_norms, "change": change}
