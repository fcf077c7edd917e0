"""The plain reference renderer: 3D Gaussian splatting as Kerbl et al.
(2023) define it, in plain PyTorch.

Every pixel blends, front to back in depth order (ties by index), the
Gaussians whose footprint covers it: alpha = opacity * exp(power), cut to
0.99 and zeroed under 1/255; colour, depth and opacity accumulate with the
weights alpha * T; the semantic id is that of the largest weight. The
projection (EWA with the 0.3 px dilation, the frustum clamp of the
Jacobian, the opacity-aware extent) and the degree-3 SH colour are frozen
copies of the classic arithmetic. A Gaussian is listed in every 32 x 32
tile its extent box touches; no tile cull, no budgets, no early
termination beyond the point where every pixel of a group of tiles has
T <= 1e-4 (after which the rest adds under 1e-4).

Imports nothing of the program: it takes the benchmark's scene fields and
camera numbers and works everything out again. ``dtype`` runs it in
bfloat16 for the control. Under ``loss_targets`` it also backpropagates the
squared error, tile group by tile group, into the scene's leaves.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

TILE = 32
NPIX = TILE * TILE
CHUNK = 128
TRANS_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
DILATION = 0.3
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
APERTURE_MM = 20.954999923706055


class Cam(NamedTuple):
    """One pinhole camera: world position (3,), cam_to_world (3, 3) with
    columns right, down, forward; intrinsics as Python floats."""
    position: torch.Tensor
    rot: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float = 0.1
    far: float = 50.0


def agent_cam(x: float, y: float, yaw: float, width: int, height: int,
              focal_mm: float = 8.0, eye: float = 1.2, device=None) -> Cam:
    """The agent's first-person camera at (x, y), ``eye`` m up, level,
    facing ``yaw``."""
    f32 = dict(dtype=torch.float32, device=device)
    yaw_t = torch.tensor(yaw, **f32)
    c, s = torch.cos(yaw_t), torch.sin(yaw_t)
    fwd = torch.stack([c, s, torch.zeros_like(c)])
    right = torch.stack([s, -c, torch.zeros_like(c)])
    down = torch.linalg.cross(fwd, right)
    fx = float(torch.tensor(width * focal_mm / APERTURE_MM,
                            dtype=torch.float32))
    return Cam(torch.tensor([x, y, eye], **f32),
               torch.stack([right, down, fwd], 1), fx, fx,
               width / 2.0, height / 2.0, width, height)


def eval_sh(sh, dirs, degree: int):
    """RGB from (N, K, 3) SH coefficients along unit view directions, +0.5,
    clipped at 0 (the 3DGS basis up to degree 3)."""
    out = SH_C0 * sh[:, 0]
    if degree >= 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        out = (out + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.clamp(out + 0.5, min=0.0)


def project(fields: dict, cam: Cam, dtype=torch.float32) -> dict:
    """Screen-space Gaussians: means2d (N, 2), conic (N, 3), depth,
    colour (N, 3), opacity, visible (bool) and the extent box (N, 2) in px,
    all in ``dtype`` (visible and the box from its arithmetic)."""
    means = fields["means"].to(dtype)
    W = cam.rot.to(dtype).T
    d = means - cam.position.to(dtype)
    t = d @ W.T
    tz = t[:, 2]
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    inv_z = 1.0 / tz_safe
    u = cam.fx * t[:, 0] * inv_z + cam.cx
    v = cam.fy * t[:, 1] * inv_z + cam.cy
    lim_x = 1.3 * (0.5 * cam.width / cam.fx)
    lim_y = 1.3 * (0.5 * cam.height / cam.fy)
    txz = torch.clamp(t[:, 0] * inv_z, -lim_x, lim_x) * tz_safe
    tyz = torch.clamp(t[:, 1] * inv_z, -lim_y, lim_y) * tz_safe
    zero = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * txz * inv_z * inv_z], -1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * tyz * inv_z * inv_z], -1),
    ], 1)                                                   # (N, 2, 3)
    q = fields["quats"].to(dtype)
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], 1)     # (N, 3, 3)
    M = R * torch.exp(fields["log_scales"].to(dtype))[:, None, :]
    U = (J @ W) @ M                                         # (N, 2, 3)
    a = (U[:, 0] * U[:, 0]).sum(-1) + DILATION
    b = (U[:, 0] * U[:, 1]).sum(-1)
    c = (U[:, 1] * U[:, 1]).sum(-1) + DILATION
    det = a * c - b * b
    inv_det = 1.0 / torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)

    opacity = torch.sigmoid(fields["opacity_logits"].to(dtype))
    op = opacity.detach()
    s_cut = torch.sqrt(torch.clamp(2.0 * torch.log(
        torch.clamp(op, min=ALPHA_MIN) / ALPHA_MIN), min=1e-6))
    ext_x = torch.ceil(s_cut * torch.sqrt(torch.clamp(a.detach(), min=0))) + 1
    ext_y = torch.ceil(s_cut * torch.sqrt(torch.clamp(c.detach(), min=0))) + 1
    dirs = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)
    sh = fields["sh"].to(dtype)
    colour = eval_sh(sh, dirs, int(round(math.sqrt(sh.shape[1]))) - 1)
    ud, vd = u.detach(), v.detach()
    visible = ((tz.detach() > cam.near) & (tz.detach() < cam.far)
               & (det.detach() > 0) & (op > ALPHA_MIN)
               & (ud + ext_x > 0) & (ud - ext_x < cam.width)
               & (vd + ext_y > 0) & (vd - ext_y < cam.height))
    return {"means2d": torch.stack([u, v], -1), "conic": conic, "depth": tz,
            "colour": colour, "opacity": opacity, "visible": visible,
            "ext": torch.stack([ext_x, ext_y], -1)}


class Pairs(NamedTuple):
    gauss: torch.Tensor    # (P,) int64 Gaussian of each pair, by tile, front to back
    start: torch.Tensor    # (T + 1,) int64 first pair of each tile
    tiles_x: int
    tiles_y: int


def pair_lists(proj: dict, width: int, height: int) -> Pairs:
    """Every (tile, visible Gaussian) pair of the Gaussians' extent boxes,
    grouped by tile and depth-ordered (ties by index) within each."""
    dev = proj["depth"].device
    tx, ty = -(-width // TILE), -(-height // TILE)
    n = proj["depth"].shape[0]
    vis = torch.nonzero(proj["visible"]).squeeze(1)
    m = proj["means2d"].detach()[vis].float()
    e = proj["ext"][vis].float()

    def cell(v, hi):
        return torch.clamp(torch.floor(v / TILE), 0, hi - 1).long()

    x0, x1 = cell(m[:, 0] - e[:, 0], tx), cell(m[:, 0] + e[:, 0], tx)
    y0, y1 = cell(m[:, 1] - e[:, 1], ty), cell(m[:, 1] + e[:, 1], ty)
    nx = x1 - x0 + 1
    count = nx * (y1 - y0 + 1)
    total = int(count.sum())
    row = torch.repeat_interleave(torch.arange(vis.shape[0], device=dev),
                                  count, output_size=total)
    first = torch.cumsum(count, 0) - count
    local = torch.arange(total, device=dev) - first[row]
    tile = (y0[row] + local // nx[row]) * tx + x0[row] + local % nx[row]
    depth = torch.where(proj["visible"], proj["depth"].detach().float(),
                        torch.tensor(float("inf"), device=dev))
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(depth, stable=True)] = torch.arange(n, device=dev)
    key = tile * n + rank[vis[row]]
    key, perm = torch.sort(key)
    start = torch.searchsorted(key, torch.arange(tx * ty + 1, device=dev) * n)
    return Pairs(vis[row[perm]], start, tx, ty)


def _chunk(carry, attrs, px, py):
    """Blend one chunk of pairs into a group's carry. ``attrs`` (G, C, 11):
    mx, my, conic a, b, c, opacity, r, g, b, depth, semantic id (as a
    float, -1 for no pair); ``px``, ``py`` (G, NPIX, 1) pixel centres."""
    T, acc, best_w, best_id = carry
    dx = px - attrs[:, None, :, 0]
    dy = py - attrs[:, None, :, 1]
    a, b, c = (attrs[:, None, :, i] for i in (2, 3, 4))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = attrs[:, None, :, 5] * torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.where(power > 0, torch.zeros_like(alpha), alpha)
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
    incl = torch.cumprod(1.0 - alpha, -1) * T[..., None]      # (G, NPIX, C)
    before = torch.cat([T[..., None], incl[..., :-1]], -1)
    w = alpha * before
    acc = acc + torch.bmm(w, attrs[..., 6:10])
    cw, arg = torch.max(w, -1)
    better = cw > best_w
    best_id = torch.where(better, torch.gather(
        attrs[..., 10], 1, arg), best_id)
    best_w = torch.where(better, cw, best_w)
    return (incl[..., -1], acc, best_w, best_id), alpha, before


class Counts(NamedTuple):
    """The least work a compositor needs for a frame: pairs with alpha > 0
    at some pixel of their tile before it saturates, pair-pixel evaluations
    with alpha > 0 at an unsaturated pixel, and the distinct Gaussians those
    pairs name; ``tiles`` of the frame."""
    pairs: int
    hits: int
    gaussians: int
    tiles: int


def render(fields: dict, cam: Cam, dtype=torch.float32, group: int = 64,
           loss_targets: Optional[torch.Tensor] = None, loss_scale=1.0,
           count: bool = False, bg=(0.0, 0.0, 0.0)):
    """Render one camera. Returns a dict of rgb (H, W, 3), depth, alpha and
    semantic (H, W), all float32 (semantic int64), and with ``count`` the
    frame's ``Counts``. With ``loss_targets`` (H, W, 3) it also
    backpropagates sum((rgb - target)^2) * ``loss_scale`` into the leaves of
    ``fields`` that require grad, and returns the loss (a float64 number)
    under ``loss``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    try:
        return _render(fields, cam, dtype, group, loss_targets, loss_scale,
                       count, bg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _render(fields, cam, dtype, group, loss_targets, loss_scale, count, bg):
    dev = fields["means"].device
    grad = loss_targets is not None
    with torch.set_grad_enabled(grad):
        proj = project(fields, cam, dtype)
    pairs = pair_lists(proj, cam.width, cam.height)
    keys = ("means2d", "conic", "opacity", "colour", "depth")
    leaves = {k: proj[k].detach().requires_grad_(grad) for k in keys}
    sem = fields["semantic_ids"].to(dtype)
    tx, ty = pairs.tiles_x, pairs.tiles_y
    n_tiles = tx * ty
    cnt = pairs.start[1:] - pairs.start[:-1]
    tile_order = torch.argsort(cnt, descending=True).cpu()
    cnt_host = cnt.cpu()
    lanes = torch.arange(CHUNK, device=dev)
    pix = torch.arange(NPIX, device=dev)
    out = torch.zeros((n_tiles, NPIX, 7), dtype=torch.float32, device=dev)
    loss = 0.0
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    needed = []
    for g0 in range(0, n_tiles, group):
        tid_h = tile_order[g0:g0 + group]
        tid = tid_h.to(dev)
        G = tid.shape[0]
        px = ((tid % tx) * TILE)[:, None, None].to(dtype) \
            + (pix % TILE)[None, :, None].to(dtype) + 0.5
        py = ((tid // tx) * TILE)[:, None, None].to(dtype) \
            + (pix // TILE)[None, :, None].to(dtype) + 0.5
        start = pairs.start[tid]
        c_t = cnt[tid]
        carry = (torch.ones((G, NPIX), dtype=dtype, device=dev),
                 torch.zeros((G, NPIX, 4), dtype=dtype, device=dev),
                 torch.zeros((G, NPIX), dtype=dtype, device=dev),
                 torch.full((G, NPIX), -1.0, dtype=dtype, device=dev))
        with torch.set_grad_enabled(grad):
            for k in range(-(-int(cnt_host[tid_h].max()) // CHUNK)):
                valid = (k * CHUNK + lanes)[None, :] < c_t[:, None]
                idx = torch.clamp(start[:, None] + k * CHUNK + lanes, max=max(
                    pairs.gauss.shape[0] - 1, 0))
                gi = pairs.gauss[idx] if pairs.gauss.numel() else idx
                vm = valid.to(dtype)[..., None]
                attrs = torch.cat([
                    leaves["means2d"][gi], leaves["conic"][gi],
                    leaves["opacity"][gi][..., None] * vm,
                    leaves["colour"][gi], leaves["depth"][gi][..., None],
                    torch.where(valid, sem[gi], -1.0)[..., None]], -1)
                if grad:
                    carry, alpha, before = checkpoint(
                        _chunk, carry, attrs, px, py, use_reentrant=False)
                else:
                    carry, alpha, before = _chunk(carry, attrs, px, py)
                if count:
                    live = (before > TRANS_EPS) & (alpha > 0)
                    hits += live.sum()
                    need = (alpha > 0).any(1) & (before > TRANS_EPS).any(1)
                    needed.append(gi[need])
                if bool((carry[0] <= TRANS_EPS).all()):
                    break
            T, acc, _, best_id = carry
            rgb = acc[..., 0:3] + T[..., None] * torch.tensor(
                bg, dtype=dtype, device=dev)
            if grad:
                yy = (tid // tx)[:, None] * TILE + pix[None, :] // TILE
                xx = (tid % tx)[:, None] * TILE + pix[None, :] % TILE
                inside = (yy < cam.height) & (xx < cam.width)
                tgt = loss_targets[torch.clamp(yy, max=cam.height - 1),
                                   torch.clamp(xx, max=cam.width - 1)]
                part = (((rgb.float() - tgt) ** 2).sum(-1)
                        * inside).sum() * loss_scale
                part.backward()
                loss += float(part.detach().double())
        out[tid] = torch.cat([
            rgb.detach(), (acc[..., 3] + T * cam.far).detach()[..., None],
            (1.0 - T).detach()[..., None], best_id.detach()[..., None],
            T.detach()[..., None]], -1).float()
    if grad:
        torch.autograd.backward([proj[k] for k in keys],
                                [leaves[k].grad if leaves[k].grad is not None
                                 else torch.zeros_like(proj[k])
                                 for k in keys])
    img = out.reshape(ty, tx, TILE, TILE, 7).permute(0, 2, 1, 3, 4).reshape(
        ty * TILE, tx * TILE, 7)[:cam.height, :cam.width]
    res = {"rgb": img[..., 0:3], "depth": img[..., 3], "alpha": img[..., 4],
           "semantic": img[..., 5].round().long(), "trans": img[..., 6]}
    if grad:
        res["loss"] = loss
    if count:
        g = torch.cat(needed) if needed else torch.zeros(0, dtype=torch.long)
        res["counts"] = Counts(int(g.numel()), int(hits),
                               int(torch.unique(g).numel()), n_tiles)
    return res
