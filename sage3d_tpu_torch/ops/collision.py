"""Batched capsule-vs-Gaussian collision queries (physics-aware execution).

PyTorch counterpart of ``sage3d_tpu/ops/collision.py``, the replacement for the
PhysX collision bodies the reference embeds into its 3DGS scenes
(template.usda:156-165 collision payload; simple_env.py:2823-2851 physics
scene; the kinematic agent is a cylinder collider, :741-967). Collision
geometry IS the Gaussian set: the agent capsule (vertical segment + radius,
matching the reference's cylinder agent) is tested against every Gaussian's
ellipsoid support directly.

The boolean "collides" decision uses the Mahalanobis distance at the closest
point of the capsule axis, thresholded at ``sigma_cut`` (default 2): a Gaussian
counts as solid out to 2 sigma if its opacity exceeds ``opacity_thresh``.

The math is the JAX package's; its channel-planar (B, chunk) layout, a TPU
lane workaround, is not ported. Both queries walk the scene in passes of at
most QUERY_PAIRS capsule-Gaussian pairs (B=1 takes a 1M scene in one pass),
under ``torch.no_grad``, so memory stays bounded whatever B and the scene's
size; each pass is some 130-190 elementwise launches. The clearance is then
recomputed with autograd for the one Gaussian each query picked, so
``clearance`` is differentiable w.r.t. ``p0`` and ``p1`` without keeping any
pass's intermediates (an exact tie for the minimum sends the whole gradient
to the first Gaussian, where ``jnp.min`` splits it).

Entry points take ``device=None``, which means the card; they raise when the
scene's tensors lie elsewhere, and never fall back to the CPU.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..renderer.scene import GaussianScene, resolve_device
from .projection import _rotmat_channels

DEFAULT_OPACITY_THRESH = 0.5
DEFAULT_SIGMA_CUT = 2.0
BIG = 1e9   # the clearance of "no solid Gaussian"
QUERY_PAIRS = 1 << 24   # capsule-Gaussian pairs a pass: each of the ~20
                        # (B, pass) float32 temporaries takes at most 64 MiB


def _check_device(t: torch.Tensor, device, what: str) -> torch.device:
    dev = resolve_device(device)
    if t.device.type != dev.type:
        raise ValueError(f"{what} lies on {t.device}, not on {dev}; pass "
                         f"device='{t.device.type}' or move it")
    return t.device


def _queries(p0, p1, radius, dev):
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)
    p0, p1 = f32(p0), f32(p1)
    return p0, p1, f32(radius).expand(p0.shape[:1])


def _clearance(p0, p1, radius, means, quats, log_scales, opac,
               opacity_thresh, sigma_cut):
    """(clear, contact) of B capsules against Gaussian columns that carry a
    leading broadcast axis: (1, C, ...) for every pair, giving (B, C), or
    (B, 1, ...) for one Gaussian per query, giving (B, 1)."""
    d = p1 - p0                                              # (B, 3)
    dd = torch.sum(d * d, dim=-1)
    inv_dd = (1.0 / torch.where(dd > 1e-12, dd, torch.ones_like(dd)))[:, None]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    # Closest point of each capsule axis to each Gaussian center:
    # t* = clamp((mu - p0) . d / |d|^2, 0, 1).
    rx = means[..., 0] - p0[:, 0:1]
    ry = means[..., 1] - p0[:, 1:2]
    rz = means[..., 2] - p0[:, 2:3]
    t = torch.clamp((rx * dx + ry * dy + rz * dz) * inv_dd, 0.0, 1.0)
    fx = rx - t * dx                                         # mu - closest
    fy = ry - t * dy
    fz = rz - t * dz
    dist = torch.sqrt(fx * fx + fy * fy + fz * fz + 1e-20)
    # Mahalanobis distance of the closest point: |S^-1 R^T diff|.
    R = _rotmat_channels(quats)
    inv_s = torch.exp(-log_scales)
    m2 = None
    for j in range(3):
        loc_j = (R[0][j] * fx + R[1][j] * fy + R[2][j] * fz) * inv_s[..., j]
        m2 = loc_j * loc_j if m2 is None else m2 + loc_j * loc_j
    maha = torch.sqrt(m2 + 1e-20)
    solid = opac >= opacity_thresh
    # Support radius along the contact direction: sigma_cut * dist / maha
    # (distance from center to the sigma_cut ellipsoid surface).
    support = sigma_cut * dist / torch.clamp(maha, min=1e-6)
    r = radius[:, None]
    clear = torch.where(solid, dist - support - r,
                        torch.full_like(dist, BIG))
    contact = solid & (maha <= sigma_cut + r * maha
                       / torch.clamp(dist, min=1e-6))
    return clear, contact


def _columns(scene: GaussianScene, rows=None):
    """The Gaussian columns the query reads (means, quats, log-scales,
    opacities), of the rows ``rows`` (all when None)."""
    cols = (scene.means, scene.quats, scene.log_scales, scene.opacity_logits)
    if rows is not None:
        cols = tuple(c[rows] for c in cols)
    return cols[:3] + (torch.sigmoid(cols[3]),)


def _best(q, cols, opacity_thresh, sigma_cut):
    """Per query: the least clearance over the Gaussian columns ``cols``,
    the index of its first occurrence, and the contact count."""
    clear, contact = _clearance(*q, *(c[None] for c in cols),
                                opacity_thresh, sigma_cut)
    c_min, c_arg = torch.min(clear, dim=1)   # first minimum, as jnp.argmin
    return c_min, c_arg, torch.sum(contact, dim=1, dtype=torch.int32)


def _result(scene, best_clear, best_idx, hits, q, opacity_thresh, sigma_cut,
            margin=None) -> Dict[str, torch.Tensor]:
    """The query's outputs from the winning Gaussian of each query
    (``best_idx``, -1 for none). Where ``p0`` or ``p1`` asks for a gradient,
    the clearance carries the autograd of its recomputation against that
    Gaussian (the value stays the one found)."""
    found = best_idx >= 0
    idx = torch.clamp(best_idx, min=0)
    clear = best_clear
    p0, p1, _ = q
    if torch.is_grad_enabled() and (p0.requires_grad or p1.requires_grad):
        again = _clearance(*q, *(c[:, None] for c in _columns(scene, idx)),
                           opacity_thresh, sigma_cut)[0][:, 0]
        clear = clear + torch.where(found, again - again.detach(),
                                    torch.zeros_like(again))
    nid = torch.where(found, scene.semantic_ids[idx], -1)
    limit = BIG
    if margin is not None:
        clear = torch.clamp(clear, max=margin)
        limit = margin
    return {
        "clearance": clear,
        "hit": hits > 0,
        "hit_count": hits,
        "nearest_id": torch.where(clear < limit, nid, -1),
    }


def _init(b, dev):
    return (torch.full((b,), BIG, dtype=torch.float32, device=dev),
            torch.full((b,), -1, dtype=torch.int64, device=dev),
            torch.zeros((b,), dtype=torch.int32, device=dev))


def _merge(best, c_best, rows):
    """Fold one pass's (min, first argmin, contacts) into the running
    ``best``; ``rows`` maps the pass's columns to scene rows. A later pass
    replaces only a strictly smaller minimum, so over passes in scene order
    the first minimum wins, as ``jnp.argmin`` over the whole scene."""
    best_clear, best_idx, hits = best
    c_min, c_arg, c_hits = c_best
    better = c_min < best_clear
    return (torch.where(better, c_min, best_clear),
            torch.where(better, rows(c_arg), best_idx), hits + c_hits)


def capsule_query(
    scene: GaussianScene,
    p0,
    p1,
    radius,
    opacity_thresh: float = DEFAULT_OPACITY_THRESH,
    sigma_cut: float = DEFAULT_SIGMA_CUT,
    chunk: int = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Query B capsules against all Gaussians, ``chunk`` at a time (None:
    QUERY_PAIRS // B, at least the JAX package's 65536).

    Args:
      p0, p1: (B, 3) capsule segment endpoints (world frame).
      radius: scalar or (B,) capsule radius.

    Returns dict of (B,)-shaped tensors:
      clearance:  min over Gaussians of (euclidean axis distance
                  - capsule radius - Gaussian sigma_cut support); negative
                  inside contact. Differentiable w.r.t. ``p0`` and ``p1``.
      hit:        bool, any solid Gaussian within sigma_cut of the capsule.
      hit_count:  int32 number of contacting Gaussians.
      nearest_id: semantic id of the minimum-clearance Gaussian (-1 if none).
    """
    dev = _check_device(scene.means, device, "the scene")
    q = _queries(p0, p1, radius, dev)
    best = _init(q[0].shape[0], dev)
    chunk = chunk or max(65536, QUERY_PAIRS // max(q[0].shape[0], 1))
    with torch.no_grad():
        cols = _columns(scene)
        qd = tuple(t.detach() for t in q)
        for c0 in range(0, scene.num_gaussians, chunk):
            best = _merge(best, _best(qd, [c[c0:c0 + chunk] for c in cols],
                                      opacity_thresh, sigma_cut),
                          lambda arg: arg + c0)
    return _result(scene, *best, q, opacity_thresh, sigma_cut)


class CollisionAccel(NamedTuple):
    """Spatially-chunked collision acceleration structure.

    The dense ``capsule_query`` touches all N Gaussians per query. This accel
    reorders the scene by a Morton code over (x, y) so each fixed-size chunk
    covers a compact region, and precomputes per-chunk AABBs + a
    conservative support bound; the pruned query then visits only the chunks
    whose AABB can contain a Gaussian within ``prune_margin`` of a query
    capsule. Indoor agents are local: few of ~64-128 chunks survive.
    """

    scene: GaussianScene          # Morton-reordered, padded copy of the scene
    aabb_min: torch.Tensor        # (n_chunks, 3) chunk bounds over means
    aabb_max: torch.Tensor        # (n_chunks, 3)
    max_scale: torch.Tensor       # (n_chunks,) max linear scale in the chunk


def _morton16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interleave two 16-bit ints into one int32 Morton code.

    The JAX package builds a uint32 code and casts it to int32, so codes of
    2^31 and above wrap negative (and sort first). The bits are spread here
    in int64 and wrapped the same way."""
    def spread(v):
        v = v.to(torch.int64) & 0xFFFFFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v
    code = spread(a) | (spread(b) << 1)
    return torch.where(code >= 1 << 31, code - (1 << 32), code).to(torch.int32)


@torch.no_grad()
def build_collision_accel(scene: GaussianScene, chunk: int = 8192,
                          device=None) -> CollisionAccel:
    """One-time (per scene) spatial sort + chunk-bound precompute.

    Gaussians are ordered by the Morton code of their quantized (x, y)
    (indoor scenes extend in the ground plane; z stays within chunks), a
    stable sort as ``jnp.argsort``'s, so a contiguous chunk is spatially
    compact and its AABB is tight. The tail is padded to whole chunks with
    far-away, transparent, tiny Gaussians (means 1e7, log-scales -10,
    opacity logits -20, semantic id -1), which never make contact."""
    dev = _check_device(scene.means, device, "the scene")
    m = scene.means
    n = scene.num_gaussians
    pad = (-n) % chunk
    lo = torch.amin(m, dim=0)
    span = torch.clamp(torch.amax(m, dim=0) - lo, min=1e-6)
    qx = torch.clamp((m[:, 0] - lo[0]) / span[0] * 65535.0, 0, 65535
                     ).to(torch.int32)
    qy = torch.clamp((m[:, 1] - lo[1]) / span[1] * 65535.0, 0, 65535
                     ).to(torch.int32)
    order = torch.argsort(_morton16(qx, qy), stable=True)

    def padded(t, value):
        tail = torch.full((pad,) + t.shape[1:], value, dtype=t.dtype,
                          device=dev)
        return torch.cat([t[order], tail])

    quats = padded(scene.quats, 0.0)
    quats[n:, 0] = 1.0
    sorted_scene = GaussianScene(
        means=padded(m, 1e7), log_scales=padded(scene.log_scales, -10.0),
        quats=quats, opacity_logits=padded(scene.opacity_logits, -20.0),
        sh=padded(scene.sh, 0.0), semantic_ids=padded(scene.semantic_ids, -1))
    n_chunks = (n + pad) // chunk
    mc = sorted_scene.means.reshape(n_chunks, chunk, 3)
    scales = torch.exp(sorted_scene.log_scales).reshape(n_chunks, chunk, 3)
    # Padding rows must not inflate chunk AABBs: an all-pad tail chunk gets
    # an empty (+inf/-inf) box whose gap is infinite, so it is never visited.
    real = (torch.arange(n + pad, device=dev) < n).reshape(n_chunks, chunk, 1)
    inf = torch.tensor(float("inf"), device=dev)
    return CollisionAccel(
        scene=sorted_scene,
        aabb_min=torch.amin(torch.where(real, mc, inf), dim=1),
        aabb_max=torch.amax(torch.where(real, mc, -inf), dim=1),
        max_scale=torch.amax(torch.where(real, scales, torch.zeros(
            (), device=dev)), dim=(1, 2)))


def _segment_aabb_gap(p0, p1, radius, amin, amax):
    """Conservative lower bound on distance(capsule axis, chunk AABB): the
    per-axis gap between the SEGMENT's AABB (inflated by radius) and the
    chunk AABB. (B, n_chunks)."""
    g2 = None
    for j in range(3):
        s_lo = torch.minimum(p0[:, j], p1[:, j])[:, None] - radius[:, None]
        s_hi = torch.maximum(p0[:, j], p1[:, j])[:, None] + radius[:, None]
        g = torch.clamp(torch.maximum(amin[None, :, j] - s_hi,
                                      s_lo - amax[None, :, j]), min=0.0)
        g2 = g * g if g2 is None else g2 + g * g
    return torch.sqrt(g2)


def capsule_query_pruned(
    accel: CollisionAccel,
    p0,
    p1,
    radius,
    opacity_thresh: float = DEFAULT_OPACITY_THRESH,
    sigma_cut: float = DEFAULT_SIGMA_CUT,
    prune_margin: float = 2.0,
    device=None,
) -> Dict[str, torch.Tensor]:
    """``capsule_query`` semantics with chunk-level spatial pruning.

    Identical to the dense query for every Gaussian whose clearance is below
    ``prune_margin``; the reported ``clearance`` is clipped at the margin
    (values == prune_margin mean "free by at least the margin"). ``hit``,
    ``hit_count`` and ``nearest_id``-below-margin are exact: a contact
    implies clearance < 0, and a chunk is only skipped when NO Gaussian in it
    can come within the margin (AABB gap > sigma_cut * chunk max scale +
    margin, a bound on the ellipsoid support). ``chunks_visited`` counts the
    chunks some query reaches.

    The visited chunks are found with one host sync (``nonzero``) and swept
    in chunk order, as many a pass as QUERY_PAIRS allows (all 123 chunks of
    8192 of a 1M scene at B up to 16), so the first minimum is the JAX
    package's (whose scan skips the other chunks one by one).
    """
    scene = accel.scene
    dev = _check_device(scene.means, device, "the collision accel")
    q = _queries(p0, p1, radius, dev)
    b = q[0].shape[0]
    best = _init(b, dev)
    n_chunks = accel.aabb_min.shape[0]
    chunk = scene.num_gaussians // n_chunks
    per_pass = max(1, QUERY_PAIRS // max(b * chunk, 1))
    with torch.no_grad():
        qd = tuple(t.detach() for t in q)
        gap = _segment_aabb_gap(*qd, accel.aabb_min, accel.aabb_max)
        reach = sigma_cut * accel.max_scale + prune_margin     # (n_chunks,)
        visit = torch.any(gap <= reach[None, :], dim=0)        # (n_chunks,)
        chunks = torch.nonzero(visit)[:, 0]
        lanes = torch.arange(chunk, device=dev)
        for c0 in range(0, chunks.numel(), per_pass):
            rows = (chunks[c0:c0 + per_pass, None] * chunk
                    + lanes[None, :]).reshape(-1)
            best = _merge(best, _best(qd, _columns(scene, rows),
                                      opacity_thresh, sigma_cut),
                          lambda arg: rows[arg])
    out = _result(scene, *best, q, opacity_thresh, sigma_cut,
                  margin=prune_margin)
    out["chunks_visited"] = torch.sum(visit, dtype=torch.int32)
    return out


def agent_capsule(pos_xy, z0: float = 0.1, z1: float = 0.7,
                  radius: float = 0.1, device=None):
    """The agent's collision capsule (cylinder r=0.1 m, h=0.5-0.7 m, the
    reference's collider, simple_env.py:765,922), as (p0, p1, radius) for
    (..., 2) positions; ``device=None`` means the card."""
    pos_xy = torch.as_tensor(pos_xy, dtype=torch.float32,
                             device=resolve_device(device))
    flat = pos_xy.reshape(-1, 2)
    col = torch.ones_like(flat[:, :1])
    p0 = torch.cat([flat, col * z0], dim=-1)
    p1 = torch.cat([flat, col * z1], dim=-1)
    return p0, p1, float(radius)
