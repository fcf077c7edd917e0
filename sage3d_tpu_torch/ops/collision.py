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
lane workaround, is not ported. On the card both queries are one launch of
kernel K6 (``csrc/capsule.cu``, wrapper ``capsule_best``) after a memset of
its scratch: per query the least clearance, its first Gaussian and the
contact count, with no (B, N) temporaries and, for the pruned query, no host
sync. K6 reads the opacity logits (its solid test is PyTorch's sigmoid
written out) and assembles the query's result itself (``hit``,
``nearest_id``, the clearance clipped at the prune margin), so a query
launches nothing else (but the fill of a radius given as a number) unless a
gradient is asked for. Its plain twin
``capsule_best_plain`` (the CPU's path) walks the scene in passes of at most
QUERY_PAIRS capsule-Gaussian pairs, so memory stays bounded whatever B and
the scene's size, and assembles the result with ``_finish_plain``. Both
reduce the same packed key (``pack_key``: the clearance's order-preserving
bits above the Gaussian index), so the least clearance and its first index
come out of one integer minimum. The clearance is then recomputed with
autograd for the one Gaussian each query picked, so ``clearance`` is
differentiable w.r.t. ``p0`` and ``p1`` without keeping any pass's
intermediates (an exact tie for the minimum sends the whole gradient to the
first Gaussian, where ``jnp.min`` splits it).

Entry points take ``device=None``, which means the card; they raise when the
scene's tensors lie elsewhere, and never fall back to the CPU.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..renderer.scene import GaussianScene, resolve_device
from . import _build

DEFAULT_OPACITY_THRESH = 0.5
DEFAULT_SIGMA_CUT = 2.0
BIG = 1e9   # the clearance of "no solid Gaussian"
QUERY_PAIRS = 1 << 24   # capsule-Gaussian pairs a pass of the plain twin:
                        # each of its ~20 (B, pass) float32 temporaries takes
                        # at most 64 MiB
NONE = (1 << 63) - 1    # the packed key of "no solid Gaussian"
FEW_MAX = 4             # K6 takes its few-query schedule up to this B
                        # (csrc/capsule.cu kFewMax)


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
    if isinstance(radius, (int, float)):    # a fill: no copy to the card
        return p0, p1, torch.full(p0.shape[:1], float(radius),
                                  dtype=torch.float32, device=dev)
    return p0, p1, f32(radius).expand(p0.shape[:1])


def _rotmat_channels(quats: torch.Tensor):
    """Normalized-quaternion rotation matrix as 9 separate (...,) channels:
    ``projection._rotmat_channels`` with the norm written out as
    sqrt(((w^2 + x^2) + y^2) + z^2), since torch's norm reduction adds in
    an order of its own on each device and K6 rounds as this does."""
    w, x, y, z = quats.unbind(-1)
    den = torch.sqrt(w * w + x * x + y * y + z * z) + 1e-12
    w, x, y, z = w / den, x / den, y / den, z / den
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))


def _clearance(p0, p1, radius, means, quats, log_scales, logits,
               opacity_thresh, sigma_cut):
    """(clear, contact) of B capsules against Gaussian columns that carry a
    leading broadcast axis: (1, C, ...) for every pair, giving (B, C), or
    (B, 1, ...) for one Gaussian per query, giving (B, 1). Every operation
    is one f32 rounding in this order; K6 repeats them."""
    d = p1 - p0                                              # (B, 3)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    dd = (dx * dx + dy * dy + dz * dz)[:, 0]
    inv_dd = (1.0 / torch.where(dd > 1e-12, dd, torch.ones_like(dd)))[:, None]
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
    solid = torch.sigmoid(logits) >= opacity_thresh
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
    opacity logits), of the rows ``rows`` (all when None)."""
    cols = (scene.means, scene.quats, scene.log_scales, scene.opacity_logits)
    if rows is None:
        return cols
    return tuple(c[rows] for c in cols)


def pack_key(clear: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is that of (clearance, index): the f32
    clearance's bits made order-preserving as a signed int32 (-0.0 taken as
    +0.0, the magnitude bits of negatives flipped) above the index
    (0 <= idx < 2^32). The least key is the least clearance and, on a tie,
    the smallest index: ``jnp.argmin``'s first occurrence. K6 packs the same
    order into unsigned words."""
    c = torch.where(clear == 0, torch.zeros_like(clear), clear)
    bits = c.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    return (key << 32) | idx


def unpack_key(word: torch.Tensor):
    """(clearance f32, index int64) of ``pack_key`` keys; NONE gives
    (BIG, -1)."""
    none = word == NONE
    key = (word >> 32).to(torch.int32)
    bits = torch.where(key >= 0, key, key ^ 0x7FFFFFFF)
    return (torch.where(none, BIG, bits.view(torch.float32)),
            torch.where(none, -1, word & 0xFFFFFFFF))


def _pass_best(q, cols, rows, opacity_thresh, sigma_cut):
    """Per query, the least key over the Gaussian columns ``cols`` (scene
    rows ``rows``), NONE where no clearance is below BIG, and the contact
    count."""
    clear, contact = _clearance(*q, *(c[None] for c in cols),
                                opacity_thresh, sigma_cut)
    words = torch.where(clear < BIG, pack_key(clear, rows[None]), NONE)
    return (torch.amin(words, dim=1),
            torch.sum(contact, dim=1, dtype=torch.int32))


class Best(NamedTuple):
    """K6's outputs. The last three are the query's result, filled when the
    scene's semantic ids are given (None otherwise)."""

    clear: torch.Tensor      # (B,) float32, BIG where no solid Gaussian
    idx: torch.Tensor        # (B,) int64 first index at the minimum, -1
    hits: torch.Tensor       # (B,) int32 contacts
    visited: torch.Tensor    # () int32 chunks visited, 0 when dense
    hit: Optional[torch.Tensor] = None         # (B,) bool, hits > 0
    nearest_id: Optional[torch.Tensor] = None  # (B,) int32, -1
    clearance: Optional[torch.Tensor] = None   # (B,) clear, clipped at the
                                               # margin when pruned


def _finish_plain(clear, idx, hits, ids, margin=None):
    """Plain version of K6's result assembly: (hit, nearest_id, clearance)
    from the winners, as ``capsule_query`` and ``capsule_query_pruned``
    report them. ``margin`` clips the clearance (the pruned query), and
    only a clearance below it (BIG when None) names a Gaussian."""
    nid = torch.where(idx >= 0, ids[torch.clamp(idx, min=0)], -1)
    limit = BIG
    if margin is not None:
        clear = torch.clamp(clear, max=margin)
        limit = margin
    return hits > 0, torch.where(clear < limit, nid, -1), clear


def capsule_best_plain(q, cols, opacity_thresh=DEFAULT_OPACITY_THRESH,
                       sigma_cut=DEFAULT_SIGMA_CUT, pass_size=None,
                       prune=None, ids=None) -> Best:
    """Plain version of K6 (``capsule_best``): the same outputs, from passes
    of at most ``pass_size`` Gaussians (None: QUERY_PAIRS // B, at least the
    JAX package's chunk of 65536), or with ``prune`` of whole visited
    chunks, as many a pass as QUERY_PAIRS allows, found with one host sync
    (``nonzero``). Each pass's least key folds into the running one, so
    over passes in scene order the first minimum wins."""
    p0 = q[0]
    dev, b, n = p0.device, p0.shape[0], cols[0].shape[0]
    best = torch.full((b,), NONE, dtype=torch.int64, device=dev)
    hits = torch.zeros((b,), dtype=torch.int32, device=dev)
    if prune is None:
        visited = torch.zeros((), dtype=torch.int32, device=dev)
        step = pass_size or max(65536, QUERY_PAIRS // max(b, 1))
        passes = [torch.arange(c0, min(c0 + step, n), device=dev)
                  for c0 in range(0, n, step)]
    else:
        aabb_min, aabb_max, max_scale, margin = prune
        chunk = n // aabb_min.shape[0]
        gap = _segment_aabb_gap(*q, aabb_min, aabb_max)
        reach = sigma_cut * max_scale + margin                 # (n_chunks,)
        visit = torch.any(gap <= reach[None, :], dim=0)        # (n_chunks,)
        visited = torch.sum(visit, dtype=torch.int32)
        chunks = torch.nonzero(visit)[:, 0]
        per_pass = max(1, QUERY_PAIRS // max(b * chunk, 1))
        lanes = torch.arange(chunk, device=dev)
        passes = [(chunks[c0:c0 + per_pass, None] * chunk
                   + lanes[None, :]).reshape(-1)
                  for c0 in range(0, chunks.numel(), per_pass)]
    for rows in passes:
        words, h = _pass_best(q, [c[rows] for c in cols], rows,
                              opacity_thresh, sigma_cut)
        best = torch.minimum(best, words)
        hits = hits + h
    clear, idx = unpack_key(best)
    if ids is None:
        return Best(clear, idx, hits, visited)
    return Best(clear, idx, hits, visited, *_finish_plain(
        clear, idx, hits, ids, None if prune is None else prune[3]))


def capsule_best(q, cols, opacity_thresh=DEFAULT_OPACITY_THRESH,
                 sigma_cut=DEFAULT_SIGMA_CUT, pass_size=None, prune=None,
                 ids=None) -> Best:
    """K6: per query, the least clearance over the solid Gaussians, the
    first index that reaches it and the contact count; with ``ids`` also
    the query's result.

    ``q`` is (p0, p1, radius): (B, 3), (B, 3), (B,) float32; ``cols`` the
    Gaussians' (means (N, 3), quats (N, 4), log-scales (N, 3), opacity
    logits (N,)) float32. ``prune`` is None for the dense query, or the
    accel's (aabb_min, aabb_max, max_scale, prune_margin), its N Gaussians
    in n_chunks whole chunks: then only the chunks some capsule can reach
    are walked. ``ids`` is the scene's (N,) int32 semantic ids. Returns a
    ``Best``.

    A CPU tensor takes the plain version (``pass_size`` sizes its passes);
    a CUDA tensor launches ``csrc/capsule.cu``: a memset of O(B) scratch
    and one launch, no host sync; B above FEW_MAX takes the many-query
    schedule."""
    p0, p1, radius = q
    means, quats, log_scales, logits = cols
    b, n = p0.shape[0], means.shape[0]
    want = [(p0, (b, 3)), (p1, (b, 3)), (radius, (b,)), (means, (n, 3)),
            (quats, (n, 4)), (log_scales, (n, 3)), (logits, (n,))]
    if prune is not None:
        n_chunks = prune[0].shape[0]
        want += [(prune[0], (n_chunks, 3)), (prune[1], (n_chunks, 3)),
                 (prune[2], (n_chunks,))]
        if n_chunks == 0 or n % n_chunks:
            raise ValueError("capsule_best: the accel's Gaussians must fill "
                             "its chunks")
    for t, shape in want:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"capsule_best: expected {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if ids is not None:
        if tuple(ids.shape) != (n,) or ids.dtype != torch.int32:
            raise ValueError(f"capsule_best: expected ({n},) int32 ids, got "
                             f"{tuple(ids.shape)} {ids.dtype}")
        want.append((ids, (n,)))
    dev = means.device
    if any(t.device != dev for t, _ in want):
        raise ValueError("capsule_best: inputs on different devices")
    if dev.type == "cpu":
        return capsule_best_plain(q, cols, opacity_thresh, sigma_cut,
                                  pass_size, prune, ids)
    if dev.type != "cuda":
        raise ValueError(f"capsule_best: unsupported device {dev}")
    if n >= 2**31:
        raise ValueError("capsule_best: at most 2^31 - 1 Gaussians")

    held = []   # contiguous copies live until the launch is queued

    def ptr(t):
        if t is None:
            return None
        held.append(t.contiguous())
        return held[-1].data_ptr()

    def out(dtype, shape=(b,)):
        return torch.empty(shape, dtype=dtype, device=dev)

    state = out(torch.int64, (2 * b + 2,))
    res = Best(out(torch.float32), out(torch.int64), out(torch.int32),
               out(torch.int32, ()))
    if ids is not None:
        clipped = None if prune is None else out(torch.float32)
        res = res._replace(hit=out(torch.bool), nearest_id=out(torch.int32),
                           clearance=res.clear if clipped is None
                           else clipped)
    bounds = ((None, None, None, 0.0) if prune is None else
              (*(ptr(t) for t in prune[:3]), float(prune[3])))
    err = _build.launch(
        _build.load("capsule").sage3d_capsule_query, dev, ptr(p0), ptr(p1),
        ptr(radius), b,
        *(ptr(t) for t in cols), n,
        n if prune is None else n // prune[0].shape[0], *bounds,
        float(opacity_thresh), float(sigma_cut), ptr(ids),
        state.data_ptr(), *(ptr(t) for t in res[:4]), ptr(res.hit),
        ptr(res.nearest_id),
        None if prune is None or ids is None else ptr(res.clearance))
    _build.check(err, "capsule_best")
    capsule_best.launches += 1
    return res


capsule_best.launches = 0


def capsule_sigmoid(logits: torch.Tensor) -> torch.Tensor:
    """The sigmoid of K6's solid test over float32 ``logits``: on a CUDA
    tensor K6's own device function (``csrc/capsule.cu``), which must equal
    ``torch.sigmoid`` bitwise there; on the CPU ``torch.sigmoid``."""
    if logits.dtype != torch.float32:
        raise ValueError("capsule_sigmoid: expected float32 logits")
    if logits.device.type == "cpu":
        return torch.sigmoid(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"capsule_sigmoid: unsupported device "
                         f"{logits.device}")
    x = logits.contiguous()
    y = torch.empty_like(x)
    _build.check(_build.launch(_build.load("capsule").sage3d_capsule_sigmoid,
                               x.device, x.data_ptr(), y.data_ptr(),
                               x.numel()), "capsule_sigmoid")
    return y


def _result(scene, best: Best, q, opacity_thresh, sigma_cut,
            margin=None) -> Dict[str, torch.Tensor]:
    """The query's outputs from K6's result (``best``, its ids given).
    Where ``p0`` or ``p1`` asks for a gradient, the clearance carries the
    autograd of its recomputation against each query's winning Gaussian
    (the value stays the one found)."""
    clear = best.clearance
    p0, p1, _ = q
    if torch.is_grad_enabled() and (p0.requires_grad or p1.requires_grad):
        found = best.idx >= 0
        idx = torch.clamp(best.idx, min=0)
        again = _clearance(*q, *(c[:, None] for c in _columns(scene, idx)),
                           opacity_thresh, sigma_cut)[0][:, 0]
        clear = best.clear + torch.where(found, again - again.detach(),
                                         torch.zeros_like(again))
        if margin is not None:
            clear = torch.clamp(clear, max=margin)
    return {
        "clearance": clear,
        "hit": best.hit,
        "hit_count": best.hits,
        "nearest_id": best.nearest_id,
    }


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
    """Query B capsules against all Gaussians: K6 on the card; on the CPU
    its plain twin, ``chunk`` Gaussians a pass (None: QUERY_PAIRS // B, at
    least the JAX package's 65536).

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
    with torch.no_grad():
        best = capsule_best(tuple(t.detach() for t in q), _columns(scene),
                            opacity_thresh, sigma_cut, pass_size=chunk,
                            ids=scene.semantic_ids)
    return _result(scene, best, q, opacity_thresh, sigma_cut)


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

    On the card this is one launch of K6, which tests each chunk itself and
    skips those no capsule reaches: no host sync. The plain
    twin finds the visited chunks with one ``nonzero`` and sweeps them in
    chunk order, so the first minimum is the JAX package's (whose scan
    skips the other chunks one by one).
    """
    scene = accel.scene
    dev = _check_device(scene.means, device, "the collision accel")
    q = _queries(p0, p1, radius, dev)
    with torch.no_grad():
        best = capsule_best(
            tuple(t.detach() for t in q), _columns(scene), opacity_thresh,
            sigma_cut, prune=(accel.aabb_min, accel.aabb_max, accel.max_scale,
                   prune_margin), ids=scene.semantic_ids)
    out = _result(scene, best, q, opacity_thresh, sigma_cut,
                  margin=prune_margin)
    out["chunks_visited"] = best.visited
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
