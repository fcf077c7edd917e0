"""K3's walk in segments (``composite_cuda``): K2's plain twin writing the
segment checkpoints and K3's plain twin starting each segment from them,
against the single sweep of each tile, on the CPU."""

import numpy as np
import pytest
import torch

from sage3d_tpu_torch.ops import binning, composite_cuda as tcu
from sage3d_tpu_torch.ops.projection import project_gaussians
from sage3d_tpu_torch.renderer import render as trender
from sage3d_tpu_torch.renderer.camera import make_camera
from sage3d_tpu_torch.renderer.scene import synthetic_room
from sage3d_tpu_torch.utils import profiling

W, H = 64, 48


def _dense_case(n=2400, opacity=0.06):
    """A room of faint Gaussians at 64x48: no tile saturates, so each walks
    its ~10 chunks to the end. The attribute table, the pair lists, the
    safe gradient capacity and a seeded cotangent of K2's output."""
    scene = synthetic_room(n, seed=11, device="cpu")
    logit = float(np.log(opacity / (1.0 - opacity)))
    scene = scene._replace(opacity_logits=torch.full_like(
        scene.opacity_logits, logit))
    cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], W, H,
                      device="cpu")
    bk = trender.budget_kwargs(trender.autotune_all(scene, cam))
    with torch.no_grad():
        proj = project_gaussians(scene, cam)
        bins = binning.bin_gaussians(
            proj, W, H, **{k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
    attrs = tcu.attribute_table(proj, scene.semantic_ids)
    pg, start, count, _ = tcu.trim_to_capacity(bins)
    n_tiles = start.shape[0]
    gout = torch.from_numpy(np.random.default_rng(7).normal(
        size=(n_tiles, tcu.NCH, tcu.NPIX)).astype(np.float32))
    return dict(attrs=attrs, args=(pg, start, count), tiles_x=bins.tiles_x,
                c_cap=pg.shape[0] // tcu.CHUNK + n_tiles, gout=gout)


CASE = _dense_case()
LONGEST = int(((CASE["args"][2] + tcu.CHUNK - 1) // tcu.CHUNK).max())


def _run(case, seg):
    """K2's images, k_end and checkpoints, the slot rows of K3 and d_attrs
    through the sort and K4, with segments of ``seg`` chunks (0: none)."""
    attrs, args, tiles_x = case["attrs"], case["args"], case["tiles_x"]
    out, kend, *ckpt = tcu.composite_fwd(attrs, *args, tiles_x, seg=seg)
    chunk0, allowed = tcu.slot_ranges(kend, case["c_cap"])
    kw = dict(ckpt=ckpt[0], seg=seg) if seg else {}
    slots = tcu.composite_bwd(attrs, *args, chunk0, allowed, out,
                              case["gout"], case["c_cap"], tiles_x, **kw)
    d = tcu.composite_vjp(attrs, *args, kend, out, case["gout"], tiles_x,
                          case["c_cap"], **kw)
    return out, kend, slots, d, chunk0


@pytest.mark.parametrize("seg", [1, 4, LONGEST])
def test_segments_match_the_single_sweep(seg):
    assert LONGEST >= 6                       # the case walks long tiles
    out0, kend0, slots0, d0, chunk0 = _run(CASE, 0)
    out, kend, slots, d, _ = _run(CASE, seg)
    # K2's outputs do not depend on the checkpoints it writes
    assert torch.equal(out[:, 5], out0[:, 5]) and torch.equal(kend, kend0)
    assert torch.equal(out, out0)
    assert int(kend.max()) == LONGEST         # no tile stopped early
    assert torch.equal(slots[:, tcu.NGRAD:], slots0[:, tcu.NGRAD:])
    if seg >= LONGEST:
        assert torch.equal(slots, slots0) and torch.equal(d, d0)
        return
    # each tile's first segment is the single sweep's, row for row
    first = torch.cat([torch.arange(c, c + min(seg, int(k)))
                       for c, k in zip(chunk0.tolist(), kend.tolist())])
    rows = (first[:, None] * tcu.CHUNK + torch.arange(tcu.CHUNK)).reshape(-1)
    assert torch.equal(slots[rows], slots0[rows])
    assert not torch.equal(slots[:, :tcu.NGRAD], slots0[:, :tcu.NGRAD])
    for ch in range(tcu.NGRAD):
        scale = float(d0[:, ch].abs().max())
        assert scale > 0, ch
        err = float((d[:, ch] - d0[:, ch]).abs().max())
        assert err <= 1e-6 * scale, (ch, err / scale)


def test_segments_route_ids_past_2_24():
    """The same walk with the table's rows at ids on both sides of 2^24
    (the slot rows' two id columns): the payload is the small table's, bit
    for bit, split and unsplit, and each row names its pair's id."""
    n = CASE["attrs"].shape[0]
    base = 2**24 - n // 2
    big = torch.empty((base + n + 8, tcu.NFEAT))   # rows outside stay unread
    big[base:base + n] = CASE["attrs"]
    pg, start, count = CASE["args"]
    case = dict(CASE, attrs=big, args=(pg + base, start, count))
    seg = 3
    for s in (0, seg):
        _, _, slots_small, _, _ = _run(CASE, s)
        out = tcu.composite_fwd(big, pg + base, start, count,
                                CASE["tiles_x"], seg=s)
        chunk0, allowed = tcu.slot_ranges(out[1], CASE["c_cap"])
        kw = dict(ckpt=out[2], seg=s) if s else {}
        slots = tcu.composite_bwd(big, pg + base, start, count, chunk0,
                                  allowed, out[0], case["gout"],
                                  case["c_cap"], CASE["tiles_x"], **kw)
        assert torch.equal(slots[:, :tcu.NGRAD], slots_small[:, :tcu.NGRAD])
        ids = tcu.slot_ids(slots, big.shape[0]).long()
        filled = ids < big.shape[0]
        small = tcu.slot_ids(slots_small, n).long()
        assert torch.equal(filled, small < n)
        assert torch.equal(ids[filled], small[filled] + base)
        assert int(ids[filled].min()) < 2**24 <= int(ids[filled].max())
        assert float(slots[filled, tcu.SLOT_HI_COL].max()) == 1.0


def test_autograd_takes_segments_only_for_a_gradient(monkeypatch):
    """attr_composite: the segments forced by ``_seg`` under autograd give
    composite_vjp's d_attrs and count K3's work items; without a gradient K2
    writes no checkpoint. The rule sizes segments from the pair count."""
    pg, start, count = CASE["args"]
    seg = 2
    attrs = CASE["attrs"].clone().requires_grad_()
    profiling.reset()
    profiling.enable()
    try:
        with profiling.span("unit", unit=True):
            out, kend = tcu.attr_composite(attrs, pg, start, count,
                                           CASE["tiles_x"], CASE["c_cap"],
                                           _seg=seg)
            out.backward(CASE["gout"])
    finally:
        profiling.disable()
    counts = profiling.counters()
    profiling.reset()
    _, _, _, d, _ = _run(CASE, seg)
    assert torch.equal(attrs.grad, d)
    n_tiles = start.shape[0]
    assert counts["composite.bwd_tiles"] == n_tiles
    assert counts["composite.bwd_blocks"] == n_tiles + -(-CASE["c_cap"] // seg)
    segs = []
    fwd = tcu.composite_fwd
    monkeypatch.setattr(tcu, "composite_fwd", lambda *a, seg=0, **kw: (
        segs.append(seg), fwd(*a, seg=seg, **kw))[1])
    with torch.no_grad():
        plain = tcu.attr_composite(attrs, pg, start, count, CASE["tiles_x"],
                                   CASE["c_cap"], _seg=seg)
    tcu.attr_composite(attrs.detach(), pg, start, count, CASE["tiles_x"],
                       CASE["c_cap"], _seg=seg)
    assert segs == [0, 0] and torch.equal(plain[0], out)
    # the rule: about SPLIT_WAVES waves of resident blocks over the chunks
    assert tcu.segment_chunks(10**6, torch.device("cpu")) == 0
    monkeypatch.setattr(tcu, "resident_blocks", lambda device: 528)
    cuda = torch.device("cuda")
    per_wave = tcu.SPLIT_WAVES * 528
    assert tcu.segment_chunks(16_600_000, cuda) == \
        -(-(-(-16_600_000 // tcu.CHUNK)) // per_wave)
    assert tcu.segment_chunks(per_wave * tcu.CHUNK * 3, cuda) == 3
    assert tcu.segment_chunks(tcu.CHUNK, cuda) == 0
