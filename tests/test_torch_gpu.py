"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Without a CUDA device each test skips itself with the reason.
"""

import numpy as np
import pytest
import torch

from sage3d_tpu_torch.benchmarks import kernel_anatomy
from sage3d_tpu_torch.ops import binning, composite_cuda, segreduce
from sage3d_tpu_torch.ops.projection import project_gaussians
from sage3d_tpu_torch.renderer import render as trender
from sage3d_tpu_torch.renderer.camera import make_camera
from sage3d_tpu_torch.renderer.scene import synthetic_room

pytestmark = pytest.mark.gpu
PARAMS = ("means", "log_scales", "quats", "opacity_logits", "sh")


def _need_card(what: str):
    if not torch.cuda.is_available():
        pytest.skip(f"needs a CUDA device: {what} is a CUDA kernel")


def _frame(n=20_000, width=320, height=256, seed=5):
    scene = synthetic_room(n, seed=seed, device="cuda")
    cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], width, height,
                      device="cuda")
    return scene, cam, trender.budget_kwargs(trender.autotune_all(scene, cam))


def _sorted_pairs(keys, gauss, n_kept):
    """The first ``n_kept`` pairs, ordered by their (unique) keys."""
    n = int(n_kept)
    keys, perm = torch.sort(keys[:n])
    return keys, gauss[:n][perm]


@pytest.mark.parametrize("width,height", [(320, 256), (3840, 2160)])
def test_emit_kernel_matches_plain(width, height):
    _need_card("K1")
    scene, cam, bk = _frame(width=width, height=height)
    with torch.no_grad():
        plan = binning.emission_plan(
            project_gaussians(scene, cam), width, height,
            **{k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
    args = (plan.table, plan.offsets, plan.n_live, plan.tiles_x)
    for mult in {plan.mult, 0}:
        want = _sorted_pairs(*binning.emit_tile_pairs_plain(*args, mult))
        before = binning.emit_tile_pairs.launches
        got = _sorted_pairs(*binning.emit_tile_pairs(*args, mult))
        torch.cuda.synchronize()
        assert binning.emit_tile_pairs.launches == before + 1
        assert 0 < got[0].shape[0] <= plan.n_live
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_composite_kernel_matches_plain():
    _need_card("K2")
    scene, cam, bk = _frame()
    with torch.no_grad():
        proj = project_gaussians(scene, cam)
        bins = binning.bin_gaussians(
            proj, cam.width, cam.height,
            **{k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
    attrs = composite_cuda.attribute_table(proj, scene.semantic_ids)
    pg, start, count, _ = composite_cuda.trim_to_capacity(bins)
    args = (attrs, pg, start, count, bins.tiles_x)
    want_out, want_kend = composite_cuda.composite_fwd_plain(*args)
    before = composite_cuda.composite_fwd.launches
    out, kend = composite_cuda.composite_fwd(*args)
    torch.cuda.synchronize()
    assert composite_cuda.composite_fwd.launches == before + 1
    assert (kend != want_kend).float().mean() <= 0.001
    for ch in (0, 1, 2, 4, 5):
        torch.testing.assert_close(out[:, ch], want_out[:, ch], rtol=0, atol=2e-4)
    assert (out[:, 7] == want_out[:, 7]).float().mean() >= 0.995


def test_cuda_backend_matches_torch_backend_and_oracle():
    _need_card("the cuda backend")
    scene, cam, bk = _frame()
    with torch.no_grad():
        a = trender.render(scene, cam, backend="cuda", **bk)
        t = trender.render(scene, cam, backend="torch", **bk)
    assert int(a["overflow"]) == 0
    torch.testing.assert_close(a["rgb"], t["rgb"], rtol=0, atol=5e-4)
    assert (a["semantic"] == t["semantic"]).float().mean() > 0.995
    small = synthetic_room(400, seed=5, device="cuda")
    cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], 64, 48, device="cuda")
    with torch.no_grad():
        a = trender.render(small, cam, backend="cuda", pair_capacity=1 << 14)
        o = trender.render(small, cam, backend="oracle")
    for k in ("rgb", "alpha", "trans"):
        torch.testing.assert_close(a[k], o[k], rtol=1e-4, atol=1e-4)
    assert np.isfinite(a["depth"].cpu().numpy()).all()


def _k3_inputs():
    """Frame inputs of K3 at 320x256: the attribute table, the pair lists,
    K2's output, a seeded cotangent and the slot ranges."""
    scene, cam, bk = _frame()
    with torch.no_grad():
        proj = project_gaussians(scene, cam)
        bins = binning.bin_gaussians(
            proj, cam.width, cam.height,
            **{k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
    attrs = composite_cuda.attribute_table(proj, scene.semantic_ids)
    pg, start, count, _ = composite_cuda.trim_to_capacity(bins)
    out, kend = composite_cuda.composite_fwd(attrs, pg, start, count,
                                             bins.tiles_x)
    gen = torch.Generator(device="cuda").manual_seed(3)
    gout = torch.randn(out.shape, generator=gen, device="cuda")
    c_cap = int(kend.sum()) + 8
    chunk0, allowed = composite_cuda.slot_ranges(kend, c_cap)
    return (attrs, pg, start, count, chunk0, allowed, out, gout, c_cap,
            bins.tiles_x), kend


def test_backward_kernel_matches_plain():
    _need_card("K3")
    args, kend = _k3_inputs()
    want = composite_cuda.composite_bwd_plain(*args)
    before = composite_cuda.composite_bwd.launches
    got = composite_cuda.composite_bwd(*args)
    torch.cuda.synchronize()
    assert composite_cuda.composite_bwd.launches == before + 1
    used = int(kend.sum()) * composite_cuda.CHUNK
    # unfilled slots: zero payload and the out-of-range id N
    assert float(got[used:, :composite_cuda.NGRAD].abs().max()) == 0.0
    assert bool((got[used:, composite_cuda.GID_COL] == args[0].shape[0]).all())
    assert torch.equal(got[:, composite_cuda.GID_COL],
                       want[:, composite_cuda.GID_COL])
    for ch in range(composite_cuda.NGRAD):
        scale = float(want[:, ch].abs().max())
        torch.testing.assert_close(got[:, ch], want[:, ch], rtol=0,
                                   atol=2e-4 * scale)
    assert torch.equal(composite_cuda.composite_bwd(*args), got)


def test_segment_reduce_kernel_matches_plain():
    _need_card("K4")
    args, _ = _k3_inputs()
    slots = composite_cuda.composite_bwd(*args)
    ids, perm = torch.sort(slots[:, composite_cuda.GID_COL].int(), stable=True)
    rows = slots[:, :composite_cuda.NGRAD]
    n = args[0].shape[0]
    want = segreduce.segment_reduce_plain(ids, rows, n, perm=perm)
    before = segreduce.segment_reduce_sorted.launches
    got = segreduce.segment_reduce_sorted(ids, rows, n, perm=perm)
    again = segreduce.segment_reduce_sorted(ids, rows, n, perm=perm)
    torch.cuda.synchronize()
    assert segreduce.segment_reduce_sorted.launches == before + 2
    assert torch.equal(got, want)         # the plain version adds in K4's order
    assert torch.equal(got, again)        # deterministic: no atomics


def _segments(rng, n_out):
    """Ascending ids with segments of 0, 1, L, L + 1, 33, 1000 and 5000 rows
    among random short ones (so they start and end across warp and block
    boundaries), and ids below 0 and at or above n_out at both ends."""
    short = segreduce.SHORT
    lengths = [0, 1, short, short + 1, 33, 1000, 5000, short, short + 1]
    sizes = []
    for n in lengths:
        sizes += list(rng.integers(0, 4, size=int(rng.integers(5, 90))))
        sizes.append(n)
    sizes += list(rng.integers(0, 40, size=n_out - len(sizes) - 8))
    ids = np.repeat(np.arange(len(sizes)) + 4, sizes)
    ids = np.concatenate([[-7, -1, -1], ids, [n_out, n_out, n_out + 5]])
    return ids.astype(np.int32)


@pytest.mark.parametrize("layout", ["perm_wide", "wide", "perm_packed",
                                    "packed"])
def test_segment_reduce_kernel_is_bitwise_plain_on_constructed_segments(layout):
    _need_card("K4")
    rng = np.random.default_rng(17)
    n_out = 1200
    ids = _segments(rng, n_out)
    p = len(ids)
    rows = (rng.normal(size=(p, 10)) * 10.0 ** rng.integers(
        -3, 4, size=(p, 1))).astype(np.float32)
    rows[::7] *= np.float32(1e-40)   # subnormal sums are kept, not flushed
    perm = None
    if layout.startswith("perm"):
        perm = rng.permutation(p)
        src = np.empty_like(rows)
        src[perm] = rows
    else:
        src = rows
    if layout.endswith("wide"):      # a column slice of 16-wide rows: float4
        wide = np.zeros((p, 16), np.float32)
        wide[:, :10] = src
        payload = torch.from_numpy(wide).cuda()[:, :10]
    else:                            # stride 10: scalar loads
        payload = torch.from_numpy(src).cuda()
    ids_t = torch.from_numpy(ids).cuda()
    perm_t = None if perm is None else torch.from_numpy(perm).cuda()
    got = segreduce.segment_reduce_sorted(ids_t, payload, n_out, perm=perm_t)
    again = segreduce.segment_reduce_sorted(ids_t, payload, n_out, perm=perm_t)
    on_card = segreduce.segment_reduce_plain(ids_t, payload, n_out, perm=perm_t)
    on_cpu = segreduce.segment_reduce_plain(
        torch.from_numpy(ids), torch.from_numpy(rows), n_out)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, on_card)
    assert torch.equal(got.cpu(), on_cpu)
    absent = np.setdiff1d(np.arange(n_out), ids)
    assert float(got[torch.from_numpy(absent).cuda()].abs().max()) == 0.0


def test_tight_grad_capacity_is_bitwise_on_the_card():
    _need_card("K3 and K4")
    args, kend = _k3_inputs()
    attrs, pg, start, count, _, _, out, gout, _, tiles_x = args
    n_tiles = start.shape[0]
    safe = pg.shape[0] // composite_cuda.CHUNK + n_tiles
    tight = int(kend.sum())
    assert tight < safe
    grads = [composite_cuda.composite_vjp(attrs, pg, start, count, kend, out,
                                          gout, tiles_x, c_cap)
             for c_cap in (tight, safe)]
    torch.cuda.synchronize()
    assert float(grads[0].abs().max()) > 0
    assert torch.equal(grads[0], grads[1])
    assert composite_cuda.composite_bwd_registers() > 0


def _split_frame(kind: str, n_cams: int = 1):
    """K2's and K3's inputs where K3 walks segments: "band", a 1152x224 band
    of the 1M room with its Gaussians made faint, so that its 252 tiles walk
    long, as a mesh rank's band of an aerial site does; "room", the
    1920x1080 frame of the 1M room (chip_smoke's frame a), ``n_cams``
    cameras in one batch. The K2 arguments, cam_tiles, K2's output and
    k_end, a seeded cotangent and the safe gradient capacity."""
    from sage3d_tpu_torch.renderer.camera import stack_cameras
    scene = synthetic_room(1_000_000, seed=0, device="cuda")
    poses = [([0.0, -6.0, 1.5], [0.0, 1.0, -0.05]),
             ([0.5, -5.5, 1.4], [0.1, 1.0, -0.05])][:n_cams]
    if kind == "band":
        scene = scene._replace(opacity_logits=scene.opacity_logits - 5.0)
        cams = [make_camera(*p, 1152, 224, focal_mm=8.4, device="cuda")
                for p in poses]
    else:
        cams = [make_camera(*p, 1920, 1080, focal_mm=14.0, device="cuda")
                for p in poses]
    cam = cams[0] if n_cams == 1 else stack_cameras(cams)
    bk = trender.budget_kwargs(trender.autotune_poses(scene,
                                                      stack_cameras(cams)))
    with torch.no_grad():
        proj = project_gaussians(scene, cam)
        bins = binning.bin_gaussians(
            proj, cams[0].width, cams[0].height,
            **{k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
    attrs = composite_cuda.attribute_table(proj, scene.semantic_ids)
    args = (attrs, *composite_cuda.trim_to_capacity(bins)[:3], bins.tiles_x)
    cam_tiles = bins.tiles_x * bins.tiles_y
    out, kend = composite_cuda.composite_fwd(*args, cam_tiles=cam_tiles)
    gen = torch.Generator(device="cuda").manual_seed(3)
    gout = torch.randn(out.shape, generator=gen, device="cuda")
    safe = args[1].shape[0] // composite_cuda.CHUNK + n_cams * cam_tiles
    return args, cam_tiles, out, kend, gout, safe


def _d_attrs_f64(args, cam_tiles, kend, gout, tile_batch=16):
    """d_attrs (N, NGRAD) in float64 of the chunks K2 walked: alpha as the
    kernels decide it, in float32 (``_plain_chunk``), and everything after
    it, the forward's sums and the backward's, in float64."""
    cc = composite_cuda
    attrs, pg, start, count, tiles_x = args
    dev, f64 = attrs.device, torch.float64
    px, py = cc._pixel_centers(dev)
    lanes = torch.arange(cc.CHUNK, device=dev)
    d = torch.zeros((attrs.shape[0], cc.NGRAD), dtype=f64, device=dev)
    for t0 in range(0, start.shape[0], tile_batch):
        tid = torch.arange(t0, min(t0 + tile_batch, start.shape[0]),
                           device=dev)
        st, cnt, allow = start[tid].long(), count[tid].long(), kend[tid].long()
        ox, oy = cc._origin(tid, tiles_x, cam_tiles)

        def walk():
            trans = torch.ones((tid.shape[0], cc.NPIX), dtype=f64, device=dev)
            for k in range(int(allow.max())):
                co, valid, alpha, raw = cc._plain_chunk(
                    attrs, pg, st, cnt, k, ox, oy, px, py)
                a = alpha.double()
                t_run = torch.cumprod(torch.cat([trans[:, None], 1.0 - a], 1), 1)
                yield k < allow, co.double(), valid, alpha, raw, a, t_run
                trans = torch.where((k < allow)[:, None], t_run[:, -1], trans)

        acc = torch.zeros((tid.shape[0], 6, cc.NPIX), dtype=f64, device=dev)
        for act, co, _, _, _, a, t_run in walk():
            w = a * t_run[:, :-1]
            new = torch.stack([(w * co[..., ch:ch + 1]).sum(1)
                               for ch in (6, 7, 8, 9)] + [w.sum(1)], 1)
            acc[:, :5] += torch.where(act[:, None, None], new, 0.0)
            acc[:, 5] = torch.where(act[:, None], t_run[:, -1], acc[:, 5])
        acc[:, 5] = torch.where(allow[:, None] > 0, acc[:, 5], 1.0)
        g = gout[tid].double()[:, :, None, :]
        f = acc[:, :, None, :]
        suffix = sum(g[:, ch] * f[:, ch] for ch in range(6))
        prefix = torch.zeros((tid.shape[0], 1, cc.NPIX), dtype=f64, device=dev)
        for k, (act, co, valid, alpha, raw, a, t_run) in enumerate(walk()):
            t_at = t_run[:, :-1]
            w = a * t_at
            c = sum(co[..., 6 + ch:7 + ch] * g[:, ch] for ch in range(4)) \
                + g[:, 4]
            incl = prefix + torch.cumsum(c * w, 1)
            dal = c * t_at - (suffix - incl) / (1.0 - a)
            dp = torch.where((alpha > 0) & (raw <= cc.ALPHA_MAX), dal, 0.0) * a
            dx = px - (co[..., 3:4] - ox)
            dy = py - (co[..., 4:5] - oy)
            op = co[..., 5]
            rows = torch.stack([
                (dp * (-0.5 * dx * dx)).sum(-1), (dp * (-dx * dy)).sum(-1),
                (dp * (-0.5 * dy * dy)).sum(-1),
                (dp * (co[..., 0:1] * dx + co[..., 1:2] * dy)).sum(-1),
                (dp * (co[..., 2:3] * dy + co[..., 1:2] * dx)).sum(-1),
                dp.sum(-1) / torch.where(op > 0, op, 1.0),
                *((g[:, ch] * w).sum(-1) for ch in range(4))], -1)
            keep = act[:, None] & valid
            gid = pg[torch.clamp(st[:, None] + k * cc.CHUNK + lanes,
                                 max=pg.shape[0] - 1)].long()
            d.index_add_(0, gid[keep], rows[keep])
            prefix = torch.where(act[:, None, None], incl[:, -1:], prefix)
    return d


@pytest.mark.parametrize("kind,n_cams", [("band", 1), ("room", 1),
                                         ("room", 2)])
def test_split_backward_matches_one_segment_a_tile(kind, n_cams):
    """K3 in segments from K2's checkpoints, at the segment length the card
    picks and at a quarter of the longest walk, beside K3 at one segment a
    tile, both against d_attrs of the same walk summed in float64: every
    channel within 2e-4 of its max (K3's tolerance against its plain twin),
    and in each channel the split no further from float64 than 2.5e-5 or
    the single sweep is in that channel, with a quarter for noise (on a
    band's walks of 200-500 chunks the single sweep's running prefix is
    itself up to 1.2e-4 off; each segment restarts it from K2's
    accumulators). K2's images and k_end are the same
    with the checkpoints; a tight grad_capacity and a second run are
    bitwise."""
    _need_card("K2's checkpoints and K3's segments")
    args, cam_tiles, out, kend, gout, safe = _split_frame(kind, n_cams)
    cc = composite_cuda
    vjp_args = (*args[:4], kend, out, gout, args[4])
    ref = _d_attrs_f64(args, cam_tiles, kend, gout)
    scale = ref.abs().amax(0)
    assert bool((scale > 0).all())

    def errs(d):
        return ((d[:, :cc.NGRAD].double() - ref).abs().amax(0)
                / scale).tolist()

    one = errs(cc.composite_vjp(*vjp_args, safe, cam_tiles=cam_tiles))
    longest = int(kend.max())
    auto = cc.segment_chunks(args[1].shape[0], args[0].device)
    segs = {max(1, longest // 4)} | ({auto} if 0 < auto < longest else set())
    if kind == "band":
        assert 0 < auto < longest     # the card's own pick splits a band
    for seg in sorted(segs):
        out_s, kend_s, ckpt = cc.composite_fwd(*args, cam_tiles=cam_tiles,
                                               seg=seg)
        assert torch.equal(out_s, out) and torch.equal(kend_s, kend)
        before = cc.composite_bwd.launches
        got, tight, again = (
            cc.composite_vjp(*vjp_args, c_cap, cam_tiles=cam_tiles,
                             ckpt=ckpt, seg=seg)
            for c_cap in (safe, int(kend.sum()), safe))
        torch.cuda.synchronize()
        assert cc.composite_bwd.launches == before + 3
        assert torch.equal(got, tight) and torch.equal(got, again), seg
        assert float(got[:, cc.NGRAD:].abs().max()) == 0.0
        split = errs(got)
        assert max(split) <= 2e-4 and max(one) <= 2e-4, (seg, split, one)
        assert all(s <= 1.25 * max(o, 2.5e-5) for s, o in zip(split, one)), \
            (seg, split, one)


def test_k2_writes_checkpoints_only_for_a_gradient(monkeypatch):
    """A render without a gradient launches K2 once and sizes no checkpoint
    buffer; with one, K2's images are the same bits and the backward is one
    K3 launch in segments."""
    _need_card("K2 and K3")
    scene, cam, bk = _frame(n=200_000, width=640, height=480)
    cc = composite_cuda
    sized = []
    rows = cc.checkpoint_rows
    monkeypatch.setattr(cc, "checkpoint_rows",
                        lambda n, seg: (sized.append(seg), rows(n, seg))[1])
    before = (cc.composite_fwd.launches, cc.composite_bwd.launches)
    with torch.no_grad():
        plain = trender.render(scene, cam, backend="cuda", **bk)
    torch.cuda.synchronize()
    assert (cc.composite_fwd.launches, cc.composite_bwd.launches) == (
        before[0] + 1, before[1])
    assert sized == []
    op = scene.opacity_logits.clone().requires_grad_()
    out = trender.render(scene._replace(opacity_logits=op), cam,
                         backend="cuda", **bk)
    torch.mean(out["rgb"] ** 2).backward()
    torch.cuda.synchronize()
    assert sized and min(sized) > 0
    assert cc.composite_bwd.launches == before[1] + 1
    for k in ("rgb", "depth", "alpha", "semantic", "trans", "grad_chunks"):
        assert torch.equal(out[k].detach(), plain[k]), k
    assert float(op.grad.abs().max()) > 0


@pytest.mark.parametrize("mode", ["f16", "bf16"])
def test_rounded_grad_sorts_on_the_card(mode):
    """The f16 and bf16 sorts round the slot rows in place and read them
    through the sort's index: the same d_attrs as the plain versions on the
    CPU, and a tight grad_capacity bitwise equal to the safe bound."""
    _need_card("K3 and K4")
    args, kend = _k3_inputs()
    attrs, pg, start, count, _, _, out, gout, _, tiles_x = args
    safe = pg.shape[0] // composite_cuda.CHUNK + start.shape[0]
    grads = [composite_cuda.composite_vjp(attrs, pg, start, count, kend, out,
                                          gout, tiles_x, c_cap, mode)
             for c_cap in (int(kend.sum()), safe)]
    cpu = composite_cuda.composite_vjp(
        *(x.cpu() for x in (attrs, pg, start, count, kend, out, gout)),
        tiles_x, safe, mode)
    torch.cuda.synchronize()
    assert float(grads[0].abs().max()) > 0
    assert torch.equal(grads[0], grads[1])
    tol = {"f16": 2e-3, "bf16": 2e-2}[mode]   # the CPU tests' mode tolerances
    torch.testing.assert_close(grads[1].cpu(), cpu, rtol=0,
                               atol=tol * float(cpu.abs().max()))


@pytest.mark.parametrize("name", list(kernel_anatomy.VARIANTS))
def test_anatomy_probe_matches_plain(name):
    _need_card("the K2 anatomy probe")
    scene, cam, bk = _frame()
    inputs = kernel_anatomy.prepare(scene, cam, bk)
    args = tuple(inputs[k] for k in
                 ("attrs", "pair_gauss", "tile_start", "tile_count"))
    flags = kernel_anatomy.VARIANTS[name]
    want = kernel_anatomy.variant_plain(*args, inputs["tiles_x"], **flags)
    call = kernel_anatomy.make_variant(inputs["n_tiles"], inputs["tiles_x"],
                                       **flags)
    before = kernel_anatomy.composite_anatomy.launches
    got = call(*args)
    torch.cuda.synchronize()
    assert kernel_anatomy.composite_anatomy.launches == before + 1
    for ch in (0, 1, 2, 4, 5, 6):
        torch.testing.assert_close(got[:, ch], want[:, ch], rtol=1e-4,
                                   atol=1e-4)
    torch.testing.assert_close(got[:, 3], want[:, 3], rtol=1e-3, atol=1e-3)
    assert (got[:, 7] == want[:, 7]).float().mean() >= 0.995
    if name == kernel_anatomy.PRODUCTION:      # K2 line for line
        k2, _ = composite_cuda.composite_fwd(*args, inputs["tiles_x"])
        assert torch.equal(got, k2)
        copies = [x[None].expand(2, *x.shape).contiguous() for x in args]
        two = kernel_anatomy.make_variant(
            inputs["n_tiles"], inputs["tiles_x"], batch=2, **flags)(*copies)
        assert torch.equal(two[0], k2) and torch.equal(two[1], k2)
    assert kernel_anatomy.variant_registers(**flags) > 0


def test_cuda_backend_gradients_match_torch_backend():
    _need_card("the cuda backend")
    scene, cam, bk = _frame()
    grads = {}
    for backend in ("cuda", "torch"):
        params = {k: getattr(scene, k).clone().requires_grad_()
                  for k in PARAMS}
        out = trender.render(scene._replace(**params), cam, backend=backend,
                             **bk)
        assert int(out["overflow"]) == 0
        torch.mean((out["rgb"] - 0.5) ** 2).backward()
        grads[backend] = {k: params[k].grad for k in PARAMS}
    for k in PARAMS:
        ref = grads["torch"][k]
        err = float((grads["cuda"][k] - ref).abs().max())
        assert err <= 5e-4 * float(ref.abs().max()), k


def _need_card_for(what: str):
    if not torch.cuda.is_available():
        pytest.skip(f"needs a CUDA device: {what} runs on the card")


def test_capsule_query_on_the_card_matches_cpu():
    from sage3d_tpu_torch.ops import collision
    _need_card_for("the capsule query")
    xy = np.stack(np.meshgrid(np.linspace(-4, 4, 4), np.linspace(-4, 4, 4)),
                  -1).reshape(-1, 2)
    outs = {}
    for dev in ("cuda", "cpu"):
        scene = synthetic_room(20_000, seed=3, device=dev)
        p0, p1, r = collision.agent_capsule(xy, device=dev)
        dense = collision.capsule_query(scene, p0, p1, r, chunk=4096,
                                        device=dev)
        accel = collision.build_collision_accel(scene, chunk=1024, device=dev)
        pruned = collision.capsule_query_pruned(accel, p0, p1, r, device=dev)
        outs[dev] = {k: {q: v.cpu() for q, v in o.items()}
                     for k, o in (("dense", dense), ("pruned", pruned))}
    for kind in ("dense", "pruned"):
        got, want = outs["cuda"][kind], outs["cpu"][kind]
        for k in ("hit", "hit_count", "nearest_id"):
            assert torch.equal(got[k], want[k]), (kind, k)
        torch.testing.assert_close(got["clearance"], want["clearance"],
                                   rtol=1e-5, atol=1e-5)
    assert int(outs["cuda"]["pruned"]["chunks_visited"]) == \
        int(outs["cpu"]["pruned"]["chunks_visited"])


def test_rollout_on_the_card_matches_cpu():
    from sage3d_tpu_torch.env.rollout import rollout
    from sage3d_tpu_torch.physics.occupancy import grid_from_mask
    _need_card_for("the rollout (K1, K2)")
    mask = np.zeros((200, 200), np.uint8)
    mask[:2], mask[-2:], mask[:, :2], mask[:, -2:] = 1, 1, 1, 1
    kw = dict(start_xy=[2.0, 2.0], start_yaw=0.0, goal_xy=[-2.0, -2.0],
              n_steps=10, width=160, height=120, pair_capacity=1 << 19,
              tile_capacity=1 << 14, backend="cuda")
    outs = {}
    for dev in ("cuda", "cpu"):
        scene = synthetic_room(20_000, seed=13, device=dev)
        grid = grid_from_mask(mask, bounds=[-5.0, 5.0, -5.0, 5.0], device=dev)
        before = binning.emit_tile_pairs.launches
        outs[dev] = {k: v.cpu() for k, v in
                     rollout(scene, grid, device=dev, **kw).items()}
        if dev == "cuda":
            torch.cuda.synchronize()
            assert binning.emit_tile_pairs.launches == before + 10
    got, want = outs["cuda"], outs["cpu"]
    assert int(got["total_overflow"]) == int(want["total_overflow"]) == 0
    assert int(got["total_collisions"]) == int(want["total_collisions"])
    for k in ("positions", "goal_distance", "min_clearance"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["mean_depth"], want["mean_depth"],
                               rtol=1e-4, atol=1e-4)


def test_wavefront_on_the_card_equals_cpu():
    from sage3d_tpu_torch.benchmarks.planner_bench import make_grid, sample_free
    from sage3d_tpu_torch.data.astar import plan_many, wavefront_distances
    _need_card_for("the wavefront planner")
    g = make_grid(240)
    pairs = sample_free(g, 16)
    fields = {dev: wavefront_distances(g == 0, pairs[:, 0], device=dev,
                                       return_relaxations=True)
              for dev in ("cuda", "cpu")}
    assert fields["cuda"][1] == fields["cpu"][1]
    assert torch.equal(fields["cuda"][0].cpu(), fields["cpu"][0])
    assert plan_many(g == 0, pairs[:, 0], pairs[:, 1], device="cuda") == \
        plan_many(g == 0, pairs[:, 0], pairs[:, 1], device="cpu")


def test_wavefront_kernel_is_bitwise_its_plain_twin():
    """K5 (``relax_tiles``) against ``relax_tiles_plain`` on the card, one
    launch at a time from the start to convergence, on a grid whose sides are
    not multiples of the tile: fields and flags equal bitwise; then the whole
    loop, with the relaxation count."""
    from sage3d_tpu_torch.data import astar
    _need_card("K5")
    rng = np.random.default_rng(4)
    free = torch.from_numpy(rng.uniform(size=(75, 131)) > 0.15).cuda()
    ys, xs = torch.nonzero(free, as_tuple=True)
    pick = torch.from_numpy(rng.integers(0, len(ys), 17)).cuda()
    src = torch.stack([ys[pick], xs[pick]], 1)
    field = {}
    for name, relax in (("kernel", astar.relax_tiles),
                        ("plain", astar.relax_tiles_plain)):
        field[name] = astar._relax_until_converged(free, src, relax)
    assert field["kernel"][1] == field["plain"][1]
    assert torch.equal(field["kernel"][0], field["plain"][0])
    cur = torch.full((17, 75, 131), astar.INF, device="cuda")
    cur[torch.arange(17), src[:, 0], src[:, 1]] = 0.0
    flags = torch.zeros((2, 2), dtype=torch.int32, device="cuda")
    for _ in range(field["kernel"][1] // astar.CHECK_EVERY):
        outs = [torch.empty_like(cur), torch.empty_like(cur)]
        astar.relax_tiles(cur, outs[0], free, None, flags[0, 0])
        astar.relax_tiles_plain(cur, outs[1], free, None, flags[1, 0])
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(flags[0], flags[1])
        flags.zero_()
        cur = outs[0]


def test_capsule_kernel_matches_its_plain_twin():
    """K6 (``capsule_best``) against ``capsule_best_plain`` on the card,
    dense and pruned, B = 1, 4, 64, 257 (both schedules, two query tiles),
    on a room and on its adversarial copy (``tests/capsule_cases.py``):
    indices, contact counts, chunks visited and the assembled result equal,
    the clearance within 1e-5 (the same f32 operations: 0 expected); a
    radius given as a stride-0 view gives the same outputs as the filled
    one."""
    from capsule_cases import adversarial_room, capsules
    from sage3d_tpu_torch.ops import collision
    _need_card("K6")
    base = synthetic_room(50_000, seed=3, device="cuda")
    xy = capsules(257)
    for scene in (base, adversarial_room(base)):
        accel = collision.build_collision_accel(scene, chunk=2048)
        for b in (1, 4, 64, 257):
            q = collision._queries(*collision.agent_capsule(xy[:b]),
                                   torch.device("cuda"))
            for sc, prune in (
                    (scene, None),
                    (accel.scene, (accel.aabb_min, accel.aabb_max,
                                   accel.max_scale, 2.0))):
                cols, ids = collision._columns(sc), sc.semantic_ids
                got = collision.capsule_best(q, cols, prune=prune, ids=ids)
                want = collision.capsule_best_plain(q, cols, prune=prune,
                                                    ids=ids)
                for k in (1, 2, 3, 4, 5):
                    assert torch.equal(got[k], want[k]), (b, prune is None,
                                                          k)
                for k in (0, 6):
                    torch.testing.assert_close(got[k], want[k], rtol=0,
                                               atol=1e-5)
                # a radius tensor that is a stride-0 view takes a copy
                stretched = q[2][:1].expand(b)
                again = collision.capsule_best((*q[:2], stretched), cols,
                                               prune=prune, ids=ids)
                for k in range(7):
                    assert torch.equal(again[k], got[k]), (b, k)


def _k6_case():
    from capsule_cases import capsules
    from sage3d_tpu_torch.ops import collision
    dev = torch.device("cuda", 0)
    cols = collision._columns(synthetic_room(50_000, seed=3, device=dev))
    q = collision._queries(*collision.agent_capsule(capsules(64)), dev)
    return q, cols, collision.capsule_best(q, cols)


def test_launch_takes_the_current_stream():
    """``_build.launch`` hands a kernel the current stream as a raw
    ``cudaStream_t`` (``torch._C._cuda_getCurrentRawStream``, not a public
    API): K6 launched inside ``torch.cuda.stream(s)`` must be queued behind
    the work already on ``s``."""
    from sage3d_tpu_torch.ops import collision
    _need_card("K6")
    q, cols, want = _k6_case()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        # The capsules reach K6's input only after ~0.5 s of spinning on s:
        # on any other stream K6 would read the zeros.
        p0 = torch.zeros_like(q[0])
        torch.cuda._sleep(1 << 30)
        p0.copy_(q[0])
        got = collision.capsule_best((p0, *q[1:]), cols)
    s.synchronize()
    for k in range(4):
        assert torch.equal(got[k], want[k]), k


def test_launch_takes_the_tensors_device():
    """``_build.launch`` makes the tensors' card current for the launch and
    takes that card's stream: K6 on card 1's tensors while card 0 is
    current gives card 0's outputs bit for bit."""
    from sage3d_tpu_torch.ops import collision
    _need_card("K6")
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the second device index")
    q, cols, want = _k6_case()
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    far = collision.capsule_best(tuple(t.to(other) for t in q),
                                 tuple(t.to(other) for t in cols))
    assert far.clear.device == other
    for k in range(4):
        assert torch.equal(far[k].cpu(), want[k].cpu()), k


def test_capsule_sigmoid_is_torch_sigmoid():
    """K6's solid test takes PyTorch's CUDA sigmoid written out: bitwise
    ``torch.sigmoid`` over a room's logits, a sweep across the 0.5
    threshold and the extremes."""
    from sage3d_tpu_torch.ops import collision
    _need_card("K6's sigmoid")
    x = torch.cat([
        synthetic_room(200_000, seed=1, device="cuda").opacity_logits,
        torch.linspace(-1e-5, 1e-5, 1 << 16, device="cuda"),
        torch.randn(1 << 16, device="cuda") * 30,
        torch.tensor([0.0, -0.0, 88.0, -88.0, 104.0, -104.0, float("inf"),
                      -float("inf")], device="cuda")])
    got = collision.capsule_sigmoid(x)
    assert torch.equal(got.view(torch.int32),
                       torch.sigmoid(x).view(torch.int32))


def test_waypoint_images_on_the_card_match_cpu(tmp_path):
    """One batch of waypoint frames through ``generate_scene_images``: the
    card's ``cuda`` backend (K1, K2) against the CPU's ``torch`` backend,
    within the cuda-vs-torch gate; the JPEGs within a few levels."""
    import json
    from PIL import Image
    from sage3d_tpu_torch.data.images import generate_scene_images
    _need_card_for("the waypoint image batch (K1, K2)")
    points = [{"position": [x, -1.0 + 0.3 * x, 0.5],
               "rotation": [0.0, 0.0, float(np.sin(y / 2)),
                            float(np.cos(y / 2))]}
              for x, y in zip(np.linspace(-2, 2, 4), (0.3, 1.2, 2.0, -2.5))]
    gt = tmp_path / "action_groundtruth.json"
    gt.write_text(json.dumps({"trajectories": [{
        "trajectory_id": "0", "sampled_points": points,
        "actions": ["MOVE_FORWARD"] * 3 + ["STOP"]}]}))
    kw = dict(width=320, height=240, pair_capacity=1 << 20,
              tile_capacity=1 << 14)
    metas = {}
    for dev in ("cuda", "cpu"):
        scene = synthetic_room(20_000, seed=3, device=dev)
        before = binning.emit_tile_pairs.launches
        metas[dev] = generate_scene_images(scene, gt, tmp_path / dev, "s",
                                           batch_size=4, device=dev, **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
            # the 4 waypoints are one batch: one batched render, one K1
            assert binning.emit_tile_pairs.launches == before + 1
    assert metas["cuda"]["total_overflow"] == metas["cpu"]["total_overflow"] == 0
    assert metas["cuda"] == metas["cpu"]
    for f in metas["cpu"]["trajectories"]["0"]["frames"]:
        a = np.asarray(Image.open(tmp_path / "cuda" / "s" / f), np.int16)
        b = np.asarray(Image.open(tmp_path / "cpu" / "s" / f), np.int16)
        assert np.abs(a - b).mean() < 0.5
    # The card's cuda frames against its torch backend's: the cuda-vs-torch
    # gate. Against the CPU's torch backend, a pixel whose alpha lies at the
    # 1/255 cutoff may land on the other side of it (exp differs in the last
    # place between the devices) and move by alpha * T * colour < 1/255: all
    # but 0.1% of the values within the gate, every one within 1/255.
    from sage3d_tpu_torch.data.images import waypoint_cameras
    frames = {}
    for dev, backend in (("cuda", "cuda"), ("cuda", "torch"), ("cpu", "torch")):
        scene = synthetic_room(20_000, seed=3, device=dev)
        cams = waypoint_cameras(points, 320, 240, device=dev)
        with torch.no_grad():
            frames[dev, backend] = trender.render_batch(
                scene, cams, backend=backend, pair_capacity=kw["pair_capacity"],
                tile_capacity=kw["tile_capacity"])["rgb"].cpu()
    card = frames["cuda", "cuda"]
    assert float((card - frames["cuda", "torch"]).abs().max()) <= 5e-4
    diff = (card - frames["cpu", "torch"]).abs()
    assert float((diff > 5e-4).float().mean()) <= 1e-3
    assert float(diff.max()) < 1 / 255


TF32_REL = 1e-2     # CNN logits, card vs CPU, over max |logit|: cuDNN may
                    # run the convolutions in TF32 (10-bit mantissa)


def test_cnn_policy_on_the_card_matches_cpu():
    """The serving CNN at its defaults (96x128, 4 frames): the card's logits
    within the TF32 tolerance of the CPU's on the same weights, and the same
    action wherever the top two logits are further apart than that."""
    from sage3d_tpu_torch.serve import torch_policy as tp
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the policy's device path")
    params = tp.init_cnn_policy(device="cpu",
                                generator=torch.Generator().manual_seed(0))
    card = {k: v.cuda() for k, v in params.items()}
    x = torch.rand((8, 4, 96, 128, 3),
                   generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = tp.CNNPolicy(params)(x)
        got = tp.CNNPolicy(card)(x.cuda()).cpu()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TF32_REL * scale
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * TF32_REL * scale
    assert torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_densify_prune_on_the_card_equals_cpu():
    """One density-control round on the card and on a CPU copy with the same
    generator seed: counters and semantic ids equal, rows bitwise but for
    the exp/log rounding (log_scales within 1 ulp, the offspring means
    within 1e-6)."""
    from sage3d_tpu_torch.parallel.densify import (DEAD_LOGIT, DensifyConfig,
                                                   DensifyState,
                                                   densify_prune)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the round's device path")
    n = 200_000
    g = torch.Generator().manual_seed(3)
    params = {"means": torch.rand((n, 3), generator=g) * 8 - 4,
              "log_scales": torch.log(torch.rand((n, 3), generator=g) * 0.2
                                      + 0.005),
              "quats": torch.randn((n, 4), generator=g),
              "opacity_logits": torch.rand((n,), generator=g) * 10 - 7,
              "sh": torch.randn((n, 4, 3), generator=g)}
    params["opacity_logits"][torch.rand((n,), generator=g) < 0.3] = DEAD_LOGIT
    accum = torch.rand((n,), generator=g) * 1e-3
    sem = torch.randint(-1, 9, (n,), generator=g, dtype=torch.int32)
    cfg = DensifyConfig(split_scale=0.1)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.clone().to(dev) for k, v in params.items()}
        outs[dev] = densify_prune(p, DensifyState(accum.to(dev), 4),
                                  torch.Generator().manual_seed(11), cfg,
                                  semantic_ids=sem.to(dev))
    (pc, _, _, sc, ic), (pg, _, _, sg, ig) = outs["cpu"], outs["cuda"]
    assert {k: int(v) for k, v in ic.items()} == \
        {k: int(v) for k, v in ig.items()}
    assert int(ic["n_split"]) > 0 and int(ic["n_clone"]) > 0
    assert torch.equal(sc, sg.cpu())
    for k in ("quats", "opacity_logits", "sh"):
        assert torch.equal(pc[k], pg[k].cpu()), k
    np.testing.assert_array_max_ulp(pc["log_scales"].numpy(),
                                    pg["log_scales"].cpu().numpy(), maxulp=1)
    means_c, means_g = pc["means"], pg["means"].cpu()
    assert float((means_c - means_g).abs().max()) <= 1e-6
    assert float((means_c != means_g).sum()) <= 3 * int(ic["n_split"])


def test_native_decoder_builds_into_build_native():
    """The compressed-PLY decoder is built from native/compressed_ply.cpp
    into build/native/ on the card's host and agrees with the Python one."""
    from pathlib import Path

    from sage3d_tpu_torch.utils import plyio_native as pn
    if not torch.cuda.is_available():
        pytest.skip("needs the card's host: its native build")
    lib = pn.load_native()
    assert Path(lib._name).parent == pn.BUILD_DIR
    rng = np.random.default_rng(0)
    chunk = np.sort(rng.uniform(-3, 3, (4, 18)).astype(np.float32), axis=1)
    chunk = np.concatenate([chunk[:, :3], chunk[:, 9:12], chunk[:, 3:6],
                            chunk[:, 12:15], chunk[:, 6:9], chunk[:, 15:18]],
                           axis=1)
    packed = rng.integers(0, 2**32, (1000, 4), dtype=np.uint64).astype(
        np.uint32)
    a = pn.decode_compressed(chunk, packed, use_native=True)
    b = pn.decode_compressed(chunk, packed, use_native=False)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)


def test_band_render_on_a_gloo_mesh_on_the_card():
    """``render_tile_sharded`` on two gloo ranks sharing the card: the
    gathered bands within K2's gate (2e-4) of the unsharded frame, overflow
    0."""
    import functools

    from sage3d_tpu_torch.parallel.mesh import spawn_mesh
    from sage3d_tpu_torch.parallel.sharded_render import render_tile_sharded
    _need_card("K1 and K2 of each band")
    scene, cam, bk = _frame()
    with torch.no_grad():
        ref = trender.render(scene, cam, backend="cuda", **bk)
    got = spawn_mesh(functools.partial(render_tile_sharded, backend="cuda",
                                       **bk), (1, 2), scene, cam,
                     timeout_s=300)
    assert int(got["overflow"]) == 0 and int(ref["overflow"]) == 0
    for k in ("rgb", "alpha"):
        assert float((got[k] - ref[k]).abs().max()) <= 2e-4, k


def _batch_cameras(width=320, height=256):
    from sage3d_tpu_torch.renderer.camera import agent_camera, stack_cameras
    cams = [agent_camera(xy, yaw, width=width, height=height, device="cuda")
            for xy, yaw in (((0.0, -3.5), 1.3), ((0.5, -3.0), 1.8),
                            ((-1.0, -3.2), 1.0))]
    return cams, stack_cameras(cams)


def test_batched_render_is_each_render_bitwise_on_the_card():
    _need_card("K1 and K2 with a camera axis")
    scene = synthetic_room(20_000, seed=5, device="cuda")
    cams, stacked = _batch_cameras()
    bk = trender.budget_kwargs(trender.autotune_poses(scene, stacked))
    launches = (binning.emit_tile_pairs.launches,
                composite_cuda.composite_fwd.launches)
    with torch.no_grad():
        got = trender.render_batch(scene, stacked, backend="cuda", **bk)
        torch.cuda.synchronize()
        assert (binning.emit_tile_pairs.launches,
                composite_cuda.composite_fwd.launches) == tuple(
                    n + 1 for n in launches)
        assert got["overflow"].tolist() == [0, 0, 0]
        for b, cam in enumerate(cams):
            one = trender.render(scene, cam, backend="cuda", **bk)
            for k in ("rgb", "depth", "alpha", "semantic", "trans",
                      "overflow", "grad_chunks"):
                assert torch.equal(got[k][b], one[k]), (b, k)
        # K1 and K2 with the camera axis against their plain versions
        proj = project_gaussians(scene, stacked)
        plan = binning.emission_plan(
            proj, cams[0].width, cams[0].height,
            **{k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
        args = (plan.table, plan.offsets, plan.n_live, plan.tiles_x)
        for mult in {plan.mult, 0}:
            want = _sorted_pairs(*binning.emit_tile_pairs_plain(*args, mult))
            pairs = _sorted_pairs(*binning.emit_tile_pairs(*args, mult))
            assert torch.equal(pairs[0], want[0])
            assert torch.equal(pairs[1], want[1])
        bins = binning.bin_gaussians(
            proj, cams[0].width, cams[0].height,
            **{k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
        k2_args = (composite_cuda.attribute_table(proj, scene.semantic_ids),
                   *composite_cuda.trim_to_capacity(bins)[:3], bins.tiles_x)
        n_tiles = bins.tiles_x * bins.tiles_y
        out, kend = composite_cuda.composite_fwd(*k2_args, cam_tiles=n_tiles)
        want_out, want_kend = composite_cuda.composite_fwd_plain(
            *k2_args, cam_tiles=n_tiles)
        assert float((kend != want_kend).float().mean()) <= 1e-3
        torch.testing.assert_close(out[:, :6], want_out[:, :6], rtol=2e-4,
                                   atol=2e-4)


def test_batched_backward_on_the_card_matches_the_per_camera_loop():
    _need_card("K3 and K4 over a camera batch")
    scene = synthetic_room(20_000, seed=5, device="cuda")
    cams, stacked = _batch_cameras()
    bk = trender.budget_kwargs(trender.autotune_poses(scene, stacked,
                                                      grad_margin=1.5))

    def grads(render_all):
        params = {k: getattr(scene, k).clone().requires_grad_()
                  for k in PARAMS}
        for rgb in render_all(scene._replace(**params)):
            torch.sum((rgb - 0.5) ** 2).backward()
        return {k: params[k].grad for k in PARAMS}

    before = (composite_cuda.composite_bwd.launches,
              segreduce.segment_reduce_sorted.launches)
    got = grads(lambda s: [trender.render_batch(s, stacked, backend="cuda",
                                                **bk)["rgb"]])
    torch.cuda.synchronize()
    assert (composite_cuda.composite_bwd.launches,
            segreduce.segment_reduce_sorted.launches) == tuple(
                n + 1 for n in before)
    want = grads(lambda s: [trender.render(s, c, backend="cuda", **bk)["rgb"]
                            for c in cams])
    for k in PARAMS:
        scale = float(want[k].abs().max())
        assert scale > 0 and float((got[k] - want[k]).abs().max()) <= \
            1e-5 * scale, k


def test_lockstep_rollout_on_the_card_is_each_rollout_bitwise():
    from sage3d_tpu_torch.env.rollout import rollout, rollout_batch
    from sage3d_tpu_torch.ops import collision
    from sage3d_tpu_torch.physics.occupancy import grid_from_mask
    _need_card("the lockstep rollout (K1, K2, K6)")
    mask = np.zeros((200, 200), np.uint8)
    mask[:2], mask[-2:], mask[:, :2], mask[:, -2:] = 1, 1, 1, 1
    scene = synthetic_room(20_000, seed=13, device="cuda")
    grid = grid_from_mask(mask, bounds=[-5.0, 5.0, -5.0, 5.0], device="cuda")
    starts = np.array([[2.0, 2.0], [-2.0, 2.0], [0.0, -3.0], [3.0, -3.0],
                       [-3.0, -1.0]], np.float32)
    yaws = np.array([0.0, 1.0, 1.57, 3.0, -1.0], np.float32)
    goals = -starts
    kw = dict(n_steps=6, width=160, height=120, pair_capacity=1 << 19,
              tile_capacity=1 << 14, device="cuda")
    before = (binning.emit_tile_pairs.launches,
              collision.capsule_best.launches)
    got = rollout_batch(scene, grid, starts, yaws, goals, **kw)
    torch.cuda.synchronize()
    assert (binning.emit_tile_pairs.launches,
            collision.capsule_best.launches) == (before[0] + 6,
                                                 before[1] + 6)
    for b in range(len(starts)):
        one = rollout(scene, grid, starts[b], yaws[b], goals[b], **kw)
        for k in one:
            assert torch.equal(got[k][b], one[k]), (b, k)


# -- K7, the projection --------------------------------------------------------

K7_EYE, K7_FORWARD = (0.0, -4.0, 1.2), (0.0, 1.0, -0.1)


def _k7_scene(deg: int, n: int = 20_000):
    """A room at SH ``deg`` with view-dependent colour, and Gaussians planted
    for camera 0 (``K7_EYE`` looking along ``K7_FORWARD``): 100 behind it,
    100 beyond its far plane, 100 on its image plane (|tz| < 1e-6, the
    safe-depth branch), 100 below ALPHA_MIN and 100 at its logit."""
    from sage3d_tpu_torch.ops.projection import ALPHA_MIN
    scene = synthetic_room(n, seed=11, sh_degree=deg, device="cuda")
    g = torch.Generator().manual_seed(deg)
    sh = scene.sh + 0.3 * torch.randn(scene.sh.shape, generator=g).cuda()
    eye = torch.tensor(K7_EYE)
    fwd = torch.tensor(K7_FORWARD)
    fwd = fwd / fwd.norm()
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 0.0, 1.0]))
    right = right / right.norm()
    s = torch.linspace(-3.0, 3.0, 100)[:, None]
    means = scene.means.clone()
    means[0:100] = (eye - 2.0 * fwd + 0.5 * s * right).cuda()
    means[100:200] = (eye + 60.0 * fwd + s * right).cuda()
    means[200:300] = (eye + s * right).cuda()
    logits = scene.opacity_logits.clone()
    logits[300:400] = -7.0
    a = np.float32(ALPHA_MIN)
    logits[400:500] = float(np.log(a / (np.float32(1) - a)))
    return scene._replace(means=means, sh=sh.contiguous(),
                          opacity_logits=logits)


def _k7_cameras(width, height):
    from sage3d_tpu_torch.renderer.camera import stack_cameras
    poses = [(K7_EYE, K7_FORWARD)] + [
        ((3.0 * np.cos(t), 3.0 * np.sin(t), 1.0 + 0.1 * i),
         (-np.cos(t), -np.sin(t), -0.2 + 0.05 * i))
        for i, t in enumerate(np.linspace(0.3, 5.9, 7))]
    cams = [make_camera(p, f, width, height, device="cuda") for p, f in poses]
    return cams, stack_cameras(cams)


def _bitwise(got, want, what):
    """Every field of two ``ProjectedGaussians`` equal bit for bit."""
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        n_diff = int((a != b).sum())
        assert n_diff == 0, f"{what}: {f} differs in {n_diff} entries"


@pytest.mark.parametrize("width,height", [(640, 480), (1920, 1080)])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_projection_kernel_is_bitwise_its_plain_twin(deg, width, height):
    """K7 against ``project_gaussians_plain`` on the card, one camera and a
    batch of 8, with and without ``clamp_dims``, at SH ``deg`` of a degree-3
    scene (16-byte SH loads) and of a scene of degree ``deg`` (K = 1 and 9:
    scalar loads): every field bitwise, each batched camera bitwise its
    single projection."""
    from sage3d_tpu_torch.ops import projection
    _need_card("K7")
    cams, stacked = _k7_cameras(width, height)
    for scene in {3: _k7_scene(3), deg: _k7_scene(deg)}.values():
        assert bool((projection.project_gaussians_plain(
            scene, cams[0], deg).depths[:100] < 0).all())
        for clamp in (None, (2 * width, 2 * height)):
            what = f"SH {deg} of {scene.sh.shape[1]}, clamp {clamp}"
            before = projection.project_gaussians_cuda.launches
            got = projection.project_gaussians_cuda(scene, stacked, deg, clamp)
            torch.cuda.synchronize()
            assert projection.project_gaussians_cuda.launches == before + 1
            _bitwise(got, projection.project_gaussians_plain(
                scene, stacked, deg, clamp), f"B=8, {what}")
            for b, cam in enumerate(cams):
                one = projection.project_gaussians_cuda(scene, cam, deg, clamp)
                _bitwise(one, projection.project_gaussians_plain(
                    scene, cam, deg, clamp), f"camera {b}, {what}")
                _bitwise(one, type(got)(*(t[b] for t in got)),
                         f"camera {b} in the batch, {what}")
            vis = got.visible[0]
            assert 0 < int(vis.sum()) < vis.numel()
            assert not bool(vis[:400].any())


def test_project_gaussians_takes_k7_only_without_a_gradient():
    """On the card ``project_gaussians`` launches K7 alone under ``no_grad``
    and for a scene that requires no gradient, and K7 under ``_ProjectK7``
    for one that does: its fields bitwise the plain version's, K8 launched
    once by the backward. A camera that requires a gradient raises."""
    from sage3d_tpu_torch.ops import projection
    _need_card("K7")
    scene = _k7_scene(3, n=4000)
    cams, stacked = _k7_cameras(640, 480)
    before = projection.project_gaussians_cuda.launches
    before_k8 = projection.project_gaussians_backward_cuda.launches
    plain = projection.project_gaussians_plain(scene, stacked, 3)
    _bitwise(projection.project_gaussians(scene, stacked), plain, "no grad")
    leaves = scene._replace(**{f: getattr(scene, f).clone().requires_grad_()
                               for f in PARAMS})
    with torch.no_grad():
        _bitwise(projection.project_gaussians(leaves, stacked), plain,
                 "no_grad")
    assert projection.project_gaussians_cuda.launches == before + 2
    got = projection.project_gaussians(leaves, stacked)
    assert projection.project_gaussians_cuda.launches == before + 3
    _bitwise(type(got)(*(t.detach() for t in got)), plain, "under autograd")
    assert projection.project_gaussians_backward_cuda.launches == before_k8
    got.colors.sum().backward()
    assert projection.project_gaussians_backward_cuda.launches == before_k8 + 1
    assert leaves.sh.grad is not None and bool(leaves.sh.grad.abs().sum() > 0)
    with pytest.raises(ValueError, match="camera"):
        projection.project_gaussians(leaves, stacked._replace(
            fx=stacked.fx.clone().requires_grad_()))


def test_projection_kernel_refuses_what_it_does_not_take():
    from sage3d_tpu_torch.ops import projection
    _need_card("K7")
    scene = _k7_scene(1, n=1000)
    cams, _ = _k7_cameras(64, 48)
    with pytest.raises(ValueError, match="SH degree"):
        projection.project_gaussians_cuda(scene, cams[0], 2)
    with pytest.raises(ValueError, match="contiguous"):
        projection.project_gaussians_cuda(
            scene._replace(means=scene.means.t().contiguous().t()), cams[0], 1)
    with pytest.raises(ValueError, match="float32"):
        projection.project_gaussians_cuda(
            scene._replace(quats=scene.quats.double()), cams[0], 1)
    with pytest.raises(ValueError, match="one CUDA device"):
        projection.project_gaussians_cuda(
            scene, cams[0]._replace(position=cams[0].position.cpu()), 1)


# -- K8, the projection's backward -----------------------------------------

# K8 against autograd of the plain chain: each gradient within K8_REL of its
# largest entry (the same arithmetic in f32, its sums in another order).
K8_REL = 1e-4
FIELDS = ("means2d", "conics", "depths", "colors", "opacities")


def _k8_against_autograd(scene, cams, deg: int = 3, clamp=None,
                         seed: int = 0) -> dict:
    """Random gradients of the five float fields back through K8
    (``project_gaussians`` under autograd, K8 launched once) and through
    autograd of ``project_gaussians_plain``: each scene gradient's largest
    error over its largest entry."""
    from sage3d_tpu_torch.ops import projection
    g = torch.Generator(device="cuda").manual_seed(seed)
    grads = {}
    for route in ("k8", "plain"):
        leaves = scene._replace(**{k: getattr(scene, k).clone()
                                   .requires_grad_() for k in PARAMS})
        before = projection.project_gaussians_backward_cuda.launches
        if route == "k8":
            proj = projection.project_gaussians(leaves, cams, deg, clamp)
            ups = [torch.randn(getattr(proj, f).shape, generator=g,
                               device="cuda") for f in FIELDS]
        else:
            proj = projection.project_gaussians_plain(leaves, cams, deg,
                                                      clamp)
        torch.autograd.backward([getattr(proj, f) for f in FIELDS], ups)
        torch.cuda.synchronize()
        assert projection.project_gaussians_backward_cuda.launches == (
            before + (route == "k8"))
        grads[route] = {k: getattr(leaves, k).grad for k in PARAMS}
        del leaves, proj
    rel = {}
    for k in PARAMS:
        ref = grads["plain"][k]
        scale = float(ref.abs().max())
        assert scale > 0, k
        rel[k] = float((grads["k8"][k] - ref).abs().max()) / scale
    assert not bool(grads["k8"]["sh"][:, (deg + 1) ** 2:].any())
    return rel


@pytest.mark.parametrize("n_cams", [1, 8])
def test_projection_backward_kernel_matches_autograd_on_the_1m_room(n_cams):
    """K8 against autograd of the plain chain on a 1M room at SH 3 with
    ``_k7_scene``'s planted Gaussians, 1920x1080, one camera and a batch of
    8, with and without ``clamp_dims``: each gradient within ``K8_REL`` of
    its largest entry."""
    _need_card("K8")
    scene = _k7_scene(3, n=1_000_000)
    cams, stacked = _k7_cameras(1920, 1080)
    cam = cams[0] if n_cams == 1 else stacked
    for clamp in (None, (3840, 2160)):
        rel = _k8_against_autograd(scene, cam, 3, clamp, seed=n_cams)
        assert max(rel.values()) <= K8_REL, (clamp, rel)


def test_projection_backward_kernel_past_2_24_rows():
    """K8 against autograd of the plain chain on ``_room_past_2_24``'s
    2^24 + 2^20 rows (64-bit row offsets), one camera at SH 3."""
    _need_card("K8")
    scene, _ = _room_past_2_24()
    cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], 160, 128,
                      device="cuda")
    rel = _k8_against_autograd(scene, cam, scene.sh_degree, seed=3)
    assert max(rel.values()) <= K8_REL, rel


def test_train_steps_with_k8_stay_within_the_fit_limits(monkeypatch):
    """Three ``cuda`` train steps of the 1M room at 1920x1080 and SH 3 from
    a noisy start, with the projection through K7 and K8 and through the
    plain chain (K7's rule forced off): the losses, the step-1 gradient
    norms and the change norms after step 3 of every group within the fit
    cell's ``loss_gap``, ``grad_gap`` and ``change_gap``
    (``perfbench/workloads/fit-1m-1080p.json``), by the reference's
    measures."""
    import json
    from pathlib import Path

    from perfbench.reference import train as rt
    from sage3d_tpu_torch.ops import projection
    from sage3d_tpu_torch.parallel import train
    from sage3d_tpu_torch.renderer.camera import stack_cameras
    _need_card("K8")
    limits = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                         / "workloads" / "fit-1m-1080p.json").read_text()
                        )["limits"]
    room = synthetic_room(1_000_000, seed=0, sh_degree=3, device="cuda")
    cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], 1920, 1080,
                      device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    start = room._replace(
        sh=room.sh + torch.randn(room.sh.shape, generator=g, device="cuda"),
        opacity_logits=room.opacity_logits + 0.5 * torch.randn(
            room.opacity_logits.shape, generator=g, device="cuda"))
    bk = trender.budget_kwargs(trender.autotune_all(
        start, cam, pair_margin=1.5, grad_margin=1.5))
    with torch.no_grad():
        target = trender.render(room, cam, backend="cuda", **bk)["rgb"][None]
    runs = {}
    for route in ("k8", "plain"):
        if route == "plain":
            monkeypatch.setattr(projection, "_takes_kernel",
                                lambda s, c: False)
        opt = train.make_group_optimizer(extent=1.0)
        step, _ = train.make_train_step(start, cam, optimizer=opt,
                                        backend="cuda", **bk)
        state = train.init_train_state(start, opt)
        before = projection.project_gaussians_backward_cuda.launches
        losses, grad1 = [], None
        for i in range(3):
            state, loss = step(state, stack_cameras([cam]), target)
            losses.append(float(loss))
            if i == 0:
                grad1 = {k: float(torch.linalg.vector_norm(
                    state.params[k].grad.double())) for k in PARAMS}
        assert projection.project_gaussians_backward_cuda.launches == (
            before + (3 if route == "k8" else 0))
        change = {k: float(torch.linalg.vector_norm(
            (state.params[k].detach() - getattr(start, k)).double()))
            for k in PARAMS}
        runs[route] = (losses, grad1, change)
        del state, step, opt
    (l_k8, g_k8, c_k8), (l_pl, g_pl, c_pl) = runs["k8"], runs["plain"]
    assert rt.loss_gap(l_k8, l_pl) <= limits["loss_gap"], (l_k8, l_pl)
    assert rt.worst_leaf_gap(g_k8, g_pl) <= limits["grad_gap"], (g_k8, g_pl)
    assert rt.worst_leaf_gap(c_k8, c_pl, ref_grad=g_pl) <= limits[
        "change_gap"], (c_k8, c_pl)


def _room_past_2_24(n_total: int = 2**24 + 2**20, n_room: int = 20_000):
    """A scene of ``n_total`` rows, all parked (far away, transparent) but
    a 20k-Gaussian room laid at the rows around 2^24, so that the frame's
    Gaussians carry ids on both sides of it; the room's first row."""
    from sage3d_tpu_torch.parallel.train import pad_scene_to
    room = synthetic_room(n_room, seed=5, device="cuda")
    first = 2**24 - n_room // 4
    # ``first`` parked rows: a one-row scene's padding, without the row
    head = pad_scene_to(room._replace(**{
        k: getattr(room, k)[:1] for k in room._fields}), first + 1)
    scene = room._replace(**{k: torch.cat([getattr(head, k)[1:],
                                           getattr(room, k)])
                             for k in room._fields})
    return pad_scene_to(scene, n_total), first


def test_gaussian_ids_past_2_24_route_on_the_card():
    """One render and backward of 2^24 + 2^20 rows, the frame's Gaussians
    at ids on both sides of 2^24: the cuda backend's gradients match the
    plain compositor's, every gradient on its own Gaussian (the parked rows'
    zero)."""
    _need_card("K3's routing past 2^24")
    scene, first = _room_past_2_24()
    n = scene.num_gaussians
    assert n == 2**24 + 2**20 and first < 2**24 < first + 20_000
    cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], 160, 128,
                      device="cuda")
    bk = trender.budget_kwargs(trender.autotune_all(scene, cam))
    grads = {}
    for backend in ("cuda", "torch"):
        params = {k: getattr(scene, k).clone().requires_grad_()
                  for k in PARAMS}
        out = trender.render(scene._replace(**params), cam, backend=backend,
                             **bk)
        assert int(out["overflow"]) == 0
        torch.mean((out["rgb"] - 0.5) ** 2).backward()
        grads[backend] = {k: params[k].grad for k in PARAMS}
        del params, out
    room = slice(first, first + 20_000)
    for k in PARAMS:
        ref, got = grads["torch"][k], grads["cuda"][k]
        assert float(ref[room].abs().amax()) > 0, k
        hi = ref[2**24:first + 20_000].abs().amax()
        assert float(hi) > 0, k          # Gaussians past 2^24 are seen
        err = float((got - ref).abs().max())
        assert err <= 5e-4 * float(ref.abs().max()), k
        assert float(got[:first].abs().max()) == 0.0, k
        assert float(got[first + 20_000:].abs().max()) == 0.0, k


def test_splat_layout_on_four_cards_matches_the_parameter_layout():
    """Three steps of the sharded step's splat layout and of its parameter
    layout on a (1, 4) NCCL mesh, a card a rank, from one start: the same
    losses, gradients and parameters, up to the band's rounding of the
    means and the sums' order; each rank projects its quarter."""
    import functools

    from sage3d_tpu_torch.parallel import audit
    from sage3d_tpu_torch.parallel.mesh import spawn_mesh
    from sage3d_tpu_torch.parallel.train import Optimizer, pad_scene_to
    from sage3d_tpu_torch.renderer.camera import stack_cameras
    _need_card("the splat layout over NCCL")
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices: an NCCL mesh of a card a rank")
    scene, cam, bk = _frame(n=200_000)
    scene = pad_scene_to(scene, 16)
    lrs = {"means": 8e-4, "log_scales": 5e-3, "quats": 1e-3,
           "opacity_logits": 5e-2, "sh": 2.5e-3}
    targets = torch.full((1, cam.height, cam.width, 3), 0.3, device="cuda")
    got = spawn_mesh(functools.partial(audit.compare_layouts, n_steps=3,
                                       backend="cuda", **bk),
                     (1, 4), scene, stack_cameras([cam]), targets,
                     Optimizer(group_lrs=lrs), backend="nccl",
                     timeout_s=600)
    p, s = got["params"], got["splats"]
    assert got["rows"]["splats"].tolist() == [scene.num_gaussians / 4] * 4
    assert got["rows"]["params"].tolist() == [float(scene.num_gaussians)] * 4
    torch.testing.assert_close(s["losses"], p["losses"], rtol=1e-4, atol=0)
    for k in PARAMS:
        scale = float(p["grads"][k].abs().max())
        err = float((s["grads"][k] - p["grads"][k]).abs().max())
        assert err <= 1e-3 * scale, (k, err, scale)
        assert float((s["params"][k] - p["params"][k]).abs().max()) <= 1e-3, k
