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
            assert binning.emit_tile_pairs.launches == before + 4
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
