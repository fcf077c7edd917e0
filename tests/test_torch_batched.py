"""The camera-batched path on the CPU, through the kernels' plain versions:
K1, K2 and K3 with a camera axis against their single-camera calls,
``render_batch`` against ``render`` camera by camera (bitwise) and against
the JAX package's vmapped ``render_batch``, per-camera budgets, the grouping
of a batch below the f32 id limit, the lockstep ``rollout_batch`` and the
batched train step.

The fixtures are the render tests' small ones: 400 Gaussians at 64x48, B = 3
cameras."""

import jax
import numpy as np
import pytest
import torch

from sage3d_tpu.env import rollout as jroll
from sage3d_tpu.physics.occupancy import grid_from_mask as jgrid
from sage3d_tpu.renderer import camera as jcam
from sage3d_tpu.renderer import render as jrender
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.env import rollout as troll
from sage3d_tpu_torch.ops import binning as tbin
from sage3d_tpu_torch.ops import composite_cuda as tcu
from sage3d_tpu_torch.ops.collision import build_collision_accel as taccel
from sage3d_tpu_torch.ops.projection import project_gaussians
from sage3d_tpu_torch.parallel import train as ttrain
from sage3d_tpu_torch.physics.agent import apply_cmd, init_agent
from sage3d_tpu_torch.physics.occupancy import grid_from_mask as tgrid
from sage3d_tpu_torch.renderer import camera as tcam
from sage3d_tpu_torch.renderer import render as trender
from sage3d_tpu_torch.renderer.scene import scene_from_numpy

W, H = 64, 48
CAP = dict(pair_capacity=1 << 14)
POSES = (((0.0, -3.5), 1.3), ((0.5, -3.0), 1.8), ((-1.0, -3.2), 1.0))
PARAMS = ("means", "log_scales", "quats", "opacity_logits", "sh")
OUT_KEYS = ("rgb", "depth", "alpha", "semantic", "trans", "depth_acc",
            "rgb_acc", "overflow", "grad_chunks")
LOSS_REL = 1e-6     # batched vs per-camera loss, relative
GRAD_REL = 1e-5     # batched vs per-camera gradients, of max |grad| a group
POS_TOL = 1e-5      # rollouts against the JAX package (test_torch_rollout's)


def _cam_np(c):
    return {f: np.asarray(getattr(c, f)) for f in
            ("position", "cam_to_world", "fx", "fy", "cx", "cy")} | {
        "width": c.width, "height": c.height, "near": c.near, "far": c.far}


@pytest.fixture(scope="module")
def room():
    js = synthetic_room(num_gaussians=400, seed=5)
    ts = scene_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          device="cpu")
    jcs = [jcam.agent_camera(xy, yaw, width=W, height=H) for xy, yaw in POSES]
    tcs = [tcam.camera_from_numpy(_cam_np(c), device="cpu") for c in jcs]
    return js, ts, jcs, tcs


def _slices(room):
    """Each camera's projection alone, and the batch's."""
    _, ts, _, tcs = room
    with torch.no_grad():
        return ([project_gaussians(ts, c) for c in tcs],
                project_gaussians(ts, tcam.stack_cameras(tcs)))


def test_projection_and_agent_camera_batched_are_each_camera_bitwise(room):
    ones, batch = _slices(room)
    for b, one in enumerate(ones):
        for f, x in zip(one._fields, one):
            assert torch.equal(getattr(batch, f)[b], x), (b, f)
    xy = torch.tensor([p[0] for p in POSES])
    yaw = torch.tensor([p[1] for p in POSES])
    cams = tcam.agent_camera_t(xy, yaw, width=W, height=H)
    for b in range(len(POSES)):
        one = tcam.agent_camera_t(xy[b], yaw[b], width=W, height=H)
        for f in ("position", "cam_to_world", "fx", "fy", "cx", "cy"):
            assert torch.equal(getattr(cams, f)[b], getattr(one, f)), (b, f)


@pytest.mark.parametrize("fused", [True, False])
def test_k1_with_a_camera_axis_is_each_camera_bitwise(room, fused):
    ones, batch = _slices(room)
    plan = tbin.emission_plan(batch, W, H)
    n_tiles = plan.tiles_x * plan.tiles_y
    n = ones[0].depths.shape[0]
    assert plan.table.shape == (len(ones) * n, tbin.LIVE_COLS)
    mult = plan.mult if fused else 0

    def tile_rank(keys, mult):   # (tile, rank) of either key as one int64
        keys = keys.to(torch.int64)
        if mult:
            return (keys // mult) << 31 | keys % mult
        return keys

    keys, gauss, _ = tbin.emit_tile_pairs(plan.table, plan.offsets,
                                          plan.n_live, plan.tiles_x, mult)
    keys = tile_rank(keys, mult)
    tile = keys >> 31
    for b, one in enumerate(ones):
        p1 = tbin.emission_plan(one, W, H)
        assert p1.overflow.shape == (1,)
        assert torch.equal(plan.overflow[b:b + 1], p1.overflow)
        mult1 = p1.mult if fused else 0
        want_k, want_g, _ = tbin.emit_tile_pairs(p1.table, p1.offsets,
                                                 p1.n_live, p1.tiles_x, mult1)
        want_k, want_order = torch.sort(tile_rank(want_k, mult1))
        mine = (tile >= b * n_tiles) & (tile < (b + 1) * n_tiles)
        got_k, order = torch.sort(keys[mine] - (b * n_tiles << 31))
        assert want_k.numel() > 0
        assert torch.equal(got_k, want_k), b
        assert torch.equal(gauss[mine][order] - b * n, want_g[want_order]), b


def _bins_and_attrs(room):
    ones, batch = _slices(room)
    _, ts, _, _ = room
    bins = tbin.bin_gaussians(batch, W, H)
    singles = [tbin.bin_gaussians(p, W, H) for p in ones]
    return (ones, batch, bins, singles,
            tcu.attribute_table(batch, ts.semantic_ids),
            [tcu.attribute_table(p, ts.semantic_ids) for p in ones])


def test_k2_and_k3_with_a_camera_axis_are_each_camera_bitwise(room):
    ones, _, bins, singles, attrs, attrs1 = _bins_and_attrs(room)
    n = ones[0].depths.shape[0]
    n_cams, n_tiles = len(ones), bins.tiles_x * bins.tiles_y
    assert bins.tile_start.shape == (n_cams * n_tiles,)
    assert torch.equal(bins.n_pairs,
                       torch.cat([s.n_pairs for s in singles]))
    assert attrs.shape == (n_cams * n, tcu.NFEAT)
    assert torch.equal(attrs[:, tcu.GID_COL],
                       torch.arange(n_cams * n, dtype=torch.float32))
    pg, start, count, _ = tcu.trim_to_capacity(bins)
    out, kend = tcu.composite_fwd(attrs, pg, start, count, bins.tiles_x,
                                  cam_tiles=n_tiles)
    c_cap = 8
    chunk0, allowed = tcu.slot_ranges(kend, c_cap, groups=n_cams)
    gout = torch.from_numpy(np.random.default_rng(3).normal(
        size=out.shape).astype(np.float32))
    slots = tcu.composite_bwd(attrs, pg, start, count, chunk0, allowed, out,
                              gout, n_cams * c_cap, bins.tiles_x,
                              cam_tiles=n_tiles)
    for b, s1 in enumerate(singles):
        t = slice(b * n_tiles, (b + 1) * n_tiles)
        pg1, st1, ct1, _ = tcu.trim_to_capacity(s1)
        out1, kend1 = tcu.composite_fwd(attrs1[b], pg1, st1, ct1,
                                        s1.tiles_x)
        assert torch.equal(out[t], out1) and torch.equal(kend[t], kend1), b
        assert int(kend1.sum()) <= c_cap
        ch1, al1 = tcu.slot_ranges(kend1, c_cap)
        slots1 = tcu.composite_bwd(attrs1[b], pg1, st1, ct1, ch1, al1, out1,
                                   gout[t], c_cap, s1.tiles_x)
        rows = slots[b * c_cap * tcu.CHUNK:(b + 1) * c_cap * tcu.CHUNK]
        assert torch.equal(rows[:, :tcu.NGRAD], slots1[:, :tcu.NGRAD]), b
        ids, ids1 = rows[:, tcu.GID_COL], slots1[:, tcu.GID_COL]
        filled = ids1 < n
        assert bool(filled.any())
        assert torch.equal(ids[filled] - b * n, ids1[filled]), b
        assert bool((ids[~filled] == n_cams * n).all()), b


def test_render_batch_is_each_render_bitwise_and_near_jax_vmap(room):
    js, ts, jcs, tcs = room
    with torch.no_grad():
        got = trender.render_batch(ts, tcam.stack_cameras(tcs),
                                   backend="cuda", **CAP)
        for b, c in enumerate(tcs):
            one = trender.render(ts, c, backend="cuda", **CAP)
            for k in OUT_KEYS:
                assert torch.equal(got[k][b], one[k]), (b, k)
    assert got["rgb"].shape == (len(tcs), H, W, 3)
    assert got["overflow"].shape == got["grad_chunks"].shape == (len(tcs),)
    assert bool((got["grad_chunks"] > 0).all())
    # the JAX backend the cuda backend ports, vmapped (Pallas in interpret
    # mode), with test_torch_render's tolerances
    want = jax.device_get(jrender.render_batch(js, jcam.stack_cameras(jcs),
                                               backend="pallas", **CAP))
    assert got["overflow"].tolist() == np.asarray(want["overflow"]).tolist()
    for k in ("rgb", "alpha", "trans"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in ("depth_acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)
    assert (got["semantic"].numpy() == np.asarray(want["semantic"])).mean() \
        > 0.995


def test_budget_overflow_lands_on_its_camera_alone(room):
    """pair_capacity and grad_capacity are per camera: a capacity between
    the cameras' pair (chunk) counts drops pairs of the cameras above it
    alone."""
    _, ts, _, tcs = room
    cams = tcam.stack_cameras(tcs)
    with torch.no_grad():
        pairs = [int(tbin.bin_gaussians(project_gaussians(ts, c), W,
                                        H).n_pairs) for c in tcs]
        chunks = trender.render_batch(ts, cams, backend="cuda",
                                      **CAP)["grad_chunks"].tolist()
        for kw, counts in ((dict(pair_capacity=None), pairs),
                           (dict(grad_capacity=None, **CAP), chunks)):
            key = next(k for k, v in kw.items() if v is None)
            kw[key] = sorted(set(counts))[-2]   # below the largest count
            got = trender.render_batch(ts, cams, backend="cuda", **kw)
            ovf = got["overflow"].tolist()
            assert [o > 0 for o in ovf] == [c > kw[key] for c in counts], \
                (key, counts, ovf)
            for b, c in enumerate(tcs):
                one = trender.render(ts, c, backend="cuda", **kw)
                for k in OUT_KEYS:
                    assert torch.equal(got[k][b], one[k]), (key, b, k)


def test_a_batch_past_the_id_limit_renders_in_groups(room, monkeypatch):
    _, ts, _, tcs = room
    n = ts.num_gaussians
    monkeypatch.setattr(trender, "BATCH_ROWS", 2 * n + 1)
    assert trender.camera_groups(3, n) == [slice(0, 2), slice(2, 3)]
    calls = []
    render = trender.render

    def counted(scene, camera, **kw):
        calls.append(camera.position.shape[0])
        return render(scene, camera, **kw)

    monkeypatch.setattr(trender, "render", counted)
    with torch.no_grad():
        got = trender.render_batch(ts, tcam.stack_cameras(tcs),
                                   backend="cuda", **CAP)
        assert calls == [2, 1]
        for b, c in enumerate(tcs):
            one = render(ts, c, backend="cuda", **CAP)
            for k in OUT_KEYS:
                assert torch.equal(got[k][b], one[k]), (b, k)
        # the compositor refuses a batch whose rows reach the limit
        monkeypatch.setattr(tcu, "GID_LIMIT", 2 * n)
        with pytest.raises(ValueError, match="2\\^31 - 1"):
            render(ts, tcam.stack_cameras(tcs[:2]), backend="cuda", **CAP)
    with pytest.raises(ValueError, match="render_batch"):
        render(ts, tcam.stack_cameras(tcs), backend="torch")


def test_pair_count_stats_with_a_camera_axis_are_each_cameras(room):
    ones, batch = _slices(room)
    got = tbin.pair_count_stats(batch, W, H)
    for b, one in enumerate(ones):
        want = tbin.pair_count_stats(one, W, H)
        for k, v in want.items():
            assert torch.equal(got[k][b], v), (b, k)


def test_autotune_poses_is_the_same_in_any_probe_group(room, monkeypatch):
    """The probes' budgets are each statistic's worst pose, whatever the
    group size; a group holds at most PROBE_ROWS Gaussian rows."""
    _, ts, _, tcs = room
    cams = tcam.stack_cameras(tcs)
    n = ts.num_gaussians
    assert trender.camera_groups(3, n, max_rows=2 * n + 1) == [
        slice(0, 2), slice(2, 3)]
    assert trender.camera_groups(3, n, max_rows=1) == [
        slice(0, 1), slice(1, 2), slice(2, 3)]
    calls = []
    render = trender.render

    def counted(scene, camera, **kw):
        calls.append(camera.position.shape[0])
        return render(scene, camera, **kw)

    monkeypatch.setattr(trender, "render", counted)
    got = {}
    for size in (1, 2, 3):
        monkeypatch.setattr(trender, "PROBE_ROWS", size * n)
        calls.clear()
        got[size] = trender.autotune_poses(ts, cams, grad_margin=1.5)
        assert calls == [len(range(b, min(b + size, 3)))
                         for b in range(0, 3, size)]
    assert got[1] == got[2] == got[3]
    assert got[3]["grad_chunks_measured"] > 0


def test_a_batch_past_the_pair_limit_is_refused(room, monkeypatch):
    """The tile bounds and the compositor's pair indices are int32: a batch
    that keeps PAIR_LIMIT pairs or more raises, it does not wrap."""
    ones, batch = _slices(room)
    kept = int(tbin.bin_gaussians(batch, W, H).n_pairs.sum())
    monkeypatch.setattr(tbin, "PAIR_LIMIT", kept)
    with pytest.raises(ValueError, match="int32 pair index"):
        tbin.bin_gaussians(batch, W, H)
    assert int(tbin.bin_gaussians(ones[0], W, H).n_pairs) < kept


def test_apply_cmd_over_agents_is_each_agent_bitwise():
    _, grid = _walls()
    pos = torch.tensor([[0.0, -3.0, 0.5], [3.8, 0.0, 0.5], [0.5, 2.0, 0.5]])
    yaw = torch.tensor([1.57, 0.0, -2.0])
    vx = torch.tensor([0.4, 0.5, 0.05])
    wr = torch.tensor([0.3, -0.8, 0.8])
    batch = apply_cmd(init_agent(pos, yaw, device="cpu"), grid, vx, 0.0, wr,
                      1.0)
    assert bool(batch.collision_detected[1])   # walks into the wall
    for b in range(3):
        one = apply_cmd(init_agent(pos[b], yaw[b], device="cpu"), grid,
                        vx[b], 0.0, wr[b], 1.0)
        for f, x in zip(one._fields, one):
            assert torch.equal(getattr(batch, f)[b], x), (b, f)


def _walls():
    m = np.zeros((100, 100), np.uint8)
    m[:3, :] = m[-3:, :] = 1
    m[:, :3] = m[:, -3:] = 1
    bounds = [-5.0, 5.0, -4.0, 4.0]
    return jgrid(m, bounds=bounds), tgrid(m, bounds=bounds, device="cpu")


def test_lockstep_rollout_batch_matches_singles_and_jax_vmap(room):
    js, ts, _, _ = room
    jg, tg = _walls()
    starts = np.array([[0.0, -3.0], [0.5, -2.5], [-1.0, 1.0]], np.float32)
    yaws = np.array([1.57, 1.3, -0.5], np.float32)
    goals = np.array([[2.0, 2.0], [-2.0, 2.0], [1.0, -2.0]], np.float32)
    kw = dict(n_steps=5, width=W, height=H, use_capsule=True, **CAP,
              tile_capacity=512)
    accel = taccel(ts, chunk=128, device="cpu")
    for extra in ({"backend": "cuda"}, {"collision_accel": accel}):
        got = troll.rollout_batch(ts, tg, starts, yaws, goals,
                                  batch_mode="vmap", device="cpu",
                                  **kw, **extra)
        assert got["positions"].shape == (3, 5, 3)
        assert got["total_overflow"].tolist() == [0, 0, 0]
        for b in range(3):
            one = troll.rollout(ts, tg, starts[b], yaws[b], goals[b],
                                device="cpu", **kw, **extra)
            for k in one:
                assert torch.equal(got[k][b], one[k]), (extra, b, k)
    want = jroll.rollout_batch(js, jg, starts, yaws, goals, backend="xla",
                               batch_mode="vmap", **kw)
    got = troll.rollout_batch(ts, tg, starts, yaws, goals, device="cpu", **kw)
    np.testing.assert_array_equal(got["collisions"].numpy(),
                                  np.asarray(want["collisions"]))
    for k in ("positions", "final_pos", "goal_distance", "min_clearance"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=POS_TOL, atol=POS_TOL, err_msg=k)


def test_batched_train_step_matches_the_per_camera_loop(room):
    _, ts, _, tcs = room
    cams = tcam.stack_cameras(tcs)
    with torch.no_grad():
        targets = trender.render_batch(ts, cams, backend="cuda",
                                       **CAP)["rgb"] * 0.9 + 0.05
    opt = ttrain.make_group_optimizer()
    step, _ = ttrain.make_train_step(ts, tcs[0], optimizer=opt,
                                     backend="cuda", **CAP)
    state = ttrain.init_train_state(ts, opt)
    ref = {k: v.detach().clone().requires_grad_(True)
           for k, v in state.params.items()}
    _, loss = step(state, cams, targets)
    n_px = targets.numel()
    want = 0.0
    for c, tgt in zip(tcs, targets):
        out = trender.render(ttrain.with_params(ts, ref), c, backend="cuda",
                             **CAP)
        err = torch.sum((out["rgb"] - tgt) ** 2)
        (err / n_px).backward()
        want += float(err.detach())
    want /= n_px
    assert abs(float(loss) - want) <= LOSS_REL * want
    for k in PARAMS:
        g, r = state.params[k].grad, ref[k].grad
        scale = float(r.abs().max())
        assert scale > 0, k
        assert float((g - r).abs().max()) <= GRAD_REL * scale, k
