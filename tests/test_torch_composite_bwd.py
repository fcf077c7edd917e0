"""The port's compositor backward (K3 and K4 through their plain versions on
the CPU) against the JAX package's ``custom_vjp`` (``_get_attr_composite``,
Pallas in interpret mode), and the ``cuda`` render path's gradients against
JAX ``render(backend="pallas")`` and the oracle."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.ops import composite_pallas as jpal
from sage3d_tpu.renderer import camera as jcam
from sage3d_tpu.renderer import render as jrender
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.ops import composite_cuda as tcu
from sage3d_tpu_torch.renderer import camera as tcam
from sage3d_tpu_torch.renderer import render as trender
from sage3d_tpu_torch.renderer.scene import scene_from_numpy
from test_torch_composite import CASES, _setup

W, H = 64, 48
PARAMS = ("means", "log_scales", "quats", "opacity_logits", "sh")
# Normalized by each channel's max |JAX gradient|: f32 sums in another order;
# one float16 rounding (2^-11 of the channel absmax); one bfloat16 rounding.
MODE_TOL = {"f32": 3e-4, "f16": 2e-3, "bf16": 2e-2}


def _attr_case(case):
    """The attribute table, the pair lists and a seeded cotangent, as numpy,
    plus the JAX compositor's static shape arguments."""
    _, _, proj, bins, tproj, tbins, sem = _setup(case)
    n = proj.depths.shape[0]
    n_tiles = bins.tiles_x * bins.tiles_y
    p = bins.pair_gauss.shape[0]
    attrs = tcu.attribute_table(tproj, torch.from_numpy(np.array(sem))).numpy()
    count = np.minimum(np.asarray(bins.tile_count), 4096).astype(np.int32)
    gout = np.random.default_rng(7).normal(
        size=(n_tiles, tcu.NCH, tcu.NPIX)).astype(np.float32)
    return dict(attrs=attrs, pg=np.asarray(bins.pair_gauss),
                start=np.asarray(bins.tile_start), count=count, gout=gout,
                n=n, n_tiles=n_tiles, tiles_x=bins.tiles_x,
                n_blocks=p // jpal.CHUNK + jpal.GUARD_BLOCKS,
                c_cap=p // jpal.CHUNK + n_tiles)


@functools.lru_cache(maxsize=None)
def _jax_vjp(case, mode):
    """d_attrs and k_end of the JAX compositor on ``_attr_case(case)``."""
    c = _attr_case(case)
    flat = jpal._get_attr_composite(c["n_tiles"], c["tiles_x"], c["n_blocks"],
                                    c["c_cap"], c["n"], True, mode)
    (out, kend), vjp = jax.vjp(
        lambda a: flat(a, c["pg"], c["start"], c["count"]), c["attrs"])
    (d,) = vjp((jnp.asarray(c["gout"]), np.zeros(kend.shape, jax.dtypes.float0)))
    return np.asarray(d), np.asarray(kend)


def _port_vjp(c, mode, scale=1.0):
    attrs = torch.from_numpy(c["attrs"]).requires_grad_()
    out, kend = tcu.attr_composite(
        attrs, *(torch.from_numpy(np.array(c[k])) for k in ("pg", "start",
                                                            "count")),
        c["tiles_x"], c["c_cap"], mode)
    assert not kend.requires_grad
    out.backward(torch.from_numpy(c["gout"] * np.float32(scale)))
    return attrs.grad.numpy(), kend.numpy()


def _assert_channels_close(got, want, tol):
    assert np.abs(got[:, tcu.NGRAD:]).max() == 0.0
    for ch in range(tcu.NGRAD):
        scale = np.abs(want[:, ch]).max()
        assert scale > 0, ch
        np.testing.assert_allclose(got[:, ch] / scale, want[:, ch] / scale,
                                   atol=tol, err_msg=f"channel {ch}")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", list(MODE_TOL))
def test_attr_composite_vjp_matches_pallas(case, mode):
    want, want_kend = _jax_vjp(case, mode)
    got, kend = _port_vjp(_attr_case(case), mode)
    np.testing.assert_array_equal(kend, want_kend)
    _assert_channels_close(got, want, MODE_TOL[mode])


def test_f16_sort_is_loss_scale_invariant():
    # 1e8 cotangents overflow raw float16 rows; the absmax scaling absorbs it
    c = _attr_case("room")
    base, _ = _port_vjp(c, "f16")
    huge, _ = _port_vjp(c, "f16", scale=1e8)
    assert np.isfinite(huge).all()
    _assert_channels_close(huge, base * 1e8, MODE_TOL["f16"])
    _assert_channels_close(huge, _jax_vjp("room", "f16")[0] * 1e8,
                           MODE_TOL["f16"])


def test_slot_rows_and_packing():
    c = _attr_case("wall")
    attrs = torch.from_numpy(c["attrs"])
    args = [torch.from_numpy(np.array(c[k])) for k in ("pg", "start", "count")]
    out, kend = tcu.composite_fwd(attrs, *args, c["tiles_x"])
    chunk0, allowed = tcu.slot_ranges(kend, c["c_cap"])
    assert torch.equal(allowed, kend)
    assert torch.equal(chunk0[1:], torch.cumsum(kend, 0)[:-1].int())
    slots = tcu.composite_bwd(attrs, *args, chunk0, allowed, out,
                              torch.from_numpy(c["gout"]), c["c_cap"],
                              c["tiles_x"])
    used = int(kend.sum()) * tcu.CHUNK
    assert slots.shape == (c["c_cap"] * tcu.CHUNK, tcu.NFEAT)
    # untouched slots: zero payload and the out-of-range id N
    assert float(slots[used:, :tcu.NGRAD].abs().max()) == 0.0
    assert bool((slots[used:, tcu.GID_COL] == c["n"]).all())
    ids = slots[:used, tcu.GID_COL]
    written = slots[:used, :tcu.NGRAD].abs().sum(1) > 0
    assert bool(written.any())
    # every row of a walked chunk names the Gaussian of its pair
    rows = []
    for t in range(c["n_tiles"]):
        for k in range(int(kend[t])):
            n_valid = min(int(c["count"][t]) - k * tcu.CHUNK, tcu.CHUNK)
            base = (int(chunk0[t]) + k) * tcu.CHUNK
            first = int(c["start"][t]) + k * tcu.CHUNK
            gids = c["pg"][first:first + n_valid]
            # lanes past the last pair: zero payload and the id N
            rows.append((base, np.concatenate(
                [gids, np.full(tcu.CHUNK - n_valid, c["n"])])))
            assert float(slots[base + n_valid:base + tcu.CHUNK,
                               :tcu.NGRAD].abs().sum()) == 0.0
    for base, gids in rows:
        np.testing.assert_array_equal(ids[base:base + len(gids)].numpy(),
                                      gids.astype(np.float32))
    # a capacity below the chunk total cuts the last tiles' slots
    chunk0_s, allowed_s = tcu.slot_ranges(kend, 2)
    assert int(allowed_s.sum()) == 2
    assert int((chunk0_s + allowed_s)[allowed_s > 0].max()) <= 2


def _render_case():
    js = synthetic_room(num_gaussians=400, seed=5)
    ts = scene_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          device="cpu")
    jc = jcam.make_camera(position=[0.0, -4.0, 1.2], forward=[0.0, 1.0, -0.1],
                          width=W, height=H)
    tc = tcam.camera_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in
         ("position", "cam_to_world", "fx", "fy", "cx", "cy")}
        | {"width": W, "height": H}, device="cpu")
    return js, ts, jc, tc


def _port_grads(ts, tc, target, **kw):
    params = {k: getattr(ts, k).clone().requires_grad_() for k in PARAMS}
    out = trender.render(ts._replace(**params), tc, backend="cuda", **kw)
    loss = (torch.mean((out["rgb"] - torch.from_numpy(target)) ** 2)
            + 0.05 * torch.mean(out["depth_acc"])
            + 0.02 * torch.mean(out["alpha"])
            + 0.01 * torch.mean(out["trans"]))
    loss.backward()
    return {k: params[k].grad.numpy() for k in PARAMS}, out


def test_cuda_render_gradients_match_pallas_and_oracle():
    js, ts, jc, tc = _render_case()
    target = np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32)

    def jloss(p, backend):
        out = jrender.render(js._replace(**p), jc, backend=backend,
                             pair_capacity=1 << 14, grad_sort="f32")
        return (jnp.mean((out["rgb"] - target) ** 2)
                + 0.05 * jnp.mean(out["depth_acc"])
                + 0.02 * jnp.mean(out["alpha"])
                + 0.01 * jnp.mean(out["trans"]))

    jp = {k: getattr(js, k) for k in PARAMS}
    g_pal = jax.grad(lambda p: jloss(p, "pallas"))(jp)
    g_or = jax.grad(lambda p: jloss(p, "oracle"))(jp)
    got, out = _port_grads(ts, tc, target, pair_capacity=1 << 14)
    assert int(out["overflow"]) == 0
    for k in PARAMS:
        for want in (np.asarray(g_pal[k]), np.asarray(g_or[k])):
            scale = np.abs(want).max() + 1e-8
            np.testing.assert_allclose(got[k] / scale, want / scale,
                                       atol=3e-4, err_msg=k)


def test_default_mode_is_f32_and_tight_capacity_is_exact():
    _, ts, _, tc = _render_case()
    target = np.zeros((H, W, 3), np.float32)
    kw = dict(pair_capacity=1 << 14)
    g_default, out = _port_grads(ts, tc, target, **kw)
    g_f32, _ = _port_grads(ts, tc, target, grad_sort="f32", **kw)
    g_bf16, _ = _port_grads(ts, tc, target, grad_sort_bf16=True, **kw)
    for k in PARAMS:
        np.testing.assert_array_equal(g_default[k], g_f32[k])
    assert max(np.abs(g_bf16[k] - g_f32[k]).max() for k in PARAMS) > 0
    chunks = int(out["grad_chunks"])
    assert chunks > 0 and int(out["overflow"]) == 0
    g_tight, out_t = _port_grads(ts, tc, target, grad_capacity=chunks, **kw)
    assert int(out_t["overflow"]) == 0
    for k in PARAMS:
        np.testing.assert_array_equal(g_tight[k], g_f32[k])
    _, out_s = _port_grads(ts, tc, target, grad_capacity=max(chunks // 2, 1),
                           **kw)
    assert int(out_s["overflow"]) > 0
    with pytest.raises(ValueError, match="grad_sort"):
        trender.render(ts, tc, backend="cuda", grad_sort="f8", **kw)


def test_autotune_grad_margin_budgets_train_cleanly():
    js, ts, jc, tc = _render_case()
    budgets = trender.autotune_all(ts, tc, grad_margin=1.25)
    assert budgets == jrender.autotune_all(js, jc, grad_margin=1.25)
    assert budgets["grad_capacity"] >= budgets["grad_chunks_measured"]
    op = ts.opacity_logits.clone().requires_grad_()
    out = trender.render(ts._replace(opacity_logits=op), tc, backend="cuda",
                         **trender.budget_kwargs(budgets))
    torch.mean(out["rgb"] ** 2).backward()
    assert int(out["overflow"]) == 0
    assert torch.isfinite(op.grad).all() and float(op.grad.abs().max()) > 0
