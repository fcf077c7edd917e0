"""Parity of the port's compositors with the JAX package on the CPU.

K2's plain version is held against the JAX forward kernel
(``_get_attr_composite``, Pallas in interpret mode) called directly, and the
``torch`` compositor against the JAX ``xla`` compositor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.ops import binning as jbin
from sage3d_tpu.ops import composite_pallas as jpal
from sage3d_tpu.ops import composite_xla as jxla
from sage3d_tpu.ops.projection import project_gaussians
from sage3d_tpu.renderer.camera import make_camera
from sage3d_tpu.renderer.scene import GaussianScene, synthetic_room
from sage3d_tpu_torch.ops import binning as tbin
from sage3d_tpu_torch.ops import composite_cuda as tcu
from sage3d_tpu_torch.ops import composite_torch as tct
from sage3d_tpu_torch.ops.projection import ProjectedGaussians


def _wall_scene(n=600, seed=3):
    """A dense wall of opaque Gaussians filling a narrow camera's view: every
    tile saturates after a chunk or two of its ~390 pairs, so the per-tile
    early termination stops before the last chunk."""
    rng = np.random.default_rng(seed)
    means = np.array([0.0, 0.0, 1.0]) + rng.normal(0, 1, (n, 3)) * [1.0, 0.05, 1.0]
    op = rng.uniform(0.6, 0.95, n)
    sh = np.zeros((n, 1, 3))
    sh[:, 0, :] = (rng.uniform(0.1, 0.9, (n, 3)) - 0.5) / 0.28209479177387814
    return GaussianScene(
        means=jnp.asarray(means, jnp.float32),
        log_scales=jnp.log(jnp.full((n, 3), 0.3, jnp.float32)),
        quats=jnp.asarray(np.tile([1.0, 0, 0, 0], (n, 1)), jnp.float32),
        opacity_logits=jnp.asarray(np.log(op / (1 - op)), jnp.float32),
        sh=jnp.asarray(sh, jnp.float32),
        semantic_ids=jnp.arange(n, dtype=jnp.int32) % 7,
    )


def _room_case():
    cam = make_camera(position=[0.0, -4.0, 1.2], forward=[0.0, 1.0, -0.1],
                      width=64, height=48)
    return synthetic_room(num_gaussians=400, seed=5), cam


def _wall_case():
    cam = make_camera(position=[0.0, -2.0, 1.0], forward=[0.0, 1.0, 0.0],
                      width=64, height=64, focal_mm=30.0)
    return _wall_scene(), cam


CASES = {"room": _room_case, "wall": _wall_case}


def _setup(case):
    scene, cam = CASES[case]()
    proj = project_gaussians(scene, cam)
    budgets = jbin.suggest_budgets(proj, cam.width, cam.height)
    bins = jbin.bin_gaussians(proj, cam.width, cam.height,
                              k_small=budgets["k_small"], m_big=budgets["m_big"],
                              k_big=budgets["k_big"], m_mid=budgets["m_mid"],
                              k_mid=budgets["k_mid"])
    tproj = ProjectedGaussians(*(torch.from_numpy(np.array(x)) for x in proj))
    tbins = tbin.TileBins(*(torch.from_numpy(np.array(x)) for x in bins[:5]),
                          bins.tiles_x, bins.tiles_y)
    sem = scene.semantic_ids
    return scene, cam, proj, bins, tproj, tbins, sem


def _assert_images_close(got, want, sem_min=0.995):
    for k in ("rgb", "alpha", "trans"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["depth_acc"].numpy(),
                               np.asarray(want["depth_acc"]), rtol=1e-3, atol=1e-3)
    agree = (got["semantic"].numpy() == np.asarray(want["semantic"])).mean()
    assert agree >= sem_min


@pytest.mark.parametrize("case", list(CASES))
def test_k2_plain_matches_pallas_forward_kernel(case):
    _, _, proj, bins, tproj, tbins, sem = _setup(case)
    n = proj.depths.shape[0]
    n_tiles = bins.tiles_x * bins.tiles_y
    p = bins.pair_gauss.shape[0]
    attrs = jnp.stack([
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        proj.means2d[:, 0], proj.means2d[:, 1], proj.opacities,
        proj.colors[:, 0], proj.colors[:, 1], proj.colors[:, 2], proj.depths,
        sem.astype(jnp.float32), jnp.arange(n, dtype=jnp.float32),
        *([jnp.zeros((n,), jnp.float32)] * 4)], axis=1)
    count_c = jnp.minimum(bins.tile_count, 4096).astype(jnp.int32)
    flat = jpal._get_attr_composite(n_tiles, bins.tiles_x,
                                    p // jpal.CHUNK + jpal.GUARD_BLOCKS,
                                    p // jpal.CHUNK + n_tiles, n, True, "f32")
    want_out, want_kend = jax.device_get(
        flat(attrs, bins.pair_gauss, bins.tile_start, count_c))

    t_attrs = tcu.attribute_table(tproj, torch.from_numpy(np.array(sem)))
    np.testing.assert_array_equal(t_attrs.numpy(), np.asarray(attrs))
    out, kend = tcu.composite_fwd(t_attrs, tbins.pair_gauss, tbins.tile_start,
                                  torch.from_numpy(np.array(count_c)),
                                  bins.tiles_x)
    assert out.shape == (n_tiles, tcu.NCH, tcu.NPIX)
    np.testing.assert_array_equal(kend.numpy(), want_kend)
    out, want_out = out.numpy(), np.asarray(want_out)
    for ch in (0, 1, 2, 4, 5, 6):       # rgb, alpha, trans, best weight
        np.testing.assert_allclose(out[:, ch], want_out[:, ch], rtol=1e-4,
                                   atol=1e-4, err_msg=f"channel {ch}")
    np.testing.assert_allclose(out[:, 3], want_out[:, 3], rtol=1e-3, atol=1e-3)
    assert (out[:, 7] == want_out[:, 7]).mean() >= 0.995
    if case == "wall":   # some tile stopped early, before its last chunk
        n_chunks = -(-np.asarray(count_c) // tcu.CHUNK)
        assert (want_kend < n_chunks).any()


@pytest.mark.parametrize("case,kw", [
    ("room", {}),
    ("room", {"pair_capacity": 256}),               # trims the pair list
    ("wall", {"pair_capacity": 1 << 16}),
    ("wall", {"pair_capacity": 1 << 16, "grad_capacity": 2}),   # tight
])
def test_composite_tiles_cuda_matches_pallas(case, kw):
    scene, cam, proj, bins, tproj, tbins, sem = _setup(case)
    want = jax.device_get(jpal.composite_tiles_pallas(
        proj, sem, bins, cam.width, cam.height, tile_capacity=1024, **kw))
    got = tcu.composite_tiles_cuda(tproj, torch.from_numpy(np.array(sem)), tbins,
                                   cam.width, cam.height, tile_capacity=1024,
                                   **kw)
    assert got["rgb"].shape == (1, cam.height, cam.width, 3)
    got = {k: v[0] for k, v in got.items()}     # the one camera
    assert int(got["grad_chunks"]) == int(want["grad_chunks"])
    assert int(got["tile_overflow"]) == int(want["tile_overflow"])
    if kw.get("pair_capacity") == 256 or kw.get("grad_capacity"):
        assert int(got["tile_overflow"]) > 0
    _assert_images_close(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_torch_compositor_matches_xla(case):
    scene, cam, proj, bins, tproj, tbins, sem = _setup(case)
    want = jax.device_get(jxla.composite_tiles(proj, sem, bins, cam.width,
                                               cam.height, tile_capacity=1024))
    got = tct.composite_tiles(tproj, torch.from_numpy(np.array(sem)), tbins,
                              cam.width, cam.height, tile_capacity=1024,
                              tile_batch=3)
    assert int(got["tile_overflow"]) == int(want["tile_overflow"])
    _assert_images_close(got, want)
    small = tct.composite_tiles(tproj, torch.from_numpy(np.array(sem)), tbins,
                                cam.width, cam.height, tile_capacity=128)
    assert int(small["tile_overflow"]) == int(jax.device_get(jxla.composite_tiles(
        proj, sem, bins, cam.width, cam.height,
        tile_capacity=128)["tile_overflow"]))


def test_quad_coeffs_and_pixel_basis_match(rng):
    m = rng.uniform(-5, 40, (30, 2)).astype(np.float32)
    c = rng.uniform(0.01, 0.5, (30, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tct.quad_coeffs(torch.from_numpy(m), torch.from_numpy(c)).numpy(),
        np.asarray(jxla.quad_coeffs(m, c)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tct.pixel_basis(32, 32).numpy(),
                                  np.asarray(jxla.pixel_basis(32, 32)))


def test_cuda_backend_gradient_matches_pallas():
    _, cam, proj, bins, tproj, tbins, sem = _setup("room")
    fields = ("means2d", "conics", "opacities", "colors", "depths")
    wts = np.random.default_rng(2).normal(
        size=(cam.height, cam.width, 3)).astype(np.float32)

    def jloss(p):
        out = jpal.composite_tiles_pallas(proj._replace(**p), sem, bins,
                                          cam.width, cam.height)
        return jnp.sum(out["rgb"] * wts) + 0.1 * jnp.sum(out["depth_acc"]) \
            + 0.2 * jnp.sum(out["alpha"]) - 0.3 * jnp.sum(out["trans"])

    want = jax.grad(jloss)({f: getattr(proj, f) for f in fields})
    p = {f: getattr(tproj, f).clone().requires_grad_() for f in fields}
    out = tcu.composite_tiles_cuda(tproj._replace(**p),
                                   torch.from_numpy(np.array(sem)), tbins,
                                   cam.width, cam.height)
    out = {k: v[0] for k, v in out.items()}     # the one camera
    (torch.sum(out["rgb"] * torch.from_numpy(wts))
     + 0.1 * torch.sum(out["depth_acc"]) + 0.2 * torch.sum(out["alpha"])
     - 0.3 * torch.sum(out["trans"])).backward()
    for f in fields:
        w = np.asarray(want[f])
        scale = np.abs(w).max()
        assert scale > 0, f
        np.testing.assert_allclose(p[f].grad.numpy() / scale, w / scale,
                                   atol=3e-4, err_msg=f)


def test_k2_wrapper_checks_inputs():
    attrs = torch.zeros((4, 16))
    i32 = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        tcu.composite_fwd(attrs[:, :11], i32, i32, i32, 1)
    with pytest.raises(ValueError):
        tcu.composite_fwd(attrs, i32.long(), i32, i32, 1)
    with pytest.raises(ValueError):
        tcu.composite_fwd(attrs, i32, i32, i32[:2], 1)
    before = tcu.composite_fwd.launches
    out, kend = tcu.composite_fwd(attrs, i32, i32, i32, 3)
    assert tcu.composite_fwd.launches == before     # the plain version ran
    assert out.shape == (3, 8, 1024) and kend.tolist() == [0, 0, 0]
    assert float(out[:, 5].min()) == 1.0 and float(out[:, 7].max()) == -1.0


def test_k2_wrapper_refuses_misaligned_attrs():
    # the kernel reads attribute rows as float4: a table 4 bytes off a
    # 16-byte boundary is refused on every device, before the dispatch
    attrs = torch.zeros(4 * 16 + 1)[1:].view(4, 16)
    assert attrs.data_ptr() % 16
    i32 = torch.zeros((3,), dtype=torch.int32)
    before = tcu.composite_fwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        tcu.composite_fwd(attrs, i32, i32, i32, 3)
    out, _ = tcu.composite_fwd(attrs.clone(), i32, i32, i32, 3)
    assert tcu.composite_fwd.launches == before
    assert out.shape == (3, 8, 1024)
