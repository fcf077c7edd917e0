"""The port's K2 anatomy probe against the JAX probe on the CPU.

``sage3d_tpu_torch.benchmarks.kernel_anatomy.variant_plain`` (the probe
kernel's plain version, which the wrapper runs for CPU tensors) is held
against ``benchmarks/kernel_anatomy.py``'s ``_variant_kernel`` (Pallas in
interpret mode) for each of the six timed flag sets and for a batch of 2
copies, on a frame whose tiles have several chunks and stop early.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.ops import binning as jbin
from sage3d_tpu.ops import composite_pallas as jpal
from sage3d_tpu.ops.projection import project_gaussians
from sage3d_tpu.renderer.camera import make_camera
from sage3d_tpu.renderer.scene import GaussianScene
from sage3d_tpu_torch.benchmarks import kernel_anatomy as tka
from sage3d_tpu_torch.ops import composite_cuda as tcu

REPO = Path(__file__).resolve().parent.parent
# K2's tolerances (tests/test_torch_composite.py): f32 sums in another order
# and XLA's exp against torch's.
TOL = {"rgb_alpha_trans_bestw": 1e-4, "depth": 1e-3, "semantic": 0.995}
# The stub variants, on channels 0-6 (rtol = atol): 1e-6 without the scan.
# The no-exp stub's alpha is |op * (a*px + c*py + b)| * 1e-3, a sum that
# nearly cancels where alpha is small. XLA's CPU backend contracts it into
# fused multiply-adds (a quarter of such sums differ in their last bit from
# unfused f32), the port does not (K2's -fmad=false), and every pair of the
# stub has alpha > 0, so the differences compound through 4 chunks of T:
# measured 4.35e-6 on the trans channel (T = 0.946 there), held to 1e-5.
STUB_TOL = {"no transmittance scan": 1e-6, "no exp (quadratic stub)": 1e-5}


def _jax_anatomy():
    """The JAX probe module, imported as its own script imports it."""
    for p in (str(REPO), str(REPO / "benchmarks")):
        if p not in sys.path:
            sys.path.insert(0, p)
    return importlib.import_module("kernel_anatomy")


def _wall_scene(n=600, seed=3):
    """A dense wall of opaque Gaussians in a narrow camera's view: each of
    the 4 tiles has ~390 pairs (4 chunks) and saturates before its last."""
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


@pytest.fixture(scope="module")
def frame():
    """The wall frame's K2 inputs, as numpy: the attribute table, the pair
    list, tile ranges, and the JAX probe's packed pair features (packed as
    its ``main`` packs them)."""
    scene = _wall_scene()
    cam = make_camera(position=[0.0, -2.0, 1.0], forward=[0.0, 1.0, 0.0],
                      width=64, height=64, focal_mm=30.0)
    proj = project_gaussians(scene, cam)
    budgets = jbin.suggest_budgets(proj, cam.width, cam.height)
    bins = jbin.bin_gaussians(proj, cam.width, cam.height,
                              k_small=budgets["k_small"], m_big=budgets["m_big"],
                              k_big=budgets["k_big"], m_mid=budgets["m_mid"],
                              k_mid=budgets["k_mid"])
    n = proj.depths.shape[0]
    attrs = jnp.stack([
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        proj.means2d[:, 0], proj.means2d[:, 1], proj.opacities,
        proj.colors[:, 0], proj.colors[:, 1], proj.colors[:, 2], proj.depths,
        scene.semantic_ids.astype(jnp.float32), jnp.arange(n, dtype=jnp.float32),
        *([jnp.zeros((n,), jnp.float32)] * 4)], axis=1)
    pair_cap = bins.pair_gauss.shape[0]
    n_blocks = pair_cap // jpal.CHUNK + jpal.GUARD_BLOCKS
    idx = jnp.concatenate([bins.pair_gauss, jnp.zeros(
        (n_blocks * jpal.CHUNK - pair_cap,), jnp.int32)])
    feats3 = attrs[idx].reshape(n_blocks, jpal.CHUNK, jpal.NFEAT).transpose(0, 2, 1)
    count = jnp.minimum(bins.tile_count, 4096).astype(jnp.int32)
    return {k: np.array(v) for k, v in dict(
        attrs=attrs, pair_gauss=bins.pair_gauss, tile_start=bins.tile_start,
        tile_count=count, feats3=feats3).items()} | {
            "tiles_x": bins.tiles_x, "n_tiles": bins.tiles_x * bins.tiles_y}


def _torch_args(f):
    return tuple(torch.from_numpy(f[k]) for k in
                 ("attrs", "pair_gauss", "tile_start", "tile_count"))


def _assert_probe_close(got, want, stub_tol=None):
    """K2's tolerances per channel, and ``stub_tol`` (rtol = atol) on
    channels 0-6 where given."""
    for ch in (0, 1, 2, 4, 5, 6):       # rgb, alpha, trans, best weight
        tol = TOL["rgb_alpha_trans_bestw"]
        np.testing.assert_allclose(got[..., ch, :], want[..., ch, :],
                                   rtol=tol, atol=tol, err_msg=f"channel {ch}")
    np.testing.assert_allclose(got[..., 3, :], want[..., 3, :],
                               rtol=TOL["depth"], atol=TOL["depth"])
    assert (got[..., 7, :] == want[..., 7, :]).mean() >= TOL["semantic"]
    if stub_tol is not None:
        np.testing.assert_allclose(got[..., :7, :], want[..., :7, :],
                                   rtol=stub_tol, atol=stub_tol)


def test_frame_has_long_tiles_that_stop_early(frame):
    _, kend = tcu.composite_fwd_plain(*_torch_args(frame), frame["tiles_x"])
    n_chunks = -(-frame["tile_count"] // tcu.CHUNK)
    assert n_chunks.max() >= 3
    assert (kend.numpy() < n_chunks).any()


@pytest.mark.parametrize("name", list(tka.VARIANTS))
def test_variant_plain_matches_jax_probe(frame, name):
    flags = tka.VARIANTS[name]
    ka = _jax_anatomy()
    want = np.asarray(jax.device_get(ka.make_variant(
        frame["n_tiles"], frame["tiles_x"], **flags)(
        frame["feats3"], frame["tile_start"], frame["tile_count"])))
    call = tka.make_variant(frame["n_tiles"], frame["tiles_x"], **flags)
    before = tka.composite_anatomy.launches
    got = call(*_torch_args(frame)).numpy()
    assert tka.composite_anatomy.launches == before     # the plain version ran
    assert got.shape == want.shape == (frame["n_tiles"], tcu.NCH, tcu.NPIX)
    _assert_probe_close(got, want, STUB_TOL.get(name))
    if not flags["do_argmax"]:
        assert (got[:, 6] == 0).all() and (got[:, 7] == -1).all()


def test_production_variant_is_k2_plain(frame):
    args = _torch_args(frame)
    got = tka.make_variant(frame["n_tiles"], frame["tiles_x"],
                           **tka.VARIANTS[tka.PRODUCTION])(*args)
    want, _ = tcu.composite_fwd_plain(*args, frame["tiles_x"])
    assert torch.equal(got, want)


def test_batched_variant_matches_jax_vmap(frame):
    flags = tka.VARIANTS[tka.PRODUCTION]
    ka = _jax_anatomy()
    jargs = [np.broadcast_to(frame[k][None], (2,) + frame[k].shape)
             for k in ("feats3", "tile_start", "tile_count")]
    want = np.asarray(jax.device_get(jax.vmap(ka.make_variant(
        frame["n_tiles"], frame["tiles_x"], **flags))(*jargs)))
    copies = [x[None].expand(2, *x.shape).contiguous()
              for x in _torch_args(frame)]
    got = tka.make_variant(frame["n_tiles"], frame["tiles_x"], batch=2,
                           **flags)(*copies)
    assert got.shape == want.shape == (2, frame["n_tiles"], tcu.NCH, tcu.NPIX)
    _assert_probe_close(got.numpy(), want)
    one = tka.make_variant(frame["n_tiles"], frame["tiles_x"],
                           **flags)(*_torch_args(frame))
    assert torch.equal(got[0], one) and torch.equal(got[1], one)


def test_measure_reports_variants_batch_and_deltas(frame):
    """``measure`` on the CPU (plain versions, host clock): every variant,
    the batch ratio, and each delta as the baseline's time less its
    variant's."""
    inputs = dict(zip(("attrs", "pair_gauss", "tile_start", "tile_count"),
                      _torch_args(frame)), tiles_x=frame["tiles_x"],
                  n_tiles=frame["n_tiles"])
    r = tka.measure(inputs, iters=1, batch=2)
    assert list(r["variants"]) == list(tka.VARIANTS)
    assert all(v["ms"] > 0 and v["registers"] is None
               for v in r["variants"].values())
    base = r["variants"][tka.BASELINE]["ms"]
    assert r["deltas_ms"] == {d: base - r["variants"][v]["ms"]
                              for d, v in tka.DELTAS.items()}
    prod = r["variants"][tka.PRODUCTION]["ms"]
    assert r["batch"]["copies"] == 2
    assert r["batch"]["ratio_to_single"] == pytest.approx(
        r["batch"]["ms"] / (2 * prod))


def test_probe_refuses_other_flag_sets_and_shapes(frame):
    with pytest.raises(ValueError, match="no probe variant"):
        tka.make_variant(4, 2, early_term=True, do_exp=False, do_scan=True,
                         do_blend=True, do_argmax=True)
    call = tka.make_variant(frame["n_tiles"] + 1, frame["tiles_x"],
                            **tka.BASE)
    with pytest.raises(ValueError, match="tiles"):
        call(*_torch_args(frame))
    with pytest.raises(ValueError):
        tka.composite_anatomy(*_torch_args(frame), frame["tiles_x"],
                              early_term=True)
