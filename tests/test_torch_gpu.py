"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Without a CUDA device each test skips itself with the reason.
"""

import numpy as np
import pytest
import torch

from sage3d_tpu_torch.ops import binning, composite_cuda
from sage3d_tpu_torch.ops.projection import project_gaussians
from sage3d_tpu_torch.renderer import render as trender
from sage3d_tpu_torch.renderer.camera import make_camera
from sage3d_tpu_torch.renderer.scene import synthetic_room

pytestmark = pytest.mark.gpu


def _need_card(what: str):
    if not torch.cuda.is_available():
        pytest.skip(f"needs a CUDA device: {what} is a CUDA kernel")


def _frame(n=20_000, width=320, height=256, seed=5):
    scene = synthetic_room(n, seed=seed, device="cuda")
    cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], width, height,
                      device="cuda")
    return scene, cam, trender.budget_kwargs(trender.autotune_all(scene, cam))


@pytest.mark.parametrize("width,height", [(320, 256), (3840, 2160)])
def test_emit_kernel_matches_plain(width, height):
    _need_card("K1")
    scene, cam, bk = _frame(width=width, height=height)
    with torch.no_grad():
        plan = binning.emission_plan(
            project_gaussians(scene, cam), width, height,
            **{k: bk[k] for k in binning.EMIT_BUDGET_KEYS})
    n_tiles = plan.tiles_x * plan.tiles_y
    for mult in {plan.mult, 0}:
        for t in plan.tiers:
            want = binning.emit_tile_keys_plain(t.attrs, t.rank, t.k_budget,
                                                plan.tiles_x, n_tiles, mult)
            got = binning.emit_tile_keys(t.attrs, t.rank, t.k_budget,
                                         plan.tiles_x, n_tiles, mult)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


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


def test_cuda_backend_refuses_gradients():
    _need_card("the cuda backend")
    scene, cam, bk = _frame(n=2000)
    means = scene.means.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="K3"):
        trender.render(scene._replace(means=means), cam, backend="cuda", **bk)
