"""Parity of the PyTorch port's SH, projection and oracle compositor with the
JAX package, on the CPU, from the same numpy inputs."""

import numpy as np
import pytest
import torch

from sage3d_tpu.ops import composite_ref as jref
from sage3d_tpu.ops import projection as jproj
from sage3d_tpu.ops import sh as jsh
from sage3d_tpu.renderer.camera import make_camera
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.ops import composite_ref as tref
from sage3d_tpu_torch.ops import projection as tproj
from sage3d_tpu_torch.ops import sh as tsh
from sage3d_tpu_torch.renderer.camera import camera_from_numpy
from sage3d_tpu_torch.renderer.scene import scene_from_numpy

W, H = 64, 48


def _np(x):
    return x.detach().cpu().numpy()


def _port(scene, cam):
    ts = scene_from_numpy({f: np.asarray(getattr(scene, f))
                           for f in scene._fields}, device="cpu")
    tc = camera_from_numpy({f: np.asarray(getattr(cam, f)) for f in
                            ("position", "cam_to_world", "fx", "fy", "cx", "cy")}
                           | {"width": cam.width, "height": cam.height,
                              "near": cam.near, "far": cam.far}, device="cpu")
    return ts, tc


def _cam(width=W, height=H):
    return make_camera(position=[0.0, -4.0, 1.2], forward=[0.0, 1.0, -0.1],
                       width=width, height=height)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches(deg, rng):
    k = (deg + 1) ** 2
    sh = rng.normal(size=(200, k, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = tsh.eval_sh(torch.from_numpy(sh), torch.from_numpy(d), deg)
    want = jsh.eval_sh(sh, d, deg)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("deg,width,height", [(0, W, H), (3, W, H),
                                              (3, 640, 480)])
def test_project_gaussians_matches(deg, width, height):
    scene = synthetic_room(num_gaussians=400, seed=5, sh_degree=deg)
    cam = _cam(width, height)
    ts, tc = _port(scene, cam)
    got = tproj.project_gaussians(ts, tc)
    want = jproj.project_gaussians(scene, cam)
    for f in ("radii", "extents", "visible"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert _np(got.visible).sum() > 50
    for f in ("means2d", "conics", "depths", "colors", "opacities"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    clamped = tproj.project_gaussians(ts, tc, clamp_dims=(2 * width, 2 * height))
    want_c = jproj.project_gaussians(scene, cam, clamp_dims=(2 * width, 2 * height))
    np.testing.assert_allclose(_np(clamped.conics), np.asarray(want_c.conics),
                               rtol=1e-5, atol=1e-5)


def test_rotation_and_covariance_match(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    ls = rng.uniform(-3, 0, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tproj.quat_to_rotmat(torch.from_numpy(q))),
                               np.asarray(jproj.quat_to_rotmat(q)), atol=1e-6)
    np.testing.assert_allclose(
        _np(tproj.covariance_3d(torch.from_numpy(ls), torch.from_numpy(q))),
        np.asarray(jproj.covariance_3d(ls, q)), rtol=1e-5, atol=1e-7)


def test_alpha_at_matches():
    scene = synthetic_room(num_gaussians=400, seed=5)
    cam = _cam()
    ts, tc = _port(scene, cam)
    px = np.linspace(0.5, W - 0.5, 37).astype(np.float32)
    py = np.linspace(0.5, H - 0.5, 37).astype(np.float32)
    got = tproj.alpha_at(tproj.project_gaussians(ts, tc), torch.from_numpy(px),
                         torch.from_numpy(py))
    want = jproj.alpha_at(jproj.project_gaussians(scene, cam), px, py)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_oracle_compositor_matches():
    scene = synthetic_room(num_gaussians=400, seed=5)
    cam = _cam()
    ts, tc = _port(scene, cam)
    got = tref.composite_reference(tproj.project_gaussians(ts, tc),
                                   ts.semantic_ids, W, H, pixel_chunk=1000)
    want = jref.composite_reference(jproj.project_gaussians(scene, cam),
                                    scene.semantic_ids, W, H)
    for k in ("rgb", "alpha", "trans"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(_np(got["depth_acc"]), np.asarray(want["depth_acc"]),
                               rtol=1e-3, atol=1e-3)
    assert (_np(got["semantic"]) == np.asarray(want["semantic"])).mean() > 0.995
    assert got["semantic"].dtype == torch.int32


# -- K7's dispatch, counters and wrapper (the kernel itself runs on the card:
# tests/test_torch_gpu.py) ---------------------------------------------------

def _fields_equal(got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert torch.equal(a, b), f


def _batch(width=W, height=H):
    from sage3d_tpu_torch.renderer.camera import make_camera as tmake
    from sage3d_tpu_torch.renderer.camera import stack_cameras
    return stack_cameras([tmake(p, [0.0, 1.0, -0.1], width, height,
                                device="cpu")
                          for p in ([0.0, -4.0, 1.2], [0.5, -3.5, 1.0],
                                    [-0.5, -3.0, 1.4])])


@pytest.mark.parametrize("grad", [False, True])
def test_project_gaussians_takes_the_plain_version_on_the_cpu(grad):
    """On the CPU ``project_gaussians`` is the plain version, with or without
    a gradient wanted; the gradient flows through it."""
    scene = synthetic_room(num_gaussians=400, seed=5, sh_degree=3)
    ts, tc = _port(scene, _cam())
    if grad:
        ts = ts._replace(**{f: getattr(ts, f).clone().requires_grad_()
                            for f in ("means", "log_scales", "quats",
                                      "opacity_logits", "sh")})
    assert not tproj._takes_kernel(ts, tc)
    before = tproj.project_gaussians_cuda.launches
    got = tproj.project_gaussians(ts, tc)
    _fields_equal(got, tproj.project_gaussians_plain(ts, tc, 3))
    assert tproj.project_gaussians_cuda.launches == before
    assert got.colors.requires_grad == grad
    if grad:
        got.colors.sum().backward()
        assert float(ts.sh.grad.abs().sum()) > 0


@pytest.mark.parametrize("kernel", [False, True])
def test_projection_counts_rows_and_kernel_rows(kernel, monkeypatch):
    """``projection.rows`` counts cameras x Gaussians of every call,
    ``projection.kernel_rows`` those of the calls K7 takes (here a stand-in
    for K7 that records its arguments)."""
    from sage3d_tpu_torch.utils import profiling as prof
    ts, tc = _port(synthetic_room(num_gaussians=400, seed=5), _cam())
    calls = []
    if kernel:
        monkeypatch.setattr(tproj, "_takes_kernel", lambda s, c: True)
        monkeypatch.setattr(tproj, "project_gaussians_cuda",
                            lambda *a: calls.append(a)
                            or tproj.project_gaussians_plain(*a))
    prof.reset()
    prof.enable()
    try:
        with prof.span("render.project"):
            tproj.project_gaussians(ts, tc)
            tproj.project_gaussians(ts, _batch(), sh_degree=0,
                                    clamp_dims=(128, 96))
    finally:
        prof.disable()
    counted = prof.counters()
    prof.reset()
    assert counted["projection.rows"] == 4 * 400
    assert counted["projection.kernel_rows"] == (4 * 400 if kernel else 0)
    assert [(a[2], a[3]) for a in calls] == (
        [(0, None), (0, (128, 96))] if kernel else [])


def _refused(case):
    """A CPU scene and camera that K7's wrapper refuses for ``case``."""
    ts, tc = _port(synthetic_room(num_gaussians=400, seed=5, sh_degree=1),
                   _cam())
    deg = 1
    if case == "dtype":
        ts = ts._replace(quats=ts.quats.double())
    elif case == "shape":
        ts = ts._replace(sh=ts.sh[:, :, :2].contiguous())
    elif case == "contiguity":
        ts = ts._replace(means=ts.means.t().contiguous().t())
    elif case == "camera shape":
        tc = tc._replace(fx=tc.fx.reshape(1))
    elif case == "degree":
        deg = 2
    return ts, tc, deg


@pytest.mark.parametrize("case,message", [
    ("dtype", "float32"), ("shape", "expected"), ("contiguity", "contiguous"),
    ("camera shape", "expected"), ("degree", "SH degree"),
    ("cpu", "one CUDA device")])
def test_projection_kernel_wrapper_refuses(case, message):
    ts, tc, deg = _refused(case)
    before = tproj.project_gaussians_cuda.launches
    with pytest.raises(ValueError, match=message):
        tproj.project_gaussians_cuda(ts, tc, deg)
    assert tproj.project_gaussians_cuda.launches == before
