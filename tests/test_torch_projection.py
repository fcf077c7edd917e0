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


# -- K8's twin, the autograd Function and its dispatch (K8 itself runs on the
# card: tests/test_torch_gpu.py) ---------------------------------------------

FIELDS = ("means2d", "conics", "depths", "colors", "opacities")


def _leaves(ts):
    return ts._replace(**{f: getattr(ts, f).clone().requires_grad_()
                          for f in tproj.GaussianScene._fields[:5]})


def _grad_case(camera: str, dtype):
    """A 400-Gaussian room and a camera: ``single``, a ``batch`` of 3, or
    ``near``: a batch whose first camera stands inside the room with 20
    Gaussians planted on its image plane, so that the frustum clamp and the
    ``tz`` guard engage."""
    from sage3d_tpu_torch.renderer.camera import make_camera as tmake
    from sage3d_tpu_torch.renderer.camera import stack_cameras, unstack_cameras
    ts, tc = _port(synthetic_room(num_gaussians=400, seed=5, sh_degree=3),
                   _cam())
    if camera != "single":
        tc = _batch()
    if camera == "near":
        first = tmake([0.0, -0.5, 1.0], [0.0, 1.0, 0.0], W, H, device="cpu")
        tc = stack_cameras([first, *unstack_cameras(tc)[1:]])
        means = ts.means.clone()
        right = first.cam_to_world[:, 0]
        means[:20] = first.position + right * torch.linspace(-0.3, 0.3,
                                                               20)[:, None]
        ts = ts._replace(means=means)
    ts = ts._replace(**{f: getattr(ts, f).to(dtype)
                        for f in tproj.GaussianScene._fields[:5]})
    tc = tc._replace(**{f: getattr(tc, f).to(dtype)
                        for f in tc._fields[:6]})
    return ts, tc


def _upstream(proj, seed: int, drop=()):
    """Random gradients for the five float fields (None for those in
    ``drop``), of their dtype and shape."""
    g = torch.Generator().manual_seed(seed)
    return tuple(None if f in drop else torch.randn(
        getattr(proj, f).shape, generator=g, dtype=getattr(proj, f).dtype)
        for f in FIELDS)


def _autograd(ts, tc, deg, grads, clamp=None):
    leaves = _leaves(ts)
    proj = tproj.project_gaussians_plain(leaves, tc, deg, clamp)
    outs = [(getattr(proj, f), g) for f, g in zip(FIELDS, grads)
            if g is not None]
    torch.autograd.backward([o for o, _ in outs], [g for _, g in outs])
    return [getattr(leaves, f).grad
            for f in tproj.GaussianScene._fields[:5]]


def _close(got, want, rel, what):
    """Each gradient within ``rel`` of its largest entry."""
    for name, a, b in zip(tproj.GaussianScene._fields[:5], got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        scale = float(b.abs().max())
        assert scale > 0, (what, name)
        err = float((a - b).abs().max())
        assert err <= rel * scale, f"{what}: {name} off by {err / scale:.3g}"


@pytest.mark.parametrize("camera", ["single", "batch", "near"])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_projection_backward_twin_matches_autograd(dtype, deg, camera):
    """``project_gaussians_backward_plain`` (K8's twin) against autograd of
    ``project_gaussians_plain``, at SH ``deg`` of a degree-3 scene (the
    coefficients above it get zeros). The two differ only in the order of
    their sums: 1e-10 of each gradient's largest entry in float64, 2e-5 in
    float32 (~100 f32 roundings a row; the CPU runs measured 1e-6)."""
    ts, tc = _grad_case(camera, dtype)
    grads = _upstream(tproj.project_gaussians_plain(ts, tc, deg), seed=deg,
                      drop=("depths",) if camera == "near" else ())
    for clamp in (None, (2 * W, 2 * H)):
        want = _autograd(ts, tc, deg, grads, clamp)
        got = tproj.project_gaussians_backward_plain(ts, tc, deg, clamp, grads)
        _close(got, want, 1e-10 if dtype == torch.float64 else 2e-5,
               f"{camera}, clamp {clamp}")
        assert not bool(got[4][:, (deg + 1) ** 2:].any())
    if camera == "near":
        # the first camera's guard and clamp both engage
        depths = tproj.project_gaussians_plain(ts, tc, deg).depths[0]
        assert int((depths.abs() < 1e-6).sum()) >= 10
        means2d = tproj.project_gaussians_plain(ts, tc, deg).means2d[0]
        lim = 1.3 * 0.5 * W / float(tc.fx[0])
        rx = (means2d[:, 0] - float(tc.cx[0])) / float(tc.fx[0])
        assert int((rx.abs() > lim).sum()) > 50


def _stand_ins(monkeypatch):
    """K7 and K8 replaced by their plain twins, recording their calls, and
    the kernel rule forced: ``project_gaussians`` then runs its card path
    on the CPU."""
    calls = {"k7": 0, "k8": []}

    def k7(*a):
        calls["k7"] += 1
        return tproj.project_gaussians_plain(*a)

    def k8(scene, camera, deg, clamp, grads):
        calls["k8"].append(tuple(g is not None for g in grads))
        return tproj.project_gaussians_backward_plain(scene, camera, deg,
                                                      clamp, grads)
    monkeypatch.setattr(tproj, "_takes_kernel", lambda s, c: True)
    monkeypatch.setattr(tproj, "project_gaussians_cuda", k7)
    monkeypatch.setattr(tproj, "project_gaussians_backward_cuda", k8)
    return calls


@pytest.mark.parametrize("camera", ["single", "batch"])
def test_project_gaussians_under_autograd_takes_k7_and_k8(camera,
                                                          monkeypatch):
    """On the card a scene that wants a gradient goes through
    ``_ProjectK7``: K7 once forward (its fields those of the plain
    version), K8 once backward with the output gradients it was given
    (None for an unused field), and the scene's gradients autograd's of the
    plain version; ``projection.grad_kernel_rows`` counts its rows, which
    ``projection.kernel_rows`` counts too (stand-ins for K7 and K8)."""
    from sage3d_tpu_torch.utils import profiling as prof
    ts, tc = _grad_case(camera, torch.float32)
    calls = _stand_ins(monkeypatch)
    leaves = _leaves(ts)
    prof.reset()
    prof.enable()
    try:
        with prof.span("render.project"):
            got = tproj.project_gaussians(leaves, tc, clamp_dims=(96, 72))
            with torch.no_grad():
                tproj.project_gaussians(leaves, tc)
    finally:
        prof.disable()
    counted = prof.counters()
    prof.reset()
    rows = 400 * (3 if camera == "batch" else 1)
    assert counted["projection.rows"] == 2 * rows
    assert counted["projection.kernel_rows"] == 2 * rows
    assert counted["projection.grad_kernel_rows"] == rows
    assert calls["k7"] == 2 and calls["k8"] == []
    _fields_equal(got._replace(**{f: getattr(got, f).detach()
                                  for f in got._fields}),
                  tproj.project_gaussians_plain(ts, tc, 3, (96, 72)))
    assert all(getattr(got, f).requires_grad for f in FIELDS)
    assert not any(getattr(got, f).requires_grad
                   for f in ("radii", "visible", "extents"))
    grads = _upstream(got, seed=7, drop=("depths",))
    torch.autograd.backward([getattr(got, f) for f, g in zip(FIELDS, grads)
                             if g is not None],
                            [g for g in grads if g is not None])
    assert calls["k8"] == [(True, True, False, True, True)]
    _close([getattr(leaves, f).grad for f in tproj.GaussianScene._fields[:5]],
           _autograd(ts, tc, 3, grads, (96, 72)), 2e-5, camera)


def test_project_gaussians_refuses_a_camera_gradient_on_the_card(
        monkeypatch):
    """On the card a camera tensor that requires a gradient raises (K8
    gives the scene's gradients only); under ``no_grad`` it is K7's."""
    ts, tc = _grad_case("single", torch.float32)
    calls = _stand_ins(monkeypatch)
    tc = tc._replace(fx=tc.fx.clone().requires_grad_())
    with pytest.raises(ValueError, match="camera"):
        tproj.project_gaussians(_leaves(ts), tc)
    with torch.no_grad():
        tproj.project_gaussians(ts, tc)
    assert calls["k7"] == 1 and calls["k8"] == []


@pytest.mark.parametrize("case,message", [
    ("dtype", "float32"), ("shape", "expected"), ("degree", "SH degree"),
    ("cpu", "one CUDA device"), ("gradient shape", "gradient"),
    ("gradient dtype", "gradient")])
def test_projection_backward_wrapper_refuses(case, message):
    """K8's wrapper checks each output gradient's shape, type and device,
    and the scene and the camera as K7's does, before it launches."""
    ts, tc, deg = _refused(case if case in ("dtype", "shape", "degree")
                           else "cpu")
    grads = [None] * 5
    if case == "gradient shape":
        grads[0] = torch.zeros((400, 3))
    elif case == "gradient dtype":
        grads[3] = torch.zeros((400, 3), dtype=torch.float64)
    before = tproj.project_gaussians_backward_cuda.launches
    with pytest.raises(ValueError, match=message):
        tproj.project_gaussians_backward_cuda(ts, tc, deg, None, grads)
    assert tproj.project_gaussians_backward_cuda.launches == before


def _jax_vjp(ts, tc, deg, grads, clamp=None):
    """The scene's gradients from ``jax.vjp`` of the JAX package's
    ``project_gaussians`` on the same numpy inputs and output gradients
    (zeros for a dropped field), camera by camera and summed over the
    batch, as the port's stacked call sums them."""
    import jax
    import jax.numpy as jnp
    from sage3d_tpu.renderer.camera import Camera as JCamera
    from sage3d_tpu.renderer.scene import GaussianScene as JScene
    from sage3d_tpu_torch.renderer.camera import unstack_cameras
    params = tuple(jnp.asarray(_np(getattr(ts, f)))
                   for f in tproj.GaussianScene._fields[:5])
    ids = jnp.asarray(_np(ts.semantic_ids))
    cams = unstack_cameras(tc) if tc.fx.ndim else [tc]
    total = [np.zeros(p.shape, np.float64) for p in params]
    for i, c in enumerate(cams):
        jc = JCamera(*(jnp.asarray(_np(getattr(c, f)))
                       for f in c._fields[:6]), c.width, c.height,
                     c.near, c.far)

        def fields(*p, jc=jc):
            out = jproj.project_gaussians(JScene(*p, ids), jc, deg, clamp)
            return tuple(getattr(out, f) for f in FIELDS)
        outs, vjp = jax.vjp(fields, *params)
        cot = tuple(jnp.zeros_like(o) if g is None
                    else jnp.asarray(_np(g[i] if tc.fx.ndim else g))
                    for o, g in zip(outs, grads))
        for t, g in zip(total, vjp(cot)):
            t += np.asarray(g, np.float64)
    return [torch.from_numpy(t.astype(np.float32)) for t in total]


@pytest.mark.parametrize("camera", ["single", "batch", "near"])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_projection_backward_matches_jax_vjp(deg, camera, monkeypatch):
    """K8's twin, and ``project_gaussians`` under autograd through
    ``_ProjectK7`` (K7 and K8 stand-ins), against ``jax.vjp`` of the JAX
    package's ``project_gaussians``, which takes this gradient from XLA's
    autodiff: same float32 inputs, same output gradients, with and without
    the clamp. Each gradient within 1e-5 of its largest entry: both sides
    round in float32 in their own order (the CPU runs measured at most
    1e-6), and ties, where PyTorch's and JAX's rules for ``clamp`` and
    ``maximum`` differ, do not occur here."""
    ts, tc = _grad_case(camera, torch.float32)
    grads = _upstream(tproj.project_gaussians_plain(ts, tc, deg), seed=deg,
                      drop=("depths",) if camera == "near" else ())
    calls = _stand_ins(monkeypatch)
    for clamp in (None, (2 * W, 2 * H)):
        want = _jax_vjp(ts, tc, deg, grads, clamp)
        twin = tproj.project_gaussians_backward_plain(ts, tc, deg, clamp,
                                                      grads)
        _close(twin, want, 1e-5, f"twin, {camera}, clamp {clamp}")
        leaves = _leaves(ts)
        got = tproj.project_gaussians(leaves, tc, deg, clamp)
        torch.autograd.backward(
            [getattr(got, f) for f, g in zip(FIELDS, grads) if g is not None],
            [g for g in grads if g is not None])
        _close([getattr(leaves, f).grad
                for f in tproj.GaussianScene._fields[:5]], want, 1e-5,
               f"_ProjectK7, {camera}, clamp {clamp}")
    assert calls["k7"] == 2 and len(calls["k8"]) == 2
