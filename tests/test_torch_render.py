"""End-to-end parity of the port's render path with the JAX package on the
CPU (the port's ``cuda`` backend runs its kernels' plain versions here), and
the port's import boundary."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.renderer import camera as jcam
from sage3d_tpu.renderer import render as jrender
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.renderer import camera as tcam
from sage3d_tpu_torch.renderer import render as trender
from sage3d_tpu_torch.renderer.scene import scene_from_numpy

W, H = 64, 48
REPO = Path(__file__).resolve().parent.parent
PAIRS = {"oracle": "oracle", "torch": "xla", "cuda": "pallas"}
PARAMS = ("means", "log_scales", "quats", "opacity_logits", "sh")


def _cam_np(c):
    return {f: np.asarray(getattr(c, f)) for f in
            ("position", "cam_to_world", "fx", "fy", "cx", "cy")} | {
        "width": c.width, "height": c.height, "near": c.near, "far": c.far}


@pytest.fixture(scope="module")
def scenes():
    js = synthetic_room(num_gaussians=400, seed=5)
    ts = scene_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def cams():
    jc = jcam.make_camera(position=[0.0, -4.0, 1.2], forward=[0.0, 1.0, -0.1],
                          width=W, height=H)
    return jc, tcam.camera_from_numpy(_cam_np(jc), device="cpu")


@pytest.mark.parametrize("backend", list(PAIRS))
def test_render_matches_jax_backend(backend, scenes, cams):
    js, ts = scenes
    jc, tc = cams
    kw = dict(pair_capacity=1 << 14, bg_color=(0.2, 0.3, 0.4))
    want = jax.device_get(jrender.render(js, jc, backend=PAIRS[backend], **kw))
    with torch.no_grad():
        got = trender.render(ts, tc, backend=backend, **kw)
    assert int(got["overflow"]) == int(want["overflow"]) == 0
    assert int(got["grad_chunks"]) == int(want["grad_chunks"])
    for k in ("rgb", "alpha", "trans", "rgb_acc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in ("depth_acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)
    assert (got["semantic"].numpy() == np.asarray(want["semantic"])).mean() > 0.995
    assert got["semantic"].dtype == torch.int32 and got["rgb"].shape == (H, W, 3)


def test_render_with_nothing_in_view(scenes):
    # outside the room, looking away: every backend renders the background
    _, ts = scenes
    tc = tcam.make_camera([0.0, -8.0, 1.2], [0.0, -1.0, 0.0], W, H,
                          device="cpu")
    for backend in PAIRS:
        with torch.no_grad():
            got = trender.render(ts, tc, backend=backend, pair_capacity=1 << 14,
                                 bg_color=(0.2, 0.3, 0.4))
        assert int(got["overflow"]) == 0, backend
        assert torch.equal(got["trans"], torch.ones((H, W))), backend
        assert int(got["semantic"].max()) == -1, backend
        torch.testing.assert_close(got["rgb"][3, 5], torch.tensor([0.2, 0.3, 0.4]))


def test_autotune_all_and_budget_kwargs_match(scenes, cams):
    js, ts = scenes
    jc, tc = cams
    want = jrender.autotune_all(js, jc, pair_margin=1.05, grad_margin=1.2)
    got = trender.autotune_all(ts, tc, pair_margin=1.05, grad_margin=1.2)
    assert got == want
    assert trender.budget_kwargs(got) == jrender.budget_kwargs(want)
    assert trender.autotune_budgets(ts, tc) == jrender.autotune_budgets(js, jc)
    with torch.no_grad():
        out = trender.render(ts, tc, backend="cuda", **trender.budget_kwargs(got))
    assert int(out["overflow"]) == 0


def test_autotune_poses_matches(scenes):
    js, ts = scenes
    jcs = [jcam.agent_camera((0.0, -3.5), yaw, width=W, height=H)
           for yaw in (1.2, 1.57, 2.0)]
    tcs = tcam.stack_cameras([tcam.camera_from_numpy(_cam_np(c), device="cpu")
                              for c in jcs])
    want = jrender.autotune_poses(js, jcam.stack_cameras(jcs))
    assert trender.autotune_poses(ts, tcs) == want


def test_small_helpers_match():
    for n in (10, 1000, 400_000, 5_000_000):
        assert trender.default_pair_capacity(n, 640, 480) == \
            jrender.default_pair_capacity(n, 640, 480)
    rgb = np.random.default_rng(0).uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(trender.rgb_to_uint8(torch.from_numpy(rgb)).numpy(),
                                  np.asarray(jrender.rgb_to_uint8(rgb)))
    assert trender.budget_kwargs({"k_small": 4, "m_big": 32, "k_big": 8}) == \
        jrender.budget_kwargs({"k_small": 4, "m_big": 32, "k_big": 8})


def test_render_batch_matches_single_renders(scenes):
    _, ts = scenes
    tcs = [tcam.agent_camera((0.0, -3.5), yaw, width=W, height=H, device="cpu")
           for yaw in (1.3, 1.8)]
    with torch.no_grad():
        batch = trender.render_batch(ts, tcam.stack_cameras(tcs), backend="cuda",
                                     sequential=True, pair_capacity=1 << 14)
        for i, c in enumerate(tcs):
            one = trender.render(ts, c, backend="cuda", pair_capacity=1 << 14)
            for k in ("rgb", "semantic", "overflow"):
                assert torch.equal(batch[k][i], one[k])
    assert batch["rgb"].shape == (2, H, W, 3)
    with pytest.raises(ValueError, match="unknown backend"):
        trender.render(ts, tcs[0], backend="pallas")


def test_torch_backend_gradients_match_xla(scenes, cams):
    js, ts = scenes
    jc, tc = cams
    target = np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32)

    def jloss(p):
        out = jrender.render(js._replace(**p), jc, backend="xla")
        return (jnp.mean((out["rgb"] - target) ** 2)
                + 0.01 * jnp.mean(out["depth_acc"]))

    jgrads = jax.grad(jloss)({k: getattr(js, k) for k in PARAMS})
    params = {k: getattr(ts, k).clone().requires_grad_() for k in PARAMS}
    out = trender.render(ts._replace(**params), tc, backend="torch")
    loss = (torch.mean((out["rgb"] - torch.from_numpy(target)) ** 2)
            + 0.01 * torch.mean(out["depth_acc"]))
    loss.backward()
    for k in PARAMS:
        want = np.asarray(jgrads[k])
        scale = np.abs(want).max() + 1e-12
        assert scale > 1e-9, k
        np.testing.assert_allclose(params[k].grad.numpy() / scale, want / scale,
                                   atol=3e-4, err_msg=k)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((REPO / "sage3d_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "sage3d_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"
