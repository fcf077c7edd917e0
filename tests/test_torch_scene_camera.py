"""Parity of the PyTorch port's scene and camera modules with the JAX package.

Both packages run on the CPU; arrays cross between them as numpy.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.renderer import camera as jcam
from sage3d_tpu.renderer import scene as jscene
from sage3d_tpu_torch.renderer import camera as tcam
from sage3d_tpu_torch.renderer import scene as tscene

CPU = "cpu"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_scene_equal(ts, js):
    for f in jscene.GaussianScene._fields:
        t, j = _np(getattr(ts, f)), np.asarray(getattr(js, f))
        assert t.dtype == j.dtype and t.shape == j.shape, f
        if f == "log_scales":
            # jnp.log and torch.log round differently in the last place on
            # about 5% of inputs (both within 1 ulp of the true log).
            np.testing.assert_array_max_ulp(t, j, maxulp=1)
        else:
            np.testing.assert_array_equal(t, j, err_msg=f)


def _cam_np(c):
    return {f: np.asarray(getattr(c, f)) for f in
            ("position", "cam_to_world", "fx", "fy", "cx", "cy")} | {
        "width": c.width, "height": c.height, "near": c.near, "far": c.far}


def _assert_cam_equal(tc, jc, exact=True):
    for f, j in _cam_np(jc).items():
        t = getattr(tc, f)
        if isinstance(j, np.ndarray):
            if exact:
                np.testing.assert_array_equal(_np(t), j, err_msg=f)
            else:
                np.testing.assert_allclose(_np(t), j, rtol=1e-6, atol=1e-6,
                                           err_msg=f)
        else:
            assert t == j, f


@pytest.mark.parametrize("n,seed,deg", [(400, 5, 0), (1000, 3, 3), (37, 0, 1)])
def test_synthetic_room_matches(n, seed, deg):
    ts = tscene.synthetic_room(n, seed=seed, sh_degree=deg, device=CPU)
    js = jscene.synthetic_room(n, seed=seed, sh_degree=deg)
    _assert_scene_equal(ts, js)
    assert ts.sh_degree == js.sh_degree == deg
    assert ts.num_gaussians == n
    np.testing.assert_allclose(_np(ts.opacities), np.asarray(js.opacities),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(ts.scales), np.asarray(js.scales), rtol=1e-6)


def test_make_scene_matches(rng):
    n = 50
    args = dict(means=rng.normal(size=(n, 3)),
                scales=rng.uniform(0.01, 0.3, (n, 3)),
                quats=rng.normal(size=(n, 4)),
                opacities=rng.uniform(0, 1, n),
                colors=rng.uniform(0, 1, (n, 3)),
                semantic_ids=rng.integers(-1, 5, n))
    _assert_scene_equal(tscene.make_scene(**args, sh_degree=2, device=CPU),
                        jscene.make_scene(**args, sh_degree=2))
    no_ids = {k: v for k, v in args.items() if k != "semantic_ids"}
    _assert_scene_equal(tscene.make_scene(**no_ids, device=CPU),
                        jscene.make_scene(**no_ids))


def test_scene_from_numpy_roundtrip():
    js = jscene.synthetic_room(200, seed=2, sh_degree=1)
    arrays = {f: np.asarray(getattr(js, f)) for f in js._fields}
    ts = tscene.scene_from_numpy(arrays, device=CPU)
    for f in js._fields:
        np.testing.assert_array_equal(_np(getattr(ts, f)), arrays[f])
    back = tscene.scene_to_numpy(ts)
    assert set(back) == set(arrays)


def test_importance_subset_matches():
    js = jscene.synthetic_room(500, seed=8)
    ts = tscene.scene_from_numpy({f: np.asarray(getattr(js, f))
                                  for f in js._fields}, device=CPU)
    tsub = tscene.importance_subset(ts, 120)
    jsub = jscene.importance_subset(js, 120)
    # the rank order rests on exp/sigmoid, which round differently in the
    # last place; compare the chosen set and the arrays, not tie order
    assert set(_np(tsub.semantic_ids).tolist()) <= set(_np(ts.semantic_ids).tolist())
    tm, jm = _np(tsub.means), np.asarray(jsub.means)
    same = (tm[:, None, :] == jm[None, :, :]).all(-1).any(1)
    assert same.mean() >= 0.99
    assert tscene.importance_subset(ts, 10_000).num_gaussians == 500


def test_ply_roundtrip_across_packages(tmp_path):
    js = jscene.synthetic_room(300, seed=6, sh_degree=3)
    ts = tscene.scene_from_numpy({f: np.asarray(getattr(js, f))
                                  for f in js._fields}, device=CPU)
    tscene.save_ply(ts, tmp_path / "t.ply")
    jscene.save_ply(js, tmp_path / "j.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    _assert_scene_equal(tscene.load_ply(tmp_path / "j.ply", device=CPU),
                        jscene.load_ply(tmp_path / "t.ply"))
    low = tscene.load_ply(tmp_path / "j.ply", max_sh_degree=1, device=CPU)
    assert low.sh.shape == (300, 4, 3)


def test_attach_semantic_ids_matches(tmp_path):
    js = jscene.synthetic_room(400, seed=1)
    ts = tscene.scene_from_numpy({f: np.asarray(getattr(js, f))
                                  for f in js._fields}, device=CPU)
    labels = {"label_3": {"bbox": [[-2, -2, 0], [2, 2, 2]]},
              "label_7": {"bbox": [[-1, -1, 0], [1, 1, 1]]},
              "junk": {"bbox": [[0, 0, 0], [1, 1, 1]]}}
    path = tmp_path / "labels.json"
    path.write_text(json.dumps(labels))
    t_ids = _np(tscene.attach_semantic_ids_from_labels(ts, path).semantic_ids)
    j_ids = np.asarray(jscene.attach_semantic_ids_from_labels(js, labels).semantic_ids)
    np.testing.assert_array_equal(t_ids, j_ids)
    assert 3 in set(t_ids.tolist())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert tscene.synthetic_room(16).means.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscene.synthetic_room(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcam.make_camera([0, 0, 1], [0, 1, 0], 64, 48)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscene.scene_from_numpy(tscene.scene_to_numpy(
            tscene.synthetic_room(4, device=CPU)))


@pytest.mark.parametrize("focal", [8.0, 14.0])
def test_make_camera_matches(focal):
    kw = dict(position=[0.0, -6.0, 1.5], forward=[0.0, 1.0, -0.05],
              width=1920, height=1080, focal_mm=focal)
    _assert_cam_equal(tcam.make_camera(**kw, device=CPU), jcam.make_camera(**kw))
    intr = (500.0, 510.0, 320.0, 240.0)
    _assert_cam_equal(tcam.make_camera([1, 2, 3], [1, 0, 0], 640, 480,
                                       intrinsics=intr, device=CPU),
                      jcam.make_camera([1, 2, 3], [1, 0, 0], 640, 480,
                                       intrinsics=intr))
    assert tcam.intrinsics_from_focal_mm(8.0, 640, 480) == \
        jcam.intrinsics_from_focal_mm(8.0, 640, 480)
    for fwd in ([0, 0, -1], [0.3, 0.9, 0.1]):
        np.testing.assert_array_equal(tcam.look_rotation(fwd),
                                      jcam.look_rotation(np.asarray(fwd, float)))


@pytest.mark.parametrize("xy,yaw,pitch", [((0.0, -3.5), 1.57, 0.0),
                                          ((1.2, 0.4), -2.0, 0.3)])
def test_agent_cameras_match(xy, yaw, pitch):
    jc = jcam.agent_camera(xy, yaw, pitch=pitch)
    _assert_cam_equal(tcam.agent_camera(xy, yaw, pitch=pitch, device=CPU), jc)
    tt = tcam.agent_camera_t(torch.tensor(xy, dtype=torch.float32),
                             torch.tensor(yaw), pitch=pitch)
    jj = jcam.agent_camera_jnp(jnp.asarray(xy), jnp.float32(yaw), pitch=pitch)
    _assert_cam_equal(tt, jj, exact=False)
    # the traced form agrees with the host-built camera's geometry
    np.testing.assert_allclose(_np(tt.cam_to_world), np.asarray(jc.cam_to_world),
                               atol=1e-6)
    assert float(tcam.camera_rays_yaw(tt)) == pytest.approx(
        float(jcam.camera_rays_yaw(jj)), abs=1e-6)


def test_stack_and_camera_from_numpy():
    jcs = [jcam.agent_camera((0.0, float(i)), 0.3 * i) for i in range(3)]
    tcs = [tcam.camera_from_numpy(_cam_np(c), device=CPU) for c in jcs]
    for tc, jc in zip(tcs, jcs):
        _assert_cam_equal(tc, jc)
    ts, js = tcam.stack_cameras(tcs), jcam.stack_cameras(jcs)
    for f in ("position", "cam_to_world", "fx", "cy"):
        np.testing.assert_array_equal(_np(getattr(ts, f)),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_allclose(_np(tcam.camera_rays_yaw(ts)),
                               np.asarray(jcam.camera_rays_yaw(js)), atol=1e-6)
    back = tcam.unstack_cameras(ts)
    assert len(back) == 3 and back[1].position.shape == (3,)
    np.testing.assert_array_equal(_np(tcs[0].world_to_cam),
                                  np.asarray(jcs[0].world_to_cam))
    with pytest.raises(ValueError):
        tcam.stack_cameras([tcs[0], tcam.agent_camera((0, 0), 0.0, width=320,
                                                      device=CPU)])
