"""The port's configuration tree (``utils/config.py``) against the JAX
package's: defaults, the JSON and dotted-override layers, the fast-mode
bundles; and the port's renderer backend names."""

import dataclasses
import json

import pytest

from sage3d_tpu.utils import config as jconfig
from sage3d_tpu_torch.renderer.render import render
from sage3d_tpu_torch.utils import config as tconfig

OVERRIDES = ["renderer.tile_capacity=2048", "benchmark.max_steps=50",
             "physics.disable_collision=true", "benchmark.max_episodes=7",
             "renderer.bg_color=[0.1, 0.2, 0.3]", "policy.model_type=navila",
             "benchmark.task_type=none", "train.lr=3e-4"]


def test_config_defaults_match_the_jax_package():
    assert tconfig.to_dict(tconfig.Config()) == \
        jconfig.to_dict(jconfig.Config())
    assert tconfig.Config().renderer.backend == "auto"


def test_config_defaults_and_overrides(tmp_path):
    cfg = tconfig.load_config(overrides=OVERRIDES)
    assert cfg.renderer.tile_capacity == 2048
    assert cfg.benchmark.max_steps == 50
    assert cfg.physics.disable_collision is True
    assert cfg.benchmark.max_episodes == 7
    assert cfg.renderer.bg_color == (0.1, 0.2, 0.3)
    assert cfg.train.lr == 3e-4
    assert tconfig.to_dict(cfg) == tconfig.to_dict(
        jconfig.load_config(overrides=OVERRIDES))
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"renderer": {"width": 320}, "silent": True}))
    cfg2 = tconfig.load_config(str(p))
    assert cfg2.renderer.width == 320 and cfg2.silent is True
    assert tconfig.to_dict(cfg2) == jconfig.to_dict(jconfig.load_config(str(p)))


@pytest.mark.parametrize("level", ["fast", "ultra"])
def test_fast_mode_bundles(level):
    got = tconfig.Config().apply_fast_mode(level)
    want = jconfig.Config().apply_fast_mode(level)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.benchmark.record_video is False


@pytest.mark.parametrize("backend", ["oracle", "torch", "cuda"])
def test_backend_names_are_the_ports(backend, tmp_path):
    """``renderer.backend`` takes the port's names: each renders a frame;
    the JAX package's ``xla`` and ``pallas`` are unknown to ``render``."""
    from sage3d_tpu_torch.renderer.camera import make_camera
    from sage3d_tpu_torch.renderer.scene import synthetic_room
    cfg = tconfig.load_config(overrides=[f"renderer.backend={backend}",
                                         "renderer.width=32",
                                         "renderer.height=24"])
    r = cfg.renderer
    scene = synthetic_room(100, seed=1, device="cpu")
    cam = make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], r.width, r.height,
                      focal_mm=r.focal_mm, device="cpu")
    out = render(scene, cam, backend=r.backend, tile_capacity=r.tile_capacity)
    assert out["rgb"].shape == (24, 32, 3) and int(out["overflow"]) == 0
    for jax_name in ("xla", "pallas"):
        with pytest.raises(ValueError, match="unknown backend"):
            render(scene, cam, backend=jax_name)
