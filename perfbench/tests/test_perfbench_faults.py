"""The comparison that decides ``correct``, shown to fail: a whole run of
each cell at a tiny size on the CPU (the harness's look for a chip
skipped), with the timed path broken underneath, comes out not correct;
so does each cell's control, the reference in bfloat16 put in the
program's place."""

import pytest
import torch

from perfbench import control
from perfbench.harness import runner

SEED = 2**31 + 99


def run(tiny, cell):
    return runner.run(cell, SEED, 0.3, False, 0.0, device="cpu", base=tiny)


def failed(out):
    return [k for k, c in out["compared"].items() if c["value"] > c["limit"]]


def half(cams, n):
    """The first half of a stacked camera batch, repeated: half of the
    batch left out."""
    idx = torch.arange(n) % max(n // 2, 1)
    return cams._replace(**{f: getattr(cams, f)[idx] for f in
                            ("position", "cam_to_world", "fx", "fy", "cx",
                             "cy")})


def altered(fn, key, delta):
    """``fn`` with one value of output ``key`` altered where it is made."""
    def call(*a, **k):
        out = fn(*a, **k)
        t = out[key] = out[key].clone()
        if key == "rgb":           # (..., H, W, 3)
            t[..., 10, 10, :] += delta
        else:                      # (..., H, W)
            t[..., 10, 10] += delta
        return out
    return call


def halved(fn):
    def call(scene, cams, **k):
        return fn(scene, half(cams, cams.position.shape[0]), **k)
    return call


@pytest.mark.parametrize("cell", ["fit-1m-1080p", "render-8cam-1080p",
                                  "nav-env-1", "nav-lockstep-8"])
def test_sound_runs_are_correct(tiny, cell):
    out = run(tiny, cell)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("cell", ["fit-1m-1080p", "render-8cam-1080p",
                                  "nav-env-1", "nav-lockstep-8"])
def test_control_is_not_correct(tiny, cell):
    out = control.control(cell, SEED, device="cpu", base=tiny)
    assert any(not c["ok"] for c in out), out


def _frozen(make):
    def fake(*a, **k):
        step, opt = make(*a, **k)

        def frozen(state, cams, targets):
            saved = {n: p.detach().clone() for n, p in state.params.items()}
            state, loss = step(state, cams, targets)
            with torch.no_grad():
                for n, p in state.params.items():
                    p.copy_(saved[n])
            return state, loss
        return frozen, opt
    return fake


def _half_rows(make):
    def fake(template, camera, **k):
        step, opt = make(template, camera._replace(height=camera.height // 2),
                         **k)

        def halfstep(state, cams, targets):
            return step(state, cams, targets[:, :camera.height // 2])
        return halfstep, opt
    return fake


FAULTS = {
    ("fit-1m-1080p", "state unchanged"):
        ("sage3d_tpu_torch.parallel.train", "make_train_step", _frozen),
    ("fit-1m-1080p", "half the batch"):
        ("sage3d_tpu_torch.parallel.train", "make_train_step", _half_rows),
    ("fit-1m-1080p", "answer altered"):
        ("sage3d_tpu_torch.parallel.train", "render_batch",
         lambda f: altered(f, "rgb", 0.1)),
    ("render-8cam-1080p", "answer altered"):
        ("sage3d_tpu_torch.renderer.render", "render_batch",
         lambda f: altered(f, "rgb", 0.5)),
    ("render-8cam-1080p", "half the batch"):
        ("sage3d_tpu_torch.renderer.render", "render_batch", halved),
    ("nav-env-1", "state unchanged"):
        ("sage3d_tpu_torch.env.vln_env", "apply_cmd",
         lambda f: (lambda state, *a, **k: state)),
    ("nav-env-1", "answer altered"):
        ("sage3d_tpu_torch.env.vln_env", "render",
         lambda f: altered(f, "depth", 5.0)),
    ("nav-lockstep-8", "state unchanged"):
        ("sage3d_tpu_torch.env.rollout", "apply_cmd",
         lambda f: (lambda state, *a, **k: state)),
    ("nav-lockstep-8", "answer altered"):
        ("sage3d_tpu_torch.env.rollout", "render_batch",
         lambda f: altered(f, "depth", 5.0)),
    ("nav-lockstep-8", "half the batch"):
        ("sage3d_tpu_torch.env.rollout", "render_batch", halved),
}


@pytest.mark.parametrize("cell, fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    import importlib
    module, name, breaker = FAULTS[(cell, fault)]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, breaker(getattr(mod, name)))
    out = run(tiny, cell)
    assert not out["correct"] and failed(out), out["compared"]
