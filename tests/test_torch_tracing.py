"""The port's spans and counters (``utils/profiling.py``) on the CPU: off by
default and free there, nested per layer with one unit id a train step,
lockstep step or render, bitwise neutral to what they wrap, resolved across
threads, and written by ``trace()`` beside the profiler's events.

The fixtures are small: 400 Gaussians at 64x48, through the ``cuda``
backend's plain versions."""

import json
import threading

import numpy as np
import pytest
import torch

from sage3d_tpu_torch.env import rollout as troll
from sage3d_tpu_torch.env.vln_env import GaussianVLNEnv
from sage3d_tpu_torch.ops.binning import bin_gaussians, emission_plan
from sage3d_tpu_torch.ops.projection import project_gaussians
from sage3d_tpu_torch.parallel import train as ttrain
from sage3d_tpu_torch.physics.occupancy import grid_from_mask
from sage3d_tpu_torch.renderer import camera as tcam
from sage3d_tpu_torch.renderer.render import render
from sage3d_tpu_torch.renderer.scene import synthetic_room
from sage3d_tpu_torch.utils import profiling as prof

W, H = 64, 48
CAP = dict(pair_capacity=1 << 14, tile_capacity=512)
STARTS = torch.tensor([[0.0, -3.0], [0.5, -2.5]])
YAWS = torch.tensor([1.57, 1.3])
GOALS = torch.tensor([[2.0, 2.0], [-2.0, 2.0]])
STEP_CHILDREN = {"rollout.camera", "render", "rollout.policy",
                 "rollout.motion", "rollout.collision", "rollout.metrics"}


@pytest.fixture(scope="module")
def scene():
    return synthetic_room(num_gaussians=400, seed=5, device="cpu")


@pytest.fixture
def cam():
    return tcam.agent_camera((0.0, -3.5), 1.3, width=W, height=H,
                             device="cpu")


@pytest.fixture(scope="module")
def grid():
    m = np.zeros((100, 100), np.uint8)
    m[:3, :] = m[-3:, :] = 1
    m[:, :3] = m[:, -3:] = 1
    return grid_from_mask(m, bounds=[-5.0, 5.0, -4.0, 4.0], device="cpu")


@pytest.fixture(autouse=True)
def fresh_recorder():
    prof.disable()
    prof.reset()
    yield
    prof.disable()
    prof.reset()


def recorded(fn):
    """``fn()``'s result and the spans it recorded."""
    prof.reset()
    prof.enable()
    try:
        out = fn()
    finally:
        prof.disable()
    return out, prof.spans()


def by_id(items):
    return {s.id: s for s in items}


def children(items, parent):
    return [s for s in items if s.parent == parent.id]


def assert_nested(items):
    """Every span lies inside its parent in time, and shares its unit."""
    ids = by_id(items)
    for s in items:
        assert s.start <= s.end
        if s.parent is not None:
            p = ids[s.parent]
            assert p.start <= s.start and s.end <= p.end, (p.name, s.name)
            assert s.unit == p.unit, (p.name, s.name)


def test_off_records_nothing_and_returns_the_shared_noop():
    noop = prof.span("render")
    assert prof.span("train.step", unit=True) is noop
    with prof.span("render"):
        prof.count("binning.kept_pairs", 5)
    assert prof.spans() == [] and prof.counters() == {}


def test_render_spans_nest_with_one_unit_and_count_the_binning(scene, cam):
    out, items = recorded(lambda: render(scene, cam, backend="cuda", **CAP))
    names = [s.name for s in items]
    assert names.count("render") == 1
    top = next(s for s in items if s.name == "render")
    assert top.parent is None and top.unit == 0
    assert [s.name for s in children(items, top)] == [
        "render.project", "render.bin", "render.composite"]
    binning = next(s for s in items if s.name == "render.bin")
    assert [s.name for s in children(items, binning)] == [
        "binning.read_live", "binning.read_kept"]
    assert {s.unit for s in items} == {0}
    assert_nested(items)
    with torch.no_grad():
        proj = project_gaussians(scene, cam)
        bins = bin_gaussians(proj, W, H)
        plan = emission_plan(proj, W, H)
    counted = prof.counters()
    assert counted["binning.kept_pairs"] == int(bins.n_pairs.sum()) > 0
    assert counted["binning.live_slots"] == plan.n_live > 0
    assert counted["binning.cameras"] == 1
    assert int(out["overflow"]) == 0


def _train_once(scene, cam):
    opt = ttrain.make_group_optimizer()
    step, _ = ttrain.make_train_step(scene, cam, optimizer=opt,
                                     backend="cuda", **CAP)
    state = ttrain.init_train_state(scene, opt)
    cams = tcam.stack_cameras([cam])
    with torch.no_grad():
        target = render(scene, cam, backend="cuda", **CAP)["rgb"][None] * 0.9
    state, loss = step(state, cams, target + 0.05)
    return {"loss": loss, **{k: v.detach() for k, v in state.params.items()}}


def _rollout(scene, grid):
    return troll.rollout_batch(scene, grid, STARTS, YAWS, GOALS, n_steps=3,
                               width=W, height=H, backend="cuda",
                               device="cpu", **CAP)


@pytest.mark.parametrize("what", ["render", "train_step", "rollout"])
def test_recorder_on_and_off_give_bitwise_the_same(scene, cam, grid, what):
    run = {"render": lambda: render(scene, cam, backend="cuda", **CAP),
           "train_step": lambda: _train_once(scene, cam),
           "rollout": lambda: _rollout(scene, grid)}[what]
    off = run()
    on, items = recorded(run)
    assert items
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_train_step_records_its_four_children_and_the_backward(scene, cam):
    _, items = recorded(lambda: _train_once(scene, cam))
    steps = [s for s in items if s.name == "train.step"]
    assert len(steps) == 1 and steps[0].parent is None
    kids = [s.name for s in children(items, steps[0])]
    assert kids == ["train.forward", "train.loss", "train.backward",
                    "train.optimizer"]
    backward = next(s for s in items if s.name == "train.backward")
    comp = [s for s in items if s.name == "composite.backward"]
    assert len(comp) == 1 and comp[0].parent == backward.id
    forward = next(s for s in items if s.name == "train.forward")
    assert [s.name for s in children(items, forward)] == ["render"]
    step_items = [s for s in items if s.unit == steps[0].unit]
    assert_nested(step_items)


def test_a_span_on_another_thread_takes_the_home_threads_parent():
    prof.enable()
    seen = {}

    def worker():
        with prof.span("composite.backward"):
            prof.count("rows", 3)
        seen["tid"] = threading.get_ident()

    with prof.span("train.step", unit=True):
        with prof.span("train.backward"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    prof.disable()
    items = by_id(prof.spans())
    comp = next(s for s in items.values() if s.name == "composite.backward")
    assert items[comp.parent].name == "train.backward"
    assert comp.thread == seen["tid"] != threading.get_ident()
    assert comp.unit == items[comp.parent].unit == 0
    assert comp.counters == {"rows": 3} and prof.counters() == {"rows": 3}


def test_rollout_records_a_unit_a_lockstep_step_with_its_children(scene,
                                                                  grid):
    _, items = recorded(lambda: _rollout(scene, grid))
    steps = [s for s in items if s.name == "rollout.step"]
    assert [s.unit for s in steps] == [0, 1, 2]
    for st in steps:
        assert st.parent is None
        assert {s.name for s in children(items, st)} == STEP_CHILDREN
    assert_nested(items)
    counted = prof.counters()
    assert counted["binning.cameras"] == 3 * len(STARTS)


def test_env_api_records_its_spans(scene, grid):
    env = GaussianVLNEnv(scene, map_json=grid, width=W, height=H,
                         device="cpu", budgets=CAP)

    def step():
        env.apply_cmd_for(0.3, 0.0, 0.2, 1.0)
        rgb, depth = env.get_rgbd()
        return rgb, depth, env.get_agent_pos(), env.get_yaw()

    _, items = recorded(step)
    names = [s.name for s in items if s.parent is None]
    assert names == ["env.apply_cmd_for", "env.render_frame",
                     "env.read_frame", "env.read_frame", "env.read_pose",
                     "env.read_pose"]
    assert {s.unit for s in items} == {0}
    cmd = next(s for s in items if s.name == "env.apply_cmd_for")
    assert {s.name for s in children(items, cmd)} == {"motion.read_scalar"}
    frame = next(s for s in items if s.name == "env.render_frame")
    assert {s.name for s in children(items, frame)} == {"camera.read_scalar",
                                                       "render"}
    assert_nested(items)


def test_trace_writes_the_spans_beside_the_profilers_events(scene, cam,
                                                            tmp_path):
    path = tmp_path / "t.json"
    with prof.trace(path) as p:
        render(scene, cam, backend="cuda", **CAP)
    assert p == str(path) and prof.span("a") is prof.span("b")
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert {"render", "render.bin", "binning.read_kept"} <= set(spans)
    top = spans["render"]
    assert top["args"]["unit"] == 0
    # on one clock: the profiler's ops of the render lie inside its span
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and e["name"] == "aten::argsort"]
    assert ops
    for e in ops:
        assert top["ts"] - 50 <= e["ts"] <= top["ts"] + top["dur"] + 50
