"""The SAGE-Bench harness through the port (``bench/``, ``serve/``,
``env/vln_env.py``) and the JAX package on the CPU: the ``world`` of
``tests/test_bench_harness.py`` built in both packages (synthetic room,
semantic map, GVLN episode file), the adapter, task, success and measure
cases, and closed-loop episodes of the oracle policy through both runners;
the scripted socket server, batch-and-resume and no-goal cases on the port."""

import json
import math
import sys

import numpy as np
import pytest
import torch

from sage3d_tpu.bench import episodes as jepisodes
from sage3d_tpu.bench import measures as jmeasures
from sage3d_tpu.bench import runner as jrunner
from sage3d_tpu.bench import success as jsuccess
from sage3d_tpu.bench import tasks as jtasks
from sage3d_tpu.env.vln_env import GaussianVLNEnv as JEnv
from sage3d_tpu.physics import occupancy as jocc
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu.serve.policy import OraclePolicy as JOracle
from sage3d_tpu_torch.bench import episodes as tepisodes
from sage3d_tpu_torch.bench import measures as tmeasures
from sage3d_tpu_torch.bench import runner as trunner
from sage3d_tpu_torch.bench import success as tsuccess
from sage3d_tpu_torch.bench import tasks as ttasks
from sage3d_tpu_torch.env.protocol import VLNEnvProtocol, assert_conforms
from sage3d_tpu_torch.env.vln_env import GaussianVLNEnv as TEnv
from sage3d_tpu_torch.physics import occupancy as tocc
from sage3d_tpu_torch.renderer.scene import scene_from_numpy
from sage3d_tpu_torch.serve.policy import OraclePolicy as TOracle
from sage3d_tpu_torch.serve.policy import make_socket_policy
from sage3d_tpu_torch.serve.scripted_server import ScriptedPolicyServer
from sage3d_tpu_torch.utils.transforms import (map_to_world_xy,
                                               world_quat_from_map_yaw)

TOL = 1e-4          # measurements, trajectories, frames
DEPTH_TOL = 1e-3    # depth = depth_acc + T * far (50 m): the render tests'
BOUNDS = (0.0, 10.0, 0.0, 10.0)


def make_semantic_map():
    """10x10 m room: boundary walls, one table object, in map-frame meters."""
    wall = []
    for i in range(101):
        t = i / 10.0
        wall += [[0.0, t], [10.0, t], [t, 0.0], [t, 10.0]]
    table = [[y / 10.0, x / 10.0] for y in range(60, 71) for x in range(70, 81)]
    floor = [[y, x] for y in np.linspace(0, 10, 11) for x in np.linspace(0, 10, 11)]
    return [
        {"category_label": "Wall", "instance_id": 0, "item_id": "label_0",
         "mask_coords_m": wall, "bbox_m": [0, 0, 10, 10]},
        {"category_label": "Table", "instance_id": 3, "item_id": "label_3",
         "mask_coords_m": table, "bbox_m": [7.0, 6.0, 8.0, 7.0]},
        {"category_label": "floor", "instance_id": 9, "item_id": "label_9",
         "mask_coords_m": floor, "bbox_m": [0, 0, 10, 10]},
    ]


def world_pt(mx, my, z=0.5):
    wx, wy = map_to_world_xy(mx, my, BOUNDS)
    return [float(wx), float(wy), z]


def make_gvln_json(tmp_path):
    """Trajectory from map (2,2) to the table at (7.5, 6.5), world frame."""
    waypoints_map = [(2.0, 2.0), (3.5, 3.0), (5.0, 4.0), (6.5, 5.5), (7.3, 6.3)]
    points = []
    for i, (mx, my) in enumerate(waypoints_map):
        if i < len(waypoints_map) - 1:
            nx, ny = waypoints_map[i + 1]
            rot = list(world_quat_from_map_yaw(math.atan2(ny - my, nx - mx)))
        else:
            rot = [0.0, 0.0, 0.0, 1.0]
        points.append({"position": world_pt(mx, my), "rotation": rot})
    data = {"scenes": [{
        "scene_id": 1, "scene_name": "synthroom",
        "samples": [{
            "trajectory_id": "7",
            "instructions": [
                {"generated_instruction": "Walk to the table.",
                 "instruction_type": "AC", "start": "label_0",
                 "end": "label_3"}],
            "points": points}]}]}
    p = tmp_path / "trajectories_overall_test_synthroom.json"
    p.write_text(json.dumps(data))
    map_p = tmp_path / "2D_Semantic_Map_synthroom_Complete.json"
    map_p.write_text(json.dumps(make_semantic_map()))
    return p, map_p


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    traj_path, map_path = make_gvln_json(tmp)
    js = synthetic_room(num_gaussians=300, seed=11)
    ts = scene_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          device="cpu")
    jenv = JEnv(js, map_json=str(map_path), width=64, height=48,
                backend="xla")
    tenv = TEnv(ts, map_json=str(map_path), width=64, height=48,
                device="cpu")
    jeps = jepisodes.adapt_gvln_to_episodes(traj_path, "synthroom.ply")
    teps = tepisodes.adapt_gvln_to_episodes(traj_path, "synthroom.ply")
    return jenv, tenv, jeps, teps, tmp


def _close(got, want, what):
    """Nested dicts/lists: numbers within TOL, everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    elif isinstance(want, (bool, str, type(None))):
        assert got == want, what
    else:
        assert float(got) == pytest.approx(float(want), abs=TOL), what


def test_adapter_schema_equal(world):
    _, _, jeps, teps, _ = world
    assert teps == jeps
    ep = teps[0]
    assert ep["episode_id"] == "7-0" and ep["end_item"] == "label_3"
    assert len(ep["gt_locations"]) == 5 and ep["goals"][0]["radius"] == 0.5


@pytest.mark.parametrize("episode", [
    {"instructions": ["go"]},
    {"instructions": [{"generated_instruction": "x",
                       "instruction_type": "Goal-less"}]},
    {"target_object": "chair"}, {"goal_position": [0, 0, 0]},
    {"target_image": "x"},
    {"instruction_type": "Goal-less",
     "instruction": {"instruction_text": "Explore."}},
    {"instruction_type": "AC", "instruction": {"instruction_text": "Walk."}},
])
def test_task_inference_equal(episode):
    assert ttasks.TaskTypeManager.infer_task_type(episode) == \
        jtasks.TaskTypeManager.infer_task_type(episode)


@pytest.mark.parametrize("task", ["vln", "objectnav", "pointnav",
                                  "nogoalnav"])
def test_adapt_episode_for_task_equal(task, world):
    ep = {"instructions": ["Go to the chair near the window"],
          "points": [{"position": [0, 0, 0]}, {"position": [1, 1, 0]}]}
    assert ttasks.adapt_episode_for_task(ep, task) == \
        jtasks.adapt_episode_for_task(ep, task)
    ep2 = world[3][0]
    assert ttasks.adapt_episode_for_task(ep2, task) == \
        jtasks.adapt_episode_for_task(world[2][0], task)


def test_object_priority_equal():
    for item, cat in (("label_1", "Projection Screen"), ("label_2", "Dining Table"),
                      ("label_3", "Office Chair"), ("label_4", "Unable Area"),
                      ("label_5", "Plant")):
        assert tsuccess.object_priority(item, cat) == \
            jsuccess.object_priority(item, cat)


def test_object_based_success_equal(world):
    _, _, jeps, teps, _ = world
    inst = make_semantic_map()
    jgrid = jocc.grid_from_semantic_map(inst)
    tgrid = tocc.grid_from_semantic_map(inst, device="cpu")
    cases = [(7.5, 6.5), (2.0, 2.0), (7.9, 6.9), (9.0, 6.5), (6.5, 5.5),
             (0.02, 5.0)]
    for detector in (None, "grid"):
        jev = jsuccess.ObjectBasedSuccessEvaluator(
            inst, collision_detector=jgrid if detector else None)
        tev = tsuccess.ObjectBasedSuccessEvaluator(
            inst, collision_detector=tgrid if detector else None)
        for ep_mod in (lambda e: e, lambda e: {**e, "end_item": "label_9",
                                               "instructions": []}):
            for mx, my in cases:
                pos = np.array(world_pt(mx, my))
                got = tev.evaluate_success(pos, ep_mod(teps[0]))
                want = jev.evaluate_success(pos, ep_mod(jeps[0]))
                _close(list(got), list(want), f"{detector} ({mx}, {my})")
    # standing at the table is a success; in the wall's inflation it is not
    tev = tsuccess.ObjectBasedSuccessEvaluator(inst, collision_detector=tgrid)
    assert tev.evaluate_success(np.array(world_pt(7.5, 6.5)), teps[0])[0]
    assert not tev._collision_free(world_pt(0.02, 5.0))


def test_success_collision_check_fails_loudly():
    """The JAX evaluator swallows any error of its collision test and calls
    the position collision-free; the port's raises."""
    tev = tsuccess.ObjectBasedSuccessEvaluator(
        make_semantic_map(), collision_detector=object())
    with pytest.raises(AttributeError):
        tev._collision_free([1.0, 1.0])


def _drive(env, ep, cmds, mm):
    env.set_start_pose(ep["start_position"], ep["start_rotation"])
    env.reset_episode_time()
    mm.reset(env)
    for c in cmds:
        env.update_time_and_reset_collision()
        env.apply_cmd_for(*c)
        mm.update(env)
    return mm.dump()


def test_measures_equal(world):
    jenv, tenv, jeps, teps, _ = world
    cmds = [(0.3, 0.0, 0.1, 1.0), (0.5, 0.1, -0.4, 1.0), (0.0, 0.0, 1.0, 0.5),
            (1.0, 0.0, 0.0, 1.0), (0.2, -0.1, 0.3, 2.0)] * 3
    for build in ("default_measures", "nogoal_measures"):
        want = _drive(jenv, jeps[0], cmds,
                      getattr(jmeasures, build)(jeps[0]))
        got = _drive(tenv, teps[0], cmds, getattr(tmeasures, build)(teps[0]))
        _close(got, want, build)
    assert got["episode_time"] > 0
    got = _drive(tenv, teps[0], cmds, tmeasures.default_measures(teps[0]))
    assert got["path_length"] > 0


def test_set_start_pose_equal(world):
    jenv, tenv, jeps, teps, _ = world
    jenv.set_start_pose(jeps[0]["start_position"], jeps[0]["start_rotation"])
    tenv.set_start_pose(teps[0]["start_position"], teps[0]["start_rotation"])
    assert tenv.get_yaw() == pytest.approx(jenv.get_yaw(), abs=1e-6)
    np.testing.assert_array_equal(tenv.get_agent_pos(), jenv.get_agent_pos())


def test_get_rgbd_matches_jax_env(world):
    jenv, tenv, jeps, teps, _ = world
    for env, ep in ((jenv, jeps[0]), (tenv, teps[0])):
        env.set_start_pose(ep["start_position"], ep["start_rotation"])
        env.apply_cmd_for(0.4, 0.0, 0.3, 1.0)
    np.testing.assert_allclose(tenv.get_agent_pos(), jenv.get_agent_pos(),
                               atol=1e-5)
    jrgb, jdepth = jenv.get_rgbd()
    trgb, tdepth = tenv.get_rgbd()
    assert trgb.shape == jrgb.shape == (48, 64, 3) and trgb.dtype == np.uint8
    np.testing.assert_allclose(tdepth, jdepth, rtol=DEPTH_TOL, atol=DEPTH_TOL)
    # uint8 frames: the f32 colors within TOL may round to neighbours
    assert np.abs(trgb.astype(int) - jrgb.astype(int)).max() <= 1
    frame = tenv.render_frame()
    want = jenv.render_frame()
    for k in ("rgb", "trans", "alpha"):
        np.testing.assert_allclose(frame[k].numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert int(tenv.total_overflow) == 0


def test_oracle_episode_equal_through_both_runners(world):
    jenv, tenv, jeps, teps, tmp = world
    want = jrunner.run_episode(jenv, jeps[0], JOracle(jenv, jeps[0]),
                               max_steps=120)
    got = trunner.run_episode(tenv, teps[0], TOracle(tenv, teps[0]),
                              max_steps=120, output_dir=str(tmp / "out"))
    for k in ("steps_run", "stop_called", "task_type", "instruction"):
        assert got["episode_info"][k] == want["episode_info"][k], k
    _close(got["measurements"], want["measurements"], "measurements")
    _close(got["trajectory"], want["trajectory"], "trajectory")
    m = got["measurements"]
    assert got["episode_info"]["stop_called"]
    assert m["success"] == 1.0 and m["spl"] > 0.3 and m["oracle_success"] == 1.0
    assert trunner.check_episode_completed(tmp / "out", "synthroom", "7-0")


def test_scripted_server_closed_loop(world):
    _, tenv, _, teps, _ = world
    with ScriptedPolicyServer(script=["MOVE_FORWARD", "TURN_LEFT",
                                      "MOVE_FORWARD", "STOP"]) as srv:
        policy = make_socket_policy(host="127.0.0.1", port=srv.port)
        rec = trunner.run_episode(tenv, teps[0], policy, max_steps=10)
        assert srv.request_count >= 4
    assert rec["episode_info"]["stop_called"]          # STOP honoured
    assert rec["episode_info"]["steps_run"] == 4


def test_run_benchmark_batch_and_resume(world):
    _, tenv, _, teps, tmp = world
    out_dir = tmp / "batch"
    policy = TOracle(tenv, teps[0])
    summary = trunner.run_benchmark(tenv, teps, policy,
                                    output_dir=str(out_dir), max_steps=120)
    assert summary["num_episodes"] == 1 and summary["num_failures"] == 0
    assert summary["metrics"]["success"] == 1.0
    assert (out_dir / "batch_test_summary.json").exists()
    summary2 = trunner.run_benchmark(tenv, teps, policy,
                                     output_dir=str(out_dir))
    assert summary2["num_skipped"] == 1 and summary2["num_episodes"] == 0


def test_nogoal_episode(world):
    _, tenv, _, teps, _ = world
    ep = dict(teps[0], task_type="no_goal_exploration", episode_id="7-ng")

    def wander(images, instruction, current_yaw=0.0, depth_images=None, **kw):
        return {"vx": 0.3, "vy": 0.0, "yaw_rate": 0.3, "duration_s": 1.0,
                "stop": True}  # STOP must be overridden into exploration

    rec = trunner.run_episode(tenv, ep, wander, max_steps=15,
                              task_type="nogoalnav")
    m = rec["measurements"]
    assert "episode_time" in m and "explored_areas" in m
    assert rec["episode_info"]["stop_override_count"] > 0
    assert m["explored_areas"] >= 1.0


def test_missing_pillow_fails_the_episode(world, monkeypatch):
    """Without Pillow the episode raises; it does not run on fallback
    actions."""
    _, tenv, _, teps, _ = world
    answered = []

    def policy(**kw):
        answered.append(1)
        return {"vx": 0.1, "stop": False}

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        trunner.run_episode(tenv, teps[0], policy, max_steps=3)
    assert not answered


def test_env_conforms_to_protocol(world):
    _, tenv, _, teps, _ = world
    assert isinstance(tenv, VLNEnvProtocol)
    assert_conforms(tenv)
    tenv.set_start_pose(teps[0]["start_position"], teps[0]["start_rotation"])
    tenv.reset_episode_time()
    t0 = tenv.episode_time_s
    tenv.apply_cmd_for(0.2, 0.0, 0.0, 1.0)
    assert tenv.episode_time_s > t0
    assert tenv.get_collision_count() >= 0 and tenv.consecutive_collisions >= 0
    assert isinstance(tenv.collision_detected, bool)

    class Broken:
        def get_agent_pos(self):
            return np.zeros(3)

        def get_yaw(self):
            return 0.0

    with pytest.raises(TypeError, match="consecutive_collisions"):
        assert_conforms(Broken())


def test_env_device_and_backend_rules(world, tmp_path):
    _, tenv, _, _, _ = world
    assert tenv.device.type == "cpu" and tenv.backend == "torch"
    assert tenv.scene.means.device.type == "cpu"
    assert tenv.grid.obstacle.device.type == "cpu"
    # a scene bundle (manifest.json) loads onto the env's device
    from sage3d_tpu_torch.data.scene_build import build_scene_bundle
    from sage3d_tpu_torch.renderer.scene import save_ply
    save_ply(tenv.scene, tmp_path / "room.ply")
    (tmp_path / "labels.json").write_text("[]")
    manifest = build_scene_bundle(tmp_path / "room.ply",
                                  tmp_path / "labels.json", "map.json",
                                  tmp_path / "bundles", device="cpu")
    benv = TEnv(str(manifest), device="cpu")
    assert benv.device.type == "cpu" and benv.backend == "torch"
    assert torch.equal(benv.scene.means, tenv.scene.means)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TEnv(tenv.scene)
