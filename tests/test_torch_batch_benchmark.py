"""The multi-scene batch benchmark through the port (``bench/batch.py``) and
the JAX package on the CPU: the non-CLI tests of
``tests/test_batch_benchmark.py`` (discovery and matching, the hot swap with
its artifacts and resume, all 13 measures, file sharding), with the JAX
package's runs beside the port's; a scene bundle built by the port and
loaded by both packages; the env and the batch runner on bundles, with
budgets set per scene at the hot swap."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sage3d_tpu.bench import batch as jbatch
from sage3d_tpu.data import scene_build as jbuild
from sage3d_tpu.env.vln_env import GaussianVLNEnv as JEnv
from sage3d_tpu.renderer.scene import save_ply, synthetic_room
from sage3d_tpu_torch.bench import batch as tbatch
from sage3d_tpu_torch.data import scene_build as tbuild
from sage3d_tpu_torch.env.vln_env import GaussianVLNEnv as TEnv
from sage3d_tpu_torch.renderer.camera import agent_camera, stack_cameras
from sage3d_tpu_torch.renderer.render import autotune_poses, budget_kwargs
from tests.test_batch_benchmark import _gvln, _semantic_map

TOL = 1e-4      # measurements (tests/test_torch_bench_harness.py)
SIZE = dict(width=64, height=48)
MEASURES = {"distance_to_goal", "success", "oracle_success", "path_length",
            "spl", "navigation_error", "collision_count",
            "continuous_success_ratio", "integrated_collision_penalty",
            "path_smoothness", "episode_time", "explored_areas",
            "exploration_coverage"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this file runs: beside the suite's other
    workers, torch's own pool on every worker oversubscribes the cores, and
    the many small ops of the planner and the CPU renders then wait on each
    other (the pipeline ran ~15x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def policy(images, instruction, current_yaw, depth_images=None):
    return {"vx": 0.3, "vy": 0.0, "yaw_rate": 0.0, "duration_s": 1.0,
            "stop": False, "parsed_from": "scripted"}


def labels_of(scene) -> list:
    """labels.json records: each object's AABB (semantic ids 1..8)."""
    means = np.asarray(scene.means)
    sem = np.asarray(scene.semantic_ids)
    out = []
    for k in range(1, int(sem.max()) + 1):
        lo, hi = means[sem == k].min(0), means[sem == k].max(0)
        corners = [{"x": float(x), "y": float(y), "z": float(z)}
                   for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                   for z in (lo[2], hi[2])]
        out.append({"label": f"object{k}", "ins_id": k,
                    "bounding_box": corners})
    return out


@pytest.fixture(scope="module")
def batch_world(tmp_path_factory):
    """tests/test_batch_benchmark.py's world: two PLY rooms, their maps, a
    nested test tree and a file discovery must ignore."""
    tmp = tmp_path_factory.mktemp("tbatch")
    scenes, maps, tests_dir = tmp / "scenes", tmp / "maps", tmp / "tests"
    for d in (scenes, maps, tests_dir / "nested"):
        d.mkdir(parents=True)
    for i, name in enumerate(["roomA", "roomB"]):
        save_ply(synthetic_room(num_gaussians=200, seed=20 + i),
                 str(scenes / f"{name}.ply"))
        (maps / f"2D_Semantic_Map_{name}_Complete.json").write_text(
            json.dumps(_semantic_map()))
    (tests_dir / "test_roomA.json").write_text(json.dumps(_gvln("roomA")))
    (tests_dir / "nested" / "test_roomB.json").write_text(
        json.dumps(_gvln("roomB")))
    (tests_dir / "notes.json").write_text("{}")
    return tmp


def measurements(out_dir, scene_names) -> dict:
    return {str(p.relative_to(out_dir)): json.loads(p.read_text())[
        "measurements"] for name in scene_names
        for p in sorted(out_dir.glob(f"{name}/*/measurements/*.json"))}


def assert_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys(), k
        for m in want[k]:
            np.testing.assert_allclose(got[k][m], want[k][m], rtol=TOL,
                                       atol=TOL, err_msg=f"{k} {m}")


def test_discovery_and_matching_parity(batch_world):
    files = tbatch.find_test_json_files(batch_world / "tests")
    assert files == jbatch.find_test_json_files(batch_world / "tests")
    assert sorted(f.split("/")[-1] for f in files) == ["test_roomA.json",
                                                      "test_roomB.json"]
    for f in files:
        assert tbatch.get_scene_name_from_json(f) == \
            jbatch.get_scene_name_from_json(f)
        for folder in ("scenes", "maps"):
            assert tbatch.find_matching_scene_file(f, batch_world / folder) \
                == jbatch.find_matching_scene_file(f, batch_world / folder)
            assert tbatch.find_matching_map_file(f, batch_world / folder) \
                == jbatch.find_matching_map_file(f, batch_world / folder)
    file_a = next(f for f in files if f.endswith("test_roomA.json"))
    assert tbatch.find_matching_scene_file(
        file_a, batch_world / "scenes").endswith("roomA.ply")


def test_batch_run_hot_swap_and_artifacts_parity(batch_world):
    ply = str(batch_world / "scenes" / "roomA.ply")
    runs = {}
    for pkg, env, batch in (
            ("jax", JEnv(ply, map_json=None, backend="xla", **SIZE), jbatch),
            ("torch", TEnv(ply, map_json=None, device="cpu", **SIZE), tbatch)):
        out_dir = batch_world / f"out_{pkg}"
        summary = batch.run_batch_benchmark(
            env, batch_world / "tests", batch_world / "scenes",
            batch_world / "maps", policy, out_dir, max_steps=4,
            model_info="test-policy", quiet=True)
        again = batch.run_batch_benchmark(
            env, batch_world / "tests", batch_world / "scenes",
            batch_world / "maps", policy, out_dir, max_steps=4, quiet=True)
        runs[pkg] = (summary, again, env, out_dir)
    summary, again, env, out_dir = runs["torch"]
    bs = summary["batch_summary"]
    assert bs["total_json_files"] == bs["total_episodes"] == 2
    assert all(r["status"] == "ok" for r in summary["file_results"])
    assert (out_dir / "batch_test_summary.json").exists()
    assert env.semantic_map_path.endswith("2D_Semantic_Map_roomA_Complete.json")
    assert int(env.total_overflow) == 0
    for scene_name in ("roomA", "roomB"):
        ep_dir = out_dir / scene_name / "1-0"
        assert (ep_dir / "measurements" / "1-0.json").exists()
        assert (ep_dir / "trajectory_1-0.png").exists()
        log = (ep_dir / "episode.log").read_text()
        assert "[EPISODE]" in log and "[MEASURE]" in log
    assert all(r.get("num_skipped", 0) == 1 for r in again["file_results"])
    want = runs["jax"]
    for key in ("total_json_files", "total_episodes", "successful_episodes",
                "failed_episodes", "overall_success_rate"):
        assert bs[key] == want[0]["batch_summary"][key], key
    assert [r["scene_name"] for r in summary["file_results"]] == \
        [r["scene_name"] for r in want[0]["file_results"]]
    assert_close(measurements(out_dir, ("roomA", "roomB")),
                 measurements(want[3], ("roomA", "roomB")))


def test_batch_covers_all_13_measures_parity(batch_world, tmp_path):
    gvln = _gvln("roomA")
    gvln["scenes"][0]["samples"][0]["instructions"].append(
        {"generated_instruction": "Explore the room freely.",
         "instruction_type": "Goal-less", "start": "label_0",
         "end": "label_0"})
    tests_dir = tmp_path / "tests"
    tests_dir.mkdir()
    (tests_dir / "test_roomA.json").write_text(json.dumps(gvln))
    ply = str(batch_world / "scenes" / "roomA.ply")
    seen = {}
    for pkg, env, batch in (
            ("jax", JEnv(ply, map_json=None, backend="xla", **SIZE), jbatch),
            ("torch", TEnv(ply, map_json=None, device="cpu", **SIZE), tbatch)):
        out_dir = tmp_path / f"out_{pkg}"
        batch.run_batch_benchmark(env, tests_dir, batch_world / "scenes",
                                  batch_world / "maps", policy, out_dir,
                                  max_steps=3, quiet=True)
        seen[pkg] = measurements(out_dir, ("roomA",))
    assert set().union(*(m.keys() for m in seen["torch"].values())) == MEASURES
    assert_close(seen["torch"], seen["jax"])


@pytest.mark.parametrize("instance_id", [0, 1])
def test_batch_file_sharding(batch_world, tmp_path, instance_id):
    """Each of two instances runs its half of the files, as the JAX
    package's ``i % total`` rule picks them."""
    files = tbatch.find_test_json_files(batch_world / "tests")
    env = TEnv(str(batch_world / "scenes" / "roomA.ply"), map_json=None,
               device="cpu", **SIZE)
    summary = tbatch.run_batch_benchmark(
        env, batch_world / "tests", batch_world / "scenes",
        batch_world / "maps", policy, tmp_path, max_steps=2, quiet=True,
        instance_id=instance_id, total_instances=2)
    assert [r["json_file"] for r in summary["file_results"]] == \
        [f for i, f in enumerate(files) if i % 2 == instance_id]
    assert summary["file_results"][0]["status"] == "ok"


@pytest.fixture(scope="module")
def bundles(batch_world):
    """roomA and roomB as bundles built by the port, each labelled with its
    8 objects' boxes; a test tree that names them."""
    root = batch_world / "bundles"
    labels = batch_world / "labels"
    labels.mkdir()
    out = {}
    for i, name in enumerate(["roomA", "roomB"]):
        lab = labels / f"{name}.json"
        lab.write_text(json.dumps(labels_of(synthetic_room(200, seed=20 + i))))
        out[name] = tbuild.build_scene_bundle(
            batch_world / "scenes" / f"{name}.ply", lab,
            batch_world / "maps" / f"2D_Semantic_Map_{name}_Complete.json",
            root, device="cpu")
    return root, out


def test_scene_bundle_round_trip(bundles, batch_world, tmp_path):
    """The port's bundle equals the JAX package's, and both packages load
    it to equal arrays; the port's env takes its manifest.json."""
    root, manifests = bundles
    for name, manifest in manifests.items():
        lab = batch_world / "labels" / f"{name}.json"
        want = jbuild.build_scene_bundle(
            batch_world / "scenes" / f"{name}.ply", lab,
            batch_world / "maps" / f"2D_Semantic_Map_{name}_Complete.json",
            tmp_path)
        assert json.loads(manifest.read_text()) == json.loads(want.read_text())
        assert (manifest.parent / "scene.ply").read_bytes() == \
            (want.parent / "scene.ply").read_bytes()
        tscene, tmap = tbuild.load_scene_bundle(manifest, device="cpu")
        jscene, jmap = jbuild.load_scene_bundle(manifest)
        assert tmap == jmap
        for f in jscene._fields:
            assert np.array_equal(getattr(tscene, f).numpy(),
                                  np.asarray(getattr(jscene, f))), f
        ids = tscene.semantic_ids.numpy()
        assert set(ids[ids >= 0].tolist()) == set(range(1, 9))
        env = TEnv(str(manifest), map_json=None, device="cpu", **SIZE)
        for f in tscene._fields:
            assert torch.equal(getattr(env.scene, f), getattr(tscene, f)), f
    # resume: an existing bundle is returned as it is
    assert tbuild.build_scene_bundle(
        batch_world / "scenes" / "roomA.ply", "unread", "unread", root,
        device="cpu") == manifests["roomA"]


@pytest.mark.parametrize("layout", ["scene_ply", "manifest"])
def test_batch_on_bundles_with_budgets_per_scene(bundles, batch_world,
                                                 tmp_path, layout):
    """The hot swap between two bundles on one env: each scene's budgets
    (autotune_poses over its start poses) are set with it; nothing
    overflows, and the env ends on the last file's scene and budgets. The
    runner matches a bundle's ``scene.ply`` before its ``manifest.json`` (as
    the JAX package does); with the PLY under another name it loads the
    bundle through the manifest."""
    root, manifests = bundles
    if layout == "manifest":
        shutil.copytree(root, tmp_path / "bundles")
        root = tmp_path / "bundles"
        manifests = {name: root / name / "manifest.json" for name in manifests}
        for manifest in manifests.values():
            m = json.loads(manifest.read_text())
            (manifest.parent / "scene.ply").rename(manifest.parent /
                                                   "gaussians.ply")
            manifest.write_text(json.dumps({**m, "scene_ply": "gaussians.ply"}))
    loaded = []
    load_bundle = tbuild.load_scene_bundle

    def spy(path, device=None):
        loaded.append(Path(path).parent.name)
        return load_bundle(path, device=device)
    budgets = {}
    for name, manifest in manifests.items():
        scene, _ = tbuild.load_scene_bundle(manifest, device="cpu")
        cams = stack_cameras([agent_camera(xy, yaw, device="cpu", **SIZE)
                              for xy, yaw in (((-3.0, -3.0), 0.8),
                                              ((0.0, 0.0), 2.0))])
        budgets[name] = autotune_poses(scene, cams, pair_margin=1.5)
    assert budgets["roomA"] != budgets["roomB"]
    env = TEnv(str(manifests["roomB"]), map_json=None, device="cpu", **SIZE)
    tbuild.load_scene_bundle = spy
    try:
        summary = tbatch.run_batch_benchmark(
            env, batch_world / "tests", root, batch_world / "maps", policy,
            tmp_path / "out", max_steps=3, quiet=True, budgets=budgets)
    finally:
        tbuild.load_scene_bundle = load_bundle
    assert loaded == ([] if layout == "scene_ply" else ["roomB", "roomA"])
    assert [r["status"] for r in summary["file_results"]] == ["ok", "ok"]
    assert summary["batch_summary"]["total_episodes"] == 2
    assert int(env.total_overflow) == 0
    assert env.render_kw == budget_kwargs(budgets["roomA"])
    last, _ = tbuild.load_scene_bundle(manifests["roomA"], device="cpu")
    assert torch.equal(env.scene.means, last.means)
    assert env.semantic_map_path.endswith("2D_Semantic_Map_roomA_Complete.json")
