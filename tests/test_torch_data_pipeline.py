"""SAGE-Bench's data pipeline through the port (``sage3d_tpu_torch/data``) and
the JAX package on the CPU: every test of ``tests/test_data_pipeline.py`` and
``tests/test_prompt_templates.py`` as a parity test.

Both packages run the whole pipeline on the 12x12 m InteriorGS-style scene
of ``make_interiorgs_scene``, each in its own directory: semantic map ->
physical map -> scene text -> trajectories (mock LLM, wavefront planner) ->
2D->3D transform -> merge -> statistics -> splits -> action GT -> waypoint
images (200 Gaussians at 64x48) -> NaVILA samples. What each stage writes
must be equal as JSON; the wavefront's distance fields bitwise equal;
rendered waypoint frames within the render parity tolerance before the
uint8 conversion."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sage3d_tpu.data import actions as jactions
from sage3d_tpu.data import astar as jastar
from sage3d_tpu.data import images as jimages
from sage3d_tpu.data import llm as jllm
from sage3d_tpu.data import merge as jmerge
from sage3d_tpu.data import navila as jnavila
from sage3d_tpu.data import physical_map as jphys
from sage3d_tpu.data import prompt_templates as jprompts
from sage3d_tpu.data import scene_text as jtext
from sage3d_tpu.data import semantic_map as jsem
from sage3d_tpu.data import split as jsplit
from sage3d_tpu.data import statistics as jstats
from sage3d_tpu.data import trajectory_gen as jtg
from sage3d_tpu.data import transform_2d3d as jtrans
from sage3d_tpu.renderer import render as jrender
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.data import actions as tactions
from sage3d_tpu_torch.data import astar as tastar
from sage3d_tpu_torch.data import images as timages
from sage3d_tpu_torch.data import llm as tllm
from sage3d_tpu_torch.data import merge as tmerge
from sage3d_tpu_torch.data import navila as tnavila
from sage3d_tpu_torch.data import physical_map as tphys
from sage3d_tpu_torch.data import prompt_templates as tprompts
from sage3d_tpu_torch.data import scene_text as ttext
from sage3d_tpu_torch.data import semantic_map as tsem
from sage3d_tpu_torch.data import split as tsplit
from sage3d_tpu_torch.data import statistics as tstats
from sage3d_tpu_torch.data import trajectory_gen as ttg
from sage3d_tpu_torch.data import transform_2d3d as ttrans
from sage3d_tpu_torch.renderer import render as trender
from sage3d_tpu_torch.renderer.scene import scene_from_numpy
from tests.test_data_pipeline import make_interiorgs_scene

TOL = 1e-4      # rendered frames before uint8 (tests/test_torch_render.py)
J = dict(actions=jactions, images=jimages, llm=jllm, merge=jmerge,
         navila=jnavila, phys=jphys, sem=jsem, split=jsplit, stats=jstats,
         text=jtext, tg=jtg, trans=jtrans)
T = dict(actions=tactions, images=timages, llm=tllm, merge=tmerge,
         navila=tnavila, phys=tphys, sem=tsem, split=tsplit, stats=tstats,
         text=ttext, tg=ttg, trans=ttrans)


def read(path, root):
    """A JSON file with its package's root directory written as <root>."""
    return json.loads(Path(path).read_text().replace(str(root), "<root>"))


def tree(root, pattern="**/*.json"):
    """Every JSON file under ``root``, by relative path, root-neutral."""
    return {str(p.relative_to(root)): read(p, root)
            for p in sorted(Path(root).glob(pattern))}


def run_pipeline(m, root: Path, scene_dir: Path, pkg: str) -> dict:
    """Every stage of test_transform_merge_stats_split_actions_navila through
    one package's modules ``m``, under ``root``."""
    out = {}
    dev = {} if pkg == "jax" else {"device": "cpu"}
    out["sem"] = m["sem"].build_scene_dir(scene_dir, root / "maps",
                                          save_png=False)
    out["phys"] = m["phys"].convert_scene(scene_dir, root / "phys")
    out["text"] = m["text"].process_scene("0001", root / "phys" / "scene.json",
                                          root / "text",
                                          client=m["llm"].MockLLMClient())
    sem_data = json.loads(Path(out["sem"]).read_text())
    out["traj_summary"] = m["tg"].process_scene(
        "0001", sem_data, root / "traj", client=m["llm"].MockLLMClient(),
        min_trajs=4, max_batches=3, seed=1, **dev)
    out["n_trans"] = m["trans"].process_scene(root / "traj" / "0001",
                                              root / "maps")
    out["merged"] = m["merge"].merge_scene(root / "traj" / "0001",
                                           prefix="gvln")
    out["stats"] = m["stats"].analyze_all(root / "traj", prefix="gvln")
    samples = json.loads(Path(out["merged"]).read_text()
                         )["scenes"][0]["samples"]
    mappings = m["split"].create_split_mappings(
        dict(out["stats"]["scenes"]),
        {"0001": [s["trajectory_id"] for s in samples]},
        {"0001": {s["trajectory_id"]: len(s["instructions"])
                  for s in samples}})
    m["split"].save_split_mappings(mappings, root / "splits")
    m["split"].materialize_all(root / "splits", root / "traj",
                               root / "split_data", prefix="gvln")
    out["actions"] = m["actions"].process_all(
        root / "traj", root / "actions", preset="navila_small", workers=1)
    scene = synthetic_room(num_gaussians=200, seed=2)
    if pkg == "torch":
        scene = scene_from_numpy({f: np.asarray(getattr(scene, f))
                                  for f in scene._fields}, device="cpu")
    out["images"] = m["images"].generate_scene_images(
        scene, out["actions"][0], root / "images", "0001", batch_size=4,
        max_trajectories=1, width=64, height=48, **dev)
    out["navila"] = m["navila"].create_dataset([{
        "scene_id": "0001", "actions_path": out["actions"][0],
        "images_metadata_path": root / "images" / "0001" /
        "image_metadata.json",
        "trajectories_path": out["merged"]}], root / "navila")
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data_parity")
    scene_dir = make_interiorgs_scene(tmp / "raw")
    roots = {"jax": tmp / "jax", "torch": tmp / "torch"}
    planned = []
    plan_many = ttg.plan_many

    def counted(*a, **k):       # the batched branch of process_scene
        planned.append(len(a[1]))
        return plan_many(*a, **k)

    ttg.plan_many = counted
    try:
        outs = {"jax": run_pipeline(J, roots["jax"], scene_dir, "jax"),
                "torch": run_pipeline(T, roots["torch"], scene_dir, "torch")}
    finally:
        ttg.plan_many = plan_many
    outs["torch"]["planned"] = planned
    return roots, outs, scene_dir


def test_robust_json_parse_parity():
    for text in ('{"a": 1}', 'noise {"a": 1} more', "[1,2]", "garbage",
                 'x [{"pair_id": 0}] y', '{"a": [1, {"b": 2}]} tail {"c": 3}'):
        assert tllm.robust_json_parse(text) == jllm.robust_json_parse(text)
    assert tllm.robust_json_parse("garbage") is None


def test_astar_basic_parity():
    grid = np.zeros((20, 20), np.uint8)
    grid[10, 2:18] = 1
    got = tastar.astar_pixel(grid, (5, 5), (5, 15))
    assert got is not None and got == jastar.astar_pixel(grid, (5, 5), (5, 15))
    assert all(grid[y, x] == 0 for x, y in got)
    grid[10, :] = 1
    assert tastar.astar_pixel(grid, (5, 5), (5, 15)) is None
    # the snapping BFS and the centroid, on an instance next to the wall
    mask = [(y, x) for y in range(6, 9) for x in range(8, 12)]
    for towards in (None, (10, 2), (10, 18)):
        assert tastar.nearest_free_pixel_on_side(mask, grid, towards) == \
            jastar.nearest_free_pixel_on_side(mask, grid, towards)
    assert tastar.instance_centroid_px(mask) == jastar.instance_centroid_px(mask)


def _bitwise(free, sources):
    want = np.asarray(jastar.wavefront_distances(
        free, np.asarray(sources, np.int32)))
    got, n = tastar.wavefront_distances(free, np.asarray(sources),
                                        device="cpu", return_relaxations=True)
    got = got.numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
        np.abs(got - want).max()
    assert n % tastar.CHECK_EVERY == 0
    return got


def test_wavefront_matches_astar_reachability_parity():
    rng = np.random.default_rng(3)
    grid = (rng.uniform(size=(40, 40)) < 0.25).astype(np.uint8)
    grid[0, 0] = 0
    free = grid == 0
    starts, goals = [], []
    for _ in range(12):
        ys, xs = np.where(free)
        i, j = rng.integers(0, len(ys), 2)
        starts.append((ys[i], xs[i]))
        goals.append((ys[j], xs[j]))
    _bitwise(free, starts)
    # a source in a wall: its whole field is unreachable, in both packages
    _bitwise(free, [(int(np.argwhere(grid)[0][0]),
                     int(np.argwhere(grid)[0][1])), starts[0]])
    got = tastar.plan_many(free, np.array(starts), np.array(goals),
                           device="cpu")
    assert got == jastar.plan_many(free, np.array(starts), np.array(goals))
    for (sy, sx), (gy, gx), pw in zip(starts, goals, got):
        pa = tastar.astar_pixel(grid, (sx, sy), (gx, gy))
        assert (pa is not None) == (pw is not None)


def test_wavefront_long_serpentine_path_parity():
    h, w = 40, 40
    free = np.ones((h, w), bool)
    for i, r in enumerate(range(2, h - 2, 4)):
        if i % 2 == 0:
            free[r, : w - 1] = False
        else:
            free[r, 1:] = False
    start, goal = (0, 0), (h - 1, w - 1)
    dist = _bitwise(free, [start])
    assert dist[0][goal] > h + w
    ref = tastar.astar_pixel(~free, start, goal)
    got = tastar.plan_many(free, np.asarray([start]), np.asarray([goal]),
                           device="cpu")[0]
    assert got is not None and len(got) == len(ref) > h + w
    assert got == jastar.plan_many(free, np.asarray([start]),
                                   np.asarray([goal]))[0]


def test_semantic_map_schema_parity(worlds):
    roots, outs, scene_dir = worlds
    assert Path(outs["torch"]["sem"]).name == Path(outs["jax"]["sem"]).name
    records = read(outs["torch"]["sem"], roots["torch"])
    assert records == read(outs["jax"]["sem"], roots["jax"])
    cats = {r["category_label"] for r in records}
    assert "wall" in cats and "Unable Area" in cats and "table" in cats
    # resume: a second call returns the same file
    assert tsem.build_scene_dir(scene_dir, roots["torch"] / "maps",
                                save_png=False) == outs["torch"]["sem"]


def test_physical_map_parity(worlds):
    roots, outs, _ = worlds
    entries = read(outs["torch"]["phys"], roots["torch"])
    assert entries == read(outs["jax"]["phys"], roots["jax"])
    assert entries["label_1"].startswith("(")


def test_scene_text_parity(worlds):
    _, outs, _ = worlds
    text = outs["torch"]["text"].read_text()
    assert text and text == outs["jax"]["text"].read_text()


def test_trajectory_generation_parity(worlds):
    roots, outs, _ = worlds
    assert outs["torch"]["traj_summary"] == outs["jax"]["traj_summary"]
    assert outs["torch"]["traj_summary"]["trajectories"] >= 1
    assert outs["torch"]["planned"] and min(outs["torch"]["planned"]) >= 4
    pattern = "0001/[te]*_gvln_0001*.json"      # part files and endpoints
    got = tree(roots["torch"] / "traj", pattern)
    assert any("part" in k for k in got) and any("endpoints" in k for k in got)
    assert got == tree(roots["jax"] / "traj", pattern)
    sem = json.loads(Path(outs["torch"]["sem"]).read_text())
    summary = ttg.process_scene("0001", sem, roots["torch"] / "traj",
                                client=tllm.MockLLMClient(), min_trajs=1,
                                device="cpu")
    assert summary["resumed"]


def test_trajectory_points_lie_on_free_cells(worlds):
    roots, outs, _ = worlds
    sem = json.loads(Path(outs["torch"]["sem"]).read_text())
    grid, scale, min_x, min_y = ttg.build_2d_map(sem)
    n = 0
    for part in (roots["torch"] / "traj" / "0001").glob(
            "trajectories_gvln_0001_part*[0-9].json"):
        for sample in json.loads(part.read_text())["scenes"][0]["samples"]:
            for p in sample["points"]:
                x = int(round((p["position"][0] - min_x) / scale - 0.5))
                y = int(round((p["position"][1] - min_y) / scale - 0.5))
                assert grid[y, x] == 0
                n += 1
    assert n > 0


def test_transform_and_merge_parity(worlds):
    roots, outs, _ = worlds
    assert outs["torch"]["n_trans"] == outs["jax"]["n_trans"] >= 1
    pattern = "0001/*_trans.json"
    got = tree(roots["torch"] / "traj", pattern)
    assert got and got == tree(roots["jax"] / "traj", pattern)
    pts = next(iter(got.values()))["scenes"][0]["samples"][0]["points"]
    assert pts[-1]["rotation"] == [0.0, 0.0, 0.0, 1.0]
    merged = read(outs["torch"]["merged"], roots["torch"])
    assert merged == read(outs["jax"]["merged"], roots["jax"])
    samples = merged["scenes"][0]["samples"]
    assert [s["trajectory_id"] for s in samples] == \
        [str(i) for i in range(len(samples))]


def test_statistics_and_splits_parity(worlds):
    roots, outs, _ = worlds
    assert outs["torch"]["stats"] == outs["jax"]["stats"]
    assert outs["torch"]["stats"]["total_scenes"] == 1
    stats = "0001/trajectories_statistic_0001.json"
    assert read(roots["torch"] / "traj" / stats, roots["torch"]) == \
        read(roots["jax"] / "traj" / stats, roots["jax"])
    for sub in ("splits", "split_data"):
        got = tree(roots["torch"] / sub)
        assert got and got == tree(roots["jax"] / sub), sub
    assert len(tree(roots["torch"] / "splits")) == 5


def test_actions_parity(worlds):
    roots, outs, _ = worlds
    got = tree(roots["torch"] / "actions")
    assert got and got == tree(roots["jax"] / "actions")
    rec = read(outs["torch"]["actions"][0], roots["torch"])["trajectories"][0]
    assert rec["actions"][-1] == "STOP"
    assert len(rec["actions"]) == len(rec["sampled_points"])


def test_images_parity(worlds):
    roots, outs, _ = worlds
    got, want = outs["torch"]["images"], outs["jax"]["images"]
    assert got.pop("total_overflow") == 0
    assert got == want
    assert read(roots["torch"] / "images" / "0001" / "image_metadata.json",
                roots["torch"]) == want
    tid, tmeta = next(iter(got["trajectories"].items()))
    assert tmeta["num_frames"] == len(tmeta["frames"]) > 0
    for f in tmeta["frames"]:
        assert (roots["torch"] / "images" / "0001" / f).exists()


@pytest.mark.parametrize("backend,jax_backend", [("torch", "xla"),
                                                 ("cuda", "xla")])
def test_waypoint_frames_parity(worlds, backend, jax_backend):
    """The first trajectory's waypoint frames (one batch of 4) before the
    uint8 conversion: the port's backend (``cuda`` runs its kernels' plain
    versions on the CPU) against the JAX package's ``xla``."""
    roots, outs, _ = worlds
    rec = read(outs["torch"]["actions"][0], roots["torch"])["trajectories"][0]
    pts = rec["sampled_points"][:4]
    js = synthetic_room(num_gaussians=200, seed=2)
    ts = scene_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          device="cpu")
    want = jrender.render_batch(js, jimages.waypoint_cameras(pts, 64, 48),
                                backend=jax_backend, sequential=True)
    with torch.no_grad():
        got = trender.render_batch(
            ts, timages.waypoint_cameras(pts, 64, 48, device="cpu"),
            backend=backend)
    assert int(got["overflow"].sum()) == int(np.asarray(want["overflow"]).sum())
    for k in ("rgb", "alpha"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_navila_parity(worlds):
    roots, outs, _ = worlds
    assert outs["torch"]["navila"] == outs["jax"]["navila"]
    assert outs["torch"]["navila"]["total_samples"] > 0
    got = tree(roots["torch"] / "navila")
    assert got == tree(roots["jax"] / "navila")
    s0 = got[outs["torch"]["navila"]["part_files"][0]][0]
    assert s0["a"].startswith("The next action is ") and s0["frames"]


def test_images_scene_shard_filter_parity():
    scenes = [f"{i:04d}" for i in range(50)]
    shards = [timages.scene_shard_filter(scenes, i, 4) for i in range(4)]
    assert shards == [jimages.scene_shard_filter(scenes, i, 4)
                      for i in range(4)]
    assert sorted(sum(shards, [])) == scenes


def test_entry_points_need_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tastar.wavefront_distances(np.ones((4, 4), bool), [(0, 0)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttg.process_scene("x", [], tmp_path)


# -- tests/test_prompt_templates.py --------------------------------------------

def test_templates_load_and_have_placeholders_parity():
    names = sorted(p.stem for p in tprompts.PROMPTS_DIR.glob("*.json"))
    assert names == sorted(p.stem for p in jprompts.PROMPTS_DIR.glob("*.json"))
    assert len(names) == 4
    for name in names:
        assert tprompts.load_prompt_template(name) == \
            jprompts.load_prompt_template(name)
    t = tprompts.load_prompt_template("prompt_traj_to_instruction")
    assert "{text}{json}" in t[1]["content"]
    assert tprompts.INSTRUCTION_TYPES == jprompts.INSTRUCTION_TYPES
    with pytest.raises(FileNotFoundError):
        tprompts.load_prompt_template("nope_no_such_template")


def test_render_preserves_literal_braces_parity():
    t = [{"role": "user", "content": 'x={x} and {"json": true} stays'}]
    got = tprompts.render_template(t, x="7")
    assert got == jprompts.render_template(t, x="7")
    assert got[0]["content"] == 'x=7 and {"json": true} stays'


def test_pairwise_messages_and_mock_verdicts_parity():
    pairs = [("label_1", "label_2"), ("label_3", "label_4")]
    msgs = tprompts.pairwise_judgement_messages("a map", pairs)
    assert msgs == jprompts.pairwise_judgement_messages("a map", pairs)
    assert tllm.MockLLMClient().chat(msgs) == jllm.MockLLMClient().chat(msgs)
    for accept in (True, False):
        assert ttg.judge_pairs_batch(
            tllm.MockLLMClient(accept_all_pairs=accept), pairs, "a map") == \
            jtg.judge_pairs_batch(
                jllm.MockLLMClient(accept_all_pairs=accept), pairs, "a map")
    assert ttg.judge_pair(tllm.MockLLMClient(), "label_1", "label_2", "m") == \
        jtg.judge_pair(jllm.MockLLMClient(), "label_1", "label_2", "m")


def test_instruction_generation_through_template_parity(monkeypatch):
    msgs = tprompts.traj_to_instruction_messages("the map", "label_1",
                                                 "label_2")
    assert msgs == jprompts.traj_to_instruction_messages("the map", "label_1",
                                                         "label_2")
    out = ttg.generate_instructions(tllm.MockLLMClient(), "the map",
                                    "label_1", "label_2")
    assert out == jtg.generate_instructions(jllm.MockLLMClient(), "the map",
                                            "label_1", "label_2")
    assert set(tprompts.INSTRUCTION_TYPES) <= {r["instruction_type"]
                                               for r in out}
    # a failing client: the same retries and backoff, then the per-type
    # Default fallback (the sleeps are recorded, not slept)
    slept = []
    monkeypatch.setattr(tllm.time, "sleep", slept.append)
    monkeypatch.setattr(jllm.time, "sleep", slept.append)

    def dead(base):
        class Dead(base):
            def chat(self, *a, **k):
                raise RuntimeError("down")
        return Dead()

    got = ttg.generate_instructions(dead(tllm.MockLLMClient), "m", "a", "b")
    n = len(slept)
    want = jtg.generate_instructions(dead(jllm.MockLLMClient), "m", "a", "b")
    assert got == want and slept[:n] == slept[n:] and n == tllm.MAX_RETRIES - 1
    assert all(r["instruction_type"] == "Default" for r in got)


def test_phy_to_sem_fewshot_payload_parity():
    payload = {"chair_01": "(0,0,0), (1,1,1)"}
    msgs = tprompts.phy_to_sem_messages(payload)
    assert msgs == jprompts.phy_to_sem_messages(payload)
    assert msgs[2]["role"] == "assistant" and "Overview" in msgs[2]["content"]


@pytest.fixture()
def traj_world(tmp_path):
    scene_dir = make_interiorgs_scene(tmp_path / "raw")
    jsem.build_scene_dir(scene_dir, tmp_path / "maps")
    sem_data = json.loads((tmp_path / "maps" /
                           "2D_Semantic_Map_0001_Complete.json").read_text())
    return tmp_path, sem_data


def test_reconciliation_regenerates_deleted_halves_parity(traj_world):
    tmp, sem_data = traj_world
    reports = {}
    for pkg, m in (("jax", J), ("torch", T)):
        out = tmp / pkg
        dev = {} if pkg == "jax" else {"device": "cpu"}
        client = m["llm"].MockLLMClient
        summary = m["tg"].process_scene("0001", sem_data, out, client=client(),
                                        min_trajs=3, max_batches=3, seed=2,
                                        **dev)
        scene_out = out / "0001"
        for p in scene_out.glob("trajectories_*part*.json"):
            p.unlink()
        rep1 = m["tg"].reconcile_endpoints_trajectories(
            "0001", sem_data, out, client=client())
        (scene_out / "endpoints_gvln_0001.json").unlink()
        rep2 = m["tg"].reconcile_endpoints_trajectories(
            "0001", sem_data, out, client=client())
        rep3 = m["tg"].reconcile_endpoints_trajectories(
            "0001", sem_data, out, client=client())
        audit = m["tg"].check_endpoint_trajectory_pairs(scene_out, "0001")
        reports[pkg] = (summary, rep1, rep2, rep3, audit, tree(out))
    got, want = reports["torch"], reports["jax"]
    assert json.loads(json.dumps(got).replace(str(tmp / "torch"), "R")) == \
        json.loads(json.dumps(want).replace(str(tmp / "jax"), "R"))
    summary, rep1, rep2, rep3, audit, _ = got
    assert summary["trajectories"] >= 2
    assert rep1["regenerated_trajectories"] >= 1
    assert rep2["appended_endpoints"] >= 1
    assert rep3["regenerated_trajectories"] == rep3["appended_endpoints"] == 0
    assert audit["missing_endpoints"] == audit["missing_trajectories"] == []


def test_per_trajectory_visualizations_and_merge_rename_parity(traj_world):
    tmp, sem_data = traj_world
    seen = {}
    for pkg, m in (("jax", J), ("torch", T)):
        out = tmp / pkg
        dev = {} if pkg == "jax" else {"device": "cpu"}
        m["tg"].process_scene("0001", sem_data, out,
                              client=m["llm"].MockLLMClient(), min_trajs=2,
                              max_batches=2, seed=5, visualize=True, **dev)
        scene_out = out / "0001"
        pngs = sorted(p.name for p in
                      (scene_out / "visualization").glob("trajectory_*.png"))
        for p in scene_out.glob("trajectories_*part*.json"):
            shutil.copy2(p, p.with_name(p.stem + "_trans.json"))
        merged = m["merge"].merge_scene(scene_out, prefix="gvln")
        renamed = sorted(p.name for p in (scene_out / "visualization_merged"
                                          ).glob("trajectory_*.png"))
        seen[pkg] = (pngs, renamed, read(merged, out))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] and len(seen["torch"][1]) == len(seen["torch"][0])
