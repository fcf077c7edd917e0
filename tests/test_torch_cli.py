"""The port's CLI (``python -m sage3d_tpu_torch.cli``), on the CPU.

Counterparts of the JAX package's CLI tests (tests/test_aux_subsystems.py
``test_cli_run_benchmark_end_to_end``, tests/test_batch_benchmark.py's
flag plumbing) with ``--device cpu``, plus ``train-scene --adaptive``,
``validate-ply`` and every subcommand's ``--help``.
"""

import json

import pytest

from sage3d_tpu_torch import cli
from tests.test_bench_harness import make_gvln_json

SUBCOMMANDS = ("run-benchmark", "semantic-maps", "physical-maps",
               "scene-text", "gen-trajectories", "transform-2d3d", "merge",
               "stats", "split", "gen-actions", "gen-images", "build-scenes",
               "train-scene", "serve-scripted", "serve-mllm", "serve-torch",
               "serve-video", "validate-ply")


@pytest.mark.parametrize("command", SUBCOMMANDS)
def test_help_of_every_subcommand(command, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([command, "--help"])
    assert e.value.code == 0
    assert command in capsys.readouterr().out


def test_subcommands_are_the_jax_clis_with_serve_torch():
    """Every JAX subcommand has its counterpart, serve-jax as serve-torch,
    with the JAX flags (and --device where a command touches tensors)."""
    import argparse

    from sage3d_tpu import cli as jcli

    def parsers(main):
        seen = {}
        orig = argparse.ArgumentParser.parse_args

        def grab(self, *a, **k):
            for act in self._actions:
                if isinstance(act, argparse._SubParsersAction):
                    seen.update(act.choices)
            raise SystemExit(0)
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main(["stats"])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    mine, theirs = parsers(cli.main), parsers(jcli.main)
    assert set(mine) == (set(theirs) - {"serve-jax"}) | {"serve-torch"}
    assert set(mine) == set(SUBCOMMANDS)
    for name, p in theirs.items():
        flags = {o for a in p._actions for o in a.option_strings}
        mflags = {o for a in mine[name.replace("jax", "torch")]._actions
                  for o in a.option_strings}
        assert flags <= mflags, (name, flags - mflags)


def _scene_ply(tmp_path, n=150, seed=4):
    from sage3d_tpu_torch.renderer.scene import save_ply, synthetic_room
    ply = tmp_path / "scene.ply"
    save_ply(synthetic_room(num_gaussians=n, seed=seed, device="cpu"), ply)
    return ply


def test_cli_run_benchmark_end_to_end(tmp_path, capsys):
    """Full CLI drive: scene PLY + map + test json + scripted server; the
    frames' total_overflow is printed beside the metrics."""
    from sage3d_tpu_torch.serve.scripted_server import ScriptedPolicyServer
    ply = _scene_ply(tmp_path)
    traj_path, map_path = make_gvln_json(tmp_path)
    with ScriptedPolicyServer(script=["MOVE_FORWARD", "STOP"]) as srv:
        rc = cli.main([
            "run-benchmark", "--scene", str(ply), "--map", str(map_path),
            "--test-json", str(traj_path), "--output-dir",
            str(tmp_path / "out"), "--port", str(srv.port),
            "--max-episodes", "1", "--set", "renderer.width=48",
            "--set", "renderer.height=48", "--set", "benchmark.max_steps=5",
            "--device", "cpu",
        ])
    assert rc == 0
    assert (tmp_path / "out" / "batch_test_summary.json").exists()
    assert "[INFO] total_overflow 0" in capsys.readouterr().out


def test_cli_run_benchmark_task_type_plumbing(tmp_path):
    from sage3d_tpu_torch.serve.scripted_server import ScriptedPolicyServer
    traj, mp = make_gvln_json(tmp_path)
    ply = _scene_ply(tmp_path, 120, 3)
    with ScriptedPolicyServer(port=0) as srv:
        rc = cli.main([
            "run-benchmark", "--scene", str(ply), "--map", str(mp),
            "--test-json", str(traj), "--model-type", "scripted",
            "--port", str(srv.port), "--task-type", "pointnav",
            "--input-type", "rgb", "--output-dir", str(tmp_path / "out"),
            "--set", "renderer.width=48", "--set", "renderer.height=48",
            "--set", "benchmark.max_steps=3", "--device", "cpu",
        ])
    assert rc == 0
    ep_files = [p for p in (tmp_path / "out").rglob("*.json")
                if p.parent.name == "measurements"]
    assert ep_files
    rec = json.loads(ep_files[0].read_text())
    assert rec["episode_info"]["task_type"] == "pointnav"


def test_cli_reference_alias_flags(tmp_path, monkeypatch):
    import sage3d_tpu_torch.bench.runner as runner_mod
    traj, mp = make_gvln_json(tmp_path)
    ply = _scene_ply(tmp_path, 120, 3)
    seen = {}

    def fake_run_benchmark(env, episodes, policy, **kw):
        seen.update(kw)
        seen["goal_radius"] = episodes[0]["goals"][0].get("radius")
        return {"metrics": {}}

    monkeypatch.setattr(runner_mod, "run_benchmark", fake_run_benchmark)
    rc = cli.main([
        "run-benchmark", "--scene", str(ply), "--map", str(mp),
        "--test-json", str(traj), "--model-type", "scripted",
        "--output-dir", str(tmp_path / "out"), "--device", "cpu",
        "--max-steps", "7", "--goal-radius", "0.9", "--save-videos"])
    assert rc == 0
    assert seen["max_steps"] == 7
    assert seen["record_video"] is True
    assert seen["goal_radius"] == 0.9


def test_cli_train_scene_adaptive(tmp_path, capsys):
    from sage3d_tpu_torch.parallel.densify import alive_mask
    from sage3d_tpu_torch.renderer.scene import load_ply
    ply = _scene_ply(tmp_path, 100, 2)
    rc = cli.main(["train-scene", "--scene-ply", str(ply), "--steps", "4",
                   "--views", "2", "--size", "32", "--adaptive",
                   "--densify-every", "2", "--capacity", "160",
                   "--device", "cpu"])
    assert rc == 0
    fitted = load_ply(tmp_path / "scene_fitted.ply", device="cpu")
    assert fitted.num_gaussians == 160
    assert int(alive_mask(fitted.opacity_logits).sum()) >= 100
    assert "n_alive" in capsys.readouterr().out


def test_cli_train_scene_refuses_a_mesh(tmp_path):
    """``--mesh 1x2`` trains on two gloo ranks spawned on the CPU and writes
    the fitted PLY; its checkpoint (the single-device format, written by
    rank 0) resumes on one device."""
    import torch
    from sage3d_tpu_torch.parallel.checkpoint import latest_step
    from sage3d_tpu_torch.renderer.scene import load_ply
    ply = _scene_ply(tmp_path, 64, 2)
    ckpt = tmp_path / "ckpt"
    rc = cli.main(["train-scene", "--scene-ply", str(ply), "--steps", "2",
                   "--views", "2", "--size", "32", "--mesh", "1x2",
                   "--checkpoint-dir", str(ckpt), "--device", "cpu"])
    assert rc == 0 and latest_step(ckpt) == 2
    fitted = load_ply(tmp_path / "scene_fitted.ply", device="cpu")
    assert fitted.num_gaussians == 64
    assert bool(torch.isfinite(fitted.means).all())
    rc = cli.main(["train-scene", "--scene-ply", str(ply), "--steps", "3",
                   "--views", "2", "--size", "32", "--mesh", "1x1",
                   "--checkpoint-dir", str(ckpt), "--device", "cpu"])
    assert rc == 0 and latest_step(ckpt) == 3


def test_cli_validate_ply(tmp_path, capsys):
    from tests.test_native_plyio import (make_compressed_arrays,
                                         write_compressed_ply)
    chunk, packed = make_compressed_arrays(n=600)
    good = tmp_path / "3dgs_compressed.ply"
    write_compressed_ply(good, chunk, packed)
    assert cli.main(["validate-ply", str(good), "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["n_vertices"] == 600
    bad = chunk.copy()
    bad[:, 0:3], bad[:, 3:6] = chunk[:, 3:6], chunk[:, 0:3]
    p2 = tmp_path / "bad.ply"
    write_compressed_ply(p2, bad, packed)
    assert cli.main(["validate-ply", str(p2), "--device", "cpu"]) == 1


def test_cli_device_defaults_to_the_card():
    """--device defaults to cuda: without a card the command raises rather
    than running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve-torch", "--port", "0", "--batch", "2"])


def test_cli_run_benchmark_budgets_file(tmp_path, capsys, monkeypatch):
    """--budgets hands an autotune_poses dict to the env (single mode) or a
    dict of them per scene name to run_batch_benchmark (batch mode)."""
    import sage3d_tpu_torch.env.vln_env as env_mod
    from sage3d_tpu_torch.renderer.render import budget_kwargs
    from sage3d_tpu_torch.serve.scripted_server import ScriptedPolicyServer
    ply = _scene_ply(tmp_path)
    traj, mp = make_gvln_json(tmp_path)
    budgets = {"k_small": 8, "m_big": 256, "k_big": 64, "m_mid": 0,
               "k_mid": 0, "pair_capacity": 1 << 16, "tile_capacity": 2048,
               "n_pairs_measured": 1000}
    path = tmp_path / "budgets.json"
    path.write_text(json.dumps(budgets))
    assert cli._read_budgets(str(path)) == (budgets, None)
    per_scene = tmp_path / "per_scene.json"
    per_scene.write_text(json.dumps({"synthroom": budgets}))
    assert cli._read_budgets(str(per_scene)) == (None,
                                                 {"synthroom": budgets})
    assert cli._read_budgets(None) == (None, None)

    seen = []
    real = env_mod.GaussianVLNEnv.set_budgets

    def spy(self, b):
        seen.append(b)
        return real(self, b)

    monkeypatch.setattr(env_mod.GaussianVLNEnv, "set_budgets", spy)
    with ScriptedPolicyServer(script=["MOVE_FORWARD", "STOP"]) as srv:
        rc = cli.main([
            "run-benchmark", "--scene", str(ply), "--map", str(mp),
            "--test-json", str(traj), "--output-dir", str(tmp_path / "out"),
            "--port", str(srv.port), "--max-episodes", "1",
            "--budgets", str(path), "--set", "renderer.width=48",
            "--set", "renderer.height=48", "--set", "benchmark.max_steps=3",
            "--device", "cpu"])
    assert rc == 0 and seen == [budgets]
    assert budget_kwargs(seen[0])["tile_capacity"] == 2048
    assert "[INFO] total_overflow 0" in capsys.readouterr().out
