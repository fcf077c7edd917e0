"""Command-line front end: benchmark runner + every data-pipeline stage.

The port's counterpart of ``sage3d_tpu/cli.py``, with the same subcommands
and flags. One CLI replaces the reference's per-script argparse drivers:

  python -m sage3d_tpu_torch.cli run-benchmark   <- run_benchmark.py main()
  python -m sage3d_tpu_torch.cli semantic-maps   <- semantic_map_builder.py
  python -m sage3d_tpu_torch.cli physical-maps   <- physical_map_converter.py
  python -m sage3d_tpu_torch.cli scene-text      <- scene_text_generator.py
  python -m sage3d_tpu_torch.cli gen-trajectories<- vln_trajectory_generator.py
  python -m sage3d_tpu_torch.cli transform-2d3d  <- trajectory_2d_to_3d.py
  python -m sage3d_tpu_torch.cli merge           <- trajectory_merge.py
  python -m sage3d_tpu_torch.cli stats           <- trajectory_statistics.py
  python -m sage3d_tpu_torch.cli split           <- trajectory_split_domain_aware.py
                                                    + benchmark_data_splitter.py
  python -m sage3d_tpu_torch.cli gen-actions     <- generate_actions.py
  python -m sage3d_tpu_torch.cli gen-images      <- generate_images.py
  python -m sage3d_tpu_torch.cli build-scenes    <- sage3d_usda_builder.py
  python -m sage3d_tpu_torch.cli train-scene     <- scene fitting (+ --adaptive)
  python -m sage3d_tpu_torch.cli serve-scripted  <- scripted policy server
  python -m sage3d_tpu_torch.cli serve-mllm      <- mllm_server.py
  python -m sage3d_tpu_torch.cli serve-video     <- navila_server.py
  python -m sage3d_tpu_torch.cli serve-torch     <- the CNN policy on the card
  python -m sage3d_tpu_torch.cli validate-ply    <- compressed-PLY audit

Beyond the JAX CLI's flags, every command that touches tensors takes
``--device`` (default ``cuda``; ``cpu`` runs it on the CPU), ``serve-torch``
replaces ``serve-jax``, and ``run-benchmark`` and ``gen-images`` print the
frames' ``total_overflow`` so that dropped pairs are never silent.
``train-scene --mesh RxC`` of more than one rank starts one process per
rank on ``--device`` (``parallel/mesh.py``'s ``spawn_mesh``); ``--gather
splats`` picks the sharded step's splat layout (each rank projects its own
shard), ``params`` (the default) the JAX package's. ``run-benchmark
--budgets`` takes the env's binning budgets from a JSON file (an
``autotune_poses`` dict): without it the frames use ``render``'s defaults,
as in the JAX CLI, and those drop pairs at 640x480 even in a 20k-Gaussian
room.

Benchmark episode sharding across hosts (--instance-id/--total-instances) is
actually implemented here — the reference documented it (README.md:792-793)
but never wired the flags (run_benchmark.py:1964-2026).
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from pathlib import Path


def _first_scene_asset(scenes_root: str) -> str:
    """First scene asset in a folder (warm-up scene for the shared batch env)."""
    root = Path(scenes_root)
    for cand in sorted(root.glob("*.ply")):
        return str(cand)
    for cand in sorted(root.iterdir()):
        if cand.is_dir():
            for inner in (cand / "scene.ply", cand / "manifest.json"):
                if inner.exists():
                    return str(inner)
    raise FileNotFoundError(f"no scene assets under {scenes_root}")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", type=str, default=None,
                   help="JSON config file (utils/config.py schema)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where tensors live: cuda (the card) or cpu")


def _read_budgets(path):
    """(budgets for the env, budgets per scene name) from a ``--budgets``
    JSON file: one ``autotune_*`` dict, or a dict of them keyed by scene
    name (batch mode). (None, None) without a file: ``render``'s defaults."""
    if not path:
        return None, None
    with open(path) as f:
        data = json.load(f)
    if data and all(isinstance(v, dict) for v in data.values()):
        return None, data
    return data, None


def cmd_run_benchmark(args) -> int:
    from .bench.episodes import adapt_gvln_to_episodes
    from .bench.runner import run_benchmark
    from .env.vln_env import GaussianVLNEnv
    from .serve.policy import make_socket_policy
    from .utils.config import load_config

    cfg = load_config(args.config, args.overrides)
    budgets, per_scene = _read_budgets(args.budgets)
    if args.fast_mode:
        cfg.apply_fast_mode("fast")
    if args.ultra_fast:
        cfg.apply_fast_mode("ultra")
    if args.task_type:
        cfg.benchmark.task_type = args.task_type
    if args.input_type:
        cfg.benchmark.use_depth = args.input_type == "rgbd"
    if args.max_steps is not None:
        cfg.benchmark.max_steps = args.max_steps
    if args.goal_radius is not None:
        cfg.benchmark.goal_radius = args.goal_radius
    if args.save_videos:
        cfg.benchmark.record_video = True

    if args.test_dir:
        # Batch mode: recursive test_*.json discovery + per-file scene/map
        # auto-matching + shared-env hot-swap (run_benchmark.py:2137-2351).
        from .bench.batch import run_batch_benchmark
        if not (args.scenes_root and args.map_root):
            print("[ERROR] batch mode needs --scenes-root and --map-root")
            return 1
        env = GaussianVLNEnv(
            args.scene or _first_scene_asset(args.scenes_root),
            map_json=None,
            width=cfg.renderer.width, height=cfg.renderer.height,
            backend=None if cfg.renderer.backend == "auto"
            else cfg.renderer.backend,
            robot_radius_m=cfg.physics.robot_radius_m, device=args.device,
            budgets=budgets)
        policy = make_socket_policy(model_type=args.model_type,
                                    host=args.host, port=args.port)
        summary = run_batch_benchmark(
            env, args.test_dir, args.scenes_root, args.map_root, policy,
            args.output_dir, goal_radius=cfg.benchmark.goal_radius,
            max_steps=cfg.benchmark.max_steps,
            max_episodes_per_file=args.max_episodes,
            skip_completed=not args.no_skip_completed,
            model_info=args.model_type, instance_id=args.instance_id,
            total_instances=args.total_instances, quiet=False,
            use_depth=cfg.benchmark.use_depth,
            record_video=cfg.benchmark.record_video,
            task_type=cfg.benchmark.task_type, budgets=per_scene)
        print(json.dumps(summary["batch_summary"], indent=2))
        print(f"[INFO] total_overflow {int(env.total_overflow)}")
        return 0

    if not (args.scene and args.test_json):
        print("[ERROR] single-scene mode needs --scene and --test-json "
              "(or use --test-dir batch mode)")
        return 1
    test_files = sorted(glob.glob(args.test_json, recursive=True)) \
        if any(ch in args.test_json for ch in "*?") else [args.test_json]
    if not test_files:
        print(f"[ERROR] no test JSON matched {args.test_json}")
        return 1

    episodes = []
    for tf in test_files:
        episodes.extend(adapt_gvln_to_episodes(
            tf, args.scene, goal_radius=cfg.benchmark.goal_radius))
    # episode sharding across hosts
    if args.total_instances > 1:
        episodes = [e for i, e in enumerate(episodes)
                    if i % args.total_instances == args.instance_id]
    if args.max_episodes:
        episodes = episodes[: args.max_episodes]
    print(f"[INFO] {len(episodes)} episodes "
          f"(shard {args.instance_id}/{args.total_instances})")

    env = GaussianVLNEnv(
        args.scene, map_json=None if args.disable_collision else args.map,
        width=cfg.renderer.width, height=cfg.renderer.height,
        backend=None if cfg.renderer.backend == "auto" else cfg.renderer.backend,
        robot_radius_m=cfg.physics.robot_radius_m, device=args.device,
        budgets=budgets)

    policy = make_socket_policy(model_type=args.model_type, host=args.host,
                                port=args.port)
    summary = run_benchmark(
        env, episodes, policy, output_dir=args.output_dir,
        max_steps=cfg.benchmark.max_steps,
        skip_completed=not args.no_skip_completed,
        use_depth=cfg.benchmark.use_depth,
        record_video=cfg.benchmark.record_video,
        task_type=cfg.benchmark.task_type, quiet=False,
        map_file=args.map)
    print(json.dumps(summary.get("metrics", {}), indent=2))
    print(f"[INFO] total_overflow {int(env.total_overflow)}")
    return 0


def cmd_serve_scripted(args) -> int:
    from .serve.scripted_server import ScriptedPolicyServer
    server = ScriptedPolicyServer(port=args.port,
                                  script=args.script.split(",") if args.script
                                  else None)
    print(f"[INFO] scripted policy server on :{server.port}")
    server.start()
    try:
        import time
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_serve_mllm(args) -> int:
    from .serve.mllm_server import MLLMServer, make_hf_adapter
    adapter = make_hf_adapter(args.model_id,
                              family=getattr(args, "family", ""),
                              device=args.device)
    MLLMServer(adapter, port=args.port, verbose=True).serve_forever()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sage3d_tpu_torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run-benchmark", help="closed-loop SAGE-Bench evaluation")
    p.add_argument("--scene", default=None, help="scene PLY / bundle "
                   "(single-scene mode; optional warm-up scene in batch mode)")
    p.add_argument("--map", default=None, help="2D semantic map JSON")
    p.add_argument("--test-json", default=None,
                   help="GVLN test file or glob (single-scene mode)")
    p.add_argument("--test-dir", default=None,
                   help="batch mode: directory scanned recursively for "
                        "test_*.json; scenes/maps auto-matched per file")
    p.add_argument("--scenes-root", default=None,
                   help="batch mode: folder of scene assets")
    p.add_argument("--map-root", default=None,
                   help="batch mode: folder of 2D semantic maps")
    p.add_argument("--output-dir", default="outputs/benchmark")
    p.add_argument("--model-type", default="scripted",
                   choices=["scripted", "navila", "navid", "navdp"])
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=55221)
    p.add_argument("--max-episodes", type=int, default=None)
    p.add_argument("--task-type", default=None,
                   choices=["vln", "objectnav", "pointnav", "imgnav",
                            "nogoalnav"],
                   help="force a task type (default: inferred per episode; "
                        "mirrors run_benchmark.py --task-type)")
    p.add_argument("--input-type", default=None, choices=["rgb", "rgbd"],
                   help="input modality; rgbd adds depth frames "
                        "(mirrors run_benchmark.py --input-type)")
    p.add_argument("--no-skip-completed", action="store_true")
    p.add_argument("--disable-collision", action="store_true")
    p.add_argument("--fast-mode", action="store_true")
    p.add_argument("--ultra-fast", action="store_true")
    # Reference-named aliases for config fields (run_benchmark.py:1964-2026's
    # long tail otherwise maps to --set benchmark.<field>=<v>, utils/config.py)
    p.add_argument("--max-steps", type=int, default=None,
                   help="episode step cap (alias of --set benchmark.max_steps)")
    p.add_argument("--goal-radius", type=float, default=None,
                   help="success radius in m (alias of "
                        "--set benchmark.goal_radius)")
    p.add_argument("--save-videos", action="store_true",
                   help="record per-episode video (alias of "
                        "--set benchmark.record_video=true)")
    p.add_argument("--instance-id", type=int, default=0)
    p.add_argument("--total-instances", type=int, default=1)
    p.add_argument("--budgets", default=None,
                   help="JSON file of the frames' binning budgets (an "
                        "autotune_poses dict; in batch mode also one per "
                        "scene name); default: render's defaults, as the "
                        "JAX CLI")
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_run_benchmark)

    p = sub.add_parser("semantic-maps")
    p.add_argument("--input-root", required=True)
    p.add_argument("--output-root", required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--max-scenes", type=int, default=None)
    p.set_defaults(fn=lambda a: (__import__(
        "sage3d_tpu_torch.data.semantic_map", fromlist=["build_all"]).build_all(
        a.input_root, a.output_root, a.overwrite, a.max_scenes) and 0) or 0)

    p = sub.add_parser("physical-maps")
    p.add_argument("--input-root", required=True)
    p.add_argument("--output-root", required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--max-scenes", type=int, default=None)
    p.set_defaults(fn=lambda a: (__import__(
        "sage3d_tpu_torch.data.physical_map", fromlist=["convert_dataset"])
        .convert_dataset(a.input_root, a.output_root, a.overwrite,
                         a.max_scenes) and 0) or 0)

    p = sub.add_parser("scene-text")
    p.add_argument("--scene-json-root", required=True,
                   help="root of {scene}/scene.json files")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--mock-llm", action="store_true")
    p.add_argument("--overwrite", action="store_true")

    def _scene_text(a):
        from .data.llm import MockLLMClient, OpenAIClient
        from .data.scene_text import process_all
        client = MockLLMClient() if a.mock_llm else OpenAIClient()
        jobs = {d.name: str(d / "scene.json")
                for d in Path(a.scene_json_root).iterdir()
                if (d / "scene.json").exists()}
        process_all(jobs, a.output_dir, client=client, overwrite=a.overwrite)
        return 0
    p.set_defaults(fn=_scene_text)

    p = sub.add_parser("gen-trajectories")
    p.add_argument("--map-root", required=True)
    p.add_argument("--scene-text-root", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--min-trajs", type=int, default=100)
    p.add_argument("--mock-llm", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    _add_device(p)

    def _gen_traj(a):
        from .data.llm import MockLLMClient, OpenAIClient
        from .data.trajectory_gen import process_scene
        client = MockLLMClient() if a.mock_llm else OpenAIClient()
        for map_file in sorted(Path(a.map_root).glob(
                "2D_Semantic_Map_*_Complete.json")):
            scene_key = map_file.name.replace("2D_Semantic_Map_", "") \
                .replace("_Complete.json", "")
            with open(map_file) as f:
                sem = json.load(f)
            text = ""
            if a.scene_text_root:
                tp = Path(a.scene_text_root) / f"semantic_map_{scene_key}.txt"
                text = tp.read_text() if tp.exists() else ""
            summary = process_scene(scene_key, sem, a.output_dir,
                                    client=client, scene_text=text,
                                    min_trajs=a.min_trajs, seed=a.seed,
                                    device=a.device)
            print(json.dumps(summary))
        return 0
    p.set_defaults(fn=_gen_traj)

    p = sub.add_parser("transform-2d3d")
    p.add_argument("--traj-root", required=True)
    p.add_argument("--map-root", required=True)
    p.add_argument("--force", action="store_true")

    def _trans(a):
        from .data.transform_2d3d import process_scene
        for d in sorted(Path(a.traj_root).iterdir()):
            if d.is_dir():
                n = process_scene(d, a.map_root, force=a.force)
                print(f"[{d.name}] transformed {n}")
        return 0
    p.set_defaults(fn=_trans)

    p = sub.add_parser("merge")
    p.add_argument("--traj-root", required=True)
    p.add_argument("--prefix", default="gvln")
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(fn=lambda a: (__import__(
        "sage3d_tpu_torch.data.merge", fromlist=["merge_all"]).merge_all(
        a.traj_root, a.prefix, a.overwrite) and 0) or 0)

    p = sub.add_parser("stats")
    p.add_argument("--traj-root", required=True)
    p.add_argument("--prefix", default="gvln")
    p.add_argument("--overwrite", action="store_true")

    def _stats(a):
        from .data.statistics import analyze_all
        print(json.dumps(analyze_all(a.traj_root, a.prefix, a.overwrite),
                         indent=2))
        return 0
    p.set_defaults(fn=_stats)

    p = sub.add_parser("split")
    p.add_argument("--traj-root", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--scene-type-file", default=None)
    p.add_argument("--prefix", default="gvln")
    p.add_argument("--seed", type=int, default=42)

    def _split(a):
        from .data.split import (create_split_mappings, materialize_all,
                                 save_split_mappings)
        from .data.statistics import analyze_all
        summary = analyze_all(a.traj_root, a.prefix)
        traj_ids, instr_counts = {}, {}
        for scene_dir in sorted(Path(a.traj_root).iterdir()):
            overall = scene_dir / \
                f"trajectories_overall_{a.prefix}_{scene_dir.name}.json"
            if not overall.exists():
                continue
            with open(overall) as f:
                data = json.load(f)
            samples = data["scenes"][0]["samples"]
            traj_ids[scene_dir.name] = [str(s["trajectory_id"])
                                        for s in samples]
            instr_counts[scene_dir.name] = {
                str(s["trajectory_id"]): len(s.get("instructions", []))
                for s in samples}
        mappings = create_split_mappings(summary["scenes"], traj_ids,
                                         instr_counts, a.scene_type_file,
                                         seed=a.seed)
        save_split_mappings(mappings, a.output_dir)
        materialize_all(a.output_dir, a.traj_root,
                        Path(a.output_dir) / "materialized", prefix=a.prefix)
        return 0
    p.set_defaults(fn=_split)

    p = sub.add_parser("gen-actions")
    p.add_argument("--traj-root", required=True)
    p.add_argument("--output-root", required=True)
    p.add_argument("--preset", default="vlnce",
                   choices=["vlnce", "navila_small", "navila_large",
                            "custom_small"])
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--workers", type=int, default=None)
    p.set_defaults(fn=lambda a: (__import__(
        "sage3d_tpu_torch.data.actions", fromlist=["process_all"]).process_all(
        a.traj_root, a.output_root, a.preset, a.overwrite, a.workers) and 0)
        or 0)

    p = sub.add_parser("gen-images")
    p.add_argument("--scene-ply", required=True)
    p.add_argument("--actions-root", required=True)
    p.add_argument("--output-root", required=True)
    p.add_argument("--scene-id", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--instance-id", type=int, default=0)
    p.add_argument("--total-instances", type=int, default=1)
    _add_device(p)

    def _gen_images(a):
        from .data.images import generate_scene_images, scene_shard_filter
        from .renderer.scene import load_ply
        if scene_shard_filter([a.scene_id], a.instance_id,
                              a.total_instances) != [a.scene_id]:
            print(f"[SKIP] {a.scene_id} not in shard {a.instance_id}")
            return 0
        scene = load_ply(a.scene_ply, device=a.device)
        gt = Path(a.actions_root) / a.scene_id / "action_groundtruth.json"
        meta = generate_scene_images(scene, gt, a.output_root, a.scene_id,
                                     batch_size=a.batch_size,
                                     device=a.device)
        print(f"[DONE] {len(meta['trajectories'])} trajectories rendered, "
              f"total_overflow {int(meta['total_overflow'])}")
        return 0
    p.set_defaults(fn=_gen_images)

    p = sub.add_parser("build-scenes")
    p.add_argument("--ply-root", required=True)
    p.add_argument("--labels-root", required=True)
    p.add_argument("--map-root", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--max-scenes", type=int, default=None)
    _add_device(p)
    p.set_defaults(fn=lambda a: (__import__(
        "sage3d_tpu_torch.data.scene_build", fromlist=["build_all"]).build_all(
        a.ply_root, a.labels_root, a.map_root, a.output_dir, a.overwrite,
        a.max_scenes, device=a.device) and 0) or 0)

    p = sub.add_parser("train-scene", help="fit a Gaussian scene to targets")
    p.add_argument("--scene-ply", required=True)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--mesh", default="1x1", help="data x tile, e.g. 2x4")
    p.add_argument("--gather", default="params", choices=("params", "splats"),
                   help="the sharded step's layout on a mesh: 'params' "
                   "all-gathers the raw parameters and renders every row on "
                   "every rank (the JAX package's); 'splats' projects each "
                   "rank's shard and all-gathers the projected splats, for "
                   "scenes too large to gather whole")
    p.add_argument("--adaptive", action="store_true",
                   help="classic 3DGS density control (split/clone/prune)")
    p.add_argument("--capacity", type=int, default=0,
                   help="slot capacity for --adaptive (default 2x scene)")
    p.add_argument("--densify-every", type=int, default=50)
    _add_device(p)

    def _train(a):
        from .parallel.trainer import (AdaptiveConfig, TrainerConfig,
                                       fit_scene, fit_scene_adaptive,
                                       make_orbit_targets)
        from .renderer.scene import load_ply, save_ply
        scene = load_ply(a.scene_ply, device=a.device)
        backend = "cuda" if scene.means.is_cuda else "torch"
        cams, targets = make_orbit_targets(scene, n_views=a.views,
                                           width=a.size, height=a.size,
                                           backend=backend)
        mesh_shape = tuple(int(x) for x in a.mesh.split("x"))
        cfg = TrainerConfig(lr=a.lr, steps=a.steps,
                            mesh_shape=mesh_shape, gather=a.gather,
                            checkpoint_dir=a.checkpoint_dir, backend=backend)
        if a.adaptive:
            fitted, history = fit_scene_adaptive(
                scene, cams, targets, cfg,
                AdaptiveConfig(densify_every=a.densify_every),
                capacity=a.capacity or None)
        else:
            fitted, history = fit_scene(scene, cams, targets, cfg)
        out = a.scene_ply.replace(".ply", "_fitted.ply")
        save_ply(fitted, out)
        print(f"[train-scene] wrote {out}; final: {history[-1]}")
        return 0
    p.set_defaults(fn=_train)

    p = sub.add_parser("serve-scripted")
    p.add_argument("--port", type=int, default=55221)
    p.add_argument("--script", default=None,
                   help="comma-separated action cycle")
    p.set_defaults(fn=cmd_serve_scripted)

    p = sub.add_parser("serve-mllm")
    p.add_argument("--model-id", required=True)
    p.add_argument("--family", default="",
                   help="qwen | llava | internvl (default: sniff model id)")
    p.add_argument("--port", type=int, default=54321)
    _add_device(p)
    p.set_defaults(fn=cmd_serve_mllm)

    p = sub.add_parser("serve-torch",
                       help="the CNN policy on the card behind the MLLM wire")
    p.add_argument("--port", type=int, default=9701)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=0,
                   help=">0: micro-batch concurrent clients (serve/"
                        "batch_server.py), sharing one batched device call")
    _add_device(p)

    def _serve_torch(a):
        if a.batch > 0:
            import time as _time
            from .serve.batch_server import from_torch_policy
            srv = from_torch_policy(seed=a.seed, height=a.height,
                                    width=a.width, frames=a.frames,
                                    device=a.device, port=a.port,
                                    max_batch=a.batch).start()
            print(f"[serve-torch] batching up to {a.batch} on :{srv.port}")
            try:
                while True:
                    _time.sleep(1.0)
            except KeyboardInterrupt:
                srv.stop()
            return 0
        from .serve.torch_policy import make_torch_policy_server
        make_torch_policy_server(port=a.port, seed=a.seed, height=a.height,
                                 width=a.width, frames=a.frames,
                                 device=a.device).serve_forever()
        return 0
    p.set_defaults(fn=_serve_torch)

    p = sub.add_parser("serve-video",
                       help="NaVILA-class 8-frame video-prompt server")
    p.add_argument("--model-id", required=True)
    p.add_argument("--port", type=int, default=54321)
    _add_device(p)
    p.add_argument("--num-video-frames", type=int, default=8)

    def _serve_video(a):
        from .serve.mllm_server import HFVideoAdapter, MLLMServer
        adapter = HFVideoAdapter(a.model_id, device=a.device,
                                 num_video_frames=a.num_video_frames)
        MLLMServer(adapter, port=a.port, verbose=True).serve_forever()
        return 0
    p.set_defaults(fn=_serve_video)

    p = sub.add_parser("validate-ply",
                       help="audit a compressed 3DGS PLY against every "
                            "decoder format assumption (native vs python "
                            "cross-check included)")
    p.add_argument("ply")
    _add_device(p)

    def _validate_ply(a):
        from .utils.ply_validate import main as vmain
        return vmain([a.ply, "--device", a.device])
    p.set_defaults(fn=_validate_ply)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
