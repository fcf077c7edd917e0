"""sage3d_tpu_torch: sage3d_tpu in PyTorch, with hand-written CUDA kernels
for an NVIDIA H100 (sm_90a).

A second package beside the JAX package ``sage3d_tpu``, which stays the
reference it is tested against. It imports neither JAX nor ``sage3d_tpu``.
It holds the differentiable render path: scene and camera, projection,
binning (kernel K1, ``csrc/emit.cu``), the tile compositor (kernel K2,
``csrc/composite_fwd.cu``) and its analytic backward (kernels K3,
``csrc/composite_bwd.cu``, and K4, ``csrc/segreduce.cu``); scene training
(``parallel/``: train step, checkpoints, ``fit_scene``), on one device or
sharded over a (data x tile) mesh of ranks on ``torch.distributed``
(``parallel/mesh.py``, ``sharded_render.py``, ``multihost.py``,
``audit.py``); the closed-loop navigation path (``ops/collision.py``
capsule queries, kernel K6, ``csrc/capsule.cu``; ``physics/`` occupancy
grid and agent, ``env/`` the VLN env and rollouts, ``bench/`` the
SAGE-Bench runner with its tasks and measures, ``serve/`` the
policy wire protocol); policy serving (``serve/``: the MLLM server and its
adapters, the CNN policy on the card, the micro-batching server); adaptive
density control (``parallel/densify.py``, ``fit_scene_adaptive``); the
SAGE-Bench data path (``data/``, whose wavefront planner is kernel K5,
``csrc/wavefront.cu``); the
compressed-PLY reader (``utils/plyio_native.py``, host C++); the command line
(``python -m sage3d_tpu_torch.cli``); and its measurement scripts
(``benchmarks/``: the fwd+bwd bench and the K2 anatomy probe, kernel
``csrc/composite_anatomy.cu``).
Entry points run on the card unless the caller passes ``device="cpu"``.

The public surface is the JAX package's, name for name (the reference
package's exports, environment_evaluation/__init__.py:9-81), so downstream
code ports by changing the package name.
"""

__version__ = "0.1.0"

from .bench.episodes import adapt_gvln_to_episodes  # noqa: F401
from .bench.measures import MeasureManager, default_measures, nogoal_measures  # noqa: F401
from .bench.runner import run_benchmark, run_episode  # noqa: F401
from .bench.success import ObjectBasedSuccessEvaluator  # noqa: F401
from .bench.tasks import TaskTypeManager, adapt_episode_for_task  # noqa: F401
from .env.vln_env import GaussianVLNEnv  # noqa: F401
from .physics.occupancy import OccupancyGrid, grid_from_semantic_map  # noqa: F401
from .renderer.camera import Camera, agent_camera, make_camera, stack_cameras  # noqa: F401
from .renderer.render import render, render_batch  # noqa: F401
from .renderer.scene import GaussianScene, load_ply, make_scene, save_ply, synthetic_room  # noqa: F401
from .serve.client import ModularVLMClient, create_vlm_client, query_vlm  # noqa: F401

# Aliases kept for direct portability from the reference package
# (`from environment_evaluation import SimpleVLNEnv` -> same role here).
SimpleVLNEnv = GaussianVLNEnv
SemanticMap2DCollisionDetector = OccupancyGrid
