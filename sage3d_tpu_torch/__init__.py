"""sage3d_tpu_torch: the sage3d_tpu renderer in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).

A second package beside the JAX package ``sage3d_tpu``, which stays the
reference it is tested against. It imports neither JAX nor ``sage3d_tpu``.
It holds the differentiable render path: scene and camera, projection,
binning (kernel K1, ``csrc/emit.cu``), the tile compositor (kernel K2,
``csrc/composite_fwd.cu``) and its analytic backward (kernels K3,
``csrc/composite_bwd.cu``, and K4, ``csrc/segreduce.cu``); single-device
scene training (``parallel/``: train step, checkpoints, ``fit_scene``); and
its measurement scripts (``benchmarks/``: the fwd+bwd bench and the K2
anatomy probe, kernel ``csrc/composite_anatomy.cu``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .renderer.camera import Camera, agent_camera, make_camera, stack_cameras  # noqa: F401
from .renderer.render import render, render_batch  # noqa: F401
from .renderer.scene import GaussianScene, load_ply, make_scene, save_ply, synthetic_room  # noqa: F401
