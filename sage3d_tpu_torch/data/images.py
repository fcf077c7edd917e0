"""Training-image generation: batched rendering on the card at action waypoints.

PyTorch counterpart of ``sage3d_tpu/data/images.py``, the replacement for the
reference's Isaac-Sim offline render farm (generate_images.py:57-806: one
headless Isaac process per shard, scene-hash sharding across instances, 3
`world.step(render=True)` per frame). Here a scene's waypoint cameras are
rendered ``batch_size`` at a time by ``render_batch`` on the scene's device:
the ``cuda`` backend (kernels K1 and K2) on a CUDA device, ``torch`` on the
CPU, as the env chooses. A batch holds only the chunk's own cameras (the JAX
package pads the last one to a fixed shape for ``jit``).

Every frame's dropped pairs are counted: ``render_trajectory_images``
returns their sum beside the frame paths, and ``generate_scene_images``
returns the scene's as ``total_overflow`` (``image_metadata.json`` keeps the
JAX package's schema).

Matches the reference's camera setup: 1024x768, focal 8.0 mm, z = 1.2 m
(generate_images.py:43-51), frame files frame_{idx:04d}.jpg with an
image_metadata.json per scene (:572-609) and image-count resume (:229-286).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..renderer.camera import agent_camera, stack_cameras
from ..renderer.render import render_batch, rgb_to_uint8
from ..renderer.scene import GaussianScene, resolve_device
from ..utils.transforms import yaw_from_world_quat

IMAGE_WIDTH = 1024
IMAGE_HEIGHT = 768
FOCAL_MM = 8.0
CAMERA_HEIGHT_M = 1.2


def waypoint_cameras(points: List[Dict], width: int = IMAGE_WIDTH,
                     height: int = IMAGE_HEIGHT, focal_mm: float = FOCAL_MM,
                     device=None):
    """Build the per-waypoint camera batch from action-sampled points, on
    ``device`` (None means the card)."""
    cams = []
    for pt in points:
        x, y = float(pt["position"][0]), float(pt["position"][1])
        qx, qy, qz, qw = pt["rotation"]
        yaw = yaw_from_world_quat(qx, qy, qz, qw)
        cams.append(agent_camera((x, y), yaw, width=width, height=height,
                                 focal_mm=focal_mm,
                                 camera_height=CAMERA_HEIGHT_M,
                                 device=device))
    return stack_cameras(cams)


def render_trajectory_images(
    scene: GaussianScene,
    points: List[Dict],
    out_dir,
    trajectory_id: str,
    batch_size: int = 8,
    width: int = IMAGE_WIDTH,
    height: int = IMAGE_HEIGHT,
    backend: Optional[str] = None,
    overwrite: bool = False,
    **render_kw,
) -> Tuple[List[str], int]:
    """Render every waypoint of one trajectory on the scene's device; returns
    the relative frame paths and the pairs the frames dropped (0 when the
    budgets in ``render_kw`` cover every frame).

    Resume: skips if the expected number of frames already exists
    (generate_images.py:229-286 image-count check).
    """
    from PIL import Image
    if backend is None:
        backend = "cuda" if scene.device.type == "cuda" else "torch"

    out_dir = Path(out_dir)
    traj_dir = out_dir / f"trajectory_{trajectory_id}"
    traj_dir.mkdir(parents=True, exist_ok=True)
    expected = [f"frame_{i:04d}.jpg" for i in range(len(points))]
    if not overwrite and all((traj_dir / f).exists() for f in expected):
        return [str(Path(traj_dir.name) / f) for f in expected], 0

    frame_paths: List[str] = []
    overflow = 0
    for start in range(0, len(points), batch_size):
        chunk = points[start:start + batch_size]
        cams = waypoint_cameras(chunk, width, height, device=scene.device)
        with torch.no_grad():
            out = render_batch(scene, cams, backend=backend, **render_kw)
        rgb = rgb_to_uint8(out["rgb"]).cpu().numpy()
        overflow += int(out["overflow"].sum())
        for i in range(len(chunk)):
            name = f"frame_{start + i:04d}.jpg"
            Image.fromarray(rgb[i]).save(traj_dir / name, quality=92)
            frame_paths.append(str(Path(traj_dir.name) / name))
    return frame_paths, overflow


def generate_scene_images(
    scene: GaussianScene,
    action_gt_path,
    output_dir,
    scene_id: str,
    batch_size: int = 8,
    max_trajectories: Optional[int] = None,
    overwrite: bool = False,
    device=None,
    **render_kw,
) -> Dict:
    """All trajectories of one scene from its action_groundtruth.json.

    Writes images/{scene_id}/trajectory_{tid}/frame_*.jpg plus
    image_metadata.json (generate_images.py:572-609 schema). The frames are
    rendered on ``device`` (None means the card; the scene is moved there if
    it lies elsewhere), with the budgets of ``render_kw`` (``budget_kwargs``
    of an ``autotune_poses`` over the waypoint cameras). Returns the
    metadata plus ``total_overflow``, the pairs every frame dropped.
    """
    dev = resolve_device(device)
    if scene.device != dev:
        scene = GaussianScene(*(t.to(dev) for t in scene))
    output_dir = Path(output_dir) / scene_id
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(action_gt_path) as f:
        gt = json.load(f)

    metadata = {"scene_id": scene_id, "trajectories": {},
                "image_size": [IMAGE_WIDTH, IMAGE_HEIGHT],
                "camera": {"focal_length": FOCAL_MM,
                           "height_m": CAMERA_HEIGHT_M}}
    trajs = gt.get("trajectories", [])
    if max_trajectories is not None:
        trajs = trajs[:max_trajectories]
    total_overflow = 0
    for rec in trajs:
        tid = rec["trajectory_id"]
        frames, overflow = render_trajectory_images(
            scene, rec["sampled_points"], output_dir, tid,
            batch_size=batch_size, overwrite=overwrite, **render_kw)
        total_overflow += overflow
        metadata["trajectories"][tid] = {
            "num_frames": len(frames),
            "frames": frames,
            "actions": rec["actions"],
        }
    with open(output_dir / "image_metadata.json", "w") as f:
        json.dump(metadata, f, indent=2)
    return {**metadata, "total_overflow": total_overflow}


def scene_shard_filter(scene_ids: List[str], instance_id: int,
                       total_instances: int) -> List[str]:
    """Deterministic scene sharding across hosts. The reference used Python's
    salted hash() (generate_images.py:136-139) which is NOT stable across
    processes; here an md5-based stable hash gives every host the same answer
    — same contract, actually reproducible."""
    import hashlib

    def h(s: str) -> int:
        return int(hashlib.md5(s.encode()).hexdigest(), 16)

    return [s for s in scene_ids if h(s) % total_instances == instance_id]
