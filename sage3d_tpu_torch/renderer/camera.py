"""Pinhole camera model.

PyTorch counterpart of ``sage3d_tpu/renderer/camera.py``, same conventions:

* World frame: z-up.
* Camera frame: OpenCV style — +x right, +y down, +z forward (view direction).
* ``cam_to_world`` is a 3x3 rotation whose columns are the camera axes in world
  coordinates; ``position`` is the optical center in world coordinates.

Tensor fields live on one device; ``width``/``height``/``near``/``far`` are
plain Python numbers. A batch of cameras (``stack_cameras``) carries a leading
axis on every tensor field.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from .scene import resolve_device

DEFAULT_HORIZONTAL_APERTURE_MM = 20.954999923706055
AGENT_CAMERA_HEIGHT_M = 1.2
AGENT_CAMERA_PITCH_RAD = 0.0

_TENSOR_FIELDS = ("position", "cam_to_world", "fx", "fy", "cx", "cy")


class Camera(NamedTuple):
    position: torch.Tensor      # (3,) optical center, world frame
    cam_to_world: torch.Tensor  # (3, 3) rotation, columns = camera axes in world
    fx: torch.Tensor            # () focal in pixels
    fy: torch.Tensor
    cx: torch.Tensor            # () principal point in pixels
    cy: torch.Tensor
    width: int
    height: int
    near: float = 0.1
    far: float = 50.0

    @property
    def world_to_cam(self) -> torch.Tensor:
        return self.cam_to_world.transpose(-1, -2)


def intrinsics_from_focal_mm(
    focal_mm: float,
    width: int,
    height: int,
    horizontal_aperture_mm: float = DEFAULT_HORIZONTAL_APERTURE_MM,
) -> Tuple[float, float, float, float]:
    """USD-style (focal length, aperture) -> pixel intrinsics (fx, fy, cx, cy):
    square pixels, principal point at the image center."""
    fx = width * focal_mm / horizontal_aperture_mm
    return fx, fx, width / 2.0, height / 2.0


def look_rotation(forward, world_up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """cam_to_world rotation with camera +z along ``forward`` (z-up world)."""
    f = np.asarray(forward, dtype=np.float64)
    f = f / (np.linalg.norm(f) + 1e-12)
    up = np.asarray(world_up, dtype=np.float64)
    right = np.cross(f, up)
    n = np.linalg.norm(right)
    if n < 1e-8:  # looking straight up/down: pick arbitrary right axis
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / n
    down = np.cross(f, right)  # camera +y is image-down
    down = down / (np.linalg.norm(down) + 1e-12)
    return np.stack([right, down, f], axis=1)  # columns: x=right, y=down, z=fwd


def _scalar(x, dev) -> torch.Tensor:
    with span("camera.read_scalar"):
        return torch.tensor(np.float32(x), dtype=torch.float32, device=dev)


def make_camera(
    position,
    forward,
    width: int,
    height: int,
    focal_mm: float = 8.0,
    horizontal_aperture_mm: float = DEFAULT_HORIZONTAL_APERTURE_MM,
    near: float = 0.1,
    far: float = 50.0,
    intrinsics: Tuple[float, float, float, float] | None = None,
    device=None,
) -> Camera:
    """Build a Camera from a world position and a forward (view) direction."""
    dev = resolve_device(device)
    if intrinsics is None:
        fx, fy, cx, cy = intrinsics_from_focal_mm(
            focal_mm, width, height, horizontal_aperture_mm)
    else:
        fx, fy, cx, cy = intrinsics
    R = look_rotation(np.asarray(forward, dtype=np.float64))
    return Camera(
        position=torch.tensor(np.asarray(position, np.float32), device=dev),
        cam_to_world=torch.tensor(R.astype(np.float32), device=dev),
        fx=_scalar(fx, dev), fy=_scalar(fy, dev),
        cx=_scalar(cx, dev), cy=_scalar(cy, dev),
        width=int(width), height=int(height), near=float(near), far=float(far),
    )


def agent_camera(
    agent_xy,
    yaw: float,
    width: int = 640,
    height: int = 480,
    focal_mm: float = 8.0,
    camera_height: float = AGENT_CAMERA_HEIGHT_M,
    pitch: float = AGENT_CAMERA_PITCH_RAD,
    **kw,
) -> Camera:
    """The agent's first-person camera: ``camera_height`` above the agent's
    (x, y), forward along the yaw with an optional downward pitch."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    forward = np.array([cy * cp, sy * cp, -sp])
    pos = np.array([float(agent_xy[0]), float(agent_xy[1]), camera_height])
    return make_camera(pos, forward, width, height, focal_mm=focal_mm, **kw)


def agent_camera_t(
    agent_xy: torch.Tensor,
    yaw: torch.Tensor,
    width: int = 640,
    height: int = 480,
    focal_mm: float = 8.0,
    camera_height: float = AGENT_CAMERA_HEIGHT_M,
    pitch: float = AGENT_CAMERA_PITCH_RAD,
    horizontal_aperture_mm: float = DEFAULT_HORIZONTAL_APERTURE_MM,
    near: float = 0.1,
    far: float = 50.0,
) -> Camera:
    """Agent camera from tensors (``agent_camera_jnp`` in the JAX package):
    the pose stays on its device, so a rollout builds cameras without a host
    round trip. Same geometry as ``agent_camera``. ``agent_xy`` (..., 2) and
    ``yaw`` (...) may carry a leading batch axis: (B, 2) and (B,) give a
    stacked Camera of B poses (``agent_camera_jnp`` under ``vmap``), each
    camera bitwise the one its pose gives alone."""
    agent_xy = torch.as_tensor(agent_xy, dtype=torch.float32)
    dev = agent_xy.device
    yaw = torch.as_tensor(yaw, dtype=torch.float32, device=dev)
    cy_, sy_ = torch.cos(yaw), torch.sin(yaw)
    p = _scalar(pitch, dev)
    cp, sp = torch.cos(p), torch.sin(p)
    zero = torch.zeros_like(yaw)
    forward = torch.stack([cy_ * cp, sy_ * cp, (-sp).expand(yaw.shape)],
                          dim=-1)
    # right = normalize(forward x up); z-up world => right = (sin, -cos, 0)
    right = torch.stack([sy_, -cy_, zero], dim=-1)
    down = torch.linalg.cross(forward, right, dim=-1)
    R = torch.stack([right, down, forward], dim=-1)
    fx = width * focal_mm / horizontal_aperture_mm

    def field(v):
        return _scalar(v, dev).expand(yaw.shape).clone()

    return Camera(
        position=torch.stack([agent_xy[..., 0], agent_xy[..., 1],
                              zero + np.float32(camera_height)], dim=-1),
        cam_to_world=R,
        fx=field(fx), fy=field(fx),
        cx=field(width / 2.0), cy=field(height / 2.0),
        width=int(width), height=int(height), near=near, far=far,
    )


def camera_rays_yaw(camera: Camera) -> torch.Tensor:
    """Yaw of the camera's forward axis in the world xy-plane (for policies)."""
    f = camera.cam_to_world[..., :, 2]
    return torch.atan2(f[..., 1], f[..., 0])


def stack_cameras(cams) -> Camera:
    """Stack same-resolution cameras into one Camera with a leading axis."""
    if len({(c.width, c.height, c.near, c.far) for c in cams}) != 1:
        raise ValueError("stack_cameras needs one resolution and clip range")
    c0 = cams[0]
    return c0._replace(**{f: torch.stack([getattr(c, f) for c in cams])
                          for f in _TENSOR_FIELDS})


def unstack_cameras(cameras: Camera) -> list:
    """The cameras of a stacked batch, one by one."""
    return [cameras._replace(**{f: getattr(cameras, f)[i]
                                for f in _TENSOR_FIELDS})
            for i in range(cameras.position.shape[0])]


def slice_cameras(cameras: Camera, sl: slice) -> Camera:
    """The cameras ``sl`` of a stacked batch, still stacked."""
    return cameras._replace(**{f: getattr(cameras, f)[sl]
                               for f in _TENSOR_FIELDS})


def camera_from_numpy(arrays: dict, device=None) -> Camera:
    """Build a Camera from the JAX ``Camera`` fields: the six array fields as
    numpy arrays plus ``width``, ``height`` and optionally ``near``/``far``."""
    dev = resolve_device(device)
    fields = {f: torch.from_numpy(np.array(arrays[f], dtype=np.float32)).to(dev)
              for f in _TENSOR_FIELDS}
    return Camera(**fields, width=int(arrays["width"]),
                  height=int(arrays["height"]),
                  near=float(arrays.get("near", 0.1)),
                  far=float(arrays.get("far", 50.0)))
