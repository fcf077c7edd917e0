"""3D -> 2D Gaussian projection (EWA splatting), plain tensor code, autograd.

PyTorch counterpart of ``sage3d_tpu/ops/projection.py``. The channel math and
its operation order are kept as written there: ``radii``, ``extents`` and
``visible`` come from ``ceil`` and comparisons of f32 expressions, and binning
reads all three, so they must land on the same integers as the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..renderer.camera import Camera
from ..renderer.scene import GaussianScene
from .sh import eval_sh

COV2D_DILATION = 0.3
ALPHA_MAX = 0.99    # compositing clamp, classic 3DGS
ALPHA_MIN = 1.0 / 255.0


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen-space quantities consumed by the compositors."""

    means2d: torch.Tensor    # (N, 2) pixel coords ((B, N, ...) for a camera batch)
    conics: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c): [[a,b],[b,c]]
    depths: torch.Tensor     # (N,) camera-space z
    radii: torch.Tensor      # (N,) int32 conservative pixel radius (0 => culled)
    colors: torch.Tensor     # (N, 3) view-dependent RGB
    opacities: torch.Tensor  # (N,)
    visible: torch.Tensor    # (N,) bool
    extents: torch.Tensor    # (N, 2) tight AABB half-extents in pixels (x, y)


def _rotmat_channels(quats: torch.Tensor):
    """Normalized-quaternion rotation matrix as 9 separate (...,) channels."""
    q = quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) quaternions -> (..., 3, 3) rotation matrices."""
    R = _rotmat_channels(quats)
    return torch.stack([torch.stack(row, -1) for row in R], dim=-2)


def covariance_3d(log_scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T (the matrix form ``project_gaussians`` computes as
    channels)."""
    R = quat_to_rotmat(quats)
    S = torch.exp(log_scales)
    M = R * S[..., None, :]
    return M @ M.transpose(-1, -2)


def project_gaussians(scene: GaussianScene, camera: Camera,
                      sh_degree: Optional[int] = None,
                      clamp_dims: Optional[tuple] = None) -> ProjectedGaussians:
    """Project all Gaussians into one camera, or into each camera of a
    stacked batch (``stack_cameras``): then every field carries a leading
    camera axis, (B, N, ...), and camera b's slice is bitwise what camera b
    alone gives (the channel math is elementwise, the camera's scalars
    broadcast over the Gaussians). The batch is one set of launches with
    view-dependent SH per camera; autograd sums the scene's gradients over
    the cameras.

    ``clamp_dims`` (width, height) overrides the frustum-cone clamp used in the
    EWA Jacobian (band-sharded renders pass the full frame dims).
    """
    if sh_degree is None:
        sh_degree = scene.sh_degree
    clamp_w, clamp_h = clamp_dims if clamp_dims is not None else (
        camera.width, camera.height)
    batched = camera.position.dim() == 2

    def cam(x):   # a camera scalar, shaped to broadcast over the Gaussians
        return x[..., None] if batched else x

    W = camera.world_to_cam                        # (3, 3) world -> camera
    Wc = [[cam(W[..., i, j]) for j in range(3)] for i in range(3)]
    d0 = scene.means[:, 0] - cam(camera.position[..., 0])
    d1 = scene.means[:, 1] - cam(camera.position[..., 1])
    d2 = scene.means[:, 2] - cam(camera.position[..., 2])
    t0, t1, tz = (Wc[i][0] * d0 + Wc[i][1] * d1 + Wc[i][2] * d2
                  for i in range(3))
    depths = tz
    fx, fy, cx, cy = (cam(x) for x in (camera.fx, camera.fy, camera.cx,
                                        camera.cy))

    tz_safe = torch.where(torch.abs(tz) < 1e-6, 1e-6, tz)
    inv_z = 1.0 / tz_safe
    u = fx * t0 * inv_z + cx
    v = fy * t1 * inv_z + cy
    means2d = torch.stack([u, v], dim=-1)

    # EWA: Sigma2D = (JW M)(JW M)^T with M = R diag(S), as channel math.
    # The Jacobian point is clamped to the frustum cone (classic 3DGS).
    lim_x = 1.3 * (0.5 * clamp_w / fx)
    lim_y = 1.3 * (0.5 * clamp_h / fy)
    txz = torch.minimum(torch.maximum(t0 * inv_z, -lim_x), lim_x) * tz_safe
    tyz = torch.minimum(torch.maximum(t1 * inv_z, -lim_y), lim_y) * tz_safe
    fx_z = fx * inv_z
    fy_z = fy * inv_z
    jx2 = -fx * txz * inv_z * inv_z   # J[0,2]
    jy2 = -fy * tyz * inv_z * inv_z   # J[1,2]
    jw0 = [fx_z * Wc[0][j] + jx2 * Wc[2][j] for j in range(3)]
    jw1 = [fy_z * Wc[1][j] + jy2 * Wc[2][j] for j in range(3)]
    Rq = _rotmat_channels(scene.quats)
    S = torch.exp(scene.log_scales)
    u0 = [S[:, k] * (jw0[0] * Rq[0][k] + jw0[1] * Rq[1][k] + jw0[2] * Rq[2][k])
          for k in range(3)]
    u1 = [S[:, k] * (jw1[0] * Rq[0][k] + jw1[1] * Rq[1][k] + jw1[2] * Rq[2][k])
          for k in range(3)]
    a = u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2] + COV2D_DILATION
    b = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2]
    c = u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2] + COV2D_DILATION
    det = a * c - b * b
    det_safe = torch.where(det <= 0, 1.0, det)
    inv_det = 1.0 / det_safe
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    # Opacity-aware extent: the last contributing pixel has Mahalanobis
    # m <= sqrt(2 ln(op / ALPHA_MIN)) (the compositors zero alpha below it).
    op = scene.opacities.detach()
    cut2 = 2.0 * torch.log(torch.clamp(op, min=ALPHA_MIN) / ALPHA_MIN)
    s_cut = torch.sqrt(torch.clamp(cut2, min=1e-6))
    mid = 0.5 * (a + c)
    eig_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radii_f = torch.ceil(s_cut * torch.sqrt(eig_max)) + 1.0
    ext_x = torch.ceil(s_cut * torch.sqrt(torch.clamp(a, min=0.0))) + 1.0
    ext_y = torch.ceil(s_cut * torch.sqrt(torch.clamp(c, min=0.0))) + 1.0

    # The view direction's norm written out, so that it adds in one order
    # whatever the batch (a reduction's order may follow the shape).
    norm = torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
    view_dirs = torch.stack([d0, d1, d2], dim=-1) / (norm[..., None] + 1e-12)
    # (degree 0 does not read the direction: one set of colours for all)
    colors = eval_sh(scene.sh, view_dirs, sh_degree).expand(
        view_dirs.shape)

    inside = ((u + ext_x > 0) & (u - ext_x < camera.width)
              & (v + ext_y > 0) & (v - ext_y < camera.height))
    visible = ((tz > camera.near) & (tz < camera.far) & (det > 0) & inside
               & (op > ALPHA_MIN))
    radii = torch.where(visible, radii_f, 0.0).to(torch.int32)
    extents = torch.where(visible[..., None], torch.stack([ext_x, ext_y], -1),
                          0.0)

    return ProjectedGaussians(
        means2d=means2d,
        conics=conics,
        depths=depths,
        radii=radii,
        colors=colors,
        opacities=scene.opacities.expand(depths.shape),
        visible=visible,
        extents=extents,
    )


def alpha_at(proj: ProjectedGaussians, px: torch.Tensor,
             py: torch.Tensor) -> torch.Tensor:
    """Opacity of every Gaussian at pixel (px, py): the EWA footprint.
    (px, py) broadcast against N; used by the oracle compositor and tests."""
    dx = px[..., None] - proj.means2d[:, 0]
    dy = py[..., None] - proj.means2d[:, 1]
    a, b, c = proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = proj.opacities * torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.where(power > 0.0, 0.0, alpha)         # outside-center guard
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)   # classic 3DGS cutoff
    return torch.where(proj.visible, alpha, 0.0)
