"""3D -> 2D Gaussian projection (EWA splatting) and SH colour.

PyTorch counterpart of ``sage3d_tpu/ops/projection.py``. The channel math and
its operation order are kept as written there: ``radii``, ``extents`` and
``visible`` come from ``ceil`` and comparisons of f32 expressions, and binning
reads all three, so they must land on the same integers as the JAX package.

``project_gaussians`` launches K7 (``csrc/project.cu``, wrapper
``project_gaussians_cuda``) where the scene lies on the card and no gradient
is wanted, and runs the plain tensor code (``project_gaussians_plain``, which
autograd differentiates) otherwise: on the CPU and under autograd. K7 is the
plain version's arithmetic in one launch, its fields bitwise the plain
version's on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..renderer.camera import Camera
from ..renderer.scene import GaussianScene
from ..utils.profiling import count as add_count
from . import _build
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


def _takes_kernel(scene: GaussianScene, camera: Camera) -> bool:
    """K7's rule: the scene lies on the card and no gradient is wanted
    (grad mode is off, or no scene or camera tensor the projection reads
    requires one)."""
    return scene.means.device.type == "cuda" and not (
        torch.is_grad_enabled()
        and any(t.requires_grad for t in (*scene[:5], *camera[:6])))


def project_gaussians(scene: GaussianScene, camera: Camera,
                      sh_degree: Optional[int] = None,
                      clamp_dims: Optional[tuple] = None) -> ProjectedGaussians:
    """Project all Gaussians into one camera, or into each camera of a
    stacked batch (``stack_cameras``): then every field carries a leading
    camera axis, (B, N, ...), and camera b's slice is bitwise what camera b
    alone gives. View-dependent SH per camera; autograd sums the scene's
    gradients over the cameras.

    ``clamp_dims`` (width, height) overrides the frustum-cone clamp used in the
    EWA Jacobian (band-sharded renders pass the full frame dims).

    A scene on the card with no gradient wanted takes K7
    (``project_gaussians_cuda``), one launch; otherwise the plain version
    runs. Counts ``projection.rows`` (cameras x Gaussians) and
    ``projection.kernel_rows`` (the rows K7 took) on the recorder.
    """
    if sh_degree is None:
        sh_degree = scene.sh_degree
    kernel = _takes_kernel(scene, camera)
    rows = scene.num_gaussians * (camera.position.shape[0]
                                  if camera.position.dim() == 2 else 1)
    add_count("projection.rows", rows)
    add_count("projection.kernel_rows", rows if kernel else 0)
    if kernel:
        return project_gaussians_cuda(scene, camera, sh_degree, clamp_dims)
    return project_gaussians_plain(scene, camera, sh_degree, clamp_dims)


def project_gaussians_plain(scene: GaussianScene, camera: Camera,
                            sh_degree: int,
                            clamp_dims: Optional[tuple] = None
                            ) -> ProjectedGaussians:
    """``project_gaussians`` as plain tensor code, differentiable: K7's
    twin, the CPU path and the path under autograd. The channel math is
    elementwise and the camera's scalars broadcast over the Gaussians, so a
    batch is one set of launches."""
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


# cameras one K7 launch takes: 16 a block, 65535 blocks along grid.y
K7_MAX_CAMERAS = 16 * 65535


def project_gaussians_cuda(scene: GaussianScene, camera: Camera,
                           sh_degree: int,
                           clamp_dims: Optional[tuple] = None
                           ) -> ProjectedGaussians:
    """K7 (``csrc/project.cu``): ``project_gaussians_plain``'s fields in one
    launch, for one camera or a stacked batch, with no autograd. The scene's
    and the camera's tensors are float32, contiguous and on one CUDA
    device; ``sh_degree`` is 0-3 and at most the scene's. The opacities,
    and the colours at degree 0, are one (N,) / (N, 3) tensor expanded over
    the cameras, as the plain version's are."""
    n = scene.means.shape[0]
    batched = camera.position.dim() == 2
    b = camera.position.shape[0] if batched else 1
    cam = (b,) if batched else ()
    k = scene.sh.shape[1] if scene.sh.dim() == 3 else -1
    want = [(scene.means, (n, 3)), (scene.log_scales, (n, 3)),
            (scene.quats, (n, 4)), (scene.opacity_logits, (n,)),
            (scene.sh, (n, k, 3)), (camera.position, cam + (3,)),
            (camera.cam_to_world, cam + (3, 3)),
            *((t, cam) for t in camera[2:6])]
    for t, shape in want:
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"project_gaussians_cuda: expected a contiguous "
                             f"{shape} float32 tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if not 0 <= sh_degree <= 3 or (sh_degree + 1) ** 2 > k:
        raise ValueError(f"project_gaussians_cuda: SH degree {sh_degree} "
                         f"needs {(sh_degree + 1) ** 2} of the scene's {k} "
                         "coefficients, at most degree 3")
    if n >= 2**31 or b > K7_MAX_CAMERAS:
        raise ValueError("project_gaussians_cuda: at most 2^31 - 1 Gaussians "
                         f"and {K7_MAX_CAMERAS} cameras a launch")
    dev = scene.means.device
    if dev.type != "cuda" or any(t.device != dev for t, _ in want):
        raise ValueError("project_gaussians_cuda: the scene and the camera "
                         "must lie on one CUDA device")
    clamp_w, clamp_h = clamp_dims if clamp_dims is not None else (
        camera.width, camera.height)
    lead = (b, n) if batched else (n,)

    def out(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    proj = ProjectedGaussians(
        means2d=out(lead + (2,)), conics=out(lead + (3,)), depths=out(lead),
        radii=out(lead, torch.int32),
        colors=out(lead + (3,) if sh_degree else (n, 3)),
        opacities=out((n,)), visible=out(lead, torch.bool),
        extents=out(lead + (2,)))
    sh_vec = int(scene.sh.data_ptr() % 16 == 0 and 3 * k % 4 == 0)
    err = _build.launch(
        _build.load("project").sage3d_project, dev,
        *(t.data_ptr() for t in scene[:5]), n, 3 * k, sh_vec, sh_degree,
        *(t.data_ptr() for t in camera[:6]), b, 0.5 * clamp_w,
        0.5 * clamp_h, float(camera.width), float(camera.height),
        float(camera.near), float(camera.far),
        *(t.data_ptr() for t in proj))
    _build.check(err, "project_gaussians_cuda")
    project_gaussians_cuda.launches += 1
    return proj._replace(colors=proj.colors.expand(lead + (3,)),
                         opacities=proj.opacities.expand(lead))


project_gaussians_cuda.launches = 0


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
