"""3D -> 2D Gaussian projection (EWA splatting) and SH colour.

PyTorch counterpart of ``sage3d_tpu/ops/projection.py``. The channel math and
its operation order are kept as written there: ``radii``, ``extents`` and
``visible`` come from ``ceil`` and comparisons of f32 expressions, and binning
reads all three, so they must land on the same integers as the JAX package.

``project_gaussians`` launches K7 (``csrc/project.cu``, wrapper
``project_gaussians_cuda``) wherever the scene lies on the card, and runs the
plain tensor code (``project_gaussians_plain``, which autograd
differentiates) on the CPU. K7 is the plain version's arithmetic in one
launch, its fields bitwise the plain version's on the card. Where a scene
tensor wants a gradient, K7 runs inside ``_ProjectK7``, whose backward is K8
(``project_gaussians_backward_cuda``, in the same source): the plain
version's reverse-mode arithmetic in one launch for the whole camera batch,
written out in tensor code by ``project_gaussians_backward_plain``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from ..renderer.camera import Camera
from ..renderer.scene import GaussianScene
from ..utils.profiling import count as add_count
from . import _build
from .sh import SH_C0, SH_C1, SH_C2, SH_C3, eval_sh

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
    """K7's rule: the scene lies on the card (with or without a gradient
    wanted)."""
    return scene.means.device.type == "cuda"


def _wants_grad(scene: GaussianScene, camera: Camera) -> bool:
    """Whether autograd should see the projection of a scene on the card:
    grad mode is on and a scene tensor the projection reads requires a
    gradient. A camera tensor that requires one raises: K8 gives no camera
    gradient."""
    if not torch.is_grad_enabled():
        return False
    if any(t.requires_grad for t in camera[:6]):
        raise ValueError("project_gaussians: a camera on the card that "
                         "requires a gradient is not taken (K8 gives the "
                         "scene's gradients only)")
    return any(t.requires_grad for t in scene[:5])


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

    A scene on the card takes K7 (``project_gaussians_cuda``), one launch:
    under ``_ProjectK7`` (backward K8, one launch) where a scene tensor
    wants a gradient, else alone. On the CPU the plain version runs.
    Counts ``projection.rows`` (cameras x Gaussians),
    ``projection.kernel_rows`` (the rows K7 took) and
    ``projection.grad_kernel_rows`` (those ``_ProjectK7`` took) on the
    recorder.
    """
    if sh_degree is None:
        sh_degree = scene.sh_degree
    kernel = _takes_kernel(scene, camera)
    grad = kernel and _wants_grad(scene, camera)
    rows = scene.num_gaussians * (camera.position.shape[0]
                                  if camera.position.dim() == 2 else 1)
    add_count("projection.rows", rows)
    add_count("projection.kernel_rows", rows if kernel else 0)
    add_count("projection.grad_kernel_rows", rows if grad else 0)
    if grad:
        return ProjectedGaussians(*_ProjectK7.apply(
            camera, sh_degree, clamp_dims, *scene[:5]))
    if kernel:
        return project_gaussians_cuda(scene, camera, sh_degree, clamp_dims)
    return project_gaussians_plain(scene, camera, sh_degree, clamp_dims)


def project_gaussians_plain(scene: GaussianScene, camera: Camera,
                            sh_degree: int,
                            clamp_dims: Optional[tuple] = None
                            ) -> ProjectedGaussians:
    """``project_gaussians`` as plain tensor code, differentiable: K7's
    twin and the CPU path (K8 is the twin of its autograd). The channel
    math is elementwise and the camera's scalars broadcast over the
    Gaussians, so a batch is one set of launches."""
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


def _pass_max_min(x, lim):
    """The share of the gradient of ``minimum(maximum(x, -lim), lim)`` that
    reaches ``x``, as autograd splits it: 1 inside, 0 outside, a half at
    each tie (the clamp written with ``torch.maximum``/``minimum``)."""
    m = torch.maximum(x, -lim)
    lo = torch.where(x == -lim, 0.5, torch.where(x < -lim, 0.0, 1.0))
    hi = torch.where(m == lim, 0.5, torch.where(m > lim, 0.0, 1.0))
    return lo * hi


def project_gaussians_backward_plain(scene: GaussianScene, camera: Camera,
                                     sh_degree: int,
                                     clamp_dims: Optional[tuple],
                                     grads) -> tuple:
    """The gradient of ``project_gaussians_plain`` written out: from the
    gradients of its five float fields ``grads`` = (means2d, conics,
    depths, colors, opacities), each None for zero, to those of the
    scene's (means, log_scales, quats, opacity_logits, sh), summed over the
    cameras of a batch. K8's twin and the arithmetic it mirrors: the
    forward's intermediates recomputed, then each operation's
    reverse-mode rule as autograd defines it (``clamp`` passes where its
    input is at or above the bound, ``maximum``/``minimum`` split ties in
    half, ``where`` feeds the branch it took; ``ceil`` and the comparisons,
    so radii, extents and visible, give nothing, nor does the opacity cut,
    which reads ``opacities.detach()``)."""
    clamp_w, clamp_h = clamp_dims if clamp_dims is not None else (
        camera.width, camera.height)
    batched = camera.position.dim() == 2

    def cam(x):
        return x[..., None] if batched else x

    def total(x):   # a (B, N) gradient summed over the cameras
        return x.sum(0) if batched else x

    W = camera.world_to_cam
    Wc = [[cam(W[..., i, j]) for j in range(3)] for i in range(3)]
    d = [scene.means[:, j] - cam(camera.position[..., j]) for j in range(3)]
    t0, t1, tz = (Wc[i][0] * d[0] + Wc[i][1] * d[1] + Wc[i][2] * d[2]
                  for i in range(3))
    lead = tz.shape
    fx, fy = cam(camera.fx), cam(camera.fy)
    zero = tz.new_zeros(())

    def given(g, width=None):
        if g is not None:
            return g
        return tz.new_zeros(lead if width is None else lead + (width,))

    g_m2, g_con, g_depth, g_col, g_op = (
        given(grads[0], 2), given(grads[1], 3), given(grads[2]),
        given(grads[3], 3), given(grads[4]))

    # -- the forward's intermediates ---------------------------------------
    guarded = torch.abs(tz) < 1e-6
    tz_safe = torch.where(guarded, 1e-6, tz)
    inv_z = 1.0 / tz_safe
    lim_x = 1.3 * (0.5 * clamp_w / fx)
    lim_y = 1.3 * (0.5 * clamp_h / fy)
    rx, ry = t0 * inv_z, t1 * inv_z
    clx = torch.minimum(torch.maximum(rx, -lim_x), lim_x)
    cly = torch.minimum(torch.maximum(ry, -lim_y), lim_y)
    txz, tyz = clx * tz_safe, cly * tz_safe
    fx_z, fy_z = fx * inv_z, fy * inv_z
    jx2 = -fx * txz * inv_z * inv_z
    jy2 = -fy * tyz * inv_z * inv_z
    jw0 = [fx_z * Wc[0][j] + jx2 * Wc[2][j] for j in range(3)]
    jw1 = [fy_z * Wc[1][j] + jy2 * Wc[2][j] for j in range(3)]
    Rq = _rotmat_channels(scene.quats)
    S = torch.exp(scene.log_scales)
    p0 = [jw0[0] * Rq[0][k] + jw0[1] * Rq[1][k] + jw0[2] * Rq[2][k]
          for k in range(3)]
    p1 = [jw1[0] * Rq[0][k] + jw1[1] * Rq[1][k] + jw1[2] * Rq[2][k]
          for k in range(3)]
    u0 = [S[:, k] * p0[k] for k in range(3)]
    u1 = [S[:, k] * p1[k] for k in range(3)]
    a = u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2] + COV2D_DILATION
    b = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2]
    c = u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2] + COV2D_DILATION
    det = a * c - b * b
    inv_det = 1.0 / torch.where(det <= 0, 1.0, det)

    # -- conics -> the 2D covariance -> the EWA factors ---------------------
    g_a = g_con[..., 2] * inv_det
    g_b = -g_con[..., 1] * inv_det
    g_c = g_con[..., 0] * inv_det
    g_inv = g_con[..., 0] * c - g_con[..., 1] * b + g_con[..., 2] * a
    g_det = torch.where(det <= 0, zero, -g_inv * inv_det * inv_det)
    g_a = g_a + g_det * c
    g_c = g_c + g_det * a
    g_b = g_b - 2.0 * b * g_det
    g_u0 = [2.0 * u0[k] * g_a + u1[k] * g_b for k in range(3)]
    g_u1 = [2.0 * u1[k] * g_c + u0[k] * g_b for k in range(3)]
    g_S = [total(g_u0[k] * p0[k] + g_u1[k] * p1[k]) for k in range(3)]
    g_p0 = [g_u0[k] * S[:, k] for k in range(3)]
    g_p1 = [g_u1[k] * S[:, k] for k in range(3)]
    g_R = [[total(g_p0[k] * jw0[i] + g_p1[k] * jw1[i]) for k in range(3)]
           for i in range(3)]
    g_jw0 = [sum(g_p0[k] * Rq[i][k] for k in range(3)) for i in range(3)]
    g_jw1 = [sum(g_p1[k] * Rq[i][k] for k in range(3)) for i in range(3)]

    # -- the Jacobian and the mean -> camera space --------------------------
    g_fx_z = sum(g_jw0[j] * Wc[0][j] for j in range(3))
    g_jx2 = sum(g_jw0[j] * Wc[2][j] for j in range(3))
    g_fy_z = sum(g_jw1[j] * Wc[1][j] for j in range(3))
    g_jy2 = sum(g_jw1[j] * Wc[2][j] for j in range(3))
    g_u, g_v = g_m2[..., 0], g_m2[..., 1]
    g_txz = -fx * g_jx2 * inv_z * inv_z
    g_tyz = -fy * g_jy2 * inv_z * inv_z
    g_rx = g_txz * tz_safe * _pass_max_min(rx, lim_x)
    g_ry = g_tyz * tz_safe * _pass_max_min(ry, lim_y)
    g_iz = (g_fx_z * fx + g_fy_z * fy
            - 2.0 * inv_z * (g_jx2 * fx * txz + g_jy2 * fy * tyz)
            + g_u * fx * t0 + g_v * fy * t1 + g_rx * t0 + g_ry * t1)
    g_t0 = (g_u * fx + g_rx) * inv_z
    g_t1 = (g_v * fy + g_ry) * inv_z
    g_tz_safe = g_txz * clx + g_tyz * cly - g_iz * inv_z * inv_z
    g_tz = g_depth + torch.where(guarded, zero, g_tz_safe)
    g_d = [Wc[0][j] * g_t0 + Wc[1][j] * g_t1 + Wc[2][j] * g_tz
           for j in range(3)]

    # -- SH colour -> coefficients and view direction -----------------------
    sh = scene.sh
    g_sh = torch.zeros_like(sh)
    if sh_degree == 0:
        res = SH_C0 * sh[:, 0, :] + 0.5
        g_sh[:, 0, :] = SH_C0 * torch.where(res >= 0, total(g_col), zero)
    else:
        norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        den = norm + 1e-12
        x, y, z = (dj / den for dj in d)
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        one = torch.ones_like(x)
        # (basis function, its d/dx, d/dy, d/dz) of each coefficient
        basis = [(SH_C0 * one, zero, zero, zero),
                 (-SH_C1 * y, zero, -SH_C1 * one, zero),
                 (SH_C1 * z, zero, zero, SH_C1 * one),
                 (-SH_C1 * x, -SH_C1 * one, zero, zero)]
        if sh_degree >= 2:
            c2 = SH_C2
            basis += [
                (c2[0] * xy, c2[0] * y, c2[0] * x, zero),
                (c2[1] * yz, zero, c2[1] * z, c2[1] * y),
                (c2[2] * (2.0 * zz - xx - yy), -2.0 * c2[2] * x,
                 -2.0 * c2[2] * y, 4.0 * c2[2] * z),
                (c2[3] * xz, c2[3] * z, zero, c2[3] * x),
                (c2[4] * (xx - yy), 2.0 * c2[4] * x, -2.0 * c2[4] * y, zero)]
        if sh_degree >= 3:
            c3 = SH_C3
            basis += [
                (c3[0] * y * (3.0 * xx - yy), 6.0 * c3[0] * xy,
                 3.0 * c3[0] * (xx - yy), zero),
                (c3[1] * xy * z, c3[1] * yz, c3[1] * xz, c3[1] * xy),
                (c3[2] * y * (4.0 * zz - xx - yy), -2.0 * c3[2] * xy,
                 c3[2] * (4.0 * zz - xx - 3.0 * yy), 8.0 * c3[2] * yz),
                (c3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                 -6.0 * c3[3] * xz, -6.0 * c3[3] * yz,
                 c3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
                (c3[4] * x * (4.0 * zz - xx - yy),
                 c3[4] * (4.0 * zz - 3.0 * xx - yy), -2.0 * c3[4] * xy,
                 8.0 * c3[4] * xz),
                (c3[5] * z * (xx - yy), 2.0 * c3[5] * xz, -2.0 * c3[5] * yz,
                 c3[5] * (xx - yy)),
                (c3[6] * x * (xx - 3.0 * yy), 3.0 * c3[6] * (xx - yy),
                 -6.0 * c3[6] * xy, zero)]
        res = sum(f[..., None] * sh[:, k, :] for k, (f, *_) in
                  enumerate(basis))
        g_res = torch.where(res + 0.5 >= 0, g_col, zero)
        g_dir = [zero, zero, zero]
        for k, (f, *df) in enumerate(basis):
            g_sh[:, k, :] = total(f[..., None] * g_res)
            g_f = (g_res * sh[:, k, :]).sum(-1)
            g_dir = [g_dir[j] + g_f * df[j] for j in range(3)]
        g_norm = -(g_dir[0] * d[0] + g_dir[1] * d[1] + g_dir[2] * d[2]) / (
            den * den)
        g_d = [g_d[j] + g_dir[j] / den + g_norm * d[j] / norm
               for j in range(3)]

    # -- the per-Gaussian parameters ----------------------------------------
    g_means = torch.stack([total(g) for g in g_d], -1)
    g_log_scales = torch.stack(g_S, -1) * S
    q = scene.quats
    nq = torch.linalg.norm(q, dim=-1, keepdim=True)
    qn = q / (nq + 1e-12)
    w, qx, qy, qz = qn.unbind(-1)
    (g00, g01, g02), (g10, g11, g12), (g20, g21, g22) = g_R
    g_qn = 2.0 * torch.stack([
        -qz * g01 + qy * g02 + qz * g10 - qx * g12 - qy * g20 + qx * g21,
        qy * g01 + qz * g02 + qy * g10 - 2.0 * qx * g11 - w * g12
        + qz * g20 + w * g21 - 2.0 * qx * g22,
        -2.0 * qy * g00 + qx * g01 + w * g02 + qx * g10 + qz * g12
        - w * g20 + qz * g21 - 2.0 * qy * g22,
        -2.0 * qz * g00 - w * g01 + qx * g02 + w * g10 - 2.0 * qz * g11
        + qy * g12 + qx * g20 + qy * g21], -1)
    dot = (g_qn * q).sum(-1, keepdim=True)
    g_quats = g_qn / (nq + 1e-12) - torch.where(
        nq == 0, zero, dot / ((nq + 1e-12) ** 2 * nq)) * q
    s_op = torch.sigmoid(scene.opacity_logits)
    g_logits = total(g_op) * (1.0 - s_op) * s_op
    return g_means, g_log_scales, g_quats, g_logits, g_sh


# cameras one K7 launch takes: 16 a block, 65535 blocks along grid.y
K7_MAX_CAMERAS = 16 * 65535


def _kernel_args(scene: GaussianScene, camera: Camera, sh_degree: int,
                 clamp_dims: Optional[tuple], what: str) -> list:
    """K7's and K8's shared check of the scene and the camera, and their
    shared arguments from the scene's pointers to the far plane."""
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
            raise ValueError(f"{what}: expected a contiguous {shape} float32 "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    if not 0 <= sh_degree <= 3 or (sh_degree + 1) ** 2 > k:
        raise ValueError(f"{what}: SH degree {sh_degree} needs "
                         f"{(sh_degree + 1) ** 2} of the scene's {k} "
                         "coefficients, at most degree 3")
    if n >= 2**31 or b > K7_MAX_CAMERAS:
        raise ValueError(f"{what}: at most 2^31 - 1 Gaussians and "
                         f"{K7_MAX_CAMERAS} cameras a launch")
    dev = scene.means.device
    if dev.type != "cuda" or any(t.device != dev for t, _ in want):
        raise ValueError(f"{what}: the scene and the camera must lie on one "
                         "CUDA device")
    clamp_w, clamp_h = clamp_dims if clamp_dims is not None else (
        camera.width, camera.height)
    sh_vec = int(scene.sh.data_ptr() % 16 == 0 and 3 * k % 4 == 0)
    return [*(t.data_ptr() for t in scene[:5]), n, 3 * k, sh_vec, sh_degree,
            *(t.data_ptr() for t in camera[:6]), b, 0.5 * clamp_w,
            0.5 * clamp_h, float(camera.width), float(camera.height),
            float(camera.near), float(camera.far)]


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
    args = _kernel_args(scene, camera, sh_degree, clamp_dims,
                        "project_gaussians_cuda")
    n, dev = scene.means.shape[0], scene.means.device
    batched = camera.position.dim() == 2
    lead = (camera.position.shape[0], n) if batched else (n,)

    def out(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    proj = ProjectedGaussians(
        means2d=out(lead + (2,)), conics=out(lead + (3,)), depths=out(lead),
        radii=out(lead, torch.int32),
        colors=out(lead + (3,) if sh_degree else (n, 3)),
        opacities=out((n,)), visible=out(lead, torch.bool),
        extents=out(lead + (2,)))
    err = _build.launch(_build.load("project").sage3d_project, dev, *args,
                        *(t.data_ptr() for t in proj))
    _build.check(err, "project_gaussians_cuda")
    project_gaussians_cuda.launches += 1
    return proj._replace(colors=proj.colors.expand(lead + (3,)),
                         opacities=proj.opacities.expand(lead))


project_gaussians_cuda.launches = 0


def project_gaussians_backward_cuda(scene: GaussianScene, camera: Camera,
                                    sh_degree: int,
                                    clamp_dims: Optional[tuple],
                                    grads) -> tuple:
    """K8 (``csrc/project.cu``): ``project_gaussians_backward_plain`` in one
    launch for one camera or a stacked batch. ``grads`` = the gradients of
    (means2d, conics, depths, colors, opacities), each None for zero or a
    float32 tensor of the field's (B, N, ...) / (N, ...) shape on the
    scene's device, read through its strides (a channel dimension is made
    unit-stride first). The scene and the camera as K7 takes them. Returns
    the gradients of (means, log_scales, quats, opacity_logits, sh), new
    contiguous tensors; SH coefficients above ``sh_degree`` get zeros."""
    n, dev = scene.means.shape[0], scene.means.device
    batched = camera.position.dim() == 2
    lead = (camera.position.shape[0], n) if batched else (n,)
    views, keep = [], []   # keep: copies made here, alive until queued
    for g, width in zip(grads, (2, 3, None, 3, None)):
        if g is None:
            views += [0, 0, 0]
            continue
        shape = lead + (() if width is None else (width,))
        if (tuple(g.shape) != shape or g.dtype != torch.float32
                or g.device != dev):
            raise ValueError("project_gaussians_backward_cuda: expected a "
                             f"{shape} float32 gradient on {dev}, got "
                             f"{tuple(g.shape)} {g.dtype} on {g.device}")
        if width is not None and g.stride(-1) != 1:
            g = g.contiguous()
        keep.append(g)
        lead_strides = g.stride()[:len(lead)]
        views += [g.data_ptr(), lead_strides[0] if batched else 0,
                  lead_strides[-1]]
    args = _kernel_args(scene, camera, sh_degree, clamp_dims,
                        "project_gaussians_backward_cuda")
    out = tuple(torch.empty(t.shape, dtype=torch.float32, device=dev)
                for t in scene[:5])
    err = _build.launch(_build.load("project").sage3d_project_bwd, dev,
                        *args, *views, *(t.data_ptr() for t in out))
    _build.check(err, "project_gaussians_backward_cuda")
    project_gaussians_backward_cuda.launches += 1
    return out


project_gaussians_backward_cuda.launches = 0


class _ProjectK7(torch.autograd.Function):
    """``project_gaussians`` of a scene on the card under autograd: K7
    forward (bitwise the plain version's fields), K8 backward, one launch
    each for the whole camera batch. Saves only its inputs: the scene's
    five tensors, the camera, the degree and the clamp. The integer and
    box fields (radii, visible, extents) take no gradient."""

    @staticmethod
    def forward(ctx, camera, sh_degree, clamp_dims, *params):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*params)
        ctx.camera, ctx.sh_degree, ctx.clamp_dims = (camera, sh_degree,
                                                     clamp_dims)
        proj = project_gaussians_cuda(GaussianScene(*params, None), camera,
                                      sh_degree, clamp_dims)
        ctx.mark_non_differentiable(proj.radii, proj.visible, proj.extents)
        return tuple(proj)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_means2d, g_conics, g_depths, _radii, g_colors,
                 g_opacities, _visible, _extents):
        grads = project_gaussians_backward_cuda(
            GaussianScene(*ctx.saved_tensors, None), ctx.camera,
            ctx.sh_degree, ctx.clamp_dims,
            (g_means2d, g_conics, g_depths, g_colors, g_opacities))
        return (None, None, None, *grads)


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
