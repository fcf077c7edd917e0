// K7: the EWA projection and SH colour of project_gaussians, and K8, its
// backward, hand-written for Hopper (sm_90a).
//
// Replace no TPU kernel: the JAX package computes the projection in plain
// XLA (sage3d_tpu/ops/projection.py::project_gaussians, ops/sh.py) and takes
// its gradient from XLA's autodiff, and the port's plain version
// (ops/projection.py::project_gaussians_plain) is a chain of ~300
// elementwise PyTorch launches forward and about twice as many under
// autograd backward, each reading and writing whole (B, N) tensors. K7
// computes every field project_gaussians returns in one launch, for one
// camera or a stacked batch of B, wherever the scene lies on the card; under
// autograd it is the forward of ops/projection.py::_ProjectK7, whose
// backward is K8 (below).
//
// Numbers: each field is the plain chain's, channel by channel and in its
// order, each operation one f32 rounding as PyTorch's CUDA kernels round it
// (built with -fmad=false; IEEE division, sqrtf, expf and logf; Python
// constants cast from double to float as PyTorch casts a scalar). Where
// PyTorch rewrites an operation, K7 writes the rewrite: `s / t` is
// reciprocal(t) * s (Tensor.__rtruediv__); `t / s` by a Python float is,
// on the card, t * float(1 / s), the reciprocal taken in double; clamp,
// maximum and minimum keep a NaN; torch.linalg.norm of a quaternion adds
// its squares as (w^2 + y^2) + (x^2 + z^2). The sigmoid is K6's (PyTorch's
// CUDA sigmoid written out). On an H100 (torch 2.11, CUDA 12.8) a probe of
// each rewrite against the operation found no differing value in 10^6.
// So radii, extents and visible, which come from ceil and comparisons, land
// on the plain chain's integers, and a camera of a batch is bitwise what it
// gives alone (its math reads only its own camera).
//
// What bounds it on an H100: bytes. A Gaussian's 236 bytes at SH 3 (means,
// log-scales, quaternion, opacity logit, 48 SH floats) are read once, and
// 49 bytes a (camera, Gaussian) row are written (means2d 8, conics 12,
// depths 4, radii 4, colours 12, visible 1, extents 8): 0.086 ms for one
// camera at 1M Gaussians, 0.19 ms for 8, at 3.35 TB/s. Design: one thread a
// Gaussian, 128 a block; the Gaussian's fields are loaded once into
// registers (the SH as 16-byte loads where its rows allow), only the
// (d+1)^2 coefficients the degree needs; the rotation, scales, opacity and
// its cut are computed once; then the thread loops over the block's
// cameras, whose constants (and the frustum clamp each derives) sit in
// shared memory, at most kCams a block (grid.y takes the rest), and writes
// row b*N + g, so neighbouring threads write neighbouring addresses. The
// opacities (N,), and the colours (N, 3) at degree 0, are written once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCams = 16;   // cameras a block keeps in shared memory

// Python float constants of ops/projection.py and ops/sh.py, cast to f32 as
// PyTorch casts a scalar operand of an f32 tensor.
constexpr float kDilation = (float)0.3;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kInvAlphaMin = (float)(1.0 / (1.0 / 255.0));
constexpr float kTiny = (float)1e-12;
constexpr float kZeroZ = (float)1e-6;
constexpr float kCutFloor = (float)1e-6;
constexpr float kEigFloor = (float)0.01;
constexpr float kFrustum = (float)1.3;
constexpr float kC0 = (float)0.28209479177387814;
constexpr float kC1 = (float)0.4886025119029199;
constexpr float kC20 = (float)1.0925484305920792;
constexpr float kC21 = (float)-1.0925484305920792;
constexpr float kC22 = (float)0.31539156525252005;
constexpr float kC23 = (float)-1.0925484305920792;
constexpr float kC24 = (float)0.5462742152960396;
constexpr float kC30 = (float)-0.5900435899266435;
constexpr float kC31 = (float)2.890611442640554;
constexpr float kC32 = (float)-0.4570457994644658;
constexpr float kC33 = (float)0.3731763325901154;
constexpr float kC34 = (float)-0.4570457994644658;
constexpr float kC35 = (float)1.445305721320277;
constexpr float kC36 = (float)-0.5900435899266435;

// PyTorch's CUDA sigmoid for float32: one / (one + std::exp(-a)) (K6's).
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// torch.clamp(v, min=lo): a NaN stays a NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// torch.maximum / torch.minimum: a NaN in either operand is the result.
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

struct Scene {
  const float* means;       // (N, 3)
  const float* log_scales;  // (N, 3)
  const float* quats;       // (N, 4) (w, x, y, z)
  const float* logits;      // (N,)
  const float* sh;          // (N, K, 3)
  int n;
  int sh_row;               // K * 3 floats
  int sh_vec;               // 1: rows 16-byte aligned, K * 3 % 4 == 0
};

struct Cameras {
  const float* position;      // (B, 3)
  const float* cam_to_world;  // (B, 3, 3), columns the camera axes
  const float* fx;            // (B,)
  const float* fy;
  const float* cx;
  const float* cy;
  int b;
  float half_w, half_h;       // 0.5 * the clamp dims, as Python computes them
  float width, height, near, far;
};

struct Out {
  float* means2d;          // (B, N, 2)
  float* conics;           // (B, N, 3)
  float* depths;           // (B, N)
  int* radii;              // (B, N)
  float* colors;           // (B, N, 3); (N, 3) at degree 0
  float* opacities;        // (N,)
  unsigned char* visible;  // (B, N) bool
  float* extents;          // (B, N, 2)
};

struct Cam {
  float w[9];              // world -> camera, row-major
  float pos[3];
  float fx, fy, cx, cy;
  float lim_x, lim_y;
};

// Camera b's constants and the frustum clamp it derives.
__device__ __forceinline__ void load_cam(const Cameras& cs, int b, Cam& c) {
  const float* r = cs.cam_to_world + 9 * b;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.w[3 * i + j] = r[3 * j + i];
    c.pos[i] = cs.position[3 * b + i];
  }
  c.fx = cs.fx[b];
  c.fy = cs.fy[b];
  c.cx = cs.cx[b];
  c.cy = cs.cy[b];
  // 1.3 * (0.5 * clamp_w / fx): reciprocal(fx) * half_w, then * 1.3
  c.lim_x = (1.0f / c.fx) * cs.half_w * kFrustum;
  c.lim_y = (1.0f / c.fy) * cs.half_h * kFrustum;
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
project_kernel(Scene s, Cameras cs, Out o) {
  __shared__ Cam cams[kCams];
  const int b0 = blockIdx.y * kCams;
  const int nb = min(kCams, cs.b - b0);
  if ((int)threadIdx.x < nb) load_cam(cs, b0 + threadIdx.x, cams[threadIdx.x]);
  __syncthreads();
  // 64-bit, so that 4 * g and 3 * g stay exact up to n = 2^31 - 1
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= s.n) return;

  // -- the Gaussian, once -------------------------------------------------
  const float mx = s.means[3 * g], my = s.means[3 * g + 1],
              mz = s.means[3 * g + 2];
  const float S0 = expf(s.log_scales[3 * g]),
              S1 = expf(s.log_scales[3 * g + 1]),
              S2 = expf(s.log_scales[3 * g + 2]);
  float w = s.quats[4 * g], x = s.quats[4 * g + 1], y = s.quats[4 * g + 2],
        z = s.quats[4 * g + 3];
  // torch.linalg.norm's order on the card
  const float den = sqrtf((w * w + y * y) + (x * x + z * z)) + kTiny;
  w = w / den;
  x = x / den;
  y = y / den;
  z = z / den;
  const float R[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z),
       2.0f * (x * z + w * y)},
      {2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z),
       2.0f * (y * z - w * x)},
      {2.0f * (x * z - w * y), 2.0f * (y * z + w * x),
       1.0f - 2.0f * (x * x + y * y)}};
  const float op = sigmoid(s.logits[g]);
  // 2 ln(max(op, 1/255) / (1/255)), the division as the card makes it
  const float cut2 = 2.0f * logf(clamp_min(op, kAlphaMin) * kInvAlphaMin);
  const float s_cut = sqrtf(clamp_min(cut2, kCutFloor));
  const bool op_ok = op > kAlphaMin;

  constexpr int NF = (DEG + 1) * (DEG + 1) * 3;
  float sh[NF];
  const float* row = s.sh + g * s.sh_row;
  if (s.sh_vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int v = 0; v < (NF + 3) / 4; ++v) {
      const float4 q = __ldg(row4 + v);
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * v + i < NF) sh[4 * v + i] = e[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NF; ++i) sh[i] = __ldg(row + i);
  }

  if (blockIdx.y == 0) {
    o.opacities[g] = op;
    if (DEG == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        o.colors[3 * g + ch] = clamp_min(kC0 * sh[ch] + 0.5f, 0.0f);
    }
  }

  // -- each camera of the block --------------------------------------------
  for (int ci = 0; ci < nb; ++ci) {
    const Cam& C = cams[ci];
    const float d0 = mx - C.pos[0], d1 = my - C.pos[1], d2 = mz - C.pos[2];
    const float t0 = C.w[0] * d0 + C.w[1] * d1 + C.w[2] * d2;
    const float t1 = C.w[3] * d0 + C.w[4] * d1 + C.w[5] * d2;
    const float tz = C.w[6] * d0 + C.w[7] * d1 + C.w[8] * d2;
    const float tz_safe = fabsf(tz) < kZeroZ ? kZeroZ : tz;
    const float inv_z = 1.0f / tz_safe;
    const float u = C.fx * t0 * inv_z + C.cx;
    const float v = C.fy * t1 * inv_z + C.cy;

    const float txz = minimum(maximum(t0 * inv_z, -C.lim_x), C.lim_x) * tz_safe;
    const float tyz = minimum(maximum(t1 * inv_z, -C.lim_y), C.lim_y) * tz_safe;
    const float fx_z = C.fx * inv_z, fy_z = C.fy * inv_z;
    const float jx2 = -C.fx * txz * inv_z * inv_z;
    const float jy2 = -C.fy * tyz * inv_z * inv_z;
    float jw0[3], jw1[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      jw0[j] = fx_z * C.w[j] + jx2 * C.w[6 + j];
      jw1[j] = fy_z * C.w[3 + j] + jy2 * C.w[6 + j];
    }
    const float Sk[3] = {S0, S1, S2};
    float u0[3], u1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      u0[k] = Sk[k] * (jw0[0] * R[0][k] + jw0[1] * R[1][k] + jw0[2] * R[2][k]);
      u1[k] = Sk[k] * (jw1[0] * R[0][k] + jw1[1] * R[1][k] + jw1[2] * R[2][k]);
    }
    const float a = u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2] + kDilation;
    const float b = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
    const float c = u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2] + kDilation;
    const float det = a * c - b * b;
    const float inv_det = 1.0f / (det <= 0.0f ? 1.0f : det);

    const float mid = 0.5f * (a + c);
    const float eig_max = mid + sqrtf(clamp_min(mid * mid - det, kEigFloor));
    const float radii_f = ceilf(s_cut * sqrtf(eig_max)) + 1.0f;
    const float ext_x = ceilf(s_cut * sqrtf(clamp_min(a, 0.0f))) + 1.0f;
    const float ext_y = ceilf(s_cut * sqrtf(clamp_min(c, 0.0f))) + 1.0f;
    const bool inside = (u + ext_x > 0.0f) & (u - ext_x < cs.width)
                        & (v + ext_y > 0.0f) & (v - ext_y < cs.height);
    const bool vis = (tz > cs.near) & (tz < cs.far) & (det > 0.0f) & inside
                     & op_ok;

    const long long r = (long long)(b0 + ci) * s.n + g;
    reinterpret_cast<float2*>(o.means2d)[r] = make_float2(u, v);
    o.conics[3 * r] = c * inv_det;
    o.conics[3 * r + 1] = -b * inv_det;
    o.conics[3 * r + 2] = a * inv_det;
    o.depths[r] = tz;
    o.radii[r] = vis ? (int)radii_f : 0;
    o.visible[r] = vis;
    reinterpret_cast<float2*>(o.extents)[r] =
        vis ? make_float2(ext_x, ext_y) : make_float2(0.0f, 0.0f);

    if (DEG > 0) {
      const float dn = sqrtf(d0 * d0 + d1 * d1 + d2 * d2) + kTiny;
      const float dx = d0 / dn, dy = d1 / dn, dz = d2 / dn;
      const float c1y = kC1 * dy, c1z = kC1 * dz, c1x = kC1 * dx;
      const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
      const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
      float b2[5] = {0, 0, 0, 0, 0}, b3[7] = {0, 0, 0, 0, 0, 0, 0};
      if (DEG >= 2) {
        b2[0] = kC20 * xy;
        b2[1] = kC21 * yz;
        b2[2] = kC22 * (2.0f * zz - xx - yy);
        b2[3] = kC23 * xz;
        b2[4] = kC24 * (xx - yy);
      }
      if (DEG >= 3) {
        b3[0] = kC30 * dy * (3.0f * xx - yy);
        b3[1] = kC31 * xy * dz;
        b3[2] = kC32 * dy * (4.0f * zz - xx - yy);
        b3[3] = kC33 * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy);
        b3[4] = kC34 * dx * (4.0f * zz - xx - yy);
        b3[5] = kC35 * dz * (xx - yy);
        b3[6] = kC36 * dx * (xx - 3.0f * yy);
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float res = kC0 * sh[ch];
        res = res - c1y * sh[3 + ch] + c1z * sh[6 + ch] - c1x * sh[9 + ch];
        if (DEG >= 2) {
#pragma unroll
          for (int k = 0; k < 5; ++k) res = res + b2[k] * sh[3 * (4 + k) + ch];
        }
        if (DEG >= 3) {
#pragma unroll
          for (int k = 0; k < 7; ++k) res = res + b3[k] * sh[3 * (9 + k) + ch];
        }
        o.colors[3 * r + ch] = clamp_min(res + 0.5f, 0.0f);
      }
    }
  }
}

template <int DEG>
void launch(const Scene& s, const Cameras& cs, const Out& o, cudaStream_t st) {
  const dim3 grid((s.n + kThreads - 1) / kThreads, (cs.b + kCams - 1) / kCams);
  project_kernel<DEG><<<grid, kThreads, 0, st>>>(s, cs, o);
}

// -- K8: the backward --------------------------------------------------------
//
// The gradients of means, log-scales, quaternion, opacity logit and SH from
// those of K7's five float outputs (means2d, conics, depths, colours,
// opacities), summed over the B cameras: the plain chain's reverse-mode
// arithmetic as autograd defines it (twin:
// ops/projection.py::project_gaussians_backward_plain). The forward's
// intermediates are recomputed from the inputs in K7's order, so that each
// decision the gradient takes (the tz guard, the frustum clamp, det <= 0,
// the colour's clamp at 0) is the forward's; nothing is saved between the
// two. clamp passes where its input is >= the bound, maximum/minimum split
// a tie in half, ceil and the comparisons (radii, extents, visible, the
// opacity cut) give nothing.
//
// What bounds it on an H100: bytes. A Gaussian's 236 bytes at SH 3 are read
// and its 236 bytes of gradient written once, and 40 bytes of output
// gradient read a (camera, Gaussian) row: 0.153 ms for one camera at 1M
// Gaussians, 1.55 ms at 10.1M, at 3.35 TB/s. Design: one thread a Gaussian,
// 128 a block, its fields in registers once; a loop over all B cameras
// (kCams a time in shared memory) sums every gradient in registers, so each
// Gaussian's gradient is written once, with no atomics and in a fixed
// order; the output gradients are read through their strides (the views
// autograd hands over, no copies); the SH gradient is written as 16-byte
// stores where the rows allow, zeros above the degree.

struct Grad {           // the gradient of one output field; NULL for zero
  const float* p;
  long long sb, sn;     // camera and Gaussian strides, in floats
};

struct Grads {
  Grad means2d, conics, depths, colors, opacities;
};

struct SceneGrads {
  float* means;         // (N, 3)
  float* log_scales;    // (N, 3)
  float* quats;         // (N, 4)
  float* logits;        // (N,)
  float* sh;            // (N, K, 3)
};

// The share of the gradient of minimum(maximum(x, -lim), lim) that reaches
// x: autograd's rule for torch.maximum / torch.minimum, a tie split in half.
__device__ __forceinline__ float pass_max_min(float x, float lim) {
  const float m = maximum(x, -lim);
  const float lo = x == -lim ? 0.5f : (x < -lim ? 0.0f : 1.0f);
  const float hi = m == lim ? 0.5f : (m > lim ? 0.0f : 1.0f);
  return lo * hi;
}

// One SH coefficient's part of the colour gradient: coefficient k's basis
// value f and its derivative (fx, fy, fz) along the unit view direction.
template <int K>
__device__ __forceinline__ void sh_term(float f, float fx, float fy, float fz,
                                        const float* gr, const float* sh,
                                        float* g_sh, float* g_dir) {
  float gf = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    g_sh[3 * K + ch] += f * gr[ch];
    gf += gr[ch] * sh[3 * K + ch];
  }
  g_dir[0] += gf * fx;
  g_dir[1] += gf * fy;
  g_dir[2] += gf * fz;
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(Scene s, Cameras cs, Grads gi, SceneGrads go) {
  __shared__ Cam cams[kCams];
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  // a thread past the end works on the last row and writes nothing, so
  // that every thread reaches the block's barriers
  const long long gl = g < s.n ? g : s.n - 1;

  // -- the Gaussian, once (K7's arithmetic) --------------------------------
  const float mx = s.means[3 * gl], my = s.means[3 * gl + 1],
              mz = s.means[3 * gl + 2];
  const float Sk[3] = {expf(s.log_scales[3 * gl]),
                       expf(s.log_scales[3 * gl + 1]),
                       expf(s.log_scales[3 * gl + 2])};
  const float qw = s.quats[4 * gl], qx = s.quats[4 * gl + 1],
              qy = s.quats[4 * gl + 2], qz = s.quats[4 * gl + 3];
  const float nq = sqrtf((qw * qw + qy * qy) + (qx * qx + qz * qz));
  const float den = nq + kTiny;
  const float w = qw / den, x = qx / den, y = qy / den, z = qz / den;
  const float R[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z),
       2.0f * (x * z + w * y)},
      {2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z),
       2.0f * (y * z - w * x)},
      {2.0f * (x * z - w * y), 2.0f * (y * z + w * x),
       1.0f - 2.0f * (x * x + y * y)}};

  constexpr int NF = (DEG + 1) * (DEG + 1) * 3;
  float sh[NF];
  const float* row = s.sh + gl * s.sh_row;
  if (s.sh_vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int v = 0; v < (NF + 3) / 4; ++v) {
      const float4 q = __ldg(row4 + v);
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * v + i < NF) sh[4 * v + i] = e[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NF; ++i) sh[i] = __ldg(row + i);
  }

  // the parameters' gradients, summed over the cameras in registers
  float g_m[3] = {0.0f, 0.0f, 0.0f}, g_S[3] = {0.0f, 0.0f, 0.0f};
  float g_R[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f},
                     {0.0f, 0.0f, 0.0f}};
  float g_op = 0.0f;
  float g_sh[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) g_sh[i] = 0.0f;

  for (int b0 = 0; b0 < cs.b; b0 += kCams) {
    const int nb = min(kCams, cs.b - b0);
    __syncthreads();   // the last chunk's cameras are read
    if ((int)threadIdx.x < nb)
      load_cam(cs, b0 + threadIdx.x, cams[threadIdx.x]);
    __syncthreads();
    for (int ci = 0; ci < nb; ++ci) {
      const Cam& C = cams[ci];
      const long long b = b0 + ci;

      // -- the forward's intermediates, as K7 computes them ----------------
      const float d0 = mx - C.pos[0], d1 = my - C.pos[1], d2 = mz - C.pos[2];
      const float t0 = C.w[0] * d0 + C.w[1] * d1 + C.w[2] * d2;
      const float t1 = C.w[3] * d0 + C.w[4] * d1 + C.w[5] * d2;
      const float tz = C.w[6] * d0 + C.w[7] * d1 + C.w[8] * d2;
      const bool guarded = fabsf(tz) < kZeroZ;
      const float tz_safe = guarded ? kZeroZ : tz;
      const float inv_z = 1.0f / tz_safe;
      const float rx = t0 * inv_z, ry = t1 * inv_z;
      const float clx = minimum(maximum(rx, -C.lim_x), C.lim_x);
      const float cly = minimum(maximum(ry, -C.lim_y), C.lim_y);
      const float txz = clx * tz_safe, tyz = cly * tz_safe;
      const float fx_z = C.fx * inv_z, fy_z = C.fy * inv_z;
      const float jx2 = -C.fx * txz * inv_z * inv_z;
      const float jy2 = -C.fy * tyz * inv_z * inv_z;
      float jw0[3], jw1[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        jw0[j] = fx_z * C.w[j] + jx2 * C.w[6 + j];
        jw1[j] = fy_z * C.w[3 + j] + jy2 * C.w[6 + j];
      }
      float p0[3], p1[3], u0[3], u1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p0[k] = jw0[0] * R[0][k] + jw0[1] * R[1][k] + jw0[2] * R[2][k];
        p1[k] = jw1[0] * R[0][k] + jw1[1] * R[1][k] + jw1[2] * R[2][k];
        u0[k] = Sk[k] * p0[k];
        u1[k] = Sk[k] * p1[k];
      }
      const float a = u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2] + kDilation;
      const float bb = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
      const float c = u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2] + kDilation;
      const float det = a * c - bb * bb;
      const float inv_det = 1.0f / (det <= 0.0f ? 1.0f : det);

      // -- the output gradients of this camera's row ------------------------
      float gu = 0.0f, gv = 0.0f, gca = 0.0f, gcb = 0.0f, gcc = 0.0f;
      float gz = 0.0f, gc[3] = {0.0f, 0.0f, 0.0f};
      if (gi.means2d.p) {
        const float* q = gi.means2d.p + b * gi.means2d.sb + gl * gi.means2d.sn;
        gu = q[0];
        gv = q[1];
      }
      if (gi.conics.p) {
        const float* q = gi.conics.p + b * gi.conics.sb + gl * gi.conics.sn;
        gca = q[0];
        gcb = q[1];
        gcc = q[2];
      }
      if (gi.depths.p) gz = gi.depths.p[b * gi.depths.sb + gl * gi.depths.sn];
      if (gi.colors.p) {
        const float* q = gi.colors.p + b * gi.colors.sb + gl * gi.colors.sn;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) gc[ch] = q[ch];
      }
      if (gi.opacities.p)
        g_op += gi.opacities.p[b * gi.opacities.sb + gl * gi.opacities.sn];

      // -- conics -> the 2D covariance -> the EWA factors -------------------
      float g_a = gcc * inv_det, g_b = -gcb * inv_det, g_c = gca * inv_det;
      const float g_inv = gca * c - gcb * bb + gcc * a;
      // det_safe = where(det <= 0, 1, det): the gradient reaches det only
      // where the branch took it
      const float g_det = det <= 0.0f ? 0.0f : -g_inv * inv_det * inv_det;
      g_a += g_det * c;
      g_c += g_det * a;
      g_b -= 2.0f * bb * g_det;
      float g_p0[3], g_p1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float gu0 = 2.0f * u0[k] * g_a + u1[k] * g_b;
        const float gu1 = 2.0f * u1[k] * g_c + u0[k] * g_b;
        g_S[k] += gu0 * p0[k] + gu1 * p1[k];
        g_p0[k] = gu0 * Sk[k];
        g_p1[k] = gu1 * Sk[k];
      }
      float g_jw0[3], g_jw1[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          g_R[i][k] += g_p0[k] * jw0[i] + g_p1[k] * jw1[i];
        g_jw0[i] = g_p0[0] * R[i][0] + g_p0[1] * R[i][1] + g_p0[2] * R[i][2];
        g_jw1[i] = g_p1[0] * R[i][0] + g_p1[1] * R[i][1] + g_p1[2] * R[i][2];
      }

      // -- the Jacobian and the mean -> camera space ------------------------
      const float g_fx_z =
          g_jw0[0] * C.w[0] + g_jw0[1] * C.w[1] + g_jw0[2] * C.w[2];
      const float g_jx2 =
          g_jw0[0] * C.w[6] + g_jw0[1] * C.w[7] + g_jw0[2] * C.w[8];
      const float g_fy_z =
          g_jw1[0] * C.w[3] + g_jw1[1] * C.w[4] + g_jw1[2] * C.w[5];
      const float g_jy2 =
          g_jw1[0] * C.w[6] + g_jw1[1] * C.w[7] + g_jw1[2] * C.w[8];
      const float iz2 = inv_z * inv_z;
      const float g_txz = -C.fx * g_jx2 * iz2, g_tyz = -C.fy * g_jy2 * iz2;
      const float g_rx = g_txz * tz_safe * pass_max_min(rx, C.lim_x);
      const float g_ry = g_tyz * tz_safe * pass_max_min(ry, C.lim_y);
      const float g_iz =
          g_fx_z * C.fx + g_fy_z * C.fy
          - 2.0f * inv_z * (g_jx2 * C.fx * txz + g_jy2 * C.fy * tyz)
          + gu * C.fx * t0 + gv * C.fy * t1 + g_rx * t0 + g_ry * t1;
      const float g_t0 = (gu * C.fx + g_rx) * inv_z;
      const float g_t1 = (gv * C.fy + g_ry) * inv_z;
      const float g_tzs = g_txz * clx + g_tyz * cly - g_iz * iz2;
      const float g_tz = gz + (guarded ? 0.0f : g_tzs);
      float g_d[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        g_d[j] = C.w[j] * g_t0 + C.w[3 + j] * g_t1 + C.w[6 + j] * g_tz;

      // -- SH colour -> coefficients and view direction ---------------------
      if constexpr (DEG == 0) {
        // one colour for all cameras: clamp(C0 sh + 0.5, min=0) passes
        // where its input is >= 0
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          g_sh[ch] += kC0 * (kC0 * sh[ch] + 0.5f >= 0.0f ? gc[ch] : 0.0f);
      } else {
        const float nrm = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        const float dn = nrm + kTiny;
        const float dx = d0 / dn, dy = d1 / dn, dz = d2 / dn;
        const float c1y = kC1 * dy, c1z = kC1 * dz, c1x = kC1 * dx;
        const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
        const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
        float b2[5] = {0, 0, 0, 0, 0}, b3[7] = {0, 0, 0, 0, 0, 0, 0};
        if constexpr (DEG >= 2) {
          b2[0] = kC20 * xy;
          b2[1] = kC21 * yz;
          b2[2] = kC22 * (2.0f * zz - xx - yy);
          b2[3] = kC23 * xz;
          b2[4] = kC24 * (xx - yy);
        }
        if constexpr (DEG >= 3) {
          b3[0] = kC30 * dy * (3.0f * xx - yy);
          b3[1] = kC31 * xy * dz;
          b3[2] = kC32 * dy * (4.0f * zz - xx - yy);
          b3[3] = kC33 * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy);
          b3[4] = kC34 * dx * (4.0f * zz - xx - yy);
          b3[5] = kC35 * dz * (xx - yy);
          b3[6] = kC36 * dx * (xx - 3.0f * yy);
        }
        // the colour as K7 sums it, for the clamp's decision
        float gr[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float res = kC0 * sh[ch];
          res = res - c1y * sh[3 + ch] + c1z * sh[6 + ch] - c1x * sh[9 + ch];
          if constexpr (DEG >= 2) {
#pragma unroll
            for (int k = 0; k < 5; ++k)
              res = res + b2[k] * sh[3 * (4 + k) + ch];
          }
          if constexpr (DEG >= 3) {
#pragma unroll
            for (int k = 0; k < 7; ++k)
              res = res + b3[k] * sh[3 * (9 + k) + ch];
          }
          gr[ch] = res + 0.5f >= 0.0f ? gc[ch] : 0.0f;
        }
        float g_dir[3] = {0.0f, 0.0f, 0.0f};
        sh_term<0>(kC0, 0.0f, 0.0f, 0.0f, gr, sh, g_sh, g_dir);
        sh_term<1>(-c1y, 0.0f, -kC1, 0.0f, gr, sh, g_sh, g_dir);
        sh_term<2>(c1z, 0.0f, 0.0f, kC1, gr, sh, g_sh, g_dir);
        sh_term<3>(-c1x, -kC1, 0.0f, 0.0f, gr, sh, g_sh, g_dir);
        if constexpr (DEG >= 2) {
          sh_term<4>(b2[0], kC20 * dy, kC20 * dx, 0.0f, gr, sh, g_sh, g_dir);
          sh_term<5>(b2[1], 0.0f, kC21 * dz, kC21 * dy, gr, sh, g_sh, g_dir);
          sh_term<6>(b2[2], -2.0f * kC22 * dx, -2.0f * kC22 * dy,
                     4.0f * kC22 * dz, gr, sh, g_sh, g_dir);
          sh_term<7>(b2[3], kC23 * dz, 0.0f, kC23 * dx, gr, sh, g_sh, g_dir);
          sh_term<8>(b2[4], 2.0f * kC24 * dx, -2.0f * kC24 * dy, 0.0f, gr, sh,
                     g_sh, g_dir);
        }
        if constexpr (DEG >= 3) {
          sh_term<9>(b3[0], 6.0f * kC30 * xy, 3.0f * kC30 * (xx - yy), 0.0f,
                     gr, sh, g_sh, g_dir);
          sh_term<10>(b3[1], kC31 * yz, kC31 * xz, kC31 * xy, gr, sh, g_sh,
                      g_dir);
          sh_term<11>(b3[2], -2.0f * kC32 * xy,
                      kC32 * (4.0f * zz - xx - 3.0f * yy), 8.0f * kC32 * yz,
                      gr, sh, g_sh, g_dir);
          sh_term<12>(b3[3], -6.0f * kC33 * xz, -6.0f * kC33 * yz,
                      kC33 * (6.0f * zz - 3.0f * xx - 3.0f * yy), gr, sh,
                      g_sh, g_dir);
          sh_term<13>(b3[4], kC34 * (4.0f * zz - 3.0f * xx - yy),
                      -2.0f * kC34 * xy, 8.0f * kC34 * xz, gr, sh, g_sh,
                      g_dir);
          sh_term<14>(b3[5], 2.0f * kC35 * xz, -2.0f * kC35 * yz,
                      kC35 * (xx - yy), gr, sh, g_sh, g_dir);
          sh_term<15>(b3[6], 3.0f * kC36 * (xx - yy), -6.0f * kC36 * xy, 0.0f,
                      gr, sh, g_sh, g_dir);
        }
        // dirs = d / (|d| + 1e-12): the direction's gradient back to d
        const float g_nrm = -(g_dir[0] * d0 + g_dir[1] * d1 + g_dir[2] * d2)
                            / (dn * dn);
        g_d[0] += g_dir[0] / dn + g_nrm * d0 / nrm;
        g_d[1] += g_dir[1] / dn + g_nrm * d1 / nrm;
        g_d[2] += g_dir[2] / dn + g_nrm * d2 / nrm;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) g_m[j] += g_d[j];
    }
  }
  if (g >= s.n) return;

  // -- the per-Gaussian parameters, written once ----------------------------
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    go.means[3 * g + j] = g_m[j];
    go.log_scales[3 * g + j] = g_S[j] * Sk[j];   // exp: grad * result
  }
  // R of the normalised quaternion -> the normalised quaternion
  const float gw = 2.0f * (-z * g_R[0][1] + y * g_R[0][2] + z * g_R[1][0]
                           - x * g_R[1][2] - y * g_R[2][0] + x * g_R[2][1]);
  const float gx = 2.0f * (y * g_R[0][1] + z * g_R[0][2] + y * g_R[1][0]
                           - 2.0f * x * g_R[1][1] - w * g_R[1][2]
                           + z * g_R[2][0] + w * g_R[2][1]
                           - 2.0f * x * g_R[2][2]);
  const float gy = 2.0f * (-2.0f * y * g_R[0][0] + x * g_R[0][1]
                           + w * g_R[0][2] + x * g_R[1][0] + z * g_R[1][2]
                           - w * g_R[2][0] + z * g_R[2][1]
                           - 2.0f * y * g_R[2][2]);
  const float gz = 2.0f * (-2.0f * z * g_R[0][0] - w * g_R[0][1]
                           + x * g_R[0][2] + w * g_R[1][0]
                           - 2.0f * z * g_R[1][1] + y * g_R[1][2]
                           + x * g_R[2][0] + y * g_R[2][1]);
  // q / (|q| + 1e-12): the norm's gradient is masked to 0 where |q| = 0,
  // as torch.linalg.norm's backward masks it
  const float dot = gw * qw + gx * qx + gy * qy + gz * qz;
  const float k = nq == 0.0f ? 0.0f : dot / (den * den * nq);
  // (N, 4) rows of a new tensor: 16-byte aligned
  reinterpret_cast<float4*>(go.quats)[g] =
      make_float4(gw / den - k * qw, gx / den - k * qx, gy / den - k * qy,
                  gz / den - k * qz);
  // sigmoid: grad * (1 - y) * y
  const float op = sigmoid(s.logits[g]);
  go.logits[g] = g_op * (1.0f - op) * op;

  // the SH rows: the degree's coefficients, zeros above it
  float* out = go.sh + g * s.sh_row;
  if (s.sh_vec) {
    float4* out4 = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int v = 0; v < (NF + 3) / 4; ++v) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = 4 * v + i < NF ? g_sh[4 * v + i] : 0.0f;
      out4[v] = make_float4(e[0], e[1], e[2], e[3]);
    }
    for (int v = (NF + 3) / 4; v < s.sh_row / 4; ++v)
      out4[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < NF; ++i) out[i] = g_sh[i];
    for (int i = NF; i < s.sh_row; ++i) out[i] = 0.0f;
  }
}

template <int DEG>
void launch_bwd(const Scene& s, const Cameras& cs, const Grads& gi,
                const SceneGrads& go, cudaStream_t st) {
  const unsigned blocks = (unsigned)((s.n + kThreads - 1) / kThreads);
  project_bwd_kernel<DEG><<<blocks, kThreads, 0, st>>>(s, cs, gi, go);
}

}  // namespace

// K7 over n Gaussians and b cameras at SH degree 0-3 (the wrapper checks
// shapes, types and contiguity). Returns the cudaError_t of the launch.
extern "C" int sage3d_project(
    const void* means, const void* log_scales, const void* quats,
    const void* logits, const void* sh, int n, int sh_row, int sh_vec,
    int degree, const void* position, const void* cam_to_world,
    const void* fx, const void* fy, const void* cx, const void* cy, int b,
    float half_w, float half_h, float width, float height, float near_,
    float far_, void* means2d, void* conics, void* depths, void* radii,
    void* colors, void* opacities, void* visible, void* extents,
    void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaSuccess;
  if (degree < 0 || degree > 3 || (b + kCams - 1) / kCams > 65535)
    return (int)cudaErrorInvalidValue;
  const Scene s{(const float*)means, (const float*)log_scales,
                (const float*)quats, (const float*)logits, (const float*)sh,
                n, sh_row, sh_vec};
  const Cameras cs{(const float*)position, (const float*)cam_to_world,
                   (const float*)fx, (const float*)fy, (const float*)cx,
                   (const float*)cy, b, half_w, half_h, width, height, near_,
                   far_};
  const Out o{(float*)means2d, (float*)conics, (float*)depths, (int*)radii,
              (float*)colors, (float*)opacities, (unsigned char*)visible,
              (float*)extents};
  cudaStream_t st = (cudaStream_t)stream;
  switch (degree) {
    case 0: launch<0>(s, cs, o, st); break;
    case 1: launch<1>(s, cs, o, st); break;
    case 2: launch<2>(s, cs, o, st); break;
    default: launch<3>(s, cs, o, st); break;
  }
  return (int)cudaGetLastError();
}

// K8 over n Gaussians and b cameras at SH degree 0-3: the scene's and the
// cameras' arguments as K7 takes them, then each output gradient's pointer
// (NULL for zero) and strides, then the five parameter gradients (the
// wrapper checks shapes, types and contiguity). Returns the cudaError_t of
// the launch.
extern "C" int sage3d_project_bwd(
    const void* means, const void* log_scales, const void* quats,
    const void* logits, const void* sh, int n, int sh_row, int sh_vec,
    int degree, const void* position, const void* cam_to_world,
    const void* fx, const void* fy, const void* cx, const void* cy, int b,
    float half_w, float half_h, float width, float height, float near_,
    float far_, const void* g_means2d, long long sb_means2d,
    long long sn_means2d, const void* g_conics, long long sb_conics,
    long long sn_conics, const void* g_depths, long long sb_depths,
    long long sn_depths, const void* g_colors, long long sb_colors,
    long long sn_colors, const void* g_opacities, long long sb_opacities,
    long long sn_opacities, void* d_means, void* d_log_scales, void* d_quats,
    void* d_logits, void* d_sh, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaSuccess;
  if (degree < 0 || degree > 3) return (int)cudaErrorInvalidValue;
  const Scene s{(const float*)means, (const float*)log_scales,
                (const float*)quats, (const float*)logits, (const float*)sh,
                n, sh_row, sh_vec};
  const Cameras cs{(const float*)position, (const float*)cam_to_world,
                   (const float*)fx, (const float*)fy, (const float*)cx,
                   (const float*)cy, b, half_w, half_h, width, height, near_,
                   far_};
  const Grads gi{{(const float*)g_means2d, sb_means2d, sn_means2d},
                 {(const float*)g_conics, sb_conics, sn_conics},
                 {(const float*)g_depths, sb_depths, sn_depths},
                 {(const float*)g_colors, sb_colors, sn_colors},
                 {(const float*)g_opacities, sb_opacities, sn_opacities}};
  const SceneGrads go{(float*)d_means, (float*)d_log_scales, (float*)d_quats,
                      (float*)d_logits, (float*)d_sh};
  cudaStream_t st = (cudaStream_t)stream;
  switch (degree) {
    case 0: launch_bwd<0>(s, cs, gi, go, st); break;
    case 1: launch_bwd<1>(s, cs, gi, go, st); break;
    case 2: launch_bwd<2>(s, cs, gi, go, st); break;
    default: launch_bwd<3>(s, cs, gi, go, st); break;
  }
  return (int)cudaGetLastError();
}
