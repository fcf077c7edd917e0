// K1: tile-key emission for the binning stage, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sage3d_tpu/ops/binning.py::_emit_kernel (launched by
// _get_emit_call through _emit_fused). For every (candidate slot k, Gaussian g)
// it walks the Gaussian's tight AABB tile rect in row-major order, applies the
// exact ellipse-tile cull (the minimum of the conic quadratic over the tile's
// pixel rect must be <= cut2 * 1.001 + 1e-3, and is 0 when the mean lies in
// the tile) and writes one int32: tid * mult + rank (INVALID_KEY when culled),
// or with mult == 0 the raw tile id (n_tiles when culled) for the two-key sort.
//
// What bounds it on an H100: bytes. Each live (k, g) does ~90 f32 operations
// and every slot writes 4 bytes; the 16-row attribute table is read once per
// Gaussian. A 1M-Gaussian scene gives ~100M slots at 1080p and 2.3G at 4K,
// most of them past the Gaussian's tile count, so the store stream sets the
// time. Design: one thread per (k, g). blockIdx.x is the slot k, so the blocks
// that run together share one 256-Gaussian column of the attribute table and
// read it from L2 instead of device memory; every store of a warp is 128
// contiguous bytes of row k, at a 64-bit offset (a tier may exceed 2^31
// slots). The TPU kernel's k-tiling (EMIT_KB) was a VMEM workaround and is
// gone.
//
// Arithmetic: the same f32 operations, in the same order, as the JAX kernel
// and the plain PyTorch version (ops/binning.py::emit_tile_keys_plain). The
// file is built with -fmad=false, so no multiply-add is contracted into an
// FMA and a tile at the cull margin is decided the same way; 1/x is IEEE
// division (no fast math). The keys equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr float kTileW = 32.0f;
constexpr float kTileH = 32.0f;
constexpr int32_t kInvalidKey = 0x7fffffff;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void emit_kernel(const float* __restrict__ attrs,
                            const int32_t* __restrict__ rank,
                            int32_t* __restrict__ out, int n_pad, int tiles_x,
                            int n_tiles, int mult) {
  const int k = blockIdx.x;
  const float kf = (float)k;
  const int n_gblocks = (n_pad + kBlock - 1) / kBlock;
  for (int gb = blockIdx.y; gb < n_gblocks; gb += gridDim.y) {
    const int g = gb * kBlock + threadIdx.x;
    if (g >= n_pad) continue;
    int32_t* dst = out + (size_t)k * n_pad + g;
    const float count = attrs[3 * (size_t)n_pad + g];
    if (!(kf < count)) {
      *dst = mult ? kInvalidKey : n_tiles;
      continue;
    }
    const float x0 = attrs[g];
    const float y0 = attrs[(size_t)n_pad + g];
    const float nx = attrs[2 * (size_t)n_pad + g];
    const float mx = attrs[4 * (size_t)n_pad + g];
    const float my = attrs[5 * (size_t)n_pad + g];
    const float cut2 = attrs[6 * (size_t)n_pad + g];
    const float ca = attrs[8 * (size_t)n_pad + g];
    const float cb = attrs[9 * (size_t)n_pad + g];
    const float cc = attrs[10 * (size_t)n_pad + g];

    // k // nx and k % nx through the f32 reciprocal plus a +-1 fixup.
    const float nxs = fmaxf(nx, 1.0f);
    const float inv = 1.0f / nxs;
    float q = floorf(kf * inv);
    float r = kf - q * nxs;
    q = (r < 0.0f) ? q - 1.0f : ((r >= nxs) ? q + 1.0f : q);
    r = kf - q * nxs;
    const float tx = x0 + r;
    const float ty = y0 + q;
    const float fx0 = tx * kTileW;
    const float fy0 = ty * kTileH;
    // Tile pixel rect relative to the mean.
    const float x_lo = fx0 - mx;
    const float x_hi = x_lo + kTileW;
    const float y_lo = fy0 - my;
    const float y_hi = y_lo + kTileH;
    const bool inside = (x_lo <= 0.0f) && (x_hi >= 0.0f) && (y_lo <= 0.0f) &&
                        (y_hi >= 0.0f);
    const float inv_a = 1.0f / fmaxf(ca, 1e-20f);
    const float inv_c = 1.0f / fmaxf(cc, 1e-20f);

    // min over y' in [y_lo, y_hi] at fixed x' = xe, and the transposed edge
    auto vedge = [&](float xe) {
      const float t = clipf(-cb * xe * inv_c, y_lo, y_hi);
      return (ca * xe) * xe + (2.0f * cb * xe + cc * t) * t;
    };
    auto hedge = [&](float ye) {
      const float t = clipf(-cb * ye * inv_a, x_lo, x_hi);
      return (cc * ye) * ye + (2.0f * cb * ye + ca * t) * t;
    };
    float m2 = fminf(fminf(vedge(x_lo), vedge(x_hi)),
                     fminf(hedge(y_lo), hedge(y_hi)));
    if (inside) m2 = 0.0f;
    const bool valid = m2 <= cut2 * 1.001f + 1e-3f;
    const int32_t tid = (int32_t)(ty * (float)tiles_x + tx);
    if (mult) {
      *dst = valid ? tid * mult + rank[g] : kInvalidKey;
    } else {
      *dst = valid ? tid : n_tiles;
    }
  }
}

}  // namespace

extern "C" int sage3d_emit_tile_keys(const void* attrs, const void* rank,
                                     void* out, int n_pad, int k_budget,
                                     int tiles_x, int n_tiles, int mult,
                                     void* stream) {
  if (n_pad > 0 && k_budget > 0) {
    const int n_gblocks = (n_pad + kBlock - 1) / kBlock;
    dim3 grid(k_budget, n_gblocks < 65535 ? n_gblocks : 65535);
    emit_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)attrs, (const int32_t*)rank, (int32_t*)out, n_pad,
        tiles_x, n_tiles, mult);
  }
  return (int)cudaGetLastError();
}
