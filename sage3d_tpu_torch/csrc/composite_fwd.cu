// K2: forward tile compositor, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sage3d_tpu/ops/composite_pallas.py::_fwd_kernel
// (pallas_call in fwd_call) together with the feature gather in front of it
// (_gather_feats). For each 32x32 tile it walks the tile's depth-ordered pairs
// in 128-pair chunks: alpha = min(op * exp(power), 0.99), zeroed where
// power > 0 or alpha < 1/255; weight w = alpha * T; it accumulates rgb, depth
// and alpha, keeps the final T and the best weight with its semantic id (the
// first maximum in depth order), and stops once every pixel of the tile has
// T <= 1e-4, checked after each chunk. k_end is the number of chunks done.
//
// What bounds it on an H100: operations. Each pair-pixel evaluation is ~25
// f32 operations and one expf, and a tile re-reads each of its pairs' 64-byte
// attribute rows only once per chunk, so arithmetic outweighs bytes by two
// orders of magnitude. Design: one block of 1024 threads per tile, one thread
// per pixel, state in registers. Per chunk, 128 threads gather the chunk's
// attribute rows (attrs[pair_gauss[i]], 16 floats each) and turn them into
// tile-local quadratic coefficients in shared memory once, so the per-pixel
// loop reads broadcast shared memory and does only the per-pixel terms. After
// each chunk __syncthreads_or decides for the whole block whether to go on.
// There is no per-pixel cutoff: a pixel keeps accumulating until the whole
// tile is saturated, as on the TPU, so k_end and the images match it.
//
// Arithmetic: alpha uses the TPU kernel's tile-local expanded form
// (_alpha_rows: w0, wx, wy from the global mean minus the tile origin, pixel
// centers at +0.5) in its operation order, built with -fmad=false and IEEE
// expf, so the power > 0 and alpha < 1/255 decisions follow the JAX kernel.
// The TPU layout workarounds (feature-major blocks, rolled two-block windows,
// guard blocks, the (1,8,128) k_end block) are gone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kNpix = kTile * kTile;  // threads per block, one per pixel
constexpr int kChunk = 128;           // pairs per chunk
constexpr int kNfeat = 16;            // floats per attribute row
constexpr int kNch = 8;               // r,g,b,depth,alpha,trans,best_w,best_id
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTransEps = 1e-4f;

struct Coef {
  float w0, wx, wy, ha, hc, b, op, r, g, bl, depth, sem;
};

__global__ void __launch_bounds__(kNpix)
composite_fwd_kernel(const float* __restrict__ attrs,
                     const int32_t* __restrict__ pair_gauss,
                     const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ tile_count,
                     float* __restrict__ out, int32_t* __restrict__ kend,
                     int tiles_x, int n_gauss, int n_pairs) {
  __shared__ Coef coef[kChunk];
  const int t = blockIdx.x;
  const int pix = threadIdx.x;
  const float px = (float)(pix % kTile) + 0.5f;
  const float py = (float)(pix / kTile) + 0.5f;
  const float pxx = px * px, pyy = py * py, pxy = px * py;
  const float ox = (float)((t % tiles_x) * kTile);
  const float oy = (float)((t / tiles_x) * kTile);
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int n_chunks = (count + kChunk - 1) / kChunk;

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f, acc_a = 0.0f;
  float best_w = 0.0f, best_id = -1.0f;
  int k = 0;
  while (k < n_chunks) {
    const int n_valid = min(count - k * kChunk, kChunk);
    if (pix < n_valid) {
      const int p = start + k * kChunk + pix;
      if (p < 0 || p >= n_pairs) __trap();
      const int gid = pair_gauss[p];
      if (gid < 0 || gid >= n_gauss) __trap();
      const float* row = attrs + (size_t)gid * kNfeat;
      const float a = row[0], b = row[1], c = row[2];
      const float cx = row[3] - ox;
      const float cy = row[4] - oy;
      Coef e;
      e.w0 = -0.5f * (a * cx * cx + c * cy * cy) - b * cx * cy;
      e.wx = a * cx + b * cy;
      e.wy = c * cy + b * cx;
      e.ha = 0.5f * a;
      e.hc = 0.5f * c;
      e.b = b;
      e.op = row[5];
      e.r = row[6];
      e.g = row[7];
      e.bl = row[8];
      e.depth = row[9];
      e.sem = row[10];
      coef[pix] = e;
    }
    __syncthreads();
    for (int i = 0; i < n_valid; ++i) {
      const Coef& e = coef[i];
      const float power = e.w0 + e.wx * px + e.wy * py - e.ha * pxx -
                          e.hc * pyy - e.b * pxy;
      const float raw = (power > 0.0f) ? 0.0f : e.op * expf(fminf(power, 0.0f));
      float alpha = fminf(raw, kAlphaMax);
      if (alpha < kAlphaMin) alpha = 0.0f;
      const float w = alpha * T;
      acc_r += w * e.r;
      acc_g += w * e.g;
      acc_b += w * e.bl;
      acc_d += w * e.depth;
      acc_a += w;
      if (w > best_w) {
        best_w = w;
        best_id = e.sem;
      }
      T *= 1.0f - alpha;
    }
    ++k;
    // Also the barrier before the next chunk overwrites `coef`.
    if (!__syncthreads_or(T > kTransEps)) break;
  }

  float* o = out + (size_t)t * kNch * kNpix + pix;
  o[0 * kNpix] = acc_r;
  o[1 * kNpix] = acc_g;
  o[2 * kNpix] = acc_b;
  o[3 * kNpix] = acc_d;
  o[4 * kNpix] = acc_a;
  o[5 * kNpix] = T;
  o[6 * kNpix] = best_w;
  o[7 * kNpix] = best_id;
  if (pix == 0) kend[t] = k;
}

}  // namespace

extern "C" int sage3d_composite_fwd(const void* attrs, const void* pair_gauss,
                                    const void* tile_start,
                                    const void* tile_count, void* out,
                                    void* kend, int n_tiles, int tiles_x,
                                    int n_gauss, int n_pairs, void* stream) {
  if (n_tiles > 0) {
    composite_fwd_kernel<<<n_tiles, kNpix, 0, (cudaStream_t)stream>>>(
        (const float*)attrs, (const int32_t*)pair_gauss,
        (const int32_t*)tile_start, (const int32_t*)tile_count, (float*)out,
        (int32_t*)kend, tiles_x, n_gauss, n_pairs);
  }
  return (int)cudaGetLastError();
}
