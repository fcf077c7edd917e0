// K2 anatomy probe: the forward tile compositor K2 (composite_fwd.cu) with
// switches that stub out its cost blocks, hand-written for Hopper (sm_90a).
//
// Replaces the TPU timing probe benchmarks/kernel_anatomy.py::_variant_kernel
// (pallas_call in make_variant). It is a timing probe: a variant with a block
// stubbed out computes something else on purpose, and what the compiler
// removes with that block is what the probe measures. The switches:
//
//   ET      on: stop a tile after the chunk where every pixel has T <= 1e-4,
//           as K2 does; off: walk all ceil(count / 128) chunks.
//   EXP     on: K2's alpha; off: alpha = min(|op * (a*px + c*py + b)| * 1e-3,
//           0.5), with a, b, c the raw conic and px, py tile-local pixel
//           centres (no exp, no power > 0 test, no 1/255 cutoff).
//   SCAN    on: w = alpha * T, T *= 1 - alpha per pair (K2's order); off:
//           w = alpha * T_chunk_start for every pair, and after the chunk
//           T *= 1 - (the chunk's largest alpha).
//   BLEND   on: acc += w * (r, g, b, depth) and w; off: all five acc channels
//           += 1e-9 * w of the chunk's first pair.
//   ARGMAX  on: best_w / best_id track the first largest w, replaced only by
//           a strictly larger one; off: best_w stays 0 and best_id -1.
//
// All five on with ET on is K2 line for line, built with the same flags
// (-fmad=false, IEEE expf), so its images are bitwise K2's.
//
// Inputs are K2's: the (N, 16) attribute table, pair_gauss, tile_start and
// tile_count, gathered in the kernel. The TPU probe reads a pre-packed pair
// feature array instead; this probe takes K2's inputs because what it takes
// apart is the port's K2, whose gather is part of its cost. With batch b the
// launch has b * T blocks over b materialised copies of the inputs (the
// counterpart of jax.vmap over broadcast copies), block (i, t) reading copy i.
//
// What bounds it on an H100: operations, as K2 (pair-pixel evaluations of
// the quadratic, the exp and the blend; bytes are two orders of magnitude
// below). Design: K2's, one 1024-thread block per tile, one thread per pixel,
// the chunk's coefficients in shared memory.

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
  float w0, wx, wy, ha, hc, b, op, r, g, bl, depth, sem, a, c;
};

template <bool ET, bool EXP, bool SCAN, bool BLEND, bool ARGMAX>
__global__ void __launch_bounds__(kNpix)
composite_anatomy_kernel(const float* __restrict__ attrs,
                         const int32_t* __restrict__ pair_gauss,
                         const int32_t* __restrict__ tile_start,
                         const int32_t* __restrict__ tile_count,
                         float* __restrict__ out, int n_tiles, int tiles_x,
                         int n_gauss, int n_pairs) {
  __shared__ Coef coef[kChunk];
  const int copy = blockIdx.x / n_tiles;
  const int t = blockIdx.x - copy * n_tiles;
  attrs += (size_t)copy * n_gauss * kNfeat;
  pair_gauss += (size_t)copy * n_pairs;
  tile_start += (size_t)copy * n_tiles;
  tile_count += (size_t)copy * n_tiles;
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
      e.a = a;
      e.c = c;
      coef[pix] = e;
    }
    __syncthreads();
    const float T0 = T;           // the chunk's starting transmittance
    float max_alpha = 0.0f;       // SCAN off: the chunk's largest alpha
    float w_first = 0.0f;         // BLEND off: w of the chunk's first pair
    for (int i = 0; i < n_valid; ++i) {
      const Coef& e = coef[i];
      float alpha;
      if constexpr (EXP) {
        const float power = e.w0 + e.wx * px + e.wy * py - e.ha * pxx -
                            e.hc * pyy - e.b * pxy;
        const float raw =
            (power > 0.0f) ? 0.0f : e.op * expf(fminf(power, 0.0f));
        alpha = fminf(raw, kAlphaMax);
        if (alpha < kAlphaMin) alpha = 0.0f;
      } else {
        alpha = fminf(fabsf(e.op * (e.a * px + e.c * py + e.b)) * 1e-3f, 0.5f);
      }
      float w;
      if constexpr (SCAN) {
        w = alpha * T;
      } else {
        w = alpha * T0;
        max_alpha = fmaxf(max_alpha, alpha);
      }
      if constexpr (BLEND) {
        acc_r += w * e.r;
        acc_g += w * e.g;
        acc_b += w * e.bl;
        acc_d += w * e.depth;
        acc_a += w;
      } else {
        if (i == 0) w_first = w;
      }
      if constexpr (ARGMAX) {
        if (w > best_w) {
          best_w = w;
          best_id = e.sem;
        }
      }
      if constexpr (SCAN) T *= 1.0f - alpha;
    }
    if constexpr (!SCAN) T = T0 * (1.0f - max_alpha);
    if constexpr (!BLEND) {
      const float s = w_first * 1e-9f;
      acc_r += s;
      acc_g += s;
      acc_b += s;
      acc_d += s;
      acc_a += s;
    }
    ++k;
    // Also the barrier before the next chunk overwrites `coef`.
    if constexpr (ET) {
      if (!__syncthreads_or(T > kTransEps)) break;
    } else {
      __syncthreads();
    }
  }

  float* o = out + (size_t)blockIdx.x * kNch * kNpix + pix;
  o[0 * kNpix] = acc_r;
  o[1 * kNpix] = acc_g;
  o[2 * kNpix] = acc_b;
  o[3 * kNpix] = acc_d;
  o[4 * kNpix] = acc_a;
  o[5 * kNpix] = T;
  o[6 * kNpix] = best_w;
  o[7 * kNpix] = best_id;
}

typedef void (*KernelFn)(const float*, const int32_t*, const int32_t*,
                         const int32_t*, float*, int, int, int, int);

// The six flag sets the probe times; any other set is refused.
KernelFn pick(int et, int exp, int scan, int blend, int argmax) {
  const int key = (et << 4) | (exp << 3) | (scan << 2) | (blend << 1) | argmax;
  switch (key) {
    case 0x1f: return composite_anatomy_kernel<true, true, true, true, true>;
    case 0x0f: return composite_anatomy_kernel<false, true, true, true, true>;
    case 0x0e: return composite_anatomy_kernel<false, true, true, true, false>;
    case 0x0b: return composite_anatomy_kernel<false, true, false, true, true>;
    case 0x0d: return composite_anatomy_kernel<false, true, true, false, true>;
    case 0x07: return composite_anatomy_kernel<false, false, true, true, true>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" int sage3d_composite_anatomy(const void* attrs,
                                        const void* pair_gauss,
                                        const void* tile_start,
                                        const void* tile_count, void* out,
                                        int n_tiles, int tiles_x, int n_gauss,
                                        int n_pairs, int batch, int early_term,
                                        int do_exp, int do_scan, int do_blend,
                                        int do_argmax, void* stream) {
  KernelFn fn = pick(early_term != 0, do_exp != 0, do_scan != 0,
                     do_blend != 0, do_argmax != 0);
  if (fn == nullptr || batch < 1) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    fn<<<n_tiles * batch, kNpix, 0, (cudaStream_t)stream>>>(
        (const float*)attrs, (const int32_t*)pair_gauss,
        (const int32_t*)tile_start, (const int32_t*)tile_count, (float*)out,
        n_tiles, tiles_x, n_gauss, n_pairs);
  }
  return (int)cudaGetLastError();
}

// Registers per thread of one variant's kernel, from cudaFuncGetAttributes.
extern "C" int sage3d_composite_anatomy_regs(int early_term, int do_exp,
                                             int do_scan, int do_blend,
                                             int do_argmax, void* regs) {
  KernelFn fn = pick(early_term != 0, do_exp != 0, do_scan != 0,
                     do_blend != 0, do_argmax != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)fn);
  if (err == cudaSuccess) *(int*)regs = attr.numRegs;
  return (int)err;
}
