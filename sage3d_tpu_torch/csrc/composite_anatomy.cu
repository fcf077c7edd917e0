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
// below). Design: K2's, 128 threads per tile with 8 pixels (one column) each,
// a straight-line pixel body with the cutoffs as one PTX select, the next
// chunk's attribute rows loaded while a chunk is swept into the other half of
// a double-buffered coefficient array, one barrier per chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kNpix = kTile * kTile;
constexpr int kPix = 8;                   // pixels per thread: rows of a column
constexpr int kThreads = kNpix / kPix;    // threads per block
constexpr int kMinBlocks = 3;             // blocks an SM must hold
constexpr int kChunk = 128;               // pairs per chunk
constexpr int kNfeat = 16;                // floats per attribute row
constexpr int kNch = 8;                   // r,g,b,depth,alpha,trans,best_w,best_id
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTransEps = 1e-4f;
static_assert(kTile % kPix == 0 && kThreads % 32 == 0, "pixel layout");

struct __align__(16) Coef {
  float w0, wx, wy, ha, hc, b, op, r, g, bl, depth, sem, a, c;
};

// One pair's coefficients from its attribute row, in K2's operations and
// order, and the raw conic a, c for the no-exp stub.
__device__ __forceinline__ Coef make_coef(const float4 (&q)[3], float ox,
                                          float oy) {
  const float a = q[0].x, b = q[0].y, c = q[0].z;
  const float cx = q[0].w - ox;
  const float cy = q[1].x - oy;
  Coef e;
  e.w0 = -0.5f * (a * cx * cx + c * cy * cy) - b * cx * cy;
  e.wx = a * cx + b * cy;
  e.wy = c * cy + b * cx;
  e.ha = 0.5f * a;
  e.hc = 0.5f * c;
  e.b = b;
  e.op = q[1].y;
  e.r = q[1].z;
  e.g = q[1].w;
  e.bl = q[2].x;
  e.depth = q[2].y;
  e.sem = q[2].z;
  e.a = a;
  e.c = c;
  return e;
}

// K2's alpha from power and x = min(op * exp(min(power, 0)), 0.99):
// power > 0 ? 0 : x, then 0 where that is below 1/255. As the PTX of two
// compares and one select, which gives the same bits (for power > 0, x is
// discarded either way): written as C++ conditionals, the compiler turns the
// first into a branch around the exp, one per pixel, which serialises the
// pixels' chains, and keeps two selects.
__device__ __forceinline__ float cut_alpha(float power, float x) {
  float r;
  asm("{\n\t.reg .pred p;\n\t"
      "setp.gt.f32 p, %1, 0f00000000;\n\t"
      "setp.lt.or.f32 p, %2, %3, p;\n\t"
      "selp.f32 %0, 0f00000000, %2, p;\n\t}"
      : "=f"(r) : "f"(power), "f"(x), "f"(kAlphaMin));
  return r;
}

__device__ __forceinline__ void load_row(const float* __restrict__ attrs,
                                         int gid, float4 (&q)[3]) {
  const float4* row = reinterpret_cast<const float4*>(attrs + (size_t)gid * kNfeat);
  q[0] = row[0];
  q[1] = row[1];
  q[2] = row[2];
}

template <bool ET, bool EXP, bool SCAN, bool BLEND, bool ARGMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_anatomy_kernel(const float* __restrict__ attrs,
                         const int32_t* __restrict__ pair_gauss,
                         const int32_t* __restrict__ tile_start,
                         const int32_t* __restrict__ tile_count,
                         float* __restrict__ out, int n_tiles, int tiles_x,
                         int n_gauss, int n_pairs) {
  __shared__ Coef coef[2][kChunk];
  const int copy = blockIdx.x / n_tiles;
  const int t = blockIdx.x - copy * n_tiles;
  attrs += (size_t)copy * n_gauss * kNfeat;
  pair_gauss += (size_t)copy * n_pairs;
  tile_start += (size_t)copy * n_tiles;
  tile_count += (size_t)copy * n_tiles;
  const int tid = threadIdx.x;
  const float ox = (float)((t % tiles_x) * kTile);
  const float oy = (float)((t / tiles_x) * kTile);
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int n_chunks = (count + kChunk - 1) / kChunk;

  const int col = tid % kTile;
  const int row0 = (tid / kTile) * kPix;
  const float px = (float)col + 0.5f;
  const float pxx = px * px;
  float py[kPix], pyy[kPix], pxy[kPix];
  float T[kPix], acc_r[kPix], acc_g[kPix], acc_b[kPix], acc_d[kPix],
      acc_a[kPix], best_w[kPix], best_id[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    py[j] = (float)(row0 + j) + 0.5f;
    pyy[j] = py[j] * py[j];
    pxy[j] = px * py[j];
    T[j] = 1.0f;
    acc_r[j] = acc_g[j] = acc_b[j] = acc_d[j] = acc_a[j] = 0.0f;
    best_w[j] = 0.0f;
    best_id[j] = -1.0f;
  }

  auto has_pair = [&](int kk) {
    return kk < n_chunks && tid < kChunk && tid < count - kk * kChunk;
  };
  auto pair_id = [&](int kk) {
    const int p = start + kk * kChunk + tid;
    if (p < 0 || p >= n_pairs) __trap();
    return pair_gauss[p];
  };
  auto check_id = [&](int gid) {
    if (gid < 0 || gid >= n_gauss) __trap();
  };

  if (has_pair(0)) {
    const int gid = pair_id(0);
    check_id(gid);
    float4 rq[3];
    load_row(attrs, gid, rq);
    coef[0][tid] = make_coef(rq, ox, oy);
  }
  bool has_next = has_pair(1);
  int gid_next = has_next ? pair_id(1) : 0;
  __syncthreads();

  int k = 0;
  while (k < n_chunks) {
    const int buf = k & 1;
    float4 rq[3];
    const bool load = has_next;
    if (load) {
      check_id(gid_next);
      load_row(attrs, gid_next, rq);
    }
    has_next = has_pair(k + 2);
    if (has_next) gid_next = pair_id(k + 2);

    float max_alpha[kPix];   // SCAN off: the chunk's largest alpha
    float w_first[kPix];     // BLEND off: w of the chunk's first pair
#pragma unroll
    for (int j = 0; j < kPix; ++j) max_alpha[j] = w_first[j] = 0.0f;
    const Coef* cf = coef[buf];
    const int n_valid = min(count - k * kChunk, kChunk);
    for (int i = 0; i < n_valid; ++i) {
      const Coef e = cf[i];
      const float t1 = e.w0 + e.wx * px;
      const float t3 = e.ha * pxx;
      float alpha[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if constexpr (EXP) {
          const float power = t1 + e.wy * py[j] - t3 - e.hc * pyy[j] -
                              e.b * pxy[j];
          alpha[j] = cut_alpha(
              power, fminf(e.op * expf(fminf(power, 0.0f)), kAlphaMax));
        } else {
          alpha[j] = fminf(
              fabsf(e.op * (e.a * px + e.c * py[j] + e.b)) * 1e-3f, 0.5f);
        }
      }
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        // SCAN off: T holds the chunk's starting transmittance all chunk.
        const float w = alpha[j] * T[j];
        if constexpr (!SCAN) max_alpha[j] = fmaxf(max_alpha[j], alpha[j]);
        if constexpr (BLEND) {
          acc_r[j] += w * e.r;
          acc_g[j] += w * e.g;
          acc_b[j] += w * e.bl;
          acc_d[j] += w * e.depth;
          acc_a[j] += w;
        } else {
          w_first[j] = i == 0 ? w : w_first[j];
        }
        if constexpr (ARGMAX) {
          const bool better = w > best_w[j];
          best_w[j] = better ? w : best_w[j];
          best_id[j] = better ? e.sem : best_id[j];
        }
        if constexpr (SCAN) T[j] *= 1.0f - alpha[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if constexpr (!SCAN) T[j] = T[j] * (1.0f - max_alpha[j]);
      if constexpr (!BLEND) {
        const float s = w_first[j] * 1e-9f;
        acc_r[j] += s;
        acc_g[j] += s;
        acc_b[j] += s;
        acc_d[j] += s;
        acc_a[j] += s;
      }
    }
    if (load) coef[buf ^ 1][tid] = make_coef(rq, ox, oy);
    ++k;
    // The one barrier of the chunk (with ET, also the early-stop vote); it
    // publishes the next chunk's coefficients.
    if constexpr (ET) {
      bool live = false;
#pragma unroll
      for (int j = 0; j < kPix; ++j) live |= T[j] > kTransEps;
      if (!__syncthreads_or(live)) break;
    } else {
      __syncthreads();
    }
  }

  float* o = out + (size_t)blockIdx.x * kNch * kNpix + row0 * kTile + col;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    float* oj = o + j * kTile;
    oj[0 * kNpix] = acc_r[j];
    oj[1 * kNpix] = acc_g[j];
    oj[2 * kNpix] = acc_b[j];
    oj[3 * kNpix] = acc_d[j];
    oj[4 * kNpix] = acc_a[j];
    oj[5 * kNpix] = T[j];
    oj[6 * kNpix] = best_w[j];
    oj[7 * kNpix] = best_id[j];
  }
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
    fn<<<n_tiles * batch, kThreads, 0, (cudaStream_t)stream>>>(
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
