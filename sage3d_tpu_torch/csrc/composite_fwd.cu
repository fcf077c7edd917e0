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
// There is no per-pixel cutoff: a pixel keeps accumulating until the whole
// tile is saturated, as on the TPU, so k_end and the images match it.
//
// What bounds it on an H100: operations. Each pair-pixel evaluation is ~18
// f32 operations and one expf, each one with alpha > 0 ~14 more, and a tile
// reads each of its pairs' attribute rows once per chunk, so arithmetic
// outweighs bytes by two orders of magnitude; the kernel runs near the
// instruction-issue limit. Design:
//   - 128 threads per tile, 8 pixels per thread: one column and 8 rows (a
//     warp holds a 32x8 strip). The pixels of a thread share x, so
//     t1 = w0 + wx * px and t3 = ha * pxx are formed once per pair and each
//     pixel evaluates t1 + wy * py - t3 - hc * pyy - b * pxy: K2's
//     association, left to right.
//   - The pixel body is straight-line, unrolled over the 8 pixels: the
//     cutoffs and the best-weight update (w > best_w, strict, so the first
//     maximum in depth order stays) are selects, so the 8 pixels' dependent
//     transmittance chains interleave. The power > 0 cutoff is a PTX select
//     (cut_alpha): as a C++ conditional it compiled to a branch around the
//     exp of every pixel. The rest of an evaluation is the fixed f32
//     arithmetic; the kernel runs near the instruction-issue rate.
//   - kSkipMisses (off): a warp would skip the blend of a pair whose alpha
//     is 0 on all its 256 pixels, an exact no-op; the vote cost more than it
//     saved, also on the sparse bench box (benchmarks/kernel_variants.py).
//   - __launch_bounds__(128, 3): 150 registers (kernel_variants.py: 128
//     registers at 4 blocks an SM 3% slower, 4 pixels a thread 5% slower).
//   - Double-buffered chunks: while chunk k is swept, each thread's load of
//     chunk k+1's attribute row (three float4) and chunk k+2's pair id are in
//     flight; the row becomes chunk k+1's coefficients in the other buffer.
//   - One barrier per chunk: __syncthreads_or, which is also the early-stop
//     vote, and publishes the next chunk's coefficients.
//
// Arithmetic: alpha uses the TPU kernel's tile-local expanded form
// (_alpha_rows: w0, wx, wy from the global mean minus the tile origin, pixel
// centers at +0.5) in its operation order, built with -fmad=false and IEEE
// expf, so the power > 0 and alpha < 1/255 decisions follow the JAX kernel,
// and K3 (composite_bwd.cu) replays w and T bit for bit. The TPU layout
// workarounds (feature-major blocks, rolled two-block windows, guard blocks,
// the (1,8,128) k_end block) are gone.
//
// A batch of cameras (the vmapped TPU kernel's leading grid axis) is one
// launch of B * cam_tiles blocks over one attribute table of B * N rows
// (camera b's Gaussian g at row b * N + g, which its pairs name): a block
// takes its pixel origin from its tile's index within its camera, and
// nothing else in the body depends on the camera.
//
// Segment checkpoints (under autograd only; composite_bwd.cu splits a tile's
// walk into segments of `seg` chunks, one block each): at every chunk
// boundary k that is a multiple of seg and that the walk goes past, each
// pixel's T and its five accumulators (r, g, b, depth, alpha) before chunk
// k, into checkpoint row start / (seg * 128) + k / seg. Two such boundaries,
// of one tile or of two, lie at least seg * 128 pairs apart in the pair list
// (a tile's pairs are one range, disjoint from the others'), so the rows are
// distinct and the caller sizes the buffer from the pair count alone, with
// no host read. These are stores of values the walk already holds: the
// arithmetic, the images and k_end are those of the launch without them,
// which is the same template with the stores compiled out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kNpix = kTile * kTile;
constexpr int kPix = 8;                   // pixels per thread: rows of a column
constexpr int kThreads = kNpix / kPix;    // threads per block
constexpr int kMinBlocks = 3;             // blocks an SM must hold
constexpr bool kSkipMisses = false;       // a warp skips the blend of a pair
                                          // that misses all its pixels
constexpr int kChunk = 128;               // pairs per chunk
constexpr int kNfeat = 16;                // floats per attribute row
constexpr int kNch = 8;                   // r,g,b,depth,alpha,trans,best_w,best_id
constexpr int kCkptCh = 6;                // checkpoint: T, r, g, b, depth, alpha
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTransEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile % kPix == 0 && kThreads % 32 == 0, "pixel layout");

struct __align__(16) Coef {
  float w0, wx, wy, ha, hc, b, op, r, g, bl, depth, sem;
};

// One pair's coefficients from its attribute row (columns 0-10), in K2's
// operations and order.
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

template <bool kCkpt>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_fwd_kernel(const float* __restrict__ attrs,
                     const int32_t* __restrict__ pair_gauss,
                     const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ tile_count,
                     float* __restrict__ out, int32_t* __restrict__ kend,
                     float* __restrict__ ckpt, int seg, int tiles_x,
                     int cam_tiles, int n_gauss, int n_pairs) {
  __shared__ Coef coef[2][kChunk];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  // The tile's pixel origin within its camera: a batch of cameras is
  // B * cam_tiles camera-major tiles.
  const int tc = t % cam_tiles;
  const float ox = (float)((tc % tiles_x) * kTile);
  const float oy = (float)((tc / tiles_x) * kTile);
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int n_chunks = (count + kChunk - 1) / kChunk;

  // Pixels of this thread: column col, rows row0 .. row0 + kPix - 1, with
  // the coordinates K2 computes for them.
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

  // Whether this thread loads a pair of chunk kk, and that pair's Gaussian
  // id (loaded here, checked where it is used, so the load can be in flight).
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

  // Chunk 0's coefficients, and chunk 1's pair id in flight.
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
  // With checkpoints the walk stops at each seg-th chunk to store them and
  // goes on; without, it is one loop to the end, as the inner loop alone.
  int stop = kCkpt ? min(seg, n_chunks) : n_chunks;
  bool stopped = false;   // the early stop
  for (;;) {
    while (k < stop) {
      const int buf = k & 1;
      // Loads for the next chunks, consumed after this chunk's sweep.
      float4 rq[3];
      const bool load = has_next;
      if (load) {
        check_id(gid_next);
        load_row(attrs, gid_next, rq);
      }
      has_next = has_pair(k + 2);
      if (has_next) gid_next = pair_id(k + 2);

      const Coef* cf = coef[buf];
      const int n_valid = min(count - k * kChunk, kChunk);
      for (int i = 0; i < n_valid; ++i) {
        const Coef e = cf[i];
        const float t1 = e.w0 + e.wx * px;
        const float t3 = e.ha * pxx;
        float alpha[kPix];
        bool hit = false;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float power = t1 + e.wy * py[j] - t3 - e.hc * pyy[j] -
                              e.b * pxy[j];
          alpha[j] = cut_alpha(
              power, fminf(e.op * expf(fminf(power, 0.0f)), kAlphaMax));
          hit |= alpha[j] > 0.0f;
        }
        // A pair that leaves every pixel of the warp at alpha 0 changes
        // nothing below (w = 0 adds exact zeros, T is multiplied by 1).
        if (kSkipMisses && !__any_sync(kFull, hit)) continue;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float w = alpha[j] * T[j];
          acc_r[j] += w * e.r;
          acc_g[j] += w * e.g;
          acc_b[j] += w * e.bl;
          acc_d[j] += w * e.depth;
          acc_a[j] += w;
          const bool better = w > best_w[j];
          best_w[j] = better ? w : best_w[j];
          best_id[j] = better ? e.sem : best_id[j];
          T[j] *= 1.0f - alpha[j];
        }
      }
      if (load) coef[buf ^ 1][tid] = make_coef(rq, ox, oy);
      ++k;
      // The one barrier of the chunk: the early-stop vote, which also
      // publishes the next chunk's coefficients.
      bool live = false;
#pragma unroll
      for (int j = 0; j < kPix; ++j) live |= T[j] > kTransEps;
      if (!__syncthreads_or(live)) {
        stopped = true;
        break;
      }
    }
    if (!kCkpt || stopped || k >= n_chunks) break;
    // Chunk k = stop, a multiple of seg: the state before it. Row
    // (start + 128 k) / (128 seg) is start / (128 seg) + k / seg.
    float* c = ckpt + (size_t)((start + k * kChunk) / (seg * kChunk))
                          * kCkptCh * kNpix + row0 * kTile + col;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      float* cj = c + j * kTile;
      cj[0 * kNpix] = T[j];
      cj[1 * kNpix] = acc_r[j];
      cj[2 * kNpix] = acc_g[j];
      cj[3 * kNpix] = acc_b[j];
      cj[4 * kNpix] = acc_d[j];
      cj[5 * kNpix] = acc_a[j];
    }
    stop = min(k + seg, n_chunks);
  }

  float* o = out + (size_t)t * kNch * kNpix + row0 * kTile + col;
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
  if (tid == 0) kend[t] = k;
}

}  // namespace

// ckpt NULL: no checkpoints (seg unused); else seg > 0 chunks.
extern "C" int sage3d_composite_fwd(const void* attrs, const void* pair_gauss,
                                    const void* tile_start,
                                    const void* tile_count, void* out,
                                    void* kend, void* ckpt, int seg,
                                    int n_tiles, int tiles_x, int cam_tiles,
                                    int n_gauss, int n_pairs, void* stream) {
  if (cam_tiles <= 0 || n_tiles % cam_tiles) return (int)cudaErrorInvalidValue;
  if (ckpt && seg <= 0) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    auto kernel = ckpt ? composite_fwd_kernel<true> : composite_fwd_kernel<false>;
    kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)attrs, (const int32_t*)pair_gauss,
        (const int32_t*)tile_start, (const int32_t*)tile_count, (float*)out,
        (int32_t*)kend, (float*)ckpt, seg, tiles_x, cam_tiles, n_gauss,
        n_pairs);
  }
  return (int)cudaGetLastError();
}
