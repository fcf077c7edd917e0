// K3: backward tile compositor, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sage3d_tpu/ops/composite_pallas.py::_bwd_kernel
// (pallas_call in bwd_call). For each 32x32 tile it sweeps the tile's
// depth-ordered pairs once, front to back, over the first allowed[t] chunks
// (the forward's k_end, clipped to the gradient buffer). Per pixel and pair it
// replays the forward (alpha, w = alpha * T, T *= 1 - alpha) and forms
//   c      = sum_ch g_ch * feat_ch + g_alpha
//   dalpha = c * T_before - (S_pix - prefix_incl(c * w)) / (1 - alpha)
//            - g_T * T_final / (1 - alpha),  S_pix = sum_ch g_ch * fwd_acc_ch,
// zeroed where alpha == 0 or raw > 0.99. The suffix sums a back-to-front
// sweep would carry come from S_pix minus the running prefix, so the sweep
// runs in the forward's order. Per pair it sums ten channels over the tile's
// 1024 pixels: the conic a/b/c and mean x/y gradients from dpower =
// dalpha * alpha, the opacity gradient sum(dpower) / op, and g_ch * w for
// r, g, b and depth. Row (chunk0[t] + k) * 128 + i of the slot buffer gets
// those ten values and, in column 11, the pair's Gaussian id. The caller
// fills the buffer with zero payload and the out-of-range id n_gauss, which
// rows of lanes past a chunk's last pair and of slots past the tile's allowed
// chunks keep: the sort puts them last and the segment sum skips them.
//
// The stop must be the forward's: the transmittance is replayed with K2's
// operations in K2's order (the same tile-local power expression, then
// w = alpha * T; T *= 1 - alpha, sequentially over the pairs), built with
// -fmad=false and IEEE expf, so w and T equal K2's bit for bit and a
// grad_capacity equal to the measured sum of k_end gives the same gradients
// as the safe bound. The TPU kernel's roll-doubling prefix products, HALF
// sub-blocks, rolled two-block windows and DMA pipelines are not carried over.
//
// What bounds it on an H100: operations. Each pair-pixel evaluation is the
// forward's ~21 f32 operations plus ~53 for the gradient, and each pair's
// 64-byte attribute row is read once per tile. Where alpha is 0 (a pixel
// outside the pair's footprint) the gradient adds nothing and is skipped, and
// a warp none of whose pixels the pair reaches skips the pair's cross-lane
// sum; the forward replay runs for every pixel. Design: one block of 256
// threads per tile, four pixels per thread (four rows of one column; a warp
// holds a 32x4 strip), so a thread adds its four pixels before any
// cross-thread sum.
// Per chunk, 128 threads turn the chunk's attribute rows into tile-local
// coefficients in shared memory, as K2 does. For every pair the warp sums its
// ten channels with a reduce-scatter butterfly (16 shuffles for 16 slots
// rather than 5 per value), lane 2v holding channel v of the warp's sum; the
// eight warp partials of 32 pairs wait in shared memory and are then added in
// warp order by one thread per (pair, channel). The sums are deterministic:
// no float atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kNpix = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kPix = kNpix / kThreads;  // pixels per thread: 4
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // pairs per chunk
constexpr int kSub = 32;     // pairs per round of the cross-warp sum
constexpr int kNfeat = 16;   // floats per attribute / slot row
constexpr int kNch = 8;      // channels of the forward images
constexpr int kNgrad = 10;   // gradient channels per pair
constexpr int kGidCol = 11;  // slot column carrying the Gaussian id
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTransEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

struct Coef {
  float w0, wx, wy, ha, hc, b, op, r, g, bl, depth, a, c, mx, my, gid;
};

// One level of the reduce-scatter: lanes with `up` keep the upper n values
// and send the lower n to their partner lane ^ off, the others the reverse.
template <int N>
__device__ __forceinline__ void halve(float (&v)[16], int off, bool up) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float send = up ? v[j] : v[j + N];
    const float keep = up ? v[j + N] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ attrs,
                     const int32_t* __restrict__ pair_gauss,
                     const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ tile_count,
                     const int32_t* __restrict__ chunk0,
                     const int32_t* __restrict__ allowed,
                     const float* __restrict__ fwd,
                     const float* __restrict__ gout,
                     float* __restrict__ slots, int tiles_x, int n_gauss,
                     int n_pairs, int c_cap) {
  __shared__ Coef coef[kChunk];
  __shared__ float part[kWarps][kSub][kNgrad];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float ox = (float)((t % tiles_x) * kTile);
  const float oy = (float)((t / tiles_x) * kTile);
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int n_chunks = allowed[t];
  const int64_t slot0 = chunk0[t];

  // Pixel j of this thread: column lane, row 4 * warp + j, so a warp covers
  // a 32x4 strip and a small footprint reaches few warps. Coordinates as K2
  // computes them.
  const float px = (float)lane + 0.5f;
  const float pxx = px * px;
  float py[kPix], pyy[kPix], pxy[kPix];
  float T[kPix], cw[kPix], spix[kPix], gtt[kPix];
  float g0[kPix], g1[kPix], g2[kPix], g3[kPix], g4[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int pix = (warp * kPix + j) * kTile + lane;
    py[j] = (float)(pix / kTile) + 0.5f;
    pyy[j] = py[j] * py[j];
    pxy[j] = px * py[j];
    const float* f = fwd + (size_t)t * kNch * kNpix + pix;
    const float* g = gout + (size_t)t * kNch * kNpix + pix;
    g0[j] = g[0 * kNpix];
    g1[j] = g[1 * kNpix];
    g2[j] = g[2 * kNpix];
    g3[j] = g[3 * kNpix];
    g4[j] = g[4 * kNpix];
    spix[j] = g0[j] * f[0 * kNpix] + g1[j] * f[1 * kNpix] +
              g2[j] * f[2 * kNpix] + g3[j] * f[3 * kNpix] +
              g4[j] * f[4 * kNpix];
    gtt[j] = g[5 * kNpix] * f[5 * kNpix];
    T[j] = 1.0f;
    cw[j] = 0.0f;
  }

  for (int k = 0; k < n_chunks; ++k) {
    const int n_valid = min(count - k * kChunk, kChunk);
    if (slot0 + k >= c_cap) __trap();
    if (tid < n_valid) {
      const int p = start + k * kChunk + tid;
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
      e.a = a;
      e.c = c;
      e.mx = cx;
      e.my = cy;
      e.gid = row[kGidCol];
      coef[tid] = e;
    }
    __syncthreads();
    for (int s0 = 0; s0 < n_valid; s0 += kSub) {
      const int ns = min(kSub, n_valid - s0);
      for (int i = 0; i < ns; ++i) {
        const Coef& e = coef[s0 + i];
        float v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = 0.0f;
        bool hit = false;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          // The forward, in K2's operations and order.
          const float power = e.w0 + e.wx * px + e.wy * py[j] - e.ha * pxx -
                              e.hc * pyy[j] - e.b * pxy[j];
          const float raw =
              (power > 0.0f) ? 0.0f : e.op * expf(fminf(power, 0.0f));
          float alpha = fminf(raw, kAlphaMax);
          if (alpha < kAlphaMin) alpha = 0.0f;
          const float om = 1.0f - alpha;
          // The gradient. Where alpha is 0, w and dpower are 0: every term
          // it would add is an exact zero and T stays, so it is skipped.
          if (alpha > 0.0f) {
            hit = true;
            const float w = alpha * T[j];
            const float cc = e.r * g0[j] + e.g * g1[j] + e.bl * g2[j] +
                             e.depth * g3[j] + g4[j];
            cw[j] += cc * w;
            float dalpha = 0.0f;
            if (raw <= kAlphaMax) {
              const float inv = 1.0f / om;
              dalpha = cc * T[j] - (spix[j] - cw[j]) * inv - gtt[j] * inv;
            }
            const float dpower = dalpha * alpha;
            const float dx = px - e.mx;
            const float dy = py[j] - e.my;
            v[0] += dpower * (-0.5f * dx * dx);
            v[1] += dpower * (-dx * dy);
            v[2] += dpower * (-0.5f * dy * dy);
            v[3] += dpower * (e.a * dx + e.b * dy);
            v[4] += dpower * (e.c * dy + e.b * dx);
            v[5] += dpower;
            v[6] += g0[j] * w;
            v[7] += g1[j] * w;
            v[8] += g2[j] * w;
            v[9] += g3[j] * w;
            T[j] *= om;
          }
        }
        if (__any_sync(kFull, hit)) {
          halve<8>(v, 16, lane & 16);
          halve<4>(v, 8, lane & 8);
          halve<2>(v, 4, lane & 4);
          halve<1>(v, 2, lane & 2);
          // Lanes 2q and 2q+1 now hold halves of slot q's warp sum.
          const float sum = v[0] + __shfl_xor_sync(kFull, v[0], 1);
          if ((lane & 1) == 0 && (lane >> 1) < kNgrad)
            part[warp][i][lane >> 1] = sum;
        } else if (lane < kNgrad) {
          part[warp][i][lane] = 0.0f;   // the pair misses this warp's pixels
        }
      }
      __syncthreads();
      for (int o = tid; o < ns * kNfeat; o += kThreads) {
        const int i = o / kNfeat;
        const int col = o % kNfeat;
        float val = 0.0f;
        if (col < kNgrad) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) val += part[w][i][col];
          if (col == 5) {
            const float op = coef[s0 + i].op;
            val = val / (op > 0.0f ? op : 1.0f);
          }
        } else if (col == kGidCol) {
          val = coef[s0 + i].gid;
        }
        slots[((slot0 + k) * kChunk + s0 + i) * kNfeat + col] = val;
      }
      __syncthreads();  // `part` is reused by the next round
    }
    // Lanes past the chunk's last pair keep the caller's fill. The barrier
    // below is also the one before the next chunk overwrites `coef`.
    bool live = false;
#pragma unroll
    for (int j = 0; j < kPix; ++j) live |= T[j] > kTransEps;
    if (!__syncthreads_or(live)) break;
  }
}

}  // namespace

extern "C" int sage3d_composite_bwd(const void* attrs, const void* pair_gauss,
                                    const void* tile_start,
                                    const void* tile_count, const void* chunk0,
                                    const void* allowed, const void* fwd_out,
                                    const void* gout, void* slots, int n_tiles,
                                    int tiles_x, int n_gauss, int n_pairs,
                                    int c_cap, void* stream) {
  if (n_tiles > 0) {
    composite_bwd_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)attrs, (const int32_t*)pair_gauss,
        (const int32_t*)tile_start, (const int32_t*)tile_count,
        (const int32_t*)chunk0, (const int32_t*)allowed, (const float*)fwd_out,
        (const float*)gout, (float*)slots, tiles_x, n_gauss, n_pairs, c_cap);
  }
  return (int)cudaGetLastError();
}
