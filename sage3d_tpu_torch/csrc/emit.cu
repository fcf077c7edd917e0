// K1: tile-key emission for the binning stage, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sage3d_tpu/ops/binning.py::_emit_kernel (launched by
// _get_emit_call through _emit_fused) and the compaction of its output. The
// TPU kernel gives every (candidate slot k, Gaussian g) of every emission
// tier a key, INVALID_KEY for slots past the Gaussian's count or culled; this
// kernel walks only the live slots (k < count_eff[g]) of all tiers at once
// and writes only the kept pairs. A Gaussian is live in at most one tier (the
// tiers split Gaussians by tile count), so one table with per-Gaussian
// count_eff describes them all; offsets is its exclusive scan, L live slots.
//
// Live slot s belongs to the Gaussian g with offsets[g] <= s < offsets[g+1],
// as its k = s - offsets[g]-th candidate: the kernel walks the Gaussian's
// tight AABB tile rect in row-major order, applies the exact ellipse-tile cull
// (the minimum of the conic quadratic over the tile's pixel rect must be
// <= cut2 * 1.001 + 1e-3, and is 0 when the mean lies in the tile) and keeps
// the pair if it survives: key tid * mult + rank (mult > 0, the fused int32
// key) or (tid << 31) | rank (mult == 0, the two-key sort's int64 key), and
// the Gaussian id. tid is the tile's index within its camera plus the row's
// tile base (column 11 of the table, int32 bits): a batch of B cameras is
// one table of B*n rows, camera b's with base b*T, so one launch emits the
// whole batch with camera-major tile ids, as the vmapped TPU kernel's batch
// grid axis does. One camera has base 0. The pairs come out in no
// particular order: the sort after the kernel orders them, and a kept key is
// unique per (tile, Gaussian).
//
// What bounds it on an H100: operations and latency. Each live slot does
// ~90 f32 operations; the bytes are the live Gaussians' rows, the offsets
// and 8-12 bytes per kept pair. Design:
//   - kSlots consecutive live slots per thread; a block of kBlock threads
//     covers kBlock * kSlots consecutive slots. Warp 0 and warp 1 find the
//     Gaussian of the block's first and last slot by a 32-way search of the
//     offsets (every lane probes one point, a ballot picks the interval: 4-5
//     dependent loads for 1M Gaussians, not 20); every thread then
//     binary-searches only that window, which its block's loads keep in L1,
//     for its first slot, and walks forward from there (a Gaussian has ~30
//     live slots). The block's search is the latency the slots per thread
//     amortize: at one slot a thread it set the time.
//   - What a Gaussian's candidates share (its row, the three IEEE
//     divisions) is formed once per Gaussian a thread meets.
//   - Compaction in the kernel: __ballot_sync/__popc within a warp, a
//     prefix over the block's warps in shared memory, and one atomicAdd per
//     block on a device counter reserves the block's range of the output.
//   - No float atomics; the counter is cleared by one cudaMemsetAsync.
// The TPU kernel's k-tiling (EMIT_KB, a VMEM workaround) and its padded
// (k_budget, n_pad) key array, written in full and compacted afterwards,
// are gone.
//
// Arithmetic: the same f32 operations, in the same order, as the JAX kernel
// and the plain PyTorch versions (ops/binning.py::emit_tile_keys_plain and
// emit_tile_pairs_plain). The file is built with -fmad=false, so no
// multiply-add is contracted into an FMA and a tile at the cull margin is
// decided the same way; 1/x is IEEE division (no fast math). The keys equal
// the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;             // threads per block
constexpr int kSlots = 8;               // consecutive live slots per thread
constexpr bool kBlockSearch = true;     // search the block's window only
constexpr int kSpan = kBlock * kSlots;  // live slots per block
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTileW = 32.0f;
constexpr float kTileH = 32.0f;
static_assert(kBlock % 32 == 0 && kBlock >= 64, "two searching warps");

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The Gaussian of slot s: the g in [lo, hi) with off[g] <= s < off[g + 1],
// given off[lo] <= s < off[hi]. The whole warp searches for one s: each lane
// probes one of 32 evenly spaced points and a ballot keeps the interval
// between the last probe at or below s and the next.
__device__ int warp_search(const int64_t* __restrict__ off, int lo, int hi,
                           int64_t s, int lane) {
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + (lane + 1) * step;
    const bool le = probe < hi && off[probe] <= s;
    const int c = __popc(__ballot_sync(kFull, le));  // the probes at or below s
    lo += c * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// The same by one thread: plain binary search.
__device__ __forceinline__ int thread_search(const int64_t* __restrict__ off,
                                             int lo, int hi, int64_t s) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= s) lo = mid; else hi = mid;
  }
  return lo;
}

// One Gaussian's row of the table, with what its candidates share: the
// three IEEE divisions, formed once per Gaussian and not once per slot.
struct Gauss {
  float x0, y0, nxs, inv, mx, my, cut2, ca, cb, cc, inv_a, inv_c;
  int32_t rank, base;
};

__device__ __forceinline__ Gauss load_gauss(const float4* __restrict__ table,
                                            int g) {
  const float4 q0 = table[3 * (size_t)g];      // x0, y0, nx, count
  const float4 q1 = table[3 * (size_t)g + 1];  // mx, my, cut2, rank bits
  const float4 q2 = table[3 * (size_t)g + 2];  // conic a, b, c, tile base
  Gauss e;
  e.x0 = q0.x;
  e.y0 = q0.y;
  e.nxs = fmaxf(q0.z, 1.0f);
  e.inv = 1.0f / e.nxs;
  e.mx = q1.x;
  e.my = q1.y;
  e.cut2 = q1.z;
  e.rank = __float_as_int(q1.w);
  e.ca = q2.x;
  e.cb = q2.y;
  e.cc = q2.z;
  e.base = __float_as_int(q2.w);
  e.inv_a = 1.0f / fmaxf(e.ca, 1e-20f);
  e.inv_c = 1.0f / fmaxf(e.cc, 1e-20f);
  return e;
}

// Candidate k (float) of Gaussian e: whether it survives the cull, and its
// key.
__device__ __forceinline__ bool cull_key(float kf, const Gauss& e, int tiles_x,
                                         int mult, int64_t& key) {
  // k // nx and k % nx through the f32 reciprocal plus a +-1 fixup.
  const float nxs = e.nxs;
  float q = floorf(kf * e.inv);
  float r = kf - q * nxs;
  q = (r < 0.0f) ? q - 1.0f : ((r >= nxs) ? q + 1.0f : q);
  r = kf - q * nxs;
  const float tx = e.x0 + r;
  const float ty = e.y0 + q;
  const float fx0 = tx * kTileW;
  const float fy0 = ty * kTileH;
  // Tile pixel rect relative to the mean.
  const float x_lo = fx0 - e.mx;
  const float x_hi = x_lo + kTileW;
  const float y_lo = fy0 - e.my;
  const float y_hi = y_lo + kTileH;
  const bool inside = (x_lo <= 0.0f) && (x_hi >= 0.0f) && (y_lo <= 0.0f) &&
                      (y_hi >= 0.0f);
  const float ca = e.ca, cb = e.cb, cc = e.cc;

  // min over y' in [y_lo, y_hi] at fixed x' = xe, and the transposed edge
  auto vedge = [&](float xe) {
    const float t = clipf(-cb * xe * e.inv_c, y_lo, y_hi);
    return (ca * xe) * xe + (2.0f * cb * xe + cc * t) * t;
  };
  auto hedge = [&](float ye) {
    const float t = clipf(-cb * ye * e.inv_a, x_lo, x_hi);
    return (cc * ye) * ye + (2.0f * cb * ye + ca * t) * t;
  };
  float m2 = fminf(fminf(vedge(x_lo), vedge(x_hi)),
                   fminf(hedge(y_lo), hedge(y_hi)));
  if (inside) m2 = 0.0f;
  const int32_t tid = (int32_t)(ty * (float)tiles_x + tx) + e.base;
  key = mult ? (int64_t)(tid * mult + e.rank)
             : (((int64_t)tid << 31) | (int64_t)e.rank);
  return m2 <= e.cut2 * 1.001f + 1e-3f;
}

__global__ void __launch_bounds__(kBlock)
emit_kernel(const float4* __restrict__ table, const int64_t* __restrict__ off,
            int n, int64_t n_live, int tiles_x, int mult,
            void* __restrict__ keys, int32_t* __restrict__ gauss,
            unsigned long long* __restrict__ counter) {
  __shared__ int window[2];
  __shared__ int warp_base[kWarps];
  __shared__ unsigned long long block_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s_first = (int64_t)blockIdx.x * kSpan;

  // The window [lo, hi) of Gaussians that holds the block's slots.
  int lo = 0, hi = n;
  if (kBlockSearch) {
    if (warp < 2) {
      const int64_t last =
          (s_first + kSpan < n_live ? s_first + kSpan : n_live) - 1;
      const int g = warp_search(off, 0, n, warp == 0 ? s_first : last, lane);
      if (lane == 0) window[warp] = g;
    }
    __syncthreads();
    lo = window[0];
    hi = window[1] + 1;
  }

  // The thread's slots s0 .. s0 + kSlots - 1: one search finds the first
  // one's Gaussian, the others walk forward from it.
  const int64_t s0 = s_first + (int64_t)threadIdx.x * kSlots;
  int g = 0;
  int64_t g_start = 0, g_end = 0;   // offsets[g], offsets[g + 1]
  Gauss e = {};
  if (s0 < n_live) {
    g = thread_search(off, lo, hi, s0);
    g_start = off[g];
    g_end = off[g + 1];
    e = load_gauss(table, g);
  }
  int64_t key[kSlots];
  int gid[kSlots];
  unsigned kept[kSlots];
  int n_warp = 0;   // pairs the warp keeps
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int64_t s = s0 + i;
    bool keep = false;
    key[i] = 0;
    if (s < n_live) {
      if (s >= g_end) {   // the next Gaussian with a live slot
        do {
          ++g;
          g_start = g_end;
          g_end = off[g + 1];
        } while (s >= g_end);
        e = load_gauss(table, g);
      }
      keep = cull_key((float)(int)(s - g_start), e, tiles_x, mult, key[i]);
    }
    gid[i] = g;
    kept[i] = __ballot_sync(kFull, keep);
    n_warp += __popc(kept[i]);
  }

  // Compaction: the kept pairs of the block at a range of the output that
  // one atomicAdd reserves; within it, warp by warp, slot by slot.
  if (lane == 0) warp_base[warp] = n_warp;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_base[w];
      warp_base[w] = total;
      total += c;
    }
    block_base = total ? atomicAdd(counter, (unsigned long long)total) : 0ull;
  }
  __syncthreads();
  size_t pos = (size_t)block_base + warp_base[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (kept[i] >> lane & 1u) {
      const size_t at = pos + __popc(kept[i] & below);
      if (mult) {
        static_cast<int32_t*>(keys)[at] = (int32_t)key[i];
      } else {
        static_cast<int64_t*>(keys)[at] = key[i];
      }
      gauss[at] = gid[i];
    }
    pos += __popc(kept[i]);
  }
}

}  // namespace

// keys: n_live int32 (mult > 0) or int64 (mult == 0) entries; gauss: n_live
// int32; counter: one int64, set to the number of kept pairs, which fill
// keys[0, count) and gauss[0, count).
extern "C" int sage3d_emit_tile_pairs(const void* table, const void* offsets,
                                      int n, long long n_live, int tiles_x,
                                      int mult, void* keys, void* gauss,
                                      void* counter, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  if (n_live == 0) return (int)cudaGetLastError();
  const long long blocks = (n_live + kSpan - 1) / kSpan;
  if (n <= 0 || n_live < 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  emit_kernel<<<(unsigned)blocks, kBlock, 0, st>>>(
      (const float4*)table, (const int64_t*)offsets, n, (int64_t)n_live,
      tiles_x, mult, keys, (int32_t*)gauss, (unsigned long long*)counter);
  return (int)cudaGetLastError();
}
