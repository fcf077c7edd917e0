// K6: capsule-vs-Gaussian clearance, first argmin and contact count,
// hand-written for Hopper (sm_90a).
//
// Replaces the device programs of sage3d_tpu/ops/collision.py::capsule_query
// (a jit-compiled lax.scan over chunks of Gaussians) and
// ::capsule_query_pruned (the same scan with a lax.cond skip per chunk);
// XLA, not Pallas. For B capsules (segment p0-p1, radius r) and N Gaussians
// it computes, per query: the least clearance over the solid Gaussians (the
// math of collision.py:94-131, in its order, each operation rounded as the
// port's plain version rounds it: built with -fmad=false, IEEE division and
// sqrtf, expf), the first Gaussian index that reaches it, and the number of
// Gaussians in contact. Pruned: only the chunks whose AABB some query can
// reach (collision.py:285-288, the same f32 test) are walked, and the
// visited chunks are counted, all on the device (no host sync). It also
// assembles the query's result (the clearance clipped at the prune margin,
// hit, nearest_id), so a query is one memset and this one launch (after
// the radius's fill when the caller gives it as a number).
//
// The solid test is sigmoid(logit) >= opacity_thresh with PyTorch's CUDA
// sigmoid written out (1 / (1 + expf(-x)), IEEE division), so the scene's
// logits are read as they are and no sigmoid pass over the scene precedes
// the query; chip_smoke.py holds capsule_sigmoid to torch.sigmoid bitwise.
//
// The reduction has no float atomics. A clearance is packed into an
// order-preserving 32-bit key (the f32 bits, -0.0 made +0.0, the sign bit
// flipped for positives and all bits for negatives) above the 32-bit
// Gaussian index: the least 64-bit word is the least clearance and, on a
// tie, the smallest index, which is jnp.argmin's first occurrence and the
// scan's strict-less merge. Only clearances below BIG compete. Each thread
// walks its Gaussians in increasing index order and keeps a strict-less
// running minimum, which is the least word of what it saw; a block folds
// its threads' words once, at its end, and makes one global atomic per
// query, only where it improves on the global word. The words are stored
// complemented, so a zero-filled state means "no Gaussian" and the minimum
// is an atomicMax; contacts are integer atomicAdds. The block that finishes
// last (a ticket counter) writes the outputs. Any schedule of the same
// per-pair values gives the same words, so the result is deterministic.
//
// What bounds it on an H100: the scene's 44 bytes a Gaussian (means, quats,
// log-scales, opacity logit) are read once, 13 us at 1M; the pair
// arithmetic (~60 f32 operations with two IEEE divisions and two sqrtf,
// none an FMA, for each of the ~0.69M solid Gaussians of the 1M room) is
// ~0.08 ms at 64 queries at the non-FMA rate. On the card an IEEE division
// or sqrtf is 10-11 instructions (MUFU, Newton steps, a range check and its
// branch), so a pair issues ~111 instructions against those 60 operations:
// a schedule that issues every cycle reaches about half of the operations
// bound. Two schedules, picked from B:
//   - Few queries (B <= kFewMax, the rollout's B = 1): capsule_few. Blocks
//     sized to fill the SMs once walk each chunk grid-stride, a thread a
//     Gaussian at a time, the next Gaussian's bytes read while this one is
//     worked: its rotation, exp(-log_scales) and solid test once, in
//     registers, then the B pairs, each query's running minimum and contact
//     count in registers. One warp reduction (redux.sync) per query at the
//     end of the walk, one global atomic per query and block.
//   - Many queries (B > kFewMax): capsule_many, N-body style. A block takes
//     a tile of up to 256 queries, a thread per query (and per Gaussian
//     lane when the tile is narrower than the block), the query and its
//     running minimum in registers. The block stages 256 Gaussians at a
//     time in shared memory in their precomputed form (center, rotation,
//     inverse scales, index: 64 bytes), compacted to the solid ones, and
//     each thread walks the stage; a warp reads one Gaussian at a time (a
//     broadcast). No per-pair shuffle and no shared atomic: the lanes of a
//     query fold through shared memory once, at the end. kManyWaves
//     card-fulls of short blocks even out the stages' solid counts.
//   - The crossover: up to B = 4 capsule_few is the faster on the 1M room
//     (benchmarks/kernel_variants.py K6 times capsule_many at B = 1 and 4).
//   - Pruned: each block first tests its chunk against every query's
//     segment AABB and skips the walk when none reaches it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads a block; Gaussians a stage
constexpr int kWarps = kThreads / 32;
constexpr int kFewMax = 4;        // queries capsule_few keeps in registers
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;      // collision.BIG: "no solid Gaussian"
constexpr unsigned long long kNone = ~0ull;
// capsule_many's blocks, in card-fulls: short blocks even out the
// stages' uneven solid counts (benchmarks/kernel_variants.py times 1 and 2)
constexpr int kManyWaves = 4;

// The order-preserving key of a clearance (see the header).
__device__ __forceinline__ unsigned key_of(float c) {
  const unsigned bits = __float_as_uint(c == 0.0f ? 0.0f : c);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pack(float c, unsigned idx) {
  return ((unsigned long long)key_of(c) << 32) | idx;
}

__device__ __forceinline__ float unpack(unsigned long long word) {
  unsigned bits = (unsigned)(word >> 32);
  bits = (bits & 0x80000000u) ? (bits & 0x7fffffffu) : ~bits;
  return __uint_as_float(bits);
}

// PyTorch's CUDA sigmoid for float32: one / (one + std::exp(-a)).
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct Queries {
  const float* p0;      // (B, 3)
  const float* p1;      // (B, 3)
  const float* radius;  // (B,)
  int b;
};

struct Prune {          // NULL aabb_min: the dense query
  const float* aabb_min;   // (n_chunks, 3)
  const float* aabb_max;   // (n_chunks, 3)
  const float* max_scale;  // (n_chunks,)
  float margin;
};

struct Scene {
  const float* means;       // (N, 3)
  const float* quats;       // (N, 4)
  const float* log_scales;  // (N, 3)
  const float* logits;      // (N,) opacity logits
  int n;
  int chunk;                // Gaussians a chunk (N when dense)
};

struct Out {
  unsigned long long* state;  // (2B + 2): words, contacts, visited, ticket
  float* clear;               // (B,) BIG where none
  int64_t* idx;               // (B,) -1 where none
  int* hits;                  // (B,)
  int* visited;               // ()
  const int* ids;             // (N,) semantic ids, or NULL: no result
  unsigned char* hit;         // (B,) bool
  int* nearest;               // (B,)
  float* clipped;             // (B,) clear clipped at the margin, or NULL
};

// Can query q's capsule reach chunk c (collision._segment_aabb_gap and the
// visit test, operation for operation)?
__device__ __forceinline__ bool reaches(const Queries& qs, const Prune& pr,
                                        int q, int c, float sigma_cut) {
  const float r = qs.radius[q];
  float g2 = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float a = qs.p0[q * 3 + j], b = qs.p1[q * 3 + j];
    const float s_lo = fminf(a, b) - r;
    const float s_hi = fmaxf(a, b) + r;
    const float g = fmaxf(fmaxf(pr.aabb_min[c * 3 + j] - s_hi,
                                s_lo - pr.aabb_max[c * 3 + j]), 0.0f);
    g2 = j == 0 ? g * g : g2 + g * g;
  }
  const float reach = sigma_cut * pr.max_scale[c] + pr.margin;
  return sqrtf(g2) <= reach;
}

// Does some query reach chunk c? Block-uniform; every thread calls it. The
// block that `counts` adds the chunk to the visited count.
__device__ __forceinline__ bool chunk_reached(const Queries& qs,
                                              const Prune& pr, int c,
                                              float sigma_cut, bool counts,
                                              unsigned long long* visited) {
  if (pr.aabb_min == nullptr) return true;
  bool any = false;
  for (int q = threadIdx.x; q < qs.b && !any; q += kThreads)
    any = reaches(qs, pr, q, c, sigma_cut);
  const bool hit = __syncthreads_or(any);
  if (hit && counts && threadIdx.x == 0) atomicAdd(visited, 1ull);
  return hit;
}

// A capsule as its pair math reads it.
struct Capsule {
  float ax, ay, az, dx, dy, dz, inv_dd, r;
};

__device__ __forceinline__ Capsule capsule_of(const Queries& qs, int q) {
  Capsule c;
  c.ax = qs.p0[q * 3];
  c.ay = qs.p0[q * 3 + 1];
  c.az = qs.p0[q * 3 + 2];
  c.dx = qs.p1[q * 3] - c.ax;
  c.dy = qs.p1[q * 3 + 1] - c.ay;
  c.dz = qs.p1[q * 3 + 2] - c.az;
  const float dd = (c.dx * c.dx + c.dy * c.dy) + c.dz * c.dz;
  c.inv_dd = 1.0f / (dd > 1e-12f ? dd : 1.0f);
  c.r = qs.radius[q];
  return c;
}

// A Gaussian in its precomputed form: center, rotation R (row i, column
// j: rij), inverse scales, index.
struct Gauss {
  float mx, my, mz;
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;
  float s0, s1, s2;
  unsigned idx;
};

// A Gaussian's 44 bytes as read.
struct Raw {
  float logit, mx, my, mz, w, x, y, z, l0, l1, l2;
};

__device__ __forceinline__ Raw fetch(const Scene& sc, int64_t g) {
  Raw a;
  a.logit = __ldg(sc.logits + g);
  a.mx = __ldg(sc.means + g * 3);
  a.my = __ldg(sc.means + g * 3 + 1);
  a.mz = __ldg(sc.means + g * 3 + 2);
  a.w = __ldg(sc.quats + g * 4);
  a.x = __ldg(sc.quats + g * 4 + 1);
  a.y = __ldg(sc.quats + g * 4 + 2);
  a.z = __ldg(sc.quats + g * 4 + 3);
  a.l0 = __ldg(sc.log_scales + g * 3);
  a.l1 = __ldg(sc.log_scales + g * 3 + 1);
  a.l2 = __ldg(sc.log_scales + g * 3 + 2);
  return a;
}

// Gaussian g's solid test; fills `G` from its bytes `a` when solid.
__device__ __forceinline__ bool prepare(const Raw& a, int64_t g,
                                        float opacity_thresh, Gauss& G) {
  if (!(sigmoid(a.logit) >= opacity_thresh)) return false;
  const float mx = a.mx, my = a.my, mz = a.mz;
  float w = a.w, x = a.x, y = a.y, z = a.z;
  const float l0 = a.l0, l1 = a.l1, l2 = a.l2;
  const float den = sqrtf(((w * w + x * x) + y * y) + z * z) + 1e-12f;
  w = w / den;
  x = x / den;
  y = y / den;
  z = z / den;
  G.mx = mx;
  G.my = my;
  G.mz = mz;
  G.r00 = 1.0f - 2.0f * (y * y + z * z);
  G.r01 = 2.0f * (x * y - w * z);
  G.r02 = 2.0f * (x * z + w * y);
  G.r10 = 2.0f * (x * y + w * z);
  G.r11 = 1.0f - 2.0f * (x * x + z * z);
  G.r12 = 2.0f * (y * z - w * x);
  G.r20 = 2.0f * (x * z - w * y);
  G.r21 = 2.0f * (y * z + w * x);
  G.r22 = 1.0f - 2.0f * (x * x + y * y);
  G.s0 = expf(-l0);
  G.s1 = expf(-l1);
  G.s2 = expf(-l2);
  G.idx = (unsigned)g;
  return true;
}

// One capsule-Gaussian pair: collision._clearance's operations in order.
__device__ __forceinline__ void pair(const Capsule& c, const Gauss& G,
                                     float sigma_cut, float& clear,
                                     bool& contact) {
  const float rx = G.mx - c.ax, ry = G.my - c.ay, rz = G.mz - c.az;
  const float proj = ((rx * c.dx + ry * c.dy) + rz * c.dz) * c.inv_dd;
  const float t = fminf(fmaxf(proj, 0.0f), 1.0f);
  const float fx = rx - t * c.dx, fy = ry - t * c.dy, fz = rz - t * c.dz;
  const float dist = sqrtf(((fx * fx + fy * fy) + fz * fz) + 1e-20f);
  const float l0 = ((G.r00 * fx + G.r10 * fy) + G.r20 * fz) * G.s0;
  const float l1 = ((G.r01 * fx + G.r11 * fy) + G.r21 * fz) * G.s1;
  const float l2 = ((G.r02 * fx + G.r12 * fy) + G.r22 * fz) * G.s2;
  const float maha = sqrtf(((l0 * l0 + l1 * l1) + l2 * l2) + 1e-20f);
  const float support = (sigma_cut * dist) / fmaxf(maha, 1e-6f);
  clear = (dist - support) - c.r;
  contact = maha <= sigma_cut + (c.r * maha) / fmaxf(dist, 1e-6f);
}

// Folds one block's word and contact count of query q into the state.
__device__ __forceinline__ void fold(unsigned long long* state, int b, int q,
                                     unsigned long long word, int hits) {
  // stored complemented: the least word is the greatest ~word
  if (word != kNone && ~word > __ldcg(state + q)) atomicMax(state + q, ~word);
  if (hits) atomicAdd(state + b + q, (unsigned long long)hits);
}

// After a block's folds: the block that finishes last writes the outputs
// from the state (and the query's result when `out.ids` is set).
__device__ __forceinline__ void finish_if_last(const Queries& qs,
                                               const Out& out, float margin,
                                               bool* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long blocks =
        (unsigned long long)gridDim.x * gridDim.y;
    *s_last = atomicAdd(out.state + 2 * qs.b + 1, 1ull) == blocks - 1;
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  const float limit = out.clipped != nullptr ? margin : kBig;
  for (int q = threadIdx.x; q < qs.b; q += kThreads) {
    const unsigned long long word = ~__ldcg(out.state + q);
    const bool none = word == kNone;
    const float c = none ? kBig : unpack(word);
    const int64_t i = none ? -1 : (int64_t)(word & 0xffffffffull);
    const int h = (int)__ldcg(out.state + qs.b + q);
    out.clear[q] = c;
    out.idx[q] = i;
    out.hits[q] = h;
    if (out.ids != nullptr) {
      const float cl = out.clipped != nullptr ? fminf(c, margin) : c;
      if (out.clipped != nullptr) out.clipped[q] = cl;
      out.hit[q] = h > 0;
      out.nearest[q] = (!none && cl < limit) ? out.ids[i] : -1;
    }
  }
  if (threadIdx.x == 0) *out.visited = (int)__ldcg(out.state + 2 * qs.b);
}

template <int NQ>
__global__ void __launch_bounds__(kThreads)
capsule_few(Queries qs, Prune pr, Scene sc, int per_chunk,
            float opacity_thresh, float sigma_cut, Out out) {
  __shared__ Capsule s_cap[NQ];
  __shared__ unsigned long long s_word[kWarps][NQ];
  __shared__ int s_hits[kWarps][NQ];
  __shared__ bool s_last;
  const int c = blockIdx.x / per_chunk;
  const int sub = blockIdx.x % per_chunk;
  const bool reached = chunk_reached(qs, pr, c, sigma_cut, sub == 0,
                                     out.state + 2 * qs.b);
  if ((int)threadIdx.x < NQ && (int)threadIdx.x < qs.b)
    s_cap[threadIdx.x] = capsule_of(qs, threadIdx.x);
  __syncthreads();

  float best[NQ];
  unsigned arg[NQ];
  int hits[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    best[k] = kBig;
    arg[k] = 0;
    hits[k] = 0;
  }
  if (reached) {
    const int64_t c0 = (int64_t)c * sc.chunk;
    const int64_t c1 = min(c0 + sc.chunk, (int64_t)sc.n);
    const int64_t stride = (int64_t)per_chunk * kThreads;
    int64_t g = c0 + (int64_t)sub * kThreads + threadIdx.x;
    Raw next;
    if (g < c1) next = fetch(sc, g);
    for (; g < c1; g += stride) {
      // The next Gaussian's bytes are read while this one is worked.
      const Raw a = next;
      if (g + stride < c1) next = fetch(sc, g + stride);
      Gauss G;
      if (!prepare(a, g, opacity_thresh, G)) continue;
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        if (k < qs.b) {
          float cl;
          bool ct;
          pair(s_cap[k], G, sigma_cut, cl, ct);
          if (cl < best[k]) {   // increasing g: the first minimum stays
            best[k] = cl;
            arg[k] = G.idx;
          }
          hits[k] += ct;
        }
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const unsigned key = best[k] < kBig ? key_of(best[k]) : kFull;
    const unsigned kmin = __reduce_min_sync(kFull, key);
    const unsigned imin = __reduce_min_sync(kFull, key == kmin ? arg[k]
                                                                : kFull);
    const int h = __reduce_add_sync(kFull, hits[k]);
    if (lane == 0) {
      s_word[warp][k] = kmin == kFull
                            ? kNone
                            : ((unsigned long long)kmin << 32) | imin;
      s_hits[warp][k] = h;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < NQ && (int)threadIdx.x < qs.b) {
    const int k = threadIdx.x;
    unsigned long long word = kNone;
    int h = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      word = s_word[w][k] < word ? s_word[w][k] : word;
      h += s_hits[w][k];
    }
    fold(out.state, qs.b, k, word, h);
  }
  finish_if_last(qs, out, pr.margin, &s_last);
}

__global__ void __launch_bounds__(kThreads)
capsule_many(Queries qs, Prune pr, Scene sc, int per_chunk,
             float opacity_thresh, float sigma_cut, Out out) {
  __shared__ float4 s_g[4][kThreads];   // the stage: 16 floats a Gaussian
  __shared__ int s_count[kWarps];
  __shared__ unsigned long long s_word[kThreads];
  __shared__ int s_hits[kThreads];
  __shared__ bool s_last;
  const int c = blockIdx.x / per_chunk;
  const int sub = blockIdx.x % per_chunk;
  const bool reached = chunk_reached(qs, pr, c, sigma_cut,
                                     sub == 0 && blockIdx.y == 0,
                                     out.state + 2 * qs.b);
  // The block's queries: 256 from blockIdx.y * 256, fewer in the last
  // tile. Thread t: query (t mod tile) of them, tile the least power of
  // two that holds them, and Gaussian lane (t / tile) of n_lanes; a lane
  // walks the stage's j = lane, lane + n_lanes, ... (a warp reads one
  // Gaussian when the tile is >= 32).
  const int nq = min(kThreads, qs.b - (int)blockIdx.y * kThreads);
  const int tile_log2 = nq > 1 ? 32 - __clz(nq - 1) : 0;
  const int tile = 1 << tile_log2;
  const int ql = threadIdx.x & (tile - 1);
  const int my_lane = threadIdx.x >> tile_log2;
  const int n_lanes = kThreads >> tile_log2;
  const int q = blockIdx.y * kThreads + ql;
  const bool active = ql < nq;
  const Capsule cap = capsule_of(qs, active ? q : 0);

  float best = kBig;
  unsigned arg = 0;
  int hits = 0;
  if (reached) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t c0 = (int64_t)c * sc.chunk;
    const int64_t c1 = min(c0 + sc.chunk, (int64_t)sc.n);
    const int64_t stride = (int64_t)per_chunk * kThreads;
    for (int64_t base = c0 + (int64_t)sub * kThreads; base < c1;
         base += stride) {
      const int64_t g = base + threadIdx.x;
      Gauss G;
      const bool solid = g < c1 && prepare(fetch(sc, g), g, opacity_thresh,
                                           G);
      const unsigned m = __ballot_sync(kFull, solid);
      __syncthreads();                  // the previous stage has been read
      if (lane == 0) s_count[warp] = __popc(m);
      __syncthreads();
      int off = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int n_w = s_count[w];
        off += w < warp ? n_w : 0;
        total += n_w;
      }
      if (solid) {                      // compacted, in index order
        const int j = off + __popc(m & ((1u << lane) - 1u));
        s_g[0][j] = make_float4(G.mx, G.my, G.mz, G.r00);
        s_g[1][j] = make_float4(G.r01, G.r02, G.r10, G.r11);
        s_g[2][j] = make_float4(G.r12, G.r20, G.r21, G.r22);
        s_g[3][j] = make_float4(G.s0, G.s1, G.s2, __uint_as_float(G.idx));
      }
      __syncthreads();
      if (active) {
        for (int j = my_lane; j < total; j += n_lanes) {
          const float4 a = s_g[0][j], b = s_g[1][j], e = s_g[2][j],
                       f = s_g[3][j];
          Gauss H;
          H.mx = a.x; H.my = a.y; H.mz = a.z; H.r00 = a.w;
          H.r01 = b.x; H.r02 = b.y; H.r10 = b.z; H.r11 = b.w;
          H.r12 = e.x; H.r20 = e.y; H.r21 = e.z; H.r22 = e.w;
          H.s0 = f.x; H.s1 = f.y; H.s2 = f.z; H.idx = __float_as_uint(f.w);
          float cl;
          bool ct;
          pair(cap, H, sigma_cut, cl, ct);
          if (cl < best) {              // increasing j: the first minimum
            best = cl;
            arg = H.idx;
          }
          hits += ct;
        }
      }
    }
  }

  s_word[threadIdx.x] = best < kBig ? pack(best, arg) : kNone;
  s_hits[threadIdx.x] = hits;
  __syncthreads();
  if ((int)threadIdx.x < tile && active) {
    unsigned long long word = kNone;
    int h = 0;
    for (int l = 0; l < n_lanes; ++l) {
      const unsigned long long w = s_word[l * tile + threadIdx.x];
      word = w < word ? w : word;
      h += s_hits[l * tile + threadIdx.x];
    }
    fold(out.state, qs.b, q, word, h);
  }
  finish_if_last(qs, out, pr.margin, &s_last);
}

__global__ void sigmoid_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = sigmoid(x[i]);
}

// Blocks of `kernel` resident on the current device at once (cached per
// device).
int resident_blocks(const void* kernel, int slot) {
  static int cache[8][64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int& v = cache[slot][dev];
  if (v == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    v = sms * (per_sm > 0 ? per_sm : 1);
  }
  return v;
}

}  // namespace

// K6 over the queries (p0, p1: (b, 3) float32; radius: (b,) float32) and
// the Gaussians (means (n, 3), quats
// (n, 4), log_scales (n, 3), opacity logits (n,), float32). Dense: aabb_min
// NULL, the whole scene one chunk. Pruned: chunks of `chunk` Gaussians with
// their bounds (n_chunks = ceil(n / chunk)). b > kFewMax takes
// capsule_many, else capsule_few. `state` is (2b + 2)
// 64-bit words of scratch, zeroed here. Outputs: the least clearance (BIG
// where no solid Gaussian), its first index (-1 for none) as int64, the
// contact count as int32, the visited chunks as one int32; with `ids`
// (int32 (n,)) also hit (bool), nearest_id (int32) and, when pruned,
// `clipped`, the clearance clipped at `margin`. Returns the first failing
// call's cudaError_t.
extern "C" int sage3d_capsule_query(
    const void* p0, const void* p1, const void* radius, int b,
    const void* means, const void* quats, const void* log_scales,
    const void* logits, int n, int chunk, const void* aabb_min,
    const void* aabb_max, const void* max_scale, float margin,
    float opacity_thresh, float sigma_cut, const void* ids,
    void* state, void* clear, void* idx, void* hits, void* visited, void* hit,
    void* nearest, void* clipped, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 0) return (int)cudaMemsetAsync(visited, 0, sizeof(int), s);
  const bool pruned = aabb_min != nullptr;
  if (n < 0 || (pruned && (n == 0 || chunk <= 0)))
    return (int)cudaErrorInvalidValue;
  if (!pruned) chunk = n > 0 ? n : 1;
  cudaError_t err = cudaMemsetAsync(
      state, 0, (size_t)(2 * b + 2) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;

  const Queries qs{(const float*)p0, (const float*)p1, (const float*)radius,
                   b};
  const Prune pr{(const float*)aabb_min, (const float*)aabb_max,
                 (const float*)max_scale, margin};
  const Scene sc{(const float*)means, (const float*)quats,
                 (const float*)log_scales, (const float*)logits, n, chunk};
  const Out out{(unsigned long long*)state, (float*)clear, (int64_t*)idx,
                (int*)hits, (int*)visited, (const int*)ids,
                (unsigned char*)hit, (int*)nearest,
                pruned ? (float*)clipped : nullptr};
  const long long n_chunks = pruned ? ((long long)n + chunk - 1) / chunk : 1;
  const long long stages = ((long long)chunk + kThreads - 1) / kThreads;
  const bool many = b > kFewMax;
  const int tiles = many ? (b + kThreads - 1) / kThreads : 1;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;

  const void* kernel =
      many ? (const void*)capsule_many
           : b == 1 ? (const void*)capsule_few<1>
                    : b == 2 ? (const void*)capsule_few<2>
                             : (const void*)capsule_few<4>;
  const int slot = many ? 0 : b == 1 ? 1 : b == 2 ? 2 : 3;
  const long long resident =
      (long long)resident_blocks(kernel, slot) * (many ? kManyWaves : 1);
  if (resident <= 0) return (int)cudaErrorInvalidDevice;
  // Each chunk's stages go to per_chunk blocks, enough (with the query
  // tiles) to fill the card once (capsule_few) or kManyWaves times
  // (capsule_many); a chunk never takes more blocks than it has stages.
  long long per_chunk = (resident + tiles - 1) / tiles;
  if (per_chunk > stages) per_chunk = stages;
  if (per_chunk < 1) per_chunk = 1;
  const long long blocks = n_chunks * per_chunk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)tiles);
  if (many)
    capsule_many<<<grid, kThreads, 0, s>>>(qs, pr, sc, (int)per_chunk,
                                           opacity_thresh, sigma_cut, out);
  else if (b == 1)
    capsule_few<1><<<grid, kThreads, 0, s>>>(qs, pr, sc, (int)per_chunk,
                                             opacity_thresh, sigma_cut, out);
  else if (b == 2)
    capsule_few<2><<<grid, kThreads, 0, s>>>(qs, pr, sc, (int)per_chunk,
                                             opacity_thresh, sigma_cut, out);
  else
    capsule_few<4><<<grid, kThreads, 0, s>>>(qs, pr, sc, (int)per_chunk,
                                             opacity_thresh, sigma_cut, out);
  return (int)cudaGetLastError();
}

// capsule_few's and capsule_many's solid-test sigmoid over n float32
// logits, for the gate that holds it to torch.sigmoid bitwise.
extern "C" int sage3d_capsule_sigmoid(const void* x, void* y, int n,
                                      void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  sigmoid_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}
