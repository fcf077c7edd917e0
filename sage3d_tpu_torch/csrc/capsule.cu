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
// visited chunks are counted, all on the device (no host sync).
//
// The reduction has no float atomics. A clearance is packed into an
// order-preserving 32-bit key (the f32 bits, -0.0 made +0.0, the sign bit
// flipped for positives and all bits for negatives) above the 32-bit
// Gaussian index: the least 64-bit word is the least clearance and, on a
// tie, the smallest index, which is jnp.argmin's first occurrence and the
// scan's strict-less merge. Only clearances below BIG compete (the scan
// starts at BIG and replaces only a strictly smaller value). The words are
// stored complemented, so a zero-filled state means "no Gaussian" and the
// minimum is an atomicMax; contacts are integer atomicAdds. The result is
// deterministic.
//
// What bounds it on an H100: the scene's 44 bytes a Gaussian (means, quats,
// log-scales, opacity) are read once, 13 us at 1M; the pair arithmetic
// (~60 f32 operations with two IEEE divisions and two sqrtf, none an FMA,
// for each of the ~0.69M solid Gaussians of the 1M room) is ~0.08 ms at 64
// queries at the non-FMA rate. Design:
//   - One thread per Gaussian, 256 a block, blocks tiling each chunk (the
//     dense query is one chunk of N). The Gaussian's rotation (normalised
//     quaternion), exp(-log_scales) and solid test are computed once, in
//     registers; non-solid Gaussians skip the pair math.
//   - The queries' endpoints and 1/|d|^2 sit in shared memory, 256 at a
//     time; each thread loops over them.
//   - Per query, a warp ballot skips the warp when no lane beats the
//     block's current minimum (read from shared memory); otherwise an xor
//     butterfly finds the warp's least word, and lane 0 folds it into the
//     block's with a shared atomicMin. Contacts: ballot + popc.
//   - At the end of a query tile, one global atomic per query and block,
//     only where the block improved on the global word.
//   - Pruned: each block first tests its chunk against every query's
//     segment AABB and returns at once when none reaches it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // Gaussians a block, queries a tile
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;      // collision.BIG: "no solid Gaussian"
constexpr unsigned long long kNone = ~0ull;

// The order-preserving key of a clearance (see the header).
__device__ __forceinline__ unsigned long long pack(float c, unsigned idx) {
  unsigned bits = __float_as_uint(c == 0.0f ? 0.0f : c);
  bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((unsigned long long)bits << 32) | idx;
}

__device__ __forceinline__ float unpack(unsigned long long word) {
  unsigned bits = (unsigned)(word >> 32);
  bits = (bits & 0x80000000u) ? (bits & 0x7fffffffu) : ~bits;
  return __uint_as_float(bits);
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

__global__ void __launch_bounds__(kThreads)
capsule_kernel(Queries qs, Prune pr, const float* __restrict__ means,
               const float* __restrict__ quats,
               const float* __restrict__ log_scales,
               const float* __restrict__ opac, int n, int chunk,
               int blocks_per_chunk, float opacity_thresh, float sigma_cut,
               unsigned long long* __restrict__ state) {
  __shared__ float s_q[8][kThreads];   // p0 xyz, d xyz, 1/dd, r
  __shared__ unsigned long long s_word[kThreads];
  __shared__ int s_hits[kThreads];
  const int c = blockIdx.x / blocks_per_chunk;
  const int sub = blockIdx.x % blocks_per_chunk;
  const int64_t chunk_end = min((int64_t)(c + 1) * chunk, (int64_t)n);
  const int64_t g = (int64_t)c * chunk + (int64_t)sub * kThreads + threadIdx.x;
  const bool valid = g < chunk_end;

  if (pr.aabb_min != nullptr) {
    bool any = false;
    for (int q = threadIdx.x; q < qs.b && !any; q += kThreads)
      any = reaches(qs, pr, q, c, sigma_cut);
    if (!__syncthreads_or(any)) return;
    if (sub == 0 && threadIdx.x == 0) atomicAdd(&state[2 * qs.b], 1ull);
  }

  // The Gaussian, once: center, rotation columns, inverse scales.
  bool solid = false;
  float mx = 0, my = 0, mz = 0, R[3][3], inv_s[3];
  if (valid) {
    solid = opac[g] >= opacity_thresh;
    mx = means[g * 3];
    my = means[g * 3 + 1];
    mz = means[g * 3 + 2];
    float w = quats[g * 4], x = quats[g * 4 + 1], y = quats[g * 4 + 2],
          z = quats[g * 4 + 3];
    const float den = sqrtf(((w * w + x * x) + y * y) + z * z) + 1e-12f;
    w = w / den;
    x = x / den;
    y = y / den;
    z = z / den;
    R[0][0] = 1.0f - 2.0f * (y * y + z * z);
    R[0][1] = 2.0f * (x * y - w * z);
    R[0][2] = 2.0f * (x * z + w * y);
    R[1][0] = 2.0f * (x * y + w * z);
    R[1][1] = 1.0f - 2.0f * (x * x + z * z);
    R[1][2] = 2.0f * (y * z - w * x);
    R[2][0] = 2.0f * (x * z - w * y);
    R[2][1] = 2.0f * (y * z + w * x);
    R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
    for (int j = 0; j < 3; ++j) inv_s[j] = expf(-log_scales[g * 3 + j]);
  }
  const unsigned lane = threadIdx.x & 31;

  for (int q0 = 0; q0 < qs.b; q0 += kThreads) {
    const int nq = min(kThreads, qs.b - q0);
    __syncthreads();   // the previous tile's shared state has been read
    if ((int)threadIdx.x < nq) {
      const int q = q0 + threadIdx.x;
      const float ax = qs.p0[q * 3], ay = qs.p0[q * 3 + 1],
                  az = qs.p0[q * 3 + 2];
      const float dx = qs.p1[q * 3] - ax, dy = qs.p1[q * 3 + 1] - ay,
                  dz = qs.p1[q * 3 + 2] - az;
      const float dd = (dx * dx + dy * dy) + dz * dz;
      s_q[0][threadIdx.x] = ax;
      s_q[1][threadIdx.x] = ay;
      s_q[2][threadIdx.x] = az;
      s_q[3][threadIdx.x] = dx;
      s_q[4][threadIdx.x] = dy;
      s_q[5][threadIdx.x] = dz;
      s_q[6][threadIdx.x] = 1.0f / (dd > 1e-12f ? dd : 1.0f);
      s_q[7][threadIdx.x] = qs.radius[q];
      s_word[threadIdx.x] = kNone;
      s_hits[threadIdx.x] = 0;
    }
    __syncthreads();
    for (int k = 0; k < nq; ++k) {
      unsigned long long word = kNone;
      bool contact = false;
      if (solid) {
        const float dx = s_q[3][k], dy = s_q[4][k], dz = s_q[5][k];
        const float r = s_q[7][k];
        const float rx = mx - s_q[0][k], ry = my - s_q[1][k],
                    rz = mz - s_q[2][k];
        const float proj = ((rx * dx + ry * dy) + rz * dz) * s_q[6][k];
        const float t = fminf(fmaxf(proj, 0.0f), 1.0f);
        const float fx = rx - t * dx, fy = ry - t * dy, fz = rz - t * dz;
        const float dist = sqrtf(((fx * fx + fy * fy) + fz * fz) + 1e-20f);
        float m2 = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float loc = ((R[0][j] * fx + R[1][j] * fy) + R[2][j] * fz)
                            * inv_s[j];
          m2 = j == 0 ? loc * loc : m2 + loc * loc;
        }
        const float maha = sqrtf(m2 + 1e-20f);
        const float support = (sigma_cut * dist) / fmaxf(maha, 1e-6f);
        const float clear = (dist - support) - r;
        contact = maha <= sigma_cut + (r * maha) / fmaxf(dist, 1e-6f);
        if (clear < kBig) word = pack(clear, (unsigned)g);
      }
      const unsigned hit_mask = __ballot_sync(kFull, contact);
      if (hit_mask && lane == 0) atomicAdd(&s_hits[k], __popc(hit_mask));
      if (__ballot_sync(kFull, word < s_word[k])) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(kFull, word, off);
          word = o < word ? o : word;
        }
        if (lane == 0) atomicMin(&s_word[k], word);
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < nq) {
      const int q = q0 + threadIdx.x;
      const unsigned long long best = s_word[threadIdx.x];
      // stored complemented: the least word is the greatest ~word
      if (best != kNone && ~best > state[q]) atomicMax(&state[q], ~best);
      if (s_hits[threadIdx.x])
        atomicAdd(&state[qs.b + q], (unsigned long long)s_hits[threadIdx.x]);
    }
  }
}

__global__ void finish_kernel(const unsigned long long* __restrict__ state,
                              int b, float* __restrict__ clear,
                              int64_t* __restrict__ idx,
                              int* __restrict__ hits,
                              int* __restrict__ visited) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q == 0) *visited = (int)state[2 * b];
  if (q >= b) return;
  const unsigned long long word = ~state[q];
  clear[q] = word == kNone ? kBig : unpack(word);
  idx[q] = word == kNone ? -1 : (int64_t)(word & 0xffffffffull);
  hits[q] = (int)state[b + q];
}

}  // namespace

// K6 over the queries (p0, p1, radius: (b, 3), (b, 3), (b,) float32) and
// the Gaussians (means (n, 3), quats (n, 4), log_scales (n, 3), opacities
// (n,), float32). Dense: aabb_min NULL, the whole scene one chunk. Pruned:
// chunks of `chunk` Gaussians with their bounds (n_chunks = ceil(n / chunk)).
// `state` is (2b + 1) zeroed 64-bit words of scratch. Outputs: the least
// clearance (BIG where no solid Gaussian), its first index (-1 for none) as
// int64, the contact count as int32, and the visited chunks as one int32.
// Returns the first failing launch's cudaError_t.
extern "C" int sage3d_capsule_query(
    const void* p0, const void* p1, const void* radius, int b,
    const void* means, const void* quats, const void* log_scales,
    const void* opac, int n, int chunk, const void* aabb_min,
    const void* aabb_max, const void* max_scale, float margin,
    float opacity_thresh, float sigma_cut, void* state, void* clear,
    void* idx, void* hits, void* visited, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 0) return (int)cudaSuccess;
  if (n > 0) {
    if (chunk <= 0) return (int)cudaErrorInvalidValue;
    const long long n_chunks = ((long long)n + chunk - 1) / chunk;
    const int per_chunk = (chunk + kThreads - 1) / kThreads;
    const long long blocks = n_chunks * per_chunk;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const Queries qs{(const float*)p0, (const float*)p1,
                     (const float*)radius, b};
    const Prune pr{(const float*)aabb_min, (const float*)aabb_max,
                   (const float*)max_scale, margin};
    capsule_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        qs, pr, (const float*)means, (const float*)quats,
        (const float*)log_scales, (const float*)opac, n, chunk, per_chunk,
        opacity_thresh, sigma_cut, (unsigned long long*)state);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  finish_kernel<<<(b + 127) / 128, 128, 0, s>>>(
      (const unsigned long long*)state, b, (float*)clear, (int64_t*)idx,
      (int*)hits, (int*)visited);
  return (int)cudaGetLastError();
}
