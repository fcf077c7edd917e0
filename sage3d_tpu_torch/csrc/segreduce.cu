// K4: segment sum of id-sorted rows, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sage3d_tpu/ops/segreduce.py::_seg_kernel
// (pallas_call in _get_seg_call). Input: ids (P,) int32 in ascending order and
// P payload rows of n_payload <= 15 float32 channels, read either directly
// (row r) or through a permutation (row perm[r], the sort's indices, so the
// rows need not be gathered into a sorted copy first). Output:
// out[g, ch] = sum of the payload of the rows whose id is g, for g in
// [0, n_out); rows with an id outside that range add nothing.
//
// What bounds it on an H100: bytes in principle (every row read once, every
// output written once, one add per payload value), in practice the latency of
// dependent loads (id, sort index, payload row). At the 1080p frame of the 1M
// room the backward's 0.78M rows fall in only ~4.9k segments, ~3.8k of them
// longer than 32 rows (up to ~1.1k), and ~995k of the 1M ids own no row, so
// a warp per output id would spend 1M warps finding nothing. Design: work
// follows the rows. One lane per sorted row, in blocks of 64 threads; the
// lane at the first row of an in-range segment (its head) owns the segment.
//   - Short segments (at most kShort = 32 rows) are summed by their head
//     alone, serially in row order.
//   - Longer segments are announced to the head's warp with __ballot_sync and
//     summed by the whole warp: lane l adds rows begin+l, begin+l+32, ... in
//     order, then an xor butterfly adds the 32 lane partials.
//   - Every walk loads its next kUnroll rows' ids and sort indices while
//     the current rows' payload loads (sum_rows). Registers decide how many
//     walks wait at once, and that decides the time: at the 1080p frame of
//     the 1M room on an H100, 2 rows in flight took 0.073 ms with the
//     memset, 4 took 0.081, and 8, or fewer threads each walking many
//     windows of 32 rows, 0.098-0.126.
//   - Ids no row names are zero: the entry point clears the output with one
//     cudaMemsetAsync first, at full write bandwidth. Heads writing the zeros
//     of the ids between theirs were not taken: with ~995k absent ids among
//     ~4.9k present ones, a head would write ~200 ids on average, one thread
//     alone, and the widest gap far more.
//   - The backward's rows (ten channels at a stride of whole float4, in all
//     three gradient-sort modes) are read as two float4 and one float2
//     loads; other widths and strides take scalar loads.
// No bounds arrays, no per-output-id threads.
//
// Exact and deterministic: plain f32 adds, no tensor cores (so no TF32), no
// atomics. The order of the adds depends only on a row's place inside its
// segment and the segment's length, never on where the segment starts, and
// rows with an out-of-range id (the unfilled slots of an oversized gradient
// buffer) are never read, so they leave every sum bitwise unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPayload = 15;
constexpr int kVecPayload = 10;  // the backward's channels: the float4 path
constexpr int kShort = 32;   // the longest segment its head sums alone
constexpr int kThreads = 64;  // two windows of 32 rows a block
constexpr int kUnroll = 2;    // rows of one walk loaded together
constexpr unsigned kFull = 0xffffffffu;

// Row `src` of the payload, columns 0..kNp-1 (zeros past n_payload). kVec:
// the backward's ten channels as two float4 and one float2 (the entry point
// checked the alignment and the stride), exactly the row's ten columns.
template <bool kVec, int kNp>
__device__ __forceinline__ void load_row(const float* __restrict__ rows,
                                         int64_t src, int64_t row_stride,
                                         int n_payload, float (&x)[kNp]) {
  const float* row = rows + src * row_stride;
  if constexpr (kVec) {
    static_assert(kNp == kVecPayload, "the float4 path reads ten columns");
    const float4 a = reinterpret_cast<const float4*>(row)[0];
    const float4 b = reinterpret_cast<const float4*>(row)[1];
    const float2 c = reinterpret_cast<const float2*>(row)[4];
    const float v[kVecPayload] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                  c.x, c.y};
#pragma unroll
    for (int ch = 0; ch < kNp; ++ch) x[ch] = v[ch];
  } else {
#pragma unroll
    for (int ch = 0; ch < kNp; ++ch)
      x[ch] = ch < n_payload ? row[ch] : 0.0f;
  }
}

// acc += the rows first, first + step, first + 2 step, ... that carry the id
// g, in that order. ids ascend, so those rows are a prefix of the walk. The
// rows go kUnroll at a time, and the ids and sort indices of the next group
// load while this group's payload loads, so a walk of n rows waits for about
// n / kUnroll round trips to memory. Rows past the walk are never read.
template <bool kVec, int kNp>
__device__ __forceinline__ void sum_rows(float (&acc)[kNp],
                                         const int32_t* __restrict__ ids,
                                         const int64_t* __restrict__ perm,
                                         const float* __restrict__ rows,
                                         int64_t first, int64_t step, int g,
                                         int64_t n_rows, int64_t n_src_rows,
                                         int64_t row_stride, int n_payload) {
  int nid[kUnroll];
  int64_t nsrc[kUnroll];
  auto fetch = [&](int64_t i0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * step;
      const bool in = i < n_rows;
      nid[u] = in ? ids[i] : -1;
      nsrc[u] = in ? (perm != nullptr ? perm[i] : i) : 0;
    }
  };
  fetch(first);
  for (int64_t i0 = first;; i0 += kUnroll * step) {
    int n = 0;
    int64_t src[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      n += nid[u] == g ? 1 : 0;
      src[u] = nsrc[u];
    }
    if (n == kUnroll) fetch(i0 + kUnroll * step);
    float x[kUnroll][kNp];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < n) {
        if (src[u] < 0 || src[u] >= n_src_rows) __trap();
        load_row<kVec, kNp>(rows, src[u], row_stride, n_payload, x[u]);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < n) {
#pragma unroll
        for (int ch = 0; ch < kNp; ++ch)
          if (ch < n_payload) acc[ch] += x[u][ch];
      }
    if (n < kUnroll) return;
  }
}

template <bool kVec, int kNp>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ ids,
                   const int64_t* __restrict__ perm,
                   const float* __restrict__ rows, int64_t row_stride,
                   int64_t n_rows, int64_t n_src_rows, int n_payload,
                   int n_out, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  // No lane leaves before the warp's ballot below.
  const int g = r < n_rows ? ids[r] : 0;
  int prev = __shfl_up_sync(kFull, g, 1);
  if (lane == 0) prev = (r > 0 && r < n_rows) ? ids[r - 1] : 0;
  bool head = false;
  if (r < n_rows) {
    if (r > 0 && prev > g) __trap();  // ids must ascend
    head = g >= 0 && g < n_out && (r == 0 || prev != g);
  }
  // ids ascend, so the segment has more than kShort rows iff row r + kShort
  // still carries its id.
  const bool is_long = head && r + kShort < n_rows && ids[r + kShort] == g;

  float acc[kNp];
  if (head && !is_long) {
#pragma unroll
    for (int ch = 0; ch < kNp; ++ch) acc[ch] = 0.0f;
    sum_rows<kVec, kNp>(acc, ids, perm, rows, r, 1, g, n_rows, n_src_rows,
                        row_stride, n_payload);
    float* o = out + (int64_t)g * n_payload;
#pragma unroll
    for (int ch = 0; ch < kNp; ++ch)
      if (ch < n_payload) o[ch] = acc[ch];
  }

  // Long segments: the whole warp sums each one its lanes announce, lane l
  // the rows begin + l, begin + l + 32, ...; then the 32 lane partials by an
  // xor butterfly (more than 32 rows: every lane holds at least one term).
  unsigned todo = __ballot_sync(kFull, is_long);
  while (todo) {
    const int src_lane = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t b = __shfl_sync(kFull, r, src_lane);
    const int sg = __shfl_sync(kFull, g, src_lane);
#pragma unroll
    for (int ch = 0; ch < kNp; ++ch) acc[ch] = 0.0f;
    sum_rows<kVec, kNp>(acc, ids, perm, rows, b + lane, 32, sg, n_rows,
                        n_src_rows, row_stride, n_payload);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int ch = 0; ch < kNp; ++ch)
        if (ch < n_payload) acc[ch] += __shfl_xor_sync(kFull, acc[ch], off);
    }
    if (lane == 0) {
      float* o = out + (int64_t)sg * n_payload;
#pragma unroll
      for (int ch = 0; ch < kNp; ++ch)
        if (ch < n_payload) o[ch] = acc[ch];
    }
  }
}

template <bool kVec, int kNp>
void launch(const void* ids, const void* perm, const void* rows, void* out,
            long long n_rows, long long n_src_rows, long long row_stride,
            int n_payload, int n_out, cudaStream_t s) {
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  segment_sum_kernel<kVec, kNp><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)ids, (const int64_t*)perm, (const float*)rows,
      (int64_t)row_stride, (int64_t)n_rows, (int64_t)n_src_rows, n_payload,
      n_out, (float*)out);
}

}  // namespace

extern "C" int sage3d_segment_reduce(const void* ids, const void* perm,
                                     const void* rows, void* out,
                                     long long n_rows, long long n_src_rows,
                                     long long row_stride, int n_payload,
                                     int n_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_payload < 1 || n_payload > kMaxPayload) return (int)cudaErrorInvalidValue;
  if (n_out <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)n_out * (size_t)n_payload * sizeof(float), s);
  if (err != cudaSuccess || n_rows <= 0) return (int)err;
  // The backward's rows (ten channels, 16-byte aligned, a stride of whole
  // float4) take the vector loads; every other layout the scalar ones.
  if (n_payload == kVecPayload && row_stride % 4 == 0 &&
      ((uintptr_t)rows & 15) == 0)
    launch<true, kVecPayload>(ids, perm, rows, out, n_rows, n_src_rows,
                              row_stride, n_payload, n_out, s);
  else
    launch<false, kMaxPayload>(ids, perm, rows, out, n_rows, n_src_rows,
                               row_stride, n_payload, n_out, s);
  return (int)cudaGetLastError();
}
