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
// What bounds it on an H100: bytes. Every row is read once and every output
// written once; the arithmetic is one add per payload value. Design: two
// kernels in one launch sequence. The first marks each in-range segment's
// [begin, end) (a thread per row compares its id with its neighbours; the
// arrays are zeroed by the caller, so an absent id is an empty segment). The
// second gives each output id one warp: lane l sums rows begin+l, begin+l+32,
// ... in order, then the 32 lane partials are summed by an xor butterfly.
// The TPU kernel's 256-id blocks and one-hot matmul existed because the TPU
// has no fast scatter; neither is carried over.
//
// Exact and deterministic: plain f32 adds, no tensor cores (so no TF32), no
// atomics. The order of the adds depends only on a row's place inside its
// segment, never on where the segment starts, and rows with an out-of-range
// id (the unfilled slots of an oversized gradient buffer) are never read, so
// they leave every sum bitwise unchanged. Butterfly levels that would only
// add lanes holding zero are skipped: x + 0 == x, so the sums are the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPayload = 15;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;  // rows per lane loaded together
constexpr unsigned kFull = 0xffffffffu;

__global__ void segment_bounds_kernel(const int32_t* __restrict__ ids,
                                      int64_t n_rows, int n_out,
                                      int32_t* __restrict__ begin,
                                      int32_t* __restrict__ end) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int g = ids[r];
  if (r > 0 && ids[r - 1] > g) __trap();  // ids must ascend
  if (g < 0 || g >= n_out) return;
  if (r == 0 || ids[r - 1] != g) begin[g] = (int32_t)r;
  if (r == n_rows - 1 || ids[r + 1] != g) end[g] = (int32_t)(r + 1);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_kernel(const int32_t* __restrict__ begin,
                   const int32_t* __restrict__ end,
                   const int64_t* __restrict__ perm,
                   const float* __restrict__ rows, int64_t row_stride,
                   int64_t n_src_rows, int n_payload, int n_out,
                   float* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= n_out) return;  // the whole warp leaves together
  const int b = begin[g];
  const int e = end[g];
  float acc[kMaxPayload];
#pragma unroll
  for (int c = 0; c < kMaxPayload; ++c) acc[c] = 0.0f;
  // A lane's terms are added in order; kUnroll of them are loaded at once so
  // a long segment keeps several loads in flight per lane.
  int r = b + lane;
  for (; r + 32 * (kUnroll - 1) < e; r += 32 * kUnroll) {
    float x[kUnroll][kMaxPayload];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r + 32 * u;
      const int64_t src = perm != nullptr ? perm[ru] : (int64_t)ru;
      if (src < 0 || src >= n_src_rows) __trap();
      const float* row = rows + src * row_stride;
#pragma unroll
      for (int c = 0; c < kMaxPayload; ++c)
        x[u][c] = c < n_payload ? row[c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kMaxPayload; ++c)
        if (c < n_payload) acc[c] += x[u][c];
  }
  for (; r < e; r += 32) {
    const int64_t src = perm != nullptr ? perm[r] : (int64_t)r;
    if (src < 0 || src >= n_src_rows) __trap();
    const float* row = rows + src * row_stride;
#pragma unroll
    for (int c = 0; c < kMaxPayload; ++c)
      if (c < n_payload) acc[c] += row[c];
  }
  // Lanes at or past the segment's length hold exact zeros; start the
  // butterfly at the first level that adds a lane that may not.
  const int len = e - b;
  int off = 16;
  while (off > 0 && off >= len) off >>= 1;
  for (; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < kMaxPayload; ++c)
      if (c < n_payload) acc[c] += __shfl_xor_sync(kFull, acc[c], off);
  }
  if (lane == 0) {
    float* o = out + g * n_payload;
#pragma unroll
    for (int c = 0; c < kMaxPayload; ++c)
      if (c < n_payload) o[c] = acc[c];
  }
}

}  // namespace

extern "C" int sage3d_segment_reduce(const void* ids, const void* perm,
                                     const void* rows, void* begin, void* end,
                                     void* out, long long n_rows,
                                     long long n_src_rows,
                                     long long row_stride, int n_payload,
                                     int n_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_payload < 1 || n_payload > kMaxPayload) return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    const int threads = 256;
    const long long blocks = (n_rows + threads - 1) / threads;
    segment_bounds_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const int32_t*)ids, (int64_t)n_rows, n_out, (int32_t*)begin,
        (int32_t*)end);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_out > 0) {
    const long long blocks = ((long long)n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
    segment_sum_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const int32_t*)begin, (const int32_t*)end, (const int64_t*)perm,
        (const float*)rows, (int64_t)row_stride, (int64_t)n_src_rows,
        n_payload, n_out, (float*)out);
  }
  return (int)cudaGetLastError();
}
