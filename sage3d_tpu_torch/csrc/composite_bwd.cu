// K3: backward tile compositor, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sage3d_tpu/ops/composite_pallas.py::_bwd_kernel
// (pallas_call in bwd_call). For each 32x32 tile it sweeps the tile's
// depth-ordered pairs once, front to back, over the first allowed[t] chunks
// (the forward's k_end, clipped to the gradient buffer). Per pixel and pair it
// replays the forward (alpha, w = alpha * T, T *= 1 - alpha) and forms
//   c      = sum_ch g_ch * feat_ch + g_alpha
//   dalpha = c * T_before - (S_pix + g_T * T_final - prefix_incl(c * w))
//            / (1 - alpha),                  S_pix = sum_ch g_ch * fwd_acc_ch,
// zeroed where alpha == 0 or raw > 0.99. The suffix sums a back-to-front
// sweep would carry come from S_pix minus the running prefix, so the sweep
// runs in the forward's order. Per pair it sums ten channels over the tile's
// 1024 pixels: the conic a/b/c and mean x/y gradients from dpower =
// dalpha * alpha, the opacity gradient sum(dpower) / op, and g_ch * w for
// r, g, b and depth. Row (chunk0[t] + k) * 128 + i of the slot buffer gets
// those ten values and the pair's Gaussian id (its table row, read from
// pair_gauss), exact in two floats: id mod 2^24 in column 11 and id >> 24
// in column 10 (0 below 2^24 rows, as the JAX package's single float id).
// The caller fills the buffer with zero payload and the out-of-range id
// n_gauss, which rows of lanes past a chunk's last pair and of slots past the
// tile's allowed chunks keep: the sort puts them last and the segment sum
// skips them.
// A batch of cameras is one launch over B * cam_tiles camera-major tiles and
// an attribute table of B * N rows, as in K2: the tile's pixel origin comes
// from its index within its camera, and chunk0 places each camera's slots
// (the caller starts camera b's at its own base).
//
// Segments: a frame of few long walks (a mesh rank's 224-row band: 252
// tiles of up to ~500 chunks, under half of one wave of 4 blocks on 132
// SMs) is bounded by its longest walk with a block a tile. So a block walks
// one segment of a tile, chunks s * seg up to (s + 1) * seg of the tile's
// allowed[t], and writes only those chunks' slot rows; every segment still
// covers the tile's 1024 pixels, so each pair's sums form in one block, with
// no atomics. A block's (tile, segment) comes from a work list that a
// one-block kernel builds on the card first (segment_list_kernel: an
// exclusive scan of ceil(allowed[t] / seg) over the tiles), so the launch is
// n_items blocks, an upper bound the caller takes from host-known sizes, and
// blocks past the list's end exit at once; no host read. Segment 0 starts
// from T = 1 and an empty prefix. Segment s > 0 starts from K2's checkpoint
// of chunk s * seg (composite_fwd.cu): T is K2's T there, bit for bit, so
// the replayed alpha, w, T and stop stay the single sweep's; the running
// prefix of c * w starts as
//   g_r acc_r + g_g acc_g + g_b acc_b + g_depth acc_depth + g_alpha acc_alpha
// of K2's accumulators. That rounds otherwise than the sweep's running sum,
// so past a tile's first segment the rows differ from the single sweep's by
// float32 rounding, which the suffix's cancellation near saturation
// magnifies; against a float64 sum of the same walk the split is no less
// accurate than the sweep (PERF.md). seg = 0 is one segment a tile, the
// single sweep.
//
// The stop must be the forward's: the transmittance is replayed with K2's
// operations in K2's order (the same tile-local coefficients and power
// expression, then w = alpha * T; T *= 1 - alpha, sequentially over the
// pairs). This file is built, as K2 is, with -fmad=false and IEEE expf, so w
// and T equal K2's bit for bit and a grad_capacity equal to the measured sum
// of k_end gives the same gradients as the safe bound. The gradient side is
// written with __fmaf_rn, so it gets fused multiply-adds all the same.
//
// What bounds it on an H100: operations. Each pair-pixel evaluation is the
// forward's alpha (~18 f32 operations and an expf), and each evaluation with
// alpha > 0 (a hit) the gradient (~32); at the 1080p frame of the 1M room
// 91% of the evaluations are hits. Design:
//   - 128 threads per tile, 8 pixels per thread: one column and 8 rows, and a
//     warp holds a 16x16 square, so a pair whose footprint misses the square
//     skips the warp's cross-lane sum (__any_sync). The pixels of a thread
//     share x, so (w0 + wx * px), ha * pxx and dx are formed once per pair.
//   - The per-pixel gradient is straight-line, computed for every pixel
//     (where alpha is 0 it adds exact zeros and T is multiplied by 1), with
//     a branch-free reciprocal of 1 - alpha, so the eight pixels' dependent
//     chains interleave; a branch per pixel (or the IEEE division's
//     slow-path branch) runs them one after another, and 16 warps an SM
//     cannot hide that latency.
//   - Per pixel only seven running sums: sum dpower, sum dpower * dy,
//     sum dpower * dy^2 and sum g_ch * w; the per-pair channels are linear in
//     them (dx is the thread's), e.g. d_cov_x = -0.5 * dx^2 * sum dpower.
//     The ten warp sums come from one 16-slot reduce-scatter of shuffles,
//     spent once per 8 pixels.
//   - 128 registers (__launch_bounds__(128, 4), a 32-byte spill) and 56 KB
//     of shared memory a block let 4 blocks share an SM.
//   - Double-buffered chunks: while chunk k is swept, each thread's loads of
//     chunk k+1's attribute row (three float4) and chunk k+2's pair id are in
//     flight; the rows become chunk k+1's coefficients in the other buffer.
//     The four warp partials of every pair wait in a double-buffered shared
//     array and are added, in warp order, by one thread per pair while the
//     next chunk is swept. One barrier per chunk (__syncthreads_or, which is
//     also the early-stop vote). No float atomics: bitwise repeatable.
// The TPU kernel's roll-doubling prefix products, HALF sub-blocks, rolled
// two-block windows and DMA pipelines are not carried over.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kNpix = kTile * kTile;
constexpr int kThreads = 128;
constexpr int kPix = kNpix / kThreads;  // pixels per thread: 8
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // pairs per chunk
constexpr int kNfeat = 16;   // floats per attribute / slot row
constexpr int kNch = 8;      // channels of the forward images
constexpr int kCkptCh = 6;   // checkpoint channels: T, r, g, b, depth, alpha
constexpr int kListThreads = 1024;  // the work list's one block
constexpr int kNgrad = 10;   // gradient channels per pair
constexpr int kGidCol = 11;  // slot column: the Gaussian id mod 2^24
constexpr int kGidHiCol = 10;  // slot column: the Gaussian id >> 24
constexpr int kGidLoBits = 24;
static_assert(kGidCol == 2 * 4 + 3 && kGidHiCol == 2 * 4 + 2,
              "the id is the last two floats of the row's third float4 "
              "(flush)");
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTransEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;  // devices whose launch attributes are set

struct __align__(16) Coef {
  float w0, wx, wy, ha, hc, b, op, r, g, bl, depth, mx, my, a, c;
  int gid;  // the pair's Gaussian id (its table row)
};

constexpr size_t kSmemBytes =
    2 * kChunk * sizeof(Coef) + 2 * kWarps * kChunk * kNgrad * sizeof(float);

// One pair's coefficients from its attribute row (columns 0-10), in K2's
// operations and order, and its Gaussian id (load_row's q[2].w).
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
  e.mx = cx;
  e.my = cy;
  e.a = a;
  e.c = c;
  e.gid = __float_as_int(q[2].w);
  return e;
}

// The attribute row of Gaussian ``gid`` (three float4, columns 0-11), with
// the id's bits in place of column 11: the id routes from the pair list,
// exact at any table size, and takes no register of its own.
__device__ __forceinline__ void load_row(const float* __restrict__ attrs,
                                         int gid, float4 (&q)[3]) {
  const float4* row = reinterpret_cast<const float4*>(attrs + (size_t)gid * kNfeat);
  q[0] = row[0];
  q[1] = row[1];
  q[2] = row[2];
  q[2].w = __int_as_float(gid);
}

// 1 / x for x in [0.01, 1] (x = 1 - alpha): the hardware's approximate
// reciprocal refined by one Newton step, within an ulp of the IEEE quotient
// and, unlike it, with no slow-path branch to split the pixel loop.
__device__ __forceinline__ float reciprocal(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return __fmaf_rn(__fmaf_rn(-x, r, 1.0f), r, r);
}

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

// The segments of tile t in a walk of allowed[t] chunks, seg a segment.
__device__ __forceinline__ int n_segments(int allowed, int seg) {
  return allowed > 0 ? (allowed - 1) / seg + 1 : 0;
}

// The work list of composite_bwd_kernel, in one block: first[t], the index
// of tile t's first segment (an exclusive scan of n_segments over the
// tiles), and item[i], the tile of work item i (-1 past the last). Each
// thread scans a run of consecutive tiles serially; the runs' totals are
// scanned across the block.
__global__ void __launch_bounds__(kListThreads)
segment_list_kernel(const int32_t* __restrict__ allowed, int n_tiles, int seg,
                    int n_items, int32_t* __restrict__ first,
                    int32_t* __restrict__ item) {
  __shared__ int warp_total[kListThreads / 32];
  __shared__ int total;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int run = (n_tiles + kListThreads - 1) / kListThreads;
  const int t0 = min(tid * run, n_tiles), t1 = min(t0 + run, n_tiles);
  int mine = 0;
  for (int t = t0; t < t1; ++t) mine += n_segments(allowed[t], seg);
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_total[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += v;
    }
    warp_total[lane] = w;   // inclusive over the warps
    if (lane == 31) total = w;
  }
  __syncthreads();
  int at = incl - mine + (warp > 0 ? warp_total[warp - 1] : 0);
  if (total > n_items) __trap();   // fewer blocks than segments
  for (int t = t0; t < t1; ++t) {
    first[t] = at;
    const int n = n_segments(allowed[t], seg);
    for (int i = 0; i < n; ++i) item[at + i] = t;
    at += n;
  }
  for (int i = total + tid; i < n_items; i += kListThreads) item[i] = -1;
}

__global__ void __launch_bounds__(kThreads, 4)
composite_bwd_kernel(const float* __restrict__ attrs,
                     const int32_t* __restrict__ pair_gauss,
                     const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ tile_count,
                     const int32_t* __restrict__ chunk0,
                     const int32_t* __restrict__ allowed,
                     const float* __restrict__ fwd,
                     const float* __restrict__ gout,
                     const float* __restrict__ ckpt,
                     const int32_t* __restrict__ first,
                     const int32_t* __restrict__ item,
                     float* __restrict__ slots, int tiles_x, int cam_tiles,
                     int n_gauss, int n_pairs, int c_cap, int seg) {
  extern __shared__ float4 smem[];
  Coef* coef = reinterpret_cast<Coef*>(smem);                     // [2][kChunk]
  float* part = reinterpret_cast<float*>(coef + 2 * kChunk);  // [2][kWarps][kChunk][kNgrad]
  const int t = item[blockIdx.x];
  if (t < 0) return;   // past the work list's last segment
  const int s = blockIdx.x - first[t];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The tile's pixel origin within its camera: a batch of cameras is
  // B * cam_tiles camera-major tiles.
  const int tc = t % cam_tiles;
  const float ox = (float)((tc % tiles_x) * kTile);
  const float oy = (float)((tc / tiles_x) * kTile);
  const int start = tile_start[t];
  const int count = tile_count[t];
  // This segment: chunks k0 .. n_chunks - 1 of the tile's allowed[t].
  const int k0 = s * seg;
  const int n_chunks = allowed[t] - k0 <= seg ? allowed[t] : k0 + seg;
  const int64_t slot0 = chunk0[t];
  const float* c0 = s == 0 ? nullptr
      : ckpt + ((int64_t)start / ((int64_t)seg * kChunk) + s) * kCkptCh * kNpix;

  // Pixels of this thread: column col, rows row0 .. row0 + 7. Warp w holds
  // the 16x16 square at (16 * (w & 1), 16 * (w >> 1)). Coordinates as K2
  // computes them.
  const int col = 16 * (warp & 1) + (lane & 15);
  const int row0 = 16 * (warp >> 1) + 8 * (lane >> 4);
  const float px = (float)col + 0.5f;
  const float pxx = px * px;
  float py[kPix], pyy[kPix], pxy[kPix];
  float T[kPix], cw[kPix], q[kPix];
  float g0[kPix], g1[kPix], g2[kPix], g3[kPix], g4[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int pix = (row0 + j) * kTile + col;
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
    // S_pix + g_T * T_final: what the suffix of c * w sums to from the front.
    q[j] = (g0[j] * f[0 * kNpix] + g1[j] * f[1 * kNpix] +
            g2[j] * f[2 * kNpix] + g3[j] * f[3 * kNpix] +
            g4[j] * f[4 * kNpix]) + g[5 * kNpix] * f[5 * kNpix];
    if (c0 == nullptr) {
      T[j] = 1.0f;
      cw[j] = 0.0f;
    } else {   // K2's state before chunk k0: T, and the prefix of c * w
      const float* c = c0 + pix;
      T[j] = c[0 * kNpix];
      cw[j] = g0[j] * c[1 * kNpix] + g1[j] * c[2 * kNpix] +
              g2[j] * c[3 * kNpix] + g3[j] * c[4 * kNpix] +
              g4[j] * c[5 * kNpix];
    }
  }

  // Whether this thread has a pair in chunk kk, and that pair's Gaussian id
  // (loaded here, checked where it is used, so the load can be in flight).
  auto has_pair = [&](int kk) {
    return kk < n_chunks && tid < count - kk * kChunk;
  };
  auto pair_id = [&](int kk) {
    const int p = start + kk * kChunk + tid;
    if (p < 0 || p >= n_pairs) __trap();
    return pair_gauss[p];
  };
  auto check_id = [&](int gid) {
    if (gid < 0 || gid >= n_gauss) __trap();
  };

  // Chunk k0's coefficients, and chunk k0 + 1's pair id in flight.
  if (has_pair(k0)) {
    const int gid = pair_id(k0);
    check_id(gid);
    float4 rq[3];
    load_row(attrs, gid, rq);
    coef[(k0 & 1) * kChunk + tid] = make_coef(rq, ox, oy);
  }
  bool has_next = has_pair(k0 + 1);
  int gid_next = has_next ? pair_id(k0 + 1) : 0;
  __syncthreads();

  // The slot row of pair tid of chunk kk: the four warp partials added in
  // warp order, the per-pair channels formed from them.
  auto flush = [&](int kk) {
    if (!(tid < count - kk * kChunk)) return;
    const int buf = kk & 1;
    const Coef& e = coef[buf * kChunk + tid];
    float s[kNgrad];
#pragma unroll
    for (int v = 0; v < kNgrad; ++v) s[v] = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = part + ((buf * kWarps + w) * kChunk + tid) * kNgrad;
#pragma unroll
      for (int v = 0; v < kNgrad; ++v) s[v] += pw[v];
    }
    // s: sum dx^2 dp, sum dx dp dy, sum dp dy^2, sum dx dp, sum dp dy,
    // sum dp, sum g_ch w for ch = 0..3.
    float4* o = reinterpret_cast<float4*>(
        slots + ((slot0 + kk) * kChunk + tid) * kNfeat);
    o[0] = make_float4(-0.5f * s[0], -s[1], -0.5f * s[2],
                       e.a * s[3] + e.b * s[4]);
    o[1] = make_float4(e.c * s[4] + e.b * s[3],
                       s[5] / (e.op > 0.0f ? e.op : 1.0f), s[6], s[7]);
    o[2] = make_float4(s[8], s[9], (float)(e.gid >> kGidLoBits),
                       (float)(e.gid & ((1 << kGidLoBits) - 1)));
    o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };

  int k = k0;
  while (k < n_chunks) {
    if (slot0 + k >= c_cap) __trap();
    const int buf = k & 1;
    if (k > k0) flush(k - 1);
    // Loads for the next chunks, consumed after this chunk's sweep.
    float4 rq[3];
    const bool load = has_next;
    if (load) {
      check_id(gid_next);
      load_row(attrs, gid_next, rq);
    }
    has_next = has_pair(k + 2);
    if (has_next) gid_next = pair_id(k + 2);

    const Coef* cf = coef + buf * kChunk;
    float* pw = part + (buf * kWarps + warp) * kChunk * kNgrad;
    const int n_valid = min(count - k * kChunk, kChunk);
    for (int i = 0; i < n_valid; ++i) {
      const Coef& e = cf[i];
      // The forward, in K2's operations and order: the terms every pixel
      // of this column shares are formed once.
      const float t1 = e.w0 + e.wx * px;
      const float t3 = e.ha * pxx;
      float S = 0.0f, Sy = 0.0f, Syy = 0.0f;
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
      bool hit = false;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const float power = t1 + e.wy * py[j] - t3 - e.hc * pyy[j] -
                            e.b * pxy[j];
        const float raw =
            (power > 0.0f) ? 0.0f : e.op * expf(fminf(power, 0.0f));
        float alpha = fminf(raw, kAlphaMax);
        if (alpha < kAlphaMin) alpha = 0.0f;
        // The gradient, straight-line: no branch per pixel, so the
        // compiler can interleave the thread's eight pixels. Where alpha is
        // 0, w and dpower are 0, every term added below is an exact zero
        // and T is multiplied by 1.
        hit |= alpha > 0.0f;
        const float om = 1.0f - alpha;
        const float w = alpha * T[j];
        const float cc = __fmaf_rn(
            e.r, g0[j],
            __fmaf_rn(e.g, g1[j],
                      __fmaf_rn(e.bl, g2[j], __fmaf_rn(e.depth, g3[j], g4[j]))));
        cw[j] = __fmaf_rn(cc, w, cw[j]);
        const float dalpha =
            __fmaf_rn(cc, T[j], -((q[j] - cw[j]) * reciprocal(om)));
        const float dp = raw <= kAlphaMax ? dalpha * alpha : 0.0f;
        const float dy = py[j] - e.my;
        const float dpy = dp * dy;
        S += dp;
        Sy += dpy;
        Syy = __fmaf_rn(dpy, dy, Syy);
        c0 = __fmaf_rn(g0[j], w, c0);
        c1 = __fmaf_rn(g1[j], w, c1);
        c2 = __fmaf_rn(g2[j], w, c2);
        c3 = __fmaf_rn(g3[j], w, c3);
        T[j] *= om;
      }
      if (__any_sync(kFull, hit)) {
        const float dx = px - e.mx;
        const float dxs = dx * S;
        float v[16] = {dx * dxs, dx * Sy, Syy, dxs, Sy, S, c0, c1, c2, c3,
                       0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        halve<8>(v, 16, lane & 16);
        halve<4>(v, 8, lane & 8);
        halve<2>(v, 4, lane & 4);
        halve<1>(v, 2, lane & 2);
        // Lanes 2q and 2q+1 now hold halves of slot q's warp sum.
        const float sum = v[0] + __shfl_xor_sync(kFull, v[0], 1);
        if ((lane & 1) == 0 && (lane >> 1) < kNgrad)
          pw[i * kNgrad + (lane >> 1)] = sum;
      } else if (lane < kNgrad) {
        pw[i * kNgrad + lane] = 0.0f;   // the pair misses this warp's pixels
      }
    }
    if (load) coef[(buf ^ 1) * kChunk + tid] = make_coef(rq, ox, oy);
    ++k;
    // Lanes past the chunk's last pair keep the caller's fill. The barrier
    // publishes this chunk's partials and the next chunk's coefficients.
    bool live = false;
#pragma unroll
    for (int j = 0; j < kPix; ++j) live |= T[j] > kTransEps;
    if (!__syncthreads_or(live)) break;
  }
  if (k > k0) flush(k - 1);
}

}  // namespace

// Shared memory beyond 48 KB is opt-in; the largest carveout lets the most
// blocks share an SM. Set once per device, not on every launch.
static cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(composite_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(composite_bwd_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

// ckpt NULL with seg 0: one segment a tile (the single sweep); else
// segments of seg chunks from K2's checkpoints. work: n_tiles + n_items
// int32 of scratch for the work list; n_items: at least the segments of all
// tiles together (the list kernel traps otherwise).
extern "C" int sage3d_composite_bwd(const void* attrs, const void* pair_gauss,
                                    const void* tile_start,
                                    const void* tile_count, const void* chunk0,
                                    const void* allowed, const void* fwd_out,
                                    const void* gout, const void* ckpt,
                                    void* work, void* slots, int n_tiles,
                                    int tiles_x, int cam_tiles, int n_gauss,
                                    int n_pairs, int c_cap, int seg,
                                    int n_items, void* stream) {
  if (cam_tiles <= 0 || n_tiles % cam_tiles) return (int)cudaErrorInvalidValue;
  if (seg < 0 || (seg > 0) != (ckpt != nullptr) || n_items < 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0 && n_items > 0) {
    const cudaError_t err = configure();
    if (err != cudaSuccess) return (int)err;
    const int seg_len = seg > 0 ? seg : INT_MAX;
    int32_t* first = (int32_t*)work;
    int32_t* item = first + n_tiles;
    segment_list_kernel<<<1, kListThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)allowed, n_tiles, seg_len, n_items, first, item);
    composite_bwd_kernel<<<n_items, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const float*)attrs, (const int32_t*)pair_gauss,
        (const int32_t*)tile_start, (const int32_t*)tile_count,
        (const int32_t*)chunk0, (const int32_t*)allowed, (const float*)fwd_out,
        (const float*)gout, (const float*)ckpt, first, item, (float*)slots,
        tiles_x, cam_tiles, n_gauss, n_pairs, c_cap, seg_len);
  }
  return (int)cudaGetLastError();
}

// Blocks of the kernel one SM holds at once (its registers and shared
// memory), from the occupancy calculator.
extern "C" int sage3d_composite_bwd_occupancy(void* blocks) {
  const cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)blocks, composite_bwd_kernel, kThreads, kSmemBytes);
}

// Registers per thread of the kernel, from cudaFuncGetAttributes.
extern "C" int sage3d_composite_bwd_regs(void* regs) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, (const void*)composite_bwd_kernel);
  if (err == cudaSuccess) *(int*)regs = attr.numRegs;
  return (int)err;
}
