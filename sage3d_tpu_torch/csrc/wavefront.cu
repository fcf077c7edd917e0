// K5: eight Jacobi min-plus relaxations of the wavefront planner's distance
// fields, hand-written for Hopper (sm_90a).
//
// Replaces the device loop of sage3d_tpu/data/astar.py::wavefront_distances,
// a jit-compiled lax.while_loop whose body runs 8 relaxations and keeps the
// convergence test on the device (XLA, not Pallas). One launch of this file
// is one trip of that body: it reads the (B, H, W) float32 field `src`,
// writes the field 8 relaxations later to `dst`, and sets `*flag` where any
// cell of `dst` lies below its value in `src` minus 1e-6f (the f32 test
// new < dist - 1e-6 of the JAX body). A relaxation is, per cell,
//   best = d; best = min(best, d[y - dy, x - dx] + cost) for each neighbour
//   of _NEIGHBORS in order; d' = min(best + free_f, INF),
// with free_f 0 on free cells and INF on walls, cells outside the grid INF
// and never relaxed (JAX's jnp.pad(..., INF)). Jacobi: every relaxation
// reads the previous one's field, never its own partial result. min is
// exact and each candidate is one f32 add, so any schedule of the same
// relaxations gives the same bits: the fields equal JAX's bitwise.
//
// What bounds it on an H100: one launch moves B*H*W*4 bytes in and out and
// does 8 relaxations of 18 f32 operations a cell (8 adds, 8 minima, the
// obstacle add and the clamp), none of them an FMA: at 240x240 and B = 16,
// 2.2 us of bytes against 4.0 us of operations at the non-FMA rate. So the
// design keeps the 8 relaxations in shared memory and the field crosses
// device memory once a launch, not once a relaxation.
//   - One block per (source, 32x32 output tile). It loads the 48x48 region
//     around the tile (an 8-cell halo: 8 relaxations move information at
//     most 8 cells) into one of two shared buffers, with its obstacle add.
//   - Relaxation s (1..8) computes the cells at least s cells inside the
//     region from the other buffer (ping-pong), so the valid region shrinks
//     by one cell a relaxation and the 32x32 tile is exact after 8. Cells
//     outside the grid hold INF in both buffers and are never written.
//   - 288 threads: one a column of the region and band of 8 rows. A thread
//     walks its band down the column with the rows above and at the cell
//     in registers, so a cell costs 3 shared loads of the row below, not 9
//     (with a thread a cell the shared loads held it at ~11x the bound on
//     an H100). Rows are 50 floats apart, so the two bands a warp spans
//     read disjoint banks.
//   - The flag: each thread tests its tile cells against `src`, a block-wide
//     OR, one store of 1 by thread 0. The caller zeroes the flags.
//   - Launches chain on the device: a launch given `prev_flag` returns at
//     once when the launch before it found no change, so the host can queue
//     several launches and read their flags once, and the converged field
//     stays in the last launch that ran.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                 // output tile side
constexpr int kSteps = 8;                 // relaxations a launch (CHECK_EVERY)
constexpr int kRegion = kTile + 2 * kSteps;   // 48: the tile with its halo
constexpr int kCells = kRegion * kRegion;
constexpr int kStride = 50;               // a region row in shared memory
constexpr int kBand = 8;                  // rows a thread walks
constexpr int kThreads = kRegion * (kRegion / kBand);   // 288
constexpr float kInf = 1e9f;
constexpr float kSqrt2 = 1.41421356237309515f;   // f32(math.sqrt(2))

struct Row3 {
  float l, c, r;   // columns x - 1, x, x + 1
};

__device__ __forceinline__ Row3 load_row(const float* __restrict__ cur,
                                         int i) {
  return Row3{cur[i - 1], cur[i], cur[i + 1]};
}

// One relaxation of the cell whose row is `mid`, `up` the row above (y - 1)
// and `down` the row below (y + 1): _NEIGHBORS order, with
// shifted[y, x] = d[y - dy, x - dx].
__device__ __forceinline__ float relax_cell(const Row3& up, const Row3& mid,
                                            const Row3& down, float wall) {
  float best = mid.c;
  best = fminf(best, down.r + kSqrt2);   // (-1, -1)
  best = fminf(best, down.c + 1.0f);     // (-1,  0)
  best = fminf(best, down.l + kSqrt2);   // (-1,  1)
  best = fminf(best, mid.r + 1.0f);      // ( 0, -1)
  best = fminf(best, mid.l + 1.0f);      // ( 0,  1)
  best = fminf(best, up.r + kSqrt2);     // ( 1, -1)
  best = fminf(best, up.c + 1.0f);       // ( 1,  0)
  best = fminf(best, up.l + kSqrt2);     // ( 1,  1)
  return fminf(best + wall, kInf);
}

__global__ void __launch_bounds__(kThreads)
relax_kernel(const float* __restrict__ src, float* __restrict__ dst,
             const uint8_t* __restrict__ free_grid, int h, int w,
             int tiles_x, const int* __restrict__ prev_flag,
             int* __restrict__ flag) {
  if (prev_flag != nullptr && *prev_flag == 0) return;   // converged
  __shared__ float buf[2][kRegion * kStride];
  __shared__ float wall[kRegion * kStride];
  const int tx = blockIdx.x % tiles_x;
  const int ty = blockIdx.x / tiles_x;
  const int64_t plane = (int64_t)h * w;
  const float* field = src + (int64_t)blockIdx.y * plane;
  const int y0 = ty * kTile - kSteps;
  const int x0 = tx * kTile - kSteps;

  for (int i = threadIdx.x; i < kCells; i += kThreads) {
    const int ry = i / kRegion, rx = i % kRegion;
    const int gy = y0 + ry, gx = x0 + rx;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const int64_t g = (int64_t)gy * w + gx;
    const float v = inside ? field[g] : kInf;
    const int k = ry * kStride + rx;
    buf[0][k] = v;
    buf[1][k] = v;
    wall[k] = inside && free_grid[g] ? 0.0f : kInf;
  }
  __syncthreads();

  const int col = threadIdx.x % kRegion;
  const int band = threadIdx.x / kRegion;
  const bool col_inside = x0 + col >= 0 && x0 + col < w;
#pragma unroll 1
  for (int s = 1; s <= kSteps; ++s) {
    const float* cur = buf[(s - 1) & 1];
    float* nxt = buf[s & 1];
    const int r_lo = max(band * kBand, s);
    const int r_hi = min(band * kBand + kBand, kRegion - s);
    if (col_inside && col >= s && col < kRegion - s && r_lo < r_hi) {
      int i = r_lo * kStride + col;
      Row3 up = load_row(cur, i - kStride);
      Row3 mid = load_row(cur, i);
      for (int r = r_lo; r < r_hi; ++r, i += kStride) {
        const Row3 down = load_row(cur, i + kStride);
        const int gy = y0 + r;
        if (gy >= 0 && gy < h) nxt[i] = relax_cell(up, mid, down, wall[i]);
        up = mid;
        mid = down;
      }
    }
    __syncthreads();
  }

  // kSteps is even: the last relaxation wrote buf[0].
  float* out = dst + (int64_t)blockIdx.y * plane;
  int changed = 0;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int gy = ty * kTile + i / kTile;
    const int gx = tx * kTile + i % kTile;
    if (gy >= h || gx >= w) continue;
    const int64_t g = (int64_t)gy * w + gx;
    const int k = (i / kTile + kSteps) * kStride + i % kTile + kSteps;
    const float v = buf[0][k];
    out[g] = v;
    changed |= v < field[g] - 1e-6f;
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) *flag = 1;
}

}  // namespace

// One launch of kSteps relaxations of the (b, h, w) float32 field `src` into
// `dst` (not `src`: neighbouring tiles read `src` while it is written). The
// obstacle grid `free_grid` is (h, w) bytes, nonzero on free cells.
// `prev_flag` is NULL or the flag of the launch before in a chain; `flag` is
// this launch's, zeroed by the caller. Returns the launch's cudaError_t.
extern "C" int sage3d_wavefront_relax(const void* src, void* dst,
                                      const void* free_grid, int b, int h,
                                      int w, const void* prev_flag,
                                      void* flag, void* stream) {
  static_assert(kSteps % 2 == 0, "the result is read from buf[0]");
  if (b <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  const int tiles_x = (w + kTile - 1) / kTile;
  const int tiles_y = (h + kTile - 1) / kTile;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)b);
  relax_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (float*)dst, (const uint8_t*)free_grid, h, w,
      tiles_x, (const int*)prev_flag, (int*)flag);
  return (int)cudaGetLastError();
}
