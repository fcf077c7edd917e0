"""Operations and bytes of the program's hand-written kernels, worked out
from the benchmark's own counts of the work its inputs need (the reference
renderer's ``Counts``; the scene's solid Gaussians), never from the
program's outputs.

Operations a unit of work, from the kernels' arithmetic:
  * the compositor forward (K2), every pair-pixel evaluation: the quadratic
    (10), the exp (counted as 4), the clamps and cutoff (4); every one with
    alpha > 0 (a hit): the weight and five accumulations (11), the best
    test (1) and the transmittance (2). Elsewhere w is an exact zero.
  * the compositor backward (K3), every evaluation: K2's alpha (18); every
    hit: 1 - alpha, w and T (3), the colour term (8), the running sum (2),
    dalpha (4), dpower (3), three geometry sums (4), four colour sums (8).
  * the capsule query (K6), built without fused multiply-adds: every
    Gaussian, the sigmoid and solid test (5); every solid one, the rotation
    and scales (59); every query-solid pair, the clearance (60).
Bytes: each input byte read once and each output byte written once.
"""

from . import peaks

NPIX = 1024
K2_OPS_PER_EVAL, K2_OPS_PER_HIT = 18, 14
K3_OPS_PER_EVAL, K3_OPS_PER_HIT = 18, 32
K2_OUT_CHANNELS = 8          # r, g, b, depth, alpha, T, best weight, best id
K3_IN_CHANNELS = 6           # the images and their cotangents it reads
K3_ROW_FLOATS = 16           # one gradient row a walked pair
K6_OPS_PER_GAUSSIAN, K6_OPS_PER_SOLID, K6_OPS_PER_PAIR = 5, 59, 60
K6_BYTES_PER_GAUSSIAN, K6_BYTES_PER_QUERY = 44, 40


def k2_seconds(pairs: int, hits: int, gaussians: int, tiles: int) -> float:
    """K2's least time for a frame whose compositing needs ``pairs`` pairs,
    ``hits`` hits, ``gaussians`` distinct Gaussians over ``tiles`` tiles:
    the pair ids, 11 floats a Gaussian, the tile ranges, the images and
    the per-tile chunk count."""
    n_bytes = (gaussians * 11 * 4 + pairs * 4 + tiles * 8
               + tiles * K2_OUT_CHANNELS * NPIX * 4 + tiles * 4)
    ops = pairs * NPIX * K2_OPS_PER_EVAL + hits * K2_OPS_PER_HIT
    return peaks.least_seconds(n_bytes, ops)[0]


def k3_seconds(pairs: int, hits: int, gaussians: int, tiles: int) -> float:
    """K3's least time for the same frame's backward: the pair ids, 12
    floats a Gaussian, the images and their cotangents, and one gradient
    row written a pair."""
    n_bytes = (gaussians * 12 * 4 + pairs * 4
               + 2 * tiles * K3_IN_CHANNELS * NPIX * 4
               + pairs * K3_ROW_FLOATS * 4)
    ops = pairs * NPIX * K3_OPS_PER_EVAL + hits * K3_OPS_PER_HIT
    return peaks.least_seconds(n_bytes, ops)[0]


def k6_seconds(n_gauss: int, n_solid: int, queries: int) -> float:
    """K6's least time for ``queries`` capsules against ``n_gauss``
    Gaussians of which ``n_solid`` are solid."""
    n_bytes = (n_gauss * K6_BYTES_PER_GAUSSIAN + queries * K6_BYTES_PER_QUERY
               + 4)
    ops = (n_gauss * K6_OPS_PER_GAUSSIAN + n_solid * K6_OPS_PER_SOLID
           + queries * n_solid * K6_OPS_PER_PAIR)
    return peaks.least_seconds(n_bytes, ops, peaks.FP32_NONFMA_OPS_PER_S)[0]
