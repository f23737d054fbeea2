// Farnebäck main-path kernels for Hopper (sm_90a), with a plain C interface.
//
// Four kernels: one per step of each pyramid level / iteration, and K2's
// tile-list form (K4), which no path of the port runs now:
//
// K1 poly_exp_kernel — replaces btcs_pnes_optical_flow_tpu/ops/farneback_pallas.py
//    poly_exp_fused_cf (body _poly_kernel_factory).  Per frame, the separable
//    (2n+1)-tap correlations with g, x·g and x²·g (replicate borders) and the
//    inverse-Gram scaling into 5 planes [b_y, b_x, A_yy, A_xx, 2A_xy].
//    Bound: memory, 24 bytes per pixel (1 float in, 5 out), against 9(2n+1)
//    multiplies and as many adds.  Design (see "Window sums" below): 32×64
//    output tiles, the vertical pass into 3 shared planes and the horizontal
//    pass into 6 sums per pixel, both from registers with the taps in the
//    kernel's parameters; each thread stores 4 adjacent pixels of each of the
//    5 planes as one 16-byte vector.
//
// K2 update_matrices_kernel — replaces farneback_pallas.py
//    update_matrices_banded_cf (body _make_kernel), with its `active` tile
//    range: the whole level, or a box of it written into the level's M in
//    place (a boxed level of ROI dispatch, as the JAX level loop runs K2 over
//    a tile range, farneback_fused.py:131-174).  Per pixel, the bilinear
//    sample of frame b+1's expansion at (x+dx, y+dy) under cv2's inside
//    guard, the averaged A, the Δb fold, the 5-pixel rim damping and the 5 M
//    planes [G_yy, G_xy, G_xx, h_y, h_x] (matrices_math).  Bound: memory —
//    r0 and r1 are consecutive frames of one expansion, so each frame's 5
//    floats are read once, plus 2 flow floats in and 5 M floats out: 48 B
//    per pixel at 64 pairs; about 70 flops.  The pre-walk design (one
//    thread per pixel, pair-major over the grid) read each frame twice, as
//    r1 for pair b and as r0 for pair b+1, with a whole pair's planes
//    (18 MB per frame for a 1080p level-0 box) in between, more than L2
//    holds: ~68 B per pixel.  Design: a block owns one 8×32 tile and walks
//    a run of consecutive pairs (see update_matrices_kernel), so frame b+1's
//    tile is still in L1/L2 when pair b+1 reads it as r0; the run length is
//    chosen by the wrapper from the launch size so that the grid fills the
//    SMs many times over (a run's first pair reads its r0 frame once more).
//    One pixel a thread, one warp a tile row: r0, flow and M move as whole
//    128-byte rows and a warp's corner gathers stay within a few lines.  The
//    next pair's flow is loaded into registers before this pair's gathers
//    are consumed, so each pair costs one round trip to memory.  Staging
//    each pair's r0 and flow in shared memory with 16-byte cp.async copies
//    instead took 80 registers and a barrier per pair, and ran the 1080p
//    level-0 box in 1.41 ms against this form's 1.18 on an H100 (700 W;
//    scripts/k2_walk_variants.py); 16-byte accesses with 4 pixels a lane
//    would spread each gather instruction over 4 times the cache lines.
//    The r1 corners are read only when the guard holds (outside it cv2 uses
//    none of them), and the TPU kernel's banded window, clip counters and
//    follow-up passes have no counterpart: a direct sample has no reach
//    limit.
//    Instances: the precision of the horizontal lerp (fp32, or the TPU
//    kernel's bf16 candidate MAC of warp_precision="bf16", each bf16 step
//    rounded with __float2bfloat16_rn; the bytes moved are the same, so bf16
//    buys nothing on this card and exists to compute what the TPU computes).
//    update_matrices_rows_kernel is the row-offset form for a height shard
//    (parallel/spatial.py, which replaces spatial.py
//    _update_matrices_sharded: r1 carries a halo of rows, targets are global
//    rows, the rim damping uses global rows) on the pre-walk design; at
//    offset 0 without halo it is the pre-walk K2.
//
// K3 update_flow_kernel — replaces farneback_pallas.py update_flow_fused_cf
//    (body _flow_kernel_factory).  The winsize window average of the 5 M
//    planes with replicate borders (box: a sum times 1/winsize²; Gaussian:
//    the separable taps), then the regularized 2×2 solve.  Bound: memory,
//    28 bytes per pixel (5 floats in, 2 out), against 2·winsize adds (box)
//    per plane and pixel.  Design (see "Window sums" below): 32×64 output
//    tiles, one M plane at a time; the 5 window sums of a thread's 8 pixels
//    stay in registers across the planes, then the solve writes the two flow
//    planes as 16-byte vectors.  The TPU kernel's fix_borders step repaired
//    its zero-filled halo; clamped loads make it unnecessary.  Box mode
//    solves a sub-rectangle of the level only (ROI dispatch): loads clamp to
//    the box, as the fused TPU level loop's compact subgrid replicates at its
//    edges, and flow outside the box is not written.
//
// K4 update_matrices_tiles_kernel — replaces farneback_pallas.py
//    update_matrices_banded_tiles_cf (body _make_kernel2).  K2's per-pixel
//    math (the same device function, so the two stay bit-equal) over a list
//    of tiles, written into an existing M in place; unlisted tiles are left
//    as they were.  In JAX this kernel runs only the follow-up passes over
//    the tiles whose pixels a banded window missed; the port's direct
//    sample misses none, so since K2 took the `active` box no path of the
//    port runs K4 (it ran every boxed level over a device-built list of the
//    box's tiles, with a read-back of the list's range per launch).  Bound:
//    as K2, memory — per listed tile the r0, flow and M bytes of its pixels
//    plus the r1 corners.  Design: one block per listed tile reads its id
//    from the list, so the grid is the list and no block is launched for an
//    unlisted tile.  A tile is 8×32, one thread per pixel: on an H100, 16×32
//    tiles with two rows per thread took 48 registers against 32 and ran
//    21% slower per pixel.  The TPU kernel's anchored windows, band DMAs,
//    coverage masks and residual clip counters (with window_from_residuals)
//    exist because a TPU gather costs ~20 ns per index; a direct sample has
//    no reach, so one visit always covers a tile and nothing needs counting.
//
// Window sums (K1, K3).  Both kernels are separable window sums followed by
// per-pixel arithmetic, and both must repeat their plain versions' float32
// operations in order (ops/cvx.py corr1d: tap 0's product first, then each
// tap's product added in turn; the vertical pass before the horizontal).
// A running (incremental) window sum would round differently, so every
// output's sum is formed from scratch.  What keeps them near memory speed:
//  - the window radius is a template parameter (K1: n = 1…8; K3: winsize
//    3…31, box or Gaussian), so every tap loop unrolls and the taps are
//    operands from the kernel's parameter bank; a box adds without
//    multiplying (x·1.0f is exact, so the sums are the same bits).  One
//    instance per kernel takes the radius at run time, with the same
//    arithmetic in the same order, for the sizes outside the set;
//  - a tile is 32×64 outputs with a (32+2r)×(64+2r) input halo, 1.3–1.9×
//    the output's area;
//  - the vertical pass gives a thread one column of a 16-row strip: it reads
//    the strip's 16+2r inputs into registers once and forms 16 sums; the
//    horizontal pass gives a thread 4 adjacent outputs of a row: it reads
//    4+2r vertical sums once, as 16-byte shared loads;
//  - blocks are persistent: each walks over (frame, tile) units (K3: tile
//    and plane) and prefetches the next unit's input with cp.async into the
//    second of two shared buffers while it computes the current one.  Rows
//    clamp to the image (or box) per row; columns are copied 16 bytes at a
//    time when the whole staged row lies inside it, else one float at a
//    time with clamped addresses (the replicate border).  No index is
//    divided by a run-time divisor per element.
//
// Built with -fmad=false: every product is rounded before its sum, as in the
// plain PyTorch versions, so a kernel repeats their float32 operations in
// their order.  The Farnebäck iteration is ill-conditioned at some pixels of
// real video: on an H100, contracting a*b+c into one rounding moved the flow
// of 8 pairs of the 480p bench clip by 1.5e-2 px, against ~1e-5 px for any
// one kernel call.
//
// Element offsets are 64-bit: a 1080p 256-pair chunk of 5 planes has
// 2.65 G elements.  Every launcher returns cudaGetLastError() after launching
// on the caller's stream; it neither synchronises nor allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr long long kMaxGridZ = 65535;
constexpr size_t kDefaultSmem = 48 * 1024;

// K1 and K3: blocks of kThreads threads over kTH × kTW output tiles.
constexpr int kThreads = 256;
constexpr int kTH = 32;   // output rows of a tile
constexpr int kTW = 64;   // output columns of a tile
constexpr int kRun = 4;   // adjacent outputs of one horizontal-pass run
constexpr int kRunsPerRow = kTW / kRun;             // 16
constexpr int kRowsPerPass = kThreads / kRunsPerRow;  // 16: a thread takes 2 rows
constexpr int kMaxTaps = 32;

// K2's walk: a kWalkH × kWalkW tile per block of kThreads threads, one pixel
// a thread, one warp a tile row.
constexpr int kWalkH = 8;
constexpr int kWalkW = 32;
// At least 5 blocks an SM, so at most 51 registers a thread (ptxas uses
// 48).  Without a minimum ptxas took 40, and the walk ran the 1080p level 0
// 13-15% slower on an H100 (480p within 3%; scripts/k2_walk_variants.py).
constexpr int kWalkMinBlocks = 5;
static_assert(kWalkH * kWalkW == kThreads, "one thread per pixel of a walk tile");

__host__ __device__ inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// The vertical pass gives a thread one column of a strip of rows.  A
// compile-time-radius instance ("fixed") cuts the tile's rows into 3 strips
// of 11 (33 rows, one more than the tile) when 3 columns of strips fit the
// block's threads, else into 2 of 16; the run-time-radius instance into 2.
__host__ __device__ constexpr int n_strips(int r, bool fixed) {
  return fixed && 3 * (kTW + 2 * r) <= kThreads ? 3 : 2;
}
__host__ __device__ constexpr int strip_rows(int r, bool fixed) {
  return (kTH + n_strips(r, fixed) - 1) / n_strips(r, fixed);
}
__host__ __device__ constexpr int vert_rows(int r, bool fixed) {
  return n_strips(r, fixed) * strip_rows(r, fixed);
}

// Row stride of a staged input tile of radius r: absolute columns xs …
// xs + stage_w - 1, with xs = (x0 - r) rounded down to a multiple of 4.
__host__ __device__ constexpr int stage_w(int r) { return round4(kTW + 2 * r + 3); }

// Row stride of the vertical sums: the last run reads round4(kRun + 2r)
// columns from kTW - kRun.
__host__ __device__ constexpr int vsum_w(int r) { return kTW - kRun + round4(kRun + 2 * r); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of rows ys … ys+rows-1 and columns xs … xs+4·ncols4-1 of
// one plane into dst (row stride sw), each row and column clamped to
// [y_lo, y_hi] × [x_lo, x_hi].  16-byte copies when the columns lie inside
// the range and vec (w % 4 == 0, planes 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void stage_rows(float* dst, int sw, const float* __restrict__ plane,
                                           int w, int ys, int rows, int xs, int ncols4, int y_lo,
                                           int y_hi, int x_lo, int x_hi, bool vec) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (vec && xs >= x_lo && xs + 4 * ncols4 - 1 <= x_hi) {
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float* src = plane + (long long)clampi(ys + r, y_lo, y_hi) * w + xs;
      float* d = dst + r * sw;
      for (int q = lane; q < ncols4; q += 32) cp_async16(d + 4 * q, src + 4 * q);
    }
  } else {
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float* src = plane + (long long)clampi(ys + r, y_lo, y_hi) * w;
      float* d = dst + r * sw;
      for (int c = lane; c < 4 * ncols4; c += 32) cp_async4(d + c, src + clampi(xs + c, x_lo, x_hi));
    }
  }
}

// A tile of the kTH × kTW lattice over the box [y_lo, y_hi] × [x_lo, x_hi]
// of frame b: its first output (y0, x0) and where its staged columns start.
struct Tile {
  long long b;
  int y0, x0, xs, delta;
};

__device__ __forceinline__ Tile tile_at(long long t, long long per_frame, int n_tx, int y_lo,
                                        int x_lo, int r) {
  Tile tl;
  tl.b = t / per_frame;
  const int rem = (int)(t - tl.b * per_frame);
  const int ty = rem / n_tx;
  tl.y0 = y_lo + ty * kTH;
  tl.x0 = x_lo + (rem - ty * n_tx) * kTW;
  tl.xs = (tl.x0 - r) & ~3;  // floor to a multiple of 4, also below 0
  tl.delta = tl.x0 - r - tl.xs;
  return tl;
}

// K1's taps: g, x·g, x²·g for n ≤ 8 and the inverse-Gram factors.
struct PolyTaps {
  float g[17], xg[17], xxg[17];
  float ig11, ig03, ig33, ig55;
};

// consts = [g (K), xg (K), xxg (K), ig11, ig03, ig33, ig55], K = 2n+1: the
// run-time instance (N < 0) reads the taps from here, the others from taps.
template <int N>
__global__ void __launch_bounds__(kThreads)
    poly_exp_kernel(const float* __restrict__ img, const PolyTaps taps,
                    const float* __restrict__ consts, float* __restrict__ out, long long batch,
                    int h, int w, int n_rt, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int NS = n_strips(N, N >= 0);
  constexpr int SEG = strip_rows(N, N >= 0);
  const int n = N >= 0 ? N : n_rt;
  const int k = 2 * n + 1;
  const int sw = stage_w(n);
  const int svw = vsum_w(n);
  const int in_rows = NS * SEG + 2 * n;
  const int nc = kTW + 2 * n;  // columns of the vertical pass
  const int buf_floats = in_rows * sw;
  float* s_v = smem + 2 * buf_floats;  // 3 planes of NS·SEG × svw
  const int vplane = NS * SEG * svw;
  const int n_tx = (w + kTW - 1) / kTW;
  const long long per_frame = (long long)((h + kTH - 1) / kTH) * n_tx;
  const long long n_units = batch * per_frame;
  const long long plane = (long long)h * w;
  const float* cg = consts;
  const float* cxg = consts + k;
  const float* cxxg = consts + 2 * k;

  long long t = blockIdx.x;
  if (t >= n_units) return;
  {
    const Tile tl = tile_at(t, per_frame, n_tx, 0, 0, n);
    stage_rows(smem, sw, img + tl.b * plane, w, tl.y0 - n, in_rows, tl.xs,
               (nc + tl.delta + 3) / 4, 0, h - 1, 0, w - 1, vec);
    cp_async_commit();
  }
  int buf = 0;
  for (; t < n_units; t += gridDim.x) {
    const Tile tl = tile_at(t, per_frame, n_tx, 0, 0, n);
    const long long nt = t + gridDim.x;
    if (nt < n_units) {  // prefetch the next unit into the other buffer
      const Tile nx = tile_at(nt, per_frame, n_tx, 0, 0, n);
      stage_rows(smem + (buf ^ 1) * buf_floats, sw, img + nx.b * plane, w, nx.y0 - n, in_rows,
                 nx.xs, (nc + nx.delta + 3) / 4, 0, h - 1, 0, w - 1, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_in = smem + buf * buf_floats + tl.delta;
    // Vertical pass: column c of strip seg, SEG rows, 3 tap sets.
    for (int it = threadIdx.x; it < NS * nc; it += kThreads) {
      const int seg = it / nc;
      const int c = it - seg * nc;
      const float* col = s_in + seg * SEG * sw + c;
      float* dst = s_v + seg * SEG * svw + c;
      if constexpr (N >= 0) {
        constexpr int K = 2 * N + 1;
        float v[SEG + 2 * N];
#pragma unroll
        for (int i = 0; i < SEG + 2 * N; ++i) v[i] = col[i * sw];
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
          float a0 = taps.g[0] * v[j];
          float a1 = taps.xg[0] * v[j];
          float a2 = taps.xxg[0] * v[j];
#pragma unroll
          for (int q = 1; q < K; ++q) {
            a0 = a0 + taps.g[q] * v[j + q];
            a1 = a1 + taps.xg[q] * v[j + q];
            a2 = a2 + taps.xxg[q] * v[j + q];
          }
          dst[j * svw] = a0;
          dst[vplane + j * svw] = a1;
          dst[2 * vplane + j * svw] = a2;
        }
      } else {
        for (int j = 0; j < SEG; ++j) {
          const float v0 = col[j * sw];
          float a0 = __ldg(cg) * v0;
          float a1 = __ldg(cxg) * v0;
          float a2 = __ldg(cxxg) * v0;
          for (int q = 1; q < k; ++q) {
            const float vq = col[(j + q) * sw];
            a0 = a0 + __ldg(cg + q) * vq;
            a1 = a1 + __ldg(cxg + q) * vq;
            a2 = a2 + __ldg(cxxg + q) * vq;
          }
          dst[j * svw] = a0;
          dst[vplane + j * svw] = a1;
          dst[2 * vplane + j * svw] = a2;
        }
      }
    }
    __syncthreads();
    // Horizontal pass: 4 adjacent outputs of rows j0 and j0 + 16.
    const int q4 = (threadIdx.x & (kRunsPerRow - 1)) * kRun;
    const int j0 = threadIdx.x / kRunsPerRow;
    const float ig11 = N >= 0 ? taps.ig11 : __ldg(consts + 3 * k);
    const float ig03 = N >= 0 ? taps.ig03 : __ldg(consts + 3 * k + 1);
    const float ig33 = N >= 0 ? taps.ig33 : __ldg(consts + 3 * k + 2);
    const float ig55 = N >= 0 ? taps.ig55 : __ldg(consts + 3 * k + 3);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = j0 + rr * kRowsPerPass;
      const int y = tl.y0 + j;
      const float* row = s_v + j * svw + q4;
      // b1 = g⊛v0, b2 = xg⊛v0, b4 = xxg⊛v0, b3 = g⊛v1, b6 = xg⊛v1, b5 = g⊛v2
      float b1[kRun], b2[kRun], b3[kRun], b4[kRun], b5[kRun], b6[kRun];
      if constexpr (N >= 0) {
        constexpr int K = 2 * N + 1;
        constexpr int NV = round4(kRun + 2 * N);
        float v[NV];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
#pragma unroll
          for (int i = 0; i < NV / 4; ++i) {
            const float4 f = *reinterpret_cast<const float4*>(row + p * vplane + 4 * i);
            v[4 * i] = f.x;
            v[4 * i + 1] = f.y;
            v[4 * i + 2] = f.z;
            v[4 * i + 3] = f.w;
          }
#pragma unroll
          for (int o = 0; o < kRun; ++o) {
            if (p == 0) {
              float a = taps.g[0] * v[o], b = taps.xg[0] * v[o], c = taps.xxg[0] * v[o];
#pragma unroll
              for (int q = 1; q < K; ++q) {
                a = a + taps.g[q] * v[o + q];
                b = b + taps.xg[q] * v[o + q];
                c = c + taps.xxg[q] * v[o + q];
              }
              b1[o] = a;
              b2[o] = b;
              b4[o] = c;
            } else if (p == 1) {
              float a = taps.g[0] * v[o], b = taps.xg[0] * v[o];
#pragma unroll
              for (int q = 1; q < K; ++q) {
                a = a + taps.g[q] * v[o + q];
                b = b + taps.xg[q] * v[o + q];
              }
              b3[o] = a;
              b6[o] = b;
            } else {
              float a = taps.g[0] * v[o];
#pragma unroll
              for (int q = 1; q < K; ++q) a = a + taps.g[q] * v[o + q];
              b5[o] = a;
            }
          }
        }
      } else {
#pragma unroll
        for (int o = 0; o < kRun; ++o) {
          const float* r0 = row + o;
          const float* r1 = r0 + vplane;
          const float* r2 = r1 + vplane;
          float a = __ldg(cg) * r0[0], b = __ldg(cxg) * r0[0], c = __ldg(cxxg) * r0[0];
          float d = __ldg(cg) * r1[0], e = __ldg(cxg) * r1[0];
          float f = __ldg(cg) * r2[0];
          for (int q = 1; q < k; ++q) {
            a = a + __ldg(cg + q) * r0[q];
            b = b + __ldg(cxg + q) * r0[q];
            c = c + __ldg(cxxg + q) * r0[q];
            d = d + __ldg(cg + q) * r1[q];
            e = e + __ldg(cxg + q) * r1[q];
            f = f + __ldg(cg + q) * r2[q];
          }
          b1[o] = a;
          b2[o] = b;
          b4[o] = c;
          b3[o] = d;
          b6[o] = e;
          b5[o] = f;
        }
      }
      if (y >= h) continue;
      float res[5][kRun];
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        res[0][o] = b3[o] * ig11;
        res[1][o] = b2[o] * ig11;
        res[2][o] = b1[o] * ig03 + b5[o] * ig33;
        res[3][o] = b1[o] * ig03 + b4[o] * ig33;
        res[4][o] = b6[o] * ig55;
      }
      const int x = tl.x0 + q4;
      float* o0 = out + tl.b * 5 * plane + (long long)y * w + x;
      if (vec && x + kRun <= w) {
#pragma unroll
        for (int ch = 0; ch < 5; ++ch)
          *reinterpret_cast<float4*>(o0 + ch * plane) =
              make_float4(res[ch][0], res[ch][1], res[ch][2], res[ch][3]);
      } else {
#pragma unroll
        for (int o = 0; o < kRun; ++o) {
          if (x + o >= w) break;
#pragma unroll
          for (int ch = 0; ch < 5; ++ch) o0[ch * plane + o] = res[ch][o];
        }
      }
    }
    buf ^= 1;
  }
}

// v rounded to bfloat16 (nearest, ties to even) and widened back to float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One row's horizontal lerp (1 - ax)·v0 + ax·v1.  kBf16 is the TPU kernel's
// bf16 candidate MAC: taps and weights rounded to bfloat16 (1 - ax taken in
// float first), each product and the sum rounded, the (1 - ax)·v0 term
// first; ops/farneback.py _lerp_x is its plain version.
template <bool kBf16>
__device__ __forceinline__ float lerp_x(float v0, float v1, float ax) {
  if constexpr (kBf16) {
    const float omx = round_bf16(1.f - ax);
    const float axb = round_bf16(ax);
    return round_bf16(round_bf16(round_bf16(v0) * omx) + round_bf16(round_bf16(v1) * axb));
  } else {
    return v0 * (1.f - ax) + v1 * ax;
  }
}

// One pixel's M from its r0 coefficients a0…a4, flow (dx, dy) and rim
// damping `scale`, with r1b the 5 planes of frame b+1's expansion (plane
// stride plane_ext); o = [G_yy, G_xy, G_xx, h_y, h_x].  K2's walk, K2's
// row-offset instance and K4 all call it (the latter two through
// matrices_pixel), so they cannot drift apart.
//
// Row-offset form (a height shard, ops/farneback.py
// update_matrices_rows_cf_plain): y is the row inside a shard that holds
// rows [row_off, row_off + h) of an image of h_glob rows, r1 the same rows
// with `halo` rows above and below (h_ext = h + 2·halo rows); warp targets
// are global rows, and one whose floor row lies outside r1 counts as
// outside the image.  The whole image is row_off = halo = 0, h_glob = h_ext.
template <bool kBf16>
__device__ __forceinline__ void matrices_math(const float* __restrict__ r1b, long long plane_ext,
                                              int y, int x, int w, int row_off, int halo,
                                              int h_glob, int h_ext, float a0, float a1, float a2,
                                              float a3, float a4, float dx, float dy, float scale,
                                              float o[5]) {
  const float fx = (float)x + dx;
  const float fy = (float)(row_off + y) + dy;
  const float fxf = floorf(fx);
  const float fyf = floorf(fy);
  const float ax = fx - fxf;
  const float ay = fy - fyf;
  // Clamp before the cast: (int) truncates and overflows; [-2, size]
  // keeps the guard's verdict.  fmaxf maps a NaN to -2 (outside).
  const int xi = (int)fminf(fmaxf(fxf, -2.f), (float)w);
  const int yi = (int)fminf(fmaxf(fyf, -2.f), (float)h_glob);
  const int ye = yi - row_off + halo;  // the floor row inside r1
  const bool inside = xi >= 0 && xi < w - 1 && yi >= 0 && yi < h_glob - 1 && ye >= 0 &&
                      ye < h_ext - 1;
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (inside) {
    const float* c = r1b + (long long)ye * w + xi;
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) {
      const float* p = c + ch * plane_ext;
      const float top = lerp_x<kBf16>(p[0], p[1], ax);
      const float bot = lerp_x<kBf16>(p[w], p[w + 1], ax);
      s[ch] = top * (1.f - ay) + bot * ay;
    }
  }
  float r4 = inside ? (a2 + s[2]) * 0.5f : a2;
  float r5 = inside ? (a3 + s[3]) * 0.5f : a3;
  float r6 = inside ? (a4 + s[4]) * 0.25f : a4 * 0.5f;
  float r2 = (a0 - s[0]) * 0.5f;  // s is 0 outside the guard
  float r3 = (a1 - s[1]) * 0.5f;
  r2 = r2 + r4 * dy + r6 * dx;
  r3 = r3 + r6 * dy + r5 * dx;
  r2 *= scale;
  r3 *= scale;
  r4 *= scale;
  r5 *= scale;
  r6 *= scale;
  o[0] = r4 * r4 + r6 * r6;
  o[1] = (r4 + r5) * r6;
  o[2] = r5 * r5 + r6 * r6;
  o[3] = r4 * r2 + r6 * r3;
  o[4] = r6 * r2 + r5 * r3;
}

// One pixel (b, y, x) of M read from and written to global memory (K2's
// row-offset instance and K4); rim = [sy (h), sx (w)], the rim damping at
// (y, x) is sy[y] * sx[x].  The whole image is row_off = halo = 0,
// h_glob = h.
template <bool kBf16>
__device__ __forceinline__ void matrices_pixel(const float* __restrict__ r0,
                                               const float* __restrict__ r1,
                                               const float* __restrict__ flow,
                                               const float* __restrict__ rim,
                                               float* __restrict__ m, long long b, int y, int x,
                                               int h, int w, int row_off, int halo, int h_glob) {
  const long long plane = (long long)h * w;
  const int h_ext = h + 2 * halo;
  const long long plane_ext = (long long)h_ext * w;
  const long long pix = (long long)y * w + x;
  const float* a = r0 + b * 5 * plane + pix;
  const float* f = flow + b * 2 * plane + pix;
  float o[5];
  matrices_math<kBf16>(r1 + b * 5 * plane_ext, plane_ext, y, x, w, row_off, halo, h_glob, h_ext,
                       a[0], a[plane], a[2 * plane], a[3 * plane], a[4 * plane], f[0], f[plane],
                       rim[y] * rim[h + x], o);
  float* out = m + b * 5 * plane + pix;
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) out[ch * plane] = o[ch];
}

// K2's row-offset instance (a height shard, see matrices_math), one thread
// per pixel on kThreadsX × kThreadsY blocks, pair-major over grid z.  It is
// also the pre-walk design of K2 (row_off = halo = 0, h_glob = h), kept so
// that a run can time the two on the same tensors.
template <bool kBf16>
__global__ void update_matrices_rows_kernel(const float* __restrict__ r0,
                                            const float* __restrict__ r1,
                                            const float* __restrict__ flow,
                                            const float* __restrict__ rim, float* __restrict__ m,
                                            long long batch, int h, int w, int row_off, int halo,
                                            int h_glob) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z)
    matrices_pixel<kBf16>(r0, r1, flow, rim, m, b, y, x, h, w, row_off, halo, h_glob);
}

// K2's walk: one block of kThreads threads owns one kWalkH × kWalkW tile of
// the box [y_lo, y_hi) × [x_lo, x_hi) (the whole level: (0, h, 0, w)), one
// pixel a thread, and walks the pairs b0 … b1-1 of one run in order; unit
// u = run · n_tiles + tile, so the blocks in flight hold neighbouring tiles
// of one run.  Pair b's corner gathers pull frame b+1's expansion around the
// tile into L1/L2 just before pair b+1 reads that tile as its r0.  Each warp
// is one tile row: its loads of r0 and flow and its stores of M are whole
// 128-byte rows, its gathers span a row's neighbourhood.  A thread holds the
// next pair's flow in registers, loaded before this pair's gathers are
// consumed, so that the next pair's gathers (whose addresses need it) issue
// at once, together with its r0 loads: one round trip to memory per pair.
// No shared memory and no barrier: r1 is read from global memory only, so
// the result does not depend on whether r1 aliases r0 shifted by one frame.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kWalkMinBlocks)
    update_matrices_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                           const float* __restrict__ flow, const float* __restrict__ rim,
                           float* __restrict__ m, long long batch, int h, int w, int y_lo,
                           int y_hi, int x_lo, int x_hi, int n_tx, int n_tiles,
                           int pairs_per_run) {
  const int run = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - run * n_tiles;
  const int ty = tile / n_tx;
  const int y = y_lo + ty * kWalkH + threadIdx.x / kWalkW;
  const int x = x_lo + (tile - ty * n_tx) * kWalkW + threadIdx.x % kWalkW;
  if (y >= y_hi || x >= x_hi) return;
  const long long b0 = (long long)run * pairs_per_run;
  const int n = (int)(b0 + pairs_per_run < batch ? pairs_per_run : batch - b0);
  const float scale = rim[y] * rim[h + x];
  const long long plane = (long long)h * w;
  const long long pix = (long long)y * w + x;
  // Pair b's planes: r0 and M at this pixel, flow at this pixel, and frame
  // b+1's expansion for the gathers.
  const float* a = r0 + b0 * 5 * plane + pix;
  const float* f = flow + b0 * 2 * plane + pix;
  const float* c = r1 + b0 * 5 * plane;
  float* o = m + b0 * 5 * plane + pix;
  float dx = f[0], dy = f[plane];
  for (int k = 0; k < n; ++k) {
    const float a0 = a[0], a1 = a[plane], a2 = a[2 * plane], a3 = a[3 * plane],
                a4 = a[4 * plane];
    float ndx = 0.f, ndy = 0.f;
    if (k + 1 < n) {  // the next pair's flow, in flight during this pair
      ndx = f[2 * plane];
      ndy = f[3 * plane];
    }
    float out[5];
    matrices_math<kBf16>(c, plane, y, x, w, 0, 0, h, h, a0, a1, a2, a3, a4, dx, dy, scale, out);
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) o[ch * plane] = out[ch];
    dx = ndx;
    dy = ndy;
    a += 5 * plane;
    f += 2 * plane;
    c += 5 * plane;
    o += 5 * plane;
  }
}

// sel: the listed tiles' flat ids (b * n_i + i) * n_j + j on the
// blockDim.y × blockDim.x lattice of the (h, w) level, n_i = ceil(h /
// blockDim.y), n_j = ceil(w / blockDim.x).  Block s computes tile sel[s],
// one thread per pixel (K2's block); pixels past the level's edge are
// skipped and M outside the listed tiles is left as it was.
template <bool kBf16>
__global__ void update_matrices_tiles_kernel(const float* __restrict__ r0,
                                             const float* __restrict__ r1,
                                             const float* __restrict__ flow,
                                             const float* __restrict__ rim,
                                             const int* __restrict__ sel, float* __restrict__ m,
                                             int h, int w) {
  const int n_i = (h + blockDim.y - 1) / blockDim.y;
  const int n_j = (w + blockDim.x - 1) / blockDim.x;
  const int tile = sel[blockIdx.x];  // ids < 2^31: sel is int32
  const int b = tile / (n_i * n_j);
  const int rem = tile - b * (n_i * n_j);
  const int i = rem / n_j;
  const int y = i * blockDim.y + threadIdx.y;
  const int x = (rem - i * n_j) * blockDim.x + threadIdx.x;
  if (y < h && x < w) matrices_pixel<kBf16>(r0, r1, flow, rim, m, b, y, x, h, w, 0, 0, h);
}

// K3's taps: the window's separable weights (winsize ≤ 31) and, for the
// box, the final scale 1/winsize².
struct FlowTaps {
  float w[kMaxTaps - 1];
  float scale;
};

// weights = [w (winsize), scale]: the run-time instance (R < 0) reads the
// taps from here, the others from taps.  The box [y_lo, y_hi] × [x_lo, x_hi]
// (inclusive) is the image the kernel solves: M is read clamped to it, as
// replicate borders at its edges, and flow is written only inside it.  The
// whole level is the box (0, h-1, 0, w-1).
// At most 85 registers, so that 3 blocks of 256 threads share an SM: the
// third block's vertical and horizontal passes fill the other two's
// barrier waits.
template <int R, bool kBox>
__global__ void __launch_bounds__(kThreads, 3)
    update_flow_kernel(const float* __restrict__ m, const FlowTaps taps,
                       const float* __restrict__ weights, float* __restrict__ out,
                       long long batch, int h, int w, int r_rt, int y_lo, int y_hi, int x_lo,
                       int x_hi, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int NS = n_strips(R, R >= 0);
  constexpr int SEG = strip_rows(R, R >= 0);
  const int r = R >= 0 ? R : r_rt;
  const int k = 2 * r + 1;
  const int sw = stage_w(r);
  const int svw = vsum_w(r);
  const int in_rows = NS * SEG + 2 * r;
  const int nc = kTW + 2 * r;  // columns of the vertical pass
  const int buf_floats = in_rows * sw;
  float* s_v = smem + 2 * buf_floats;  // NS·SEG × svw vertical sums of one plane
  const int n_tx = (x_hi - x_lo + kTW) / kTW;
  const long long per_frame = (long long)((y_hi - y_lo + kTH) / kTH) * n_tx;
  const long long n_tiles = batch * per_frame;
  const long long plane = (long long)h * w;
  const float scale = R >= 0 ? taps.scale : __ldg(weights + k);

  long long t = blockIdx.x;
  if (t >= n_tiles) return;
  {
    const Tile tl = tile_at(t, per_frame, n_tx, y_lo, x_lo, r);
    stage_rows(smem, sw, m + tl.b * 5 * plane, w, tl.y0 - r, in_rows, tl.xs,
               (nc + tl.delta + 3) / 4, y_lo, y_hi, x_lo, x_hi, vec);
    cp_async_commit();
  }
  const int q4 = (threadIdx.x & (kRunsPerRow - 1)) * kRun;
  const int j0 = threadIdx.x / kRunsPerRow;
  int buf = 0;
  for (; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, per_frame, n_tx, y_lo, x_lo, r);
    float sum[5][2][kRun];  // the window sums of this thread's 8 pixels
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) {
      // Prefetch the next unit (the next plane, else plane 0 of the next tile).
      const long long nt = ch < 4 ? t : t + gridDim.x;
      if (nt < n_tiles) {
        const Tile nx = ch < 4 ? tl : tile_at(nt, per_frame, n_tx, y_lo, x_lo, r);
        stage_rows(smem + (buf ^ 1) * buf_floats, sw, m + (nx.b * 5 + (ch < 4 ? ch + 1 : 0)) * plane,
                   w, nx.y0 - r, in_rows, nx.xs, (nc + nx.delta + 3) / 4, y_lo, y_hi, x_lo, x_hi,
                   vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* s_in = smem + buf * buf_floats + tl.delta;
      // Vertical pass: column c of strip seg, SEG rows.
      for (int it = threadIdx.x; it < NS * nc; it += kThreads) {
        const int seg = it / nc;
        const int c = it - seg * nc;
        const float* col = s_in + seg * SEG * sw + c;
        float* dst = s_v + seg * SEG * svw + c;
        if constexpr (R >= 0) {
          float v[SEG + 2 * R];
#pragma unroll
          for (int i = 0; i < SEG + 2 * R; ++i) v[i] = col[i * sw];
#pragma unroll
          for (int j = 0; j < SEG; ++j) {
            float a = kBox ? v[j] : taps.w[0] * v[j];
#pragma unroll
            for (int q = 1; q < 2 * R + 1; ++q) a = kBox ? a + v[j + q] : a + taps.w[q] * v[j + q];
            dst[j * svw] = a;
          }
        } else {
          for (int j = 0; j < SEG; ++j) {
            float a = kBox ? col[j * sw] : __ldg(weights) * col[j * sw];
            for (int q = 1; q < k; ++q)
              a = kBox ? a + col[(j + q) * sw] : a + __ldg(weights + q) * col[(j + q) * sw];
            dst[j * svw] = a;
          }
        }
      }
      __syncthreads();
      // Horizontal pass: 4 adjacent outputs of rows j0 and j0 + 16.
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float* row = s_v + (j0 + rr * kRowsPerPass) * svw + q4;
        if constexpr (R >= 0) {
          constexpr int NV = round4(kRun + 2 * R);
          float v[NV];
#pragma unroll
          for (int i = 0; i < NV / 4; ++i) {
            const float4 f = *reinterpret_cast<const float4*>(row + 4 * i);
            v[4 * i] = f.x;
            v[4 * i + 1] = f.y;
            v[4 * i + 2] = f.z;
            v[4 * i + 3] = f.w;
          }
#pragma unroll
          for (int o = 0; o < kRun; ++o) {
            float a = kBox ? v[o] : taps.w[0] * v[o];
#pragma unroll
            for (int q = 1; q < 2 * R + 1; ++q) a = kBox ? a + v[o + q] : a + taps.w[q] * v[o + q];
            sum[ch][rr][o] = kBox ? a * scale : a;
          }
        } else {
#pragma unroll
          for (int o = 0; o < kRun; ++o) {
            float a = kBox ? row[o] : __ldg(weights) * row[o];
            for (int q = 1; q < k; ++q)
              a = kBox ? a + row[o + q] : a + __ldg(weights + q) * row[o + q];
            sum[ch][rr][o] = kBox ? a * scale : a;
          }
        }
      }
      buf ^= 1;
    }
    // The regularized 2×2 solve and the two flow planes.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int y = tl.y0 + j0 + rr * kRowsPerPass;
      if (y > y_hi) continue;
      float fx[kRun], fy[kRun];
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        const float g11 = sum[0][rr][o], g12 = sum[1][rr][o], g22 = sum[2][rr][o];
        const float h1 = sum[3][rr][o], h2 = sum[4][rr][o];
        const float idet = 1.f / (g11 * g22 - g12 * g12 + 1e-3f);
        fx[o] = (g11 * h2 - g12 * h1) * idet;
        fy[o] = (g22 * h1 - g12 * h2) * idet;
      }
      const int x = tl.x0 + q4;
      float* o0 = out + tl.b * 2 * plane + (long long)y * w + x;
      if (vec && (x & 3) == 0 && x + kRun - 1 <= x_hi) {
        *reinterpret_cast<float4*>(o0) = make_float4(fx[0], fx[1], fx[2], fx[3]);
        *reinterpret_cast<float4*>(o0 + plane) = make_float4(fy[0], fy[1], fy[2], fy[3]);
      } else {
#pragma unroll
        for (int o = 0; o < kRun; ++o) {
          if (x + o > x_hi) break;
          o0[o] = fx[o];
          o0[plane + o] = fy[o];
        }
      }
    }
  }
}

// K1 has compile-time instances for n = 1…8, K3 for winsize 3…31.
bool poly_fixed(int n) { return n >= 1 && n <= 8; }
bool flow_fixed(int r) { return r >= 1 && r <= 15; }

size_t poly_smem_bytes(int n) {
  const int rows = vert_rows(n, poly_fixed(n));
  const size_t floats = 2 * (size_t)(rows + 2 * n) * stage_w(n) + 3 * (size_t)rows * vsum_w(n);
  return floats * sizeof(float);
}

size_t flow_smem_bytes(int winsize) {
  const int r = winsize / 2;
  const int rows = vert_rows(r, flow_fixed(r));
  const size_t floats = 2 * (size_t)(rows + 2 * r) * stage_w(r) + (size_t)rows * vsum_w(r);
  return floats * sizeof(float);
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

unsigned grid_z(long long batch) { return (unsigned)(batch < kMaxGridZ ? batch : kMaxGridZ); }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Launch a persistent kernel of kThreads-thread blocks over n_units units:
// as many blocks as fit on the card at once, and no more than the units.
template <typename... KernelArgs, typename... Args>
cudaError_t launch_persistent(void (*kernel)(KernelArgs...), size_t smem, long long n_units,
                              cudaStream_t stream, Args... args) {
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(n_units < fit ? n_units : fit);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_poly(const float* img, const PolyTaps& taps, const float* consts, float* out,
                        long long batch, int h, int w, int n, cudaStream_t stream) {
  const long long units = batch * ((h + kTH - 1) / kTH) * (long long)((w + kTW - 1) / kTW);
  const int vec = w % 4 == 0 && aligned16(img) && aligned16(out);
  return launch_persistent(poly_exp_kernel<N>, poly_smem_bytes(n), units, stream, img, taps,
                           consts, out, batch, h, w, n, vec);
}

template <int R, bool kBox>
cudaError_t launch_flow(const float* m, const FlowTaps& taps, const float* weights, float* out,
                        long long batch, int h, int w, int r, int y_lo, int y_hi, int x_lo,
                        int x_hi, cudaStream_t stream) {
  const long long units = batch * ((y_hi - y_lo + kTH) / kTH) * (long long)((x_hi - x_lo + kTW) / kTW);
  const int vec = w % 4 == 0 && aligned16(m) && aligned16(out);
  return launch_persistent(update_flow_kernel<R, kBox>, flow_smem_bytes(2 * r + 1), units, stream,
                           m, taps, weights, out, batch, h, w, r, y_lo, y_hi, x_lo, x_hi, vec);
}

template <bool kBox>
cudaError_t dispatch_flow(const float* m, const FlowTaps& taps, const float* weights, float* out,
                          long long batch, int h, int w, int r, int y_lo, int y_hi, int x_lo,
                          int x_hi, cudaStream_t stream) {
#define FB_FLOW_CASE(RR) \
  case RR:               \
    return launch_flow<RR, kBox>(m, taps, weights, out, batch, h, w, r, y_lo, y_hi, x_lo, x_hi, stream);
  switch (r) {
    FB_FLOW_CASE(1)
    FB_FLOW_CASE(2)
    FB_FLOW_CASE(3)
    FB_FLOW_CASE(4)
    FB_FLOW_CASE(5)
    FB_FLOW_CASE(6)
    FB_FLOW_CASE(7)
    FB_FLOW_CASE(8)
    FB_FLOW_CASE(9)
    FB_FLOW_CASE(10)
    FB_FLOW_CASE(11)
    FB_FLOW_CASE(12)
    FB_FLOW_CASE(13)
    FB_FLOW_CASE(14)
    FB_FLOW_CASE(15)
    default:
      return launch_flow<-1, kBox>(m, taps, weights, out, batch, h, w, r, y_lo, y_hi, x_lo, x_hi,
                                   stream);
  }
#undef FB_FLOW_CASE
}

}  // namespace

extern "C" {

int fb_poly_exp_smem_bytes(int n) { return (int)poly_smem_bytes(n); }

int fb_update_flow_smem_bytes(int winsize) { return (int)flow_smem_bytes(winsize); }

const char* fb_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// consts_host / consts_dev: [g (K), xg (K), xxg (K), ig11, ig03, ig33, ig55],
// K = 2n+1, on the host (for the taps passed as kernel parameters) and on
// the device (read by the run-time-radius instance).
int fb_poly_exp(const float* img, const float* consts_host, const float* consts_dev, float* out,
                long long batch, int h, int w, int n, void* stream) {
  const int k = 2 * n + 1;
  PolyTaps taps = {};
  if (n <= 8) {
    for (int i = 0; i < k; ++i) {
      taps.g[i] = consts_host[i];
      taps.xg[i] = consts_host[k + i];
      taps.xxg[i] = consts_host[2 * k + i];
    }
  }
  taps.ig11 = consts_host[3 * k];
  taps.ig03 = consts_host[3 * k + 1];
  taps.ig33 = consts_host[3 * k + 2];
  taps.ig55 = consts_host[3 * k + 3];
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define FB_POLY_CASE(NN) \
  case NN:               \
    return (int)launch_poly<NN>(img, taps, consts_dev, out, batch, h, w, n, s);
    FB_POLY_CASE(1)
    FB_POLY_CASE(2)
    FB_POLY_CASE(3)
    FB_POLY_CASE(4)
    FB_POLY_CASE(5)
    FB_POLY_CASE(6)
    FB_POLY_CASE(7)
    FB_POLY_CASE(8)
#undef FB_POLY_CASE
    default:
      return (int)launch_poly<-1>(img, taps, consts_dev, out, batch, h, w, n, s);
  }
}

// K2's row-offset instance (r1 has h + 2·halo rows, rim = [sy of the
// shard's global rows, sx]); with row_off = halo = 0, h_glob = h it is the
// pre-walk design of K2 over the whole image.  bf16 selects the bf16
// horizontal lerp.
int fb_update_matrices_rows(const float* r0, const float* r1, const float* flow, const float* rim,
                            float* m, long long batch, int h, int w, int row_off, int halo,
                            int h_glob, int bf16, void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kThreadsX - 1) / kThreadsX, (h + kThreadsY - 1) / kThreadsY,
                  grid_z(batch));
  auto kernel = bf16 ? update_matrices_rows_kernel<true> : update_matrices_rows_kernel<false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(r0, r1, flow, rim, m, batch, h, w, row_off,
                                                   halo, h_glob);
  return (int)cudaGetLastError();
}

// K2's walk over the box [y_lo, y_hi) × [x_lo, x_hi) of the (h, w) level
// (the whole level: 0, h, 0, w), runs of pairs_per_run pairs; M outside the
// box is not written.  rim = [sy (h), sx (w)].
int fb_update_matrices(const float* r0, const float* r1, const float* flow, const float* rim,
                       float* m, long long batch, int h, int w, int y_lo, int y_hi, int x_lo,
                       int x_hi, int pairs_per_run, int bf16, void* stream) {
  if (batch < 1 || pairs_per_run < 1 || y_lo >= y_hi || x_lo >= x_hi)
    return (int)cudaErrorInvalidValue;
  const int n_tx = (x_hi - x_lo + kWalkW - 1) / kWalkW;
  const long long n_tiles = (long long)((y_hi - y_lo + kWalkH - 1) / kWalkH) * n_tx;
  const long long units = n_tiles * ((batch + pairs_per_run - 1) / pairs_per_run);
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kernel = bf16 ? update_matrices_kernel<true> : update_matrices_kernel<false>;
  kernel<<<(unsigned)units, kThreads, 0, (cudaStream_t)stream>>>(
      r0, r1, flow, rim, m, batch, h, w, y_lo, y_hi, x_lo, x_hi, n_tx, (int)n_tiles,
      pairs_per_run);
  return (int)cudaGetLastError();
}

// Blocks of K2's walk that the card holds at once (blocks per SM × SMs):
// the wrapper sizes the runs of pairs from it.
int fb_update_matrices_resident(int bf16, int* out) {
  auto kernel = bf16 ? update_matrices_kernel<true> : update_matrices_kernel<false>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *out = per_sm * sms;
  return 0;
}

// weights_host / weights_dev: [w (winsize), scale] on the host and the device.
int fb_update_flow(const float* m, const float* weights_host, const float* weights_dev, float* out,
                   long long batch, int h, int w, int winsize, int gaussian, int y_lo, int y_hi,
                   int x_lo, int x_hi, void* stream) {
  FlowTaps taps = {};
  if (winsize < kMaxTaps)
    for (int i = 0; i < winsize; ++i) taps.w[i] = weights_host[i];
  taps.scale = weights_host[winsize];
  const int r = winsize / 2;
  const cudaStream_t s = (cudaStream_t)stream;
  if (gaussian)
    return (int)dispatch_flow<false>(m, taps, weights_dev, out, batch, h, w, r, y_lo, y_hi, x_lo,
                                     x_hi, s);
  return (int)dispatch_flow<true>(m, taps, weights_dev, out, batch, h, w, r, y_lo, y_hi, x_lo,
                                  x_hi, s);
}

int fb_update_matrices_tiles(const float* r0, const float* r1, const float* flow,
                             const float* rim, const int* sel, float* m, long long n_tiles, int h,
                             int w, int tile_h, int tile_w, int bf16, void* stream) {
  const dim3 block(tile_w, tile_h);  // one thread per pixel of a tile
  auto kernel = bf16 ? update_matrices_tiles_kernel<true> : update_matrices_tiles_kernel<false>;
  kernel<<<(unsigned)n_tiles, block, 0, (cudaStream_t)stream>>>(r0, r1, flow, rim, sel, m, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
