// TV-L1 kernels for Hopper (sm_90a), with a plain C interface.
//
// K5 warp_sample_kernel<C> — replaces btcs_pnes_optical_flow_tpu/ops/farneback_pallas.py
//    warp_sample_banded_cf (body _make_sample_kernel).  Samples C source planes
//    at (x+u, y+v) with cv2.remap's clamp (gx = clip(x+u, 0, w-1)) and bilinear
//    weights; TV-L1 warps (I1, I1x, I1y) with it once per warp.
//    Bound: memory — 2 flow floats in and C floats out per pixel, plus 4 taps
//    per channel that neighbouring threads share through L1/L2; ~6 flops per
//    channel.  The gathers depend on the flow loads, so what the kernel needs
//    is many loads in flight per SM and few cache lines per load instruction.
//    Design: a warp takes 128 adjacent pixels of a row and lane l the pixels
//    l, l+32, l+64 and l+96, so each warp instruction (flow loads, tap
//    gathers, stores) covers 32 adjacent pixels and the gathers of smooth
//    flow touch two or three lines a row; a thread computes the clamp, floor
//    and fractions of its 4 pixels, then issues all 4 × 4 × C tap gathers
//    through the read-only path before the first blend.  (A thread taking 4
//    contiguous pixels with 16-byte flow loads and stores ran slower on an
//    H100: its gathers spread each warp instruction over 128 pixels.)
//    The grid is flat over (B·H rows × 128-pixel segments); offsets inside a
//    frame are 32-bit, the frame base 64-bit.  The TPU kernel fetched a band
//    of rows and scanned an anchored window because a TPU gather costs ~20 ns
//    an index; Hopper gathers through its caches, so there is no band, no
//    window, no reach limit, and the clip count is zero by construction.
//
// K6 pd_block_kernel<D> — replaces btcs_pnes_optical_flow_tpu/ops/tvl1_pallas.py
//    pd_chain_resident (body _pd_kernel_factory).  One warp's Chambolle
//    primal–dual chain: thresholding of the linearised data term, u/v update
//    with div p, p update with grad of the new u/v; the duals start at zero
//    and the chain runs n_iterations steps with no early exit.
//    Bound: per iteration ~60 float32 operations per pixel (two IEEE square
//    roots and two divisions among them) against 72 bytes if every iteration
//    went through device memory, so a chain that keeps its state on chip is
//    bound by operations — in practice by instruction issue (the IEEE square
//    root and reciprocal sequences, the edge selects and the indexing).
//    Design (temporal blocking): one launch runs D iterations on 32×64 output
//    tiles.  One iteration reaches one pixel in every direction (div p reads
//    x−1 and y−1, grad of the new u, v reads x+1 and y+1), so a block stages
//    the tile grown by D pixels on each side ((32+2D)×(64+2D), clamped loads)
//    and recomputes that halo: after iteration j the values are exact on the
//    tile grown by D−j, and the tile itself after D.  Rows that no exact
//    output can reach any more are skipped (iteration j computes u, v on rows
//    j … RH−j and the duals on rows j … RH−1−j of the region).  A block of
//    1024 threads owns the region in horizontal pairs of pixels; a thread
//    keeps u, v and the invariants of its pairs in registers, and shared
//    memory holds the six state planes, read and written 8 bytes a pair,
//    with two barriers per iteration (after the new u, v, after the new
//    duals); the neighbour inside a pair comes from registers.  The grad/div
//    boundary rules apply at image edges by global index (4 flag bits per
//    pixel, set once per tile), never at tile or region edges; an in-image
//    value never reads a pixel outside the image, so the clamped halo beyond
//    it never reaches a result.  A chain is ceil(n_iterations / D) launches
//    (ops/tvl1_cuda.py pd_schedule): the first starts the duals at zero
//    without reading them, every launch recomputes the invariants
//    (l_t·|∇I|², -1/max(|∇I|², 1e-9)) with the same float32 operations, the
//    middle ones write u, v and the duals to the other buffer of a ping-pong
//    pair, and the last writes u and v only.  The TPU kernel kept the whole
//    chain in VMEM with a 2·n_iterations-row halo; Hopper's 227 KB per block
//    holds a D-deep one.  Blocks are persistent over (frame, tile) units, so
//    ragged tiles and any batch are covered without a grid-z loop.
//
// K6 ε step pd_eps_step_kernel — replaces no TPU kernel: the JAX package runs
//    this loop in XLA ops (the lax.while_loop of its "xla" engine,
//    btcs_pnes_optical_flow_tpu/ops/tvl1.py pd_iter).  One
//    iteration of the per-pair ε loop (ops/tvl1.py pd_chain_plain with
//    epsilon > 0), which runs at the pyramid levels whose fixed-length chain
//    _resident_ok rejects (1080p levels 0–1, 720p level 0): the loop reads
//    whether any pair still iterates after every step, so one launch is one
//    iteration.  Outputs repeat the plain loop: u_out = active[b] ? u_new : u
//    (the pair's mask from before this step's stop test), the duals from the
//    gradient of u_new whatever the mask, and the squared update
//    (u_new−u)² + (v_new−v)² whose per-pair mean the wrapper takes with the
//    plain loop's own reduction.
//    Bound: bytes — 6 planes in and u, v, 4 duals and the squared update out
//    (52 B a pixel, the first step reading no duals) or 4 duals more in
//    (68 B) against ~50 float32 operations.  The plain loop streams ~90
//    whole planes an iteration (~1 KB a pixel).
//    Design: K6's depth-1 region and arithmetic (the 32×64 tile grown by one
//    pixel, the duals staged with cp.async, the same primal() and dual()),
//    so it is bit-equal to a plain iteration as K6 is.  With one iteration
//    nothing needs to stay on chip between steps, so the kernel is cut for
//    memory traffic instead: 256-thread blocks, one (frame, tile) unit each,
//    four resident per SM, so that one block's loads overlap another's
//    arithmetic; the state and invariants are read straight into registers
//    in the primal step (no staging of u, v), u_out, v_out and the squared
//    update are written from there, and the duals from the dual step, with
//    no write-back through shared memory.  The invariants l_t·|∇I|² and
//    -1/max(|∇I|², 1e-9) are computed in registers as in K6: the plain
//    loop's set-up planes are never written.
//
// Built with -fmad=false (ops/_build.py): every product is rounded before its sum,
// so each kernel repeats the float32 operations of its plain PyTorch version
// (ops/tvl1.py warp_sample_cf_plain, pd_chain_plain) in their order; sqrtf and the
// divisions are IEEE-rounded (no fast math).
//
// Every launcher returns cudaGetLastError() after launching on the caller's
// stream; it neither synchronises nor allocates.

#include <cuda_runtime.h>

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------- K5

constexpr int kWarpThreads = 256;
constexpr int kRun = 4;  // pixels of one thread, 32 apart

// The four tap offsets (inside one frame) and the fractions of pixel (y, x)
// displaced by (u, v), clamped as cv2.remap's border-replicate.
struct Tap {
  int o00, o01, o10, o11;
  float fx, fy;
};

__device__ __forceinline__ Tap tap_at(float u, float v, int y, int x, int h, int w) {
  const float gx = fminf(fmaxf((float)x + u, 0.f), (float)(w - 1));
  const float gy = fminf(fmaxf((float)y + v, 0.f), (float)(h - 1));
  const float x0f = floorf(gx);
  const float y0f = floorf(gy);
  Tap t;
  t.fx = gx - x0f;
  t.fy = gy - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
  const int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
  t.o00 = y0 * w + x0;
  t.o01 = y0 * w + x1;
  t.o10 = y1 * w + x0;
  t.o11 = y1 * w + x1;
  return t;
}

__device__ __forceinline__ float blend(float a00, float a01, float a10, float a11, const Tap& t) {
  const float top = a00 * (1.f - t.fx) + a01 * t.fx;
  const float bot = a10 * (1.f - t.fx) + a11 * t.fx;
  return top * (1.f - t.fy) + bot * t.fy;
}

// src (B, C, H, W), flow (B, 2, H, W) with channels (u, v) → out (B, C, H, W).
// A warp takes 128 adjacent pixels of a row and lane l takes pixels l, l+32,
// l+64 and l+96 of them.  C > 0 is a compile-time channel count (all gathers
// issued before the first blend); C = 0 takes c_rt channels, gathering one
// channel at a time.  The wrapper guarantees C·H·W < 2^31 and
// B·H·ceil(W/128)·32 < 2^31.
template <int C>
__global__ void __launch_bounds__(kWarpThreads)
    warp_sample_kernel(const float* __restrict__ src, const float* __restrict__ flow,
                       float* __restrict__ out, int n_units, int c_rt, int h, int w) {
  const int c = C > 0 ? C : c_rt;
  const int segs = (w + 32 * kRun - 1) / (32 * kRun);
  const int plane = h * w;
  const int lane = threadIdx.x & 31;
  for (int t = (blockIdx.x * kWarpThreads + threadIdx.x) >> 5; t < n_units;
       t += (gridDim.x * kWarpThreads) >> 5) {
    const int row = t / segs;  // b·h + y
    const int xs = (t - row * segs) * 32 * kRun + lane;
    const int b = row / h;
    const int y = row - b * h;
    const float* fu = flow + (long long)b * 2 * plane + y * w;
    float u[kRun], v[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const bool in = xs + 32 * k < w;  // past the edge: a clamped dummy sample, not stored
      u[k] = in ? __ldg(fu + xs + 32 * k) : 0.f;
      v[k] = in ? __ldg(fu + plane + xs + 32 * k) : 0.f;
    }
    Tap tp[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) tp[k] = tap_at(u[k], v[k], y, xs + 32 * k, h, w);
    const float* s = src + (long long)b * c * plane;
    float* o = out + (long long)b * c * plane + y * w + xs;
    if constexpr (C > 0) {
      float g[C][kRun][4];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          const float* p = s + ch * plane;
          g[ch][k][0] = __ldg(p + tp[k].o00);
          g[ch][k][1] = __ldg(p + tp[k].o01);
          g[ch][k][2] = __ldg(p + tp[k].o10);
          g[ch][k][3] = __ldg(p + tp[k].o11);
        }
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
#pragma unroll
        for (int k = 0; k < kRun; ++k)
          if (xs + 32 * k < w)
            o[ch * plane + 32 * k] =
                blend(g[ch][k][0], g[ch][k][1], g[ch][k][2], g[ch][k][3], tp[k]);
    } else {
      for (int ch = 0; ch < c; ++ch) {
        const float* p = s + ch * plane;
        float g[kRun][4];
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          g[k][0] = __ldg(p + tp[k].o00);
          g[k][1] = __ldg(p + tp[k].o01);
          g[k][2] = __ldg(p + tp[k].o10);
          g[k][3] = __ldg(p + tp[k].o11);
        }
#pragma unroll
        for (int k = 0; k < kRun; ++k)
          if (xs + 32 * k < w)
            o[ch * plane + 32 * k] = blend(g[k][0], g[k][1], g[k][2], g[k][3], tp[k]);
      }
    }
  }
}

// ---------------------------------------------------------------- K6

constexpr int kPdThreads = 1024;
constexpr int kPdTH = 32;  // output rows of a tile
constexpr int kPdTW = 64;  // output columns of a tile

// The staged region of a depth-D launch: the tile grown by D on each side.
// A thread owns horizontal pairs of region pixels (RW is even, so a pair
// never straddles two rows): pair tid + k·kPdThreads for k < SLOTS (at most
// 4, so that the image-edge flags of its 8 pixels share one register).
template <int D>
struct PdRegion {
  static constexpr int RH = kPdTH + 2 * D;
  static constexpr int RW = kPdTW + 2 * D;
  static constexpr int N = RH * RW;
  static constexpr int SLOTS = (N / 2 + kPdThreads - 1) / kPdThreads;
  static_assert(RW % 2 == 0 && SLOTS <= 4, "pairs of one row; flags of 8 pixels in a register");
};

struct PdArgs {
  const float* u;        // (B, H, W) state in
  const float* v;
  const float* p;        // [p11, p12, p21, p22] planes n apart, or null: zero duals
  const float* rho_c;    // (B, H, W) invariant planes of the warp
  const float* i1wx;
  const float* i1wy;
  const float* grad_sq;
  float* u_out;          // (B, H, W) state out: never one of the inputs
  float* v_out;
  float* p_out;          // [p11, p12, p21, p22] out, or null: the chain's last launch
  long long batch;
  int h, w;
  float l_t, theta, tau_theta;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Image-edge flags of a pixel: on the image's first or last column or row
// (by global index; a pixel outside the image has none).
constexpr unsigned kX0 = 1, kX1 = 2, kY0 = 4, kY1 = 8;

// Shared memory: two guard floats, then the planes u, v, p11, p12, p21, p22
// of N floats each (8-byte aligned), then two more guards.  A neighbour index
// is never clamped: at the region's edges it reads the next row, the next
// plane or a guard, all inside the allocation, and that pixel is past every
// exact output's reach.
template <int D>
constexpr size_t pd_smem_bytes() {
  return (4 + 6 * (size_t)PdRegion<D>::N) * sizeof(float);
}

// The primal step of one pixel: thresholding of the data term, then
// u, v + d + θ·div p with the backward differences of the duals (q: the
// pixel's own, left / up: its neighbours').
__device__ __forceinline__ void primal(float& u, float& v, float rc, float wx, float wy, float lg,
                                       float nig, float l_t, float theta, unsigned f, float q11,
                                       float left11, float q12, float up12, float q21,
                                       float left21, float q22, float up22) {
  const float rho = rc + wx * u + wy * v;
  const bool lo = rho < -lg;
  const bool hi = rho > lg;
  const float a1 = l_t * wx;
  const float a2 = l_t * wy;
  const float d1 = lo ? a1 : (hi ? -a1 : rho * (wx * nig));
  const float d2 = lo ? a2 : (hi ? -a2 : rho * (wy * nig));
  const float du = ((f & kX0) ? q11 : ((f & kX1) ? 0.f : q11) - left11) +
                   ((f & kY0) ? q12 : ((f & kY1) ? 0.f : q12) - up12);
  const float dv = ((f & kX0) ? q21 : ((f & kX1) ? 0.f : q21) - left21) +
                   ((f & kY0) ? q22 : ((f & kY1) ? 0.f : q22) - up22);
  u = u + d1 + theta * du;
  v = v + d2 + theta * dv;
}

// The dual step of one pixel with the forward differences of the new u, v
// (right / down: its neighbours'; zero on the image's last column or row).
__device__ __forceinline__ void dual(float u, float v, float ur, float ud, float vr, float vd,
                                     unsigned f, float tt, float& p11, float& p12, float& p21,
                                     float& p22) {
  const float ux = (f & kX1) ? 0.f : ur - u;
  const float uy = (f & kY1) ? 0.f : ud - u;
  const float vx = (f & kX1) ? 0.f : vr - v;
  const float vy = (f & kY1) ? 0.f : vd - v;
  const float r_u = 1.f / (1.f + tt * sqrtf(ux * ux + uy * uy));
  const float r_v = 1.f / (1.f + tt * sqrtf(vx * vx + vy * vy));
  p11 = (p11 + tt * ux) * r_u;
  p12 = (p12 + tt * uy) * r_u;
  p21 = (p21 + tt * vx) * r_v;
  p22 = (p22 + tt * vy) * r_v;
}

template <int D>
__global__ void __launch_bounds__(kPdThreads, 1) pd_block_kernel(const PdArgs a) {
  using R = PdRegion<D>;
  constexpr int RH = R::RH, RW = R::RW, N = R::N, S = R::SLOTS;
  extern __shared__ float4 smem4[];
  float* s_u = reinterpret_cast<float*>(smem4) + 2;
  float* s_v = s_u + N;
  float* s11 = s_v + N;
  float* s12 = s11 + N;
  float* s21 = s12 + N;
  float* s22 = s21 + N;
  const int h = a.h, w = a.w;
  const float l_t = a.l_t, theta = a.theta, tt = a.tau_theta;
  const long long plane = (long long)h * w;
  const long long n = a.batch * plane;
  const int n_tx = (w + kPdTW - 1) / kPdTW;
  const int per_frame = ((h + kPdTH - 1) / kPdTH) * n_tx;
  const long long n_units = a.batch * per_frame;
  const int tid = threadIdx.x;

  // Pixel e of slot k is region pixel 2·(tid + k·kPdThreads) + e (row-major);
  // its u, v and invariants stay in registers across the D iterations.
  float u[S][2], v[S][2], rc[S][2], wx[S][2], wy[S][2], lg[S][2], nig[S][2];

  for (long long t = blockIdx.x; t < n_units; t += gridDim.x) {
    const long long b = t / per_frame;
    const int rem = (int)(t - b * per_frame);
    const int ty = rem / n_tx;
    const int gy0 = ty * kPdTH - D;  // region origin in the image
    const int gx0 = (rem - ty * n_tx) * kPdTW - D;
    const long long base = b * plane;
    unsigned flags = 0;
    __syncthreads();  // the previous unit's tile has been written out
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int i0 = 2 * (tid + k * kPdThreads);
      if (k == S - 1 && i0 >= N) break;
      const int r = i0 / RW;
      const int y = gy0 + r;
      const long long row = base + (long long)clampi(y, 0, h - 1) * w;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + e;
        const int x = gx0 + (i - r * RW);
        flags |= ((x == 0 ? kX0 : 0u) | (x == w - 1 ? kX1 : 0u) | (y == 0 ? kY0 : 0u) |
                  (y == h - 1 ? kY1 : 0u)) << (8 * k + 4 * e);
        const long long q = row + clampi(x, 0, w - 1);
        if (a.p) {
          cp_async4(s11 + i, a.p + q);
          cp_async4(s12 + i, a.p + n + q);
          cp_async4(s21 + i, a.p + 2 * n + q);
          cp_async4(s22 + i, a.p + 3 * n + q);
        } else {
          s11[i] = s12[i] = s21[i] = s22[i] = 0.f;
        }
        u[k][e] = __ldg(a.u + q);
        v[k][e] = __ldg(a.v + q);
        rc[k][e] = __ldg(a.rho_c + q);
        wx[k][e] = __ldg(a.i1wx + q);
        wy[k][e] = __ldg(a.i1wy + q);
        const float gs = __ldg(a.grad_sq + q);
        lg[k][e] = l_t * gs;
        nig[k][e] = -1.f / fmaxf(gs, 1e-9f);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    for (int j = 1; j <= D; ++j) {
      // The primal step on rows j … RH−j of the region.
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int i0 = 2 * (tid + k * kPdThreads);
        if (i0 < j * RW || i0 >= (RH + 1 - j) * RW) continue;
        const unsigned f = flags >> (8 * k);
        const float2 q11 = ld2(s11 + i0), q12 = ld2(s12 + i0);
        const float2 q21 = ld2(s21 + i0), q22 = ld2(s22 + i0);
        const float2 up12 = ld2(s12 + i0 - RW), up22 = ld2(s22 + i0 - RW);
        primal(u[k][0], v[k][0], rc[k][0], wx[k][0], wy[k][0], lg[k][0], nig[k][0], l_t, theta,
               f, q11.x, s11[i0 - 1], q12.x, up12.x, q21.x, s21[i0 - 1], q22.x, up22.x);
        primal(u[k][1], v[k][1], rc[k][1], wx[k][1], wy[k][1], lg[k][1], nig[k][1], l_t, theta,
               f >> 4, q11.y, q11.x, q12.y, up12.y, q21.y, q21.x, q22.y, up22.y);
        st2(s_u + i0, u[k][0], u[k][1]);
        st2(s_v + i0, v[k][0], v[k][1]);
      }
      __syncthreads();
      // The dual step on rows j … RH−1−j.
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int i0 = 2 * (tid + k * kPdThreads);
        if (i0 < j * RW || i0 >= (RH - j) * RW) continue;
        const unsigned f = flags >> (8 * k);
        const float2 ud = ld2(s_u + i0 + RW), vd = ld2(s_v + i0 + RW);
        float2 q11 = ld2(s11 + i0), q12 = ld2(s12 + i0);
        float2 q21 = ld2(s21 + i0), q22 = ld2(s22 + i0);
        dual(u[k][0], v[k][0], u[k][1], ud.x, v[k][1], vd.x, f, tt, q11.x, q12.x, q21.x, q22.x);
        dual(u[k][1], v[k][1], s_u[i0 + 2], ud.y, s_v[i0 + 2], vd.y, f >> 4, tt, q11.y, q12.y,
             q21.y, q22.y);
        st2(s11 + i0, q11.x, q11.y);
        st2(s12 + i0, q12.x, q12.y);
        st2(s21 + i0, q21.x, q21.y);
        st2(s22 + i0, q22.x, q22.y);
      }
      __syncthreads();
    }
    // The tile: region rows D … D+31, columns D … D+63, inside the image.
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int i0 = 2 * (tid + k * kPdThreads);
      if (i0 < D * RW || i0 >= (D + kPdTH) * RW) continue;
      const int r = i0 / RW;
      const int y = gy0 + r;
      if (y >= h) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + e;
        const int c = i - r * RW;
        const int x = gx0 + c;
        if (c < D || c >= D + kPdTW || x >= w) continue;
        const long long q = base + (long long)y * w + x;
        a.u_out[q] = u[k][e];
        a.v_out[q] = v[k][e];
        if (a.p_out) {
          a.p_out[q] = s11[i];
          a.p_out[n + q] = s12[i];
          a.p_out[2 * n + q] = s21[i];
          a.p_out[3 * n + q] = s22[i];
        }
      }
    }
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// One persistent launch of pd_block_kernel<D>: as many blocks as fit on the
// card at once, and no more than the (frame, tile) units.
template <int D>
cudaError_t launch_pd_block(const PdArgs& a, cudaStream_t stream) {
  const size_t smem = pd_smem_bytes<D>();
  const void* kernel = (const void*)pd_block_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pd_block_kernel<D>, kPdThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long units =
      a.batch * ((a.h + kPdTH - 1) / kPdTH) * (long long)((a.w + kPdTW - 1) / kPdTW);
  const long long fit = (long long)per_sm * sms;
  pd_block_kernel<D><<<(unsigned)(units < fit ? units : fit), kPdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K6 ε step

constexpr int kEpsThreads = 256;
constexpr int kEpsBlocksPerSm = 4;  // 4 × 53.9 KB of shared memory a block

struct EpsArgs {
  const float* u;              // (B, H, W) state in
  const float* v;
  const float* p;              // [p11, p12, p21, p22] planes n apart, or null: zero duals
  const float* rho_c;          // (B, H, W) invariant planes of the warp
  const float* i1wx;
  const float* i1wy;
  const float* grad_sq;
  const unsigned char* active; // (B,) bool: the pair still iterates
  float* u_out;                // (B, H, W) state out: never one of the inputs
  float* v_out;
  float* p_out;                // [p11, p12, p21, p22] out
  float* sq;                   // (B, H, W) squared update out, or null
  long long batch;
  int h, w;
  float l_t, theta, tau_theta;
};

__device__ __forceinline__ unsigned edge_flags(int x, int y, int h, int w) {
  return (x == 0 ? kX0 : 0u) | (x == w - 1 ? kX1 : 0u) | (y == 0 ? kY0 : 0u) |
         (y == h - 1 ? kY1 : 0u);
}

// One block per (frame, tile) unit: K6's depth-1 region, the tile grown by one
// pixel, in horizontal pairs; pair tid + k·kEpsThreads for k < SLOTS.  The
// primal step runs on region rows 1 … RH−1, the dual step on rows 1 … RH−2
// (the tile's), as pd_block_kernel<1> does.
__global__ void __launch_bounds__(kEpsThreads, kEpsBlocksPerSm)
    pd_eps_step_kernel(const EpsArgs a) {
  using R = PdRegion<1>;
  constexpr int RH = R::RH, RW = R::RW, N = R::N;
  constexpr int SLOTS = (N / 2 + kEpsThreads - 1) / kEpsThreads;
  extern __shared__ float4 smem4[];
  float* s_u = reinterpret_cast<float*>(smem4) + 2;
  float* s_v = s_u + N;
  float* s11 = s_v + N;
  float* s12 = s11 + N;
  float* s21 = s12 + N;
  float* s22 = s21 + N;
  const int h = a.h, w = a.w;
  const float l_t = a.l_t, theta = a.theta, tt = a.tau_theta;
  const long long plane = (long long)h * w;
  const long long n = a.batch * plane;
  const int n_tx = (w + kPdTW - 1) / kPdTW;
  const int per_frame = ((h + kPdTH - 1) / kPdTH) * n_tx;
  const long long b = blockIdx.x / per_frame;
  const int rem = (int)(blockIdx.x - b * per_frame);
  const int ty = rem / n_tx;
  const int gy0 = ty * kPdTH - 1;  // region origin in the image
  const int gx0 = (rem - ty * n_tx) * kPdTW - 1;
  const long long base = b * plane;
  const bool keep = a.active[b] != 0;
  const int tid = threadIdx.x;

  // The duals of the region, or zeros.
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int i0 = 2 * (tid + k * kEpsThreads);
    if (i0 >= N) break;
    const int r = i0 / RW;
    const long long row = base + (long long)clampi(gy0 + r, 0, h - 1) * w;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + e;
      const long long q = row + clampi(gx0 + (i - r * RW), 0, w - 1);
      if (a.p) {
        cp_async4(s11 + i, a.p + q);
        cp_async4(s12 + i, a.p + n + q);
        cp_async4(s21 + i, a.p + 2 * n + q);
        cp_async4(s22 + i, a.p + 3 * n + q);
      } else {
        s11[i] = s12[i] = s21[i] = s22[i] = 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // The primal step on rows 1 … RH−1; the tile's pixels write u_out, v_out
  // and the squared update.
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int i0 = 2 * (tid + k * kEpsThreads);
    if (i0 < RW || i0 >= N) continue;
    const int r = i0 / RW;
    const int y = gy0 + r;
    const long long row = base + (long long)clampi(y, 0, h - 1) * w;
    float u[2], v[2], un[2], vn[2];
    unsigned f[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int x = gx0 + (i0 + e - r * RW);
      const long long q = row + clampi(x, 0, w - 1);
      f[e] = edge_flags(x, y, h, w);
      u[e] = __ldg(a.u + q);
      v[e] = __ldg(a.v + q);
    }
    const float2 q11 = ld2(s11 + i0), q12 = ld2(s12 + i0);
    const float2 q21 = ld2(s21 + i0), q22 = ld2(s22 + i0);
    const float2 up12 = ld2(s12 + i0 - RW), up22 = ld2(s22 + i0 - RW);
    const float left11[2] = {s11[i0 - 1], q11.x}, left21[2] = {s21[i0 - 1], q21.x};
    const float own11[2] = {q11.x, q11.y}, own12[2] = {q12.x, q12.y};
    const float own21[2] = {q21.x, q21.y}, own22[2] = {q22.x, q22.y};
    const float upp12[2] = {up12.x, up12.y}, upp22[2] = {up22.x, up22.y};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int x = gx0 + (i0 + e - r * RW);
      const long long q = row + clampi(x, 0, w - 1);
      const float gs = __ldg(a.grad_sq + q);
      un[e] = u[e];
      vn[e] = v[e];
      primal(un[e], vn[e], __ldg(a.rho_c + q), __ldg(a.i1wx + q), __ldg(a.i1wy + q), l_t * gs,
             -1.f / fmaxf(gs, 1e-9f), l_t, theta, f[e], own11[e], left11[e], own12[e],
             upp12[e], own21[e], left21[e], own22[e], upp22[e]);
    }
    st2(s_u + i0, un[0], un[1]);
    st2(s_v + i0, vn[0], vn[1]);
    if (r > kPdTH || y >= h) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = i0 + e - r * RW;
      const int x = gx0 + c;
      if (c < 1 || c > kPdTW || x >= w) continue;
      const long long q = base + (long long)y * w + x;
      a.u_out[q] = keep ? un[e] : u[e];
      a.v_out[q] = keep ? vn[e] : v[e];
      if (a.sq) {
        const float du = un[e] - u[e];
        const float dv = vn[e] - v[e];
        a.sq[q] = du * du + dv * dv;
      }
    }
  }
  __syncthreads();

  // The dual step on the tile's rows 1 … RH−2; its pixels write the duals.
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int i0 = 2 * (tid + k * kEpsThreads);
    if (i0 < RW || i0 >= (RH - 1) * RW) continue;
    const int r = i0 / RW;
    const int y = gy0 + r;
    if (y >= h) continue;
    const float2 uo = ld2(s_u + i0), vo = ld2(s_v + i0);
    const float2 ud = ld2(s_u + i0 + RW), vd = ld2(s_v + i0 + RW);
    float2 q11 = ld2(s11 + i0), q12 = ld2(s12 + i0);
    float2 q21 = ld2(s21 + i0), q22 = ld2(s22 + i0);
    const int x0 = gx0 + (i0 - r * RW);
    dual(uo.x, vo.x, uo.y, ud.x, vo.y, vd.x, edge_flags(x0, y, h, w), tt, q11.x, q12.x, q21.x,
         q22.x);
    dual(uo.y, vo.y, s_u[i0 + 2], ud.y, s_v[i0 + 2], vd.y, edge_flags(x0 + 1, y, h, w), tt,
         q11.y, q12.y, q21.y, q22.y);
    const float o11[2] = {q11.x, q11.y}, o12[2] = {q12.x, q12.y};
    const float o21[2] = {q21.x, q21.y}, o22[2] = {q22.x, q22.y};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = i0 + e - r * RW;
      const int x = gx0 + c;
      if (c < 1 || c > kPdTW || x >= w) continue;
      const long long q = base + (long long)y * w + x;
      a.p_out[q] = o11[e];
      a.p_out[n + q] = o12[e];
      a.p_out[2 * n + q] = o21[e];
      a.p_out[3 * n + q] = o22[e];
    }
  }
}

// One launch of pd_eps_step_kernel: a block per (frame, tile) unit.  The
// wrapper guarantees fewer than 2^31 units.
cudaError_t launch_pd_eps_step(const EpsArgs& a, cudaStream_t stream) {
  const size_t smem = pd_smem_bytes<1>();
  cudaError_t err = set_smem((const void*)pd_eps_step_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long units =
      a.batch * ((a.h + kPdTH - 1) / kPdTH) * (long long)((a.w + kPdTW - 1) / kPdTW);
  pd_eps_step_kernel<<<(unsigned)units, kEpsThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The wrapper guarantees c·h·w < 2^31 and batch·h·ceil(w/128)·32 < 2^31.
int tv_warp_sample(const float* src, const float* flow, float* out, long long batch, int c,
                   int h, int w, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n_units = batch * h * (long long)((w + 32 * kRun - 1) / (32 * kRun));
  long long blocks = (n_units * 32 + kWarpThreads - 1) / kWarpThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride loop past ~268 M threads
  if (c == 3)
    warp_sample_kernel<3><<<(unsigned)blocks, kWarpThreads, 0, s>>>(src, flow, out, (int)n_units,
                                                                    c, h, w);
  else if (c == 1)
    warp_sample_kernel<1><<<(unsigned)blocks, kWarpThreads, 0, s>>>(src, flow, out, (int)n_units,
                                                                    c, h, w);
  else
    warp_sample_kernel<0><<<(unsigned)blocks, kWarpThreads, 0, s>>>(src, flow, out, (int)n_units,
                                                                    c, h, w);
  return (int)cudaGetLastError();
}

// One launch of K6 at depth `depth` (1 … 10).  p null starts the duals at
// zero; p_out null writes u and v only.
int tv_pd_block(const float* u, const float* v, const float* p, const float* rho_c,
                const float* i1wx, const float* i1wy, const float* grad_sq, float* u_out,
                float* v_out, float* p_out, long long batch, int h, int w, int depth, float l_t,
                float theta, float tau_theta, void* stream) {
  const PdArgs a = {u,     v,     p,     rho_c, i1wx, i1wy, grad_sq,   u_out,
                    v_out, p_out, batch, h,     w,    l_t,  theta,     tau_theta};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (depth) {
#define TV_PD_CASE(DD) \
  case DD:             \
    return (int)launch_pd_block<DD>(a, s);
    TV_PD_CASE(1)
    TV_PD_CASE(2)
    TV_PD_CASE(3)
    TV_PD_CASE(4)
    TV_PD_CASE(5)
    TV_PD_CASE(6)
    TV_PD_CASE(7)
    TV_PD_CASE(8)
    TV_PD_CASE(9)
    TV_PD_CASE(10)
#undef TV_PD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One iteration of the per-pair ε loop.  p null starts the duals at zero;
// sq null writes no squared update.
int tv_pd_eps_step(const float* u, const float* v, const float* p, const float* rho_c,
                   const float* i1wx, const float* i1wy, const float* grad_sq,
                   const unsigned char* active, float* u_out, float* v_out, float* p_out,
                   float* sq, long long batch, int h, int w, float l_t, float theta,
                   float tau_theta, void* stream) {
  const EpsArgs a = {u,     v,     p,     rho_c, i1wx, i1wy, grad_sq, active, u_out,
                     v_out, p_out, sq,    batch, h,    w,    l_t,     theta,  tau_theta};
  return (int)launch_pd_eps_step(a, (cudaStream_t)stream);
}

}  // extern "C"
