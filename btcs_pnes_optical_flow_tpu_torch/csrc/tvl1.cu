// TV-L1 kernels for Hopper (sm_90a), with a plain C interface.
//
// K5 warp_sample_kernel — replaces btcs_pnes_optical_flow_tpu/ops/farneback_pallas.py
//    warp_sample_banded_cf (body _make_sample_kernel).  Samples C source planes
//    at (x+u, y+v) with cv2.remap's clamp (gx = clip(x+u, 0, w-1)) and bilinear
//    weights; TV-L1 warps (I1, I1x, I1y) with it once per warp.
//    Bound: memory — 2 flow floats in and C floats out per pixel, plus 4 taps
//    per channel that neighbouring threads share through L1/L2; ~6 flops per
//    channel.  Design: one thread per output pixel computes the clamp, floor and
//    fraction once and reads the four taps of every channel.  The TPU kernel
//    fetched a band of rows and scanned an anchored window because a TPU gather
//    costs ~20 ns an index; Hopper gathers through its caches, so there is no
//    band, no window, no reach limit, and the clip count is zero by construction.
//
// K6 pd_init_kernel + pd_iteration_kernel — replace
//    btcs_pnes_optical_flow_tpu/ops/tvl1_pallas.py pd_chain_resident (body
//    _pd_kernel_factory).  One warp's Chambolle primal–dual chain: thresholding
//    of the linearised data term, u/v update with div p, p update with grad of
//    the new u/v; the duals start at zero and the chain runs n_iterations steps
//    with no early exit.
//    Bound: memory — per iteration and pixel, 12 planes are read (u, v, the four
//    duals, rho_c, I1wx, I1wy and the three invariants) and 6 written: 72 bytes
//    against ~60 flops.  The TPU kernel kept the whole chain in VMEM, recomputing
//    a 2·n_iterations-row halo per block; 30 iterations need 60-row halos of 10
//    planes, which Hopper's 227 KB of shared memory per block cannot hold for a
//    useful tile.  Design: pd_init_kernel computes the invariants once per chain
//    (l_t·|∇I|², I1wx·(-1/|∇I|²), I1wy·(-1/|∇I|²)) and zeroes the duals; then one
//    pd_iteration_kernel launch per iteration.  Each block computes the new u and
//    v of its 16×32 tile plus one column right and one row below into shared
//    memory, then takes grad from there and writes the new u, v and duals to the
//    other buffer of a ping-pong pair.  The grad/div boundary rules apply at
//    image edges only, never at tile edges.
//
// Built with -fmad=false (ops/_build.py): every product is rounded before its sum,
// so each kernel repeats the float32 operations of its plain PyTorch version
// (ops/tvl1.py warp_sample_cf_plain, pd_chain_plain) in their order; sqrtf and the
// divisions are IEEE-rounded (no fast math).
//
// Element offsets are 64-bit.  Every launcher returns cudaGetLastError() after
// launching on the caller's stream; it neither synchronises nor allocates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kPdTH = 16;
constexpr int kPdTW = 32;
constexpr int kHaloW = kPdTW + 1;
constexpr long long kMaxGridZ = 65535;
constexpr int kInitThreads = 256;

unsigned grid_z(long long batch) { return (unsigned)(batch < kMaxGridZ ? batch : kMaxGridZ); }

// src (B, C, H, W), flow (B, 2, H, W) with channels (u, v) → out (B, C, H, W).
__global__ void warp_sample_kernel(const float* __restrict__ src, const float* __restrict__ flow,
                                   float* __restrict__ out, long long batch, int c, int h,
                                   int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const long long plane = (long long)h * w;
  const long long pix = (long long)y * w + x;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const float u = flow[b * 2 * plane + pix];
    const float v = flow[b * 2 * plane + plane + pix];
    const float gx = fminf(fmaxf((float)x + u, 0.f), (float)(w - 1));
    const float gy = fminf(fmaxf((float)y + v, 0.f), (float)(h - 1));
    const float x0f = floorf(gx);
    const float y0f = floorf(gy);
    const float fx = gx - x0f;
    const float fy = gy - y0f;
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
    const int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    const long long o00 = (long long)y0 * w + x0;
    const long long o01 = (long long)y0 * w + x1;
    const long long o10 = (long long)y1 * w + x0;
    const long long o11 = (long long)y1 * w + x1;
    const float* s = src + b * c * plane;
    float* o = out + b * c * plane + pix;
    for (int ch = 0; ch < c; ++ch) {
      const float* p = s + ch * plane;
      const float top = p[o00] * (1.f - fx) + p[o01] * fx;
      const float bot = p[o10] * (1.f - fx) + p[o11] * fx;
      o[ch * plane] = top * (1.f - fy) + bot * fy;
    }
  }
}

// n = B·H·W.  inv = [l_t·grad_sq, i1wx·nig, i1wy·nig] with nig = -1/max(grad_sq, 1e-9);
// the four dual planes p are zeroed.
__global__ void pd_init_kernel(const float* __restrict__ i1wx, const float* __restrict__ i1wy,
                               const float* __restrict__ grad_sq, float* __restrict__ inv,
                               float* __restrict__ p, long long n, float l_t) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float gs = grad_sq[i];
    const float neg_inv_gs = -1.f / fmaxf(gs, 1e-9f);
    inv[i] = l_t * gs;
    inv[n + i] = i1wx[i] * neg_inv_gs;
    inv[2 * n + i] = i1wy[i] * neg_inv_gs;
    p[i] = 0.f;
    p[n + i] = 0.f;
    p[2 * n + i] = 0.f;
    p[3 * n + i] = 0.f;
  }
}

// The backward-difference divergence of (px, py) at (y, x) of one image.
__device__ inline float div_at(const float* __restrict__ px, const float* __restrict__ py,
                               long long pix, int y, int x, int h, int w) {
  const float cx = px[pix];
  const float cy = py[pix];
  const float dx = x == 0 ? cx : (x == w - 1 ? 0.f : cx) - px[pix - 1];
  const float dy = y == 0 ? cy : (y == h - 1 ? 0.f : cy) - py[pix - w];
  return dx + dy;
}

// One primal–dual iteration.  u, v (B, H, W); p = [p11, p12, p21, p22] and
// inv = [l_t·grad_sq, wx_igs, wy_igs], plane-major with planes n = B·H·W apart.
__global__ void pd_iteration_kernel(const float* __restrict__ u, const float* __restrict__ v,
                                    const float* __restrict__ p,
                                    const float* __restrict__ rho_c,
                                    const float* __restrict__ i1wx,
                                    const float* __restrict__ i1wy,
                                    const float* __restrict__ inv, float* __restrict__ u_out,
                                    float* __restrict__ v_out, float* __restrict__ p_out,
                                    long long batch, int h, int w, float l_t, float theta,
                                    float tau_theta) {
  __shared__ float s_u[(kPdTH + 1) * kHaloW];
  __shared__ float s_v[(kPdTH + 1) * kHaloW];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int x0 = blockIdx.x * kPdTW;
  const int y0 = blockIdx.y * kPdTH;
  const long long plane = (long long)h * w;
  const long long n = batch * plane;

  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const long long base = b * plane;
    __syncthreads();  // the previous image is done with s_u / s_v
    // New u, v on the tile plus one column right and one row below.
    for (int i = tid; i < (kPdTH + 1) * kHaloW; i += nthreads) {
      const int r = i / kHaloW;
      const int c = i - r * kHaloW;
      const int y = y0 + r;
      const int x = x0 + c;
      if (y >= h || x >= w) continue;
      const long long pix = base + (long long)y * w + x;
      const float uu = u[pix];
      const float vv = v[pix];
      const float wx = i1wx[pix];
      const float wy = i1wy[pix];
      const float rho = rho_c[pix] + wx * uu + wy * vv;
      const float lg = inv[pix];
      float d1, d2;
      if (rho < -lg) {
        d1 = l_t * wx;
        d2 = l_t * wy;
      } else if (rho > lg) {
        d1 = -(l_t * wx);
        d2 = -(l_t * wy);
      } else {
        d1 = rho * inv[n + pix];
        d2 = rho * inv[2 * n + pix];
      }
      s_u[i] = uu + d1 + theta * div_at(p, p + n, pix, y, x, h, w);
      s_v[i] = vv + d2 + theta * div_at(p + 2 * n, p + 3 * n, pix, y, x, h, w);
    }
    __syncthreads();
    // Dual step with the forward-difference gradient of the new u, v.
    for (int i = tid; i < kPdTH * kPdTW; i += nthreads) {
      const int r = i / kPdTW;
      const int c = i - r * kPdTW;
      const int y = y0 + r;
      const int x = x0 + c;
      if (y >= h || x >= w) continue;
      const int si = r * kHaloW + c;
      const float un = s_u[si];
      const float vn = s_v[si];
      const float ux = x < w - 1 ? s_u[si + 1] - un : 0.f;
      const float uy = y < h - 1 ? s_u[si + kHaloW] - un : 0.f;
      const float vx = x < w - 1 ? s_v[si + 1] - vn : 0.f;
      const float vy = y < h - 1 ? s_v[si + kHaloW] - vn : 0.f;
      const float r_u = 1.f / (1.f + tau_theta * sqrtf(ux * ux + uy * uy));
      const float r_v = 1.f / (1.f + tau_theta * sqrtf(vx * vx + vy * vy));
      const long long pix = base + (long long)y * w + x;
      p_out[pix] = (p[pix] + tau_theta * ux) * r_u;
      p_out[n + pix] = (p[n + pix] + tau_theta * uy) * r_u;
      p_out[2 * n + pix] = (p[2 * n + pix] + tau_theta * vx) * r_v;
      p_out[3 * n + pix] = (p[3 * n + pix] + tau_theta * vy) * r_v;
      u_out[pix] = un;
      v_out[pix] = vn;
    }
  }
}

}  // namespace

extern "C" {

const char* tv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int tv_warp_sample(const float* src, const float* flow, float* out, long long batch, int c,
                   int h, int w, void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kThreadsX - 1) / kThreadsX, (h + kThreadsY - 1) / kThreadsY,
                  grid_z(batch));
  warp_sample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(src, flow, out, batch, c, h, w);
  return (int)cudaGetLastError();
}

int tv_pd_init(const float* i1wx, const float* i1wy, const float* grad_sq, float* inv, float* p,
               long long n, float l_t, void* stream) {
  long long blocks = (n + kInitThreads - 1) / kInitThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride loop past ~8k blocks
  pd_init_kernel<<<(unsigned)blocks, kInitThreads, 0, (cudaStream_t)stream>>>(i1wx, i1wy,
                                                                              grad_sq, inv, p,
                                                                              n, l_t);
  return (int)cudaGetLastError();
}

int tv_pd_iteration(const float* u, const float* v, const float* p, const float* rho_c,
                    const float* i1wx, const float* i1wy, const float* inv, float* u_out,
                    float* v_out, float* p_out, long long batch, int h, int w, float l_t,
                    float theta, float tau_theta, void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kPdTW - 1) / kPdTW, (h + kPdTH - 1) / kPdTH, grid_z(batch));
  pd_iteration_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, v, p, rho_c, i1wx, i1wy, inv, u_out, v_out, p_out, batch, h, w, l_t, theta, tau_theta);
  return (int)cudaGetLastError();
}

}  // extern "C"
