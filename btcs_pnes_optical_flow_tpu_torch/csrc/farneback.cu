// Farnebäck main-path kernels for Hopper (sm_90a), with a plain C interface.
//
// Three kernels, one per step of each pyramid level / iteration:
//
// K1 poly_exp_kernel — replaces btcs_pnes_optical_flow_tpu/ops/farneback_pallas.py
//    poly_exp_fused_cf (body _poly_kernel_factory).  Per frame, the separable
//    (2n+1)-tap correlations with g, x·g and x²·g (replicate borders) and the
//    inverse-Gram scaling into 5 planes [b_y, b_x, A_yy, A_xx, 2A_xy].
//    Bound: about 6(2n+1) multiply-adds per pixel against 4 bytes read and 20 written,
//    so memory traffic bounds it once the taps come from shared memory.  Design:
//    one block per 32×32 output tile loads the tile plus its n-pixel halo once
//    into shared memory with clamped indices (the replicate border, no host
//    padding), runs the vertical pass into 3 shared planes and the horizontal
//    pass into 6 sums in registers, and writes the 5 planes channel-first in
//    coalesced rows.  Shared memory grows with n; there is no fixed halo limit.
//
// K2 update_matrices_kernel — replaces farneback_pallas.py
//    update_matrices_banded_cf (body _make_kernel).  Per pixel, the bilinear
//    sample of frame b+1's expansion at (x+dx, y+dy) under cv2's inside guard,
//    the averaged A, the Δb fold, the 5-pixel rim damping and the 5 M planes
//    [G_yy, G_xy, G_xx, h_y, h_x].  Bound: memory — 5 r0 + 2 flow floats in,
//    5 M floats out, plus 4 corners × 5 planes of r1 that neighbouring threads
//    share through L1/L2; about 40 flops per pixel.  Design: one thread per
//    pixel, rows of 32 threads on consecutive addresses; the r1 corners are
//    read only when the guard holds (outside it cv2 uses none of them), and
//    the TPU kernel's banded window, clip counters and follow-up passes have
//    no counterpart: a direct sample has no reach limit.
//
// K3 update_flow_kernel — replaces farneback_pallas.py update_flow_fused_cf
//    (body _flow_kernel_factory).  The winsize window average of the 5 M
//    planes with replicate borders (separable weights and a final scale
//    passed in: ones and 1/winsize² for the box, the Gaussian taps and 1
//    otherwise), then the regularized 2×2 solve.  Bound: memory once the
//    window sums come from shared memory (5 floats in, 2 out per pixel;
//    10·winsize multiply-adds).  Design:
//    one block per 16×32 tile loads the 5 planes plus a winsize/2 halo with
//    clamped indices, takes the separable sums through shared memory and
//    solves per pixel.  The TPU kernel's fix_borders step repaired its
//    zero-filled halo; clamped loads make it unnecessary.
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kPolyTH = 32;
constexpr int kPolyTW = 32;
constexpr int kFlowTH = 16;
constexpr int kFlowTW = 32;
constexpr long long kMaxGridZ = 65535;
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

size_t poly_smem_bytes(int n) {
  const int k = 2 * n + 1;
  const int in_w = kPolyTW + 2 * n;
  const size_t floats = 3 * k + 4 + (size_t)(kPolyTH + 2 * n) * in_w + 3 * (size_t)kPolyTH * in_w;
  return floats * sizeof(float);
}

size_t flow_smem_bytes(int winsize) {
  const int r = winsize / 2;
  const int in_w = kFlowTW + 2 * r;
  const size_t floats =
      winsize + 1 + 5 * (size_t)(kFlowTH + 2 * r) * in_w + 5 * (size_t)kFlowTH * in_w;
  return floats * sizeof(float);
}

// consts = [g (K), xg (K), xxg (K), ig11, ig03, ig33, ig55], K = 2n+1.
__global__ void poly_exp_kernel(const float* __restrict__ img, const float* __restrict__ consts,
                                float* __restrict__ out, long long batch, int h, int w, int n) {
  extern __shared__ float smem[];
  const int k = 2 * n + 1;
  const int in_h = kPolyTH + 2 * n;
  const int in_w = kPolyTW + 2 * n;
  float* s_taps = smem;
  float* s_in = s_taps + 3 * k + 4;
  float* s_v = s_in + in_h * in_w;  // 3 planes of kPolyTH × in_w
  const int vplane = kPolyTH * in_w;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < 3 * k + 4; i += nthreads) s_taps[i] = consts[i];
  const float* g = s_taps;
  const float* xg = s_taps + k;
  const float* xxg = s_taps + 2 * k;

  const int x0 = blockIdx.x * kPolyTW;
  const int y0 = blockIdx.y * kPolyTH;
  const long long plane = (long long)h * w;

  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const float* src = img + b * plane;
    __syncthreads();  // taps visible; the previous frame is done with s_in / s_v
    for (int i = tid; i < in_h * in_w; i += nthreads) {
      const int r = i / in_w;
      const int c = i - r * in_w;
      const int y = clampi(y0 - n + r, 0, h - 1);
      const int x = clampi(x0 - n + c, 0, w - 1);
      s_in[i] = src[(long long)y * w + x];
    }
    __syncthreads();
    for (int i = tid; i < vplane; i += nthreads) {
      const int r = i / in_w;
      const int c = i - r * in_w;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int t = 0; t < k; ++t) {
        const float v = s_in[(r + t) * in_w + c];
        a0 += g[t] * v;
        a1 += xg[t] * v;
        a2 += xxg[t] * v;
      }
      s_v[i] = a0;
      s_v[vplane + i] = a1;
      s_v[2 * vplane + i] = a2;
    }
    __syncthreads();
    const float ig11 = s_taps[3 * k];
    const float ig03 = s_taps[3 * k + 1];
    const float ig33 = s_taps[3 * k + 2];
    const float ig55 = s_taps[3 * k + 3];
    for (int i = tid; i < kPolyTH * kPolyTW; i += nthreads) {
      const int r = i / kPolyTW;
      const int c = i - r * kPolyTW;
      const int y = y0 + r;
      const int x = x0 + c;
      if (y >= h || x >= w) continue;
      const float* v0 = s_v + r * in_w + c;  // vertical g
      const float* v1 = v0 + vplane;         // vertical x·g
      const float* v2 = v1 + vplane;         // vertical x²·g
      float b1 = 0.f, b2 = 0.f, b3 = 0.f, b4 = 0.f, b5 = 0.f, b6 = 0.f;
      for (int t = 0; t < k; ++t) {
        b1 += g[t] * v0[t];
        b2 += xg[t] * v0[t];
        b4 += xxg[t] * v0[t];
        b3 += g[t] * v1[t];
        b6 += xg[t] * v1[t];
        b5 += g[t] * v2[t];
      }
      float* o = out + b * 5 * plane + (long long)y * w + x;
      o[0] = b3 * ig11;
      o[plane] = b2 * ig11;
      o[2 * plane] = b1 * ig03 + b5 * ig33;
      o[3 * plane] = b1 * ig03 + b4 * ig33;
      o[4 * plane] = b6 * ig55;
    }
  }
}

// rim = [sy (h), sx (w)]: the rim damping at (y, x) is sy[y] * sx[x].
__global__ void update_matrices_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                                       const float* __restrict__ flow,
                                       const float* __restrict__ rim, float* __restrict__ m,
                                       long long batch, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const long long plane = (long long)h * w;
  const long long pix = (long long)y * w + x;
  const float scale = rim[y] * rim[h + x];
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const float dx = flow[b * 2 * plane + pix];
    const float dy = flow[b * 2 * plane + plane + pix];
    const float* a = r0 + b * 5 * plane + pix;
    const float fx = (float)x + dx;
    const float fy = (float)y + dy;
    const float fxf = floorf(fx);
    const float fyf = floorf(fy);
    const float ax = fx - fxf;
    const float ay = fy - fyf;
    // Clamp before the cast: (int) truncates and overflows; [-2, size]
    // keeps the guard's verdict.  fmaxf maps a NaN to -2 (outside).
    const int xi = (int)fminf(fmaxf(fxf, -2.f), (float)w);
    const int yi = (int)fminf(fmaxf(fyf, -2.f), (float)h);
    const bool inside = xi >= 0 && xi < w - 1 && yi >= 0 && yi < h - 1;
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (inside) {
      const float* c = r1 + b * 5 * plane + (long long)yi * w + xi;
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) {
        const float* p = c + ch * plane;
        const float top = p[0] * (1.f - ax) + p[1] * ax;
        const float bot = p[w] * (1.f - ax) + p[w + 1] * ax;
        s[ch] = top * (1.f - ay) + bot * ay;
      }
    }
    const float a0 = a[0], a1 = a[plane], a2 = a[2 * plane], a3 = a[3 * plane],
                a4 = a[4 * plane];
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
    float* o = m + b * 5 * plane + pix;
    o[0] = r4 * r4 + r6 * r6;
    o[plane] = (r4 + r5) * r6;
    o[2 * plane] = r5 * r5 + r6 * r6;
    o[3 * plane] = r4 * r2 + r6 * r3;
    o[4 * plane] = r6 * r2 + r5 * r3;
  }
}

// weights = [w (winsize), post-scale].
__global__ void update_flow_kernel(const float* __restrict__ m, const float* __restrict__ weights,
                                   float* __restrict__ out, long long batch, int h, int w,
                                   int winsize) {
  extern __shared__ float smem[];
  const int rad = winsize / 2;
  const int in_h = kFlowTH + 2 * rad;
  const int in_w = kFlowTW + 2 * rad;
  const int in_plane = in_h * in_w;
  const int vplane = kFlowTH * in_w;
  float* s_w = smem;
  float* s_in = s_w + winsize + 1;   // 5 planes of in_h × in_w
  float* s_v = s_in + 5 * in_plane;  // 5 planes of kFlowTH × in_w
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i <= winsize; i += nthreads) s_w[i] = weights[i];

  const int x0 = blockIdx.x * kFlowTW;
  const int y0 = blockIdx.y * kFlowTH;
  const long long plane = (long long)h * w;

  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const float* src = m + b * 5 * plane;
    __syncthreads();
    for (int i = tid; i < 5 * in_plane; i += nthreads) {
      const int ch = i / in_plane;
      const int rem = i - ch * in_plane;
      const int r = rem / in_w;
      const int c = rem - r * in_w;
      const int y = clampi(y0 - rad + r, 0, h - 1);
      const int x = clampi(x0 - rad + c, 0, w - 1);
      s_in[i] = src[ch * plane + (long long)y * w + x];
    }
    __syncthreads();
    for (int i = tid; i < vplane; i += nthreads) {
      const int r = i / in_w;
      const int c = i - r * in_w;
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) {
        const float* col = s_in + ch * in_plane + r * in_w + c;
        float acc = 0.f;
        for (int t = 0; t < winsize; ++t) acc += s_w[t] * col[t * in_w];
        s_v[ch * vplane + i] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < kFlowTH * kFlowTW; i += nthreads) {
      const int r = i / kFlowTW;
      const int c = i - r * kFlowTW;
      const int y = y0 + r;
      const int x = x0 + c;
      if (y >= h || x >= w) continue;
      float sum[5];
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) {
        const float* row = s_v + ch * vplane + r * in_w + c;
        float acc = 0.f;
        for (int t = 0; t < winsize; ++t) acc += s_w[t] * row[t];
        sum[ch] = acc * s_w[winsize];
      }
      const float g11 = sum[0], g12 = sum[1], g22 = sum[2], h1 = sum[3], h2 = sum[4];
      const float idet = 1.f / (g11 * g22 - g12 * g12 + 1e-3f);
      float* o = out + b * 2 * plane + (long long)y * w + x;
      o[0] = (g11 * h2 - g12 * h1) * idet;
      o[plane] = (g22 * h1 - g12 * h2) * idet;
    }
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

unsigned grid_z(long long batch) { return (unsigned)(batch < kMaxGridZ ? batch : kMaxGridZ); }

}  // namespace

extern "C" {

int fb_poly_exp_smem_bytes(int n) { return (int)poly_smem_bytes(n); }

int fb_update_flow_smem_bytes(int winsize) { return (int)flow_smem_bytes(winsize); }

const char* fb_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int fb_poly_exp(const float* img, const float* consts, float* out, long long batch, int h, int w,
                int n, void* stream) {
  const size_t smem = poly_smem_bytes(n);
  cudaError_t err = set_smem((const void*)poly_exp_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kPolyTW - 1) / kPolyTW, (h + kPolyTH - 1) / kPolyTH, grid_z(batch));
  poly_exp_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(img, consts, out, batch, h, w, n);
  return (int)cudaGetLastError();
}

int fb_update_matrices(const float* r0, const float* r1, const float* flow, const float* rim,
                       float* m, long long batch, int h, int w, void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kThreadsX - 1) / kThreadsX, (h + kThreadsY - 1) / kThreadsY,
                  grid_z(batch));
  update_matrices_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(r0, r1, flow, rim, m, batch,
                                                                   h, w);
  return (int)cudaGetLastError();
}

int fb_update_flow(const float* m, const float* weights, float* out, long long batch, int h,
                   int w, int winsize, void* stream) {
  const size_t smem = flow_smem_bytes(winsize);
  cudaError_t err = set_smem((const void*)update_flow_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kFlowTW - 1) / kFlowTW, (h + kFlowTH - 1) / kFlowTH, grid_z(batch));
  update_flow_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(m, weights, out, batch, h, w,
                                                                  winsize);
  return (int)cudaGetLastError();
}

}  // extern "C"
