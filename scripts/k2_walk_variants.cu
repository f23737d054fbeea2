// Alternative forms of K2's walk (csrc/farneback.cu update_matrices_kernel),
// built beside the shipped kernel by scripts/k2_walk_variants.py to time
// them on the same tensors.  Every form calls the same matrices_math, so
// all are bit-equal to the plain version.
#include "../btcs_pnes_optical_flow_tpu_torch/csrc/farneback.cu"

namespace {

// Variant 1: each pair's r0 and flow staged in shared memory by 16-byte
// cp.async copies (4-byte where a row does not allow), the next pair's
// copies issued before this pair's gathers, a barrier per pair.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    staged_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                  const float* __restrict__ flow, const float* __restrict__ rim,
                  float* __restrict__ m, long long batch, int h, int w, int y_lo, int y_hi,
                  int x_lo, int x_hi, int n_tx, int n_tiles, int pairs_per_run) {
  constexpr int kPlanes = 7;
  constexpr int kPlane = kWalkH * kWalkW;
  __shared__ __align__(16) float stage[2][kPlanes * kPlane];
  const int run = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - run * n_tiles;
  const int ty = tile / n_tx;
  const int y0 = y_lo + ty * kWalkH;
  const int x0 = x_lo + (tile - ty * n_tx) * kWalkW;
  const int rows = y_hi - y0 < kWalkH ? y_hi - y0 : kWalkH;
  const int cols = x_hi - x0 < kWalkW ? x_hi - x0 : kWalkW;
  const long long b0 = (long long)run * pairs_per_run;
  const long long b1 = b0 + pairs_per_run < batch ? b0 + pairs_per_run : batch;
  const long long plane = (long long)h * w;
  const long long corner = (long long)y0 * w + x0;
  const bool wide = w % 4 == 0 && ((uintptr_t)r0 & 15) == 0 && ((uintptr_t)flow & 15) == 0 &&
                    (x0 & 3) == 0 && (cols & 3) == 0;
  auto stage_pair = [&](long long b, float* dst) {
    const float* a = r0 + b * 5 * plane + corner;
    const float* f = flow + b * 2 * plane + corner;
    if (wide) {
      const int per_row = cols >> 2;
      for (int i = threadIdx.x; i < kPlanes * kWalkH * per_row; i += kThreads) {
        const int pr = i / per_row;
        const int q = 4 * (i - pr * per_row);
        const int p = pr / kWalkH;
        const int r = pr - p * kWalkH;
        if (r < rows)
          cp_async16(dst + pr * kWalkW + q,
                     (p < 5 ? a + p * plane : f + (p - 5) * plane) + (long long)r * w + q);
      }
    } else {
      for (int i = threadIdx.x; i < kPlanes * kPlane; i += kThreads) {
        const int pr = i / kWalkW;
        const int c = i - pr * kWalkW;
        const int p = pr / kWalkH;
        const int r = pr - p * kWalkH;
        if (r < rows && c < cols)
          cp_async4(dst + i, (p < 5 ? a + p * plane : f + (p - 5) * plane) + (long long)r * w + c);
      }
    }
    cp_async_commit();
  };
  const int j = threadIdx.x / kWalkW;
  const int i = threadIdx.x - j * kWalkW;
  const bool active = j < rows && i < cols;
  const int y = y0 + j;
  const int x = x0 + i;
  const float scale = active ? rim[y] * rim[h + x] : 0.f;
  const long long pix = (long long)y * w + x;
  stage_pair(b0, stage[0]);
  for (long long b = b0; b < b1; ++b) {
    const int cur = (int)((b - b0) & 1);
    cp_async_wait<0>();
    __syncthreads();
    if (b + 1 < b1) stage_pair(b + 1, stage[cur ^ 1]);
    if (active) {
      const float* s = stage[cur] + j * kWalkW + i;
      float o[5];
      matrices_math<kBf16>(r1 + b * 5 * plane, plane, y, x, w, 0, 0, h, h, s[0], s[kPlane],
                           s[2 * kPlane], s[3 * kPlane], s[4 * kPlane], s[5 * kPlane],
                           s[6 * kPlane], scale, o);
      float* out = m + b * 5 * plane + pix;
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) out[ch * plane] = o[ch];
    }
  }
}

// Variants 2 and 3: the register walk on kRows × 32 tiles; kPrefR0 also
// holds the next pair's r0 in registers, not only its flow.
template <bool kBf16, int kRows, bool kPrefR0, int kMinBlocks>
__global__ void __launch_bounds__(kRows * 32, kMinBlocks)
    walk_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                const float* __restrict__ flow, const float* __restrict__ rim,
                float* __restrict__ m, long long batch, int h, int w, int y_lo, int y_hi,
                int x_lo, int x_hi, int n_tx, int n_tiles, int pairs_per_run) {
  const int run = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - run * n_tiles;
  const int ty = tile / n_tx;
  const int y = y_lo + ty * kRows + threadIdx.x / 32;
  const int x = x_lo + (tile - ty * n_tx) * 32 + threadIdx.x % 32;
  if (y >= y_hi || x >= x_hi) return;
  const long long b0 = (long long)run * pairs_per_run;
  const int n = (int)(b0 + pairs_per_run < batch ? pairs_per_run : batch - b0);
  const float scale = rim[y] * rim[h + x];
  const long long plane = (long long)h * w;
  const long long pix = (long long)y * w + x;
  const float* a = r0 + b0 * 5 * plane + pix;
  const float* f = flow + b0 * 2 * plane + pix;
  const float* c = r1 + b0 * 5 * plane;
  float* o = m + b0 * 5 * plane + pix;
  float v[7];
  if (kPrefR0) {
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) v[ch] = a[ch * plane];
  }
  v[5] = f[0];
  v[6] = f[plane];
  for (int k = 0; k < n; ++k) {
    float cur[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) cur[q] = v[q];
    if (!kPrefR0) {
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) cur[ch] = a[ch * plane];
    }
    if (k + 1 < n) {
      if (kPrefR0) {
#pragma unroll
        for (int ch = 0; ch < 5; ++ch) v[ch] = a[(5 + ch) * plane];
      }
      v[5] = f[2 * plane];
      v[6] = f[3 * plane];
    }
    float out[5];
    matrices_math<kBf16>(c, plane, y, x, w, 0, 0, h, h, cur[0], cur[1], cur[2], cur[3], cur[4],
                         cur[5], cur[6], scale, out);
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) o[ch * plane] = out[ch];
    a += 5 * plane;
    f += 2 * plane;
    c += 5 * plane;
    o += 5 * plane;
  }
}

// Variant 4: the shipped kernel's code without its minimum of blocks per SM
// in __launch_bounds__, so that ptxas picks the register count itself.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    unbounded_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                     const float* __restrict__ flow, const float* __restrict__ rim,
                     float* __restrict__ m, long long batch, int h, int w, int y_lo, int y_hi,
                     int x_lo, int x_hi, int n_tx, int n_tiles, int pairs_per_run) {
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
  const float* a = r0 + b0 * 5 * plane + pix;
  const float* f = flow + b0 * 2 * plane + pix;
  const float* c = r1 + b0 * 5 * plane;
  float* o = m + b0 * 5 * plane + pix;
  float dx = f[0], dy = f[plane];
  for (int k = 0; k < n; ++k) {
    const float a0 = a[0], a1 = a[plane], a2 = a[2 * plane], a3 = a[3 * plane],
                a4 = a[4 * plane];
    float ndx = 0.f, ndy = 0.f;
    if (k + 1 < n) {
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

int variant_rows(int variant) { return variant == 3 ? 4 : 8; }

template <bool kBf16>
const void* variant_fn(int variant) {
  switch (variant) {
    case 0: return (const void*)update_matrices_kernel<kBf16>;
    case 1: return (const void*)staged_kernel<kBf16>;
    case 2: return (const void*)walk_kernel<kBf16, 8, true, 1>;
    case 3: return (const void*)walk_kernel<kBf16, 4, false, 1>;
    case 4: return (const void*)unbounded_kernel<kBf16>;
  }
  return nullptr;
}

template <bool kBf16>
void launch(int variant, unsigned units, cudaStream_t s, const float* r0, const float* r1,
            const float* flow, const float* rim, float* m, long long batch, int h, int w,
            int y_lo, int y_hi, int x_lo, int x_hi, int n_tx, int n_tiles, int ppr) {
  if (variant == 1)
    staged_kernel<kBf16><<<units, kThreads, 0, s>>>(r0, r1, flow, rim, m, batch, h, w, y_lo,
                                                     y_hi, x_lo, x_hi, n_tx, n_tiles, ppr);
  else if (variant == 2)
    walk_kernel<kBf16, 8, true, 1><<<units, 256, 0, s>>>(r0, r1, flow, rim, m, batch, h, w, y_lo,
                                                         y_hi, x_lo, x_hi, n_tx, n_tiles, ppr);
  else if (variant == 3)
    walk_kernel<kBf16, 4, false, 1><<<units, 128, 0, s>>>(r0, r1, flow, rim, m, batch, h, w,
                                                          y_lo, y_hi, x_lo, x_hi, n_tx, n_tiles,
                                                          ppr);
  else if (variant == 4)
    unbounded_kernel<kBf16><<<units, kThreads, 0, s>>>(r0, r1, flow, rim, m, batch, h, w, y_lo,
                                                        y_hi, x_lo, x_hi, n_tx, n_tiles, ppr);
}

}  // namespace

extern "C" {

int k2v_rows(int variant) { return variant_rows(variant); }

// Variant 0 is the shipped kernel (fb_update_matrices).
int k2v_launch(int variant, const float* r0, const float* r1, const float* flow,
               const float* rim, float* m, long long batch, int h, int w, int y_lo, int y_hi,
               int x_lo, int x_hi, int ppr, int bf16, void* stream) {
  if (variant == 0)
    return fb_update_matrices(r0, r1, flow, rim, m, batch, h, w, y_lo, y_hi, x_lo, x_hi, ppr,
                              bf16, stream);
  const int rows = variant_rows(variant);
  const int n_tx = (x_hi - x_lo + 31) / 32;
  const long long n_tiles = (long long)((y_hi - y_lo + rows - 1) / rows) * n_tx;
  const unsigned units = (unsigned)(n_tiles * ((batch + ppr - 1) / ppr));
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch<true>(variant, units, s, r0, r1, flow, rim, m, batch, h, w, y_lo, y_hi, x_lo, x_hi,
                 n_tx, (int)n_tiles, ppr);
  else
    launch<false>(variant, units, s, r0, r1, flow, rim, m, batch, h, w, y_lo, y_hi, x_lo, x_hi,
                  n_tx, (int)n_tiles, ppr);
  return (int)cudaGetLastError();
}

int k2v_resident(int variant, int bf16, int* out) {
  const void* fn = bf16 ? variant_fn<true>(variant) : variant_fn<false>(variant);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, variant_rows(variant) * 32,
                                                        0);
  *out = per_sm * sms;
  return (int)err;
}

}  // extern "C"
