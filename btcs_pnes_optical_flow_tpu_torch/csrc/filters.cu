// The band-pass cascade of the PC1 head for Hopper (sm_90a), with a plain C
// interface.
//
// sos_cascade_kernel<S> — replaces no TPU kernel: the JAX package runs the
//    sequential engine of ops/filters.py as a lax.scan, which XLA compiles
//    into one loop on the device.  The port's plain version
//    (ops/filters.py _section_scan) is a Python loop of nine tensor
//    operations per sample and section, so a 1080p recording's band-pass
//    (4 sections, both passes over 3649-sample staging rows) is ~263,000
//    launches; this kernel runs a whole sosfilt call in one.
//    Per staging row, the S second-order sections in transposed direct
//    form II, in _section_scan's float32 operations and order:
//        y  = b0·x + z1
//        z1 = (b1·x − a1·y) + z2
//        z2 = b2·x − a2·y
//    each product rounded before its sum (-fmad=false), the coefficients
//    rounded from float64 to float32 as a Python scalar meets a float32
//    tensor.  Section s+1 at sample n runs right after section s at sample
//    n: each output depends only on earlier samples of the section below, so
//    this gives what finishing section s over the whole row first gives.
//    Bound: latency.  A row is a chain of len·S dependent steps (9 flops
//    each) against 8 bytes a sample; a call moves a few MB, so the time is
//    latency, not bytes or operations (chip_smoke.py phase 3c times it
//    against the plain loop; PERF.md §6 keeps the numbers).  The warp's
//    tile loads wait row by row, one round trip each, before the walk
//    starts; a call is a small part of a recording's PC1 head, so nothing
//    overlaps them.
//    Design: one thread per row keeps every section's (z1, z2) in registers
//    and walks the samples in order.  Rows are contiguous along time, so a
//    block (one warp, kRows rows) stages [kRows × kTile] tiles through
//    shared memory: each warp load and store covers 32 consecutive samples
//    of one row (128 bytes), and each thread's walk reads its row from
//    shared memory at an odd pitch, so the 32 lanes hit 32 banks.  The
//    results overwrite the tile in place and leave the same way.  The row
//    count sets the grid (128 rows at 1080p: 4 blocks); nothing else adapts.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 8;
constexpr int kRows = 32;          // rows a block: one per lane of its one warp
constexpr int kTile = 256;         // samples of a row a tile
constexpr int kPitch = kTile + 1;  // odd: lane r's sample j sits in bank (r + j) mod 32

struct SosCoeffs {
  float b0[kMaxSections], b1[kMaxSections], b2[kMaxSections];
  float a1[kMaxSections], a2[kMaxSections];
};

template <int S>
__global__ void __launch_bounds__(kRows)
    sos_cascade_kernel(const float* __restrict__ x, const float* __restrict__ zi,
                       float* __restrict__ y, float* __restrict__ zf, const SosCoeffs c,
                       long long rows, long long len) {
  __shared__ float tile[kRows * kPitch];
  const int lane = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int n_rows = (int)(rows - row0 < kRows ? rows - row0 : kRows);
  const bool live = lane < n_rows;
  const long long row = row0 + lane;

  float z1[S], z2[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    z1[s] = live ? zi[(row * S + s) * 2] : 0.f;
    z2[s] = live ? zi[(row * S + s) * 2 + 1] : 0.f;
  }

  for (long long t0 = 0; t0 < len; t0 += kTile) {
    const int n = (int)(len - t0 < kTile ? len - t0 : kTile);
    for (int r = 0; r < n_rows; ++r) {
      const float* src = x + (row0 + r) * len + t0;
#pragma unroll
      for (int k = 0; k < kTile / 32; ++k) {
        const int j = lane + 32 * k;
        if (j < n) tile[r * kPitch + j] = src[j];
      }
    }
    __syncthreads();
    if (live) {
      float* v = tile + lane * kPitch;
      for (int j = 0; j < n; ++j) {
        float u = v[j];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float yn = c.b0[s] * u + z1[s];
          z1[s] = (c.b1[s] * u - c.a1[s] * yn) + z2[s];
          z2[s] = c.b2[s] * u - c.a2[s] * yn;
          u = yn;
        }
        v[j] = u;
      }
    }
    __syncthreads();
    for (int r = 0; r < n_rows; ++r) {
      float* dst = y + (row0 + r) * len + t0;
#pragma unroll
      for (int k = 0; k < kTile / 32; ++k) {
        const int j = lane + 32 * k;
        if (j < n) dst[j] = tile[r * kPitch + j];
      }
    }
    __syncthreads();  // the next tile's loads overwrite these results
  }

  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      zf[(row * S + s) * 2] = z1[s];
      zf[(row * S + s) * 2 + 1] = z2[s];
    }
  }
}

template <int S>
void launch(const float* x, const float* zi, float* y, float* zf, const SosCoeffs& c,
            long long rows, long long len, cudaStream_t stream) {
  const long long blocks = (rows + kRows - 1) / kRows;
  sos_cascade_kernel<S><<<(unsigned)blocks, kRows, 0, stream>>>(x, zi, y, zf, c, rows, len);
}

}  // namespace

extern "C" {

const char* flt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One sosfilt call: x and y (rows, len), zi and zf (rows, S, 2), all
// contiguous float32 on the device; coeffs on the host, (S, 5) float32 as
// [b0, b1, b2, a1, a2] per section.  The wrapper guarantees 1 <= S <=
// kMaxSections (ops/filters_cuda.py MAX_SECTIONS; it runs a longer cascade
// in groups of that many), rows >= 1 and len >= 1.
int flt_sos_cascade(const float* x, const float* zi, float* y, float* zf, const float* coeffs,
                    int n_sections, long long rows, long long len, void* stream) {
  SosCoeffs c = {};
  for (int s = 0; s < n_sections; ++s) {
    c.b0[s] = coeffs[5 * s];
    c.b1[s] = coeffs[5 * s + 1];
    c.b2[s] = coeffs[5 * s + 2];
    c.a1[s] = coeffs[5 * s + 3];
    c.a2[s] = coeffs[5 * s + 4];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_sections) {
    case 1: launch<1>(x, zi, y, zf, c, rows, len, st); break;
    case 2: launch<2>(x, zi, y, zf, c, rows, len, st); break;
    case 3: launch<3>(x, zi, y, zf, c, rows, len, st); break;
    case 4: launch<4>(x, zi, y, zf, c, rows, len, st); break;
    case 5: launch<5>(x, zi, y, zf, c, rows, len, st); break;
    case 6: launch<6>(x, zi, y, zf, c, rows, len, st); break;
    case 7: launch<7>(x, zi, y, zf, c, rows, len, st); break;
    case 8: launch<8>(x, zi, y, zf, c, rows, len, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
