// Banded (DIA-slab) SpMV for Hopper (sm_90a), float32 and float64.
//
// Replaces the Pallas TPU kernel of csparse3_tpu/kernels/dia_pallas.py:
// dia_spmv_pallas (K4, pallas_call in _pallas_band_call, :67), and gives the
// symmetric plan of csparse3_tpu/ops/matvec.py (SymDIAPlan, XLA on the TPU)
// the same kernel with a flag.
//
// What it computes.  The matrix is a dense range of D diagonals, row
// aligned: slabs[d * m + i] = A[i, i + omin + d].  For x given as (B, n)
// and y as (B, m), both row-major,
//   general:    y[b, i] = sum_{d < D} slabs[d, i] * x[b, i + omin + d],
//               x read as zero outside [0, n);
//   symmetric:  omin = 0, only the diagonals d >= 0 of a symmetric A are
//               stored, and the strict lower triangle is their mirror:
//               y[b, i] = sum_{d < D} slabs[d, i] * x[b, i + d]
//                       + sum_{0 < d < D, d <= i} slabs[d, i - d] * x[b, i - d].
//
// What bounds it on an H100: device-memory bytes.  Every slab value is read
// once and meets B multiply-adds (B <= 2): at most 4 operations for 4 bytes
// of float32, against the card's ~20 operations per byte (67 TFLOP/s float32
// over 3.35 TB/s).  The RCM-ordered 200k-bus admittance matrix densifies to
// D = 1885 diagonals, 1.5 GB per real slab set, far beyond the 50 MB L2; x
// and y are 0.8 MB each.  The symmetric form reads half the slab bytes.
//
// What the design does about it: one pass over the slabs and nothing else in
// device memory.  One thread owns one row i and keeps its B sums in
// registers, so across a warp the slab read of a diagonal is one coalesced
// line, and x[i + omin + d] is the same line shifted by a few elements, which
// the L1 serves (a CTA's windows of x span D + blockDim.x values).  The
// range of d that stays inside [0, n) is computed once per thread, so the
// loop carries no bounds test, and it is unrolled by four to keep several
// loads in flight.  The mirror read slabs[d, i - d] is coalesced the same
// way (consecutive i are consecutive addresses) and shares its trip of the
// loop with the forward read of the same diagonal, so that it is served by
// the L2 and not a second time by device memory.  The TPU kernel padded m and
// D to its tile grid, stitched three x windows and rolled lanes to get a
// static slice; none of that has a counterpart here.  Each thread writes only
// its own row: no atomics, the result is deterministic.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// rows (threads) per CTA.  One warp per CTA was measured for short matrices
// (10k rows) and was no faster: the warps in flight stay the same
constexpr int kTile = 256;

template <typename T, int B>
__global__ void dia_spmv_kernel(int m, int n, int D, int omin,
                                const T* __restrict__ slabs,
                                const T* __restrict__ x, T* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  T acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = T(0);
  // columns j = i + omin + d inside [0, n): d in [d_lo, d_hi)
  const long long base = static_cast<long long>(i) + omin;
  const int d_lo = base < 0 ? static_cast<int>(-base) : 0;
  const long long room = static_cast<long long>(n) - base;
  const int d_hi = room < D ? static_cast<int>(room < 0 ? 0 : room) : D;
  const T* s = slabs + i;
  const T* xw = x + base;
#pragma unroll 4
  for (int d = d_lo; d < d_hi; ++d) {
    const T v = s[static_cast<size_t>(d) * m];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] += v * xw[static_cast<ptrdiff_t>(b) * n + d];
  }
#pragma unroll
  for (int b = 0; b < B; ++b) y[static_cast<size_t>(b) * m + i] = acc[b];
}

template <typename T, int B>
__global__ void symdia_spmv_kernel(int m, int D, const T* __restrict__ slabs,
                                   const T* __restrict__ x,
                                   T* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  T acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = T(0);
  // forward (upper triangle and diagonal): d in [0, up), columns i + d < m;
  // mirror of the strict upper triangle, A[i, i - d] = slabs[d, i - d]:
  // d in [1, lo), columns i - d >= 0
  const int up = (m - i) < D ? (m - i) : D;
  const int lo = (i + 1) < D ? (i + 1) : D;
  const int both = up < lo ? up : lo;
  const T* s = slabs + i;
  const T* xw = x + i;
  if (up > 0) {
    const T v = s[0];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] += v * xw[static_cast<size_t>(b) * m];
  }
  // both reads of diagonal d in one trip: the whole grid walks d together,
  // so the mirror read finds in the L2 what another row's forward read just
  // brought in, and each slab byte leaves device memory once
#pragma unroll 4
  for (int d = 1; d < both; ++d) {
    const T v = s[static_cast<size_t>(d) * m];
    const T w = s[static_cast<ptrdiff_t>(d) * m - d];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const ptrdiff_t xb = static_cast<ptrdiff_t>(b) * m;
      acc[b] += v * xw[xb + d];
      acc[b] += w * xw[xb - d];
    }
  }
  const int rest = both > 1 ? both : 1;
  for (int d = rest; d < up; ++d) {  // rows near the top: forward only
    const T v = s[static_cast<size_t>(d) * m];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] += v * xw[static_cast<size_t>(b) * m + d];
  }
  for (int d = rest; d < lo; ++d) {  // rows near the bottom: mirror only
    const T v = s[static_cast<ptrdiff_t>(d) * m - d];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] += v * xw[static_cast<ptrdiff_t>(b) * m - d];
  }
#pragma unroll
  for (int b = 0; b < B; ++b) y[static_cast<size_t>(b) * m + i] = acc[b];
}

template <typename T>
int launch(int symmetric, int m, int n, int D, int omin, int B,
           const void* slabs, const void* x, void* y, cudaStream_t stream) {
  const T* s = static_cast<const T*>(slabs);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  const int grid = (m + kTile - 1) / kTile;
  if (symmetric) {
    if (B == 1)
      symdia_spmv_kernel<T, 1><<<grid, kTile, 0, stream>>>(m, D, s, xv, yv);
    else
      symdia_spmv_kernel<T, 2><<<grid, kTile, 0, stream>>>(m, D, s, xv, yv);
  } else {
    if (B == 1)
      dia_spmv_kernel<T, 1><<<grid, kTile, 0, stream>>>(m, n, D, omin, s, xv,
                                                      yv);
    else
      dia_spmv_kernel<T, 2><<<grid, kTile, 0, stream>>>(m, n, D, omin, s, xv,
                                                      yv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch on `stream` (a cudaStream_t); returns cudaGetLastError(): 0 when
// the launch was accepted, -1 for arguments the kernel does not take.
// itemsize is 4 (float) or 8 (double); B is 1 or 2.
// The symmetric form needs a square matrix (n == m) and omin == 0.
int dia_spmv(int itemsize, int symmetric, int m, int n, int D, int omin,
             int B, const void* slabs, const void* x, void* y, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || (B != 1 && B != 2) || D < 0 ||
      (symmetric && (n != m || omin != 0)))
    return -1;
  if (m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return itemsize == 4
             ? launch<float>(symmetric, m, n, D, omin, B, slabs, x, y, st)
             : launch<double>(symmetric, m, n, D, omin, B, slabs, x, y, st);
}

const char* dia_spmv_error_string(int code) {
  if (code == -1) return "invalid argument to dia_spmv";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
