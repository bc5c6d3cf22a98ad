// Banded (DIA-slab) SpMV for Hopper (sm_90a), float32 and float64: a kernel
// that walks only the occupied runs of the band, and the dense kernel that
// walks all of it.
//
// Replaces the Pallas TPU kernel of csparse3_tpu/kernels/dia_pallas.py:
// dia_spmv_pallas (K4, pallas_call in _pallas_band_call, :67), and gives the
// symmetric plan of csparse3_tpu/ops/matvec.py (SymDIAPlan, XLA on the TPU)
// the same kernels with a flag.
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
// What bounds it on an H100: device-memory bytes, and for a power grid
// almost all of them are zeros.  A slab value meets B multiply-adds (B <= 2):
// at most 4 operations for 4 bytes of float32, against the card's ~20
// operations per byte (67 TFLOP/s float32 over 3.35 TB/s).  The RCM-ordered
// 200k-bus admittance matrix densifies to D = 1885 diagonals, 1.5 GB per
// real slab set, of which 0.3% are nonzeros: a kernel that reads every slab
// value can at best reach the time of those 1.5 GB.  At 10k buses (D = 473,
// 38 MB in float64) the dense walk is short of warps instead: 10,000 rows
// are 313 warps, each walking 473 diagonals alone.
//
// What the design does about it: the plan carries an occupancy index and the
// run kernels read only what the index names.  Rows are cut into groups of
// kRunRows consecutive rows; for each group the index lists, ascending, the
// diagonals d whose run slabs[d, g*kRunRows : (g+1)*kRunRows] holds a
// nonzero (a CSR over groups: run_ptr, run_diag), and for the symmetric
// form a second list of the diagonals whose MIRROR run slabs[d, g*kRunRows
// - d : ...] does (the two are not aligned).  RCM keeps neighbouring rows on
// the same offsets, so at kRunRows = 4 the listed runs are 0.76% of the slab
// values at 200k buses.  kRunRows lanes own the rows of a group and walk its
// list: the slab read of a run is 16 bytes in float32, x comes through the
// L1/L2 (0.8 MB at 200k buses), the sums stay in registers and each row is
// written once by its own lane: no atomics, a fixed order, bit-equal results
// from run to run.  A group's list is dealt round-robin to P lane-sets of one
// warp (P = 1, 2, 4 or 8) whose sums are folded by shuffles, always in the
// same order: a short matrix gives few groups, and more lane-sets keep more
// reads in flight.  The edges (rows past m in the last group, columns outside
// [0, n)) are tested per lane.
//
// A complex matrix is two real slab sets, re and im, and the solvers multiply
// it with a complex x.  The split-complex kernel walks ONE index (the union of
// the two sets' own) over both sets, with x given as (n, 2), the real and the
// imaginary part side by side: one launch, one read of the index and one
// 8- or 16-byte load of x per run, where two launches on the stacked input
// made two of each.
//
// Packed run values.  The listed runs lie scattered over the 1.5 GB of a
// slab set, one 16-byte read per run, and that is what the card does worst:
// a run kernel that read them there took 43-46 us for the split-complex
// launch at 200k buses (1.43M runs, 23 MB of values: 0.5 TB/s where a stream
// moves 2.9), whatever the number of lane-sets.  So the plan copies the
// values of the listed runs once, in the order of the lists (run_vals,
// mir_vals: listed runs x kRunRows, zero where a run reaches past an edge),
// and the run kernels stream that copy, about 1% of the slabs, and never
// read the slabs: 11-12 us for the same launch.  The slabs keep their (D, m)
// layout for the dense kernel and the plain versions.
//
// The dense kernels stay for bands that are dense (a tridiagonal matrix,
// raw slabs without an index): one thread owns one row and walks all D
// diagonals with coalesced slab reads, the range of d that stays inside
// [0, n) computed once per thread and the loop unrolled by four; the mirror
// read shares its trip of the loop with the forward read of the same
// diagonal, so each slab byte leaves device memory once.  They reach 74% of
// the card's memory rate on a band that is all values.

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

// rows per group of the occupancy index.  Measured on an H100 among 4, 8,
// 16 and 32 at both shapes: 4 is ahead of 8 by 28-78% and of 32 by about 5x
// (the times stand beside RUN_ROWS in kernels/dia.py, which builds the index
// for this value and passes its own for a check)
constexpr int kRunRows = 4;
static_assert(kRunRows == 4 || kRunRows == 8 || kRunRows == 16 ||
                  kRunRows == 32,
              "a group and its lane-sets must tile a warp");
// the occupancy index: a CSR over groups of rows for the forward reads, and
// one for the mirror reads of the symmetric form (null otherwise)
struct RunIndex {
  const int* run_ptr;
  const int* run_diag;
  const int* mir_ptr;
  const int* mir_diag;
};

// a launch wants about this many threads (132 SMs x 1024) before it stops
// splitting lists
constexpr long long kRunThreads = 132LL * 1024;

// One group = kRunRows rows; P lane-sets of kRunRows lanes share its lists
// (lane-set `part` takes runs part, part + P, ...), all inside one warp.
template <typename T, int B, int P, bool SYM>
__global__ void dia_runs_kernel(int m, int n, int omin, int ngroups,
                                RunIndex index,
                                const T* __restrict__ run_vals,
                                const T* __restrict__ mir_vals,
                                const T* __restrict__ x, T* __restrict__ y) {
  const int* __restrict__ run_ptr = index.run_ptr;
  const int* __restrict__ run_diag = index.run_diag;
  const int* __restrict__ mir_ptr = index.mir_ptr;
  const int* __restrict__ mir_diag = index.mir_diag;
  constexpr int S = kRunRows;
  static_assert(S * P <= 32, "a group's lane-sets must fit one warp");
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(t % S);
  const int part = static_cast<int>((t / S) % P);
  const long long g = t / (S * P);
  const long long i = g * S + lane;
  const bool row = g < ngroups && i < m;
  T acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = T(0);
  if (g < ngroups) {
    const long long base = i + omin;
    const int r1 = run_ptr[g + 1];
#pragma unroll 4
    for (int r = run_ptr[g] + part; r < r1; r += P) {
      const int d = run_diag[r];
      const long long col = base + d;
      if (row && col >= 0 && col < n) {
        const T v = run_vals[static_cast<size_t>(r) * S + lane];
#pragma unroll
        for (int b = 0; b < B; ++b)
          acc[b] += v * x[static_cast<size_t>(b) * n + col];
      }
    }
    if (SYM) {
      // mirror of the strict upper triangle: A[i, i - d] = slabs[d, i - d]
      const int q1 = mir_ptr[g + 1];
#pragma unroll 4
      for (int r = mir_ptr[g] + part; r < q1; r += P) {
        const int d = mir_diag[r];
        const long long j = i - d;
        if (row && d > 0 && j >= 0) {
          const T w = mir_vals[static_cast<size_t>(r) * S + lane];
#pragma unroll
          for (int b = 0; b < B; ++b)
            acc[b] += w * x[static_cast<size_t>(b) * n + j];
        }
      }
    }
  }
  // fold the lane-sets: every lane of the warp is here (no early return),
  // and the order is the same at every launch
#pragma unroll
  for (int off = S * P / 2; off >= S; off >>= 1) {
#pragma unroll
    for (int b = 0; b < B; ++b)
      acc[b] += __shfl_down_sync(0xffffffffu, acc[b], off, S * P);
  }
  if (row && part == 0) {
#pragma unroll
    for (int b = 0; b < B; ++b) y[static_cast<size_t>(b) * m + i] = acc[b];
  }
}

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T re, im;
};

// The split-complex product in one launch.  A complex matrix is held as two
// real slab sets, re and im, that share one occupancy index (given here as
// their packed run values, forward and mirror); x is (n, 2), the real and
// the imaginary part of a column side by side, so that one load brings both,
// and y is (2, m): y[0] = re * xr - im * xi, y[1] = re * xi + im * xr.  The
// four partial sums are kept apart and combined at the end, as
// two launches of dia_runs_kernel on the stacked input combine theirs, with
// one walk of the index and one read of x in place of two.
//
// A batch of K vectors (the scenario axis of the batched power-flow studies)
// is one launch with grid.y = K: x is (K, n, 2) and y (K, 2, m), the index
// and the packed run values shared.  Scenario k's threads make the sums of
// the one-vector launch in the same order, so each row of the batch has the
// bits of its own launch and K = 1 is that launch.
template <typename T, int P, bool SYM>
__global__ void dia_runs_split_kernel(int m, int n, int omin, int ngroups,
                                      RunIndex index,
                                      const T* __restrict__ re_vals,
                                      const T* __restrict__ im_vals,
                                      const T* __restrict__ re_mir,
                                      const T* __restrict__ im_mir,
                                      const Pair<T>* __restrict__ x,
                                      T* __restrict__ y) {
  const int* __restrict__ run_ptr = index.run_ptr;
  const int* __restrict__ run_diag = index.run_diag;
  const int* __restrict__ mir_ptr = index.mir_ptr;
  const int* __restrict__ mir_diag = index.mir_diag;
  constexpr int S = kRunRows;
  static_assert(S * P <= 32, "a group's lane-sets must fit one warp");
  x += static_cast<size_t>(blockIdx.y) * n;
  y += static_cast<size_t>(blockIdx.y) * 2 * m;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(t % S);
  const int part = static_cast<int>((t / S) % P);
  const long long g = t / (S * P);
  const long long i = g * S + lane;
  const bool row = g < ngroups && i < m;
  // acc[0] = re * xr, [1] = re * xi, [2] = im * xr, [3] = im * xi
  T acc[4] = {T(0), T(0), T(0), T(0)};
  if (g < ngroups) {
    const long long base = i + omin;
    const int r1 = run_ptr[g + 1];
#pragma unroll 4
    for (int r = run_ptr[g] + part; r < r1; r += P) {
      const int d = run_diag[r];
      const long long col = base + d;
      if (row && col >= 0 && col < n) {
        const size_t at = static_cast<size_t>(r) * S + lane;
        const T a = re_vals[at];
        const T b = im_vals[at];
        const Pair<T> xv = x[col];
        acc[0] += a * xv.re;
        acc[1] += a * xv.im;
        acc[2] += b * xv.re;
        acc[3] += b * xv.im;
      }
    }
    if (SYM) {
      const int q1 = mir_ptr[g + 1];
#pragma unroll 4
      for (int r = mir_ptr[g] + part; r < q1; r += P) {
        const int d = mir_diag[r];
        const long long j = i - d;
        if (row && d > 0 && j >= 0) {
          const size_t at = static_cast<size_t>(r) * S + lane;
          const T a = re_mir[at];
          const T b = im_mir[at];
          const Pair<T> xv = x[j];
          acc[0] += a * xv.re;
          acc[1] += a * xv.im;
          acc[2] += b * xv.re;
          acc[3] += b * xv.im;
        }
      }
    }
  }
#pragma unroll
  for (int off = S * P / 2; off >= S; off >>= 1) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[b] += __shfl_down_sync(0xffffffffu, acc[b], off, S * P);
  }
  if (row && part == 0) {
    y[i] = acc[0] - acc[3];
    y[static_cast<size_t>(m) + i] = acc[1] + acc[2];
  }
}

// lane-sets per group: split the lists while the launch is short of threads.
// Measured on an H100 at 4 rows per group, the split-complex kernel: 8
// lane-sets at 10k rows (3.5 us against 7.6 for one), one at 200k rows (12.0
// us against 14.5 for eight; symmetric form 11.2 against 16.9); the
// one-slab-set kernel likewise (10k: 3.4 against 5.6; 200k: 9.0 against 12.3)
inline int run_parts(int m) {
  int parts = 1;
  while (parts < 8 && kRunRows * parts * 2 <= 32 &&
         static_cast<long long>(m) * parts * 2 <= kRunThreads)
    parts *= 2;
  return parts;
}

// grid for `ngroups` groups with P lane-sets each
template <int P>
int run_grid(int ngroups) {
  const long long threads = static_cast<long long>(ngroups) * kRunRows * P;
  return static_cast<int>((threads + kTile - 1) / kTile);
}

// One slab set, x (B, n).  vals: the packed values of the forward and of the
// mirror runs.
template <typename T, int B, int P>
int launch_runs_p(int symmetric, int m, int n, int omin, int ngroups,
                  RunIndex index, const T* const* vals, const T* x, T* y,
                  cudaStream_t stream) {
  if constexpr (kRunRows * P > 32) {
    return -1;
  } else {
    const int grid = run_grid<P>(ngroups);
    if (symmetric)
      dia_runs_kernel<T, B, P, true><<<grid, kTile, 0, stream>>>(
          m, n, omin, ngroups, index, vals[0], vals[1], x, y);
    else
      dia_runs_kernel<T, B, P, false><<<grid, kTile, 0, stream>>>(
          m, n, omin, ngroups, index, vals[0], vals[1], x, y);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int B>
int launch_runs_b(int symmetric, int m, int n, int omin, int ngroups,
                  RunIndex index, const T* const* vals, const T* x, T* y,
                  cudaStream_t st) {
  switch (run_parts(m)) {
    case 1:
      return launch_runs_p<T, B, 1>(symmetric, m, n, omin, ngroups, index,
                                    vals, x, y, st);
    case 2:
      return launch_runs_p<T, B, 2>(symmetric, m, n, omin, ngroups, index,
                                    vals, x, y, st);
    case 4:
      return launch_runs_p<T, B, 4>(symmetric, m, n, omin, ngroups, index,
                                    vals, x, y, st);
    case 8:
      return launch_runs_p<T, B, 8>(symmetric, m, n, omin, ngroups, index,
                                    vals, x, y, st);
    default:
      return -1;
  }
}

template <typename T>
int launch_runs(int symmetric, int m, int n, int omin, int B, int ngroups,
                RunIndex index, const void* const* vals, const void* x,
                void* y, cudaStream_t st) {
  const T* v[2] = {static_cast<const T*>(vals[0]),
                   static_cast<const T*>(vals[1])};
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  return B == 1 ? launch_runs_b<T, 1>(symmetric, m, n, omin, ngroups, index,
                                      v, xv, yv, st)
                : launch_runs_b<T, 2>(symmetric, m, n, omin, ngroups, index,
                                      v, xv, yv, st);
}

// Two slab sets, x (K, n, 2).  vals: the packed values of re's and im's
// forward runs, then of their mirror runs.
template <typename T, int P>
int launch_split_p(int symmetric, int m, int n, int omin, int ngroups, int K,
                   RunIndex index, const T* const* vals, const Pair<T>* x,
                   T* y, cudaStream_t stream) {
  if constexpr (kRunRows * P > 32) {
    return -1;
  } else {
    const dim3 grid(run_grid<P>(ngroups), K);
    if (symmetric)
      dia_runs_split_kernel<T, P, true><<<grid, kTile, 0, stream>>>(
          m, n, omin, ngroups, index, vals[0], vals[1], vals[2], vals[3], x,
          y);
    else
      dia_runs_split_kernel<T, P, false><<<grid, kTile, 0, stream>>>(
          m, n, omin, ngroups, index, vals[0], vals[1], vals[2], vals[3], x,
          y);
    return static_cast<int>(cudaGetLastError());
  }
}

// The lane-sets per group stay those of one vector (run_parts(m)) whatever
// K is: a row of the batch must have the bits of its own launch.
template <typename T>
int launch_split(int symmetric, int m, int n, int omin, int ngroups, int K,
                 RunIndex index, const void* const* vals, const void* x,
                 void* y, cudaStream_t st) {
  const T* v[4];
  for (int k = 0; k < 4; ++k) v[k] = static_cast<const T*>(vals[k]);
  const Pair<T>* xv = static_cast<const Pair<T>*>(x);
  T* yv = static_cast<T*>(y);
  switch (run_parts(m)) {
    case 1:
      return launch_split_p<T, 1>(symmetric, m, n, omin, ngroups, K, index,
                                  v, xv, yv, st);
    case 2:
      return launch_split_p<T, 2>(symmetric, m, n, omin, ngroups, K, index,
                                  v, xv, yv, st);
    case 4:
      return launch_split_p<T, 4>(symmetric, m, n, omin, ngroups, K, index,
                                  v, xv, yv, st);
    case 8:
      return launch_split_p<T, 8>(symmetric, m, n, omin, ngroups, K, index,
                                  v, xv, yv, st);
    default:
      return -1;
  }
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

// The same product through the occupancy index: run_ptr (ngroups + 1) and
// run_diag list, for each group of run_rows consecutive rows, the diagonals
// to read; mir_ptr / mir_diag the mirror reads of the symmetric form (not
// read otherwise).  ngroups = ceil(m / run_rows); run_rows must be the value
// this library was built for.  A diagonal the lists leave out is not read:
// the caller lists every run that holds a nonzero.  run_vals (listed runs x
// run_rows) and, for the symmetric form, mir_vals hold the values the runs
// read, packed in the order of the lists (a null pointer only for an empty
// list): the slabs themselves are not read.
int dia_spmv_runs(int itemsize, int symmetric, int m, int n, int omin, int B,
                  int run_rows, int ngroups, const void* run_ptr,
                  const void* run_diag, const void* mir_ptr,
                  const void* mir_diag, const void* run_vals,
                  const void* mir_vals, const void* x, void* y,
                  void* stream) {
  if ((itemsize != 4 && itemsize != 8) || (B != 1 && B != 2) || m < 0 ||
      (symmetric && (n != m || omin != 0)) || run_rows != kRunRows ||
      ngroups != (m + kRunRows - 1) / kRunRows)
    return -1;
  if (m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RunIndex index = {
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_diag),
      static_cast<const int*>(mir_ptr), static_cast<const int*>(mir_diag)};
  const void* vals[2] = {run_vals, mir_vals};
  return itemsize == 4
             ? launch_runs<float>(symmetric, m, n, omin, B, ngroups, index,
                                  vals, x, y, st)
             : launch_runs<double>(symmetric, m, n, omin, B, ngroups, index,
                                   vals, x, y, st);
}

// The split-complex product through one occupancy index shared by the two
// slab sets re and im of one complex matrix, for K vectors in one launch: x
// is (K, n, 2), xr and xi of a column side by side, on a boundary of
// 2 * itemsize bytes; y is (K, 2, m), yr then yi of each vector.  re_vals /
// im_vals are the packed values of the two sets' forward runs, re_mir /
// im_mir of their mirror runs (symmetric form; else not read).
int dia_spmv_runs_split_batched(int itemsize, int symmetric, int m, int n,
                                int omin, int run_rows, int ngroups, int K,
                                const void* run_ptr, const void* run_diag,
                                const void* mir_ptr, const void* mir_diag,
                                const void* re_vals, const void* im_vals,
                                const void* re_mir, const void* im_mir,
                                const void* x, void* y, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || m < 0 ||
      (symmetric && (n != m || omin != 0)) || run_rows != kRunRows ||
      ngroups != (m + kRunRows - 1) / kRunRows || K < 0 || K > 65535 ||
      reinterpret_cast<size_t>(x) % (2 * itemsize) != 0)
    return -1;
  if (m == 0 || K == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RunIndex index = {
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_diag),
      static_cast<const int*>(mir_ptr), static_cast<const int*>(mir_diag)};
  const void* vals[4] = {re_vals, im_vals, re_mir, im_mir};
  return itemsize == 4
             ? launch_split<float>(symmetric, m, n, omin, ngroups, K, index,
                                   vals, x, y, st)
             : launch_split<double>(symmetric, m, n, omin, ngroups, K, index,
                                    vals, x, y, st);
}

// One vector, x (n, 2) and y (2, m): the batched launch with K = 1.
int dia_spmv_runs_split(int itemsize, int symmetric, int m, int n, int omin,
                        int run_rows, int ngroups, const void* run_ptr,
                        const void* run_diag, const void* mir_ptr,
                        const void* mir_diag, const void* re_vals,
                        const void* im_vals, const void* re_mir,
                        const void* im_mir, const void* x, void* y,
                        void* stream) {
  return dia_spmv_runs_split_batched(itemsize, symmetric, m, n, omin,
                                     run_rows, ngroups, 1, run_ptr, run_diag,
                                     mir_ptr, mir_diag, re_vals, im_vals,
                                     re_mir, im_mir, x, y, stream);
}

const char* dia_spmv_error_string(int code) {
  if (code == -1) return "invalid argument to dia_spmv";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
