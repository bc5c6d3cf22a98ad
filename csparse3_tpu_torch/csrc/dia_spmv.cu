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
// A batch of K vectors (the scenario axis of the batched power-flow studies:
// K load cases, one Ybus) is one launch of its own kernel, scenario-minor.
// x comes as (n, K, 2): the K scenarios' (xr, xi) of a column side by side,
// copied from the solver's (K, n) parts by the copy kernel of bandpoints.cu
// (kernels/bandpoints.py scenario_minor_pairs).
// A thread owns one (row, scenario) pair, and L lanes (a power of two, at
// most 32, chosen by the caller from K) take consecutive scenarios of one
// row.  The lanes of a row read the same matrix values (a warp-uniform load:
// one read serves L scenarios), and the gather x[col, k0 : k0 + L] is one
// contiguous read of up to 512 bytes.  y stays (K, 2, m): a CTA's rows x
// scenarios go through shared memory and are written along m.
//   Three designs lost on an H100 at 10k buses x 256 scenarios, float64,
// symmetric form.  Lanes over rows with the scenario on the grid's second
// axis read the matrix again for every scenario (0.245 ms, 2.5x the
// library's CSR product).  Lanes over scenarios walking the index were
// hardly faster: a run is 4 rows wide, ~79% of the listed slots are zeros
// that pad a run, and each cost every scenario the walk's address
// arithmetic and tests.  A CTA that copied the band of x its rows meet
// from the (K, n) parts into shared memory, to spare the copy of x into
// this layout, was slower still: its rows' passes wait on each other's
// loads.  So the kernel walks the plan's batch entries
// (kernels/dia.py batch_entries, built once from the index and the packed
// values): for each row and lane-set j of the one-vector launch, the slots
// j adds there that hold a nonzero and meet a column inside the matrix, as
// (col, re, im), in the order j adds them.
//   Bits.  The one-vector launch splits a group's list over P = run_parts(m)
// lane-sets and folds their sums by shuffles.  The batched thread makes
// each lane-set's partial sum from its entries in their order and folds
// the partial sums in the same tree (P = 8: ((s0 + s4) + (s2 + s6)) + ((s1
// + s5) + (s3 + s7))).  Both kernels write every product as an explicit
// fused multiply-add (fma_rn), so that no compiler contraction can tell
// them apart: a row of a batch has the bits of its own one-vector launch,
// and K = 1 goes to the one-vector launch.  The slots left out add a zero
// product there: on finite x every sum keeps its value, and only the sign
// of a zero sum may differ (torch.equal holds).  An inf or NaN of x that
// only zero slots meet gives NaN in the one-vector launch (0 * inf) and
// nothing here, as in a product over the nonzeros.
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

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// acc[0] += a * xr, [1] += a * xi, [2] += b * xr, [3] += b * xi, each one
// rounding (a, b: the re and im values of one slot)
template <typename T>
__device__ __forceinline__ void split_mac(T (&acc)[4], T a, T b,
                                          Pair<T> xv) {
  acc[0] = fma_rn(a, xv.re, acc[0]);
  acc[1] = fma_rn(a, xv.im, acc[1]);
  acc[2] = fma_rn(b, xv.re, acc[2]);
  acc[3] = fma_rn(b, xv.im, acc[3]);
}

// The split-complex product in one launch.  A complex matrix is held as two
// real slab sets, re and im, that share one occupancy index (given here as
// their packed run values, forward and mirror); x is (n, 2), the real and
// the imaginary part of a column side by side, so that one load brings both,
// and y is (2, m): y[0] = re * xr - im * xi, y[1] = re * xi + im * xr.  The
// four partial sums are kept apart and combined at the end, as
// two launches of dia_runs_kernel on the stacked input combine theirs, with
// one walk of the index and one read of x in place of two.
//
// Every product is an explicit fused multiply-add (fma_rn), not one the
// compiler may contract or not: the batched kernel below makes the same
// ones, so that a row of a batch has this launch's bits.
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
        split_mac(acc, re_vals[at], im_vals[at], x[col]);
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
          split_mac(acc, re_mir[at], im_mir[at], x[j]);
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

// log2 of the batched kernel's CTA size: a CTA is cut into rows x scenario
// lanes by shifts
constexpr int kBatchTileLog2 = 7;
constexpr int kBatchTile = 1 << kBatchTileLog2;

// entries of a row whose gathers the batched kernel stages in shared memory
// before it multiplies; the rest of a longer row is read as it is added
// (a row of the 10k-bus Ybus has 5.4 on average).  And the CTAs of it an
// SM should hold: the register cap that gives (64 in float64) keeps 32
// warps in flight without spilling.  Measured on an H100 by
// tune_dia_spmv.py --batch at 10k buses x 256 scenarios, float64, both
// forms: 4 entries at 8 CTAs 66.8-66.9 us; 8 entries at 8 CTAs 89.9-90.0,
// uncapped (100 registers) 107.6-110.4; 2 entries 72.7-73.7; 1 entry at 10
// CTAs (48 registers, spilling) 99.0-99.3.  At 16 scenarios 4 entries are
// also the fastest (8.6 us against 9.0-10.5)
constexpr int kEntryChunk = 4;
constexpr int kBatchCtasPerSm = 8;

// log2 of the lane-sets P, and the position of lane-set j in the one-vector
// launch's shuffle tree (bits reversed): the tree adds the partial sums in
// the order of their positions, pairs first
template <int P>
constexpr int kLog2Parts = P == 8 ? 3 : P == 4 ? 2 : P == 2 ? 1 : 0;
template <int P>
__host__ __device__ constexpr int tree_part(int pos) {
  int j = 0;
  for (int l = 0; l < kLog2Parts<P>; ++l)
    j |= ((pos >> l) & 1) << (kLog2Parts<P> - 1 - l);
  return j;
}

// acc += the products of entry e of the row, q = e - (the row's first):
// from the staged gathers and values for q < C, else read here
template <typename T, int C>
__device__ __forceinline__ void add_staged(
    T (&acc)[4], int q, int e, const Pair<T> (*xs)[kBatchTile],
    const Pair<T>* vrow, const T* __restrict__ ere,
    const T* __restrict__ eim, const int* __restrict__ ecol,
    const Pair<T>* __restrict__ xk, int K) {
  if (q < C) {
    const Pair<T> v = vrow[q];
    split_mac(acc, v.re, v.im, xs[q][threadIdx.x]);
  } else {
    split_mac(acc, ere[e], eim[e], xk[static_cast<size_t>(ecol[e]) * K]);
  }
}

// The split-complex product for K vectors in one launch, scenario-minor,
// over the plan's batch entries: for each row and lane-set j of the
// one-vector launch (P = run_parts(m) of them), the slots j adds there that
// hold a nonzero (re or im) and meet a column inside the matrix, in the
// order it adds them (forward list, then mirror list): entries
// eptr[i * P + j] .. eptr[i * P + j + 1] of (ecol, ere, eim)
// (kernels/dia.py batch_entries).  x is (n, K) pairs (x[col * K + k]: the K
// scenarios of a column side by side) and y is (K, 2, m).  A thread owns one
// (row, scenario) pair: L = 1 << lanes_log2 lanes take consecutive
// scenarios of one row, a CTA holds kBatchTile / L rows, and grid.y walks
// the scenarios in chunks of L.  The lanes of a row read the same entries
// (warp-uniform loads: one read serves L scenarios) and gather x[col, k0 :
// k0 + L], one contiguous read.
//
// Bits: partial sum j adds its entries in order with the fma_rn of the
// one-vector launch, and the partial sums are folded in that launch's
// shuffle tree (P = 8: ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7))),
// so every row of the batch has the bits of its own one-vector launch, up
// to the sign of a zero: the slots left out add +-0 there.  The thread
// makes the partial sums one after the other in the order of the tree and
// folds each as it is done (a binary counter), so that it holds one partial
// sum and log2(P) folded ones, not P: the gathers of the row's first
// kEntryChunk entries wait in shared memory, read there by position.  Lanes
// past the last scenario read scenario K - 1 and write nothing; the rows of
// the CTA go through shared memory, so that y is written along m.
template <typename T, int P>
__global__ void __launch_bounds__(kBatchTile, kBatchCtasPerSm)
    dia_entries_split_kernel(
    int m, int K, int lanes_log2, const int* __restrict__ eptr,
    const int* __restrict__ ecol, const T* __restrict__ ere,
    const T* __restrict__ eim, const Pair<T>* __restrict__ x,
    T* __restrict__ y) {
  constexpr int C = kEntryChunk;
  constexpr int LOGP = kLog2Parts<P>;
  // the staged gathers (one column per thread) and values (one row of C
  // per row of the CTA: at least 2 lanes a row)
  __shared__ Pair<T> xs[C][kBatchTile];
  __shared__ Pair<T> vs[kBatchTile / 2][C];
  const int rows_log2 = kBatchTileLog2 - lanes_log2;
  const int rows = 1 << rows_log2;
  const int s = threadIdx.x & ((1 << lanes_log2) - 1);
  const int rl = threadIdx.x >> lanes_log2;
  const long long i0 = static_cast<long long>(blockIdx.x) << rows_log2;
  const long long i = i0 + rl;
  const int k0 = blockIdx.y << lanes_log2;
  const Pair<T>* __restrict__ xk = x + min(k0 + s, K - 1);
  int seg[P + 1];
  if (i < m) {
#pragma unroll
    for (int j = 0; j <= P; ++j) seg[j] = eptr[i * P + j];
    Pair<T> xv[C];
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (seg[0] + q < seg[P])
        xv[q] = xk[static_cast<size_t>(ecol[seg[0] + q]) * K];
    if (s == 0) {
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (seg[0] + q < seg[P])
          vs[rl][q] = Pair<T>{ere[seg[0] + q], eim[seg[0] + q]};
    }
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (seg[0] + q < seg[P]) xs[q][threadIdx.x] = xv[q];
  }
  __syncwarp();
  // done[l]: the fold of 2^l partial sums, waiting for its right sibling
  T done[LOGP + 1][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) done[LOGP][c] = T(0);
  if (i < m) {
#pragma unroll
    for (int pos = 0; pos < P; ++pos) {
      const int j = tree_part<P>(pos);
      T acc[4] = {T(0), T(0), T(0), T(0)};
      // most lane-sets add one entry or none: the first is not a trip of
      // the loop, so that its reads need not wait for the previous one's
      const int e0 = seg[j], e1 = seg[j + 1];
      if (e0 < e1)
        add_staged<T, C>(acc, e0 - seg[0], e0, xs, vs[rl], ere, eim, ecol,
                         xk, K);
      for (int e = e0 + 1; e < e1; ++e)
        add_staged<T, C>(acc, e - seg[0], e, xs, vs[rl], ere, eim, ecol, xk,
                         K);
      // fold: the tree adds this partial sum to the folded left siblings
      // of its trailing one bits, and the result waits at the first zero
      // bit (every index is known at compile time: pos is unrolled)
#pragma unroll
      for (int l = 0; l <= LOGP; ++l) {
        if ((pos & ((1 << l) - 1)) != (1 << l) - 1) continue;
        if (l < LOGP && ((pos >> l) & 1)) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = done[l][c] + acc[c];
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) done[l][c] = acc[c];
        }
      }
    }
  }
  // (scenario, row) tiles of yr and yi, a row of padding per scenario
  __shared__ T tile[2][kBatchTile + 32];
  const int ld = rows + 1;
  tile[0][s * ld + rl] = done[LOGP][0] - done[LOGP][3];
  tile[1][s * ld + rl] = done[LOGP][1] + done[LOGP][2];
  __syncthreads();
  const int s2 = threadIdx.x >> rows_log2;
  const int r2 = threadIdx.x & (rows - 1);
  const int k = k0 + s2;
  if (k < K && i0 + r2 < m) {
    T* yk = y + static_cast<size_t>(k) * 2 * m + i0 + r2;
    yk[0] = tile[0][s2 * ld + r2];
    yk[m] = tile[1][s2 * ld + r2];
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

// Two slab sets, one vector: x (n, 2), y (2, m).  vals: the packed values
// of re's and im's forward runs, then of their mirror runs.
template <typename T, int P>
int launch_split_p(int symmetric, int m, int n, int omin, int ngroups,
                   RunIndex index, const T* const* vals, const Pair<T>* x,
                   T* y, cudaStream_t stream) {
  if constexpr (kRunRows * P > 32) {
    return -1;
  } else {
    const int grid = run_grid<P>(ngroups);
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

template <typename T>
int launch_split(int symmetric, int m, int n, int omin, int ngroups,
                 RunIndex index, const void* const* vals, const void* x,
                 void* y, cudaStream_t st) {
  const T* v[4];
  for (int k = 0; k < 4; ++k) v[k] = static_cast<const T*>(vals[k]);
  const Pair<T>* xv = static_cast<const Pair<T>*>(x);
  T* yv = static_cast<T*>(y);
  switch (run_parts(m)) {
    case 1:
      return launch_split_p<T, 1>(symmetric, m, n, omin, ngroups, index, v,
                                  xv, yv, st);
    case 2:
      return launch_split_p<T, 2>(symmetric, m, n, omin, ngroups, index, v,
                                  xv, yv, st);
    case 4:
      return launch_split_p<T, 4>(symmetric, m, n, omin, ngroups, index, v,
                                  xv, yv, st);
    case 8:
      return launch_split_p<T, 8>(symmetric, m, n, omin, ngroups, index, v,
                                  xv, yv, st);
    default:
      return -1;
  }
}

// K vectors over the batch entries: x (n, K, 2), y (K, 2, m), 1 <<
// lanes_log2 lanes a row.  The partial sums are those of one vector
// (run_parts(m)) whatever K is: a row of the batch must have the bits of its
// own launch.
template <typename T>
int launch_entries(int m, int K, int lanes_log2, const int* eptr,
                   const int* ecol, const void* ere, const void* eim,
                   const void* x, void* y, cudaStream_t st) {
  const int rows_log2 = kBatchTileLog2 - lanes_log2;
  const dim3 grid(
      static_cast<unsigned>(((static_cast<long long>(m) - 1) >> rows_log2) +
                            1),
      static_cast<unsigned>(((K - 1) >> lanes_log2) + 1));
  const T* re = static_cast<const T*>(ere);
  const T* im = static_cast<const T*>(eim);
  const Pair<T>* xv = static_cast<const Pair<T>*>(x);
  T* yv = static_cast<T*>(y);
  switch (run_parts(m)) {
    case 1:
      dia_entries_split_kernel<T, 1><<<grid, kBatchTile, 0, st>>>(
          m, K, lanes_log2, eptr, ecol, re, im, xv, yv);
      break;
    case 2:
      dia_entries_split_kernel<T, 2><<<grid, kBatchTile, 0, st>>>(
          m, K, lanes_log2, eptr, ecol, re, im, xv, yv);
      break;
    case 4:
      dia_entries_split_kernel<T, 4><<<grid, kBatchTile, 0, st>>>(
          m, K, lanes_log2, eptr, ecol, re, im, xv, yv);
      break;
    case 8:
      dia_entries_split_kernel<T, 8><<<grid, kBatchTile, 0, st>>>(
          m, K, lanes_log2, eptr, ecol, re, im, xv, yv);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
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
// slab sets re and im of one complex matrix: x is (n, 2), xr and xi of a
// column side by side, on a boundary of 2 * itemsize bytes; y is (2, m), yr
// then yi.  re_vals / im_vals are the packed values of the two sets'
// forward runs, re_mir / im_mir of their mirror runs (symmetric form; else
// not read).
int dia_spmv_runs_split(int itemsize, int symmetric, int m, int n, int omin,
                        int run_rows, int ngroups, const void* run_ptr,
                        const void* run_diag, const void* mir_ptr,
                        const void* mir_diag, const void* re_vals,
                        const void* im_vals, const void* re_mir,
                        const void* im_mir, const void* x, void* y,
                        void* stream) {
  if ((itemsize != 4 && itemsize != 8) || m < 0 ||
      (symmetric && (n != m || omin != 0)) || run_rows != kRunRows ||
      ngroups != (m + kRunRows - 1) / kRunRows ||
      reinterpret_cast<size_t>(x) % (2 * itemsize) != 0)
    return -1;
  if (m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RunIndex index = {
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_diag),
      static_cast<const int*>(mir_ptr), static_cast<const int*>(mir_diag)};
  const void* vals[4] = {re_vals, im_vals, re_mir, im_mir};
  return itemsize == 4
             ? launch_split<float>(symmetric, m, n, omin, ngroups, index,
                                   vals, x, y, st)
             : launch_split<double>(symmetric, m, n, omin, ngroups, index,
                                    vals, x, y, st);
}

// The same product for K vectors in one launch, scenario-minor, over the
// batch entries of the two slab sets (eptr (m P + 1), ecol, ere, eim:
// kernels/dia.py batch_entries, built for P = `parts` lane-sets, which
// must be run_parts(m), the one-vector launch's): x
// is (n, K, 2), the K scenarios' (xr, xi) of a column side by side, on a
// boundary of 2 * itemsize bytes; y is (K, 2, m).  `lanes` (a power of two,
// 2 to 32) scenarios of a row share a warp.  1 <= K <= 65535 (K = 0
// launches nothing); -1 for arguments the kernel does not take.
int dia_spmv_split_batched(int itemsize, int m, int K, int lanes, int parts,
                           const void* eptr, const void* ecol,
                           const void* ere, const void* eim, const void* x,
                           void* y, void* stream) {
  int lanes_log2 = 1;
  while (lanes_log2 < 5 && (1 << lanes_log2) < lanes) ++lanes_log2;
  if ((itemsize != 4 && itemsize != 8) || m < 0 || K < 0 || K > 65535 ||
      lanes != 1 << lanes_log2 || parts != run_parts(m) ||
      reinterpret_cast<size_t>(x) % (2 * itemsize) != 0)
    return -1;
  if (m == 0 || K == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ep = static_cast<const int*>(eptr);
  const int* ec = static_cast<const int*>(ecol);
  return itemsize == 4
             ? launch_entries<float>(m, K, lanes_log2, ep, ec, ere, eim, x, y,
                                     st)
             : launch_entries<double>(m, K, lanes_log2, ep, ec, ere, eim, x,
                                      y, st);
}

const char* dia_spmv_error_string(int code) {
  if (code == -1) return "invalid argument to dia_spmv";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
