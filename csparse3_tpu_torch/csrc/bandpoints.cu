// Split-complex band + points SpMV for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of csparse3_tpu/kernels/bandpoints.py:
//   band_points_supertile_pallas (K1, pallas_call at :546),
//   band_points_spmv_pallas      (K2, pallas_call in _fused_call, :366),
//   points_spmv_pallas           (K3, pallas_call in _points_call, :266).
// The three differ only in how they budget the TPU's VMEM; here they are one
// kernel and one launch per matvec.  K3 served the offset groups past the
// first: the TPU partitions the scattered entries by offset so that each
// call gathers x from a VMEM window of its group's span, one call per
// group, each adding into y.  Hopper gathers through L1/L2 with no window,
// so the groups are bookkeeping of the plan's build: SplitBandPoints joins
// their per-row lists, in group order, into the lists this kernel walks.
// The groups partition the offsets into ascending ranges, so the joined
// lists are exactly those of the ungrouped plan, and a grouped plan gives
// the same bits in the same one launch.
//
// What it computes, for a square complex A split into
//   * D heavy diagonals: slab_{re,im}[d * m + i] = A[i, i + offs[d]], and
//   * the scattered "wash" entries as per-row lists sorted by row: entries
//     ptr[i] .. ptr[i+1] of (col, val_re, val_im) belong to row i,
// is y = A x with x = x_re + i x_im:
//   y[i] = sum_e val_e * x[col_e] + sum_d slab_d[i] * x[i + offs[d]]
// in float32, complex arithmetic written out on (re, im) pairs.
//
// What bounds it on an H100: device-memory bytes.  Each nonzero costs 8
// floating-point operations for 16 bytes read (its complex value and the
// complex x it meets): 0.5 FLOP per byte, against the card's ~20 (67 TFLOP/s
// f32 over 3.35 TB/s).  At 200k buses (about 1.1M nonzeros, 5 heavy
// diagonals) a call reads ~8 MB of slabs, ~2 MB of point tables, 1.6 MB of
// x and writes 1.6 MB of y: small enough to stay in the 50 MB L2 across
// back-to-back calls.
//
// What the design does about it: every byte is read once, in one launch.
// One thread owns one row (a CTA covers one row tile of blockDim.x rows), so
// slab reads and the shifted x[i + off] reads of a diagonal are coalesced
// across the warp; a row's point entries are contiguous.  The TPU kernels
// emulated the gather with one-hot matrix products (bf16-split for f32
// exactness); Hopper gathers natively, so x[col] is a direct load, no
// operand is split and every product is plain f32.  Each thread writes only
// its own row, once: no atomics, so the result is deterministic run to run.
//
// A batch of K vectors (the scenario axis of the batched power-flow studies:
// K load cases or K outages, one Ybus) is one launch of its own kernel,
// scenario-minor.  x comes as (n, K, 2): the K scenarios' (xr, xi) of a
// column side by side, copied from the (K, n) parts by this file's copy
// kernel (scenario_minor_pairs, which serves the batched DIA kernel too).
// A thread owns one (row, scenario) pair, and L lanes (a power of two, at
// most 32, chosen by the caller from K) take consecutive scenarios of one
// row: a row's terms are read once for L scenarios (warp-uniform loads),
// and the gather x[c, k0 : k0 + L] is one contiguous read of up to 256
// bytes.  The terms come as the plan's batch
// entries, one list per row built once from the slabs and point lists: the
// points, then the heavy diagonals whose column lies inside the matrix, each
// as (col, re, im), so that a thread reads a row pointer, its entries and x,
// three rounds of loads, with up to kChunk gathers in flight.  y stays (2,
// K, m): a CTA's rows x scenarios go through shared memory and are written
// along m.  A kernel with lanes over rows and the scenario on the grid's
// second axis read the slabs and lists again for every scenario: 8.2 us on
// an H100 at 10k buses x 32 scenarios, 20% of the bytes' bound.
//   Bits.  The entries keep the one-vector thread's order of terms, and both
// kernels write each complex product with explicit roundings (cmac), so
// that no compiler contraction can tell them apart: a row of a batch has the
// bits of its own one-vector launch, and K = 1 goes to the one-vector
// launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// ar += vr * xr - vi * xi and ai += vr * xi + vi * xr, each product and sum
// rounded as written here
__device__ __forceinline__ void cmac(float& ar, float& ai, float vr,
                                     float vi, float xr, float xi) {
  ar = __fadd_rn(ar, __fmaf_rn(vr, xr, -__fmul_rn(vi, xi)));
  ai = __fadd_rn(ai, __fmaf_rn(vr, xi, __fmul_rn(vi, xr)));
}

__global__ void band_points_kernel(
    int m, int n, int D, const int* __restrict__ offs,
    const float* __restrict__ slab_re, const float* __restrict__ slab_im,
    const int* __restrict__ ptr, const int* __restrict__ col,
    const float* __restrict__ val_re, const float* __restrict__ val_im,
    const float* __restrict__ x_re, const float* __restrict__ x_im,
    float* __restrict__ y_re, float* __restrict__ y_im) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float ar = 0.f, ai = 0.f;
  const int e_end = ptr[i + 1];
  for (int e = ptr[i]; e < e_end; ++e) {
    const int c = col[e];
    cmac(ar, ai, val_re[e], val_im[e], x_re[c], x_im[c]);
  }
  for (int d = 0; d < D; ++d) {
    const int j = i + __ldg(offs + d);
    if (j >= 0 && j < n) {
      const size_t s = static_cast<size_t>(d) * m + i;
      cmac(ar, ai, slab_re[s], slab_im[s], x_re[j], x_im[j]);
    }
  }
  y_re[i] = ar;
  y_im[i] = ai;
}

// threads per CTA of the batched kernel: kBatchTile / L rows of L lanes
constexpr int kBatchTileLog2 = 8;
constexpr int kBatchTile = 1 << kBatchTileLog2;
// entries a thread of the batched kernel gathers x for before it
// multiplies: a row of the 10k-bus Ybus has 5-6
constexpr int kChunk = 8;

// The product for K vectors, scenario-minor, over the plan's batch entries:
// for each row its terms in the one-vector thread's order (the points in
// list order, then the heavy diagonals whose column lies inside the matrix,
// d = 0 .. D - 1), as (col, re, im) (SplitBandPoints.batch_entries).  x is
// (n, K) pairs (x[c * K + k]), y is (2, K, m).  1 << lanes_log2 lanes a
// row; grid.y walks the scenarios in chunks of that many.  Lanes past the
// last scenario read scenario K - 1 and write nothing.
__global__ void __launch_bounds__(kBatchTile) band_points_entries_kernel(
    int m, int K, int lanes_log2, const int* __restrict__ eptr,
    const int* __restrict__ ecol, const float* __restrict__ evr,
    const float* __restrict__ evi, const float2* __restrict__ x,
    float* __restrict__ y) {
  const int rows_log2 = kBatchTileLog2 - lanes_log2;
  const int rows = 1 << rows_log2;
  const int s = threadIdx.x & ((1 << lanes_log2) - 1);
  const int rl = threadIdx.x >> lanes_log2;
  const int i0 = blockIdx.x << rows_log2;
  const int i = i0 + rl;
  const int k0 = blockIdx.y << lanes_log2;
  const float2* __restrict__ xk = x + min(k0 + s, K - 1);
  float ar = 0.f, ai = 0.f;
  if (i < m) {
    const int e1 = eptr[i + 1];
    for (int eb = eptr[i]; eb < e1; eb += kChunk) {
      // the gathers of the chunk first, every one in flight before any
      // product (an entry past e1 repeats the last one's gather and adds
      // nothing); the values after them, warp-uniform loads
      float2 xv[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q)
        xv[q] = xk[static_cast<size_t>(ecol[min(eb + q, e1 - 1)]) * K];
#pragma unroll
      for (int q = 0; q < kChunk; ++q)
        if (eb + q < e1)
          cmac(ar, ai, evr[eb + q], evi[eb + q], xv[q].x, xv[q].y);
    }
  }
  // (scenario, row) tiles of yr and yi, a row of padding per scenario
  __shared__ float tile[2][kBatchTile + 32];
  const int ld = rows + 1;
  tile[0][s * ld + rl] = ar;
  tile[1][s * ld + rl] = ai;
  __syncthreads();
  const int s2 = threadIdx.x >> rows_log2;
  const int r2 = threadIdx.x & (rows - 1);
  const int k = k0 + s2;
  if (k < K && i0 + r2 < m) {
    float* yk = y + static_cast<size_t>(k) * m + i0 + r2;
    yk[0] = tile[0][s2 * ld + r2];
    yk[static_cast<size_t>(K) * m] = tile[1][s2 * ld + r2];
  }
}

// The copy of a batch of K vectors into the batched kernels' layout (this
// file's and the DIA split-complex one of dia_spmv.cu): out (n, K, 2) from
// the (K, n) parts xr and xi, out[c, k] = (xr[k, c], xi[k, c]).  A CTA moves
// a tile of 32 columns x 32 scenarios through shared memory: it reads rows
// of the parts along n and writes the tile's pairs along K, so both sides
// are coalesced (a warp reads 32 consecutive values of a part and writes 32
// consecutive pairs).
template <typename T>
struct alignas(2 * sizeof(T)) PairOf {
  T re, im;
};

template <typename T>
__global__ void __launch_bounds__(256) scenario_minor_pairs_kernel(
    int K, int n, const T* __restrict__ xr, const T* __restrict__ xi,
    PairOf<T>* __restrict__ out) {
  __shared__ T tr[32][33], ti[32][33];
  const int c0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = ty; j < 32; j += 8) {
    const int k = k0 + j, c = c0 + tx;
    if (k < K && c < n) {
      const size_t o = static_cast<size_t>(k) * n + c;
      tr[j][tx] = xr[o];
      ti[j][tx] = xi[o];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = ty; j < 32; j += 8) {
    const int c = c0 + j, k = k0 + tx;
    if (k < K && c < n)
      out[static_cast<size_t>(c) * K + k] = PairOf<T>{tr[tx][j], ti[tx][j]};
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError():
// 0 when the launch was accepted.  `tile` is the CTA size (rows per CTA).
int bandpoints_spmv(int m, int n, int D, const int* offs,
                    const float* slab_re, const float* slab_im,
                    const int* ptr, const int* col,
                    const float* val_re, const float* val_im,
                    const float* x_re, const float* x_im,
                    float* y_re, float* y_im, int tile, void* stream) {
  if (m <= 0) return 0;
  const int grid = (m + tile - 1) / tile;
  band_points_kernel<<<grid, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      m, n, D, offs, slab_re, slab_im, ptr, col, val_re, val_im, x_re, x_im,
      y_re, y_im);
  return static_cast<int>(cudaGetLastError());
}

// K vectors in one launch, scenario-minor, over the batch entries (eptr
// (m + 1), ecol, evr, evi: SplitBandPoints.batch_entries): x is (n, K, 2)
// float32, on an 8-byte boundary, and y (2, K, m), the real parts first;
// `lanes` (a power of two, 2 to 32) scenarios of a row share a warp.
// Returns -1 for arguments the kernel does not take; 1 <= K <= 65535 (K = 0
// launches nothing).
int bandpoints_spmv_batched(int m, int K, int lanes, const int* eptr,
                            const int* ecol, const float* evr,
                            const float* evi, const void* x, float* y,
                            void* stream) {
  int lanes_log2 = 1;
  while (lanes_log2 < 5 && (1 << lanes_log2) < lanes) ++lanes_log2;
  if (m < 0 || K < 0 || K > 65535 || lanes != 1 << lanes_log2 ||
      reinterpret_cast<size_t>(x) % sizeof(float2) != 0)
    return -1;
  if (m == 0 || K == 0) return 0;
  const int rows_log2 = kBatchTileLog2 - lanes_log2;
  const dim3 grid(((m - 1) >> rows_log2) + 1, ((K - 1) >> lanes_log2) + 1);
  band_points_entries_kernel<<<grid, kBatchTile, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      m, K, lanes_log2, eptr, ecol, evr, evi, static_cast<const float2*>(x),
      y);
  return static_cast<int>(cudaGetLastError());
}

// out (n, K, 2) = the (K, n) parts xr, xi with each column's K pairs side
// by side (the input of the batched kernels); itemsize 4 (float) or 8
// (double), all three contiguous, out on a boundary of 2 * itemsize bytes.
// One launch; -1 for arguments the kernel does not take (K up to 65535 *
// 32).
int scenario_minor_pairs(int itemsize, int K, int n, const void* xr,
                         const void* xi, void* out, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || K < 0 || n < 0 ||
      (K + 31) / 32 > 65535 ||
      reinterpret_cast<size_t>(out) % (2 * itemsize) != 0)
    return -1;
  if (K == 0 || n == 0) return 0;
  const dim3 grid((n + 31) / 32, (K + 31) / 32), block(32, 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itemsize == 4)
    scenario_minor_pairs_kernel<float><<<grid, block, 0, st>>>(
        K, n, static_cast<const float*>(xr), static_cast<const float*>(xi),
        static_cast<PairOf<float>*>(out));
  else
    scenario_minor_pairs_kernel<double><<<grid, block, 0, st>>>(
        K, n, static_cast<const double*>(xr), static_cast<const double*>(xi),
        static_cast<PairOf<double>*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* bandpoints_error_string(int code) {
  if (code == -1) return "invalid argument to bandpoints_spmv";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
