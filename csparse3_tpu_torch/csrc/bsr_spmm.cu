// Block-sparse-row matrix times dense matrix, Y = A * X, for Hopper (sm_90a),
// float32 and float64.
//
// Replaces the Pallas TPU kernel of csparse3_tpu/kernels/bsr_spmm_pallas.py:
// bsr_spmm_pallas (K5, pallas_call in _call, :71).
//
// What it computes.  A is (m, n) in BSR: block row br owns the stored blocks
// p in [indptr[br], indptr[br + 1]); block p is the dense (R, C) array
// data[p] and sits at block column indices[p].  X is (n, k) and Y (m, k),
// both row-major:
//   Y[br*R + r, j] = sum_p sum_{c < C} data[p, r, c] * X[indices[p]*C + c, j].
// The last block row and block column may reach past m and n: those rows are
// not written and those columns not read.  A block row without blocks gives
// zeros.
//
// What bounds it on an H100.  Each stored block meets 2*R*C*k operations for
// R*C values of A, C*k of X and, per block row, R*k of Y.  With X and Y
// counted once (the bound's convention) a matrix of few, well filled blocks
// and k in the hundreds is bound by float32 operations (67 TFLOP/s outside
// the tensor cores); a matrix whose (8, 128) blocks are mostly padding, as a
// power-grid admittance matrix gives, is bound by the bytes of the blocks.
// What this kernel really pays for is X: every block reads its own C rows
// of X for every tile of k, from the L2 at best.
//
// What the design does about it (the simple form): one CTA per (block row,
// tile of kTile columns of X, chunk of kRows rows of the block).  A thread
// owns one column j of the tile and keeps kRows sums in registers, so the
// read of a row of X is one coalesced line per warp and meets kRows
// multiply-adds; the (kRows, <= kCols) piece of the block is staged in
// shared memory once per CTA and read from there as a broadcast.  Y is
// written once, zeros included, so the caller does not clear it and no pass
// over the empty block rows follows the launch.  R, C, m, n and k are
// run-time values and the ragged edges are guarded here: X and Y are not
// padded.  What the TPU kernel needed and this one does not: a grid that
// walks the blocks in order and revisits the output tile, scalar-prefetched
// block rows and first-of-row flags, X padded to its k tile and to nb*C
// rows, and the zeroing pass afterwards.  Tensor cores (wgmma on staged X
// tiles) and more rows per thread are the next step on the same source.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 128;  // columns of X per CTA = threads per CTA
constexpr int kRows = 8;    // rows of a block per CTA (sums per thread)
constexpr int kCols = 128;  // columns of a block staged at a time

template <typename T, typename I>
__global__ void bsr_spmm_kernel(int m, int n, int k, int R, int C,
                                const I* __restrict__ indptr,
                                const I* __restrict__ indices,
                                const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y) {
  __shared__ T sa[kRows][kCols];
  const int br = blockIdx.x;
  const int j = blockIdx.y * kTile + threadIdx.x;
  const int r0 = blockIdx.z * kRows;  // first row of this chunk in the block
  const bool live = j < k;
  T acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = T(0);
  const size_t block_elems = static_cast<size_t>(R) * C;
  const I p1 = indptr[br + 1];
  for (I p = indptr[br]; p < p1; ++p) {
    const long long col0 = static_cast<long long>(indices[p]) * C;
    // columns of this block inside [0, n)
    const long long room = n - col0;
    const int cmax = room < C ? static_cast<int>(room < 0 ? 0 : room) : C;
    const T* blk = data + static_cast<size_t>(p) * block_elems;
    for (int c0 = 0; c0 < cmax; c0 += kCols) {
      const int cw = (cmax - c0) < kCols ? (cmax - c0) : kCols;
      __syncthreads();  // the previous piece has been consumed
      for (int idx = threadIdx.x; idx < kRows * cw; idx += kTile) {
        const int r = idx / cw, c = idx - r * cw;
        sa[r][c] = (r0 + r) < R
                       ? blk[static_cast<size_t>(r0 + r) * C + c0 + c]
                       : T(0);
      }
      __syncthreads();
      if (live) {
        const T* xp = x + static_cast<size_t>(col0 + c0) * k + j;
#pragma unroll 4
        for (int c = 0; c < cw; ++c) {
          const T xv = xp[static_cast<size_t>(c) * k];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] += sa[r][c] * xv;
        }
      }
    }
  }
  if (!live) return;
  const long long row0 = static_cast<long long>(br) * R + r0;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r0 + r < R && row0 + r < m)
      y[static_cast<size_t>(row0 + r) * k + j] = acc[r];
}

template <typename T, typename I>
int launch(int m, int n, int k, int R, int C, const void* indptr,
           const void* indices, const void* data, const void* x, void* y,
           cudaStream_t stream) {
  const int mb = (m + R - 1) / R;
  const dim3 grid(mb, (k + kTile - 1) / kTile, (R + kRows - 1) / kRows);
  if (grid.y > 65535u || grid.z > 65535u) return -1;
  bsr_spmm_kernel<T, I><<<grid, kTile, 0, stream>>>(
      m, n, k, R, C, static_cast<const I*>(indptr),
      static_cast<const I*>(indices), static_cast<const T*>(data),
      static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch on `stream` (a cudaStream_t); returns cudaGetLastError(): 0 when
// the launch was accepted, -1 for arguments the kernel does not take.
// itemsize is 4 (float) or 8 (double) for data, x and y; index_size is 4
// (int32) or 8 (int64) for indptr (ceil(m / R) + 1) and indices.
int bsr_spmm(int itemsize, int index_size, int m, int n, int k, int R, int C,
             const void* indptr, const void* indices, const void* data,
             const void* x, void* y, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || (index_size != 4 && index_size != 8) ||
      m < 0 || n < 0 || k < 0 || R <= 0 || C <= 0)
    return -1;
  if (m == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itemsize == 4)
    return index_size == 4
               ? launch<float, int>(m, n, k, R, C, indptr, indices, data, x, y, st)
               : launch<float, long long>(m, n, k, R, C, indptr, indices, data, x, y, st);
  return index_size == 4
             ? launch<double, int>(m, n, k, R, C, indptr, indices, data, x, y, st)
             : launch<double, long long>(m, n, k, R, C, indptr, indices, data, x, y, st);
}

const char* bsr_spmm_error_string(int code) {
  if (code == -1) return "invalid argument to bsr_spmm";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
