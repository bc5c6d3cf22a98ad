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
// zeros.  With column lists (col_ptr over the stored blocks, col_idx the
// sorted columns c of a block that hold a nonzero in any of its R rows) the
// sum over c runs over a block's listed columns only: the same result, as
// every other term is a product with zero.
//
// What bounds it on an H100.  A matrix that has blocks (the 32 x 32 blocks of
// a multi-physics or multi-phase system) is bound by float32 operations
// outside the tensor cores, 2*R*C*k per block at 67 TFLOP/s, and what a
// simple kernel pays instead is one shared-memory read per multiply-add and
// the rows of X read again for every 8 rows of a block.  A matrix without
// blocks (a power-grid admittance matrix packed to the (8, 128) tile of a
// TPU) is 99% padding: 5 of a block's 128 columns hold anything, so 96% of
// the operations and of the X rows read are products with zero; what must
// move is one row of X (k values) for each occupied column.
//
// What the design does about it.
//  - Occupied columns only.  A block whose list is shorter than the block is
//    walked through its list: X row indices[p]*C + c and the R values
//    data[p, :, c] for each listed c, nothing else.  A block whose list is
//    full takes the same loop over c = 0..C-1 with no list read.  data keeps
//    its (nblocks, R, C) layout.
//  - More work per value loaded.  One CTA owns (block row, tile of X columns,
//    ROWS rows of the block); a thread owns V consecutive columns of X (one
//    16-byte load: 4 floats or 2 doubles) and ROWS x V sums in registers, so
//    a staged block value meets V multiply-adds per shared-memory read, the
//    ROWS values of one block column are adjacent in shared memory (vector
//    reads), and with ROWS = 16 for blocks taller than 8 rows X is read half
//    as often.  k that is ragged, short or misaligned takes V = 1.
//  - The next piece of the block (<= kCols columns x ROWS rows, and the
//    column numbers) is staged with cp.async into the other half of a double
//    buffer while the current one is consumed.
// Y is written once, zeros included, so the caller does not clear it.  R, C,
// m, n and k are run-time values and the ragged edges are guarded here: X
// and Y are not padded.  Every output element is summed by one thread in the
// order of the blocks and of their columns: no atomics, bit-equal results
// from run to run.  Float32/float64 multiply-adds only: the per-row rounding
// bound the product is held to is that of float32 sums, which TF32 tensor-core
// products do not meet (wgmma on split operands is the step after this one).
//
// What the TPU kernel needed and this one does not: a grid that walks the
// blocks in order and revisits the output tile, scalar-prefetched block rows
// and first-of-row flags, X padded to its k tile and to nb*C rows, and the
// zeroing pass afterwards.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads per CTA
constexpr int kCols = 128;     // columns of a block staged at a time

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The pieces one CTA walks: the blocks of its block row, each cut into
// pieces of <= kCols listed (or all) columns.  Every thread of the CTA keeps
// the same copy.
template <typename I>
struct Walk {
  const I* indices;
  const int* col_ptr;  // null: every column of every block
  int n, C;
  I p, p1;
  long long col0;  // first column of block p in A
  int cmax;        // columns of block p inside [0, n)
  int lo, cnt;     // its list: col_idx[lo .. lo + cnt); cnt = cmax when full
  int c0;          // first list position of the current piece
  bool full;       // the list is every column: c = position, no list read

  __device__ bool live() const { return p < p1; }
  __device__ int width() const {
    return (cnt - c0) < kCols ? (cnt - c0) : kCols;
  }
  // move p to the next block with something to multiply, from p on
  __device__ void settle() {
    for (; p < p1; ++p) {
      col0 = static_cast<long long>(indices[p]) * C;
      const long long room = n - col0;
      cmax = room < C ? static_cast<int>(room < 0 ? 0 : room) : C;
      lo = 0;
      cnt = cmax;
      if (col_ptr != nullptr) {
        lo = col_ptr[p];
        const int listed = col_ptr[p + 1] - lo;
        if (listed < cmax) cnt = listed;
      }
      full = cnt == cmax;
      if (cnt > 0) break;
    }
    c0 = 0;
  }
  __device__ void next() {
    c0 += kCols;
    if (c0 >= cnt) {
      ++p;
      settle();
    }
  }
};

template <typename T, typename I, int ROWS, int V>
__global__ void __launch_bounds__(kThreads)
    bsr_spmm_kernel(int m, int n, int k, int R, int C,
                    const I* __restrict__ indptr,
                    const I* __restrict__ indices,
                    const T* __restrict__ data,
                    const int* __restrict__ col_ptr,
                    const int* __restrict__ col_idx,
                    const T* __restrict__ x, T* __restrict__ y) {
  // [buffer][column of the piece][row of the chunk]: the ROWS values one
  // column meets are adjacent
  __shared__ __align__(16) T sa[2][kCols][ROWS];
  __shared__ int sc[2][kCols];
  const int br = blockIdx.x;
  // V > 1 only when k % V == 0: a thread's V columns are inside or outside
  const long long j0 =
      (static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x) * V;
  const int r0 = blockIdx.z * ROWS;  // first row of this chunk in the block
  const bool live = j0 < k;
  T acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = T(0);
  const size_t block_elems = static_cast<size_t>(R) * C;

  // stage piece `w` into buffer b: values by cp.async, zeros and the column
  // numbers by plain stores
  auto stage = [&](int b, const Walk<I>& w) {
    const int cw = w.width();
    const T* blk = data + static_cast<size_t>(w.p) * block_elems;
    for (int idx = threadIdx.x; idx < ROWS * cw; idx += kThreads) {
      const int r = idx / cw, t = idx - r * cw;
      int c = w.full ? w.c0 + t : col_idx[w.lo + w.c0 + t];
      // a listed column outside the block or past n is not read
      const bool inside = c >= 0 && c < w.cmax;
      if (!inside) c = 0;
      if (r == 0) sc[b][t] = c;
      if (inside && r0 + r < R)
        __pipeline_memcpy_async(&sa[b][t][r],
                                blk + static_cast<size_t>(r0 + r) * C + c,
                                sizeof(T));
      else
        sa[b][t][r] = T(0);
    }
  };

  Walk<I> cur;
  cur.indices = indices;
  cur.col_ptr = col_ptr;
  cur.n = n;
  cur.C = C;
  cur.p = indptr[br];
  cur.p1 = indptr[br + 1];
  cur.settle();
  if (cur.live()) stage(0, cur);
  __pipeline_commit();
  int b = 0;
  while (cur.live()) {
    Walk<I> nxt = cur;
    nxt.next();
    if (nxt.live()) stage(b ^ 1, nxt);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of `cur` have landed
    __syncthreads();           // and everyone's are visible
    if (live) {
      const int cw = cur.width();
      const T* xb = x + static_cast<size_t>(cur.col0) * k + j0;
#pragma unroll 2
      for (int t = 0; t < cw; ++t) {
        const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(
            xb + static_cast<size_t>(sc[b][t]) * k);
        T a[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) a[r] = sa[b][t][r];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] += a[r] * xv.v[v];
      }
    }
    __syncthreads();  // buffer b is free for the piece after the next
    cur = nxt;
    b ^= 1;
  }
  if (!live) return;
  const long long row0 = static_cast<long long>(br) * R + r0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (r0 + r < R && row0 + r < m) {
      Vec<T, V> out;
#pragma unroll
      for (int v = 0; v < V; ++v) out.v[v] = acc[r][v];
      *reinterpret_cast<Vec<T, V>*>(y + static_cast<size_t>(row0 + r) * k +
                                    j0) = out;
    }
}

template <typename T, typename I, int ROWS, int V>
int launch_as(int m, int n, int k, int R, int C, const I* indptr,
              const I* indices, const T* data, const int* col_ptr,
              const int* col_idx, const T* x, T* y, cudaStream_t stream) {
  const int mb = (m + R - 1) / R;
  const dim3 grid(mb, (k + kThreads * V - 1) / (kThreads * V),
                  (R + ROWS - 1) / ROWS);
  if (grid.y > 65535u || grid.z > 65535u) return -1;
  bsr_spmm_kernel<T, I, ROWS, V><<<grid, kThreads, 0, stream>>>(
      m, n, k, R, C, indptr, indices, data, col_ptr, col_idx, x, y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int launch(int m, int n, int k, int R, int C, const void* indptr,
           const void* indices, const void* data, const void* col_ptr,
           const void* col_idx, const void* x, void* y, cudaStream_t st) {
  const I* ip = static_cast<const I*>(indptr);
  const I* ix = static_cast<const I*>(indices);
  const T* dt = static_cast<const T*>(data);
  const int* cp = static_cast<const int*>(col_ptr);
  const int* ci = static_cast<const int*>(col_idx);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  // 16-byte vectors of X and Y: every row must start on a 16-byte boundary,
  // and k must fill at least two CTAs' worth of single columns
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = k % kVec == 0 && k >= 2 * kThreads &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const bool tall = R > 8;  // 16 rows per thread: X read half as often
  if (vec)
    return tall ? launch_as<T, I, 16, kVec>(m, n, k, R, C, ip, ix, dt, cp, ci,
                                            xv, yv, st)
                : launch_as<T, I, 8, kVec>(m, n, k, R, C, ip, ix, dt, cp, ci,
                                           xv, yv, st);
  return tall ? launch_as<T, I, 16, 1>(m, n, k, R, C, ip, ix, dt, cp, ci, xv,
                                       yv, st)
              : launch_as<T, I, 8, 1>(m, n, k, R, C, ip, ix, dt, cp, ci, xv,
                                      yv, st);
}

}  // namespace

extern "C" {

// One launch on `stream` (a cudaStream_t); returns cudaGetLastError(): 0 when
// the launch was accepted, -1 for arguments the kernel does not take.
// itemsize is 4 (float) or 8 (double) for data, x and y; index_size is 4
// (int32) or 8 (int64) for indptr (ceil(m / R) + 1) and indices.  col_ptr
// (stored blocks + 1) and col_idx are the int32 column lists; a null col_ptr
// means every column of every block (col_idx is then not read).
int bsr_spmm(int itemsize, int index_size, int m, int n, int k, int R, int C,
             const void* indptr, const void* indices, const void* data,
             const void* col_ptr, const void* col_idx, const void* x, void* y,
             void* stream) {
  if ((itemsize != 4 && itemsize != 8) || (index_size != 4 && index_size != 8) ||
      m < 0 || n < 0 || k < 0 || R <= 0 || C <= 0)
    return -1;
  if (m == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itemsize == 4)
    return index_size == 4
               ? launch<float, int>(m, n, k, R, C, indptr, indices, data,
                                    col_ptr, col_idx, x, y, st)
               : launch<float, long long>(m, n, k, R, C, indptr, indices, data,
                                          col_ptr, col_idx, x, y, st);
  return index_size == 4
             ? launch<double, int>(m, n, k, R, C, indptr, indices, data,
                                   col_ptr, col_idx, x, y, st)
             : launch<double, long long>(m, n, k, R, C, indptr, indices, data,
                                         col_ptr, col_idx, x, y, st);
}

const char* bsr_spmm_error_string(int code) {
  if (code == -1) return "invalid argument to bsr_spmm";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
