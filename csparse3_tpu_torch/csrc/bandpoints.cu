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
// K load cases or K outages, one Ybus) is one launch with grid.y = K.  The
// slabs and point lists are shared; scenario k reads x at x_re + k * ldx and
// writes y at y_re + k * ldy.  A thread's sums are those of the one-vector
// launch in the same order, so each row of a batch has the bits of its own
// launch, and K = 1 is that launch.  The batch re-reads the matrix once per
// scenario; at 10k buses the slabs and lists are 1.1 MB and stay in the L2.

#include <cuda_runtime.h>

namespace {

__global__ void band_points_kernel(
    int m, int n, int D, const int* __restrict__ offs,
    const float* __restrict__ slab_re, const float* __restrict__ slab_im,
    const int* __restrict__ ptr, const int* __restrict__ col,
    const float* __restrict__ val_re, const float* __restrict__ val_im,
    const float* __restrict__ x_re, const float* __restrict__ x_im,
    float* __restrict__ y_re, float* __restrict__ y_im, long long ldx,
    long long ldy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const long long k = blockIdx.y;
  x_re += k * ldx;
  x_im += k * ldx;
  y_re += k * ldy;
  y_im += k * ldy;
  float ar = 0.f, ai = 0.f;
  const int e_end = ptr[i + 1];
  for (int e = ptr[i]; e < e_end; ++e) {
    const int c = col[e];
    const float vr = val_re[e], vi = val_im[e];
    const float xr = x_re[c], xi = x_im[c];
    ar += vr * xr - vi * xi;
    ai += vr * xi + vi * xr;
  }
  for (int d = 0; d < D; ++d) {
    const int j = i + __ldg(offs + d);
    if (j >= 0 && j < n) {
      const size_t s = static_cast<size_t>(d) * m + i;
      const float sr = slab_re[s], si = slab_im[s];
      const float xr = x_re[j], xi = x_im[j];
      ar += sr * xr - si * xi;
      ai += sr * xi + si * xr;
    }
  }
  y_re[i] = ar;
  y_im[i] = ai;
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError():
// 0 when the launch was accepted, -1 for a batch the grid cannot hold.
// `tile` is the CTA size (rows per CTA).  K vectors in one launch: vector k
// of x starts ldx floats after vector k - 1 (in both parts), and of y ldy.
int bandpoints_spmv_batched(int m, int n, int D, const int* offs,
                            const float* slab_re, const float* slab_im,
                            const int* ptr, const int* col,
                            const float* val_re, const float* val_im,
                            const float* x_re, const float* x_im,
                            float* y_re, float* y_im, int K, long long ldx,
                            long long ldy, int tile, void* stream) {
  if (K < 0 || K > 65535) return -1;
  if (m <= 0 || K == 0) return 0;
  const dim3 grid((m + tile - 1) / tile, K);
  band_points_kernel<<<grid, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      m, n, D, offs, slab_re, slab_im, ptr, col, val_re, val_im, x_re, x_im,
      y_re, y_im, ldx, ldy);
  return static_cast<int>(cudaGetLastError());
}

// One vector: the batched launch with K = 1.
int bandpoints_spmv(int m, int n, int D, const int* offs,
                    const float* slab_re, const float* slab_im,
                    const int* ptr, const int* col,
                    const float* val_re, const float* val_im,
                    const float* x_re, const float* x_im,
                    float* y_re, float* y_im, int tile, void* stream) {
  return bandpoints_spmv_batched(m, n, D, offs, slab_re, slab_im, ptr, col,
                                 val_re, val_im, x_re, x_im, y_re, y_im, 1,
                                 n, m, tile, stream);
}

const char* bandpoints_error_string(int code) {
  if (code == -1) return "invalid argument to bandpoints_spmv";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
