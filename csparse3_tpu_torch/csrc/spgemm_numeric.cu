// Numeric pass of a sparse product C = A * B on a frozen pattern, for Hopper
// (sm_90a): float32, float64, complex64 and complex128.
//
// Replaces the Pallas TPU kernel of csparse3_tpu/kernels/spgemm_pallas.py:
// spgemm_numeric_pallas (K6, pallas_call at :109), reached from
// SpGEMMPlan.numeric.
//
// What it computes.  The symbolic phase (host, once per pattern) lists every
// elementary product of the result, sorted by the output entry it belongs
// to: product t multiplies entry pa[t] of A's value array by entry pb[t] of
// B's, and the products of output o are t in [seg_ptr[o], seg_ptr[o + 1]):
//   data[o] = sum_{t = seg_ptr[o]}^{seg_ptr[o+1] - 1} a[pa[t]] * b[pb[t]].
//
// What bounds it on an H100: device-memory bytes.  A product costs two
// 4-byte map reads, two gathered values and one multiply-add; the card does
// ~20 float32 operations in the time of one byte.  On the power-grid and
// random patterns this serves the mean segment holds 1.1-1.2 products, so
// the segment pointers and the output weigh as much as the maps.
//
// What the design does about it: one pass, one thread per output, the sum
// kept in a register and written once.  Neighbouring threads own
// neighbouring outputs, so seg_ptr and data are coalesced and, segments
// being short, so are pa and pb nearly; the two value gathers a[pa[t]],
// b[pb[t]] are what the card's caches are for (the TPU kernel had to emulate
// them with one-hot matrix products over values resident in its fast memory,
// which capped both value arrays at ~32k entries, re-tiled the products into
// blocks of 256 outputs padded to a common length, and took float32 only:
// none of that is carried over, and there is no size cap here).  Each output
// is summed by one thread in product order: no atomics, the result is
// deterministic.  A hub output with a long segment serializes on its thread;
// a warp per long segment is the remedy when a pattern needs it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename R>
struct Cx {
  R re, im;
};

__device__ inline float madd(float acc, float a, float b) { return acc + a * b; }
__device__ inline double madd(double acc, double a, double b) { return acc + a * b; }
template <typename R>
__device__ inline Cx<R> madd(Cx<R> acc, Cx<R> a, Cx<R> b) {
  acc.re += a.re * b.re - a.im * b.im;
  acc.im += a.re * b.im + a.im * b.re;
  return acc;
}

template <typename T>
__global__ void spgemm_numeric_kernel(int out_nnz,
                                      const int* __restrict__ seg_ptr,
                                      const int* __restrict__ pa,
                                      const int* __restrict__ pb,
                                      const T* __restrict__ a,
                                      const T* __restrict__ b,
                                      T* __restrict__ data) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= out_nnz) return;
  const int t1 = seg_ptr[o + 1];
  T acc = T();
  for (int t = seg_ptr[o]; t < t1; ++t) acc = madd(acc, a[pa[t]], b[pb[t]]);
  data[o] = acc;
}

template <typename T>
int launch(int out_nnz, const void* seg_ptr, const void* pa, const void* pb,
           const void* a, const void* b, void* data, cudaStream_t stream) {
  const int grid = (out_nnz + kThreads - 1) / kThreads;
  spgemm_numeric_kernel<T><<<grid, kThreads, 0, stream>>>(
      out_nnz, static_cast<const int*>(seg_ptr), static_cast<const int*>(pa),
      static_cast<const int*>(pb), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(data));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch on `stream` (a cudaStream_t); returns cudaGetLastError(): 0 when
// the launch was accepted, -1 for arguments the kernel does not take.
// itemsize is the size of one real component, 4 (float) or 8 (double);
// is_complex selects interleaved (re, im) values.  seg_ptr (out_nnz + 1), pa
// and pb are int32.
int spgemm_numeric(int itemsize, int is_complex, int out_nnz,
                   const void* seg_ptr, const void* pa, const void* pb,
                   const void* a, const void* b, void* data, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || out_nnz < 0) return -1;
  if (out_nnz == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_complex)
    return itemsize == 4
               ? launch<Cx<float>>(out_nnz, seg_ptr, pa, pb, a, b, data, st)
               : launch<Cx<double>>(out_nnz, seg_ptr, pa, pb, a, b, data, st);
  return itemsize == 4
             ? launch<float>(out_nnz, seg_ptr, pa, pb, a, b, data, st)
             : launch<double>(out_nnz, seg_ptr, pa, pb, a, b, data, st);
}

const char* spgemm_numeric_error_string(int code) {
  if (code == -1) return "invalid argument to spgemm_numeric";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
