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
// What bounds it on an H100.  The patterns it serves hold 1.09-1.12
// products per output (the longest segment 24), so the work is about one
// product per output, each a chain of three dependent loads (the segment
// bounds, the two map entries, the two value gathers) ending in one small
// write.  It is bound by how many such chains are in flight, then by the
// bytes of its streams (seg_ptr, the maps and the output: 62.5 of the 69.7
// MB it moves at the 200k-bus connectivity product; the gathered values
// stay in L2).  One thread per output, as the first version had it, keeps
// one chain per thread in flight and reached 60% of the byte bound; this
// design reaches 93% there (PERF.md).
//
// What the design does about it:
//  * An output tile per CTA: 256 threads own 256 V consecutive outputs,
//    thread t the outputs o0 + t + 256 k for k < V, so that at every step a
//    warp's lanes take consecutive outputs (coalesced segment bounds and
//    maps, value gathers that fall on few cache lines).  V = 2 on all but
//    small plans: twice the chains in flight at 32 registers a thread.
//  * Every load of a step is issued before any is used: the 2V segment
//    bounds, then the maps of each output's first two products (all but a
//    few segments hold one or two), then their value gathers through the
//    read-only path.  A longer segment's further products follow in turn
//    on its thread: no size cap.
//  * seg_ptr, pa and pb are read once and streamed with evict-first loads,
//    the output written with evict-first stores, so that they do not push
//    the gathered value arrays out of L1 and L2.
//  * Each output is summed by one thread in product order and written once:
//    no atomics, the same bits on every run.
// Measured and left (csparse3_tpu_torch/utils/tune_spgemm.py): staging a
// tile's products in shared memory behind a barrier (maps as 16-byte
// vectors, or lane by lane, or prefetched a tile ahead by cp.async in
// persistent CTAs) beat one thread per output by at most 5%: the barrier
// and 48-80 registers a thread left fewer chains in flight.
// The segment pointers stay (14.7 MB at the 200k-bus product); a layout
// without them would change the plan.
// The TPU kernel emulated the gathers with one-hot matrix products over
// values resident in its fast memory (both value arrays capped at ~32k
// entries, float32 only, products re-tiled and padded per 256 outputs):
// none of that is carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Outputs per thread: 2, unless the plan is too small to give the 132 SMs
// two tiles each; then 1.  Float32 C @ C.T on an H100 80GB HBM3 (700 W),
// device us per launch for V = 1 / 2 / 4 (utils/tune_spgemm.py, before the
// evict-first stores): 53,645 outputs 2.44 / 2.58 / 3.24; 1,004,426 outputs
// 11.4 / 8.6 / 11.5; 3,683,865 outputs 31.9 / 23.9 / 25.4.  At V = 4 a
// thread takes 54-62 registers, so an SM holds half the threads and no more
// outputs than at V = 2.
int outputs_per_thread(int out_nnz) {
  const long long tiles = (out_nnz + 2LL * kThreads - 1) / (2 * kThreads);
  return tiles >= 2 * 132 ? 2 : 1;
}

template <typename R>
struct Cx {
  R re, im;
};

__device__ inline float mul(float a, float b) { return a * b; }
__device__ inline double mul(double a, double b) { return a * b; }
template <typename R>
__device__ inline Cx<R> mul(Cx<R> a, Cx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

__device__ inline float add(float a, float b) { return a + b; }
__device__ inline double add(double a, double b) { return a + b; }
template <typename R>
__device__ inline Cx<R> add(Cx<R> a, Cx<R> b) {
  return {a.re + b.re, a.im + b.im};
}

// loads through the read-only data path
__device__ inline float ld(const float* p) { return __ldg(p); }
__device__ inline double ld(const double* p) { return __ldg(p); }
__device__ inline Cx<float> ld(const Cx<float>* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return {v.x, v.y};
}
__device__ inline Cx<double> ld(const Cx<double>* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return {v.x, v.y};
}

// evict-first stores of the output
__device__ inline void store(float* p, float v) { __stcs(p, v); }
__device__ inline void store(double* p, double v) { __stcs(p, v); }
__device__ inline void store(Cx<float>* p, Cx<float> v) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(v.re, v.im));
}
__device__ inline void store(Cx<double>* p, Cx<double> v) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v.re, v.im));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    spgemm_numeric_kernel(int out_nnz, const int* __restrict__ seg_ptr,
                          const int* __restrict__ pa,
                          const int* __restrict__ pb,
                          const T* __restrict__ a, const T* __restrict__ b,
                          T* __restrict__ data) {
  // the CTA's tile: 256 V consecutive outputs; the thread's: o + 256 k for
  // k < V, so that a warp's lanes take consecutive outputs at every step
  const int o = blockIdx.x * (kThreads * V) + threadIdx.x;
  // ---- the segment bounds of all V outputs (seg_ptr, pa and pb streamed)
  int s[V], e[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ok = o + k * kThreads;
    s[k] = e[k] = 0;
    if (ok < out_nnz)
      s[k] = __ldcs(seg_ptr + ok), e[k] = __ldcs(seg_ptr + ok + 1);
  }
  // ---- the maps of their first two products (all but a few segments
  // hold one or two), then the value gathers: all loads issued before any
  // is used
  int ia0[V], ib0[V], ia1[V], ib1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ia0[k] = ib0[k] = ia1[k] = ib1[k] = 0;
    if (s[k] < e[k]) ia0[k] = __ldcs(pa + s[k]), ib0[k] = __ldcs(pb + s[k]);
    if (s[k] + 1 < e[k])
      ia1[k] = __ldcs(pa + s[k] + 1), ib1[k] = __ldcs(pb + s[k] + 1);
  }
  T va0[V], vb0[V], va1[V], vb1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    va0[k] = vb0[k] = va1[k] = vb1[k] = T();
    if (s[k] < e[k]) va0[k] = ld(a + ia0[k]), vb0[k] = ld(b + ib0[k]);
    if (s[k] + 1 < e[k]) va1[k] = ld(a + ia1[k]), vb1[k] = ld(b + ib1[k]);
  }
  // ---- each output summed in product order, written once
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ok = o + k * kThreads;
    if (ok >= out_nnz) break;
    T acc = T();
    if (s[k] < e[k]) acc = add(acc, mul(va0[k], vb0[k]));
    if (s[k] + 1 < e[k]) acc = add(acc, mul(va1[k], vb1[k]));
    for (int t = s[k] + 2; t < e[k]; ++t)  // a longer segment, in turn
      acc = add(acc, mul(ld(a + __ldcs(pa + t)), ld(b + __ldcs(pb + t))));
    store(data + ok, acc);
  }
}

template <typename T, int V>
int launch_v(int out_nnz, const void* seg_ptr, const void* pa, const void* pb,
             const void* a, const void* b, void* data, cudaStream_t stream) {
  const int grid =
      static_cast<int>((out_nnz + kThreads * V - 1LL) / (kThreads * V));
  spgemm_numeric_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      out_nnz, static_cast<const int*>(seg_ptr), static_cast<const int*>(pa),
      static_cast<const int*>(pb), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(data));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int out_nnz, const void* seg_ptr, const void* pa, const void* pb,
           const void* a, const void* b, void* data, cudaStream_t stream) {
  if (outputs_per_thread(out_nnz) == 2)
    return launch_v<T, 2>(out_nnz, seg_ptr, pa, pb, a, b, data, stream);
  return launch_v<T, 1>(out_nnz, seg_ptr, pa, pb, a, b, data, stream);
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

// The outputs each thread owns for a plan of out_nnz outputs (the size rule
// above), for the tests and the measurements to name the tile they run.
int spgemm_numeric_outputs_per_thread(int out_nnz) {
  return outputs_per_thread(out_nnz);
}

const char* spgemm_numeric_error_string(int code) {
  if (code == -1) return "invalid argument to spgemm_numeric";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
