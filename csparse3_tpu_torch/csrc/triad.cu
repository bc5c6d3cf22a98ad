// Streaming triad o = a * s + 0.5 for Hopper (sm_90a): the bandwidth probe.
//
// Replaces the Pallas TPU kernel of probes/_probe_pallas.py: triad (K7,
// pallas_call at :38), which streams a (rows, 512) float32 array through
// 256-row tiles with the scale s in scalar memory.
//
// What bounds it on an H100: device-memory bytes, by construction: two
// operations for every 8 bytes moved (4 read, 4 written).  Timed on an array
// far beyond the 50 MB L2, its bytes per second are the memory rate this card
// reaches at its power limit, which is what the bandwidth-bound SpMV kernels
// are held against beside the published 3.35 TB/s.
//
// What the design does about it: 16-byte loads and stores (float4), a
// grid-stride loop over a grid sized to fill the card (the wrapper gives 16
// CTAs per SM), four independent float4 per thread in flight per trip.  The
// scale is read from device memory once per thread, so a caller can chain
// launches through it without a host round trip, as the TPU probe did through
// SMEM.  The product and the sum are rounded separately (no FMA contraction),
// so the result equals the plain a * s + 0.5 bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float triad1(float a, float s) {
  return __fadd_rn(__fmul_rn(a, s), 0.5f);
}

__device__ __forceinline__ float4 triad4(float4 v, float s) {
  return make_float4(triad1(v.x, s), triad1(v.y, s), triad1(v.z, s),
                     triad1(v.w, s));
}

__global__ void triad_kernel(const float* __restrict__ a,
                             const float* __restrict__ s_ptr,
                             float* __restrict__ o, size_t n) {
  const float s = *s_ptr;
  const size_t n4 = n / 4;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float4* o4 = reinterpret_cast<float4*>(o);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const float4 v0 = a4[i], v1 = a4[i + stride], v2 = a4[i + 2 * stride],
                 v3 = a4[i + 3 * stride];
    o4[i] = triad4(v0, s);
    o4[i + stride] = triad4(v1, s);
    o4[i + 2 * stride] = triad4(v2, s);
    o4[i + 3 * stride] = triad4(v3, s);
  }
  for (; i < n4; i += stride) o4[i] = triad4(a4[i], s);
  // the n % 4 values past the last whole float4
  const size_t t = 4 * n4 + static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
  if (t < n) o[t] = triad1(a[t], s);
}

}  // namespace

extern "C" {

// One launch on `stream` (a cudaStream_t) over n float32 values; a and o must
// be 16-byte aligned.  Returns cudaGetLastError(): 0 when the launch was
// accepted, -1 for arguments the kernel does not take.
int triad(const float* a, const float* s, float* o, long long n, int blocks,
          void* stream) {
  if (n < 0 || blocks < 1 || reinterpret_cast<size_t>(a) % 16 ||
      reinterpret_cast<size_t>(o) % 16)
    return -1;
  if (n == 0) return 0;
  triad_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, s, o, static_cast<size_t>(n));
  return static_cast<int>(cudaGetLastError());
}

const char* triad_error_string(int code) {
  if (code == -1) return "invalid argument to triad";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
