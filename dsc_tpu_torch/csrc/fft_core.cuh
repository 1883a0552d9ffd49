// Shared device code of the FFT kernels: complex float2 arithmetic, the
// factored twiddle lookup of the four-step and untangle twiddles (tables of
// ~sqrt(n) entries each, fourier/plan.py Factored) and ilog2. The FFT passes
// themselves are fft_radix.cuh's (the column pass of stream_columns.cuh)
// and fft_rows_reg.cuh's (the row pass).

#pragma once

#include <cuda_runtime.h>

namespace dsc {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj2(float2 a) { return make_float2(a.x, -a.y); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// i * a
__device__ __forceinline__ float2 times_i(float2 a) { return make_float2(-a.y, a.x); }

// W^e = hi[e >> bits] * lo[e & (2^bits - 1)] (fourier/plan.py Factored)
__device__ __forceinline__ float2 factored_twiddle(const float2* __restrict__ lo,
                                                   const float2* __restrict__ hi,
                                                   int bits, unsigned e) {
  return cmul(__ldg(hi + (e >> bits)), __ldg(lo + (e & ((1u << bits) - 1u))));
}

inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace dsc
