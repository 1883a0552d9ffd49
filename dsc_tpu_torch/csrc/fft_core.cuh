// Shared device code of the FFT kernels: complex float2 arithmetic, the
// factored twiddle lookup, and an in-shared-memory power-of-two FFT
// (fft_rows: K3 and K9 only; the column pass of K1, K4, K6, K7, K8, K10 and
// the row pass of K2 and K12 run the register-resident passes of
// fft_radix.cuh instead).
//
// The FFT is radix-2, decimation in time, IN PLACE: rows are loaded in
// bit-reversed order (the loaders scatter with bitrev()), then log2(n)
// stages of butterflies each read and write the same two slots, so one
// buffer of n complex values per row is all the shared memory a row takes
// (a 4096-point row is 32 KB). An out-of-place Stockham pass would need a
// second buffer and so halve the rows a block can hold; the plain PyTorch
// versions of the kernels use Stockham (fourier/core.py), and the two
// agree to float32 rounding.
//
// Twiddles come from float64-built tables in device memory: the stage
// table w[p] = W_n^p, p < n/2, read through the read-only cache.

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

// j reversed in log2n bits
__device__ __forceinline__ int bitrev(int j, int log2n) {
  return log2n == 0 ? 0 : (int)(__brev((unsigned)j) >> (32 - log2n));
}

// W^e = hi[e >> bits] * lo[e & (2^bits - 1)] (fourier/plan.py Factored)
__device__ __forceinline__ float2 factored_twiddle(const float2* __restrict__ lo,
                                                   const float2* __restrict__ hi,
                                                   int bits, unsigned e) {
  return cmul(__ldg(hi + (e >> bits)), __ldg(lo + (e & ((1u << bits) - 1u))));
}

// DFT of `rows` rows of n = 2^log2n points, row r at buf + r * stride, held
// in bit-reversed order; the result is in natural order. INV conjugates
// the twiddles (unscaled inverse). All threads of the block call it; the
// caller synchronises before (the load) and it synchronises after each
// stage.
template <bool INV>
__device__ void fft_rows(float2* buf, int rows, int stride, int log2n,
                         const float2* __restrict__ w) {
  if (log2n == 0) return;
  const int half = 1 << (log2n - 1);  // butterflies per row and stage
  const int total = rows * half;
  for (int s = 0; s < log2n; ++s) {
    const int h = 1 << s;                  // half the butterfly span
    const int wstep = half >> s;           // W_{2h}^q = W_n^(q * n / 2h)
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int r = t >> (log2n - 1);
      const int b = t & (half - 1);
      const int q = b & (h - 1);
      const int i0 = r * stride + ((b >> s) << (s + 1)) + q;
      float2 wq = __ldg(w + q * wstep);
      if (INV) wq = conj2(wq);
      const float2 u = buf[i0];
      const float2 v = cmul(buf[i0 + h], wq);
      buf[i0] = cadd(u, v);
      buf[i0 + h] = csub(u, v);
    }
    __syncthreads();
  }
}

inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace dsc
