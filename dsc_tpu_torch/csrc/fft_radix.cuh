// Register-resident radix-2^k FFT building blocks for Hopper: the column
// pass of stream_columns.cuh (K1, K4, K6, K7, K8, K10) and the row pass of
// fft_rows_reg.cuh (K2, K3, K9, K12) are made of them.
//
// A thread holds R = kRadix values of one column in registers. A pass of
// radix r (r | R) runs R/r DFT_r butterflies on them with the internal
// twiddles as constants (no table reads inside a butterfly); the values
// cross shared memory only between passes. The passes are the Stockham
// (self-sorting) decimation in time of
//   Govindaraju et al., "High performance discrete Fourier transforms on
//   graphics processors", SC 2008:
// with Ns = the product of the radices of the earlier passes, butterfly jj
// (0 <= jj < L/r) reads values jj + q*L/r (q < r), multiplies value q by
// W_{Ns*r}^((jj mod Ns)*q), runs DFT_r and writes output q to
//   (jj div Ns)*Ns*r + (jj mod Ns) + q*Ns.
// Thread t of a column owns butterflies jj = t + s*L/R (s < R/r), so in
// every pass it reads, and after the last pass holds, the values
// t + u*L/R (u < R): register u = s + q*R/r. No pass reorders its input,
// so no bit-reversed load remains.
//
// Shared memory holds a column with one float2 of pad after every 16
// values (pad16); the pass's writes, stride r apart in the first pass,
// then land on distinct banks, as do the reads of 16 consecutive t. A
// numpy emulation of the index maps counted two wavefronts (the least for
// 8-byte accesses) for every read and write of every pass at L = 256 ...
// 8192 with the column strides of column_stride() below.

#pragma once

#include "fft_core.cuh"

namespace dsc {

constexpr int kRadix = 16;
constexpr int kLog2Radix = 4;

// shared-memory slot of value o of a column (one pad after every 16)
__device__ __forceinline__ int pad16(int o) { return o + (o >> 4); }

// float2 slots between two columns in shared memory: the padded column
// plus an offset that puts the 16 / C columns of a half warp (C columns a
// block, C < 16) on distinct banks
inline int column_stride(int L, int C) { return L + L / 16 + (C >= 16 ? 1 : 16 / C); }

// Above 48 KB a kernel takes dynamic shared memory only once allowed to.
inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// z * W_16^k, 0 <= k < 8, W = exp(-2 pi i / 16) (INV: its conjugate); k is
// a constant once the callers' loops unroll, so the switch folds away
template <bool INV>
__device__ __forceinline__ float2 rot16(float2 z, int k) {
  constexpr float c1 = 0.92387953251128674f;  // cos(pi/8)
  constexpr float s1 = 0.38268343236508978f;  // sin(pi/8)
  constexpr float h = 0.70710678118654752f;   // sqrt(1/2)
  float c, s;                                 // W_16^k = c - i s
  switch (k) {
    case 0: return z;
    case 4: return INV ? times_i(z) : make_float2(z.y, -z.x);
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 5: c = -s1; s = c1; break;
    case 6: c = -h; s = h; break;
    default: c = -c1; s = s1; break;
  }
  return cmul(z, make_float2(c, INV ? s : -s));
}

__host__ __device__ constexpr int bitrev_const(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

// The radix-2 decimation-in-frequency stages of half span H, H/2, ..., 1
// over v[S + q*G], q < N: a stage of span 2H multiplies a difference by
// W_{2H}^q. Each stage's span is a template argument, so every loop has
// constant bounds and unrolls, and every index is a constant: v[] stays in
// registers (no local array).
template <int N, int H, int S, int G, bool INV>
__device__ __forceinline__ void dif_stages(float2 (&v)[kRadix]) {
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += 2 * H) {
#pragma unroll
    for (int q = 0; q < H; ++q) {
      const float2 x = v[S + (i0 + q) * G], y = v[S + (i0 + q + H) * G];
      v[S + (i0 + q) * G] = cadd(x, y);
      v[S + (i0 + q + H) * G] = rot16<INV>(csub(x, y), q * (8 / H));  // W_{2H}^q
    }
  }
  if constexpr (H > 1) dif_stages<N, H / 2, S, G, INV>(v);
}

// The bit reversal of v[S + q*G], q < N, as swaps of registers, one
// template step per K so that every index is a compile-time constant
template <int N, int S, int G, int K>
__device__ __forceinline__ void bitrev_swaps(float2 (&v)[kRadix]) {
  if constexpr (K < N) {
    constexpr int rk = bitrev_const(K, N == 16 ? 4 : N == 8 ? 3 : N == 4 ? 2 : 1);
    if constexpr (K < rk) {
      const float2 tmp = v[S + K * G];
      v[S + K * G] = v[S + rk * G];
      v[S + rk * G] = tmp;
    }
    bitrev_swaps<N, S, G, K + 1>(v);
  }
}

// In-register DFT_N (N | 16) of v[S + q*G], q < N, natural order in and
// out: radix-2 decimation in frequency with constant twiddles, then the
// bit reversal as swaps of registers.
template <int N, int S, int G, bool INV>
__device__ __forceinline__ void dft_reg(float2 (&v)[kRadix]) {
  dif_stages<N, N / 2, S, G, INV>(v);
  bitrev_swaps<N, S, G, 0>(v);
}

// W_L^e for 0 <= e < L from the stage table w[p] = W_L^p, p < L/2
// (W_L^(e + L/2) = -W_L^e); INV conjugates
template <bool INV>
__device__ __forceinline__ float2 stage_twiddle(const float2* __restrict__ w, int e, int log2L) {
  const int half = 1 << (log2L - 1);
  float2 t = __ldg(w + (e & (half - 1)));
  if (e & half) t = make_float2(-t.x, -t.y);
  return INV ? conj2(t) : t;
}

// One Stockham pass of radix r = 2^LOG2R over the L = 2^log2L values of
// a column, Ns = 2^log2Ns: this thread (index t within its column, T =
// L/16 threads a column) twiddles and transforms its registers in place.
template <int LOG2R, bool INV>
__device__ __forceinline__ void radix_pass(float2 (&v)[kRadix], int t, int log2L, int log2Ns,
                                           const float2* __restrict__ w) {
  constexpr int r = 1 << LOG2R;
  constexpr int g = kRadix / r;  // butterflies a thread
  const int log2T = log2L - kLog2Radix;
  const int shift = log2L - log2Ns - LOG2R;  // W_{Ns*r} = W_L^(2^shift)
#pragma unroll
  for (int s = 0; s < g; ++s) {
    if (log2Ns > 0) {
      const int k = (t + (s << log2T)) & ((1 << log2Ns) - 1);
#pragma unroll
      for (int q = 1; q < r; ++q)
        v[s + q * g] = cmul(v[s + q * g], stage_twiddle<INV>(w, (k * q) << shift, log2L));
    }
  }
  // one dft_reg per butterfly, each with constant register indices
  dft_reg<r, 0, g, INV>(v);
  if constexpr (g >= 2) dft_reg<r, 1, g, INV>(v);
  if constexpr (g >= 4) { dft_reg<r, 2, g, INV>(v); dft_reg<r, 3, g, INV>(v); }
  if constexpr (g >= 8) {
    dft_reg<r, 4, g, INV>(v); dft_reg<r, 5, g, INV>(v);
    dft_reg<r, 6, g, INV>(v); dft_reg<r, 7, g, INV>(v);
  }
}

// Write this thread's outputs of the pass (radix 2^LOG2R, Ns = 2^log2Ns)
// to column `col` of shared memory, at their Stockham places.
template <int LOG2R>
__device__ __forceinline__ void pass_store(const float2 (&v)[kRadix], float2* col, int t,
                                           int log2L, int log2Ns) {
  constexpr int r = 1 << LOG2R;
  constexpr int g = kRadix / r;
  const int log2T = log2L - kLog2Radix;
#pragma unroll
  for (int s = 0; s < g; ++s) {
    const int jj = t + (s << log2T);
    const int o0 = ((jj >> log2Ns) << (log2Ns + LOG2R)) + (jj & ((1 << log2Ns) - 1));
#pragma unroll
    for (int q = 0; q < r; ++q) col[pad16(o0 + (q << log2Ns))] = v[s + q * g];
  }
}

}  // namespace dsc
