// The register-resident row pass of the contiguous-row FFT kernels: K12
// (base_fft.cu), K2 and K3 (packed_rfft.cu rfft_phase_b_kernel,
// irfft_phase_a_kernel) and K9 (fourstep_stream_t.cu inv_phase_a_t_kernel).
//
// A block owns rows of one length L, 256 <= L <= 8192 a power of two.
// T = L/16 threads take a row, 16 values a thread: thread t of a row holds
// values t + u*T (u < 16) in registers, loaded by the caller (K12, K9 straight
// from device memory, so that neighbouring threads read neighbouring
// addresses: a warp's access is one 256-byte run, two 128-byte runs at
// L = 256; K2, K3 and K9's half-T rows from shared memory). The passes are
// fft_radix.cuh's Stockham passes: radix 16, radix 16, then, above L = 256,
// one of radix L/256 (2, 4, 8 or 16), and at L = 8192 radix 16 and radix 2.
// So L = 256 takes 16*16, 512..2048 take 16*16*{2,4,8}, 4096 16*16*16 and
// 8192 16*16*16*2, with one to three shared-memory exchanges between them.
// After the last pass register u of thread t holds value k = t + u*T of the
// row's transform, in natural order: the caller stores from there. The
// callers pass L as a constant (a template argument of the kernel), so that
// every index and shift folds, and the L = 8192 branch folds away in the
// kernels of shorter rows.
//
// The inter-pass twiddles differ from fft_radix.cuh's radix_pass: a
// butterfly reads W^e and W^(4e) from the stage table and forms the other
// W^(qe) as their products (twiddle_butterfly). radix_pass reads all 15,
// each read a gather of up to 32 distinct entries a warp; with the
// products K12 at 4096 x 1000 took 0.029 ms in place of 0.044 on an H100
// 80GB HBM3 at 700 W (PERF.md).
//
// Shared memory: a row takes padded_row(L) float2, one pad after every 16
// values (pad16). A half warp never spans two rows (T >= 16), and within a
// row the first pass's writes land 17 slots apart and every other access
// is 16 neighbouring values, so each takes the least wavefronts (two for a
// warp's 8-byte accesses); tests/test_torch_row_pass.py emulates the index
// maps in numpy and counts them.

#pragma once

#include "fft_radix.cuh"

namespace dsc {

// float2 slots of one row in shared memory (pad16 of L)
__host__ __device__ constexpr int padded_row(int L) { return L + L / 16; }

// v[s + q*G] *= W_L^(e*q), 0 < q < R: W^e and (R > 4) W^(4e) from the
// stage table, the other factors as products of those, so that a butterfly
// reads two table entries where radix_pass reads R - 1 (each a warp-wide
// gather of up to 16 cache lines); a factor is within four roundings of
// the table's value.
template <int R, int G, bool INV>
__device__ __forceinline__ void twiddle_butterfly(float2 (&v)[kRadix], int s,
                                                  const float2* __restrict__ w, int e,
                                                  int log2L) {
  const float2 w1 = stage_twiddle<INV>(w, e, log2L);
  v[s + G] = cmul(v[s + G], w1);
  if constexpr (R > 2) {
    const float2 w2 = cmul(w1, w1);
    const float2 w3 = cmul(w2, w1);
    v[s + 2 * G] = cmul(v[s + 2 * G], w2);
    v[s + 3 * G] = cmul(v[s + 3 * G], w3);
    if constexpr (R > 4) {
      const float2 w4 = stage_twiddle<INV>(w, 4 * e, log2L);
      float2 m = w4;  // W^(4a e)
#pragma unroll
      for (int a = 1; a < R / 4; ++a) {
        if (a > 1) m = cmul(m, w4);
        v[s + 4 * a * G] = cmul(v[s + 4 * a * G], m);
        v[s + (4 * a + 1) * G] = cmul(v[s + (4 * a + 1) * G], cmul(m, w1));
        v[s + (4 * a + 2) * G] = cmul(v[s + (4 * a + 2) * G], cmul(m, w2));
        v[s + (4 * a + 3) * G] = cmul(v[s + (4 * a + 3) * G], cmul(m, w3));
      }
    }
  }
}

// radix_pass with the inter-pass twiddles of twiddle_butterfly
template <int LOG2R, bool INV>
__device__ __forceinline__ void row_radix_pass(float2 (&v)[kRadix], int t, int log2L,
                                               int log2Ns, const float2* __restrict__ w) {
  constexpr int r = 1 << LOG2R;
  constexpr int g = kRadix / r;  // butterflies a thread
  const int log2T = log2L - kLog2Radix;
  const int shift = log2L - log2Ns - LOG2R;  // W_{Ns*r} = W_L^(2^shift)
#pragma unroll
  for (int s = 0; s < g; ++s) {
    const int k = (t + (s << log2T)) & ((1 << log2Ns) - 1);
    twiddle_butterfly<r, g, INV>(v, s, w, k << shift, log2L);
  }
  radix_pass<LOG2R, INV>(v, t, log2L, 0, w);  // at Ns = 1: the butterflies alone
}

// Store this thread's radix-16 pass outputs at their Stockham places in the
// row's shared memory, synchronise, and read the values t + u*T the next
// pass takes.
__device__ __forceinline__ void row_exchange(float2 (&v)[kRadix], float2* row, int t,
                                             int log2L, int log2Ns) {
  pass_store<kLog2Radix>(v, row, t, log2L, log2Ns);
  __syncthreads();
  const int log2T = log2L - kLog2Radix;
#pragma unroll
  for (int u = 0; u < kRadix; ++u) v[u] = row[pad16(t + (u << log2T))];
}

// The DFT of a row of L = 2^log2L points with the stage table w (L/2
// entries W_L^p): thread t of the row holds value t + u*T in v[u] on entry
// and value k = t + u*T of the transform on return; `row` is the row's
// padded_row(L) float2 of shared memory. Every thread of the block calls it
// with the same L (it synchronises the block), and the caller synchronises
// before it next writes `row`. INV conjugates the table and the
// butterflies' constants (unscaled inverse).
template <bool INV>
__device__ __forceinline__ void row_fft(float2 (&v)[kRadix], float2* row, int t, int log2L,
                                        const float2* __restrict__ w) {
  radix_pass<kLog2Radix, INV>(v, t, log2L, 0, w);
  row_exchange(v, row, t, log2L, 0);
  row_radix_pass<kLog2Radix, INV>(v, t, log2L, kLog2Radix, w);
  if (log2L == 2 * kLog2Radix) return;
  __syncthreads();  // every thread has read the first exchange
  row_exchange(v, row, t, log2L, kLog2Radix);
  if (log2L == 3 * kLog2Radix + 1) {  // L = 8192: 16*16*16*2
    row_radix_pass<kLog2Radix, INV>(v, t, log2L, 2 * kLog2Radix, w);
    __syncthreads();  // every thread has read the second exchange
    row_exchange(v, row, t, log2L, 2 * kLog2Radix);
    row_radix_pass<1, INV>(v, t, log2L, 3 * kLog2Radix, w);
    return;
  }
  switch (log2L - 2 * kLog2Radix) {
    case 1: row_radix_pass<1, INV>(v, t, log2L, 2 * kLog2Radix, w); break;
    case 2: row_radix_pass<2, INV>(v, t, log2L, 2 * kLog2Radix, w); break;
    case 3: row_radix_pass<3, INV>(v, t, log2L, 2 * kLog2Radix, w); break;
    default: row_radix_pass<4, INV>(v, t, log2L, 2 * kLog2Radix, w); break;
  }
}

// dst[t + u*T] = v[u] * conj W^(e0 + u*d), u < 16, T = 2^log2T: the inverse
// four-step twiddle of K3 and K9 applied as the row is stored (256-byte
// runs a warp). W comes from a factored table (lo, hi, bits; fourier/plan.py
// Factored, exponents below its period), three lookups a thread: W^e0, W^d
// and W^(4d), and W^(e0 + (a + 4c)d) = W^e0 * (W^d)^a * (W^(4d))^c, a, c < 4.
// A power carries its step's rounding times the exponent, so no step is
// raised above the third power. From W^e0 and W^d alone (powers up to the
// 15th) K9 read 1.0-1.24e-6 from its plain version on an H100 80GB HBM3 at
// 700 W, over its bound of 1e-6, and with the factored lookup of every
// value (the plain version's own factor) took 7-37% more time; this form
// holds 4.3e-7 at the speed of the first (PERF.md).
__device__ __forceinline__ void row_store_twiddled(const float2 (&v)[kRadix],
                                                   float2* __restrict__ dst, int t, int log2T,
                                                   const float2* __restrict__ lo,
                                                   const float2* __restrict__ hi, int bits,
                                                   unsigned e0, unsigned d) {
  const float2 base = factored_twiddle(lo, hi, bits, e0);
  const float2 s1 = factored_twiddle(lo, hi, bits, d);
  const float2 s4 = factored_twiddle(lo, hi, bits, 4u * d);
  const float2 s2 = cmul(s1, s1);
  const float2 b1 = cmul(base, s1);
  const float2 q[4] = {base, b1, cmul(base, s2), cmul(b1, s2)};  // W^(e0 + a d)
  float2 m = s4;                                                 // W^(4 c d)
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c == 2) m = cmul(s4, s4);
    if (c == 3) m = cmul(m, s4);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int u = a + 4 * c;
      const float2 f = c == 0 ? q[a] : cmul(q[a], m);
      dst[t + (u << log2T)] = cmul(v[u], conj2(f));
    }
  }
}

}  // namespace dsc
