// The register-resident row pass of the contiguous-row FFT kernels: K12
// (base_fft.cu) and K2 (packed_rfft.cu rfft_phase_b_kernel).
//
// A block owns R rows of one length L, 256 <= L <= 4096 a power of two,
// each contiguous in device memory. T = L/16 threads take a row, 16 values
// a thread: thread t of a row loads values t + u*T (u < 16) straight from
// device memory into registers, so neighbouring threads read neighbouring
// addresses (a warp's access is one 256-byte run, two 128-byte runs at
// L = 256). The passes are fft_radix.cuh's Stockham passes: radix 16,
// radix 16, then, above L = 256, one of radix L/256 (2, 4, 8 or 16). So
// L = 256 takes 16*16, 512..2048 take 16*16*{2,4,8} and 4096 16*16*16,
// with one or two shared-memory exchanges between them, where the
// radix-2 stages of fft_core.cuh took 8-12, each synchronised. After the
// last pass register u of thread t holds value k = t + u*T of the row's
// transform, in natural order: the caller stores from there. The callers
// pass L as a constant (a template argument of the kernel), so that every
// index and shift folds.
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
  switch (log2L - 2 * kLog2Radix) {
    case 1: row_radix_pass<1, INV>(v, t, log2L, 2 * kLog2Radix, w); break;
    case 2: row_radix_pass<2, INV>(v, t, log2L, 2 * kLog2Radix, w); break;
    case 3: row_radix_pass<3, INV>(v, t, log2L, 2 * kLog2Radix, w); break;
    default: row_radix_pass<4, INV>(v, t, log2L, 2 * kLog2Radix, w); break;
  }
}

}  // namespace dsc
