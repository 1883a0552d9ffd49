// K8, K9, K10: the streaming four-step FFT of one vector into and out of
// the T layout (fourier/stream_t.py).
//
// Replaces dsc_tpu/fourier/pallas_stream_t.py:
//   K8  _phase_b_t_kernel      -> stream_phase_b_t      (forward, into T / half-T)
//   K9  _inv_phase_a_t_kernel  -> stream_inv_phase_a_t  (inverse row pass)
//   K10 _inv_phase_b_zp_kernel -> stream_inv_phase_b_t  (inverse column pass)
// For n = n1*n2 the T layout stores the spectrum as S[k1, k2] = X[k1 + n1*k2],
// row-major (n1, n2); the half-T layout of a real input's spectrum keeps
// columns 0..n2/2, (n1, n2/2 + 1), the rest being the conjugate mirror
//   S[k1, k2] = conj S[n1 - k1, n2 - 1 - k2]   (k1 >= 1)
//   S[0,  k2] = conj S[0, n2 - k2].
//
// K8 follows K6 (fourstep_stream.cu), whose Z[j2, k1] is the twiddled
// column DFT: it is the column pass of stream_columns.cuh over Z as an
// (L = n2, M = n1) matrix, storing column k1 as the contiguous row k1 of S
// (or its first n2/2 + 1 values).
// K9 runs the inverse DFT_n2 along each row k1 of S, a half-T row rebuilt
// from its mirror row first, and multiplies by the inverse four-step twiddle
// as it stores:
//   Y[k1, j2] = W_n^(-k1*j2) * sum_k2 S[k1, k2] W_n2^(-k2*j2).
// It is the register-resident row pass of fft_rows_reg.cuh, T = n2/16
// threads a row, n2 a template argument (512 ... 8192). In the T layout a
// block owns R independent rows (R from the caller, fourier/stream_t.py
// block_rows); thread t loads S[k1, t + u*T] straight into registers and
// stores Y[k1, t + u*T], a warp a 256-byte run each way, and the store's
// 16 twiddles are products of three table lookups (row_store_twiddled). In
// the half-T layout block u owns rows u and n1 - u, each the other's
// mirror (block 0: rows 0 and n1/2, each its own), so each stored value is
// read from device memory once: both rows' n2/2 + 1 values go to shared
// memory, and each thread gathers its 16 values from its row or, conjugated,
// from the mirror row.
// K10 is the in-place column pass over Y as an (L = n1, M = n2) matrix,
// inverse, scaled by 1/n:
//   x[n2*j1 + j2] = (1/n) * sum_k1 Y[k1, j2] W_n1^(-k1*j1),
// complex64 or, for the irfft, the float32 real part.
// The TPU kernels' 129-row mirror windows, exchange-matrix flips, host-side
// k1 = 0 row, pad rows, 128-lane padding and tile-blocked intermediate are
// Mosaic workarounds and have no counterpart: Y is a plain row-major
// (n1, n2) array.
//
// Bound on the H100: device memory. At 2^24 points each kernel reads and
// writes 128 MiB of complex64 (the half-T side 64 MiB; K10's float32 output
// 64 MiB) against ~5*n*log2(n2) flops.
//
// Known weaknesses of K9: the half-T block holds one row pair, 2*n2/16
// threads (64 at n2 = 512, the only half-T split the routing gives it);
// a thread moves 8 bytes an access. The column passes' weaknesses are
// listed in stream_columns.cuh.

#include "fft_rows_reg.cuh"
#include "stream_columns.cuh"

using namespace dsc;

namespace {

constexpr int kRowThreads = 1024;  // K9: R*n2/16 (half-T: 2*n2/16) <= 1024

// K9, n2 = 2^LOG2N2, T = n2/16 threads a row, the row's padded_row(n2)
// float2 of shared memory at smem + r*padded_row(n2) for the block's row r.
// T layout: block b owns rows bR ... bR + R - 1. Half-T: block b < n1/2
// owns row b (r = 0) and its mirror row n1 - b (r = 1; block 0: n1/2).
template <int LOG2N2, bool HALF>
__global__ void __launch_bounds__(kRowThreads, 1)
inv_phase_a_t_kernel(const float2* __restrict__ s, float2* __restrict__ y, int n1,
                     int rows_per_block, const float2* __restrict__ w,
                     const float2* __restrict__ tw_lo, const float2* __restrict__ tw_hi,
                     int tw_bits) {
  extern __shared__ float2 smem[];
  constexpr int log2n2 = LOG2N2;
  constexpr int log2T = log2n2 - kLog2Radix;
  constexpr int stride = padded_row(1 << log2n2);
  const int r = threadIdx.x >> log2T;
  const int t = threadIdx.x & ((1 << log2T) - 1);
  float2* mine = smem + r * stride;
  float2 v[kRadix];
  int row;
  if constexpr (HALF) {
    constexpr int h = 1 << (log2n2 - 1);
    const int b = blockIdx.x;
    row = r ? (b == 0 ? n1 / 2 : n1 - b) : b;
    // the row's h + 1 stored values, neighbouring threads on neighbouring
    // values
    const float2* src = s + (long)row * (h + 1);
    for (int k2 = t; k2 <= h; k2 += 1 << log2T) mine[pad16(k2)] = src[k2];
    __syncthreads();
    // S[row, k2 > n2/2] = conj S[n1 - row, n2 - 1 - k2], and for row 0
    // conj S[0, n2 - k2]; rows 0 and n1/2 are their own mirrors
    const float2* mirror = smem + (b == 0 ? r : 1 - r) * stride;
    const int flip = row == 0 ? 2 * h : 2 * h - 1;
#pragma unroll
    for (int u = 0; u < kRadix; ++u) {
      const int k2 = t + (u << log2T);
      if (k2 <= h) {
        v[u] = mine[pad16(k2)];
      } else {
        v[u] = conj2(mirror[pad16(flip - k2)]);
      }
    }
    __syncthreads();  // the exchanges overwrite the mirror row's slot
  } else {
    row = blockIdx.x * rows_per_block + r;
    const float2* src = s + ((long)row << log2n2);
#pragma unroll
    for (int u = 0; u < kRadix; ++u) v[u] = src[t + (u << log2T)];
  }
  row_fft<true>(v, mine, t, log2n2, w);
  row_store_twiddled(v, y + ((long)row << log2n2), t, log2T, tw_lo, tw_hi, tw_bits,
                     (unsigned)row * (unsigned)t, (unsigned)row << log2T);
}

template <int LOG2N2, bool HALF>
int launch_inv_phase_a_t(const void* s, void* y, int n1, int rows, const void* w,
                         const void* tw_lo, const void* tw_hi, int tw_bits, void* stream) {
  const int slots = HALF ? 2 : rows;
  const size_t smem = (size_t)slots * padded_row(1 << LOG2N2) * sizeof(float2);
  const void* kernel = (const void*)inv_phase_a_t_kernel<LOG2N2, HALF>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  inv_phase_a_t_kernel<LOG2N2, HALF>
      <<<(unsigned)(HALF ? n1 / 2 : n1 / rows), slots << (LOG2N2 - kLog2Radix), smem,
         (cudaStream_t)stream>>>((const float2*)s, (float2*)y, n1, rows, (const float2*)w,
                                 (const float2*)tw_lo, (const float2*)tw_hi, tw_bits);
  return (int)cudaGetLastError();
}

template <bool HALF>
int dispatch_inv_phase_a_t(const void* s, void* y, int n1, int log2n2, int rows, const void* w,
                         const void* tw_lo, const void* tw_hi, int tw_bits, void* stream) {
  switch (log2n2) {
    case 9: return launch_inv_phase_a_t<9, HALF>(s, y, n1, rows, w, tw_lo, tw_hi, tw_bits, stream);
    case 10: return launch_inv_phase_a_t<10, HALF>(s, y, n1, rows, w, tw_lo, tw_hi, tw_bits, stream);
    case 11: return launch_inv_phase_a_t<11, HALF>(s, y, n1, rows, w, tw_lo, tw_hi, tw_bits, stream);
    case 12: return launch_inv_phase_a_t<12, HALF>(s, y, n1, rows, w, tw_lo, tw_hi, tw_bits, stream);
    default: return launch_inv_phase_a_t<13, HALF>(s, y, n1, rows, w, tw_lo, tw_hi, tw_bits, stream);
  }
}

}  // namespace

extern "C" {

// K8: z (n2, n1) complex64 from K6 -> s (n1, n2), or (n1, n2/2 + 1) with
// half; w_n2: n2/2 stage twiddles W_n2^p; columns: C, the columns a
// block. Forward, unscaled.
int dsc_stream_phase_b_t(const void* z, void* s, int n1, int n2, int half, const void* w_n2,
                         int columns, void* stream) {
  return half ? launch_columns<false, false, kStoreRowsHalf, false>(
                    z, s, 1, n2, n1, columns, w_n2, nullptr, nullptr, 0, 1.f, stream)
              : launch_columns<false, false, kStoreRows, false>(
                    z, s, 1, n2, n1, columns, w_n2, nullptr, nullptr, 0, 1.f, stream);
}

// K9: s (n1, n2), or (n1, n2/2 + 1) with half -> y (n1, n2) complex64,
// 512 <= n2 <= 8192; w_n2: n2/2 stage twiddles W_n2^p; tw_lo/hi/bits: W_n
// factored; rows: R, the rows a block of the T layout (R*n2/16 threads; a
// half-T block holds one row pair, and rows is not read).
int dsc_stream_inv_phase_a_t(const void* s, void* y, int n1, int n2, int half, const void* w_n2,
                             const void* tw_lo, const void* tw_hi, int tw_bits, int rows,
                             void* stream) {
  const int log2n2 = ilog2(n2);
  if (n2 < 512 || n2 > 8192 || (1 << log2n2) != n2 || n1 < 2 || n1 % 2 ||
      (!half && (rows < 1 || n1 % rows || rows * (n2 / kRadix) > kRowThreads)))
    return (int)cudaErrorInvalidValue;
  return half ? dispatch_inv_phase_a_t<true>(s, y, n1, log2n2, rows, w_n2, tw_lo, tw_hi,
                                             tw_bits, stream)
              : dispatch_inv_phase_a_t<false>(s, y, n1, log2n2, rows, w_n2, tw_lo, tw_hi,
                                              tw_bits, stream);
}

// K10: y (n1, n2) complex64 -> out (n1*n2,), complex64 or the float32 real
// part (real_output), times scale; w_n1: n1/2 stage twiddles W_n1^p;
// columns: C, the columns a block.
int dsc_stream_inv_phase_b_t(const void* y, void* out, int n1, int n2, int real_output,
                             const void* w_n1, float scale, int columns, void* stream) {
  return real_output ? launch_columns<true, false, kStoreInPlace, true>(
                           y, out, 1, n1, n2, columns, w_n1, nullptr, nullptr, 0, scale, stream)
                     : launch_columns<true, false, kStoreInPlace, false>(
                           y, out, 1, n1, n2, columns, w_n1, nullptr, nullptr, 0, scale, stream);
}

}  // extern "C"
