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
// K9 reads rows k1 of S contiguously, rebuilds a half-T row's missing
// columns from its mirror row, runs the inverse DFT_n2 along the row and
// multiplies by the inverse four-step twiddle:
//   Y[k1, j2] = W_n^(-k1*j2) * sum_k2 S[k1, k2] W_n2^(-k2*j2).
// A block owns rows k1 and n1 - k1 (rows 0 and n1/2, each its own mirror,
// share block 0), so each stored value is read once and both its places are
// filled from one read.
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
// Known weaknesses of K9: a block holds two rows, so at n2 = 512 (n = 2^18)
// it moves 8 KB and the grid has n1/2 = 256 blocks, under two a SM; at
// n2 = 8192 the two rows take 128 KB of shared memory, one block per SM.
// The column passes' weaknesses are listed in stream_columns.cuh.

#include "stream_columns.cuh"

using namespace dsc;

namespace {

constexpr int kRowThreads = 512;  // K9: threads a block at most

// Block u < n1/2 owns rows u and n1 - u (block 0: rows 0 and n1/2); slot 0
// holds the first row, slot 1 the second, each at smem + slot * (n2 + 1).
template <bool HALF>
__global__ void __launch_bounds__(kRowThreads)
inv_phase_a_t_kernel(const float2* __restrict__ s, float2* __restrict__ y, int log2n1,
                     int log2n2, const float2* __restrict__ w, const float2* __restrict__ tw_lo,
                     const float2* __restrict__ tw_hi, int tw_bits) {
  extern __shared__ float2 smem[];
  const int n1 = 1 << log2n1;
  const int n2 = 1 << log2n2;
  const int h = n2 / 2;
  const int stride = n2 + 1;
  const int u = blockIdx.x;
  const int row_a = u;
  const int row_b = u == 0 ? n1 / 2 : n1 - u;
  const int width = HALF ? h + 1 : n2;  // stored values a row
  for (int i = threadIdx.x; i < 2 * width; i += blockDim.x) {
    const int slot = i >= width;
    const int k2 = i - slot * width;
    const int row = slot ? row_b : row_a;
    const float2 v = s[(long)row * width + k2];
    smem[slot * stride + bitrev(k2, log2n2)] = v;
    if (HALF) {
      // v is also conj of S[mirror row, mk2] for the mk2 > n2/2 it mirrors
      // to; the mirror row of row 0 and of row n1/2 is the row itself
      const int mslot = u == 0 ? slot : 1 - slot;
      const int mk2 = row == 0 ? n2 - k2 : n2 - 1 - k2;
      if (mk2 > h && mk2 < n2) smem[mslot * stride + bitrev(mk2, log2n2)] = conj2(v);
    }
  }
  __syncthreads();
  fft_rows<true>(smem, 2, stride, log2n2, w);
  // neighbouring threads write neighbouring j2 of one row
  for (int i = threadIdx.x; i < 2 * n2; i += blockDim.x) {
    const int slot = i >> log2n2;
    const int j2 = i & (n2 - 1);
    const int row = slot ? row_b : row_a;
    const float2 t = conj2(factored_twiddle(tw_lo, tw_hi, tw_bits, (unsigned)row * (unsigned)j2));
    y[((long)row << log2n2) + j2] = cmul(smem[slot * stride + j2], t);
  }
}

template <bool HALF>
int launch_inv_phase_a_t(const void* s, void* y, int n1, int n2, const void* w,
                         const void* tw_lo, const void* tw_hi, int tw_bits, void* stream) {
  int threads = n2;  // two rows of n2/2 butterflies a stage
  if (threads > kRowThreads) threads = kRowThreads;
  const size_t smem = (size_t)2 * (n2 + 1) * sizeof(float2);
  const void* kernel = (const void*)inv_phase_a_t_kernel<HALF>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  inv_phase_a_t_kernel<HALF><<<(unsigned)(n1 / 2), threads, smem, (cudaStream_t)stream>>>(
      (const float2*)s, (float2*)y, ilog2(n1), ilog2(n2), (const float2*)w,
      (const float2*)tw_lo, (const float2*)tw_hi, tw_bits);
  return (int)cudaGetLastError();
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

// K9: s (n1, n2), or (n1, n2/2 + 1) with half -> y (n1, n2) complex64;
// w_n2: n2/2 stage twiddles W_n2^p; tw_lo/hi/bits: W_n factored.
int dsc_stream_inv_phase_a_t(const void* s, void* y, int n1, int n2, int half, const void* w_n2,
                             const void* tw_lo, const void* tw_hi, int tw_bits, void* stream) {
  return half ? launch_inv_phase_a_t<true>(s, y, n1, n2, w_n2, tw_lo, tw_hi, tw_bits, stream)
              : launch_inv_phase_a_t<false>(s, y, n1, n2, w_n2, tw_lo, tw_hi, tw_bits, stream);
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
