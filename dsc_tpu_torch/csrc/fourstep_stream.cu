// K6, K7: the natural streaming four-step FFT (fourier/stream.py).
//
// Replaces dsc_tpu/fourier/pallas_stream.py:
//   K6 _phase_a_kernel -> stream_phase_a  (column DFT_n1 + twiddle + transpose)
//   K7 _phase_b_kernel -> stream_phase_b  (column DFT_n2 of Z, natural output)
// (The sharded four-step's per-shard sites of the two kernels, K6 local
// and K7 local, have a column pass of their own: stream_local.cu.)
// An n-point FFT of each of B rows, n = n1*n2, s = -1 forward, +1 inverse:
//   Z[b*n2 + j2, k1] = W_n^(s*k1*j2) * sum_j1 x[b, n2*j1 + j2] W_n1^(s*j1*k1)
//   X[b*n2 + k2, k1] = scale * sum_j2 Z[b*n2 + j2, k1] W_n2^(s*j2*k2)
// and X[b*n2 + k2, k1] is X[b, k1 + n1*k2], the natural order. Both passes
// are the column pass of stream_columns.cuh (phase A: L = n1, M = n2 over
// x; phase B: L = n2, M = n1 over Z): a block owns C consecutive columns,
// holds 16 values of a column in each thread's registers and transforms
// them in 2-4 register-resident radix-16 Stockham passes (fft_radix.cuh).
// Phase A multiplies the last pass's registers by the four-step twiddle
// (two float64-built tables of ~sqrt(n) entries, fourier/plan.py Factored;
// the exponent k1*j2 < n is exact) and writes each column as one
// contiguous L-long row of Z; phase B writes the columns back in place,
// scaled by 1/n on the inverse, as complex64 or, for the irfft tail, as
// the float32 real part. The inverse conjugates the table values and the
// butterflies' constants: no conjugation pass over the data. Phase A reads
// float32 directly in the real-input variant (the rfft). The TPU kernels'
// bf16x3 DFT-matrix products, 128-lane slabs, batch grouping and
// double-buffered DMA pipeline have no counterpart here.
//
// Bound on the H100: device memory, as for every column pass (2^24
// complex64 values in and out: 0.080 ms at 3.35 TB/s, against 0.013 ms of
// float32 arithmetic). What the design does about it, and what is still
// weak after it (the runs of C values at a stride of M, 8-byte accesses),
// is in stream_columns.cuh, shared with K8 and K10 (fourstep_stream_t.cu)
// and the packed real FFT's K1 and K4 (packed_rfft.cu).
// The block size C comes from the caller (fourier/stream.py
// block_columns).

#include "stream_columns.cuh"

using namespace dsc;

extern "C" {

// x: (batch, n1*n2) float32 (real_input) or complex64 -> z (batch*n2, n1)
// complex64; w_n1: n1/2 stage twiddles W_n1^p; tw_lo/hi/bits: W_n factored;
// columns: C, the columns a block
int dsc_stream_phase_a(const void* x, void* z, int batch, int n1, int n2, int real_input,
                       int inverse, const void* w_n1, const void* tw_lo, const void* tw_hi,
                       int tw_bits, int columns, void* stream) {
  if (inverse) {
    return real_input ? launch_columns<true, true, kStoreRowsTwiddled, false>(
                            x, z, batch, n1, n2, columns, w_n1, tw_lo, tw_hi, tw_bits, 1.f, stream)
                      : launch_columns<true, false, kStoreRowsTwiddled, false>(
                            x, z, batch, n1, n2, columns, w_n1, tw_lo, tw_hi, tw_bits, 1.f, stream);
  }
  return real_input ? launch_columns<false, true, kStoreRowsTwiddled, false>(
                          x, z, batch, n1, n2, columns, w_n1, tw_lo, tw_hi, tw_bits, 1.f, stream)
                    : launch_columns<false, false, kStoreRowsTwiddled, false>(
                          x, z, batch, n1, n2, columns, w_n1, tw_lo, tw_hi, tw_bits, 1.f, stream);
}

// z (batch*n2, n1) complex64 -> out (batch, n1*n2), complex64 or the
// float32 real part (real_output); w_n2: n2/2 stage twiddles W_n2^p;
// columns: C, the columns a block
int dsc_stream_phase_b(const void* z, void* out, int batch, int n1, int n2, int inverse,
                       int real_output, const void* w_n2, float scale, int columns,
                       void* stream) {
  if (inverse) {
    return real_output ? launch_columns<true, false, kStoreInPlace, true>(
                             z, out, batch, n2, n1, columns, w_n2, nullptr, nullptr, 0, scale, stream)
                       : launch_columns<true, false, kStoreInPlace, false>(
                             z, out, batch, n2, n1, columns, w_n2, nullptr, nullptr, 0, scale, stream);
  }
  return real_output ? launch_columns<false, false, kStoreInPlace, true>(
                           z, out, batch, n2, n1, columns, w_n2, nullptr, nullptr, 0, scale, stream)
                     : launch_columns<false, false, kStoreInPlace, false>(
                           z, out, batch, n2, n1, columns, w_n2, nullptr, nullptr, 0, scale, stream);
}

}  // extern "C"
