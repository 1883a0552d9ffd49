// The column pass of the four-step kernels: K6, K7 (fourstep_stream.cu),
// K8, K10 (fourstep_stream_t.cu) and the packed real FFT's K1, K4
// (packed_rfft.cu).
//
// A block owns C consecutive columns of one (L, M) matrix of B row-major
// matrices, 256 <= L <= 8192, and transforms each column with the
// register-resident Stockham passes of fft_radix.cuh: T = L/16 threads a
// column, 16 values a thread, passes of radix 16 (the last one of radix
// 2, 4 or 8 where log2(L) is not a multiple of 4), the values crossing
// shared memory once between two passes. It stores them in one of five
// ways (STORE):
//   kStoreInPlace      back into the columns they came from, scaled by
//                      `scale`, as complex64 or (REAL_OUT) the float32
//                      real part (K7, K10; K4, whose complex64 output
//                      read as float32 is the interleaved real signal);
//   kStoreInPlaceTwiddled  back into the columns they came from, value k
//                      of column m times the four-step twiddle
//                      W_n^(s*k*m) (K1: At keeps z's (n1, m2) layout,
//                      which K2 reads row by row);
//   kStoreRowsTwiddled column m of matrix b as the contiguous L-long row
//                      b*M + m, times the four-step twiddle
//                      W_n^(s*k*(col0 + m)) (K6; col0 = 0 but for one
//                      shard's block of a sharded transform, whose column m
//                      is column col0 + m of the whole matrix);
//   kStoreRows         the same row without the twiddle (K8, T layout);
//   kStoreRowsHalf     only values 0..L/2 of each column, as a row of
//                      L/2 + 1 (K8, half-T layout).
// The four-step twiddle comes from two float64-built tables of ~sqrt(n)
// entries (fourier/plan.py Factored; the exponent k*m < n is exact) and
// is applied to the last pass's registers as they are stored; the
// inter-pass twiddles W_L^e come from the float64-built stage table. INV
// conjugates the table values and the butterflies' constants: no
// conjugation pass over the data. REAL_IN reads float32 and takes it as
// the real part (the rfft's K6). BOUNDED (K1 alone) reads complex value i
// as floats 2i and 2i+1 of a float32 signal of `valid` floats, each float
// at or past `valid` as 0 (an odd `valid` leaves one half pair): the
// packed real FFT reads its unpadded input, and no zero padding is ever
// written to device memory. Its load has no branch (a select per value):
// per-value branches around the two loads took K1 at n = 2^24 from 0.110
// to 0.120 ms on an H100 80GB HBM3 at 700 W (PERF.md).
//
// Bound on the H100: device memory. A pass over 2^24 complex64 values
// reads 128 MiB and writes 128 MiB (0.080 ms at 3.35 TB/s) against
// ~5*n*log2(L) flops (0.013 ms at 67 TFLOP/s of float32).
//
// What the design does about it:
// - the first pass reads device memory straight into registers (16
//   independent loads a thread in flight, neighbouring threads on
//   neighbouring columns of a row) and the last pass stores from them, so
//   shared memory carries only the 1-3 exchanges between passes, padded
//   so that every access takes the least wavefronts;
// - the caller's C (fourier/stream.py block_columns) sizes the block (C*L
//   points, C*L/16 threads, C*column_stride(L, C) float2 of shared memory)
//   so that more than one block is resident a SM where it pays: one
//   block's load and store overlap another's passes;
// - the row stores (K6, K8) read the last pass's values with the threads
//   of a column neighbouring (t fastest), so neighbouring threads write
//   neighbouring values of one output row; the first pass and the in-place
//   stores keep neighbouring threads on neighbouring columns.
//
// Known weaknesses, the first things a faster version looks at:
// - the reads (and the in-place writes) are still runs of C complex values
//   at a stride of M: 16 values a thread and at most 1024 threads a block
//   cap C*L at 16384, so at L = 8192 a run is at most 16 bytes (C = 2);
//   an in-place write of runs under a 32-byte sector costs over twice the
//   time, so at L = 4096 the block takes C = 4 and 1024 threads, one block
//   a SM, and its load, passes and store no longer overlap another's;
// - a thread moves 8 bytes an access (16 bytes would take two columns a
//   thread, 64 registers of values);
// - every pass after the first reads R - 1 stage twiddles a thread from
//   the table (L1), where recurrences would trade accuracy for loads.

#pragma once

#include "fft_radix.cuh"

// internal linkage: each source that includes this gets its own copies
// (the top-level anonymous namespace: nvcc's stubs refuse a nested one
// beside the source's own)
namespace {

using namespace dsc;

constexpr int kStoreInPlace = 0;
constexpr int kStoreRowsTwiddled = 1;
constexpr int kStoreRows = 2;
constexpr int kStoreRowsHalf = 3;
constexpr int kStoreInPlaceTwiddled = 4;

__host__ __device__ constexpr bool in_place(int store) {
  return store == kStoreInPlace || store == kStoreInPlaceTwiddled;
}

constexpr int kColumnThreads = 1024;  // C * L / 16 <= 1024; at most 64 registers a thread

template <bool INV>
__device__ __forceinline__ void run_pass(float2 (&v)[kRadix], int log2r, int t, int log2L,
                                         int log2Ns, const float2* __restrict__ w) {
  switch (log2r) {
    case 4: radix_pass<4, INV>(v, t, log2L, log2Ns, w); break;
    case 3: radix_pass<3, INV>(v, t, log2L, log2Ns, w); break;
    case 2: radix_pass<2, INV>(v, t, log2L, log2Ns, w); break;
    default: radix_pass<1, INV>(v, t, log2L, log2Ns, w); break;
  }
}

__device__ __forceinline__ void store_pass(const float2 (&v)[kRadix], int log2r, float2* col,
                                           int t, int log2L, int log2Ns) {
  switch (log2r) {
    case 4: pass_store<4>(v, col, t, log2L, log2Ns); break;
    case 3: pass_store<3>(v, col, t, log2L, log2Ns); break;
    case 2: pass_store<2>(v, col, t, log2L, log2Ns); break;
    default: pass_store<1>(v, col, t, log2L, log2Ns); break;
  }
}

// Matrix b at in + b*L*M; block blockIdx.x owns columns m0 .. m0 + C - 1 of
// matrix b; column c sits at smem + c * cstride between passes. Only the
// BOUNDED instances read `valid`.
template <bool INV, bool REAL_IN, int STORE, bool REAL_OUT, bool BOUNDED>
__global__ void __launch_bounds__(kColumnThreads, 1)
stream_column_kernel(const void* __restrict__ in, void* __restrict__ out, int log2L, int log2M,
                     int log2C, int cstride, const float2* __restrict__ w,
                     const float2* __restrict__ tw_lo, const float2* __restrict__ tw_hi,
                     int tw_bits, float scale, long valid, int col0) {
  extern __shared__ float2 smem[];
  const int log2T = log2L - kLog2Radix;  // threads a column
  const int log2G = log2M - log2C;       // column groups a matrix
  const long b = blockIdx.x >> log2G;
  const int m0 = (blockIdx.x & ((1 << log2G) - 1)) << log2C;
  const long base = b << (log2L + log2M);  // first value of matrix b
  // neighbouring threads take neighbouring columns of one row
  int c = threadIdx.x & ((1 << log2C) - 1);
  int t = threadIdx.x >> log2C;
  float2 v[kRadix];
  const long pairs = valid >> 1;  // BOUNDED: the signal's complete pairs
  const float odd_last =
      BOUNDED && (valid & 1) ? static_cast<const float*>(in)[valid - 1] : 0.f;
#pragma unroll
  for (int u = 0; u < kRadix; ++u) {
    const long src = base + ((long)(t + (u << log2T)) << log2M) + m0 + c;
    if (BOUNDED) {
      // branch-free, so that the 16 loads issue back to back: a place past
      // the last complete pair loads pair 0 (in bounds, cached) and keeps a
      // zero, or the signal's odd last float
      const float2 q = pairs > 0 ? static_cast<const float2*>(in)[src < pairs ? src : 0]
                                 : make_float2(0.f, 0.f);
      v[u] = src < pairs ? q : make_float2(src == pairs ? odd_last : 0.f, 0.f);
    } else {
      v[u] = REAL_IN ? make_float2(static_cast<const float*>(in)[src], 0.f)
                     : static_cast<const float2*>(in)[src];
    }
  }
  int log2Ns = 0;
  for (;;) {
    const int log2r = min(kLog2Radix, log2L - log2Ns);
    run_pass<INV>(v, log2r, t, log2L, log2Ns, w);
    if (log2Ns + log2r == log2L) break;
    store_pass(v, log2r, smem + c * cstride, t, log2L, log2Ns);
    __syncthreads();
    log2Ns += log2r;
    const bool last = log2Ns + min(kLog2Radix, log2L - log2Ns) == log2L;
    if (last && !in_place(STORE)) {
      // the row stores: neighbouring threads take neighbouring values of
      // one column
      c = threadIdx.x >> log2T;
      t = threadIdx.x & ((1 << log2T) - 1);
    }
    const float2* col = smem + c * cstride;
#pragma unroll
    for (int u = 0; u < kRadix; ++u) v[u] = col[pad16(t + (u << log2T))];
    if (!last) __syncthreads();  // the next pass's store overwrites
  }
  // v[u] is value k = t + u*T of the transform of column m0 + c
  if (in_place(STORE)) {
#pragma unroll
    for (int u = 0; u < kRadix; ++u) {
      const int k = t + (u << log2T);
      const long dst = base + ((long)k << log2M) + m0 + c;
      float2 y = cscale(v[u], scale);
      if (STORE == kStoreInPlaceTwiddled) {
        float2 tw = factored_twiddle(tw_lo, tw_hi, tw_bits, (unsigned)k * (unsigned)(m0 + c));
        y = cmul(y, INV ? conj2(tw) : tw);
      }
      if (REAL_OUT) {
        static_cast<float*>(out)[dst] = y.x;
      } else {
        static_cast<float2*>(out)[dst] = y;
      }
    }
  } else {
    const int width = STORE == kStoreRowsHalf ? (1 << (log2L - 1)) + 1 : 1 << log2L;
    const int m = m0 + c;
    float2* row = static_cast<float2*>(out) + ((b << log2M) + m) * width;
#pragma unroll
    for (int u = 0; u < kRadix; ++u) {
      const int k = t + (u << log2T);
      if (STORE == kStoreRowsHalf && k >= width) continue;
      float2 y = v[u];
      if (STORE == kStoreRowsTwiddled) {
        float2 tw = factored_twiddle(tw_lo, tw_hi, tw_bits, (unsigned)k * (unsigned)(col0 + m));
        y = cmul(y, INV ? conj2(tw) : tw);
      }
      row[k] = y;
    }
  }
}

// The pass over `batch` (L, M) matrices with C columns a block: C*L/16
// threads and C*column_stride(L, C) float2 of shared memory a block
// (fourier/stream.py block_columns chooses C). `valid`: the floats of the
// input that a BOUNDED pass reads; `col0`: the global column of column 0
// in the twiddle of kStoreRowsTwiddled (k*(col0 + m) < L*n2 <= 2^32).
template <bool INV, bool REAL_IN, int STORE, bool REAL_OUT, bool BOUNDED = false>
int launch_columns(const void* in, void* out, int batch, int L, int M, int C, const void* w,
                   const void* tw_lo, const void* tw_hi, int tw_bits, float scale,
                   void* stream, long valid = 0, int col0 = 0) {
  const int log2L = ilog2(L), log2M = ilog2(M), log2C = ilog2(C);
  if (L < 256 || L > 8192 || (1 << log2L) != L || (1 << log2M) != M || (1 << log2C) != C ||
      C > M || C * (L / kRadix) > kColumnThreads)
    return (int)cudaErrorInvalidValue;
  const long blocks = (long)batch * (M / C);
  const int cstride = column_stride(L, C);
  const size_t smem = (size_t)C * cstride * sizeof(float2);
  const void* kernel =
      (const void*)stream_column_kernel<INV, REAL_IN, STORE, REAL_OUT, BOUNDED>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  stream_column_kernel<INV, REAL_IN, STORE, REAL_OUT, BOUNDED>
      <<<(unsigned)blocks, C * (L / kRadix), smem, (cudaStream_t)stream>>>(
          in, out, log2L, log2M, log2C, cstride, (const float2*)w, (const float2*)tw_lo,
          (const float2*)tw_hi, tw_bits, scale, valid, col0);
  return (int)cudaGetLastError();
}

}  // namespace
