// K6, K7: the natural streaming four-step FFT (fourier/stream.py).
//
// Replaces dsc_tpu/fourier/pallas_stream.py:
//   K6 _phase_a_kernel -> stream_phase_a  (column DFT_n1 + twiddle + transpose)
//   K7 _phase_b_kernel -> stream_phase_b  (column DFT_n2 of Z, natural output)
// An n-point FFT of each of B rows, n = n1*n2, s = -1 forward, +1 inverse:
//   Z[b*n2 + j2, k1] = W_n^(s*k1*j2) * sum_j1 x[b, n2*j1 + j2] W_n1^(s*j1*k1)
//   X[b*n2 + k2, k1] = scale * sum_j2 Z[b*n2 + j2, k1] W_n2^(s*j2*k2)
// and X[b*n2 + k2, k1] is X[b, k1 + n1*k2], the natural order. Both passes
// are one kernel: a block owns C consecutive columns of one (L, M) matrix
// (phase A: L = n1, M = n2 over x; phase B: L = n2, M = n1 over Z), loads
// them bit-reversed into shared memory, runs the in-place radix-2 FFT of
// fft_core.cuh over C rows of L points and stores. Phase A multiplies by
// the four-step twiddle (two float64-built tables of ~sqrt(n) entries,
// fourier/plan.py Factored; the exponent k1*j2 < n is exact) and writes
// each column as one contiguous L-long row of Z; phase B writes the
// columns back in place, scaled by 1/n on the inverse, as complex64 or,
// for the irfft tail, as the float32 real part. The inverse conjugates the
// table values as it reads them: no conjugation pass over the data. Phase A
// reads float32 directly in the real-input variant (the rfft). The TPU
// kernels' bf16x3 DFT-matrix products, 128-lane slabs, batch grouping and
// double-buffered DMA pipeline have no counterpart here.
//
// Bound on the H100: device memory. At 2^24 complex64 values a pass reads
// 128 MiB and writes 128 MiB against ~5*n*log2(L) flops, about 1.2 flops a
// byte. Each pass reads and writes every value once; the FFT happens in
// shared memory between the two.
//
// Known weaknesses, the first things a faster version looks at:
// - the reads (both passes) and phase B's writes are runs of C complex
//   values at a stride of M: C*L <= 16384 and C <= 16, so the runs are
//   16 B (n1 = 8192) to 128 B long;
// - a block of C*L = 16384 points takes 128 KB of shared memory, one block
//   per SM, so the load, the FFT stages and the store do not overlap;
// - the in-place radix-2 stages bank-conflict in shared memory.

#include "fft_core.cuh"

using namespace dsc;

namespace {

constexpr int kThreads = 512;
constexpr int kBlockPoints = 16384;  // C * L <= 16384 (128 KB of complex64)
constexpr int kMaxColumns = 16;      // C <= 16 (128 B runs)
constexpr int kMinBlocks = 512;      // C halves until the grid has this many blocks

// B matrices of (L, M) values, matrix b at in + b*L*M, row-major; block
// blockIdx.x owns columns m0 .. m0 + C - 1 of matrix b. Column c sits at
// smem + c * (L + 1) (the pad spreads the columns over the banks).
template <bool INV, bool REAL_IN, bool PHASE_A, bool REAL_OUT>
__global__ void __launch_bounds__(kThreads)
stream_column_kernel(const void* __restrict__ in, void* __restrict__ out, int log2L, int log2M,
                     int log2C, const float2* __restrict__ w, const float2* __restrict__ tw_lo,
                     const float2* __restrict__ tw_hi, int tw_bits, float scale) {
  extern __shared__ float2 smem[];
  const int L = 1 << log2L;
  const int C = 1 << log2C;
  const int stride = L + 1;
  const int groups = 1 << (log2M - log2C);  // column groups per matrix
  const long b = blockIdx.x >> (log2M - log2C);
  const int m0 = (blockIdx.x & (groups - 1)) << log2C;
  const long base = b << (log2L + log2M);    // first value of matrix b
  const int total = L << log2C;
  // neighbouring threads take neighbouring columns of one row j
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i & (C - 1);
    const int j = i >> log2C;
    const long src = base + ((long)j << log2M) + m0 + c;
    const float2 v = REAL_IN ? make_float2(static_cast<const float*>(in)[src], 0.f)
                             : static_cast<const float2*>(in)[src];
    smem[c * stride + bitrev(j, log2L)] = v;
  }
  __syncthreads();
  fft_rows<INV>(smem, C, stride, log2L, w);
  if (PHASE_A) {
    // column m of matrix b is row b*M + m of Z: neighbouring threads write
    // neighbouring k of one row
    float2* z = static_cast<float2*>(out);
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i >> log2L;
      const int k = i & (L - 1);
      const int m = m0 + c;
      float2 t = factored_twiddle(tw_lo, tw_hi, tw_bits, (unsigned)k * (unsigned)m);
      if (INV) t = conj2(t);
      z[((base >> log2L) + m) * L + k] = cmul(smem[c * stride + k], t);
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i & (C - 1);
      const int k = i >> log2C;
      const float2 v = cscale(smem[c * stride + k], scale);
      const long dst = base + ((long)k << log2M) + m0 + c;
      if (REAL_OUT) {
        static_cast<float*>(out)[dst] = v.x;
      } else {
        static_cast<float2*>(out)[dst] = v;
      }
    }
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <bool INV, bool REAL_IN, bool PHASE_A, bool REAL_OUT>
int launch_columns(const void* in, void* out, int batch, int L, int M, const void* w,
                   const void* tw_lo, const void* tw_hi, int tw_bits, float scale,
                   void* stream) {
  int C = kBlockPoints / L;
  if (C > kMaxColumns) C = kMaxColumns;
  if (C > M) C = M;
  while (C > 1 && (long)batch * (M / C) < kMinBlocks) C >>= 1;
  const long blocks = (long)batch * (M / C);
  int threads = C * L / 2;  // one butterfly per thread and stage
  if (threads > kThreads) threads = kThreads;
  const size_t smem = (size_t)C * (L + 1) * sizeof(float2);
  const void* kernel = (const void*)stream_column_kernel<INV, REAL_IN, PHASE_A, REAL_OUT>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  stream_column_kernel<INV, REAL_IN, PHASE_A, REAL_OUT>
      <<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
          in, out, ilog2(L), ilog2(M), ilog2(C), (const float2*)w, (const float2*)tw_lo,
          (const float2*)tw_hi, tw_bits, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (batch, n1*n2) float32 (real_input) or complex64 -> z (batch*n2, n1)
// complex64; w_n1: n1/2 stage twiddles W_n1^p; tw_lo/hi/bits: W_n factored
int dsc_stream_phase_a(const void* x, void* z, int batch, int n1, int n2, int real_input,
                       int inverse, const void* w_n1, const void* tw_lo, const void* tw_hi,
                       int tw_bits, void* stream) {
  if (inverse) {
    return real_input ? launch_columns<true, true, true, false>(
                            x, z, batch, n1, n2, w_n1, tw_lo, tw_hi, tw_bits, 1.f, stream)
                      : launch_columns<true, false, true, false>(
                            x, z, batch, n1, n2, w_n1, tw_lo, tw_hi, tw_bits, 1.f, stream);
  }
  return real_input ? launch_columns<false, true, true, false>(
                          x, z, batch, n1, n2, w_n1, tw_lo, tw_hi, tw_bits, 1.f, stream)
                    : launch_columns<false, false, true, false>(
                          x, z, batch, n1, n2, w_n1, tw_lo, tw_hi, tw_bits, 1.f, stream);
}

// z (batch*n2, n1) complex64 -> out (batch, n1*n2), complex64 or the
// float32 real part (real_output); w_n2: n2/2 stage twiddles W_n2^p
int dsc_stream_phase_b(const void* z, void* out, int batch, int n1, int n2, int inverse,
                       int real_output, const void* w_n2, float scale, void* stream) {
  if (inverse) {
    return real_output ? launch_columns<true, false, false, true>(
                             z, out, batch, n2, n1, w_n2, nullptr, nullptr, 0, scale, stream)
                       : launch_columns<true, false, false, false>(
                             z, out, batch, n2, n1, w_n2, nullptr, nullptr, 0, scale, stream);
  }
  return real_output ? launch_columns<false, false, false, true>(
                           z, out, batch, n2, n1, w_n2, nullptr, nullptr, 0, scale, stream)
                     : launch_columns<false, false, false, false>(
                           z, out, batch, n2, n1, w_n2, nullptr, nullptr, 0, scale, stream);
}

}  // extern "C"
