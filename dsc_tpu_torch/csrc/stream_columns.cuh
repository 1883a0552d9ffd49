// The column pass of the streaming four-step kernels: K6, K7
// (fourstep_stream.cu) and K8, K10 (fourstep_stream_t.cu).
//
// A block owns C consecutive columns of one (L, M) matrix of B row-major
// matrices, loads them bit-reversed into shared memory, runs the in-place
// radix-2 FFT of fft_core.cuh over C rows of L points and stores them in
// one of four ways (STORE):
//   kStoreInPlace      back into the columns they came from, scaled by
//                      `scale`, as complex64 or (REAL_OUT) the float32
//                      real part (K7, K10);
//   kStoreRowsTwiddled column m of matrix b as the contiguous L-long row
//                      b*M + m, times the four-step twiddle W_n^(s*k*m)
//                      (K6);
//   kStoreRows         the same row without the twiddle (K8, T layout);
//   kStoreRowsHalf     only values 0..L/2 of each column, as a row of
//                      L/2 + 1 (K8, half-T layout).
// The twiddle comes from two float64-built tables of ~sqrt(n) entries
// (fourier/plan.py Factored; the exponent k*m < n is exact). INV
// conjugates the table values as it reads them: no conjugation pass over
// the data. REAL_IN reads float32 and takes it as the real part (the
// rfft's K6).
//
// Bound on the H100: device memory. A pass over 2^24 complex64 values
// reads 128 MiB and writes 128 MiB (half: 64 MiB) against ~5*n*log2(L)
// flops, about 1.2 flops a byte; the FFT happens in shared memory between
// the read and the write.
//
// Known weaknesses, the first things a faster version looks at:
// - the reads (and the in-place writes) are runs of C complex values at a
//   stride of M: C*L <= 16384 and C <= 16, so the runs are 16 B (L = 8192)
//   to 128 B long;
// - a block of C*L = 16384 points takes 128 KB of shared memory, one block
//   per SM, so the load, the FFT stages and the store do not overlap;
// - the in-place radix-2 stages bank-conflict in shared memory.

#pragma once

#include "fft_core.cuh"

// internal linkage: each source that includes this gets its own copies
// (the top-level anonymous namespace: nvcc's stubs refuse a nested one
// beside the source's own)
namespace {

using namespace dsc;

constexpr int kStoreInPlace = 0;
constexpr int kStoreRowsTwiddled = 1;
constexpr int kStoreRows = 2;
constexpr int kStoreRowsHalf = 3;

constexpr int kColumnThreads = 512;
constexpr int kBlockPoints = 16384;  // C * L <= 16384 (128 KB of complex64)
constexpr int kMaxColumns = 16;      // C <= 16 (128 B runs)
constexpr int kMinBlocks = 512;      // C halves until the grid has this many blocks

// Matrix b at in + b*L*M; block blockIdx.x owns columns m0 .. m0 + C - 1 of
// matrix b. Column c sits at smem + c * (L + 1) (the pad spreads the
// columns over the banks).
template <bool INV, bool REAL_IN, int STORE, bool REAL_OUT>
__global__ void __launch_bounds__(kColumnThreads)
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
  if (STORE == kStoreInPlace) {
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
  } else {
    // column m of matrix b is row b*M + m of the output: neighbouring
    // threads write neighbouring k of one row
    const int width = STORE == kStoreRowsHalf ? L / 2 + 1 : L;
    float2* rows = static_cast<float2*>(out);
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i >> log2L;
      const int k = i & (L - 1);
      if (k >= width) continue;
      const int m = m0 + c;
      float2 v = smem[c * stride + k];
      if (STORE == kStoreRowsTwiddled) {
        float2 t = factored_twiddle(tw_lo, tw_hi, tw_bits, (unsigned)k * (unsigned)m);
        if (INV) t = conj2(t);
        v = cmul(v, t);
      }
      rows[((b << log2M) + m) * width + k] = v;
    }
  }
}

// Above 48 KB a kernel takes dynamic shared memory only once allowed to.
inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <bool INV, bool REAL_IN, int STORE, bool REAL_OUT>
int launch_columns(const void* in, void* out, int batch, int L, int M, const void* w,
                   const void* tw_lo, const void* tw_hi, int tw_bits, float scale,
                   void* stream) {
  int C = kBlockPoints / L;
  if (C > kMaxColumns) C = kMaxColumns;
  if (C > M) C = M;
  while (C > 1 && (long)batch * (M / C) < kMinBlocks) C >>= 1;
  const long blocks = (long)batch * (M / C);
  int threads = C * L / 2;  // one butterfly per thread and stage
  if (threads > kColumnThreads) threads = kColumnThreads;
  const size_t smem = (size_t)C * (L + 1) * sizeof(float2);
  const void* kernel = (const void*)stream_column_kernel<INV, REAL_IN, STORE, REAL_OUT>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  stream_column_kernel<INV, REAL_IN, STORE, REAL_OUT>
      <<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
          in, out, ilog2(L), ilog2(M), ilog2(C), (const float2*)w, (const float2*)tw_lo,
          (const float2*)tw_hi, tw_bits, scale);
  return (int)cudaGetLastError();
}

}  // namespace
