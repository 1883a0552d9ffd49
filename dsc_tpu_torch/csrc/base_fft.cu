// K12: batched base-case FFT, 256..4096-point complex64 rows.
//
// Replaces dsc_tpu/fourier/pallas_kernels.py:_fft_block_kernel (reached
// through fft_base_planar from core._base_fft_p): the leaf of the four-step
// plan. The TPU kernel runs each row as two DFT-matrix products on the MXU
// over 128-row blocks. Here each block loads whole rows into shared memory
// (bit-reversed), runs the in-place radix-2 FFT of fft_core.cuh and writes
// the rows back.
//
// Bound on the H100: device memory. A batch of B n-point rows moves
// 16*B*n bytes (read + write of complex64) and does 5*n*log2(n) flops per
// row, about 2.5 flops per byte at n = 4096, far under the card's balance
// point. The design keeps the row in shared memory between the one read
// and the one write; blocks take 4096 points (32 KB) of rows each so that
// several blocks share an SM. The strided butterfly stages in shared memory
// bank-conflict; a later PR can pad or move to radix-4.

#include "fft_core.cuh"

using namespace dsc;

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerBlock = 4096;

__global__ void __launch_bounds__(kThreads)
base_fft_kernel(const float2* __restrict__ x, float2* __restrict__ y, int batch,
                int log2n, int rows_per_block, const float2* __restrict__ w) {
  extern __shared__ float2 smem[];
  const int n = 1 << log2n;
  const long row0 = (long)blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, (int)(batch - row0));
  const int total = rows * n;
  const float2* src = x + row0 * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> log2n;
    smem[(r << log2n) + bitrev(i & (n - 1), log2n)] = src[i];
  }
  __syncthreads();
  fft_rows<false>(smem, rows, n, log2n, w);
  float2* dst = y + row0 * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) dst[i] = smem[i];
}

}  // namespace

extern "C" {

const char* dsc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x, y: (batch, n) complex64; w: n/2 stage twiddles W_n^p.
int dsc_base_fft(const void* x, void* y, int batch, int n, const void* w, void* stream) {
  const int log2n = ilog2(n);
  const int rows = n >= kPointsPerBlock ? 1 : kPointsPerBlock / n;
  const int blocks = (batch + rows - 1) / rows;
  const size_t smem = (size_t)rows * n * sizeof(float2);
  base_fft_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (float2*)y, batch, log2n, rows, (const float2*)w);
  return (int)cudaGetLastError();
}

}  // extern "C"
