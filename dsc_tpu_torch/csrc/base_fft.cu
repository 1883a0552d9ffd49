// K12: batched base-case FFT, 256..4096-point complex64 rows.
//
// Replaces dsc_tpu/fourier/pallas_kernels.py:_fft_block_kernel (reached
// through fft_base_planar from core._base_fft_p): the leaf of the four-step
// plan. The TPU kernel runs each row as two DFT-matrix products on the MXU
// over 128-row blocks. Here a block owns R whole rows and runs each through
// the register-resident row pass of fft_rows_reg.cuh: loaded from device
// memory into registers, radix-16 Stockham passes, stored from registers
// in natural order.
//
// Bound on the H100: device memory. A batch of B n-point rows moves
// 16*B*n bytes (read + write of complex64) and does 5*n*log2(n) flops per
// row, about 3.75 flops per byte at n = 4096, far under the card's balance
// point. What the design does about it:
// - each value crosses device memory once each way, as 256-byte runs a
//   warp (value k of row r is y[r*n + k], thread t of a row storing
//   k = t + u*n/16), and shared memory carries only the one or two padded
//   exchanges between passes;
// - R comes from the caller (fourier/base_fft.py block_rows, the table
//   ROWS timed by chip_smoke.py --profile): R*n/16 threads, R*padded_row(n)
//   float2 of shared memory, so that small blocks leave several resident a
//   SM, one block's load and store overlapping another's passes.
//
// Known weaknesses: a thread moves 8 bytes an access; 64 registers a thread
// (all of them at 1024 threads) leave at most 1024 threads resident a SM; a
// ragged last block runs its missing rows on zeros.

#include "fft_rows_reg.cuh"

using namespace dsc;

namespace {

constexpr int kThreads = 1024;  // R * n / 16 <= 1024; at most 64 registers a thread

// n = 2^LOG2N: a constant, so that every index and shift of the passes folds
template <int LOG2N>
__global__ void __launch_bounds__(kThreads, 1)
base_fft_kernel(const float2* __restrict__ x, float2* __restrict__ y, long batch,
                int rows_per_block, const float2* __restrict__ w) {
  extern __shared__ float2 smem[];
  constexpr int log2n = LOG2N;
  constexpr int log2T = log2n - kLog2Radix;  // threads a row
  const int r = threadIdx.x >> log2T;
  const int t = threadIdx.x & ((1 << log2T) - 1);
  const long row = (long)blockIdx.x * rows_per_block + r;
  const bool live = row < batch;  // the rest of a ragged last block runs on zeros
  const long base = row << log2n;
  float2 v[kRadix];
#pragma unroll
  for (int u = 0; u < kRadix; ++u)
    v[u] = live ? x[base + t + (u << log2T)] : make_float2(0.f, 0.f);
  row_fft<false>(v, smem + r * padded_row(1 << log2n), t, log2n, w);
  if (live) {
#pragma unroll
    for (int u = 0; u < kRadix; ++u) y[base + t + (u << log2T)] = v[u];
  }
}

template <int LOG2N>
int launch_base_fft(const void* x, void* y, int batch, int rows, const void* w, void* stream) {
  const long blocks = ((long)batch + rows - 1) / rows;
  const size_t smem = (size_t)rows * padded_row(1 << LOG2N) * sizeof(float2);
  int err = set_smem((const void*)base_fft_kernel<LOG2N>, smem);
  if (err) return err;
  base_fft_kernel<LOG2N><<<(unsigned)blocks, rows << (LOG2N - kLog2Radix), smem,
                           (cudaStream_t)stream>>>((const float2*)x, (float2*)y, batch, rows,
                                                   (const float2*)w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dsc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x, y: (batch, n) complex64; w: n/2 stage twiddles W_n^p; `rows` rows a
// block (R*n/16 threads).
int dsc_base_fft(const void* x, void* y, int batch, int n, const void* w, int rows,
                 void* stream) {
  const int log2n = ilog2(n);
  if (n < 256 || n > 4096 || (1 << log2n) != n || rows < 1 || batch < 1 ||
      rows * (n / kRadix) > kThreads)
    return (int)cudaErrorInvalidValue;
  switch (log2n) {
    case 8: return launch_base_fft<8>(x, y, batch, rows, w, stream);
    case 9: return launch_base_fft<9>(x, y, batch, rows, w, stream);
    case 10: return launch_base_fft<10>(x, y, batch, rows, w, stream);
    case 11: return launch_base_fft<11>(x, y, batch, rows, w, stream);
    default: return launch_base_fft<12>(x, y, batch, rows, w, stream);
  }
}

}  // extern "C"
