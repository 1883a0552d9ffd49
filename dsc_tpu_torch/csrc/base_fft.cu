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
//
// K12r: the batched real FFT of float32 rows of n = 2*nh points, nh a K12
// size. It replaces no TPU kernel: the JAX package's batched rfft runs the
// base kernel on the packed rows and lets XLA fuse the untangle
// (dsc_tpu/fourier/core.py); the plain version (fourier/core.py untangle)
// takes six or seven passes over the half-size spectrum. K12r runs
// K12's row pass on z[t] = x[2t] + i*x[2t+1] (a float2 load of x is z) and
// untangles as it stores, as K2 does on the packed single-vector route
// (packed_rfft.cu): the row's Z goes to its shared-memory row, and after a
// barrier thread t forms X[k] = (Z[k] + conj Z[nh-k])/2
// - i*wu[k]*(Z[k] - conj Z[nh-k])/2, Z[nh] = Z[0], for its k = t + u*T and
// thread 0 also for k = nh, and stores the (B, nh+1) complex64 spectrum
// once. It moves 8*B*nh bytes in and 8*B*(nh+1) out: each value crosses
// device memory once each way, as in K12.
//
// K12ir: the mirror of K12r, the batched inverse real FFT of (B, nh + 1)
// complex64 half spectra to float32 rows of n = 2*nh points. The plain
// version (fourier/core.py irfft_batched) entangles the spectrum, conjugates
// it, runs the forward half-size transform, conjugates and divides by nh: six
// or seven ATen passes over the half-size rows around K12. K12ir stages each
// row's nh + 1 bins in its shared-memory row (coalesced loads, each value
// read from device memory once), and after a barrier thread t forms, for its
// k = t + u*T, Z[k] = (X[k] + conj X[nh-k])/2 + i*conj(wu[k])*(X[k] -
// conj X[nh-k])/2 (core.entangle, k = 0 pairing X[0] with X[nh]); then
// K12's unscaled inverse row pass (row_fft<true>: no conjugation passes) and
// the store of z[t]/nh as the float2 x[2t], x[2t+1] of the output row. It
// moves 8*B*(nh+1) bytes in and 8*B*nh out, as K12r does.

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

// K12r: x (batch, 2*nh) float32 read as (batch, nh) float2 rows z; y (batch,
// nh + 1) complex64; w the nh-point stage table, wu the untangle table W_n^k,
// k = 0..nh (fourier/plan.py _rfft_untangle). nh = 2^LOG2NH.
template <int LOG2NH>
__global__ void __launch_bounds__(kThreads, 1)
base_rfft_kernel(const float2* __restrict__ x, float2* __restrict__ y, long batch,
                 int rows_per_block, const float2* __restrict__ w,
                 const float2* __restrict__ wu) {
  extern __shared__ float2 smem[];
  constexpr int log2n = LOG2NH;
  constexpr int nh = 1 << log2n;
  constexpr int log2T = log2n - kLog2Radix;  // threads a row
  const int r = threadIdx.x >> log2T;
  const int t = threadIdx.x & ((1 << log2T) - 1);
  const long row = (long)blockIdx.x * rows_per_block + r;
  const bool live = row < batch;  // the rest of a ragged last block runs on zeros
  float2 v[kRadix];
  {
    const long base = row << log2n;
#pragma unroll
    for (int u = 0; u < kRadix; ++u)
      v[u] = live ? x[base + t + (u << log2T)] : make_float2(0.f, 0.f);
  }
  float2* zrow = smem + r * padded_row(nh);
  row_fft<false>(v, zrow, t, log2n, w);
  // Z[k] at slot k, unpadded: a half warp writes 16 neighbouring slots and
  // reads the 16 neighbouring mirrors nh-k, which pad16 would put two to a
  // bank (a run of 16 that starts one past a multiple of 16)
  __syncthreads();  // every thread has read the last exchange
#pragma unroll
  for (int u = 0; u < kRadix; ++u) zrow[t + (u << log2T)] = v[u];
  __syncthreads();
  if (!live) return;
  float2* dst = y + row * (nh + 1);
#pragma unroll
  for (int u = 0; u < kRadix; ++u) {
    const int k = t + (u << log2T);
    const float2 a = v[u];
    const float2 bc = conj2(zrow[(nh - k) & (nh - 1)]);  // conj Z[(nh - k) mod nh]
    const float2 e = cscale(cadd(a, bc), 0.5f);
    const float2 d = cmul(__ldg(wu + k), cscale(csub(a, bc), 0.5f));
    dst[k] = csub(e, times_i(d));  // X[k] = E - i*W^k*D
  }
  if (t == 0) {  // X[nh], from Z[nh] = Z[0]
    const float2 a = v[0];
    const float2 bc = conj2(a);
    const float2 e = cscale(cadd(a, bc), 0.5f);
    const float2 d = cmul(__ldg(wu + nh), cscale(csub(a, bc), 0.5f));
    dst[nh] = csub(e, times_i(d));
  }
}

// K12ir: x (batch, nh + 1) complex64; y (batch, 2*nh) float32 written as
// (batch, nh) float2 rows; w the nh-point stage table (conjugated by the
// inverse row pass), wu the untangle table W_n^k, read at k < nh. nh =
// 2^LOG2NH.
template <int LOG2NH>
__global__ void __launch_bounds__(kThreads, 1)
base_irfft_kernel(const float2* __restrict__ x, float2* __restrict__ y, long batch,
                  int rows_per_block, const float2* __restrict__ w,
                  const float2* __restrict__ wu) {
  extern __shared__ float2 smem[];
  constexpr int log2n = LOG2NH;
  constexpr int nh = 1 << log2n;
  constexpr int log2T = log2n - kLog2Radix;  // threads a row
  const int r = threadIdx.x >> log2T;
  const int t = threadIdx.x & ((1 << log2T) - 1);
  const long row = (long)blockIdx.x * rows_per_block + r;
  const bool live = row < batch;  // the rest of a ragged last block runs on zeros
  float2* xrow = smem + r * padded_row(nh);
  float2 v[kRadix];
  {
    // X[k] at slot k, unpadded, X[nh] at slot nh: a half warp writes 16
    // neighbouring slots and reads the 16 neighbouring mirrors nh-k, which
    // pad16 would put two to a bank, as in K12r's store
    const float2* src = x + row * (nh + 1);
#pragma unroll
    for (int u = 0; u < kRadix; ++u) {
      const int k = t + (u << log2T);
      v[u] = live ? src[k] : make_float2(0.f, 0.f);
      xrow[k] = v[u];
    }
    if (t == 0) xrow[nh] = live ? src[nh] : make_float2(0.f, 0.f);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kRadix; ++u) {
    const int k = t + (u << log2T);
    const float2 a = v[u];
    const float2 bc = conj2(xrow[nh - k]);  // conj X[nh - k]
    const float2 e = cscale(cadd(a, bc), 0.5f);
    const float2 d = cmul(conj2(__ldg(wu + k)), cscale(csub(a, bc), 0.5f));
    v[u] = cadd(e, times_i(d));  // Z[k] = E + i*conj(W^k)*D
  }
  __syncthreads();  // every thread has read its mirrors before the pass writes the row
  row_fft<true>(v, xrow, t, log2n, w);
  if (!live) return;
  float2* dst = y + (row << log2n);
  constexpr float scale = 1.0f / nh;
#pragma unroll
  for (int u = 0; u < kRadix; ++u) dst[t + (u << log2T)] = cscale(v[u], scale);
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

template <int LOG2NH>
int launch_base_rfft(const void* x, void* y, int batch, int rows, const void* w, const void* wu,
                     void* stream) {
  const long blocks = ((long)batch + rows - 1) / rows;
  const size_t smem = (size_t)rows * padded_row(1 << LOG2NH) * sizeof(float2);
  int err = set_smem((const void*)base_rfft_kernel<LOG2NH>, smem);
  if (err) return err;
  base_rfft_kernel<LOG2NH><<<(unsigned)blocks, rows << (LOG2NH - kLog2Radix), smem,
                             (cudaStream_t)stream>>>((const float2*)x, (float2*)y, batch, rows,
                                                     (const float2*)w, (const float2*)wu);
  return (int)cudaGetLastError();
}

template <int LOG2NH>
int launch_base_irfft(const void* x, void* y, int batch, int rows, const void* w, const void* wu,
                      void* stream) {
  const long blocks = ((long)batch + rows - 1) / rows;
  const size_t smem = (size_t)rows * padded_row(1 << LOG2NH) * sizeof(float2);
  int err = set_smem((const void*)base_irfft_kernel<LOG2NH>, smem);
  if (err) return err;
  base_irfft_kernel<LOG2NH><<<(unsigned)blocks, rows << (LOG2NH - kLog2Radix), smem,
                              (cudaStream_t)stream>>>((const float2*)x, (float2*)y, batch, rows,
                                                      (const float2*)w, (const float2*)wu);
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

// x: (batch, 2*nh) float32, 8-byte aligned; y: (batch, nh + 1) complex64; w:
// nh/2 stage twiddles W_nh^p; wu: nh + 1 untangle twiddles W_(2nh)^k; `rows`
// rows a block (R*nh/16 threads).
int dsc_base_rfft(const void* x, void* y, int batch, int nh, const void* w, const void* wu,
                  int rows, void* stream) {
  const int log2nh = ilog2(nh);
  if (nh < 256 || nh > 4096 || (1 << log2nh) != nh || rows < 1 || batch < 1 ||
      rows * (nh / kRadix) > kThreads)
    return (int)cudaErrorInvalidValue;
  switch (log2nh) {
    case 8: return launch_base_rfft<8>(x, y, batch, rows, w, wu, stream);
    case 9: return launch_base_rfft<9>(x, y, batch, rows, w, wu, stream);
    case 10: return launch_base_rfft<10>(x, y, batch, rows, w, wu, stream);
    case 11: return launch_base_rfft<11>(x, y, batch, rows, w, wu, stream);
    default: return launch_base_rfft<12>(x, y, batch, rows, w, wu, stream);
  }
}

// x: (batch, nh + 1) complex64, 8-byte aligned; y: (batch, 2*nh) float32;
// w: nh/2 stage twiddles W_nh^p; wu: nh + 1 untangle twiddles W_(2nh)^k;
// `rows` rows a block (R*nh/16 threads).
int dsc_base_irfft(const void* x, void* y, int batch, int nh, const void* w, const void* wu,
                   int rows, void* stream) {
  const int log2nh = ilog2(nh);
  if (nh < 256 || nh > 4096 || (1 << log2nh) != nh || rows < 1 || batch < 1 ||
      rows * (nh / kRadix) > kThreads)
    return (int)cudaErrorInvalidValue;
  switch (log2nh) {
    case 8: return launch_base_irfft<8>(x, y, batch, rows, w, wu, stream);
    case 9: return launch_base_irfft<9>(x, y, batch, rows, w, wu, stream);
    case 10: return launch_base_irfft<10>(x, y, batch, rows, w, wu, stream);
    case 11: return launch_base_irfft<11>(x, y, batch, rows, w, wu, stream);
    default: return launch_base_irfft<12>(x, y, batch, rows, w, wu, stream);
  }
}

}  // extern "C"
