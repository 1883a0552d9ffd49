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
//
// K12s: the whole forward STFT of float32 signals in one launch, K12r with
// the framing in its load and the STFT's output in its store. It replaces no
// TPU kernel: the JAX package frames, windows and takes the power as XLA
// ops around its batched rfft (dsc_tpu/models/stft.py). The plain version
// (fourier/base_fft.py stft_plain) writes the windowed frames out at
// frame/hop times the signal's size, runs K12r on them and turns the complex
// spectrum into power and log power in three more passes. Row r of the
// launch is frame i = r % n_frames of signal row b = r / n_frames; its
// sample j < n = 2*nh is x[b*row_stride + start + i*hop + j] * window[j], and
// zero where j >= frame or the index falls outside [0, valid) of the row.
// Thread t loads z[k] = s[2k] + i*s[2k+1] for its k = t + u*T as K12r does.
// Where frame, hop, start, row_stride, valid and the signal's address are
// even (PAIRS), a pair lies in or out of the row and the frame whole: the
// thread reads its pairs u with lo <= u < hi, the range inside both, as one
// float2 of the signal and one of the window at constant offsets; else it
// reads and tests every sample alone. The R frames of a block overlap by
// frame - hop samples, so the repeats come from L1 and L2 and the signal
// crosses device memory about once. Then K12r's row pass and untangle
// (untangle_store), and the store of X[k] as complex64, of |X[k]|^2 as
// float32 (power) or of logf(|X[k]|^2 + eps) (log). The products and sums
// are rounded one at a time (__fmul_rn, __fadd_rn), as the plain passes
// round them, and logf is the full-precision log torch.log takes in float32.
// At 64 registers a thread, three instantiations (nh = 1024 complex and
// power, nh = 4096 complex, PAIRS) spill 4 bytes (ptxas -v); the
// benchmark's (nh = 512 log and complex, PAIRS) do not.

#include <cstdint>
#include <type_traits>

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

// The untangle and store of K12r and K12s: thread t of a row holds Z[k], k =
// t + u*T, of the row's nh-point transform in v[u]; after a barrier Z goes
// to the row's shared memory `zrow`, and after another thread t forms X[k] =
// (Z[k] + conj Z[nh-k])/2 - i*wu[k]*(Z[k] - conj Z[nh-k])/2, Z[nh] = Z[0],
// for its k and thread 0 also for k = nh, and hands each to store(k, X). A
// dead row (`live` false) stores nothing. Every thread of the block calls
// it. Z[k] sits at slot k, unpadded: a half warp writes 16 neighbouring
// slots and reads the 16 neighbouring mirrors nh-k, which pad16 would put
// two to a bank (a run of 16 that starts one past a multiple of 16).
template <int LOG2NH, class Store>
__device__ __forceinline__ void untangle_store(const float2 (&v)[kRadix], float2* zrow, int t,
                                               bool live, const float2* __restrict__ wu,
                                               Store store) {
  constexpr int nh = 1 << LOG2NH;
  constexpr int log2T = LOG2NH - kLog2Radix;  // threads a row
  __syncthreads();  // every thread has read the row pass's last exchange
#pragma unroll
  for (int u = 0; u < kRadix; ++u) zrow[t + (u << log2T)] = v[u];
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int u = 0; u < kRadix; ++u) {
    const int k = t + (u << log2T);
    const float2 a = v[u];
    const float2 bc = conj2(zrow[(nh - k) & (nh - 1)]);  // conj Z[(nh - k) mod nh]
    const float2 e = cscale(cadd(a, bc), 0.5f);
    const float2 d = cmul(__ldg(wu + k), cscale(csub(a, bc), 0.5f));
    store(k, csub(e, times_i(d)));  // X[k] = E - i*W^k*D
  }
  if (t == 0) {  // X[nh], from Z[nh] = Z[0]
    const float2 a = v[0];
    const float2 bc = conj2(a);
    const float2 e = cscale(cadd(a, bc), 0.5f);
    const float2 d = cmul(__ldg(wu + nh), cscale(csub(a, bc), 0.5f));
    store(nh, csub(e, times_i(d)));
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
  float2* dst = y + row * (nh + 1);
  untangle_store<LOG2NH>(v, zrow, t, live, wu, [dst](int k, float2 X) { dst[k] = X; });
}

// K12s's modes: what the store writes of X[k]
enum StftMode { kStftComplex = 0, kStftPower = 1, kStftLog = 2 };

// K12s: x float32 signal rows (b*row_stride + sample); y (batch, nh + 1)
// complex64 (kStftComplex) or float32; window `frame` floats, 8-byte
// aligned; w, wu as K12r's. Row `row` of the launch is frame row % n_frames
// of signal row row / n_frames. PAIRS: frame, hop, start, row_stride, valid
// and x's address are even, so that a sample pair (2k, 2k + 1) lies in or
// out of the frame and the signal together and is one float2; else every
// sample is read and tested alone. nh = 2^LOG2NH.
template <int LOG2NH, int MODE, bool PAIRS>
__global__ void __launch_bounds__(kThreads, 1)
base_stft_kernel(const float* __restrict__ x, void* __restrict__ y, int batch,
                 int rows_per_block, int n_frames, long row_stride, long start, long valid,
                 int hop, int frame, const float* __restrict__ window,
                 const float2* __restrict__ w, const float2* __restrict__ wu, float eps) {
  extern __shared__ float2 smem[];
  constexpr int log2n = LOG2NH;
  constexpr int nh = 1 << log2n;
  constexpr int log2T = log2n - kLog2Radix;  // threads a row
  const int r = threadIdx.x >> log2T;
  const int t = threadIdx.x & ((1 << log2T) - 1);
  const int row = blockIdx.x * rows_per_block + r;
  const bool live = row < batch;  // the rest of a ragged last block runs on zeros
  float2 v[kRadix];
  {
    const int b = row / n_frames;
    const long p0 = start + (long)(row - b * n_frames) * hop;  // the frame's sample 0 in its row
    const float* src = x + b * row_stride;
    if constexpr (PAIRS) {
      // pair u of the thread is samples q + 2uT and q + 2uT + 1 of the row:
      // inside the row and the frame for lo <= u < hi, read at a constant
      // offset from the thread's first pair
      const long q = p0 + 2 * t;
      constexpr int log2step = log2T + 1;  // 2T samples from pair u to u + 1
      constexpr long round = (1L << log2step) - 1;
      const long before = q >= 0 ? 0 : (round - q) >> log2step;  // pairs before the row
      const long left = valid - q < frame - 2 * t ? valid - q : frame - 2 * t;  // samples from q
      const long upto = left <= 0 ? 0 : (left + round) >> log2step;  // pairs to the end
      const int lo = before < kRadix ? (int)before : kRadix;
      const int hi = !live ? 0 : upto < kRadix ? (int)upto : kRadix;
      const float2* s2 = reinterpret_cast<const float2*>(src + q);
      const float2* h2 = reinterpret_cast<const float2*>(window) + t;
#pragma unroll
      for (int u = 0; u < kRadix; ++u) {
        const bool in = u >= lo && u < hi;
        const float2 s = in ? __ldg(s2 + (u << log2T)) : make_float2(0.f, 0.f);
        const float2 h = in ? __ldg(h2 + (u << log2T)) : make_float2(0.f, 0.f);
        v[u] = make_float2(__fmul_rn(s.x, h.x), __fmul_rn(s.y, h.y));
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRadix; ++u) {
        const int j = 2 * (t + (u << log2T));
        const long p = p0 + j;
        const bool in0 = live && j < frame && p >= 0 && p < valid;
        const bool in1 = live && j + 1 < frame && p + 1 >= 0 && p + 1 < valid;
        v[u] = make_float2(in0 ? __fmul_rn(__ldg(src + p), __ldg(window + j)) : 0.f,
                           in1 ? __fmul_rn(__ldg(src + p + 1), __ldg(window + j + 1)) : 0.f);
      }
    }
  }
  float2* zrow = smem + r * padded_row(nh);
  row_fft<false>(v, zrow, t, log2n, w);
  using Out = std::conditional_t<MODE == kStftComplex, float2, float>;
  Out* dst = static_cast<Out*>(y) + (long)row * (nh + 1);
  untangle_store<LOG2NH>(v, zrow, t, live, wu, [dst, eps](int k, float2 X) {
    if constexpr (MODE == kStftComplex) {
      dst[k] = X;
    } else {
      float p = __fadd_rn(__fmul_rn(X.x, X.x), __fmul_rn(X.y, X.y));
      if constexpr (MODE == kStftLog) p = logf(__fadd_rn(p, eps));
      dst[k] = p;
    }
  });
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

// a K12s launch's arguments, as dsc_base_stft takes them
struct StftArgs {
  const void* x;
  void* y;
  int batch, n_frames;
  long row_stride, start, valid;
  int hop, frame;
  const void *window, *w, *wu;
  float eps;
  int rows;
  void* stream;
};

template <int LOG2NH, int MODE, bool PAIRS>
int launch_base_stft(const StftArgs& a) {
  const long blocks = ((long)a.batch + a.rows - 1) / a.rows;
  const size_t smem = (size_t)a.rows * padded_row(1 << LOG2NH) * sizeof(float2);
  int err = set_smem((const void*)base_stft_kernel<LOG2NH, MODE, PAIRS>, smem);
  if (err) return err;
  base_stft_kernel<LOG2NH, MODE, PAIRS><<<(unsigned)blocks, a.rows << (LOG2NH - kLog2Radix),
                                          smem, (cudaStream_t)a.stream>>>(
      (const float*)a.x, a.y, a.batch, a.rows, a.n_frames, a.row_stride, a.start, a.valid, a.hop,
      a.frame, (const float*)a.window, (const float2*)a.w, (const float2*)a.wu, a.eps);
  return (int)cudaGetLastError();
}

template <int LOG2NH, int MODE>
int launch_base_stft_pairs(bool pairs, const StftArgs& a) {
  return pairs ? launch_base_stft<LOG2NH, MODE, true>(a) : launch_base_stft<LOG2NH, MODE, false>(a);
}

template <int LOG2NH>
int launch_base_stft_mode(int mode, bool pairs, const StftArgs& a) {
  switch (mode) {
    case kStftComplex: return launch_base_stft_pairs<LOG2NH, kStftComplex>(pairs, a);
    case kStftPower: return launch_base_stft_pairs<LOG2NH, kStftPower>(pairs, a);
    default: return launch_base_stft_pairs<LOG2NH, kStftLog>(pairs, a);
  }
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

// x: float32 signal rows at x + b*row_stride, `valid` samples each, 4-byte
// aligned; y: (batch, nh + 1) complex64 (mode 0) or float32 (power 1, log
// 2), batch = signal rows * n_frames; frame i of a row starts at sample
// start + i*hop (start may be negative); window: `frame` float32, 8-byte
// aligned, frame <= 2*nh; w, wu as dsc_base_rfft's; `rows` rows a block
// (R*nh/16 threads).
int dsc_base_stft(const void* x, void* y, int batch, int n_frames, long long row_stride,
                  long long start, long long valid, int hop, int frame, int nh,
                  const void* window, const void* w, const void* wu, int mode, float eps,
                  int rows, void* stream) {
  const int log2nh = ilog2(nh);
  if (nh < 256 || nh > 4096 || (1 << log2nh) != nh || rows < 1 || batch < 1 ||
      rows * (nh / kRadix) > kThreads || n_frames < 1 || hop < 1 || frame < 1 ||
      frame > 2 * nh || valid < 0 || mode < kStftComplex || mode > kStftLog)
    return (int)cudaErrorInvalidValue;
  const bool pairs = !(((uintptr_t)x & 7) | (row_stride & 1) | (start & 1) | (valid & 1) |
                       (hop & 1) | (frame & 1));
  const StftArgs a{x, y, batch, n_frames, row_stride, start, valid, hop, frame, window, w, wu,
                   eps, rows, stream};
  switch (log2nh) {
    case 8: return launch_base_stft_mode<8>(mode, pairs, a);
    case 9: return launch_base_stft_mode<9>(mode, pairs, a);
    case 10: return launch_base_stft_mode<10>(mode, pairs, a);
    case 11: return launch_base_stft_mode<11>(mode, pairs, a);
    default: return launch_base_stft_mode<12>(mode, pairs, a);
  }
}

}  // extern "C"
