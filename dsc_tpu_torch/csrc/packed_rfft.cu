// K1-K4: the packed half-size real FFT (fourier/packed_fused.py).
//
// Replaces dsc_tpu/fourier/packed_fused.py:
//   K1 _phase_a_packed_kernel        -> rfft_phase_a   (column pass)
//   K2 _phase_b_t_packed_kernel      -> rfft_phase_b   (row pass + untangle)
//   K3 _inv_phase_a_t_packed_kernel  -> irfft_phase_a  (entangle + row pass)
//   K4 _inv_phase_b_zp_packed_kernel -> irfft_phase_b  (column pass)
// An n-point real FFT is one nh = n/2-point complex FFT of
// z[t] = x[2t] + i*x[2t+1], four-step over z viewed as (n1, m2), m2 = n2/2,
// plus the hermitian untangle (packed_fused.py has the formulas). A float2
// load of x IS z, so the TPU kernel's even/odd selection matmul has no
// counterpart, and its bf16x3 DFT-matrix products become float32
// butterflies in registers: K1 and K4 are the column pass of
// stream_columns.cuh (batch 1, L = n1, M = m2, C columns a block from the
// caller, fourier/stream.py block_columns), and K2 and K3 run their row
// DFTs on the row pass of fft_rows_reg.cuh. K1 stores At in place with the
// four-step twiddle and
// reads the signal unpadded: floats past its end count as zeros (the
// filterFFT's zero padding is never written); K4 is the inverse in-place
// pass scaled by 1/nh, whose complex64 output read as float32 is the real
// signal. The four-step twiddle W_nh^(k1*j2) and the untangle twiddle
// W_n^k are as large as the data; each comes from two float64-built
// tables of ~sqrt entries (fourier/plan.py Factored).
//
// Bound on the H100: device memory. At n = 2^24 a forward reads 64 MiB of x,
// writes and reads the 64 MiB intermediate and writes the 64 MiB spectrum
// (256 MiB), against ~5*nh*log2(nh) = 1 GFLOP: about 4 flops per byte.
// Each pass therefore reads and writes every element once, and all the
// work of a pass happens on chip between the two.
//
// Layout costs, the first things a faster version looks at:
// - the column passes (K1, K4) read and write runs of C consecutive
//   complex values at a stride of m2: 32 B (one sector) at n = 2^24, where
//   C = 4, but 8-16 B where the grid's 512 blocks or the 1024 threads cap C
//   (C = 1 at 2^20 and 2^21, 2 at 2^22, 2^23, 2^25, 2^26);
// - the row passes (K2, K3) own P consecutive rows k1 and their mirrors
//   n1-k1 and touch the natural spectrum X[k1 + n1*k2] in runs of P
//   complex values at a stride of n1, each value once (K2 stores it, K3
//   loads it). Both take P from their caller (packed_fused.py
//   block_pairs): P >= 4 (runs of 32 B or more) up to m2 = 2048, but at
//   m2 = 4096 (n = 2^26) 1024 threads cap P at 2, 16-byte runs, half a
//   sector wasted. The runs of rows k = bP+1 .. bP+P start one value past a
//   P-aligned row, so each spans two 32-byte sectors whose other parts the
//   neighbouring blocks touch.
//
// The TPU phase B needs a boundary-row DFT and precomputed k1 = 0 rows
// (packed_fused.py:856-883, :913-921) because its tile pairs cannot see
// rows across 128-row tiles. Here the block that computes row k1 also
// holds row n1-k1, where the untangle's mirror operand
// Z[nh-k] = Z_T[n1-k1, m2-1-k2] lies (for k1 = 0 it is the same row shifted
// by one column, Z_T[0, (m2-k2) mod m2]; one extra block takes row 0 and
// the Nyquist bin X[nh] = Re Z[0] - Im Z[0]).

#include "fft_rows_reg.cuh"
#include "stream_columns.cuh"

using namespace dsc;

namespace {

constexpr int kRowThreads = 1024;     // K2, K3: 2 * P * m2 / 16 <= 1024, at most 64 registers

// ---------------------------------------------------------------------------
// row passes (K2, K3): block b < npairs holds 2P rows, slot i < P is row
// k = bP + 1 + i and slot P + i its mirror n1 - k; block npairs holds row 0
// alone. Over all blocks every row appears once, except row n1/2, which the
// last pair block holds twice (its own mirror) and writes once.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int slot_row(int b, int npairs, int P, int n1, int slot) {
  if (b == npairs) return 0;
  const int k = b * P + 1 + (slot < P ? slot : slot - P);
  return slot < P ? k : n1 - k;
}

// thread index t of a block -> (slot, k2) so that neighbouring threads
// touch neighbouring rows: runs of P ascending rows per k2
__device__ __forceinline__ void slot_k2(int b, int npairs, int P, int log2P, int m2, int t,
                                        int* slot, int* k2) {
  if (b == npairs) {
    *slot = 0;
    *k2 = t;
    return;
  }
  const int per_group = P * m2;
  const int g = t >= per_group;  // 0: rows k, 1: mirrors n1 - k
  const int u = t - g * per_group;
  const int i = u & (P - 1);
  *k2 = u >> log2P;
  *slot = g ? P + (P - 1 - i) : i;
}

__device__ __forceinline__ bool duplicate_slot(int slot, int P, int row, int n1) {
  return slot >= P && 2 * row == n1;
}

// K2: 2P*m2/16 threads, slot s at smem + s*sstride (sstride =
// column_stride(m2, P): padded_row(m2) plus an offset that puts the P slots
// a half warp reads in the untangle on distinct banks); m2 = 2^LOG2M2, a
// constant, so that every index and shift of the passes folds.
template <int LOG2M2>
__global__ void __launch_bounds__(kRowThreads, 1)
rfft_phase_b_kernel(const float2* __restrict__ at, float2* __restrict__ spec, int n1, int P,
                    int log2P, int sstride, const float2* __restrict__ w_m2,
                    const float2* __restrict__ un_lo, const float2* __restrict__ un_hi,
                    int un_bits) {
  extern __shared__ float2 smem[];
  constexpr int log2m2 = LOG2M2;
  constexpr int m2 = 1 << log2m2;
  const int npairs = n1 / (2 * P);
  const int b = blockIdx.x;
  const int slots = b == npairs ? 1 : 2 * P;
  {
    // the row pass: T = m2/16 neighbouring threads a slot, 16 values a
    // thread (the row-0 block runs row 0 in every slot and keeps slot 0)
    constexpr int log2T = log2m2 - kLog2Radix;
    const int s = threadIdx.x >> log2T;
    const int t = threadIdx.x & ((1 << log2T) - 1);
    const float2* src = at + ((long)slot_row(b, npairs, P, n1, s) << log2m2);
    float2 v[kRadix];
#pragma unroll
    for (int u = 0; u < kRadix; ++u) v[u] = src[t + (u << log2T)];
    float2* row = smem + s * sstride;
    row_fft<false>(v, row, t, log2m2, w_m2);
    __syncthreads();  // every thread has read the last exchange
#pragma unroll
    for (int u = 0; u < kRadix; ++u) row[pad16(t + (u << log2T))] = v[u];  // Z_T[row, k2]
  }
  __syncthreads();
  // the untangle: slots fastest, so that neighbouring threads write
  // neighbouring bins X[row + n1*k2] (runs of P)
  for (int t = threadIdx.x; t < slots * m2; t += blockDim.x) {
    int s, k2;
    slot_k2(b, npairs, P, log2P, m2, t, &s, &k2);
    const int row = slot_row(b, npairs, P, n1, s);
    if (duplicate_slot(s, P, row, n1)) continue;
    const float2 a = smem[s * sstride + pad16(k2)];
    float2 mir;  // Z[(nh - k) mod nh]
    if (row == 0) {
      mir = smem[pad16((m2 - k2) & (m2 - 1))];
    } else {
      const int ms = s < P ? s + P : s - P;
      mir = smem[ms * sstride + pad16(m2 - 1 - k2)];
    }
    const float2 bc = conj2(mir);
    const unsigned k = (unsigned)row + (unsigned)n1 * (unsigned)k2;
    const float2 e = cscale(cadd(a, bc), 0.5f);
    const float2 d = cmul(factored_twiddle(un_lo, un_hi, un_bits, k),
                          cscale(csub(a, bc), 0.5f));
    spec[k] = csub(e, times_i(d));  // X[k] = E - i*W^k*D
    if (row == 0 && k2 == 0) {      // Nyquist X[nh] = Re Z[0] - Im Z[0]
      spec[(long)n1 << log2m2] = make_float2(a.x - a.y, 0.f);
    }
  }
}

// cos(pi k / 16), 0 <= k <= 8
__device__ __forceinline__ float cos_pi16(int k) {
  switch (k) {
    case 0: return 1.f;
    case 1: return 0.98078528040323043f;
    case 2: return 0.92387953251128674f;
    case 3: return 0.83146961230254524f;
    case 4: return 0.70710678118654752f;
    case 5: return 0.55557023301960218f;
    case 6: return 0.38268343236508978f;
    case 7: return 0.19509032201612825f;
    default: return 0.f;
  }
}

// W_32^u = exp(-2 pi i u / 32), 0 <= u < 16 (INV: its conjugate); u is a
// constant once the callers' loops unroll, so the switches fold
template <bool INV>
__device__ __forceinline__ float2 w32(int u) {
  const float re = u <= 8 ? cos_pi16(u) : -cos_pi16(16 - u);
  const float im = u <= 8 ? cos_pi16(8 - u) : cos_pi16(u - 8);  // sin(pi u / 16)
  return make_float2(re, INV ? im : -im);
}

// K3, K2 run backwards: 2P*m2/16 threads, slot s at smem + s*sstride as in
// K2. The load reads each bin once, slots fastest (runs of P), into
// shared memory; the row threads then entangle their 16 values from their
// slot and the mirror slot into registers, run the inverse row DFT, and
// store Y[row, j2] = v * W_nh^-(row*j2). The row-0 block keeps X[nh] as
// value m2 of slot 0, where the mirror of k2 = 0 lies.
template <int LOG2M2>
__global__ void __launch_bounds__(kRowThreads, 1)
irfft_phase_a_kernel(const float2* __restrict__ spec, float2* __restrict__ y, int n1, int P,
                     int log2P, int sstride, const float2* __restrict__ w_m2,
                     const float2* __restrict__ un_lo, const float2* __restrict__ un_hi,
                     int un_bits, const float2* __restrict__ tw_lo,
                     const float2* __restrict__ tw_hi, int tw_bits) {
  extern __shared__ float2 smem[];
  constexpr int log2m2 = LOG2M2;
  constexpr int m2 = 1 << log2m2;
  constexpr int log2T = log2m2 - kLog2Radix;
  const int npairs = n1 / (2 * P);
  const int b = blockIdx.x;
  const bool row0 = b == npairs;
  for (int i = threadIdx.x; i < (row0 ? m2 : 2 * P * m2); i += blockDim.x) {
    int s, k2;
    slot_k2(b, npairs, P, log2P, m2, i, &s, &k2);
    const unsigned k = (unsigned)slot_row(b, npairs, P, n1, s) + (unsigned)n1 * (unsigned)k2;
    smem[s * sstride + pad16(k2)] = spec[k];
  }
  if (row0 && threadIdx.x == 0) smem[pad16(m2)] = spec[(long)n1 << log2m2];  // X[nh]
  __syncthreads();
  // the row pass: T = m2/16 neighbouring threads a slot, 16 values a thread
  // (the row-0 block runs row 0 in every slot, from slot 0, and keeps slot 0)
  const int s = threadIdx.x >> log2T;
  const int t = threadIdx.x & ((1 << log2T) - 1);
  const int row = slot_row(b, npairs, P, n1, s);
  const float2* own = smem + (row0 ? 0 : s * sstride);
  const float2* mirror = row0 ? smem : smem + (s < P ? s + P : s - P) * sstride;
  // X[nh - k] lies at k2' = flip - k2 of the mirror slot: n1 - row, m2 - 1 - k2
  // (row 0: row 0, m2 - k2, X[nh] at k2' = m2)
  const int flip = row0 ? m2 : m2 - 1;
  // Z[k] = (A + B)/2 + i*W_n^-k*(A - B)/2 with A = X[k], B = conj X[nh - k],
  // k = row + n1*k2, k2 = t + u*T: W_n^k = W_n^(row + n1*t) * W_32^u, as
  // n1*T = n/32
  const float2 wt = conj2(factored_twiddle(un_lo, un_hi, un_bits,
                                           (unsigned)row + (unsigned)n1 * (unsigned)t));
  float2 v[kRadix];
#pragma unroll
  for (int u = 0; u < kRadix; ++u) {
    const int k2 = t + (u << log2T);
    float2 a = own[pad16(k2)];
    float2 bc = conj2(mirror[pad16(flip - k2)]);
    // as np.fft.irfft, only the real parts of X[0] and X[nh] count: both
    // meet in the k = 0 slot alone
    if (row == 0 && k2 == 0) {
      a.y = 0.f;
      bc.y = 0.f;
    }
    const float2 d = cmul(cmul(wt, w32<true>(u)), cscale(csub(a, bc), 0.5f));
    v[u] = cadd(cscale(cadd(a, bc), 0.5f), times_i(d));
  }
  __syncthreads();  // every thread has read the mirror slot the exchanges overwrite
  row_fft<true>(v, smem + s * sstride, t, log2m2, w_m2);
  if ((row0 && s > 0) || duplicate_slot(s, P, row, n1)) return;
  row_store_twiddled(v, y + ((long)row << log2m2), t, log2T, tw_lo, tw_hi, tw_bits,
                     (unsigned)row * (unsigned)t, (unsigned)row << log2T);
}

template <int LOG2M2>
int launch_rfft_phase_b(const void* at, void* spec, int n1, int P, const void* w_m2,
                        const void* un_lo, const void* un_hi, int un_bits, void* stream) {
  const int sstride = column_stride(1 << LOG2M2, P);
  const size_t smem = (size_t)2 * P * sstride * sizeof(float2);
  int err = set_smem((const void*)rfft_phase_b_kernel<LOG2M2>, smem);
  if (err) return err;
  rfft_phase_b_kernel<LOG2M2><<<n1 / (2 * P) + 1, 2 * P << (LOG2M2 - kLog2Radix), smem,
                                (cudaStream_t)stream>>>(
      (const float2*)at, (float2*)spec, n1, P, ilog2(P), sstride, (const float2*)w_m2,
      (const float2*)un_lo, (const float2*)un_hi, un_bits);
  return (int)cudaGetLastError();
}

template <int LOG2M2>
int launch_irfft_phase_a(const void* spec, void* y, int n1, int P, const void* w_m2,
                         const void* un_lo, const void* un_hi, int un_bits, const void* tw_lo,
                         const void* tw_hi, int tw_bits, void* stream) {
  const int sstride = column_stride(1 << LOG2M2, P);
  const size_t smem = (size_t)2 * P * sstride * sizeof(float2);
  int err = set_smem((const void*)irfft_phase_a_kernel<LOG2M2>, smem);
  if (err) return err;
  irfft_phase_a_kernel<LOG2M2><<<n1 / (2 * P) + 1, 2 * P << (LOG2M2 - kLog2Radix), smem,
                                 (cudaStream_t)stream>>>(
      (const float2*)spec, (float2*)y, n1, P, ilog2(P), sstride, (const float2*)w_m2,
      (const float2*)un_lo, (const float2*)un_hi, un_bits, (const float2*)tw_lo,
      (const float2*)tw_hi, tw_bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (valid,) float32, 1 <= valid <= 2*n1*m2, zero-padded to 2*n1*m2 = z
// (n1, m2) complex64 -> at (n1, m2) complex64; C = columns a block
int dsc_rfft_phase_a(const void* x, void* at, long long valid, int n1, int m2,
                     const void* w_n1, const void* tw_lo, const void* tw_hi, int tw_bits,
                     int columns, void* stream) {
  if (valid < 1 || valid > 2LL * n1 * m2) return (int)cudaErrorInvalidValue;
  return launch_columns<false, false, kStoreInPlaceTwiddled, false, true>(
      x, at, 1, n1, m2, columns, w_n1, tw_lo, tw_hi, tw_bits, 1.f, stream, (long)valid);
}

// at (n1, m2) -> spec (n1*m2 + 1,) complex64, natural order; P row pairs a
// block (2P*m2/16 threads), n1/(2P) + 1 blocks
int dsc_rfft_phase_b(const void* at, void* spec, int n1, int m2, const void* w_m2,
                     const void* un_lo, const void* un_hi, int un_bits, int P, void* stream) {
  const int log2m2 = ilog2(m2);
  if (m2 < 256 || m2 > 4096 || (1 << log2m2) != m2 || P < 1 || (1 << ilog2(P)) != P ||
      n1 % (2 * P) || 2 * P * (m2 / kRadix) > kRowThreads)
    return (int)cudaErrorInvalidValue;
  switch (log2m2) {
    case 8: return launch_rfft_phase_b<8>(at, spec, n1, P, w_m2, un_lo, un_hi, un_bits, stream);
    case 9: return launch_rfft_phase_b<9>(at, spec, n1, P, w_m2, un_lo, un_hi, un_bits, stream);
    case 10: return launch_rfft_phase_b<10>(at, spec, n1, P, w_m2, un_lo, un_hi, un_bits, stream);
    case 11: return launch_rfft_phase_b<11>(at, spec, n1, P, w_m2, un_lo, un_hi, un_bits, stream);
    default: return launch_rfft_phase_b<12>(at, spec, n1, P, w_m2, un_lo, un_hi, un_bits, stream);
  }
}

// spec (n1*m2 + 1,) complex64 -> y (n1, m2) complex64, 512 <= m2 <= 4096;
// P row pairs a block (2P*m2/16 threads), n1/(2P) + 1 blocks
int dsc_irfft_phase_a(const void* spec, void* y, int n1, int m2, const void* w_m2,
                      const void* un_lo, const void* un_hi, int un_bits, const void* tw_lo,
                      const void* tw_hi, int tw_bits, int P, void* stream) {
  const int log2m2 = ilog2(m2);
  if (m2 < 512 || m2 > 4096 || (1 << log2m2) != m2 || P < 1 || (1 << ilog2(P)) != P ||
      n1 % (2 * P) || 2 * P * (m2 / kRadix) > kRowThreads)
    return (int)cudaErrorInvalidValue;
  switch (log2m2) {
    case 9: return launch_irfft_phase_a<9>(spec, y, n1, P, w_m2, un_lo, un_hi, un_bits, tw_lo,
                                           tw_hi, tw_bits, stream);
    case 10: return launch_irfft_phase_a<10>(spec, y, n1, P, w_m2, un_lo, un_hi, un_bits, tw_lo,
                                             tw_hi, tw_bits, stream);
    case 11: return launch_irfft_phase_a<11>(spec, y, n1, P, w_m2, un_lo, un_hi, un_bits, tw_lo,
                                             tw_hi, tw_bits, stream);
    default: return launch_irfft_phase_a<12>(spec, y, n1, P, w_m2, un_lo, un_hi, un_bits, tw_lo,
                                             tw_hi, tw_bits, stream);
  }
}

// y (n1, m2) complex64 -> out (2*n1*m2,) float32 (even samples = real
// parts), scaled by `scale`; C = columns a block
int dsc_irfft_phase_b(const void* y, void* out, int n1, int m2, const void* w_n1,
                      float scale, int columns, void* stream) {
  return launch_columns<true, false, kStoreInPlace, false>(
      y, out, 1, n1, m2, columns, w_n1, nullptr, nullptr, 0, scale, stream);
}

}  // extern "C"
