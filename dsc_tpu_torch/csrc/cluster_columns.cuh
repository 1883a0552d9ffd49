// The cluster column pass of one shard's block: K6 local and K7 local
// (stream_local.cu), the d-way sharded four-step's per-shard column passes.
//
// A shard's block is one (L, M) row-major complex64 (K6 local: float32 too)
// matrix, L = 512 ... 8192, M >= 256, both powers of two. Every column gets
// an L-point FFT; K6 local stores column m as the contiguous row m of an
// (M, L) output times the four-step twiddle W_n^(s*k*(col0 + m)), K7 local
// stores the columns back in place (scaled, complex64 or the float32 real
// part).
//
// Why not stream_columns.cuh: that pass holds C whole columns in one
// block, C*L <= 16384 points, so a narrow block takes C = 2 at L = 4096 and
// 8192 and reads (K7 local also writes) every row as a 16-byte run at a
// stride of M, half of a 32-byte sector: 2.9-5.4x the bytes' bound on an
// H100 (PERF.md). Here a group of W columns, W = 4 of complex64 and 8 where
// the block or the output is float32 (32-byte runs, whole sectors), is held
// across the shared memory of a thread-block cluster of Q CTAs, Q = max(1,
// L/1024): an L x W group of 8192 x 4 (256 KiB) is more than one block's
// 227 KB.
//
// The column FFT is split over the cluster by decimation in time,
// L = P*Q, P = L/Q rows a CTA (512 or 1024), P*W/16 threads of 16 values.
// The grid is persistent: each cluster walks the column groups g, g + G,
// ... (G clusters in the grid, as many as the card holds at once), and a
// two-stage ring overlaps the next group's load with this group's work:
//   1. CTA q (its rank in the cluster) has rows q, q + Q, q + 2Q, ... of
//      its group's W columns, a P x W tile, loaded by TMA (a 3-D tensor map
//      over the block viewed as (L/Q, Q, M), boxes of 256 x 1 x W, encoded
//      on the host for each launch) with completion on one mbarrier, whose
//      phase flips once a group; as soon as every thread has read the tile
//      into registers (and fenced its reads against the async proxy), one
//      thread starts the next group's load into it;
//   2. it runs the P-point FFT of each column in registers, fft_radix.cuh's
//      Stockham passes (16 values a thread, the exchanges in the padded
//      column layout of stream_columns.cuh at C = W), the stage twiddles
//      W_P^e = W_L^(e*Q) read from the L-point table;
//   3. it multiplies value k' by W_L^(s*q*k') and leaves the P x W result
//      in its exchange buffer: K6 local in the column layout (k'
//      contiguous), K7 local as rows of W (the column contiguous);
//   4. barrier.cluster (release / acquire);
//   5. it owns k' = q*P/Q ... (q+1)*P/Q - 1: for each of them and each
//      column it reads the Q values from the Q CTAs' exchange buffers
//      (distributed shared memory; a warp reads 256 contiguous bytes of
//      one CTA), arrives on the cluster barrier, runs the DFT_Q in
//      registers and holds X[k' + r*P], r < Q;
//   6. it stores them: K6 local as rows of the (M, L) output, the 32 lanes
//      of a warp on 32 consecutive k' of one column (256-byte runs), times
//      W_n^(s*k*(col0 + m)), two factored lookups of the float64-built
//      tables (fft_core.cuh factored_twiddle) a (k', column) pair and
//      products across r; K7 local in place, W lanes on the W columns of
//      one row (32-byte runs), scaled;
//   7. the next group waits on the cluster barrier before step 2 writes
//      the exchange buffer again (the peers have read it), and the CTA
//      waits once more before it exits.
//
// Bound on the H100: device memory, one read and one write of the block
// (2 * L*M*8 bytes; 0.020 ms for (4096, 1024) at 3.35 TB/s) against
// ~5*L*M*log2(L) flops (0.003 ms at 67 TFLOP/s of float32).
//
// What the design does about it: every global access is a run of whole
// sectors; the loads cost one thread four TMA instructions a group and run
// under the previous group's passes, exchange and stores; the shared-memory
// accesses of a full warp take the least wavefronts (a numpy emulation in
// tests/test_torch_row_pass.py counts them); the DFT_Q's distributed reads
// move each value once; two or three CTAs of 256 threads (~67 KB each)
// share an SM at W = 4, so one CTA's barriers and waits run under another's
// passes. Why not W = 16 (128-byte runs): the ring's two buffers at P =
// 1024 take 268 KB, more than an SM has, and P = 512 would need clusters of
// 16 CTAs at L = 8192 (beyond the portable 8); W = 8 for complex64 (one
// CTA of 512 threads a SM) ran 6-13% slower than W = 4 at (4096, 1024) and
// (8192, 2048), 4% faster at (4096, 512) (PERF.md, Findings: K6/K7 local).
//
// Measured on an H100 (clock64 stamps of each CTA's thread 0; PERF.md,
// Findings: K6/K7 local): a group's passes take ~6,600-11,500 cycles
// (K7 local's, three CTAs a SM, the longer), the two cluster
// barriers and their skew ~3,000-8,500, the distributed reads, DFT_Q and
// stores ~4,500-5,900. What it does not do: overlap a cluster's barrier
// waits with its own next group (only with other CTAs' work); the grid's
// first load and last round of groups leave the card part idle; K6
// local's float32-input instance spills ~470 bytes a thread.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types (no link to libcuda)
#include <dlfcn.h>

#include <cstdint>

#include "fft_radix.cuh"

// internal linkage (see stream_columns.cuh)
namespace {

using namespace dsc;
namespace cg = cooperative_groups;

constexpr int kLocalMaxRows = 1024;  // P rows a CTA
constexpr int kLocalMinRows = 512;
constexpr int kLocalMaxCluster = 8;  // the portable cluster size
constexpr int kBoxRows = 256;        // TMA's largest box extent

// log2 W, the columns of a group: 4 (32-byte runs) for complex64 in and
// out, 8 (32-byte runs of float32) where the block or the output is float32
__host__ __device__ constexpr int local_log2w(bool real) { return real ? 3 : 2; }

// CTAs a SM: at W = 4 (P*W/16 = 256 threads, ~67 KB), three of K7 local
// (80 registers a thread; 0.4-7% faster than two) and two of K6 local (128:
// at 80 its twiddled store spills ~350 bytes a thread and ran 4-25%
// slower; PERF.md, Findings: K6/K7 local); one of 512 threads at W = 8
__host__ __device__ constexpr int local_ctas_per_sm(int log2w, bool rows_out) {
  return log2w == 2 ? (rows_out ? 2 : 3) : 1;
}

// float2 slots between two columns of the exchange (fft_radix.cuh
// column_stride at C = W)
__host__ __device__ constexpr int local_column_stride(int P, int log2w) {
  return P + P / 16 + (16 >> log2w);
}

// float2 slots of the tile (P x W, the TMA's destination) and of the
// exchange buffer that follows it (W padded columns); the mbarrier comes
// last
__host__ __device__ constexpr int local_tile_slots(int P, int log2w) { return P << log2w; }
__host__ __device__ constexpr int local_exchange_slots(int P, int log2w) {
  return local_column_stride(P, log2w) << log2w;
}

inline size_t local_smem_bytes(int P, int log2w) {
  return (size_t)(local_tile_slots(P, log2w) + local_exchange_slots(P, log2w)) * sizeof(float2) +
         8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase `parity` to complete; a load that never completes
// (some seconds of waiting) traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one TMA box of the 3-D map into this CTA's shared memory at dst
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int x, int y,
                                            int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// barrier.cluster, split: arrive (release this thread's writes and reads)
// and wait (acquire the peers'). Not the .aligned forms: thread 0 reaches
// the wait straight from issuing a load the rest of its warp skipped, and
// an aligned barrier in a diverged warp is undefined (it corrupted results
// on the card before this)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// DFT_N of v[S + j*G], j < N, for each S < G (constant register indices)
template <int N, int G, int S, bool INV>
__device__ __forceinline__ void dft_each(float2 (&v)[kRadix]) {
  if constexpr (S < G) {
    dft_reg<N, S, G, INV>(v);
    dft_each<N, G, S + 1, INV>(v);
  }
}

// One Stockham pass of radix 2^LOG2R over the P = 2^log2P values of a
// column (fft_radix.cuh radix_pass, T = P/16 threads a column), its stage
// twiddles W_{Ns*r} = W_L^(L/(Ns*r)) read from the L-point table w
// (W_L^p, p < L/2): the P-point FFT of a decimated column.
template <int LOG2R, bool INV>
__device__ __forceinline__ void local_radix_pass(float2 (&v)[kRadix], int t, int log2P,
                                                 int log2L, int log2Ns,
                                                 const float2* __restrict__ w) {
  constexpr int r = 1 << LOG2R;
  constexpr int g = kRadix / r;
  const int log2T = log2P - kLog2Radix;
  const int shift = log2L - log2Ns - LOG2R;
#pragma unroll
  for (int s = 0; s < g; ++s) {
    if (log2Ns > 0) {
      const int k = (t + (s << log2T)) & ((1 << log2Ns) - 1);
#pragma unroll
      for (int q = 1; q < r; ++q)
        v[s + q * g] = cmul(v[s + q * g], stage_twiddle<INV>(w, (k * q) << shift, log2L));
    }
  }
  dft_each<r, g, 0, INV>(v);
}

template <bool INV>
__device__ __forceinline__ void local_pass(float2 (&v)[kRadix], int log2r, int t, int log2P,
                                           int log2L, int log2Ns, const float2* __restrict__ w) {
  switch (log2r) {
    case 4: local_radix_pass<4, INV>(v, t, log2P, log2L, log2Ns, w); break;
    case 3: local_radix_pass<3, INV>(v, t, log2P, log2L, log2Ns, w); break;
    case 2: local_radix_pass<2, INV>(v, t, log2P, log2L, log2Ns, w); break;
    default: local_radix_pass<1, INV>(v, t, log2P, log2L, log2Ns, w); break;
  }
}

__device__ __forceinline__ void local_store(const float2 (&v)[kRadix], int log2r, float2* col,
                                            int t, int log2P, int log2Ns) {
  switch (log2r) {
    case 4: pass_store<4>(v, col, t, log2P, log2Ns); break;
    case 3: pass_store<3>(v, col, t, log2P, log2Ns); break;
    case 2: pass_store<2>(v, col, t, log2P, log2Ns); break;
    default: pass_store<1>(v, col, t, log2P, log2Ns); break;
  }
}

// Pair g of this thread in steps 5-6: p = threadIdx.x + g*P*W/16, k'
// (its CTA's P/Q >= 128 of them from q*P/Q on) and the column; K6 local
// (ROWS_OUT) takes k' fastest, K7 local the column
template <bool ROWS_OUT, int LOG2W>
__device__ __forceinline__ void cluster_pair(int g, int q, int log2P, int log2K, int& k,
                                             int& c) {
  const int p = threadIdx.x + (g << (log2P + LOG2W - kLog2Radix));
  c = ROWS_OUT ? p >> log2K : p & ((1 << LOG2W) - 1);
  k = (q << log2K) + (ROWS_OUT ? p & ((1 << log2K) - 1) : p >> LOG2W);
}

// Slot of value k' of column c in the exchange buffer after step 3
template <bool ROWS_OUT, int LOG2W>
__device__ __forceinline__ int exchange_slot(int k, int c, int P) {
  return ROWS_OUT ? c * local_column_stride(P, LOG2W) + pad16(k) : (k << LOG2W) + c;
}

// Steps 5-6 for a cluster of Q CTAs: this thread's G = 16/Q (k', column)
// pairs of the group at column m0; arrives on the cluster barrier once it
// has read the peers' exchange buffers (every CTA's at the same offset).
template <int Q, bool INV, bool ROWS_OUT, bool REAL_OUT, int LOG2W>
__device__ __forceinline__ void cluster_dft_store(cg::cluster_group cluster, float2* exch,
                                                  void* __restrict__ out, int q, int log2P,
                                                  int log2L, int log2M, int m0,
                                                  const float2* __restrict__ tw_lo,
                                                  const float2* __restrict__ tw_hi,
                                                  int tw_bits, float scale, int col0) {
  constexpr int G = kRadix / Q;
  constexpr int log2Q = Q == 1 ? 0 : Q == 2 ? 1 : Q == 4 ? 2 : 3;
  const int log2K = log2P - log2Q;
  const int P = 1 << log2P;
  float2 v[kRadix];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const float2* src = Q == 1 ? exch : cluster.map_shared_rank(exch, j);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int k, c;
      cluster_pair<ROWS_OUT, LOG2W>(g, q, log2P, log2K, k, c);
      v[g + j * G] = src[exchange_slot<ROWS_OUT, LOG2W>(k, c, P)];
    }
  }
  cluster_arrive();  // done with the peers' buffers
  if constexpr (Q > 1) dft_each<Q, G, 0, INV>(v);
  // v[g + r*G] is X[k' + r*P] of column m0 + c
  const int L = 1 << log2L;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    int k0, c;
    cluster_pair<ROWS_OUT, LOG2W>(g, q, log2P, log2K, k0, c);
    const int m = m0 + c;
    // K6 local's W_n^(k*(col0 + m)) at k = k' + r*P: two factored lookups,
    // W_n^(k'*(col0 + m)) (its lo index differs from lane to lane) and
    // W_n^(P*(col0 + m)) (one for the warp), and r products
    float2 tw = make_float2(1.f, 0.f), tw_step = tw;
    if (ROWS_OUT) {
      tw = factored_twiddle(tw_lo, tw_hi, tw_bits, (unsigned)k0 * (unsigned)(col0 + m));
      if (Q > 1) tw_step = factored_twiddle(tw_lo, tw_hi, tw_bits, (unsigned)P * (col0 + m));
    }
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      const int k = k0 + (r << log2P);
      float2 y = v[g + r * G];
      if (ROWS_OUT) {
        static_cast<float2*>(out)[(long)m * L + k] = cmul(y, INV ? conj2(tw) : tw);
        tw = cmul(tw, tw_step);
      } else {
        y = cscale(y, scale);
        const long dst = ((long)k << log2M) + m;
        if (REAL_OUT) {
          static_cast<float*>(out)[dst] = y.x;
        } else {
          static_cast<float2*>(out)[dst] = y;
        }
      }
    }
  }
}

// Step 1 for group `grp` (thread 0): the tile's bytes expected on `bar`,
// then P/256 boxes of rows q + Q*i of columns grp*W ...
template <bool REAL_IN, int LOG2W>
__device__ __forceinline__ void load_group(float2* tile, const CUtensorMap* map, int grp, int q,
                                           int P, uint64_t* bar) {
  constexpr int row_bytes = (REAL_IN ? 4 : 8) << LOG2W;
  const int x0 = (grp << LOG2W) * (REAL_IN ? 1 : 2);  // in floats
  mbar_arrive_expect_tx(bar, (uint32_t)(P * row_bytes));
  for (int i0 = 0; i0 < P; i0 += kBoxRows)
    tma_load_3d(reinterpret_cast<char*>(tile) + i0 * row_bytes, map, x0, q, i0, bar);
}

// A persistent cluster of Q CTAs over the (L, M) block behind `map`: CTA
// blockIdx.x = cluster*Q + q takes the column groups cluster, cluster + G,
// ... (G = gridDim.x/Q; steps 1-7 above). ROWS_OUT: K6 local's twiddled row
// store into the (M, L) `out`; else K7 local's in-place store into the
// (L, M) `out`, REAL_OUT the float32 real part. REAL_IN: the block is
// float32.
template <bool INV, bool REAL_IN, bool ROWS_OUT, bool REAL_OUT>
__global__ void __launch_bounds__(kLocalMaxRows << local_log2w(REAL_IN || REAL_OUT) >> kLog2Radix,
                                  local_ctas_per_sm(local_log2w(REAL_IN || REAL_OUT), ROWS_OUT))
cluster_column_kernel(const __grid_constant__ CUtensorMap map, void* __restrict__ out,
                      int log2L, int log2Q, int log2M, const float2* __restrict__ w,
                      const float2* __restrict__ tw_lo, const float2* __restrict__ tw_hi,
                      int tw_bits, float scale, int col0) {
  extern __shared__ __align__(128) float2 lsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int LOG2W = local_log2w(REAL_IN || REAL_OUT);
  constexpr int W = 1 << LOG2W;
  const int log2P = log2L - log2Q;
  const int P = 1 << log2P;
  const int log2T = log2P - kLog2Radix;
  const int q = (int)cluster.block_rank();
  const int groups = 1 << (log2M - LOG2W);
  const int step = gridDim.x >> log2Q;  // clusters in the grid
  float2* tile = lsmem;
  float2* exch = lsmem + local_tile_slots(P, LOG2W);
  uint64_t* bar = reinterpret_cast<uint64_t*>(exch + local_exchange_slots(P, LOG2W));
  const int c = threadIdx.x & (W - 1);
  const int t = threadIdx.x >> LOG2W;
  float2* col = exch + c * local_column_stride(P, LOG2W);

  int grp = blockIdx.x >> log2Q;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    if (grp < groups) load_group<REAL_IN, LOG2W>(tile, &map, grp, q, P, bar);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  uint32_t parity = 0;
  bool ran = false;
  for (; grp < groups; grp += step) {
    // 1. this group's tile, then the next group's load into it
    mbar_wait(bar, parity);
    parity ^= 1;
    float2 v[kRadix];
#pragma unroll
    for (int u = 0; u < kRadix; ++u) {
      const int i = (t + (u << log2T)) * W + c;
      v[u] = REAL_IN ? make_float2(reinterpret_cast<const float*>(tile)[i], 0.f) : tile[i];
    }
    // every thread has read the tile: its generic reads ordered before the
    // next group's TMA writes (the async proxy) into it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0 && grp + step < groups)
      load_group<REAL_IN, LOG2W>(tile, &map, grp + step, q, P, bar);
    if (ran) cluster_wait();  // 7. the peers have read the previous group's exchange
    ran = true;

    // 2. the P-point FFT of column c
    int log2Ns = 0;
    for (;;) {
      const int log2r = min(kLog2Radix, log2P - log2Ns);
      local_pass<INV>(v, log2r, t, log2P, log2L, log2Ns, w);
      if (log2Ns + log2r == log2P) break;
      local_store(v, log2r, col, t, log2P, log2Ns);
      __syncthreads();
      log2Ns += log2r;
#pragma unroll
      for (int u = 0; u < kRadix; ++u) v[u] = col[pad16(t + (u << log2T))];
      __syncthreads();  // the next pass's store, or step 3, overwrites
    }

    // 3. v[u] is value k' = t + u*T of the P-point transform of column c:
    // times W_L^(s*q*k'), into the exchange buffer
#pragma unroll
    for (int u = 0; u < kRadix; ++u) {
      const int k = t + (u << log2T);
      float2 y = v[u];
      if (q) y = cmul(y, stage_twiddle<INV>(w, q * k, log2L));
      exch[exchange_slot<ROWS_OUT, LOG2W>(k, c, P)] = y;
    }
    cluster_arrive();  // 4.
    cluster_wait();

    // 5-6.
    const int m0 = grp << LOG2W;
    switch (log2Q) {
      case 0:
        cluster_dft_store<1, INV, ROWS_OUT, REAL_OUT, LOG2W>(cluster, exch, out, q, log2P, log2L,
                                                      log2M, m0, tw_lo, tw_hi, tw_bits, scale,
                                                      col0);
        break;
      case 1:
        cluster_dft_store<2, INV, ROWS_OUT, REAL_OUT, LOG2W>(cluster, exch, out, q, log2P, log2L,
                                                      log2M, m0, tw_lo, tw_hi, tw_bits, scale,
                                                      col0);
        break;
      case 2:
        cluster_dft_store<4, INV, ROWS_OUT, REAL_OUT, LOG2W>(cluster, exch, out, q, log2P, log2L,
                                                      log2M, m0, tw_lo, tw_hi, tw_bits, scale,
                                                      col0);
        break;
      default:
        cluster_dft_store<8, INV, ROWS_OUT, REAL_OUT, LOG2W>(cluster, exch, out, q, log2P, log2L,
                                                      log2M, m0, tw_lo, tw_hi, tw_bits, scale,
                                                      col0);
        break;
    }
  }
  if (ran) cluster_wait();  // 7. no CTA leaves while a peer may read its buffer
}

// cuTensorMapEncodeTiled from the libcuda PyTorch has loaded (dlsym: no
// link against it, no runtime-version-specific entry-point query)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// What the launcher returns when the tensor map cannot be made:
// kTensorMapError + the CUresult (kTensorMapError alone: no
// cuTensorMapEncodeTiled in libcuda)
constexpr int kTensorMapError = 100000;

// The (L, M) block at `in` as (L/Q, Q, M) rows of W-value boxes, 256 rows
// a box, in floats (2 a complex value)
inline int encode_block(CUtensorMap* map, const void* in, int log2L, int log2Q, int log2M,
                        int log2w, bool real) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t esize = real ? 4 : 8;
  const int P = 1 << (log2L - log2Q);
  const cuuint64_t dims[3] = {(real ? 1ull : 2ull) << log2M, 1ull << log2Q, (cuuint64_t)P};
  const cuuint64_t strides[2] = {esize << log2M, esize << (log2M + log2Q)};
  const cuuint32_t box[3] = {(real ? 1u : 2u) << log2w, 1u,
                             (cuuint32_t)(P < kBoxRows ? P : kBoxRows)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(in), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// The geometry the kernel takes (fourier/stream.py local_geometry): W =
// 1 << log2w columns a group, Q in {1, 2, 4, 8} CTAs a cluster, P = L/Q in
// [512, 1024] rows a CTA, M >= W, and 1 ... M/W clusters in the grid (0
// for the occupancy query); 0 or cudaErrorInvalidValue
inline int local_geometry_error(int L, int M, int W, int Q, int clusters, int log2w) {
  const int log2L = ilog2(L), log2M = ilog2(M), log2Q = ilog2(Q);
  const int P = L / Q;
  if ((1 << log2L) != L || (1 << log2M) != M || (1 << log2Q) != Q || W != (1 << log2w) ||
      Q > kLocalMaxCluster || M < W || P < kLocalMinRows || P > kLocalMaxRows ||
      (long)L * M > (1l << 30) || clusters < 0 || clusters > M / W)
    return (int)cudaErrorInvalidValue;
  return 0;
}

inline cudaLaunchConfig_t cluster_config(int clusters, int Q, int P, int log2w, size_t smem,
                                         void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * Q));
  cfg.blockDim = dim3((unsigned)((P << log2w) / kRadix));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)Q;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel of an instance, its shared memory allowed
template <bool INV, bool REAL_IN, bool ROWS_OUT, bool REAL_OUT>
int prepare_cluster_kernel(size_t smem) {
  return set_smem((const void*)cluster_column_kernel<INV, REAL_IN, ROWS_OUT, REAL_OUT>, smem);
}

// One launch over the (L, M) block `in` (16-byte aligned): groups of W
// columns, clusters of Q CTAs, `clusters` of them in the grid; `out` (M, L)
// for ROWS_OUT, else (L, M).
template <bool INV, bool REAL_IN, bool ROWS_OUT, bool REAL_OUT>
int launch_cluster_columns(const void* in, void* out, int L, int M, int W, int Q, int clusters,
                           const void* w, const void* tw_lo, const void* tw_hi, int tw_bits,
                           float scale, int col0, void* stream) {
  constexpr int log2w = local_log2w(REAL_IN || REAL_OUT);
  int err = local_geometry_error(L, M, W, Q, clusters, log2w);
  if (err || clusters == 0) return err ? err : (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(in) % 16) return (int)cudaErrorMisalignedAddress;
  const int log2L = ilog2(L), log2M = ilog2(M), log2Q = ilog2(Q);
  CUtensorMap map;
  err = encode_block(&map, in, log2L, log2Q, log2M, log2w, REAL_IN);
  if (err) return err;
  const int P = L / Q;
  const size_t smem = local_smem_bytes(P, log2w);
  err = prepare_cluster_kernel<INV, REAL_IN, ROWS_OUT, REAL_OUT>(smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(clusters, Q, P, log2w, smem, stream, &attr);
  err = (int)cudaLaunchKernelEx(&cfg, cluster_column_kernel<INV, REAL_IN, ROWS_OUT, REAL_OUT>,
                                map, out, log2L, log2Q, log2M, (const float2*)w,
                                (const float2*)tw_lo, (const float2*)tw_hi, tw_bits, scale, col0);
  if (err) return err;
  return (int)cudaGetLastError();
}

// What a launch at this geometry would get: info[0] the clusters that can
// be active at once (cudaOccupancyMaxActiveClusters), info[1] registers a
// thread, info[2] local memory a thread (bytes: spills and stack), info[3]
// dynamic shared memory a CTA (bytes), info[4] threads a CTA
template <bool INV, bool REAL_IN, bool ROWS_OUT, bool REAL_OUT>
int cluster_info(int L, int M, int W, int Q, int* info) {
  constexpr int log2w = local_log2w(REAL_IN || REAL_OUT);
  int err = local_geometry_error(L, M, W, Q, 0, log2w);
  if (err) return err;
  const int P = L / Q;
  const size_t smem = local_smem_bytes(P, log2w);
  err = prepare_cluster_kernel<INV, REAL_IN, ROWS_OUT, REAL_OUT>(smem);
  if (err) return err;
  const void* kernel = (const void*)cluster_column_kernel<INV, REAL_IN, ROWS_OUT, REAL_OUT>;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, Q, P, log2w, smem, nullptr, &attr);
  err = (int)cudaOccupancyMaxActiveClusters(&info[0], kernel, &cfg);
  if (err) return err;
  cudaFuncAttributes fa;
  err = (int)cudaFuncGetAttributes(&fa, kernel);
  if (err) return err;
  info[1] = fa.numRegs;
  info[2] = (int)fa.localSizeBytes;
  info[3] = (int)smem;
  info[4] = (int)cfg.blockDim.x;
  return 0;
}

}  // namespace
