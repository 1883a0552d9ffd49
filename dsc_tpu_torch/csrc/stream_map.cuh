// The streaming elementwise skeleton shared by K5 (stream_map.cu, a fixed
// set of bodies) and K5g (one source generated per dsc.map signature by
// ops/map_gen.py, this header plus one body functor).
//
// Replaces the loop of dsc_tpu/ops/pallas_map.py:_map_kernel, which streams
// (rows, 128) tiles HBM -> VMEM -> HBM and runs any elementwise body on
// them, with full, broadcast-row and scalar operands and one or more
// float32 outputs.
//
// Bound on the H100: device memory. A body does a few to a few tens of
// flops per 4 bytes of each streamed operand and output, far under the
// card's balance point.
//
// The design: the operand kinds (full, broadcast row, scalar) are template
// arguments, so the loop carries no branch on a kind and keeps registers
// only for what it streams: a scalar is one register, read once per thread
// (a value, or a 1-element tensor by one load); a broadcast row is read
// through L1/L2 at offsets into the row computed once per thread, with one
// 64-bit division and then 32-bit arithmetic. Each block takes one chunk
// of kVec x 256 float4 groups (8 KB an operand), and each thread issues
// its kVec 16-byte loads per streamed operand before any arithmetic, so up
// to 2048 threads an SM keep loads in flight. A body is a functor
// ``void operator()(const float (&in)[N], float (&out)[M])`` run on each of
// the four lanes of the float4 groups; a ragged count (n % 4 floats) ends
// in plain loads in block 0.
//
// Launch contract: the caller's stream, no synchronisation, no allocation;
// launch_map returns cudaGetLastError().
//
// Everything here has internal linkage (the top-level anonymous
// namespace): each source that includes it gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;                  // float4 groups a thread
constexpr int kChunk = kThreads * kVec;  // float4 groups a block: 8 KB an operand

// operand kinds as the kernels are instantiated: full, broadcast row, scalar
enum Kind { kF = 0, kB = 1, kS = 2 };

struct Operand {
  const float* ptr;  // full, brow or 1-element data; null for a value
  float re, im;      // a scalar passed by value
  int m;             // brow length in elements
};

template <int N>
struct Operands {
  Operand op[N];
};

template <int M>
struct Outputs {
  float* ptr[M];
};

// -- the operands as a thread holds them --------------------------------------
//
// at(k): the float4 of the thread's k-th group for a broadcast row or a
// scalar (a full operand is loaded by the kernel); one(i): element i, for
// the tail.

template <int K>
struct Real;

template <>
struct Real<kF> {
  const float* p;
  __device__ explicit Real(const Operand& o) : p(o.ptr) {}
  __device__ void seek(long long) {}
  __device__ float one(long long i) const { return __ldg(p + i); }
};

template <>
struct Real<kB> {
  const float* row;
  uint32_t m;
  uint32_t off[kVec];  // row offset of the thread's k-th group, in elements
  __device__ explicit Real(const Operand& o) : row(o.ptr), m((uint32_t)o.m) {}
  // the thread's groups g, g + kThreads, ...: one 64-bit division, then
  // 32-bit ones
  __device__ void seek(long long g) {
    const uint32_t base = (uint32_t)((4 * g) % m);
#pragma unroll
    for (int k = 0; k < kVec; ++k) off[k] = (base + 4u * kThreads * k) % m;
  }
  __device__ float4 at(int k) const { return __ldg(reinterpret_cast<const float4*>(row + off[k])); }
  __device__ float one(long long i) const { return __ldg(row + i % m); }
};

template <>
struct Real<kS> {
  float s;
  __device__ explicit Real(const Operand& o) : s(o.ptr ? __ldg(o.ptr) : o.re) {}
  __device__ void seek(long long) {}
  __device__ float4 at(int) const { return make_float4(s, s, s, s); }
  __device__ float one(long long) const { return s; }
};

template <int K, class Op>
__device__ __forceinline__ float4 load4(const Op& o, long long g, int k) {
  if constexpr (K == kF) return __ldg(reinterpret_cast<const float4*>(o.p) + g);
  else return o.at(k);
}

// operand I of kind K, so that one kind can appear at several places
template <int I, int K>
struct Slot : Real<K> {
  __device__ explicit Slot(const Operand& o) : Real<K>(o) {}
};

template <class Seq, int... Ks>
struct Slots;

template <int... Is, int... Ks>
struct Slots<std::integer_sequence<int, Is...>, Ks...> : Slot<Is, Ks>... {
  template <int N>
  __device__ explicit Slots(const Operands<N>& in) : Slot<Is, Ks>(in.op[Is])... {}
};

// -- the body on the four lanes of a float4 group ------------------------------

template <int J>
__device__ __forceinline__ float get_lane(const float4& v) {
  if constexpr (J == 0) return v.x;
  else if constexpr (J == 1) return v.y;
  else if constexpr (J == 2) return v.z;
  else return v.w;
}

template <int J>
__device__ __forceinline__ void set_lane(float4& v, float f) {
  if constexpr (J == 0) v.x = f;
  else if constexpr (J == 1) v.y = f;
  else if constexpr (J == 2) v.z = f;
  else v.w = f;
}

template <class Body, int N, int M, int J>
__device__ __forceinline__ void body_lane(const float4 (&a)[N], float4 (&r)[M]) {
  float x[N], y[M];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = get_lane<J>(a[i]);
  Body()(x, y);
#pragma unroll
  for (int q = 0; q < M; ++q) set_lane<J>(r[q], y[q]);
}

template <class Body, int N, int M>
__device__ __forceinline__ void body4(const float4 (&a)[N], float4 (&r)[M]) {
  body_lane<Body, N, M, 0>(a, r);
  body_lane<Body, N, M, 1>(a, r);
  body_lane<Body, N, M, 2>(a, r);
  body_lane<Body, N, M, 3>(a, r);
}

// -- helpers of the generated bodies (ops/map_gen.py), each as torch computes
// its op on the card ------------------------------------------------------------

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float dsc_clamp(float x, float lo, float hi) {
  const float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// torch.minimum / maximum: NaN if either operand is NaN
__device__ __forceinline__ float dsc_minimum(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}

__device__ __forceinline__ float dsc_maximum(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}

// torch.sinc: 1 at 0, else sin(pi x) / (pi x)
__device__ __forceinline__ float dsc_sinc(float x) {
  const float px = x * 3.14159265358979323846f;
  return x == 0.f ? 1.f : sinf(px) / px;
}

// -- the kernel ---------------------------------------------------------------

template <class Body, int M, int... Ks, int... Is>
__device__ __forceinline__ void map_chunk(const Operands<sizeof...(Ks)>& in, const Outputs<M>& out,
                                          long long n, std::integer_sequence<int, Is...>) {
  constexpr int N = sizeof...(Ks);
  const long long groups = n >> 2;
  const long long g0 = blockIdx.x * (long long)kChunk + threadIdx.x;
  Slots<std::integer_sequence<int, Is...>, Ks...> s(in);
  (static_cast<Slot<Is, Ks>&>(s).seek(g0), ...);
  float4 v[kVec][N];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const long long g = g0 + k * kThreads;
    if (g < groups) ((v[k][Is] = load4<Ks>(static_cast<const Slot<Is, Ks>&>(s), g, k)), ...);
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const long long g = g0 + k * kThreads;
    if (g < groups) {
      float4 r[M];
      body4<Body, N, M>(v[k], r);
#pragma unroll
      for (int q = 0; q < M; ++q) reinterpret_cast<float4*>(out.ptr[q])[g] = r[q];
    }
  }
  const long long i = (groups << 2) + g0;  // the ragged tail, < 4 elements, block 0
  if (blockIdx.x == 0 && i < n) {
    float x[N], y[M];
    ((x[Is] = static_cast<const Slot<Is, Ks>&>(s).one(i)), ...);
    Body()(x, y);
#pragma unroll
    for (int q = 0; q < M; ++q) out.ptr[q][i] = y[q];
  }
}

template <class Body, int M, int... Ks>
__global__ void __launch_bounds__(kThreads)
map_kernel(const Operands<sizeof...(Ks)> in, const Outputs<M> out, long long n) {
  map_chunk<Body, M, Ks...>(in, out, n, std::make_integer_sequence<int, sizeof...(Ks)>());
}

// one block a chunk
template <class Body, int M, int... Ks>
cudaError_t launch_map(const Operands<sizeof...(Ks)>& in, const Outputs<M>& out, long long n,
                       cudaStream_t stream) {
  const long long chunks = (n / 4 + kChunk - 1) / kChunk;
  const int blocks = (int)(chunks < 1 ? 1 : chunks);
  map_kernel<Body, M, Ks...><<<blocks, kThreads, 0, stream>>>(in, out, n);
  return cudaGetLastError();
}

// the entry point of a generated source (K5g): operand i at in[i], a
// broadcast row of rows[i] elements where its kind is kB; outputs at out[q]
template <class Body, int M, int... Ks>
int launch_generated(const void* const* in, const int* rows, void* const* out, long long n,
                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Operands<sizeof...(Ks)> ops;
  for (int i = 0; i < (int)sizeof...(Ks); ++i)
    ops.op[i] = Operand{static_cast<const float*>(in[i]), 0.f, 0.f, rows[i]};
  Outputs<M> outs;
  for (int q = 0; q < M; ++q) outs.ptr[q] = static_cast<float*>(out[q]);
  return (int)launch_map<Body, M, Ks...>(ops, outs, n, (cudaStream_t)stream);
}

}  // namespace
