// K5: streaming elementwise map over float32 or interleaved complex64.
//
// Replaces dsc_tpu/ops/pallas_map.py:_map_kernel (reached through
// stream_map/stream_map_multi from ops/kernels.py _binary, _unary and clip,
// and from planar.py _pp_jit/_sp_jit for complex arithmetic). The TPU
// kernel streams (rows, 128) tiles HBM -> VMEM -> HBM with 2-8 static
// buffer sets and DMA semaphores, replicates broadcast rows in VMEM and
// keeps scalars in SMEM.
//
// Bound on the H100: device memory. Each body does 1-20 flops per 8-12
// bytes moved, far under the card's balance point: a 2^26-element add moves
// 768 MiB, a 2^26 sin or clip 512 MiB, a 2^23+1 complex multiply 192 MiB,
// 10-15 times the 50 MB L2, each byte touched once.
//
// The design: one instantiation per body and operand kinds (full, broadcast
// row, scalar), chosen at compile time, on the skeleton of stream_map.cuh,
// which the generated bodies of dsc.map (K5g) share: a scalar is one
// register, read once per thread (a Python scalar by value, a 1-element
// tensor by one load); a broadcast row is read through L1/L2; each block
// takes one chunk of kVec x 256 float4 groups (8 KB an operand), and each
// thread issues its kVec 16-byte loads per streamed operand before any
// arithmetic, so up to 2048 threads an SM keep loads in flight; one block
// a chunk balances the blocks across the SMs whatever a body's register
// count (a fixed grid of eight blocks per SM ran in two uneven waves where
// only six fit). A ragged count (n % 4 floats, an odd number of complex
// values) ends in plain loads. The complex bodies run their own kernel
// (cmap_kernel) on the same chunking. Measured
// against this design on the H100 (PERF.md): 16 KB a block was 0.6-1.7%
// slower; the streaming cache hints (ld/st.global.cs) were no faster, and
// up to 3% slower with two streamed inputs; the TPU kernel's buffer sets
// carried over as a shared-memory ring filled by bulk copies (TMA) on a
// persistent grid ran 3-6% slower at every case. None is used.
//
// Launch contract: PyTorch's current stream, no synchronisation, no
// allocation; the entry point returns cudaGetLastError(), and
// cudaErrorInvalidValue for a body or a combination of kinds it has no
// instantiation for.

#include <math.h>

#include "stream_map.cuh"

namespace {

// operand kinds as the host passes them (ops/stream_map.py _FULL, _BROW,
// _VALUE, _POINTER)
enum HostKind { kFull = 0, kBrow = 1, kValue = 2, kPointer = 3 };

// op codes: the order of ops/stream_map.py REAL_BODIES, then COMPLEX_BODIES
enum Body {
  kAdd = 0, kSub, kMul, kDiv, kSin, kCos, kExp, kLogn, kLog2, kLog10, kSqrt,
  kSinc, kClip, kCAdd, kCSub, kCMul, kCDiv, kBodies
};

// -- the bodies --------------------------------------------------------------

// fast f32 sin/cos (dsc_tpu/ops/kernels.py:217-264): Cody-Waite reduction
// with a 4-part pi, then a degree-9 odd minimax polynomial
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kPi1 = 3.140625f;
constexpr float kPi2 = 0.0009670257568359375f;
constexpr float kPi3 = 6.2771141e-07f;
constexpr float kPi4 = 1.2154201e-10f;
constexpr float kS0 = 0.9999999946625908f;
constexpr float kS1 = -0.16666656657956302f;
constexpr float kS2 = 0.008333024646433733f;
constexpr float kS3 = -0.00019807388155308192f;
constexpr float kS4 = 2.601842986663649e-06f;

__device__ __forceinline__ float sin_reduced(float r) {
  const float r2 = r * r;
  float p = r2 * kS4 + kS3;
  p = p * r2 + kS2;
  p = p * r2 + kS1;
  p = p * r2 + kS0;
  return r * p;
}

__device__ __forceinline__ float fast_sin(float x) {
  const float k = rintf(x * kInvPi);
  float r = x;
  r = r - k * kPi1;
  r = r - k * kPi2;
  r = r - k * kPi3;
  r = r - k * kPi4;
  const float s = sin_reduced(r);
  return ((int)k & 1) ? -s : s;
}

__device__ __forceinline__ float fast_cos(float x) {
  // cos(x) = sin(x + pi/2) against the half-integer grid j = k - 1/2
  const float k = rintf(x * kInvPi + 0.5f);
  const float j = k - 0.5f;
  float r = x;
  r = r - j * kPi1;
  r = r - j * kPi2;
  r = r - j * kPi3;
  r = r - j * kPi4;
  const float s = sin_reduced(r);
  return ((int)k & 1) ? -s : s;
}

template <int B>
__device__ __forceinline__ float real_body(float a, float b, float c) {
  if constexpr (B == kAdd) return a + b;
  if constexpr (B == kSub) return a - b;
  if constexpr (B == kMul) return a * b;
  if constexpr (B == kDiv) return a / b;
  if constexpr (B == kSin) return fast_sin(a);
  if constexpr (B == kCos) return fast_cos(a);
  if constexpr (B == kExp) return expf(a);
  if constexpr (B == kLogn) return logf(a);
  if constexpr (B == kLog2) return log2f(a);
  if constexpr (B == kLog10) return log10f(a);
  if constexpr (B == kSqrt) return sqrtf(a);
  if constexpr (B == kSinc) {
    const float px = a * kPi;
    return a == 0.f ? 1.f : sinf(px) / px;
  }
  if constexpr (B == kClip) {
    const float y = a < b ? b : a;
    return y > c ? c : y;
  }
  return 0.f;
}

template <int B>
__device__ __forceinline__ float2 complex_body(float2 a, float2 b) {
  if constexpr (B == kCAdd) return make_float2(a.x + b.x, a.y + b.y);
  if constexpr (B == kCSub) return make_float2(a.x - b.x, a.y - b.y);
  if constexpr (B == kCMul) return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
  if constexpr (B == kCDiv) {
    const float d = b.x * b.x + b.y * b.y;
    return make_float2((a.x * b.x + a.y * b.y) / d, (a.y * b.x - a.x * b.y) / d);
  }
  return make_float2(0.f, 0.f);
}

// a real body as the skeleton's functor: the operands the body takes
template <int B>
struct RealBody {
  template <int N>
  __device__ __forceinline__ void operator()(const float (&a)[N], float (&o)[1]) const {
    if constexpr (N == 1) o[0] = real_body<B>(a[0], 0.f, 0.f);
    else if constexpr (N == 2) o[0] = real_body<B>(a[0], a[1], 0.f);
    else o[0] = real_body<B>(a[0], a[1], a[2]);
  }
};

// two complex values a float4
template <int B>
__device__ __forceinline__ float4 complex_body2(float4 a, float4 b) {
  const float2 lo = complex_body<B>(make_float2(a.x, a.y), make_float2(b.x, b.y));
  const float2 hi = complex_body<B>(make_float2(a.z, a.w), make_float2(b.z, b.w));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// -- complex operands as a thread holds them ----------------------------------

template <int K>
struct Cplx;

template <>
struct Cplx<kF> {
  const float2* p;
  __device__ explicit Cplx(const Operand& o) : p(reinterpret_cast<const float2*>(o.ptr)) {}
  __device__ float2 one(long long i) const { return __ldg(p + i); }
};

template <>
struct Cplx<kS> {
  float2 s;
  __device__ explicit Cplx(const Operand& o)
      : s(o.ptr ? __ldg(reinterpret_cast<const float2*>(o.ptr)) : make_float2(o.re, o.im)) {}
  __device__ float4 at(int) const { return make_float4(s.x, s.y, s.x, s.y); }
  __device__ float2 one(long long) const { return s; }
};

// -- the complex kernel --------------------------------------------------------

template <int B, int K0, int K1>
__global__ void __launch_bounds__(kThreads)
cmap_kernel(const Operands<2> in, float2* __restrict__ out, long long n) {
  const long long groups = n >> 1;  // two complex values a float4
  const long long g0 = blockIdx.x * (long long)kChunk + threadIdx.x;
  Cplx<K0> o0(in.op[0]);
  Cplx<K1> o1(in.op[1]);
  float4 a[kVec], b[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const long long g = g0 + k * kThreads;
    if (g < groups) {
      a[k] = load4<K0>(o0, g, k);
      b[k] = load4<K1>(o1, g, k);
    }
  }
  float4* out4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const long long g = g0 + k * kThreads;
    if (g < groups) out4[g] = complex_body2<B>(a[k], b[k]);
  }
  const long long i = groups << 1;  // an odd count's last value, block 0
  if (blockIdx.x == 0 && threadIdx.x == 0 && i < n) out[i] = complex_body<B>(o0.one(i), o1.one(i));
}

// -- dispatch ----------------------------------------------------------------

constexpr int arity(int b) { return b >= kCAdd ? 2 : b == kClip ? 3 : b >= kSin ? 1 : 2; }

// the kind combinations ops/stream_map.py's _layout admits (INSTANTIATIONS there)
template <int B, int... Ks>
constexpr bool admitted() {
  constexpr int k[] = {Ks...};
  if constexpr (B >= kCAdd)
    return (k[0] == kF && (k[1] == kF || k[1] == kS)) || (k[0] == kS && k[1] == kF);
  else if constexpr (arity(B) == 1)
    return k[0] == kF;
  else if constexpr (arity(B) == 2)
    return k[0] == kF || (k[1] == kF && (k[0] == kS || k[0] == kB));
  else
    return k[0] == kF || k[1] == kF || k[2] == kF;
}

struct Launch {
  Operand op[3];
  int kind[3];
  void* out;
  long long n;
  cudaStream_t stream;
};

// one block a chunk
template <int B, int... Ks>
cudaError_t run(const Launch& l) {
  Operands<sizeof...(Ks)> in;
  for (int i = 0; i < (int)sizeof...(Ks); ++i) in.op[i] = l.op[i];
  if constexpr (B >= kCAdd) {
    const long long chunks = (l.n / 2 + kChunk - 1) / kChunk;
    const int blocks = (int)(chunks < 1 ? 1 : chunks);
    cmap_kernel<B, Ks...><<<blocks, kThreads, 0, l.stream>>>(in, (float2*)l.out, l.n);
    return cudaGetLastError();
  } else {
    return launch_map<RealBody<B>, 1, Ks...>(in, Outputs<1>{{(float*)l.out}}, l.n, l.stream);
  }
}

// the host kinds of the operands a body takes, resolved one by one into
// template arguments; only admitted combinations are instantiated
template <int B, int... Ks>
cudaError_t pick_kinds(const Launch& l) {
  constexpr int i = sizeof...(Ks);
  if constexpr (i == arity(B)) {
    if constexpr (admitted<B, Ks...>()) return run<B, Ks...>(l);
    else return cudaErrorInvalidValue;
  } else {
    switch (l.kind[i]) {
      case kFull: return pick_kinds<B, Ks..., kF>(l);
      case kBrow: return pick_kinds<B, Ks..., kB>(l);
      case kValue:
      case kPointer: return pick_kinds<B, Ks..., kS>(l);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <int... Bs>
cudaError_t pick_body(int body, const Launch& l, std::integer_sequence<int, Bs...>) {
  cudaError_t err = cudaErrorInvalidValue;
  ((body == Bs ? (err = pick_kinds<Bs>(l), 0) : 0), ...);
  return err;
}

}  // namespace

extern "C" {

// body: op code; per operand: data pointer, scalar value (re, im), kind,
// brow length; out: n elements of float32 (real bodies) or complex64.
int dsc_stream_map(int body,
                   const void* p0, float re0, float im0, int kind0, int m0,
                   const void* p1, float re1, float im1, int kind1, int m1,
                   const void* p2, float re2, float im2, int kind2, int m2,
                   void* out, long long n, void* stream) {
  if (body < 0 || body >= kBodies) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  Launch l;
  l.op[0] = Operand{kind0 == kValue ? nullptr : (const float*)p0, re0, im0, m0};
  l.op[1] = Operand{kind1 == kValue ? nullptr : (const float*)p1, re1, im1, m1};
  l.op[2] = Operand{kind2 == kValue ? nullptr : (const float*)p2, re2, im2, m2};
  l.kind[0] = kind0;
  l.kind[1] = kind1;
  l.kind[2] = kind2;
  l.out = out;
  l.n = n;
  l.stream = (cudaStream_t)stream;
  return (int)pick_body(body, l, std::make_integer_sequence<int, kBodies>());
}

}  // extern "C"
