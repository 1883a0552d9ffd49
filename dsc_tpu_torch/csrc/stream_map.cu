// K5: streaming elementwise map over float32 or interleaved complex64.
//
// Replaces dsc_tpu/ops/pallas_map.py:_map_kernel (reached through
// stream_map/stream_map_multi from ops/kernels.py _binary, _unary and clip,
// and from planar.py _pp_jit/_sp_jit for complex arithmetic). The TPU
// kernel streams (rows, 128) tiles HBM -> VMEM -> HBM with 2-8 static
// buffer sets and DMA semaphores, replicates broadcast rows in VMEM and
// keeps scalars in SMEM. None of that carries over: here every thread moves
// four floats (two complex values) at a time, straight from device memory to
// registers and back.
//
// Bound on the H100: device memory. Each body does 1-20 flops per 8-12
// bytes moved, far under the card's balance point: a 2^26-element add moves
// 768 MiB, a 2^26 sin or clip 512 MiB, a 2^23+1 complex multiply 192 MiB.
// The design moves each byte once with coalesced 16-byte loads and stores
// (float4), keeps a broadcast row in L1/L2 (row[i % M], M % 4 == 0), reads a
// 1-element tensor once per thread and takes a Python scalar by value. Each
// block takes one chunk of kUnroll x 256 float4 groups and each thread
// issues its kUnroll loads per operand before any arithmetic, so many loads
// are in flight; the grid has one block per chunk, so blocks balance across
// the SMs whatever a body's register count (a fixed grid-stride grid of
// eight blocks per SM ran in two uneven waves where only six fit, PERF.md).
// A ragged count ends in a scalar tail. One template instantiation per
// body, selected by op code.
//
// Launch contract: PyTorch's current stream, no synchronisation, no
// allocation; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // float4 groups per thread
constexpr long long kChunk = (long long)kThreads * kUnroll;

// operand kinds (ops/stream_map.py _FULL, _BROW, _VALUE, _POINTER)
enum Kind { kFull = 0, kBrow = 1, kValue = 2, kPointer = 3 };

// op codes: the order of ops/stream_map.py REAL_BODIES, then COMPLEX_BODIES
enum Body {
  kAdd = 0, kSub, kMul, kDiv, kSin, kCos, kExp, kLogn, kLog2, kLog10, kSqrt,
  kSinc, kClip, kCAdd, kCSub, kCMul, kCDiv
};

struct Operand {
  const float* ptr;  // full, brow or 1-element data; null for a value
  float re, im;      // a Python scalar
  int kind;
  int m;             // brow length in elements
};

struct Operands {
  Operand op[3];
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

// -- operand loads -----------------------------------------------------------

__device__ __forceinline__ float scalar_of(const Operand& o) {
  return o.kind == kPointer ? __ldg(o.ptr) : o.re;
}

// four consecutive elements from 4*g
__device__ __forceinline__ float4 load4(const Operand& o, float s, long long g) {
  if (o.kind == kFull) return __ldg(reinterpret_cast<const float4*>(o.ptr) + g);
  if (o.kind == kBrow) return __ldg(reinterpret_cast<const float4*>(o.ptr + (4 * g) % o.m));
  return make_float4(s, s, s, s);
}

__device__ __forceinline__ float load1(const Operand& o, float s, long long i) {
  if (o.kind == kFull) return __ldg(o.ptr + i);
  if (o.kind == kBrow) return __ldg(o.ptr + i % o.m);
  return s;
}

__device__ __forceinline__ float2 cscalar_of(const Operand& o) {
  return o.kind == kPointer ? __ldg(reinterpret_cast<const float2*>(o.ptr))
                            : make_float2(o.re, o.im);
}

// two consecutive complex values from 2*g (no brow: the wrapper refuses it)
__device__ __forceinline__ float4 cload2(const Operand& o, float2 s, long long g) {
  if (o.kind == kFull) return __ldg(reinterpret_cast<const float4*>(o.ptr) + g);
  return make_float4(s.x, s.y, s.x, s.y);
}

__device__ __forceinline__ float2 cload1(const Operand& o, float2 s, long long i) {
  if (o.kind == kFull) return __ldg(reinterpret_cast<const float2*>(o.ptr) + i);
  return s;
}

// -- the kernels -------------------------------------------------------------

template <int B>
__global__ void __launch_bounds__(kThreads)
real_map_kernel(Operands in, float* __restrict__ out, long long n) {
  const Operand &o0 = in.op[0], &o1 = in.op[1], &o2 = in.op[2];
  const float s0 = scalar_of(o0), s1 = scalar_of(o1), s2 = scalar_of(o2);
  const long long n4 = n >> 2;
  const long long g0 = blockIdx.x * kChunk + threadIdx.x;
  float4 a[kUnroll], b[kUnroll], c[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long g = g0 + k * kThreads;
    if (g < n4) {
      a[k] = load4(o0, s0, g);
      b[k] = load4(o1, s1, g);
      c[k] = load4(o2, s2, g);
    }
  }
  float4* out4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long g = g0 + k * kThreads;
    if (g < n4) {
      float4 r;
      r.x = real_body<B>(a[k].x, b[k].x, c[k].x);
      r.y = real_body<B>(a[k].y, b[k].y, c[k].y);
      r.z = real_body<B>(a[k].z, b[k].z, c[k].z);
      r.w = real_body<B>(a[k].w, b[k].w, c[k].w);
      out4[g] = r;
    }
  }
  const long long i = (n4 << 2) + g0;  // the ragged tail, < 4 elements, block 0
  if (blockIdx.x == 0 && i < n)
    out[i] = real_body<B>(load1(o0, s0, i), load1(o1, s1, i), load1(o2, s2, i));
}

template <int B>
__global__ void __launch_bounds__(kThreads)
complex_map_kernel(Operands in, float2* __restrict__ out, long long n) {
  const Operand &o0 = in.op[0], &o1 = in.op[1];
  const float2 s0 = cscalar_of(o0), s1 = cscalar_of(o1);
  const long long n2 = n >> 1;
  const long long g0 = blockIdx.x * kChunk + threadIdx.x;
  float4 a[kUnroll], b[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long g = g0 + k * kThreads;
    if (g < n2) {
      a[k] = cload2(o0, s0, g);
      b[k] = cload2(o1, s1, g);
    }
  }
  float4* out4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long g = g0 + k * kThreads;
    if (g < n2) {
      const float2 lo = complex_body<B>(make_float2(a[k].x, a[k].y), make_float2(b[k].x, b[k].y));
      const float2 hi = complex_body<B>(make_float2(a[k].z, a[k].w), make_float2(b[k].z, b[k].w));
      out4[g] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
  const long long i = (n2 << 1) + g0;  // an odd count's last value, block 0
  if (blockIdx.x == 0 && i < n) out[i] = complex_body<B>(cload1(o0, s0, i), cload1(o1, s1, i));
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
  if (n <= 0) return (int)cudaSuccess;
  Operands in;
  in.op[0] = Operand{(const float*)p0, re0, im0, kind0, m0};
  in.op[1] = Operand{(const float*)p1, re1, im1, kind1, m1};
  in.op[2] = Operand{(const float*)p2, re2, im2, kind2, m2};
  const long long vecs = body >= kCAdd ? n / 2 : n / 4;
  const long long chunks = (vecs + kChunk - 1) / kChunk;
  const int blocks = (int)(chunks < 1 ? 1 : chunks);
  cudaStream_t s = (cudaStream_t)stream;
  float* fo = (float*)out;
  float2* co = (float2*)out;
  switch (body) {
    case kAdd: real_map_kernel<kAdd><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kSub: real_map_kernel<kSub><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kMul: real_map_kernel<kMul><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kDiv: real_map_kernel<kDiv><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kSin: real_map_kernel<kSin><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kCos: real_map_kernel<kCos><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kExp: real_map_kernel<kExp><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kLogn: real_map_kernel<kLogn><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kLog2: real_map_kernel<kLog2><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kLog10: real_map_kernel<kLog10><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kSqrt: real_map_kernel<kSqrt><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kSinc: real_map_kernel<kSinc><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kClip: real_map_kernel<kClip><<<blocks, kThreads, 0, s>>>(in, fo, n); break;
    case kCAdd: complex_map_kernel<kCAdd><<<blocks, kThreads, 0, s>>>(in, co, n); break;
    case kCSub: complex_map_kernel<kCSub><<<blocks, kThreads, 0, s>>>(in, co, n); break;
    case kCMul: complex_map_kernel<kCMul><<<blocks, kThreads, 0, s>>>(in, co, n); break;
    case kCDiv: complex_map_kernel<kCDiv><<<blocks, kThreads, 0, s>>>(in, co, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
