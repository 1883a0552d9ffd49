// K11: Hermitian spectrum reconstruction (fourier/reconstruct.py).
//
// Replaces dsc_tpu/fourier/pallas_reconstruct.py:_reconstruct_kernel: the
// full n-point spectrum of a real signal from its n/2+1 lower bins,
//   full[k] = x[k]            for k <= n/2
//   full[k] = conj(x[n - k])  for n/2 < k < n,
// which irfft hands to the inverse four-step. One thread per output value:
// the head is a copy, the tail reads backwards and writes forwards, and a
// warp's 32 reads of either kind fall in the same 256 contiguous bytes, so
// both are coalesced. The TPU kernel's exchange-matrix matmuls, 127-lane
// shift and 1024-aligned superset windows (Mosaic's reversal and DMA
// alignment workarounds) have no counterpart. full[n/2] = x[n/2] as given;
// the TPU kernel conjugates it, which changes nothing on a valid spectrum.
//
// Bound on the H100: device memory, 8*(n/2 + 1) bytes read and 8*n
// written (192 MiB at n = 2^24), no arithmetic but a sign flip.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
reconstruct_kernel(const float2* __restrict__ x, float2* __restrict__ full, long n) {
  const long k = (long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const long nh = n >> 1;
  if (k <= nh) {
    full[k] = x[k];
  } else {
    const float2 v = x[n - k];
    full[k] = make_float2(v.x, -v.y);
  }
}

}  // namespace

extern "C" {

// x: (n/2 + 1,) complex64 -> full: (n,) complex64
int dsc_reconstruct(const void* x, void* full, long long n, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  reconstruct_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (float2*)full, (long)n);
  return (int)cudaGetLastError();
}

}  // extern "C"
