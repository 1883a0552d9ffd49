"""FFT routing (dsc_tpu/fourier/config.py and the route choices of
fourier/__init__.py and core.py).

Which engine serves a transform is the same function of (size, dtype,
batch, axis) as in the JAX package on the TPU. The device enters only
where the JAX package would reach a TPU kernel that is not ported yet:
on a CUDA tensor that route raises ``NotImplementedError`` naming the
kernel, and on a CPU tensor it takes the plain core path, as the JAX
package does off the TPU. Routes whose kernels are ported (K1-K4, K12)
are taken on both devices; their wrappers pick the kernel or its plain
version by the tensor's device. The JAX package's DSC_FFT_* knobs are TPU
experiment switches and are not carried over.
"""

from __future__ import annotations

import numpy as np

from ..dtype import Dtype
from . import stream
from .plan import RFFT_PACK_MAX

# base-case kernel K12 sizes (dsc_tpu config.py:20-21)
BASE_KERNEL_MIN_N = 256
BASE_KERNEL_MAX_N = 4096

# largest batch*n the streaming kernels take (dsc_tpu config.py:92)
STREAM_MAX_ELEMS = 2**27

# Hermitian reconstruction kernel K11 serves single rows with
# n/2 a multiple of two 2^16-element chunks (pallas_reconstruct.py:205)
RECONSTRUCT_CHUNK = 2**16


def use_base_kernel(dtype, n: int) -> bool:
    """K12 serves complex64 base cases of 256..4096 points
    (dsc_tpu config.use_pallas)."""
    return (np.dtype(dtype) == np.complex64
            and BASE_KERNEL_MIN_N <= n <= BASE_KERNEL_MAX_N)


def use_stream(batch: int, n: int) -> bool:
    """The two-pass streaming engine's size rule for complex64 work
    (dsc_tpu config.use_stream)."""
    if batch < 1 or n & (n - 1) or batch * n > STREAM_MAX_ELEMS:
        return False
    n1, n2 = stream.factors(n)
    return stream.supported(n1, n2, np.complex64, batch)


def use_packed(n: int) -> bool:
    """The packed half-size real FFT (K1-K4) takes this single-vector
    size (dsc_tpu config.packed_impl == 'fused')."""
    from . import packed_fused

    return use_stream(1, n) and packed_fused.supported(*stream.factors(n))


def _unported(device_type: str, kernels: str, what: str) -> str:
    if device_type == 'cuda':
        raise NotImplementedError(
            f'{what} on CUDA runs TPU kernel {kernels} in the JAX package, '
            'which is not ported yet (ROADMAP.md, queue 2)')
    return 'core'


def rfft_route(device_type: str, dtype: Dtype, batch: int, n: int) -> str:
    """'packed' (K1+K2) or 'core' for an n-point rfft over ``batch`` rows."""
    if dtype == Dtype.F32 and use_stream(batch, n):
        if batch == 1:
            if use_packed(n):
                return 'packed'
            return _unported(device_type, 'K6/K8', f'single-vector rfft n={n}')
        return _unported(device_type, 'K6/K7', f'batched rfft n={n}')
    return 'core'


def irfft_route(device_type: str, dtype: Dtype, batch: int, n: int) -> str:
    """'packed' (K3+K4) or 'core' for an n-point irfft over ``batch`` rows."""
    if dtype == Dtype.C32 and use_stream(batch, n):
        if batch == 1:
            if use_packed(n):
                return 'packed'
            return _unported(device_type, 'K9/K10', f'single-vector irfft n={n}')
        return _unported(device_type, 'K6/K7', f'batched irfft n={n}')
    nh = n // 2
    if (n > RFFT_PACK_MAX and batch == 1 and nh % RECONSTRUCT_CHUNK == 0
            and nh // RECONSTRUCT_CHUNK >= 2):
        return _unported(device_type, 'K11', f'irfft n={n} ({dtype})')
    return 'core'


def fft_route(device_type: str, dtype: Dtype, batch: int, n: int,
              inverse: bool) -> str:
    """'core' for an n-point fft/ifft over ``batch`` rows, or raise."""
    if dtype in (Dtype.F32, Dtype.C32) and use_stream(batch, n):
        kernels = 'K6/K8' if batch == 1 and not inverse else 'K6/K7'
        name = 'ifft' if inverse else 'fft'
        return _unported(device_type, kernels, f'{name} n={n} batch={batch}')
    return 'core'
