"""FFT routing (dsc_tpu/fourier/config.py and the route choices of
fourier/__init__.py and core.py).

Which engine serves a transform is the same function of (size, dtype,
batch, ``out``, the input's layout) as in the JAX package on the TPU; the
axis enters only through the batch (a non-last axis streams as a batch).
The public functions take their streaming branches only without ``out=``;
with it they go through the core (core.fft_nd and its kin), which streams
by size alone (``core_streams``), as the JAX core does. Routes:

- 'packed'  single-vector float32 rfft / complex64 irfft, K1+K2 / K3+K4;
- 'stream_t'  one vector into or out of the T layout (stream_t.py): the
            forward fft of a natural-order vector, K6+K8; the rfft where
            the packed engine does not apply, K6+K8 into the half-T
            layout; the ifft of a T-layout spectrum and the irfft of a
            half-T one, K9+K10;
- 'stream'  K6+K7 through the core (an irfft reconstructs its spectrum
            plainly first);
- 'reconstruct+stream'  a single complex64 irfft row: K11, then K6+K7;
- 'core'    the batched core (core.py) with no streaming.

The public functions pass the route to the core, which streams on
'stream' and 'reconstruct+stream' and nowhere else; a direct call to the
core decides by ``core_streams``. Which engine the core runs on a batch of
rows is ``batched_engine``'s answer, and no other code's.

Neither rule reads the device: on a CPU tensor every kernel wrapper runs
its plain version, on a CUDA tensor it launches its kernel.
The JAX package's DSC_FFT_* knobs are TPU experiment switches and are not
carried over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..dtype import Dtype
from . import stream
from .plan import BASE_MAX, RFFT_PACK_MAX

# base-case kernel K12 sizes (dsc_tpu config.py:20-21); the largest is the
# plan's leaf size, so that K12 serves every complex64 leaf of a plan
BASE_KERNEL_MIN_N = 256
BASE_KERNEL_MAX_N = BASE_MAX

# largest batch*n the streaming kernels take (dsc_tpu config.py:92)
STREAM_MAX_ELEMS = 2**27

# a spectrum's T layout: (n1, n2, half) (stream_t.py)
Layout = Tuple[int, int, bool]


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


def core_streams(batch: int, n: int, real: bool = False) -> bool:
    """The core's own stream rule for float32/complex64 rows: the streaming
    size range, where a real transform's 'real' plan keeps its half-size
    path up to RFFT_PACK_MAX. ``batched_engine`` applies it to direct calls
    into the core; the route functions apply it with ``out=``."""
    return use_stream(batch, n) and not (real and n <= RFFT_PACK_MAX)


def batched_engine(kind: str, dtype: torch.dtype, batch: int, n: int,
                   streams: Optional[bool] = None) -> str:
    """The engine of an n-point 'c2c', 'r2c' or 'c2r' transform (core.py
    fft_batched, rfft_batched, irfft_batched) of ``batch`` rows of ``dtype``:
    'stream' (K6+K7) where ``streams`` says so, or when it is None on
    float32/complex64 rows that ``core_streams`` takes, as in
    dsc_tpu core._stream_ok; 'base', one K12r ('r2c', float32 rows) or K12ir
    ('c2r', complex64 half spectra) launch, where the packed half-size
    transform is a K12 base case; else 'plain', the core's own path."""
    if streams is None:
        streams = (dtype in (torch.float32, torch.complex64)
                   and core_streams(batch, n, kind != 'c2c'))
    if streams:
        return 'stream'
    if ((kind, dtype) in (('r2c', torch.float32), ('c2r', torch.complex64))
            and 1 < n <= RFFT_PACK_MAX and use_base_kernel(np.complex64, n // 2)):
        return 'base'
    return 'plain'


def use_packed(n: int) -> bool:
    """The packed half-size real FFT (K1-K4) takes this single-vector
    size (dsc_tpu config.packed_impl == 'fused')."""
    from . import packed_fused

    return use_stream(1, n) and packed_fused.supported(*stream.factors(n))


def fft_route(dtype: Dtype, batch: int, n: int, inverse: bool, out: bool = False,
              layout: Optional[Layout] = None) -> str:
    """'stream_t', 'stream' or 'core' for an n-point fft/ifft over
    ``batch`` rows; ``out``: the call has ``out=``; ``layout``: the T
    layout (n1, n2, half) the input is stored in, None for natural order
    (dsc_tpu fourier/__init__.py:146-188: a forward single vector lands in
    the T layout, an ifft of a full-T spectrum reads it; any other input in
    a T layout is read in natural order)."""
    if dtype not in (Dtype.F32, Dtype.C32) or not use_stream(batch, n):
        return 'core'
    if batch == 1 and not out:
        if inverse and layout == (*stream.factors(n), False):
            return 'stream_t'
        if not inverse and layout is None:
            return 'stream_t'
    return 'stream'


def rfft_route(dtype: Dtype, batch: int, n: int, out: bool = False) -> str:
    """'packed', 'stream_t', 'stream' or 'core' for an n-point rfft over
    ``batch`` rows. With ``out=`` the core's rule decides (dsc_tpu
    core.rfft_batched_p)."""
    if dtype != Dtype.F32 or not use_stream(batch, n):
        return 'core'
    if out:
        return 'stream' if core_streams(batch, n, real=True) else 'core'
    if batch > 1:
        return 'stream'
    if use_packed(n):
        return 'packed'
    return 'stream_t'


def irfft_route(dtype: Dtype, batch: int, n: int, out: bool = False,
                layout: Optional[Layout] = None) -> str:
    """'stream_t', 'packed', 'stream', 'reconstruct+stream' or 'core' for
    an n-point irfft over ``batch`` rows. A half-T spectrum of this n takes
    K9+K10; a single row off the packed route is a dense spectrum to the
    JAX package (dsc_tpu core.irfft_batched_p): K11, then K6+K7. With
    ``out=`` the core's rule decides."""
    if dtype != Dtype.C32 or not use_stream(batch, n):
        return 'core'
    if out and not core_streams(batch, n, real=True):
        return 'core'
    if batch > 1:
        return 'stream'
    if not out and layout == (*stream.factors(n), True):
        return 'stream_t'
    if use_packed(n) and not out:
        return 'packed'
    return 'reconstruct+stream'
