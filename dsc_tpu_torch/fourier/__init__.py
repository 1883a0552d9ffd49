"""Public FFT API for dsc_tpu_torch (dsc_tpu/fourier/__init__.py).

The reference FFT surface (dsc.h:384-424, dsc/src/dsc.cpp:1955-2340):

- fft/ifft/rfft/irfft over any axis of a rank<=4 tensor
- sizes rounded UP to the next power of two with pad/crop of the input
  (dsc.cpp:2023-2028)
- rfft shape rules: out_n = n/2 + 1 forward, 2*(n-1) inverse
  (dsc.cpp:2188-2201)
- fftfreq/rfftfreq generators matching np.fft incl. odd n
  (dsc.cpp:2262-2340)
- a bounded LRU plan cache warmed by plan_fft (dsc.cpp:182-267)
- fft2/ifft2/rfft2/irfft2 composed from the 1-D calls, as in the JAX
  package

Engines (config.py): single-vector float32 rfft/irfft of 2^20..2^26
points run the packed real FFT (K1-K4, packed_fused.py), whose spectrum is
a natural-order (n/2+1,) complex tensor. A single vector in the streaming
range (2^18..2^26) otherwise goes into and out of the T layout
(stream_t.py): its forward fft returns a spectrum stored in the T layout
(K6+K8), its rfft at 2^18 and 2^19 one in the half-T layout, and the
ifft/irfft of such a spectrum reads it in place (K9+K10). Other
float32/complex64 transforms in the streaming range run the natural
two-pass four-step (K6+K7, stream.py): batches over any axis, the ifft of
a natural-order vector, the irfft of a dense single spectrum at 2^18 and
2^19 after the Hermitian reconstruction (K11, reconstruct.py), and every
such call with ``out=``. Everything else runs the plain core (core.py)
with K12 at complex64 base cases.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..dtype import DTYPE_TO_NP, Dtype
from ..interop import TORCH_DTYPE
from ..tensor import Tensor, _finish, from_numpy
from . import config, core, packed_fused, plan, stream
from .plan import next_pow2

__all__ = ['fft', 'ifft', 'rfft', 'irfft', 'fft2', 'ifft2', 'rfft2', 'irfft2', 'fftfreq',
           'rfftfreq', 'plan_fft']


def plan_fft(n: int, dtype: Dtype = Dtype.F64, fft_type: str = 'complex'):
    """Warm the plan cache for an n-point transform (reference dsc_plan_fft)."""
    cdtype = torch.complex128 if dtype in (Dtype.F64, Dtype.C64) else torch.complex64
    plan.get_plan(next_pow2(n), fft_type, cdtype)


def _resolve_axis(x: Tensor, axis: int) -> int:
    ax = axis + x.n_dim if axis < 0 else axis
    if ax < 0 or ax >= x.n_dim:
        raise RuntimeError(f'axis {axis} is out of bounds for a {x.n_dim}-D tensor')
    return ax


def _batch(x: Tensor, ax: int) -> int:
    return x.ne // x.shape[ax]


def _out_shape(x: Tensor, ax: int, out_n: int):
    return tuple(out_n if i == ax else d for i, d in enumerate(x.shape))


def _t_result(storage, x: Tensor, ax: int, out_n: int, n: int, half: bool) -> Tensor:
    """A spectrum in the T layout, viewed in the input's shape with the
    transform axis ``out_n`` long (dsc_tpu fourier._planar_fft_result_t)."""
    t = Tensor._from_t(storage, *stream.factors(n), half)
    want = _out_shape(x, ax, out_n)
    return t if t.shape == want else Tensor._view_of(t, want)


def _core_plan(route: str, n: int, fft_type: str, cdtype):
    """The plain core's (spec, tables) on the 'core' route; a streaming
    route needs none (K6+K7 take the 'stream' plan)."""
    return plan.get_plan(n, fft_type, cdtype) if route == 'core' else (None, None)


def fft(x: Tensor, out: Optional[Tensor] = None, n: int = -1, axis: int = -1) -> Tensor:
    return _fft_like(x, out, n, axis, inverse=False)


def ifft(x: Tensor, out: Optional[Tensor] = None, n: int = -1, axis: int = -1) -> Tensor:
    return _fft_like(x, out, n, axis, inverse=True)


def _fft_like(x: Tensor, out, n: int, axis: int, inverse: bool) -> Tensor:
    ax = _resolve_axis(x, axis)
    nn = next_pow2(n) if n > 0 else next_pow2(x.shape[ax])
    route = config.fft_route(x.dtype, _batch(x, ax), nn, inverse, out is not None,
                             x._layout)
    with tracing.trace_op('ifft' if inverse else 'fft', 'op;fft',
                          tracing.tensor_args(x=x)):
        if route == 'stream_t' and inverse:
            res = core.ifft_stream_from_t(x._stored, *stream.factors(nn)).reshape(
                _out_shape(x, ax, nn))
        elif route == 'stream_t':
            return _t_result(core.fft_stream_t(x.torch, *stream.factors(nn)), x, ax, nn,
                             nn, False)
        else:
            cdt = TORCH_DTYPE[x.dtype.as_complex]
            spec, tables = _core_plan(route, nn, 'complex', cdt)
            res = core.fft_nd(x.torch, tables, spec, nn, ax, inverse, cdt, route != 'core')
    return _finish(res, out)


def rfft(x: Tensor, out: Optional[Tensor] = None, n: int = -1, axis: int = -1) -> Tensor:
    if not x.dtype.is_real:
        raise RuntimeError('RFFT input must be real')
    ax = _resolve_axis(x, axis)
    # fft_order = pow2(n or x_n) >> 1; out_n = fft_order + 1
    # (reference dsc.cpp:2194-2197)
    full_n = next_pow2(n) if n > 0 else next_pow2(x.shape[ax])
    data = x.torch
    route = config.rfft_route(x.dtype, _batch(x, ax), full_n, out is not None)
    with tracing.trace_op('rfft', 'op;fft', tracing.tensor_args(x=x)):
        if route == 'stream_t':
            return _t_result(core.rfft_stream_half_t(data, *stream.factors(full_n)), x, ax,
                             full_n // 2 + 1, full_n, True)
        if route == 'packed':
            _, tables = plan.get_plan(full_n, 'packed', torch.complex64)
            # K1 reads the unpadded signal (a crop is a view) and zeros
            # what lies past its end
            res = packed_fused.rfft_packed(data.reshape(-1)[:full_n], tables).reshape(
                _out_shape(x, ax, full_n // 2 + 1))
        else:
            spec, tables = _core_plan(route, full_n, 'real', TORCH_DTYPE[x.dtype.as_complex])
            res = core.rfft_nd(data, tables, spec, full_n, ax, route != 'core')
    return _finish(res, out)


def irfft(x: Tensor, out: Optional[Tensor] = None, n: int = -1, axis: int = -1) -> Tensor:
    if not x.dtype.is_complex:
        raise RuntimeError('IRFFT input must be complex')
    ax = _resolve_axis(x, axis)
    # fft_order = pow2(n-1 or x_n-1); out_n = 2 * fft_order
    # (reference dsc.cpp:2198-2201)
    full_n = 2 * (next_pow2(n - 1) if n > 0 else next_pow2(x.shape[ax] - 1))
    route = config.irfft_route(x.dtype, _batch(x, ax), full_n, out is not None, x._layout)
    with tracing.trace_op('irfft', 'op;fft', tracing.tensor_args(x=x)):
        if route == 'stream_t':
            res = core.irfft_stream_from_half_t(x._stored, *stream.factors(full_n)).reshape(
                _out_shape(x, ax, full_n))
        elif route == 'packed':
            _, tables = plan.get_plan(full_n, 'packed', torch.complex64)
            spec = core._pad_crop(x.torch.reshape(-1), full_n // 2 + 1).contiguous()
            res = packed_fused.irfft_packed(spec, tables).reshape(
                _out_shape(x, ax, full_n))
        else:
            cdt = TORCH_DTYPE[x.dtype]
            spec, tables = _core_plan(route, full_n, 'real', cdt)
            res = core.irfft_nd(x.torch, tables, spec, full_n, ax, cdt, route != 'core')
    return _finish(res, out)


def fftfreq(n: int, d: float = 1.0, dtype: Dtype = Dtype.F32) -> Tensor:
    """np.fft.fftfreq-compatible (reference dsc.cpp:2262-2302)."""
    if n <= 0:
        raise RuntimeError('n must be > 0')
    if dtype.is_complex:
        raise RuntimeError('fftfreq dtype must be real')
    factor = 1.0 / (n * d)
    odd = n & 1
    n2 = (n - 1) // 2 if odd else n // 2
    head = np.arange(0, n2 + odd, dtype=np.float64)
    tail = np.arange(-n2, 0, dtype=np.float64)
    vals = (np.concatenate([head, tail]) * factor).astype(DTYPE_TO_NP[dtype])
    return from_numpy(vals)


def rfftfreq(n: int, d: float = 1.0, dtype: Dtype = Dtype.F32) -> Tensor:
    """np.fft.rfftfreq-compatible (reference dsc.cpp:2304-2340)."""
    if n <= 0:
        raise RuntimeError('n must be > 0')
    if dtype.is_complex:
        raise RuntimeError('rfftfreq dtype must be real')
    factor = 1.0 / (n * d)
    n2 = ((n - 1) // 2 + 1) if (n & 1) else (n // 2 + 1)
    vals = (np.arange(n2, dtype=np.float64) * factor).astype(DTYPE_TO_NP[dtype])
    return from_numpy(vals)


def _axes2(x: Tensor, axes) -> tuple:
    a0, a1 = (_resolve_axis(x, a) for a in axes)
    if a0 == a1:
        raise RuntimeError(f'fft2 axes must be distinct, got {axes}')
    return a0, a1


def fft2(x: Tensor, s=(-1, -1), axes=(-2, -1)) -> Tensor:
    """2-D complex FFT: the 1-D fft over each axis, the last one first
    (np.fft.fft2 semantics, each size rounded up to a power of two)."""
    a0, a1 = _axes2(x, axes)
    return fft(fft(x, n=s[1], axis=a1), n=s[0], axis=a0)


def ifft2(x: Tensor, s=(-1, -1), axes=(-2, -1)) -> Tensor:
    """2-D inverse complex FFT (np.fft.ifft2 semantics + pow2 rule)."""
    a0, a1 = _axes2(x, axes)
    return ifft(ifft(x, n=s[1], axis=a1), n=s[0], axis=a0)


def rfft2(x: Tensor, s=(-1, -1), axes=(-2, -1)) -> Tensor:
    """2-D real FFT: rfft over the last transform axis, complex fft over
    the other (np.fft.rfft2 semantics + pow2 rule)."""
    a0, a1 = _axes2(x, axes)
    return fft(rfft(x, n=s[1], axis=a1), n=s[0], axis=a0)


def irfft2(x: Tensor, s=(-1, -1), axes=(-2, -1)) -> Tensor:
    """2-D inverse real FFT (np.fft.irfft2 semantics + pow2 rule): inverse
    complex over the first axis, Hermitian inverse over the last."""
    a0, a1 = _axes2(x, axes)
    return irfft(ifft(x, n=s[0], axis=a0), n=s[1], axis=a1)
