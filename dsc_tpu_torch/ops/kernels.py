"""Elementwise compute for the dsc_tpu_torch op set (dsc_tpu/ops/kernels.py).

Each function takes torch tensors (and Python scalars) already in the
result dtype and returns a torch tensor. Where the JAX package streams an
op through its TPU kernel K5, the port calls ``stream_map`` (kernel on a
CUDA tensor, plain version on a CPU tensor): float32 ops that
``stream_map.route`` admits, and complex64 add/sub/mul/div that
``stream_map.route_complex`` admits, each op classifying its operands once.
Everything the JAX package leaves to XLA is plain PyTorch on both devices.

Semantics kept from the reference (SURVEY Appendix B):

- complex transcendentals are explicit formulas on the real and imaginary
  parts, with the reference's naive magnitude re*re + im*im and NumPy's
  branch cuts (signbit, so a -0 imaginary part picks the lower branch);
- complex pow special-cases zero bases to NumPy's values;
- clip compares complex values by their real part, the bound replacing the
  whole value; max/min of complex values are lexicographic;
- mean is sum * (1/n).
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch

from .. import tracing
from . import stream_map as sm

# ---------------------------------------------------------------------------
# binary ops (reference dsc.cpp:1186-1310)
# ---------------------------------------------------------------------------

_PLAIN_BINARY = {
    'add': operator.add,
    'sub': operator.sub,
    'mul': operator.mul,
    'div': operator.truediv,
}


def _shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else None


def _dtype_of(a, b) -> torch.dtype:
    return a.dtype if isinstance(a, torch.Tensor) else b.dtype


def _route(name: str, a, b):
    """The (shape, kinds) K5 takes ``a <name> b`` with (operands in the
    result dtype), or None where the op is plain torch."""
    if name not in _PLAIN_BINARY:
        return None
    dtype = _dtype_of(a, b)
    if dtype == torch.complex64:
        return sm.route_complex(_shape(a), _shape(b))
    return sm.route([_shape(a) or (), _shape(b) or ()], [dtype, dtype])


def streams(name: str, a, b) -> bool:
    """Whether ``a <name> b`` runs K5 (operands in the result dtype)."""
    return _route(name, a, b) is not None


def binary(name: str, a, b) -> torch.Tensor:
    """``a <name> b`` where each operand is a tensor or a Python scalar of
    the result dtype."""
    if name == 'pow':
        return power(a, b)
    layout = _route(name, a, b)
    if layout is not None:
        return sm.stream_map(name, a, b, layout=layout)
    with tracing.trace_op(name, 'plain;binary'):
        return _PLAIN_BINARY[name](a, b)


def cpow_planes(ar, ai, br, bi):
    """pow on real and imaginary parts, a^b = exp(b * log a) (reference
    pow_op, dsc_ops.h:305-316), with NumPy's values at zero bases
    (0^0 = 1, 0^b = 0)."""
    lr = 0.5 * torch.log(ar * ar + ai * ai)
    li = torch.atan2(ai, ar)
    er = br * lr - bi * li
    ei = br * li + bi * lr
    m = torch.exp(er)
    yr, yi = m * torch.cos(ei), m * torch.sin(ei)
    zero_a = (ar == 0) & (ai == 0)
    zero_b = (br == 0) & (bi == 0)
    yr = torch.where(zero_a, torch.where(zero_b, 1.0, 0.0), yr)
    yi = torch.where(zero_a, 0.0, yi)
    return yr, yi


def power(a, b) -> torch.Tensor:
    """Never on K5 (dsc_tpu kernels.py:85-99); complex pow takes the
    real-plane formula."""
    dtype = _dtype_of(a, b)
    device = (a if isinstance(a, torch.Tensor) else b).device
    # a Python scalar as a fill, not an upload: a CUDA graph can capture it
    a, b = (x if isinstance(x, torch.Tensor) else torch.full((), x, dtype=dtype, device=device)
            for x in (a, b))
    if dtype.is_complex:
        yr, yi = cpow_planes(a.real, a.imag, b.real, b.imag)
        return torch.complex(yr, yi)
    return torch.pow(a, b)


# ---------------------------------------------------------------------------
# unary ops (reference dsc.cpp:1312-1769)
# ---------------------------------------------------------------------------


def _clog(x):
    """log z = 0.5*log(re^2+im^2) + i*atan2(im, re) (reference logn_op,
    dsc_ops.h:147-165), the naive magnitude on purpose."""
    re, im = x.real, x.imag
    return torch.complex(0.5 * torch.log(re * re + im * im), torch.atan2(im, re))


def _clog_scaled(scale: float):
    def f(x):
        y = _clog(x)
        return torch.complex(y.real * scale, y.imag * scale)
    return f


def _cexp(x):
    m = torch.exp(x.real)
    return torch.complex(m * torch.cos(x.imag), m * torch.sin(x.imag))


def _csqrt(x):
    """Principal square root by the half-angle formulas; NumPy's branch
    cut by the sign bit of the imaginary part."""
    re, im = x.real, x.imag
    r = torch.sqrt(re * re + im * im)
    u_pos = torch.sqrt((r + re) * 0.5)
    v_neg = torch.sqrt(torch.clamp((r - re) * 0.5, min=0.0))
    tiny = torch.finfo(re.dtype).tiny
    s = torch.where(torch.signbit(im), -1.0, 1.0).to(re.dtype)
    u = torch.where(re >= 0, u_pos, torch.abs(im) / torch.clamp(2.0 * v_neg, min=tiny))
    v = torch.where(re >= 0, im / torch.clamp(2.0 * u_pos, min=tiny), s * v_neg)
    zero = r == 0
    return torch.complex(torch.where(zero, 0.0, u), torch.where(zero, 0.0, v))


def _csin(x):
    re, im = x.real, x.imag
    return torch.complex(torch.sin(re) * torch.cosh(im), torch.cos(re) * torch.sinh(im))


def _ccos(x):
    re, im = x.real, x.imag
    return torch.complex(torch.cos(re) * torch.cosh(im), -torch.sin(re) * torch.sinh(im))


def _csinc(x):
    """np.sinc(z) = sin(pi z)/(pi z), sinc(0) = 1."""
    re, im = x.real, x.imag
    pr, pi_ = math.pi * re, math.pi * im
    sr = torch.sin(pr) * torch.cosh(pi_)
    si = torch.cos(pr) * torch.sinh(pi_)
    qr, qi = sm.complex_math(sr, si, pr, pi_, 'div')
    zero = (re == 0) & (im == 0)
    return torch.complex(torch.where(zero, 1.0, qr), torch.where(zero, 0.0, qi))


_LN2 = float(np.log(2.0))
_LN10 = float(np.log(10.0))

# name -> (plain real formula, complex formula); the streamed float32 bodies
# are stream_map's (sin/cos there are the fast polynomial ones)
UNARY = {
    'cos': (torch.cos, _ccos),
    'sin': (torch.sin, _csin),
    'sinc': (torch.sinc, _csinc),
    'logn': (torch.log, _clog),
    'log2': (torch.log2, _clog_scaled(1.0 / _LN2)),
    'log10': (torch.log10, _clog_scaled(1.0 / _LN10)),
    'exp': (torch.exp, _cexp),
    'sqrt': (torch.sqrt, _csqrt),
}


def unary(name: str, x: torch.Tensor) -> torch.Tensor:
    real_fn, complex_fn = UNARY[name]
    if x.dtype.is_complex:
        return complex_fn(x)
    layout = sm.route([tuple(x.shape)], [x.dtype])
    if layout is not None:
        return sm.stream_map(name, x, layout=layout)
    return real_fn(x)


def conj(x: torch.Tensor) -> torch.Tensor:
    return torch.conj_physical(x)


def absolute(x: torch.Tensor) -> torch.Tensor:
    # complex -> the real component dtype
    return torch.abs(x)


def angle(x: torch.Tensor) -> torch.Tensor:
    if x.dtype.is_complex:
        return torch.atan2(x.imag, x.real)
    return torch.atan2(torch.zeros_like(x), x)


def i0(x: torch.Tensor) -> torch.Tensor:
    return torch.special.i0(x)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi) with scalar bounds; complex compared by real
    part, the bound replacing the whole value (reference dsc.cpp:1723-1769,
    dsc_ops.h:318-338)."""
    if x.dtype.is_complex:
        lo_c = torch.full((), complex(lo), dtype=x.dtype, device=x.device)
        hi_c = torch.full((), complex(hi), dtype=x.dtype, device=x.device)
        y = torch.where(x.real < lo_c.real, lo_c, x)
        return torch.where(y.real > hi_c.real, hi_c, y)
    layout = sm.route([tuple(x.shape), (), ()], [x.dtype] * 3)
    if layout is not None:
        return sm.stream_map('clip', x, float(lo), float(hi), layout=layout)
    return torch.clamp(x, float(lo), float(hi))


# ---------------------------------------------------------------------------
# reductions (reference dsc.cpp:1771-1953)
# ---------------------------------------------------------------------------


def reduce_sum(x: torch.Tensor, axis: int, keepdims: bool) -> torch.Tensor:
    return torch.sum(x, dim=axis, keepdim=keepdims)


def reduce_mean(x: torch.Tensor, axis: int, keepdims: bool) -> torch.Tensor:
    # the reference computes sum * (1/n) (dsc.cpp:1825-1855)
    return torch.sum(x, dim=axis, keepdim=keepdims) * (1.0 / x.shape[axis])


def _complex_extreme(x, axis, keepdims, is_max):
    """NumPy's lexicographic (real, then imaginary) complex extremum."""
    re, im = x.real, x.imag
    if is_max:
        mr = torch.amax(re, dim=axis, keepdim=True)
        mi = torch.amax(torch.where(re == mr, im, -math.inf), dim=axis, keepdim=True)
    else:
        mr = torch.amin(re, dim=axis, keepdim=True)
        mi = torch.amin(torch.where(re == mr, im, math.inf), dim=axis, keepdim=True)
    out = torch.complex(mr, mi)
    return out if keepdims else out.squeeze(axis)


def reduce_max(x: torch.Tensor, axis: int, keepdims: bool) -> torch.Tensor:
    if x.dtype.is_complex:
        return _complex_extreme(x, axis, keepdims, is_max=True)
    return torch.amax(x, dim=axis, keepdim=keepdims)


def reduce_min(x: torch.Tensor, axis: int, keepdims: bool) -> torch.Tensor:
    if x.dtype.is_complex:
        return _complex_extreme(x, axis, keepdims, is_max=False)
    return torch.amin(x, dim=axis, keepdim=keepdims)


# ---------------------------------------------------------------------------
# creation / layout helpers
# ---------------------------------------------------------------------------


def arange(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    real = dtype.to_real() if dtype.is_complex else dtype
    return torch.arange(n, dtype=real, device=device).to(dtype)


def full(shape, fill_value, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.full(tuple(shape), fill_value, dtype=dtype, device=device)


def transpose(x: torch.Tensor, axes) -> torch.Tensor:
    return x.permute(axes).contiguous()


def concat(arrays, axis) -> torch.Tensor:
    if axis is None:
        return torch.cat([a.reshape(-1) for a in arrays])
    return torch.cat(arrays, dim=axis)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if x.dtype.is_complex and not dtype.is_complex:
        # astype of complex to real keeps the real part
        x = x.real
    return x.to(dtype)
