"""scipy.fft-parity fast Hankel transform, FFTLog
(dsc_tpu/transforms/fftlog.py).

``fht``/``ifht`` compute the discrete Hankel transform of a
logarithmically spaced periodic sequence per the FFTLog algorithm
(Hamilton 2000, MNRAS 312, 257): the transform diagonalizes in log-space
Fourier modes, so it is one length-n real FFT, a complex coefficient
multiply, an inverse real FFT and a flip, on the input's device. The
coefficients ``u_m = (k0 r0)^{-2pi i m/L} U_mu(q + 2pi i m/L)`` with
``U_mu(x) = 2^x Gamma((mu+1+x)/2) / Gamma((mu+1-x)/2)`` are design-time
host float64 math, uploaded once a plan: complex log-gamma via the Lanczos
series, so that scipy stays a test oracle only (no scipy.special at run
time). The host math is a copy of the JAX package's.

scipy.fft.fht/ifht/fhtoffset are the executable spec.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Tuple

import numpy as np
import torch

from .. import tracing
from ..fourier import core
from ..tensor import Tensor, _finish
from . import _dft
from .exact import _as_tensor, _real_values

__all__ = ['fht', 'ifht', 'fhtoffset']

_LN2 = math.log(2.0)

# Lanczos g=7, n=9 coefficients (Godfrey/Press public values): relative
# error < 1e-13 over the right half-plane, extended by reflection.
_LANCZOS_G = 7.0
_LANCZOS_C = np.array([
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
])


def _loggamma(z: np.ndarray) -> np.ndarray:
    """Complex log-gamma (principal branch up to 2*pi*i multiples:
    FFTLog only consumes exp(loggamma), which is branch-insensitive)."""
    z = np.asarray(z, dtype=np.complex128)
    refl = z.real < 0.5
    zz = np.where(refl, 1.0 - z, z)
    x = _LANCZOS_C[0] + np.sum(
        _LANCZOS_C[1:] / (zz[..., None] - 1.0 + np.arange(1, 9)), axis=-1)
    t = zz + _LANCZOS_G - 0.5
    lg = (0.5 * math.log(2.0 * math.pi) + (zz - 0.5) * np.log(t) - t
          + np.log(x))
    if np.any(refl):
        with np.errstate(divide='ignore', invalid='ignore'):
            lg_r = math.log(math.pi) - np.log(np.sin(np.pi * z)) - lg
        lg = np.where(refl, lg_r, lg)
    return lg


def _is_nonpos_int(x: float) -> bool:
    return x <= 0.0 and x == round(x)


def _poch(a: float, d: float) -> float:
    """Rising factorial Gamma(a+d)/Gamma(a) for real arguments with the
    pole conventions FFTLog's u_0 needs (scipy.special.poch analog)."""
    b = a + d
    if _is_nonpos_int(a) and _is_nonpos_int(b):
        # both poles: finite product a (a+1) ... (a+d-1) (d integer)
        di = int(round(d))
        if di < 0:
            return 1.0 / _poch(b, -d) if _poch(b, -d) != 0 else math.inf
        out = 1.0
        for i in range(di):
            out *= a + i
        return out
    if _is_nonpos_int(a):
        return 0.0  # 1/Gamma(pole) = 0
    if _is_nonpos_int(b):
        return math.inf  # Gamma(pole)/finite
    return float(np.exp(_loggamma(b) - _loggamma(a)).real)


def _fht_coeff(n: int, dln: float, mu: float, offset: float, bias: float,
               inverse: bool) -> np.ndarray:
    """The n//2+1 FFTLog multipliers (host f64); for the inverse the
    division by conj(u) is folded in: w = u / |u|^2."""
    lnkr, q = offset, bias
    xp_ = (mu + 1.0 + q) / 2.0
    xm_ = (mu + 1.0 - q) / 2.0
    y = np.linspace(0.0, np.pi * (n // 2) / (n * dln), n // 2 + 1)
    with np.errstate(all='ignore'):
        lgp = _loggamma(xp_ + 1j * y)
        lgm = _loggamma(xm_ + 1j * y)
        u = np.exp((lgp.real - lgm.real + _LN2 * q)
                   + 1j * (lgp.imag + lgm.imag + 2.0 * y * (_LN2 - lnkr)))
    if n % 2 == 0:
        u[-1] = u[-1].real  # low-ringing: Nyquist coefficient real
    if not np.isfinite(u[0]):
        # u_0 = 2^q Gamma(xp)/Gamma(xm) = 2^q poch(xm, xp - xm)
        u[0] = (2.0 ** q) * _poch(xm_, xp_ - xm_)
    if np.isinf(u[0]) and not inverse:
        warnings.warn('singular transform; consider changing the bias',
                      stacklevel=4)
        u = u.copy()
        u[0] = 0.0
    elif u[0] == 0 and inverse:
        warnings.warn('singular inverse transform; consider changing the '
                      'bias', stacklevel=4)
        u = u.copy()
        u[0] = np.inf
    if inverse:
        with np.errstate(all='ignore'):
            w = u / (u.real ** 2 + u.imag ** 2)
        w[~np.isfinite(w)] = 0.0  # A / conj(inf) -> 0
        return w
    return u


def _fht_plan(n: int, dln: float, mu: float, offset: float, bias: float,
              inverse: bool, device) -> Tuple[Tuple, Any]:
    key = ('fht', n, float(dln), float(mu), float(offset), float(bias),
           inverse, str(device))
    hit = _dft._cache_get(key)
    if hit is not None:
        return hit
    static, dtabs = _dft.rdft_plan(n, device)
    w = _fht_coeff(n, dln, mu, offset, bias, inverse)
    j = np.arange(n, dtype=np.float64)
    jc = (n - 1) / 2.0
    if bias != 0.0:
        # a_q(r) = a(r) (r/r_c)^{-q};  A(k) = A_q(k) (k/k_c)^{-q}(k_c r_c)^{-q}
        bin_ = np.exp(-bias * (j - jc) * dln)
        if inverse:
            bin_, bout = 1.0 / bin_ * math.exp(bias * offset), 1.0 / bin_
        else:
            bout = bin_ * math.exp(-bias * offset)
        pre = _dft.upload(bin_, device, np.float32)
        post = _dft.upload(bout, device, np.float32)
    else:
        pre = post = None
    entry = ((n, static), (dtabs, _dft.upload(w, device), pre, post))
    _dft._cache_put(key, entry)
    return entry


def _fht_prog(x: torch.Tensor, tabs: Any, static: Tuple) -> torch.Tensor:
    n, dstatic = static
    dtabs, w, pre, post = tabs
    axis = x.dim() - 1
    x, lead = core._rows(x, axis, n)
    if pre is not None:
        x = x * pre
    f = _dft.rdft_rows(x, dtabs, dstatic)
    # irdft carries the backward 1/n; _fhtq's irfft is the same convention
    y = _dft.irdft_rows(f * w, dtabs, dstatic).flip(1)
    if post is not None:
        y = y * post
    return core._unrows(y, lead, axis)


def _fht_like(a, dln, mu, offset, bias, inverse, who) -> Tensor:
    a = _as_tensor(a)
    x = _real_values(a, who)
    n = a.shape[-1]
    dln = float(dln)
    if dln == 0.0:
        raise RuntimeError(f'{who}: dln must be nonzero')
    static, tabs = _fht_plan(n, dln, float(mu), float(offset), float(bias),
                             inverse, x.device)
    with tracing.trace_op(who, 'op;transforms', tracing.tensor_args(a=a)):
        y = _fht_prog(x, tabs, static)
    return _finish(y, None)


def fht(a, dln: float, mu: float, offset: float = 0.0,
        bias: float = 0.0) -> Tensor:
    """Fast Hankel transform of a log-spaced periodic sequence over the
    last axis (scipy.fft.fht semantics, FFTLog algorithm)."""
    return _fht_like(a, dln, mu, offset, bias, inverse=False, who='tf.fht')


def ifht(A, dln: float, mu: float, offset: float = 0.0,
         bias: float = 0.0) -> Tensor:
    """Inverse fast Hankel transform (scipy.fft.ifht semantics)."""
    return _fht_like(A, dln, mu, offset, bias, inverse=True, who='tf.ifht')


def fhtoffset(dln: float, mu: float, initial: float = 0.0,
              bias: float = 0.0) -> float:
    """Return an optimal (low-ringing) offset near ``initial`` for
    fht/ifht (scipy.fft.fhtoffset semantics)."""
    lnkr, q = float(initial), float(bias)
    xp_ = (mu + 1.0 + q) / 2.0
    xm_ = (mu + 1.0 - q) / 2.0
    y = np.pi / (2.0 * float(dln))
    zp = _loggamma(xp_ + 1j * y)
    zm = _loggamma(xm_ + 1j * y)
    arg = (_LN2 - lnkr) / dln + (zp.imag + zm.imag) / np.pi
    return float(lnkr + (arg - np.round(arg)) * dln)
