"""LTI representation conversions and small system utilities
(dsc_tpu/models/lti.py, copied: host numpy, no device work).

Completes the scipy.signal representation-conversion surface around the
design pipeline in models/iir.py (which already has tf2sos/sos2tf):
``tf2zpk / zpk2tf / sos2zpk / zpk2sos / normalize / bilinear /
deconvolve / unit_impulse``. All host-side f64 polynomial/root math
(design-time policy, same as butter/ellip); scipy.signal is the
executable spec and test oracle.
"""

from __future__ import annotations

import warnings

import numpy as np

from .iir import _check_sos, _zpk2sos


class BadCoefficients(UserWarning):
    """Warning about badly conditioned filter coefficients
    (scipy.signal.BadCoefficients parity): emitted when ``normalize``
    strips near-zero leading numerator coefficients."""


def normalize(b, a):
    """Normalize a transfer function so a[0] == 1, stripping leading
    numerator zeros (scipy.signal.normalize semantics). Returns (b, a)
    f64 arrays."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a.size == 0 or a[0] == 0.0:
        raise RuntimeError('normalize: a[0] must be nonzero')
    if b.size == 0:
        raise RuntimeError('normalize: numerator is empty')
    if b.size > a.size:
        raise RuntimeError(
            f'normalize: improper transfer function (len(b)={b.size} > '
            f'len(a)={a.size})')
    bn, an = b / a[0], a / a[0]
    # strip leading (near-)zeros but keep at least one coefficient —
    # scipy's normalize tolerance semantics: compositions like ss2tf
    # produce ~1e-16 leading residue from monic-polynomial cancellation,
    # and keeping it would fabricate huge spurious roots
    scale = max(1.0, float(np.abs(bn).max()))
    k = 0
    while k < bn.size - 1 and abs(bn[k]) <= 1e-14 * scale:
        k += 1
    if k:
        warnings.warn('Badly conditioned filter coefficients (numerator): '
                      'the results may be meaningless', BadCoefficients,
                      stacklevel=2)
    bn = bn[k:]
    if bn.size == 1 and abs(bn[0]) <= 1e-14 * scale:
        bn = np.zeros(1)
    return bn, an


def tf2zpk(b, a):
    """Transfer function -> (zeros, poles, gain)
    (scipy.signal.tf2zpk semantics: normalize, then np.roots)."""
    b, a = normalize(b, a)
    k = b[0]
    z = np.roots(b / k) if b.size > 1 else np.array([], complex)
    p = np.roots(a) if a.size > 1 else np.array([], complex)
    return z, p, float(k)


def zpk2tf(z, p, k):
    """(zeros, poles, gain) -> (b, a) polynomials
    (scipy.signal.zpk2tf semantics; real coefficients whenever the roots
    are conjugate-symmetric)."""
    z = np.atleast_1d(np.asarray(z))
    p = np.atleast_1d(np.asarray(p))
    b = float(k) * np.poly(z) if z.size else np.asarray([float(k)])
    a = np.poly(p) if p.size else np.ones(1)
    # poly of a conjugate-symmetric set is real up to rounding
    if np.iscomplexobj(b) and np.allclose(b.imag, 0.0, atol=1e-10 * max(
            1.0, float(np.abs(b).max()))):
        b = b.real
    if np.iscomplexobj(a) and np.allclose(a.imag, 0.0, atol=1e-10 * max(
            1.0, float(np.abs(a).max()))):
        a = a.real
    return np.atleast_1d(b), np.atleast_1d(a)


def sos2zpk(sos):
    """Second-order sections -> (zeros, poles, gain)
    (scipy.signal.sos2zpk semantics: roots per biquad, gains
    multiplied)."""
    sos = _check_sos(sos)
    z, p, k = [], [], 1.0
    for row in sos:
        bz, az, kz = tf2zpk(row[:3], row[3:])
        # every biquad contributes exactly 2 roots in scipy's convention
        z.extend(np.concatenate([bz, np.zeros(2 - len(bz))]))
        p.extend(np.concatenate([az, np.zeros(2 - len(az))]))
        k *= kz
    return np.asarray(z, complex), np.asarray(p, complex), float(k)


def zpk2sos(z, p, k) -> np.ndarray:
    """(zeros, poles, gain) -> biquad sections. The realized transfer
    function equals scipy.signal.zpk2sos's exactly; the section PAIRING
    follows this package's low-Q-first heuristic (models/iir.py
    _zpk2sos), which may order rows differently — behavior-identical
    for filtering."""
    return _zpk2sos(np.asarray(z, complex), np.asarray(p, complex),
                    float(k))


def bilinear(b, a, fs: float = 1.0):
    """Analog -> digital transfer function via the Tustin bilinear map
    s = 2*fs*(z-1)/(z+1) (scipy.signal.bilinear semantics). Returns
    (bd, ad)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a.size == 0 or np.all(a == 0.0):
        raise RuntimeError('bilinear: denominator is zero')
    fs = float(fs)
    d = max(b.size, a.size) - 1  # system degree
    fs2 = 2.0 * fs
    # substitute s = fs2*(z-1)/(z+1) and clear (z+1)^d:
    # each s^j term becomes fs2^j (z-1)^j (z+1)^(d-j)
    zm1 = np.array([1.0, -1.0])
    zp1 = np.array([1.0, 1.0])

    def transform(c):
        out = np.zeros(d + 1)
        n = c.size - 1
        for j, cj in enumerate(c):
            powj = n - j  # coefficient of s^powj
            term = np.ones(1)
            for _ in range(powj):
                term = np.convolve(term, zm1)
            for _ in range(d - powj):
                term = np.convolve(term, zp1)
            out += cj * fs2 ** powj * term
        return out

    bd, ad = transform(b), transform(a)
    if ad[0] == 0.0:
        raise RuntimeError('bilinear: transformed denominator is singular')
    return bd / ad[0], ad / ad[0]


def deconvolve(signal, divisor):
    """Polynomial long division: quotient + remainder with
    ``signal = convolve(divisor, quotient) + remainder``
    (scipy.signal.deconvolve semantics)."""
    num = np.atleast_1d(np.asarray(signal, np.float64))
    den = np.atleast_1d(np.asarray(divisor, np.float64))
    if den.size == 0 or den[0] == 0.0:
        raise RuntimeError('deconvolve: divisor[0] must be nonzero')
    n = num.size - den.size + 1
    if n <= 0:
        return np.zeros(1), num.copy()
    quot = np.zeros(n)
    rem = num.copy()
    for i in range(n):
        q = rem[i] / den[0]
        quot[i] = q
        rem[i:i + den.size] -= q * den
    return quot, rem


def unit_impulse(shape, idx=None, dtype=np.float64) -> np.ndarray:
    """Unit impulse (scipy.signal.unit_impulse semantics): zeros with a
    single 1 at ``idx`` (default 0; 'mid' centers it)."""
    out = np.zeros(shape, dtype)
    if idx is None:
        idx = (0,) * out.ndim
    elif idx == 'mid':
        idx = tuple(s // 2 for s in out.shape)
    elif not isinstance(idx, tuple):
        idx = (int(idx),) * out.ndim
    out[idx] = 1
    return out
