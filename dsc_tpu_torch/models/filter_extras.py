"""Filter-design plumbing: analog prototypes, lowpass transforms,
initial conditions, root utilities and discrete-response helpers
(dsc_tpu/models/filter_extras.py, the same NumPy code but for the
discrete responses).

Completes the scipy.signal design-support surface: ``buttap / cheb1ap /
cheb2ap / ellipap / besselap`` (the analog lowpass prototypes the
designers build on), ``lp2lp / lp2hp / lp2bp / lp2bs`` in both tf and
zpk forms, ``bilinear_zpk``, ``lfiltic``, ``unique_roots``,
``findfreqs``, ``dfreqresp / dbode``, and the ``fftconvolve`` /
``freqz_sos`` / ``choose_conv_method`` aliases. Host f64 design math;
scipy.signal is the executable spec. ``fftconvolve`` is the one device
path: the FFT convolutions of models/filter_fft.py.

``dfreqresp`` and ``dbode`` follow scipy where the JAX package does not
(ROADMAP F9): a transfer function's numerator and denominator are
aligned as polynomials in z before they are evaluated in z^-1, a zpk
system is evaluated as k prod(z - z_i) / prod(z - p_i) on the unit
circle, and ``dbode``'s ``w`` is in rad/sample, as scipy's is."""

from __future__ import annotations

import numpy as np

from .filter_fft import fft_convolve, fft_convolve2
from .iir import (
    _bilinear_zpk,
    _lp2bp_zpk,
    _lp2bs_zpk,
    _lp2hp_zpk,
    _lp2lp_zpk,
    sosfreqz,
)
from .iirdesign import _besselap, _ellipap
from .lti import tf2zpk, zpk2tf
from .pfe import _group_poles
from .statespace import ss2tf


# ------------------------------------------------------- analog prototypes

def buttap(n: int):
    """Analog Butterworth lowpass prototype (z, p, k) with the -3 dB
    point at w = 1 (scipy.signal.buttap)."""
    if n < 1:
        raise RuntimeError(f'buttap: order ({n}) must be >= 1')
    theta = np.pi * np.arange(-n + 1, n, 2) / (2.0 * n)
    p = -np.exp(1j * theta)
    return np.asarray([], complex), p, 1.0


def cheb1ap(n: int, rp: float):
    """Analog Chebyshev-I prototype, rp dB passband ripple
    (scipy.signal.cheb1ap)."""
    if n < 1:
        raise RuntimeError(f'cheb1ap: order ({n}) must be >= 1')
    eps = np.sqrt(10.0 ** (0.1 * rp) - 1.0)
    mu = np.arcsinh(1.0 / eps) / n
    theta = np.pi * np.arange(-n + 1, n, 2) / (2.0 * n)
    p = -np.sinh(mu + 1j * theta)
    k = np.real(np.prod(-p))
    if n % 2 == 0:
        k /= np.sqrt(1.0 + eps * eps)
    return np.asarray([], complex), p, float(k)


def cheb2ap(n: int, rs: float):
    """Analog Chebyshev-II prototype, rs dB stopband attenuation
    (scipy.signal.cheb2ap)."""
    if n < 1:
        raise RuntimeError(f'cheb2ap: order ({n}) must be >= 1')
    de = 1.0 / np.sqrt(10.0 ** (0.1 * rs) - 1.0)
    mu = np.arcsinh(1.0 / de) / n
    if n % 2:
        m = np.concatenate([np.arange(-n + 1, 0, 2), np.arange(2, n, 2)])
    else:
        m = np.arange(-n + 1, n, 2)
    z = -np.conj(1j / np.sin(m * np.pi / (2.0 * n)))
    p = -np.exp(1j * np.pi * np.arange(-n + 1, n, 2) / (2.0 * n))
    p = np.sinh(mu) * p.real + 1j * np.cosh(mu) * p.imag
    p = 1.0 / p
    k = np.real(np.prod(-p) / np.prod(-z))
    return z, p, float(k)


def ellipap(n: int, rp: float, rs: float):
    """Analog elliptic prototype (scipy.signal.ellipap; the Landen-
    transform construction in models/iirdesign.py)."""
    if n < 1:
        raise RuntimeError(f'ellipap: order ({n}) must be >= 1')
    return _ellipap(n, float(rp), float(rs))


def besselap(n: int, norm: str = 'phase'):
    """Analog Bessel prototype (scipy.signal.besselap, norm='phase' —
    reverse-Bessel-polynomial roots scaled to half phase lag at
    w = 1)."""
    if norm != 'phase':
        raise RuntimeError(
            "besselap: only norm='phase' (scipy's default) is implemented")
    if n < 1:
        raise RuntimeError(f'besselap: order ({n}) must be >= 1')
    return _besselap(n)


# ------------------------------------------------ lowpass band transforms

def lp2lp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass -> lowpass zpk rescale (scipy.signal.lp2lp_zpk)."""
    return _lp2lp_zpk(np.asarray(z, complex), np.asarray(p, complex),
                      float(k), float(wo))


def lp2hp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass -> highpass zpk transform (scipy.signal.lp2hp_zpk)."""
    return _lp2hp_zpk(np.asarray(z, complex), np.asarray(p, complex),
                      float(k), float(wo))


def lp2bp_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass -> bandpass zpk transform (scipy.signal.lp2bp_zpk)."""
    return _lp2bp_zpk(np.asarray(z, complex), np.asarray(p, complex),
                      float(k), float(wo), float(bw))


def lp2bs_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass -> bandstop zpk transform (scipy.signal.lp2bs_zpk)."""
    return _lp2bs_zpk(np.asarray(z, complex), np.asarray(p, complex),
                      float(k), float(wo), float(bw))


def _lp2_tf(transform, b, a, *args):
    z, p, k = tf2zpk(b, a)
    return zpk2tf(*transform(z, p, k, *args))


def lp2lp(b, a, wo: float = 1.0):
    """Lowpass -> lowpass transfer-function rescale (scipy.signal.lp2lp)."""
    return _lp2_tf(lp2lp_zpk, b, a, wo)


def lp2hp(b, a, wo: float = 1.0):
    """Lowpass -> highpass transfer function (scipy.signal.lp2hp)."""
    return _lp2_tf(lp2hp_zpk, b, a, wo)


def lp2bp(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass -> bandpass transfer function (scipy.signal.lp2bp)."""
    return _lp2_tf(lp2bp_zpk, b, a, wo, bw)


def lp2bs(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass -> bandstop transfer function (scipy.signal.lp2bs)."""
    return _lp2_tf(lp2bs_zpk, b, a, wo, bw)


def bilinear_zpk(z, p, k, fs: float):
    """Analog zpk -> digital zpk via the Tustin map
    (scipy.signal.bilinear_zpk)."""
    return _bilinear_zpk(np.asarray(z, complex), np.asarray(p, complex),
                         float(k), float(fs))


# --------------------------------------------------------- small utilities

def lfiltic(b, a, y, x=None) -> np.ndarray:
    """Initial conditions for :func:`~dsc_tpu_torch.models.lfilter` that
    continue from given past outputs ``y`` (and inputs ``x``)
    (scipy.signal.lfiltic semantics): y = [y[-1], y[-2], ...]."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a.size < 1 or a[0] == 0.0:
        raise RuntimeError('lfiltic: a[0] must be nonzero')
    n, m = a.size - 1, b.size - 1
    k = max(m, n)
    y = np.asarray(y, np.float64)
    x = np.zeros(m) if x is None else np.asarray(x, np.float64)
    if x.size < m:
        x = np.concatenate([x, np.zeros(m - x.size)])
    if y.size < n:
        y = np.concatenate([y, np.zeros(n - y.size)])
    zi = np.zeros(k)
    for i in range(m):
        zi[i] = np.sum(b[i + 1:] * x[:m - i])
    for i in range(n):
        zi[i] -= np.sum(a[i + 1:] * y[:n - i])
    if a[0] != 1.0:
        zi /= a[0]
    return zi


def unique_roots(p, tol: float = 1e-3, rtype: str = 'min'):
    """Cluster near-equal roots (scipy.signal.unique_roots): returns
    (unique_roots, multiplicities)."""
    groups = _group_poles(np.asarray(p, complex), tol, rtype)
    return (np.asarray([g[0] for g in groups]),
            np.asarray([g[1] for g in groups], np.intp))


def findfreqs(num, den, n: int, kind: str = 'ba') -> np.ndarray:
    """Log-spaced frequency grid covering a system's interesting region
    (scipy.signal.findfreqs semantics)."""
    if kind == 'ba':
        ep = np.atleast_1d(np.roots(np.asarray(den, np.float64))) + 0j
        tz = np.atleast_1d(np.roots(np.asarray(num, np.float64))) + 0j
    elif kind == 'zp':
        ep = np.atleast_1d(np.asarray(den, complex))
        tz = np.atleast_1d(np.asarray(num, complex))
    else:
        raise RuntimeError("findfreqs: kind must be 'ba' or 'zp'")
    if ep.size == 0:
        ep = np.asarray([-1000.0 + 0j])
    ez = np.concatenate([ep[ep.imag >= 0],
                         tz[(np.abs(tz) < 1e5) & (tz.imag >= 0)]])
    integ = (np.abs(ez) < 1e-10).astype(np.float64)
    hfreq = np.round(np.log10(np.max(
        3.0 * np.abs(ez.real + integ) + 1.5 * ez.imag)) + 0.5)
    lfreq = np.round(np.log10(0.1 * np.min(
        np.abs((ez + integ).real) + 2.0 * ez.imag)) - 0.5)
    return np.logspace(lfreq, hfreq, int(n))


# ------------------------------------------------ discrete responses

def dfreqresp(system, w=None, n: int = 10000):
    """Discrete-system frequency response (scipy.signal.dfreqresp):
    system is a tuple ending in dt; returns (w, H) with w in
    rad/sample. A transfer function's b and a are polynomials in z,
    right-aligned before they are evaluated in z^-1; a zpk system is
    evaluated in z, as scipy's freqz_zpk does (ROADMAP F9)."""
    if not isinstance(system, (tuple, list)) or len(system) not in (3, 4, 5):
        raise RuntimeError('dfreqresp: expected a system tuple ending in dt')
    if w is None:
        w = np.linspace(0, np.pi, int(n), endpoint=False)
    else:
        w = np.asarray(w, np.float64)
    if len(system) == 4:
        z, p = (np.atleast_1d(np.asarray(c, complex)) for c in system[:2])
        zc = np.exp(1j * w)
        num = np.prod(zc[:, None] - z[None, :], axis=1) if z.size else 1.0
        den = np.prod(zc[:, None] - p[None, :], axis=1) if p.size else 1.0
        return w, float(system[2]) * num / den
    if len(system) == 3:
        b, a = (np.atleast_1d(np.asarray(c, np.float64))
                for c in system[:2])
    else:
        num, a = ss2tf(*system[:4])
        b = num[0]
    # b(z)/a(z) = b(z^-1 z^m)/a(z^-1 z^m): pad the shorter with leading zeros
    # (scipy's TransferFunction._z_to_zinv)
    size = max(b.size, a.size)
    b = np.concatenate([np.zeros(size - b.size), b])
    a = np.concatenate([np.zeros(size - a.size), a])
    zinv = np.exp(-1j * w)
    h = np.polyval(b[::-1], zinv) / np.polyval(a[::-1], zinv)
    return w, h


def dbode(system, w=None, n: int = 100):
    """Discrete-system Bode plot (scipy.signal.dbode): ``w`` in
    rad/sample; returns (w in rad/time-unit, mag_db, phase_deg)."""
    dt = float(system[-1])
    w_out, h = dfreqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.maximum(np.abs(h), 1e-300))
    phase = np.rad2deg(np.unwrap(np.angle(h)))
    return w_out / dt, mag, phase


# ------------------------------------------------------------- aliases

def fftconvolve(in1, in2, mode: str = 'full'):
    """scipy.signal.fftconvolve for 1-D / 2-D Tensors (the FFT engines
    in models/filter_fft.py)."""
    def ndim(x):
        got = getattr(x, 'n_dim', None)
        return got if got is not None else np.ndim(x)

    if ndim(in1) == 2 and ndim(in2) == 2:
        return fft_convolve2(in1, in2, mode=mode)
    return fft_convolve(in1, in2, mode=mode)


def freqz_sos(sos, worN: int = 512, fs: float = 2.0 * np.pi):
    """Alias of :func:`~dsc_tpu_torch.models.sosfreqz`
    (scipy.signal.freqz_sos, the 1.15+ name)."""
    return sosfreqz(sos, worN=worN, fs=fs)


def choose_conv_method(in1, in2, mode: str = 'full') -> str:
    """scipy.signal.choose_conv_method analog: the convolutions of this
    package all run through the FFT engines, so the answer is always
    'fft', as in the JAX package."""
    del in1, in2, mode
    return 'fft'


def abcd_normalize(A=None, B=None, C=None, D=None):
    """Fill in and shape-check missing state-space matrices
    (scipy.signal.abcd_normalize semantics)."""
    given = {'A': A, 'B': B, 'C': C, 'D': D}
    shapes = {}
    for name, m in given.items():
        if m is not None:
            shapes[name] = np.atleast_2d(np.asarray(m, np.float64)).shape
    n = shapes.get('A', (None,))[0] or shapes.get('B', (None,))[0] \
        or (shapes.get('C', (None, None))[1])
    q = (shapes.get('B', (None, None))[1]
         or shapes.get('D', (None, None))[1])
    p = shapes.get('C', (None,))[0] or shapes.get('D', (None,))[0]
    if n is None or q is None or p is None:
        raise RuntimeError(
            'abcd_normalize: not enough information to deduce shapes')
    out = []
    for name, rows, cols in (('A', n, n), ('B', n, q), ('C', p, n),
                             ('D', p, q)):
        m = given[name]
        m = np.zeros((rows, cols)) if m is None else \
            np.atleast_2d(np.asarray(m, np.float64))
        if m.shape != (rows, cols):
            raise RuntimeError(
                f'abcd_normalize: {name} has shape {m.shape}, expected '
                f'({rows}, {cols})')
        out.append(m)
    return tuple(out)
