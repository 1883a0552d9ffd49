"""Frequency-response helpers and the spec-driven designer:
``iirdesign``, analog ``freqs`` / ``freqs_zpk``, ``freqz_zpk``,
``bode`` / ``freqresp``, ``correlation_lags``, and ``czt_points``, whose
one definition is in czt.py (dsc_tpu/models/response.py, the same NumPy
code).

scipy.signal semantics; all host f64 design-time math (the filters they
describe run on device through sosfilt/lfilter). ``freqs`` and
``freqs_zpk`` choose their default grid as the JAX package does, two
decades either side of the largest root's magnitude (``_w_grid``), not
as scipy's ``findfreqs``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .czt import czt_points  # noqa: F401  (re-exported)
from .iirdesign import (
    buttord,
    cheb1ord,
    cheb2ord,
    ellipord,
    iirfilter,
)
from .statespace import _as_ss, ss2zpk


def iirdesign(wp, ws, gpass: float, gstop: float, ftype: str = 'ellip',
              fs: Optional[float] = None, output: str = 'sos'):
    """Complete IIR design from a band spec (scipy.signal.iirdesign,
    output='sos'): pick the minimum order with the family's *ord
    function, then design at that order. ``ftype`` in {'butter',
    'cheby1', 'cheby2', 'ellip'} (bessel has no order formula)."""
    ords = {'butter': buttord, 'butterworth': buttord,
            'cheby1': cheb1ord, 'chebyshev1': cheb1ord,
            'cheby2': cheb2ord, 'chebyshev2': cheb2ord,
            'ellip': ellipord, 'elliptic': ellipord, 'cauer': ellipord}
    ordfn = ords.get(ftype.lower())
    if ordfn is None:
        raise RuntimeError(f'iirdesign: unknown ftype {ftype!r}')
    n, wn = ordfn(wp, ws, gpass, gstop, fs=fs)
    wp_a = np.atleast_1d(np.asarray(wp, np.float64))
    btype = ('low' if wp_a[0] < np.atleast_1d(ws)[0] else 'high') \
        if wp_a.size == 1 else \
        ('bandstop' if wp_a[0] < np.atleast_1d(ws)[0] else 'bandpass')
    return iirfilter(n, wn, rp=gpass, rs=gstop, btype=btype,
                     ftype=ftype, fs=fs, output=output)


def _w_grid(worN, limit: float):
    if np.isscalar(worN):
        # scipy freqs: logspace around the interesting region; here the
        # caller supplied no explicit grid, so span 2 decades around the
        # characteristic frequency like scipy's findfreqs-lite
        return np.logspace(np.log10(limit) - 2.0, np.log10(limit) + 2.0,
                           int(worN))
    return np.asarray(worN, np.float64)


def freqs(b, a, worN=200):
    """Analog transfer-function response H(jw) (scipy.signal.freqs):
    ``worN`` is a frequency array, or a point count over an
    automatically chosen log grid. Returns (w, h)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if np.isscalar(worN):
        roots = np.concatenate([
            np.roots(a) if a.size > 1 else np.zeros(0),
            np.roots(b) if b.size > 1 else np.zeros(0)])
        limit = float(np.max(np.abs(roots))) if roots.size else 1.0
        w = _w_grid(int(worN), max(limit, 1e-3))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    h = np.polyval(b, s) / np.polyval(a, s)
    return w, h


def freqs_zpk(z, p, k, worN=200):
    """Analog zpk response (scipy.signal.freqs_zpk). Returns (w, h)."""
    z = np.atleast_1d(np.asarray(z, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    if np.isscalar(worN):
        roots = np.concatenate([z, p])
        limit = float(np.max(np.abs(roots))) if roots.size else 1.0
        w = _w_grid(int(worN), max(limit, 1e-3))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    num = k * np.prod(s[:, None] - z[None, :], axis=1) if z.size else \
        np.full(w.shape, k, complex)
    den = np.prod(s[:, None] - p[None, :], axis=1) if p.size else 1.0
    return w, num / den


def freqz_zpk(z, p, k, worN: int = 512, fs: float = 2.0 * np.pi):
    """Digital zpk response on the unit circle (scipy.signal.freqz_zpk):
    (w, h) over ``worN`` points on [0, fs/2)."""
    z = np.atleast_1d(np.asarray(z, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    if np.isscalar(worN):
        w = np.arange(int(worN)) * (fs / 2.0) / int(worN)
    else:
        w = np.asarray(worN, np.float64)
    zc = np.exp(1j * 2.0 * np.pi * w / fs)
    num = k * np.prod(zc[:, None] - z[None, :], axis=1) if z.size else \
        np.full(w.shape, k, complex)
    den = np.prod(zc[:, None] - p[None, :], axis=1) if p.size else 1.0
    return w, num / den


def freqresp(system, w=None, n: int = 10000):
    """Continuous-system frequency response H(jw)
    (scipy.signal.freqresp): returns (w, H)."""
    A, B, C, D = _as_ss(system)[:4]
    z, p, k = ss2zpk(A, B, C, D)
    if w is not None:
        return freqs_zpk(z, p, k, worN=np.asarray(w, np.float64))
    return freqs_zpk(z, p, k, worN=int(n))


def bode(system, w=None, n: int = 100):
    """Bode magnitude/phase (scipy.signal.bode): returns
    (w, mag_db, phase_deg) with the phase unwrapped."""
    w_out, h = freqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.maximum(np.abs(h), 1e-300))
    phase = np.rad2deg(np.unwrap(np.angle(h)))
    return w_out, mag, phase


def correlation_lags(in1_len: int, in2_len: int,
                     mode: str = 'full') -> np.ndarray:
    """Lag indices matching ``correlate(in1, in2, mode)``
    (scipy.signal.correlation_lags)."""
    if mode == 'full':
        return np.arange(-in2_len + 1, in1_len)
    if mode == 'same':
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lo = mid - in1_len // 2
        return lags[lo:lo + in1_len]
    if mode == 'valid':
        lo, hi = min(in1_len, in2_len), max(in1_len, in2_len)
        return np.arange(hi - lo + 1) + (0 if in1_len >= in2_len
                                         else lo - hi) \
            if in1_len >= in2_len else np.arange(in1_len - in2_len, 1)
    raise RuntimeError(f'correlation_lags: unknown mode {mode!r}')

