"""IIR design completion: elliptic + Bessel prototypes, order selection,
and the second-order notch/peak/comb designers (dsc_tpu/models/iirdesign.py,
the same NumPy code).

Extends the from-scratch zpk design pipeline in models/iir.py (analog
prototype -> band transform -> bilinear -> biquad pairing) with:

* ``ellip`` — Cauer/elliptic filters. The Jacobi elliptic functions
  (sn, cd, their inverses and the degree equation) are implemented from
  scratch via descending/ascending Landen transformations (the classic
  Orfanidis recipe), f64 host math — no scipy at runtime, scipy is the
  test oracle only.
* ``bessel`` — Thomson/Bessel filters from the reverse Bessel
  polynomial roots (``norm='phase'``, scipy's default).
* ``buttord / cheb1ord / cheb2ord / ellipord`` — minimum-order
  selection (scipy semantics: returns (N, Wn) meeting gpass/gstop);
  ellipord's degree equation uses a from-scratch AGM complete elliptic
  integral.
* ``iirfilter`` — the family dispatcher (scipy.signal.iirfilter with
  output='sos').
* ``iirnotch / iirpeak / iircomb`` — single-frequency biquad/comb
  designs returning (b, a).

Everything is design-time host f64 (the same policy as
firwin/remez/butter: design once, filter on device via
models/iir.py sosfilt/lfilter). scipy.signal is the executable spec.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .iir import _check_order, _iirdesign_sos

_EPS = np.finfo(np.float64).eps


# --------------------------------------------------------------------------
# Jacobi elliptic machinery (Landen transformations, f64)
# --------------------------------------------------------------------------


def _landen(k: float) -> list:
    """Descending Landen sequence of moduli from k (exclusive) toward 0."""
    v = []
    while k > _EPS:
        k = (k / (1.0 + np.sqrt(1.0 - k * k))) ** 2
        v.append(k)
        if len(v) > 64:  # k in [0,1): converges quadratically
            break
    return v


def _ellipk(k: float) -> float:
    """Complete elliptic integral K(k) (modulus convention) via the AGM:
    K = pi / (2 * agm(1, k'))."""
    if k >= 1.0:
        return np.inf
    a, b = 1.0, np.sqrt(1.0 - k * k)
    while abs(a - b) > _EPS * a:
        a, b = 0.5 * (a + b), np.sqrt(a * b)
    return np.pi / (2.0 * a)


def _sne(u, k: float):
    """sn(u*K, k) in quarter-period units (u may be complex array)."""
    v = _landen(k)
    w = np.sin(np.asarray(u) * np.pi / 2.0)
    for vn in reversed(v):
        w = (1.0 + vn) * w / (1.0 + vn * w * w)
    return w


def _cde(u, k: float):
    """cd(u*K, k) in quarter-period units (u may be complex array)."""
    v = _landen(k)
    w = np.cos(np.asarray(u) * np.pi / 2.0)
    for vn in reversed(v):
        w = (1.0 + vn) * w / (1.0 + vn * w * w)
    return w


def _asne(w, k: float):
    """Inverse of _sne (principal branch), in quarter-period units."""
    v = _landen(k)
    prev = [k] + v[:-1]
    w = np.asarray(w, complex)
    for vn, kp in zip(v, prev):
        w = 2.0 * w / ((1.0 + vn) * (1.0 + np.sqrt(1.0 - kp * kp * w * w)))
    return 2.0 / np.pi * np.arcsin(w)


def _ellipdeg(n: int, k1: float) -> float:
    """Solve the elliptic degree equation for the selectivity modulus k
    given order n and discrimination modulus k1 (Orfanidis eq. 11)."""
    l = n // 2
    ui = (2.0 * np.arange(1, l + 1) - 1.0) / n
    kc = np.sqrt(1.0 - k1 * k1)  # complement
    if kc == 1.0:
        return 0.0
    kp = kc ** n * float(np.prod(_sne(ui, kc))) ** 4
    return float(np.sqrt(1.0 - kp * kp))


def _ellipap(n: int, rp: float, rs: float):
    """Analog elliptic lowpass prototype (z, p, k): equiripple rp dB in
    the passband, rs dB stopband, passband edge at w = 1
    (scipy.signal.ellipap semantics via the Landen-transform recipe)."""
    if n == 1:
        # degenerate: same as cheby1
        p = np.asarray([-1.0 / np.sqrt(10.0 ** (0.1 * rp) - 1.0)], complex)
        return np.asarray([], complex), p, -p[0].real
    ep = np.sqrt(10.0 ** (0.1 * rp) - 1.0)
    es = np.sqrt(10.0 ** (0.1 * rs) - 1.0)
    k1 = ep / es
    k = _ellipdeg(n, k1)
    l = n // 2
    ui = (2.0 * np.arange(1, l + 1) - 1.0) / n
    # zeros: on the imaginary axis at the stopband ripple frequencies
    z = 1j / (k * np.real(_cde(ui, k)))
    z = np.concatenate([z, np.conj(z)])
    # poles
    v0 = float(np.real(-1j * _asne(1j / ep, k1))) / n
    p = 1j * _cde(ui - 1j * v0, k)
    p = np.concatenate([p, np.conj(p)])
    if n % 2:
        p = np.append(p, complex(1j * _sne(1j * v0, k)))
    kgain = np.real(np.prod(-p) / np.prod(-z))
    if n % 2 == 0:
        kgain /= np.sqrt(1.0 + ep * ep)
    return z, p, float(kgain)


# --------------------------------------------------------------------------
# public designs
# --------------------------------------------------------------------------


def ellip(N: int, rp: float, rs: float, Wn, btype: str = 'low',
          fs: Optional[float] = None, output: str = 'sos'):
    """Elliptic (Cauer) digital filter design in second-order sections
    (scipy.signal.ellip(..., output='sos') semantics): ``rp`` dB
    passband ripple, ``rs`` dB stopband attenuation, minimal transition
    width for the order. Jacobi elliptic functions computed from
    scratch via Landen transformations."""
    _check_order(N, 'ellip')
    if rp <= 0:
        raise RuntimeError(f'ellip: rp ({rp}) must be > 0 dB')
    if rs <= rp:
        raise RuntimeError(f'ellip: rs ({rs}) must exceed rp ({rp})')
    z, p, k = _ellipap(N, float(rp), float(rs))
    return _iirdesign_sos(z, p, k, N, Wn, btype, fs, 'ellip',
                          output=output)


def _besselap(n: int):
    """Analog Bessel lowpass prototype, ``norm='phase'`` (scipy default):
    poles are the roots of the degree-n reverse Bessel polynomial,
    scaled so the phase response hits its half-maximum lag at w = 1."""
    # theta_n(s) coefficients: a_k = (2n-k)! / (2^(n-k) k! (n-k)!)
    kk = np.arange(n + 1)
    from math import factorial
    coeffs = np.array([
        factorial(2 * n - ki) / (2.0 ** (n - ki) * factorial(ki)
                                 * factorial(n - ki))
        for ki in kk
    ])
    # np.roots wants highest power first: theta = sum a_k s^k
    p = np.roots(coeffs[::-1])
    # one Newton polish pass (np.roots loses digits by n ~ 15)
    poly = np.polynomial.Polynomial(coeffs)
    dpoly = poly.deriv()
    for _ in range(2):
        p = p - poly(p) / dpoly(p)
    a_last = float(coeffs[0])  # theta_n(0) = (2n)!/(2^n n!)
    p = p * 10.0 ** (-np.log10(a_last) / n)
    return np.asarray([], complex), p, 1.0


def bessel(N: int, Wn, btype: str = 'low',
           fs: Optional[float] = None, output: str = 'sos'):
    """Bessel/Thomson digital filter design in second-order sections
    (scipy.signal.bessel(..., output='sos', norm='phase') semantics):
    maximally flat group delay in the analog prototype."""
    _check_order(N, 'bessel')
    if N > 25:
        raise RuntimeError(
            f'bessel: order {N} > 25 (reverse Bessel polynomial roots '
            'lose f64 accuracy)')
    z, p, k = _besselap(N)
    return _iirdesign_sos(z, p, k, N, Wn, btype, fs, 'bessel',
                          output=output)


def iirfilter(N: int, Wn, rp: Optional[float] = None,
              rs: Optional[float] = None, btype: str = 'band',
              ftype: str = 'butter', fs: Optional[float] = None,
              output: str = 'sos'):
    """Family dispatcher (scipy.signal.iirfilter, output='sos'):
    ``ftype`` in {'butter', 'cheby1', 'cheby2', 'ellip', 'bessel'};
    ``btype`` defaults to 'band' like scipy."""
    from .iir import butter, cheby1, cheby2
    ftype_map = {'butter': 'butter', 'butterworth': 'butter',
                 'cheby1': 'cheby1', 'chebyshev1': 'cheby1',
                 'cheby2': 'cheby2', 'chebyshev2': 'cheby2',
                 'ellip': 'ellip', 'elliptic': 'ellip', 'cauer': 'ellip',
                 'bessel': 'bessel', 'thomson': 'bessel'}
    ft = ftype_map.get(ftype.lower())
    if ft is None:
        raise RuntimeError(f'iirfilter: unknown ftype {ftype!r}')
    if ft == 'butter':
        return butter(N, Wn, btype=btype, fs=fs, output=output)
    if ft == 'cheby1':
        if rp is None:
            raise RuntimeError('iirfilter: cheby1 needs rp')
        return cheby1(N, rp, Wn, btype=btype, fs=fs, output=output)
    if ft == 'cheby2':
        if rs is None:
            raise RuntimeError('iirfilter: cheby2 needs rs')
        return cheby2(N, rs, Wn, btype=btype, fs=fs, output=output)
    if ft == 'ellip':
        if rp is None or rs is None:
            raise RuntimeError('iirfilter: ellip needs rp and rs')
        return ellip(N, rp, rs, Wn, btype=btype, fs=fs, output=output)
    return bessel(N, Wn, btype=btype, fs=fs, output=output)


# --------------------------------------------------------------------------
# order selection (scipy *ord semantics)
# --------------------------------------------------------------------------


def _ord_prepare(wp, ws, fs, who: str):
    wp = np.atleast_1d(np.asarray(wp, np.float64))
    ws = np.atleast_1d(np.asarray(ws, np.float64))
    if fs is not None:
        wp = wp / (fs / 2.0)
        ws = ws / (fs / 2.0)
    if wp.shape != ws.shape or wp.size not in (1, 2):
        raise RuntimeError(f'{who}: wp/ws must both be scalars or pairs')
    if np.any(wp <= 0) or np.any(wp >= 1) or np.any(ws <= 0) \
            or np.any(ws >= 1):
        raise RuntimeError(f'{who}: band edges must lie in (0, 1)')
    if wp.size == 1:
        btype = 'low' if wp[0] < ws[0] else 'high'
    else:
        if wp[0] < ws[0] < ws[1] < wp[1]:
            btype = 'bandstop'
        elif ws[0] < wp[0] < wp[1] < ws[1]:
            btype = 'bandpass'
        else:
            raise RuntimeError(
                f'{who}: pass/stop bands must be strictly nested')
    return wp, ws, btype


def _ord_nat(wp, ws, btype: str) -> float:
    """Equivalent analog-lowpass selectivity |ws'/wp'| after prewarp +
    band transform (the scipy *ord construction)."""
    warp = np.tan(np.pi * wp / 2.0)
    wars = np.tan(np.pi * ws / 2.0)
    if btype == 'low':
        return float(wars[0] / warp[0])
    if btype == 'high':
        return float(warp[0] / wars[0])
    if btype == 'bandpass':
        nat = (wars ** 2 - warp[0] * warp[1]) / (wars * (warp[1] - warp[0]))
        return float(np.min(np.abs(nat)))
    # bandstop: transform the stop edges through the inverse mapping
    nat = (wars * (warp[1] - warp[0])) / (wars ** 2 - warp[0] * warp[1])
    return float(np.min(np.abs(nat)))


def _golden_max(f, lo: float, hi: float) -> float:
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(90):
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = f(d)
    return (a + b) / 2.0


def _validate_gpass_gstop(gpass: float, gstop: float) -> None:
    """scipy.signal._filter_design._validate_gpass_gstop semantics:
    both ripples must be positive dB values with gpass < gstop."""
    if gpass <= 0.0:
        raise RuntimeError(f'gpass should be larger than 0.0, got {gpass}')
    if gstop <= 0.0:
        raise RuntimeError(f'gstop should be larger than 0.0, got {gstop}')
    if gpass > gstop:
        raise RuntimeError(
            f'gpass should be smaller than gstop, got gpass={gpass}, '
            f'gstop={gstop}'
        )


def band_stop_obj(wp, ind, passb, stopb, gpass, gstop, type):
    """Band-stop objective function for order minimization
    (scipy.signal.band_stop_obj semantics): the non-integer analog
    filter order when passband edge ``ind`` (0 or 1) of the pre-warped
    edge array ``passb`` is moved to ``wp``. ``type`` is 'butter',
    'cheby' or 'ellip'. The internal *ord optimizers use the
    equivalent-lowpass-selectivity formulation (_optimize_bandstop_edges
    — every family's order is strictly decreasing in selectivity); this
    public function evaluates the order itself, scipy-faithfully."""
    _validate_gpass_gstop(gpass, gstop)
    passb = np.asarray(passb, np.float64).copy()
    stopb = np.asarray(stopb, np.float64)
    passb[int(ind)] = float(wp)
    nat = (stopb * (passb[0] - passb[1])
           / (stopb ** 2 - passb[0] * passb[1]))
    nat = float(np.min(np.abs(nat)))
    if type == 'butter':
        gs = 10.0 ** (0.1 * abs(gstop))
        gp = 10.0 ** (0.1 * abs(gpass))
        return float(np.log10((gs - 1.0) / (gp - 1.0))
                     / (2.0 * np.log10(nat)))
    if type == 'cheby':
        gs = 10.0 ** (0.1 * abs(gstop))
        gp = 10.0 ** (0.1 * abs(gpass))
        return float(np.arccosh(np.sqrt((gs - 1.0) / (gp - 1.0)))
                     / np.arccosh(nat))
    if type == 'ellip':
        gs = 10.0 ** (0.1 * gstop)
        gp = 10.0 ** (0.1 * gpass)
        arg1 = np.sqrt((gp - 1.0) / (gs - 1.0))
        arg0 = 1.0 / nat
        return float(
            _ellipk(arg0) * _ellipk(np.sqrt(1.0 - arg1 * arg1))
            / (_ellipk(np.sqrt(1.0 - arg0 * arg0)) * _ellipk(arg1)))
    raise RuntimeError(f'band_stop_obj: incorrect type {type!r}')


def _optimize_bandstop_edges(wp, ws):
    """For bandstop specs the DESIGN passband edges may sit anywhere
    between the requested edges and the stopband (the design still meets
    the requested spec); scipy's *ord functions move them to minimize the
    order — equivalently maximize the equivalent-lowpass selectivity,
    which every family's order formula is strictly decreasing in
    (scipy band_stop_obj construction)."""
    wp = wp.copy()
    wp[0] = _golden_max(
        lambda e: _ord_nat(np.array([e, wp[1]]), ws, 'bandstop'),
        wp[0], ws[0] - 1e-12)
    wp[1] = _golden_max(
        lambda e: _ord_nat(np.array([wp[0], e]), ws, 'bandstop'),
        ws[1] + 1e-12, wp[1])
    return wp


def _db2(g: float) -> float:
    return 10.0 ** (0.1 * abs(g)) - 1.0


def buttord(wp, ws, gpass: float, gstop: float,
            fs: Optional[float] = None):
    """Minimum Butterworth order meeting <= gpass dB passband loss and
    >= gstop dB stopband attenuation (scipy.signal.buttord semantics).
    Returns (N, Wn) with Wn placed so the stopband spec is met exactly
    (scipy's choice); feed to :func:`butter`."""
    _validate_gpass_gstop(gpass, gstop)
    wp, ws, btype = _ord_prepare(wp, ws, fs, 'buttord')
    if btype == 'bandstop':
        wp = _optimize_bandstop_edges(wp, ws)
    nat = _ord_nat(wp, ws, btype)
    n = int(np.ceil(np.log10(_db2(gstop) / _db2(gpass))
                    / (2.0 * np.log10(nat))))
    n = max(n, 1)
    # scipy: the natural (3 dB-ish) frequency W0 in the equivalent
    # lowpass is placed so gpass is met EXACTLY at the passband edge
    w0 = _db2(gpass) ** (-1.0 / (2.0 * n))
    warp = np.tan(np.pi * wp / 2.0)
    if btype == 'low':
        wn = np.array([w0 * warp[0]])
    elif btype == 'high':
        wn = np.array([warp[0] / w0])
    elif btype == 'bandpass':
        # solve (w^2 - p0 p1)/(w*dp) = +-w0 for w
        d = w0 * (warp[1] - warp[0])
        disc = np.sqrt(d * d + 4.0 * warp[0] * warp[1])
        wn = np.sort(np.abs(np.array([(-d + disc) / 2.0,
                                      (d + disc) / 2.0])))
    else:  # bandstop: solve (w*dp)/(p0 p1 - w^2) = +-w0 for w
        d2 = (warp[1] - warp[0]) / (2.0 * w0)
        disc = np.sqrt(d2 * d2 + warp[0] * warp[1])
        wn = np.sort(np.abs(np.array([-d2 + disc, d2 + disc])))
    wn = 2.0 / np.pi * np.arctan(wn)
    if fs is not None:
        wn = wn * fs / 2.0
    return n, (float(wn[0]) if wn.size == 1 else wn)


def cheb1ord(wp, ws, gpass: float, gstop: float,
             fs: Optional[float] = None):
    """Minimum Chebyshev-I order for the spec (scipy.signal.cheb1ord);
    returns (N, Wn=passband edge — for bandstop the edges moved inward
    to the order-minimizing positions, scipy semantics) for
    :func:`cheby1`."""
    _validate_gpass_gstop(gpass, gstop)
    wp, ws, btype = _ord_prepare(wp, ws, fs, 'cheb1ord')
    if btype == 'bandstop':
        wp = _optimize_bandstop_edges(wp, ws)
    nat = _ord_nat(wp, ws, btype)
    d = np.sqrt(_db2(gstop) / _db2(gpass))
    n = max(int(np.ceil(np.arccosh(d) / np.arccosh(nat))), 1)
    wn = wp.copy()
    if fs is not None:
        wn = wn * fs / 2.0
    return n, (float(wn[0]) if wn.size == 1 else wn)


def cheb2ord(wp, ws, gpass: float, gstop: float,
             fs: Optional[float] = None):
    """Minimum Chebyshev-II order for the spec (scipy.signal.cheb2ord);
    returns (N, Wn) placed so gstop is met exactly at order N (scipy
    construction) for :func:`cheby2`."""
    _validate_gpass_gstop(gpass, gstop)
    wp, ws, btype = _ord_prepare(wp, ws, fs, 'cheb2ord')
    if btype == 'bandstop':
        wp = _optimize_bandstop_edges(wp, ws)
    nat = _ord_nat(wp, ws, btype)
    d = np.sqrt(_db2(gstop) / _db2(gpass))
    n = max(int(np.ceil(np.arccosh(d) / np.arccosh(nat))), 1)
    # the stopband edge that meets gstop exactly at order n
    new_freq = np.cosh(1.0 / n * np.arccosh(d))
    warp = np.tan(np.pi * wp / 2.0)
    if btype == 'low':
        wn = np.array([warp[0] * new_freq])
    elif btype == 'high':
        wn = np.array([warp[0] / new_freq])
    elif btype == 'bandpass':
        d0 = warp[0] * warp[1]
        d1 = (warp[1] - warp[0]) * new_freq
        disc = np.sqrt(d1 * d1 + 4.0 * d0)
        wn = np.sort(np.array([(disc - d1) / 2.0, (disc + d1) / 2.0]))
    else:
        d0 = warp[0] * warp[1]
        d1 = (warp[1] - warp[0]) / new_freq
        disc = np.sqrt(d1 * d1 + 4.0 * d0)
        wn = np.sort(np.array([(disc - d1) / 2.0, (disc + d1) / 2.0]))
    wn = 2.0 / np.pi * np.arctan(wn)
    if fs is not None:
        wn = wn * fs / 2.0
    return n, (float(wn[0]) if wn.size == 1 else wn)


def ellipord(wp, ws, gpass: float, gstop: float,
             fs: Optional[float] = None):
    """Minimum elliptic order for the spec (scipy.signal.ellipord):
    N = ceil(K(k)K'(k1) / (K'(k)K(k1))) with k = 1/nat,
    k1 = sqrt(db2(gpass)/db2(gstop)), K the complete elliptic integral
    (AGM). Returns (N, Wn=passband edge) for :func:`ellip`."""
    _validate_gpass_gstop(gpass, gstop)
    wp, ws, btype = _ord_prepare(wp, ws, fs, 'ellipord')
    if btype == 'bandstop':
        wp = _optimize_bandstop_edges(wp, ws)
    nat = _ord_nat(wp, ws, btype)
    k = 1.0 / nat
    k1 = np.sqrt(_db2(gpass) / _db2(gstop))
    kc = np.sqrt(1.0 - k * k)
    k1c = np.sqrt(1.0 - k1 * k1)
    n = int(np.ceil(_ellipk(k) * _ellipk(k1c)
                    / (_ellipk(kc) * _ellipk(k1))))
    n = max(n, 1)
    wn = wp.copy()
    if fs is not None:
        wn = wn * fs / 2.0
    return n, (float(wn[0]) if wn.size == 1 else wn)


# --------------------------------------------------------------------------
# second-order notch / peak / comb (scipy closed forms)
# --------------------------------------------------------------------------


def _notch_peak(w0: float, Q: float, fs: float, kind: str):
    if fs is not None:
        w0 = 2.0 * w0 / fs
    if not 0 < w0 < 1:
        raise RuntimeError(f'iir{kind}: w0 must lie in (0, fs/2)')
    w0 = w0 * np.pi
    bw = w0 / Q
    gb = 1.0 / np.sqrt(2.0)
    if kind == 'notch':
        beta = gb / np.sqrt(1.0 - gb * gb) * np.tan(bw / 2.0)
    else:
        beta = np.sqrt(1.0 - gb * gb) / gb * np.tan(bw / 2.0)
    gain = 1.0 / (1.0 + beta)
    if kind == 'notch':
        b = gain * np.array([1.0, -2.0 * np.cos(w0), 1.0])
    else:
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    a = np.array([1.0, -2.0 * gain * np.cos(w0), 2.0 * gain - 1.0])
    return b, a


def iirnotch(w0: float, Q: float, fs: float = 2.0):
    """Second-order notch biquad (scipy.signal.iirnotch): unit gain with
    a -3 dB-bandwidth w0/Q null at w0. Returns (b, a)."""
    return _notch_peak(float(w0), float(Q), float(fs), 'notch')


def iirpeak(w0: float, Q: float, fs: float = 2.0):
    """Second-order resonator biquad (scipy.signal.iirpeak): unit-gain
    peak at w0, zero at DC and Nyquist. Returns (b, a)."""
    return _notch_peak(float(w0), float(Q), float(fs), 'peak')


def iircomb(w0: float, Q: float, ftype: str = 'notch', fs: float = 2.0,
            pass_zero: bool = False):
    """Comb notch/peak filter (scipy.signal.iircomb): N = fs/w0 evenly
    spaced notches (``ftype='notch'``) or resonant peaks (``'peak'``),
    each with -3 dB bandwidth w0/Q. ``pass_zero=False`` (default) puts
    the teeth at the harmonics 0, w0, 2*w0, ...; ``True`` shifts them to
    the odd half-harmonics w0/2, 3*w0/2, .... Returns (b, a) of degree
    N: H(z) = g*(1 ± z^-N)/(1 ± a_N z^-N)."""
    w0, Q, fs = float(w0), float(Q), float(fs)
    if not 0 < w0 <= fs / 2.0:
        raise RuntimeError('iircomb: w0 must lie in (0, fs/2]')
    if ftype not in ('notch', 'peak'):
        raise RuntimeError(f'iircomb: unknown ftype {ftype!r}')
    order = fs / w0
    n = int(round(order))
    if abs(order - n) > 1e-8:
        raise RuntimeError(
            f'iircomb: fs/w0 = {order} is not an integer (w0 must divide '
            'fs)')
    # half-power tooth bandwidth in rad/sample; gb = 1/sqrt(2) makes the
    # Orfanidis beta = tan(N*bw/4) exactly
    w_delta = 2.0 * np.pi * (w0 / Q) / fs
    beta = np.tan(n * w_delta / 4.0)
    ax = (1.0 - beta) / (1.0 + beta)
    gx = 1.0 / (1.0 + beta) if ftype == 'notch' else beta / (1.0 + beta)
    # numerator sign: '-' places zeros (notch) / antiresonances (peak) at
    # the harmonics incl. DC; '+' at the odd half-harmonics
    nsign = 1.0 if pass_zero else -1.0
    # the poles sit WITH the zeros for a notch, BETWEEN them for a peak
    asign = nsign if ftype == 'notch' else -nsign
    b = np.zeros(n + 1)
    a = np.zeros(n + 1)
    b[0], b[n] = gx, nsign * gx
    a[0], a[n] = 1.0, asign * ax
    return b, a
