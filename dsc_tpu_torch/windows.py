"""Window functions (dsc_tpu/windows.py).

The numpy-family generators (hanning, hamming, blackman, kaiser, bartlett,
tukey) compute their window on the context's device in float64 torch ops
and round once to the requested dtype, matching ``np.hanning`` and its
kin bit-for-bit at f64 and to f32 rounding otherwise; ``kaiser`` rides the
same Bessel-I0 as the public ``dsc.i0`` op (ops/kernels.py). All follow
NumPy's symmetric convention: ``n == 1`` gives ``[1.0]`` and the formula
uses ``n - 1`` in the denominator.

The scipy.signal.windows tier (flattop, chebwin, taylor, dpss, ...) and the
``get_window`` dispatcher design their windows on the host in float64
(``design_window`` and the ``_np_*`` designers, NumPy code carried over
as it is) and upload them. Under ``dsc.compile`` every generator is a
creation op: its window is a constant of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import capture, interop, tracing
from .context import device as _device
from .dtype import DTYPE_TO_NP, Dtype
from .interop import TORCH_DTYPE
from .ops import kernels as K
from .tensor import Tensor


def _real_dtype(kind: str, dtype) -> Dtype:
    dtype = Dtype(dtype)
    if dtype.is_complex:
        raise RuntimeError(f'{kind} window requires a real dtype, got {dtype}')
    return dtype


def _device_window(kind: str, n: int, dtype, args: dict, formula) -> Tensor:
    """A window of ``n`` points from ``formula(k)``, k = 0..n-1 in float64
    on the device, rounded once to ``dtype``; n < 1 gives an empty window,
    n == 1 a one."""
    tdt = TORCH_DTYPE[_real_dtype(kind, dtype)]

    def make():
        with tracing.trace_op(kind, 'op;creation', args):
            dev = _device()
            if n < 1:
                res = torch.zeros(0, dtype=tdt, device=dev)
            elif n == 1:
                res = torch.ones(n, dtype=tdt, device=dev)
            else:
                k = torch.arange(n, dtype=torch.float64, device=dev)
                res = formula(k).to(tdt)
            return Tensor._from_torch(res)

    return capture.created(make)


_COSINE_WINDOWS = {
    'hanning': (0.5, 0.5, 0.0),
    'hamming': (0.54, 0.46, 0.0),
    'blackman': (0.42, 0.5, 0.08),
}


def _cosine_window(kind: str, n: int, dtype) -> Tensor:
    # a0 - a1*cos(2*pi*k/(n-1)) + a2*cos(4*pi*k/(n-1)), angles in float64
    a0, a1, a2 = _COSINE_WINDOWS[kind]

    def formula(k):
        th = 2.0 * np.pi * k / (n - 1)
        return a0 - a1 * torch.cos(th) + a2 * torch.cos(2.0 * th)

    return _device_window(kind, n, dtype, {'n': n}, formula)


def hanning(n: int, dtype: Dtype = Dtype.F32) -> Tensor:
    """Hann window of length n (np.hanning semantics)."""
    return _cosine_window('hanning', n, dtype)


def hamming(n: int, dtype: Dtype = Dtype.F32) -> Tensor:
    """Hamming window of length n (np.hamming semantics)."""
    return _cosine_window('hamming', n, dtype)


def blackman(n: int, dtype: Dtype = Dtype.F32) -> Tensor:
    """Blackman window of length n (np.blackman semantics)."""
    return _cosine_window('blackman', n, dtype)


def kaiser(n: int, beta: float, dtype: Dtype = Dtype.F32) -> Tensor:
    """Kaiser window of length n with shape parameter beta (np.kaiser
    semantics), computed through the same Bessel-I0 as dsc.i0."""
    beta = float(beta)

    def formula(k):
        r = 2.0 * k / (n - 1) - 1.0
        arg = beta * torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
        b = torch.full((), beta, dtype=torch.float64, device=k.device)
        return K.i0(arg) / K.i0(b)

    return _device_window('kaiser', n, dtype, {'n': n, 'beta': beta}, formula)


def bartlett(n: int, dtype: Dtype = Dtype.F32) -> Tensor:
    """Bartlett (triangular) window of length n (np.bartlett semantics)."""
    return _device_window('bartlett', n, dtype, {'n': n},
                          lambda k: 1.0 - torch.abs(2.0 * k / (n - 1) - 1.0))


def tukey(n: int, alpha: float = 0.5, dtype: Dtype = Dtype.F32) -> Tensor:
    """Tukey (tapered-cosine) window (scipy.signal.windows.tukey
    symmetric semantics): ``alpha=0`` is rectangular, ``alpha=1`` is
    Hann."""
    if not 0.0 <= alpha <= 1.0:
        raise RuntimeError(f'tukey: alpha ({alpha}) must be in [0, 1]')
    alpha = float(alpha)

    def formula(k):
        edge = alpha * (n - 1) / 2.0
        # symmetric tapered cosine: cosine ramps over the first/last
        # alpha/2 fraction, flat top between (all of it at alpha = 0)
        left = 0.5 * (1.0 + torch.cos(np.pi * (k / max(edge, 1e-300) - 1.0)))
        right = 0.5 * (1.0 + torch.cos(np.pi * ((k - (n - 1 - edge)) / max(edge, 1e-300))))
        return torch.where(k < edge, left, torch.where(k > n - 1 - edge, right, 1.0))

    return _device_window('tukey', n, dtype, {'n': n, 'alpha': alpha}, formula)


# ---------------------------------------------------------------------------
# scipy.signal.windows parity tier
#
# The generators above mirror NumPy's window functions on-device. The tier
# below completes the scipy.signal.windows family (flattop, blackmanharris,
# nuttall, gaussian, chebwin, taylor, dpss, ...) plus the get_window
# dispatcher that welch/spectrogram/firwin specs name windows through.
# These are design-time objects (tiny, computed once per pipeline), so they
# are designed host-side in f64 — the same policy as firwin/remez/butter
# coefficient design — and uploaded as device Tensors.
# ---------------------------------------------------------------------------

_COSINE_SUM_COEFFS = {
    'hann': (0.5, 0.5),
    'hamming': (0.54, 0.46),
    'blackman': (0.42, 0.50, 0.08),
    'flattop': (0.21557895, 0.41663158, 0.277263158, 0.083578947,
                0.006947368),
    'blackmanharris': (0.35875, 0.48829, 0.14128, 0.01168),
    'nuttall': (0.3635819, 0.4891775, 0.1365995, 0.0106411),
}


def _np_cosine_sum(m: int, coeffs) -> 'np.ndarray':
    # scipy.signal.windows.general_cosine: sum_j a_j*cos(j*fac) over
    # fac = linspace(-pi, pi, m); equivalently sum_j (-1)^j a_j cos(2pi j k/(m-1))
    fac = np.linspace(-np.pi, np.pi, m)
    w = np.zeros(m)
    for j, a in enumerate(coeffs):
        w += a * np.cos(j * fac)
    return w


def _np_window(kind: str, m: int, params: tuple) -> 'np.ndarray':
    """Symmetric window of length m >= 2, f64 host (scipy formulas)."""
    k = np.arange(m, dtype=np.float64)
    if kind in _COSINE_SUM_COEFFS:
        return _np_cosine_sum(m, _COSINE_SUM_COEFFS[kind])
    if kind == 'general_cosine':
        return _np_cosine_sum(m, tuple(np.asarray(params[0], np.float64)))
    if kind == 'general_hamming':
        (alpha,) = params
        return _np_cosine_sum(m, (alpha, 1.0 - alpha))
    if kind == 'boxcar':
        return np.ones(m)
    if kind == 'triang':
        d = np.abs(k - (m - 1) / 2.0)
        den = m + 1.0 if m % 2 else float(m)
        return 1.0 - 2.0 * d / den
    if kind == 'bartlett':
        return np.bartlett(m)
    if kind == 'barthann':
        f = k / (m - 1) - 0.5
        return 0.62 - 0.48 * np.abs(f) + 0.38 * np.cos(2.0 * np.pi * f)
    if kind == 'bohman':
        fac = np.abs(2.0 * k / (m - 1) - 1.0)
        w = (1.0 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
        w[0] = 0.0
        w[-1] = 0.0
        return w
    if kind == 'parzen':
        nn = k - (m - 1) / 2.0
        a = np.abs(nn) / (m / 2.0)
        return np.where(np.abs(nn) <= (m - 1) / 4.0,
                        1.0 - 6.0 * a * a + 6.0 * a ** 3,
                        2.0 * (1.0 - a) ** 3)
    if kind == 'cosine':
        return np.sin(np.pi * (k + 0.5) / m)
    if kind == 'lanczos':
        return np.sinc(2.0 * k / (m - 1) - 1.0)
    if kind == 'tukey':
        alpha = params[0] if params else 0.5
        return _np_tukey_sym(m, float(alpha))
    if kind == 'kaiser':
        (beta,) = params
        return np.kaiser(m, float(beta))
    if kind == 'gaussian':
        (std,) = params
        nn = k - (m - 1) / 2.0
        return np.exp(-0.5 * (nn / float(std)) ** 2)
    if kind == 'general_gaussian':
        p, sig = params
        nn = k - (m - 1) / 2.0
        return np.exp(-0.5 * np.abs(nn / float(sig)) ** (2.0 * float(p)))
    if kind == 'exponential':
        center = params[0] if len(params) > 0 and params[0] is not None \
            else (m - 1) / 2.0
        tau = params[1] if len(params) > 1 else 1.0
        return np.exp(-np.abs(k - float(center)) / float(tau))
    if kind == 'chebwin':
        (at,) = params
        return _np_chebwin(m, float(at))
    if kind == 'taylor':
        nbar = int(params[0]) if len(params) > 0 else 4
        sll = float(params[1]) if len(params) > 1 else 30.0
        norm = bool(params[2]) if len(params) > 2 else True
        return _np_taylor(m, nbar, sll, norm)
    if kind == 'kaiser_bessel_derived':
        (beta,) = params
        return _np_kbd(m, float(beta))
    if kind == 'dpss':
        nw = float(params[0])
        return _np_dpss_single(m, nw)
    raise RuntimeError(f'unknown window kind {kind!r}')


def _np_tukey_sym(m: int, alpha: float) -> 'np.ndarray':
    if alpha <= 0:
        return np.ones(m)
    if alpha >= 1.0:
        return np.hanning(m)
    k = np.arange(m, dtype=np.float64)
    edge = alpha * (m - 1) / 2.0
    w = np.ones(m)
    lo = k < edge
    hi = k > m - 1 - edge
    w[lo] = 0.5 * (1.0 + np.cos(np.pi * (k[lo] / edge - 1.0)))
    w[hi] = 0.5 * (1.0 + np.cos(np.pi * (k[hi] - (m - 1 - edge)) / edge))
    return w


def _np_chebwin(m: int, at: float) -> 'np.ndarray':
    """Dolph-Chebyshev window: order-(m-1) Chebyshev polynomial sampled on
    the unit circle, returned to lag domain by an FFT (scipy.signal
    .windows.chebwin semantics, equiripple sidelobes `at` dB down)."""
    order = m - 1
    beta = np.cosh(np.arccosh(10.0 ** (abs(at) / 20.0)) / order)
    x = beta * np.cos(np.pi * np.arange(m) / m)
    # T_order(x) evaluated piecewise to stay real for |x| crossing 1
    p = np.empty(m)
    inside = np.abs(x) <= 1.0
    p[inside] = np.cos(order * np.arccos(x[inside]))
    above = x > 1.0
    p[above] = np.cosh(order * np.arccosh(x[above]))
    below = x < -1.0
    p[below] = (2.0 * (m % 2) - 1.0) * np.cosh(order * np.arccosh(-x[below]))
    if m % 2:
        w = np.real(np.fft.fft(p))
        n = (m + 1) // 2
        w = w[:n]
        w = np.concatenate((w[n - 1:0:-1], w))
    else:
        w = np.real(np.fft.fft(p * np.exp(1j * np.pi / m * np.arange(m))))
        n = m // 2 + 1
        w = np.concatenate((w[n - 1:0:-1], w[1:n]))
    return w / w.max()


def _np_taylor(m: int, nbar: int, sll: float, norm: bool) -> 'np.ndarray':
    """Taylor window (scipy.signal.windows.taylor): nbar near-constant
    sidelobes sll dB below the mainlobe, via the first nbar-1 Fourier
    coefficients of the ideal Taylor taper."""
    b = 10.0 ** (sll / 20.0)
    a = np.arccosh(b) / np.pi
    s2 = nbar ** 2 / (a ** 2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar, dtype=np.float64)
    fm = np.zeros(nbar - 1)
    signs = np.where(np.arange(nbar - 1) % 2 == 0, 1.0, -1.0)
    m2 = ma * ma
    for mi in range(len(ma)):
        numer = signs[mi] * np.prod(
            1.0 - m2[mi] / s2 / (a ** 2 + (ma - 0.5) ** 2))
        denom = 2.0 * np.prod(1.0 - m2[mi] / m2[:mi]) * np.prod(
            1.0 - m2[mi] / m2[mi + 1:])
        fm[mi] = numer / denom

    def taper(n):
        return 1.0 + 2.0 * np.dot(
            fm, np.cos(2.0 * np.pi * ma[:, None] * (n - m / 2.0 + 0.5) / m))

    w = taper(np.arange(m, dtype=np.float64))
    if norm:
        w /= taper(np.asarray([(m - 1) / 2.0]))[0]
    return w


def _np_kbd(m: int, beta: float) -> 'np.ndarray':
    """Kaiser-Bessel-derived window (even m, symmetric only): square root
    of the running sum of a half-length kaiser, mirrored (the MDCT
    Princen-Bradley window)."""
    if m % 2:
        raise RuntimeError(
            f'kaiser_bessel_derived requires an even length, got {m}')
    kw = np.kaiser(m // 2 + 1, beta)
    csum = np.cumsum(kw)
    half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate((half, half[::-1]))


def _np_dpss(m: int, nw: float, kmax: int) -> 'np.ndarray':
    """First kmax discrete prolate spheroidal (Slepian) sequences: the top
    eigenvectors of the tridiagonal spectral-concentration operator
    (scipy.signal.windows.dpss construction and sign conventions)."""
    if not 0 < nw <= m / 2.0:
        raise RuntimeError(f'dpss: NW ({nw}) must be in (0, {m / 2}]')
    if not 1 <= kmax <= m:
        raise RuntimeError(f'dpss: Kmax ({kmax}) must be in [1, {m}]')
    ww = nw / m
    nidx = np.arange(m, dtype=np.float64)
    d = ((m - 1.0 - 2.0 * nidx) / 2.0) ** 2 * np.cos(2.0 * np.pi * ww)
    e = nidx[1:] * (m - nidx[1:]) / 2.0
    try:
        from scipy.linalg import eigh_tridiagonal
        _, wins = eigh_tridiagonal(
            d, e, select='i', select_range=(m - kmax, m - 1))
        wins = wins[:, ::-1].T
    except ImportError:  # pragma: no cover - dense fallback
        t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        _, vecs = np.linalg.eigh(t)
        wins = vecs[:, ::-1][:, :kmax].T
    # scipy polarity conventions: symmetric orders get positive mean,
    # antisymmetric orders start positive
    fix = wins[::2].sum(axis=1) < 0
    wins[::2][fix] *= -1
    thresh = max(1e-7, 1.0 / m)
    for i, w in enumerate(wins[1::2]):
        sig = w[np.abs(w) > thresh]
        if sig.size and sig[0] < 0:
            wins[2 * i + 1] *= -1
    return wins


def _np_dpss_single(m: int, nw: float) -> 'np.ndarray':
    """Single max-concentration taper under scipy's Kmax=None default
    norm='approximate': peak-normalized, with the m^2/(m^2+NW) even-length
    amplitude correction."""
    w = _np_dpss(m, nw, 1)[0]
    w = w / w.max()
    if m % 2 == 0:
        w *= m * m / float(m * m + nw)
    return w


_WINDOW_ALIASES = {}
for _canon, _names in {
    'barthann': ('barthann', 'brthan', 'bth'),
    'bartlett': ('bartlett', 'bart', 'brt'),
    'blackman': ('blackman', 'black', 'blk'),
    'blackmanharris': ('blackmanharris', 'blackharr', 'bkh'),
    'bohman': ('bohman', 'bman', 'bmn'),
    'boxcar': ('boxcar', 'box', 'ones', 'rect', 'rectangular'),
    'chebwin': ('chebwin', 'cheb'),
    'cosine': ('cosine', 'halfcosine'),
    'dpss': ('dpss',),
    'exponential': ('exponential', 'poisson'),
    'flattop': ('flattop', 'flat', 'flt'),
    'gaussian': ('gaussian', 'gauss', 'gss'),
    'general_cosine': ('general cosine', 'general_cosine'),
    'general_gaussian': ('general gaussian', 'general_gaussian',
                         'general gauss', 'general_gauss', 'ggs'),
    'general_hamming': ('general hamming', 'general_hamming'),
    'hamming': ('hamming', 'hamm', 'ham'),
    'hann': ('hann', 'han', 'hanning'),
    'kaiser': ('kaiser', 'ksr'),
    'kaiser_bessel_derived': ('kaiser bessel derived', 'kbd'),
    'lanczos': ('lanczos', 'sinc'),
    'nuttall': ('nuttall', 'nutl', 'nut'),
    'parzen': ('parzen', 'parz', 'par'),
    'taylor': ('taylor', 'taylorwin'),
    'triang': ('triangle', 'triang', 'tri'),
    'tukey': ('tukey', 'tuk'),
}.items():
    for _nm in _names:
        _WINDOW_ALIASES[_nm] = _canon

# names that cannot be called without a shape parameter
_NEEDS_PARAM = {'chebwin', 'dpss', 'gaussian', 'general_cosine',
                'general_gaussian', 'general_hamming', 'kaiser',
                'kaiser_bessel_derived'}


def design_window(window, n: int, fftbins: bool = True) -> 'np.ndarray':
    """scipy.signal.get_window semantics, returned as a host f64 array:
    ``window`` is a name, a ``(name, *params)`` tuple, or a bare float
    (kaiser beta); ``fftbins=True`` gives the PERIODIC (DFT-even) variant
    — the length-(n+1) symmetric window minus its last sample."""
    if isinstance(window, (int, float)) and not isinstance(window, bool):
        kind, params = 'kaiser', (float(window),)
    elif isinstance(window, str):
        kind = _WINDOW_ALIASES.get(window.lower())
        if kind is None:
            raise RuntimeError(f'unknown window {window!r}')
        if kind in _NEEDS_PARAM:
            raise RuntimeError(
                f'the {kind!r} window needs parameters: pass a tuple '
                f'like ({kind!r}, param)')
        params = ()
    elif isinstance(window, tuple) and window and isinstance(window[0], str):
        kind = _WINDOW_ALIASES.get(window[0].lower())
        if kind is None:
            raise RuntimeError(f'unknown window {window[0]!r}')
        params = tuple(window[1:])
    else:
        raise RuntimeError(f'cannot interpret window spec {window!r}')
    if n < 0:
        raise RuntimeError(f'window length must be non-negative, got {n}')
    if n in (0, 1):
        return np.ones(n, dtype=np.float64)
    if kind == 'exponential' and fftbins and params and \
            params[0] is not None:
        # scipy: a periodic exponential keeps the explicit center
        m, trunc = n + 1, True
    elif kind == 'kaiser_bessel_derived':
        if fftbins:
            raise RuntimeError(
                'kaiser_bessel_derived is defined only as symmetric '
                '(fftbins=False)')
        m, trunc = n, False
    elif fftbins:
        m, trunc = n + 1, True
    else:
        m, trunc = n, False
    w = _np_window(kind, m, params)
    return w[:-1] if trunc else w


def _upload(kind: str, args: dict, design, dtype) -> Tensor:
    """The host-designed window ``design()`` (float64) uploaded in
    ``dtype``, a creation op."""
    np_dt = DTYPE_TO_NP[_real_dtype(kind, dtype)]

    def make():
        with tracing.trace_op(kind, 'op;creation', args):
            return Tensor._from_torch(interop.put(design().astype(np_dt)))

    return capture.created(make)


def get_window(window, n: int, fftbins: bool = True,
               dtype: Dtype = Dtype.F32) -> Tensor:
    """Return a window of length ``n`` as a device Tensor
    (scipy.signal.get_window semantics; see ``design_window``)."""
    _real_dtype('get_window', dtype)
    spec = window if isinstance(window, (str, int, float)) else tuple(window)
    return _upload('get_window', {'window': str(spec), 'n': n},
                   lambda: design_window(window, n, fftbins=fftbins), dtype)


def _scipy_style_window(kind: str, n: int, params: tuple, sym: bool,
                        dtype: Dtype) -> Tensor:
    def design():
        if n < 1:
            return np.zeros((0,))
        if n == 1:
            return np.ones((1,))
        if sym:
            return _np_window(kind, n, params)
        return _np_window(kind, n + 1, params)[:-1]

    return _upload(kind, {'n': n}, design, dtype)


def flattop(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Flat-top window (scipy.signal.windows.flattop): 5-term cosine sum
    optimized for amplitude-accurate spectral peak measurement."""
    return _scipy_style_window('flattop', n, (), sym, dtype)


def hann(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Hann window (scipy.signal.windows.hann: raised cosine; ``sym=True``
    matches np.hanning, ``sym=False`` is the periodic DFT-even form)."""
    return _scipy_style_window('hann', n, (), sym, dtype)


def blackmanharris(n: int, sym: bool = True,
                   dtype: Dtype = Dtype.F32) -> Tensor:
    """4-term Blackman-Harris window (-92 dB sidelobes)."""
    return _scipy_style_window('blackmanharris', n, (), sym, dtype)


def nuttall(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Nuttall 4-term minimum-sidelobe window."""
    return _scipy_style_window('nuttall', n, (), sym, dtype)


def general_cosine(n: int, a, sym: bool = True,
                   dtype: Dtype = Dtype.F32) -> Tensor:
    """Generic weighted cosine-sum window with coefficients ``a``
    (scipy.signal.windows.general_cosine)."""
    return _scipy_style_window('general_cosine', n, (tuple(a),), sym, dtype)


def general_hamming(n: int, alpha: float, sym: bool = True,
                    dtype: Dtype = Dtype.F32) -> Tensor:
    """Generalized Hamming window alpha - (1-alpha)cos(...)."""
    return _scipy_style_window('general_hamming', n, (float(alpha),), sym,
                               dtype)


def boxcar(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Rectangular window (all ones)."""
    return _scipy_style_window('boxcar', n, (), sym, dtype)


def triang(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Triangular window (scipy.signal.windows.triang — nonzero endpoints,
    unlike bartlett)."""
    return _scipy_style_window('triang', n, (), sym, dtype)


def barthann(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Modified Bartlett-Hann window."""
    return _scipy_style_window('barthann', n, (), sym, dtype)


def bohman(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Bohman window."""
    return _scipy_style_window('bohman', n, (), sym, dtype)


def parzen(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Parzen (de la Vallee Poussin) window."""
    return _scipy_style_window('parzen', n, (), sym, dtype)


def cosine(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Half-cosine window sin(pi(k+1/2)/n)."""
    return _scipy_style_window('cosine', n, (), sym, dtype)


def lanczos(n: int, sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Lanczos (sinc) window."""
    return _scipy_style_window('lanczos', n, (), sym, dtype)


def gaussian(n: int, std: float, sym: bool = True,
             dtype: Dtype = Dtype.F32) -> Tensor:
    """Gaussian window with standard deviation ``std`` samples."""
    return _scipy_style_window('gaussian', n, (float(std),), sym, dtype)


def general_gaussian(n: int, p: float, sig: float, sym: bool = True,
                     dtype: Dtype = Dtype.F32) -> Tensor:
    """Generalized Gaussian window exp(-0.5 |k/sig|^(2p))."""
    return _scipy_style_window('general_gaussian', n,
                               (float(p), float(sig)), sym, dtype)


def exponential(n: int, center=None, tau: float = 1.0, sym: bool = True,
                dtype: Dtype = Dtype.F32) -> Tensor:
    """Exponential (Poisson) window with decay constant ``tau``."""
    if sym and center is not None:
        raise RuntimeError('exponential: center must be None when sym=True')
    return _scipy_style_window('exponential', n, (center, float(tau)), sym,
                               dtype)


def chebwin(n: int, at: float = 100.0, sym: bool = True,
            dtype: Dtype = Dtype.F32) -> Tensor:
    """Dolph-Chebyshev window with ``at`` dB equiripple sidelobes."""
    return _scipy_style_window('chebwin', n, (float(at),), sym, dtype)


def taylor(n: int, nbar: int = 4, sll: float = 30.0, norm: bool = True,
           sym: bool = True, dtype: Dtype = Dtype.F32) -> Tensor:
    """Taylor window (radar taper: nbar near-constant sidelobes at
    -sll dB)."""
    return _scipy_style_window('taylor', n, (nbar, sll, norm), sym, dtype)


def kaiser_bessel_derived(n: int, beta: float,
                          dtype: Dtype = Dtype.F32) -> Tensor:
    """Kaiser-Bessel-derived (MDCT) window; even ``n``, symmetric only."""
    return _scipy_style_window('kaiser_bessel_derived', n, (float(beta),),
                               True, dtype)


def dpss(n: int, nw: float, kmax=None, dtype: Dtype = Dtype.F32) -> Tensor:
    """Discrete prolate spheroidal (Slepian) sequences
    (scipy.signal.windows.dpss): with ``kmax=None`` the single
    max-concentration taper (n,) under the ``norm='approximate'``
    scaling, else the first ``kmax`` unit-norm orders (kmax, n), the
    multitaper analysis basis."""
    single = kmax is None
    k = 1 if single else int(kmax)

    def design():
        return _np_dpss_single(n, float(nw)) if single else _np_dpss(n, float(nw), k)

    return _upload('dpss', {'n': n, 'NW': nw, 'Kmax': k}, design, dtype)
