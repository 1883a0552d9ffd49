"""Chirp-z transform (Bluestein): exact DFTs of any length, and zoomed
spectra, on the power-of-two FFT engine (dsc_tpu/models/czt.py;
scipy.signal CZT/czt/ZoomFFT/zoom_fft semantics).

X_k = sum_n x_n a^-n w^(nk) through Bluestein's identity
nk = (n^2 + k^2 - (k-n)^2)/2: a chirp pre-multiply, one linear convolution
at the next power of two (the chirp kernel's spectrum is computed once, at
plan time) and a chirp post-multiply. On one vector in the streaming range
the whole body is fft -> same-layout multiply -> ifft on the T layout
(K6+K8, then K9+K10; fourier/stream_t.py).

The chirp tables are built on the host in float64; for the default DFT
points (w on the unit circle) the quadratic phase is reduced exactly,
``n^2 mod 2m``, before the float multiply, so the angle keeps its precision
at any length. The JAX package compiles the body (dsc.compile, the fusion
tier, not ported yet); here it is a plain function with the same values.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..dtype import Dtype
from ..fourier import fft, ifft
from ..fourier.plan import next_pow2
from ..tensor import Tensor, from_numpy, mul


def czt_points(m: int, w=None, a=1.0 + 0.0j) -> np.ndarray:
    """The m points z_k = a * w^-k the chirp-z transform evaluates at
    (scipy.signal.czt_points; dsc_tpu/models/response.py:146)."""
    if m < 1:
        raise RuntimeError(f'czt_points: m ({m}) must be >= 1')
    k = np.arange(m)
    a = complex(a)
    if w is None:
        # default: m points on the full unit circle
        return a * np.exp(2j * np.pi * k / m)
    return a * complex(w) ** (-k.astype(np.float64))


def _unit_chirp(num: np.ndarray, denom: int, sign: float) -> np.ndarray:
    """exp(sign * 1j * pi * num / denom) with the integer quadratic ``num``
    reduced mod 2*denom before the float multiply."""
    red = np.mod(num, 2 * denom).astype(np.float64)
    return np.exp(sign * 1j * np.pi * red / denom)


class CZT:
    """Pre-planned chirp-z transform (scipy.signal.CZT semantics):
    ``CZT(n, m, w, a)(x)`` evaluates ``X_k = sum_n x_n a^-n w^(nk)`` for
    k = 0..m-1 over the last axis of x (length n, real or complex, 1-D or
    batched 2-D). Defaults: ``m = n``, ``w = exp(-2j*pi/m)``, the exact
    length-n DFT when m == n and a == 1."""

    def __init__(self, n: int, m: Optional[int] = None, w=None,
                 a: complex = 1 + 0j, *, _angle_scale: Optional[float] = None):
        if n < 1:
            raise RuntimeError(f'CZT: n ({n}) must be >= 1')
        m = n if m is None else m
        if m < 1:
            raise RuntimeError(f'CZT: m ({m}) must be >= 1')
        self.n, self.m = n, m
        k_pre = np.arange(n, dtype=np.int64)
        k_conv = np.arange(-(n - 1), m, dtype=np.int64)  # length n+m-1
        k_post = np.arange(m, dtype=np.int64)
        if w is None and _angle_scale is None:
            # exact unit-circle chirp: w^(k^2/2) = exp(-1j*pi*k^2/m)
            wk2_pre = _unit_chirp(k_pre**2, m, -1.0)
            v = _unit_chirp(k_conv**2, m, +1.0)
            wk2_post = _unit_chirp(k_post**2, m, -1.0)
        elif _angle_scale is not None:
            # ZoomFFT: w = exp(-2j*pi*scale/m) given as the float64 ratio
            # ``scale``, so the chirp phase is pi*scale*k^2/m directly (the
            # powers of a rounded complex w would compound its rounding)
            scale = float(_angle_scale)
            w = np.exp(-2j * np.pi * scale / m)

            def _zoom_chirp(idx, sign):
                return np.exp(sign * 1j * np.pi * scale * idx.astype(np.float64) ** 2 / m)

            wk2_pre = _zoom_chirp(k_pre, -1.0)
            v = _zoom_chirp(k_conv, +1.0)
            wk2_post = _zoom_chirp(k_post, -1.0)
        else:
            w = complex(w)
            wk2_pre = w ** (k_pre.astype(np.float64) ** 2 / 2.0)
            v = w ** (-(k_conv.astype(np.float64) ** 2) / 2.0)
            wk2_post = w ** (k_post.astype(np.float64) ** 2 / 2.0)
        a = complex(a)
        pre = (a ** -k_pre.astype(np.float64)) * wk2_pre
        self._fft_n = next_pow2(n + m - 1)
        self._pre = from_numpy(pre.astype(np.complex64))
        self._post = from_numpy(wk2_post.astype(np.complex64))
        # the chirp kernel's spectrum, one FFT at plan time
        self._vspec = fft(from_numpy(v.astype(np.complex64)), n=self._fft_n)
        self._w, self._a = w, a

    def _run(self, x: Tensor) -> Tensor:
        n, m = self.n, self.m
        u = fft(mul(x, self._pre), n=self._fft_n)
        conv = ifft(mul(u, self._vspec))
        picked = conv[:, n - 1:n - 1 + m] if x.n_dim == 2 else conv[n - 1:n - 1 + m]
        return mul(picked, self._post)

    def __call__(self, x: Tensor) -> Tensor:
        if x.n_dim not in (1, 2):
            raise RuntimeError(f'CZT: expected a 1-D or 2-D signal, got {x.n_dim}-D')
        if x.shape[-1] != self.n:
            raise RuntimeError(f'CZT: planned for length {self.n}, got {x.shape[-1]}')
        if not x.dtype.is_complex:
            x = x.cast(Dtype.C32)
        return self._run(x)

    def points(self) -> np.ndarray:
        """The m z-plane points this transform evaluates at
        (scipy.signal.CZT.points = czt_points(m, w, a))."""
        return czt_points(self.m, self._w, self._a)


def czt(x: Tensor, m: Optional[int] = None, w=None, a: complex = 1 + 0j) -> Tensor:
    """One-shot chirp-z transform (scipy.signal.czt semantics). With the
    defaults this is the exact DFT of any length, with no power-of-two
    padding."""
    return CZT(x.shape[-1], m=m, w=w, a=a)(x)


class ZoomFFT(CZT):
    """Pre-planned zoomed DFT (scipy.signal.ZoomFFT semantics): the spectrum
    of length-n signals on [f1, f2] at m points, a chirp-z transform with
    ``w = exp(-2j*pi*(f2-f1)/(fs*m'))`` and ``a = exp(2j*pi*f1/fs)``."""

    def __init__(self, n: int, fn, m: Optional[int] = None, *,
                 fs: float = 2.0, endpoint: bool = False):
        fn_arr = np.atleast_1d(np.asarray(fn, np.float64))
        if fn_arr.size == 1:
            f1, f2 = 0.0, float(fn_arr[0])
        elif fn_arr.size == 2:
            f1, f2 = float(fn_arr[0]), float(fn_arr[1])
        else:
            raise RuntimeError('ZoomFFT: fn must be a scalar or [f1, f2]')
        m = n if m is None else m
        if m < 1:
            raise RuntimeError(f'ZoomFFT: m ({m}) must be >= 1')
        if endpoint and m < 2:
            # the m-1 divisor below exists only with endpoint=True
            raise RuntimeError(f'ZoomFFT: m ({m}) must be >= 2 when endpoint=True')
        scale = ((f2 - f1) * m) / (fs * (m - 1)) if endpoint else (f2 - f1) / fs
        a = np.exp(2j * np.pi * f1 / fs)
        super().__init__(n, m=m, a=a, _angle_scale=scale)
        self.f1, self.f2, self.fs = f1, f2, fs


def zoom_fft(x: Tensor, fn, m: Optional[int] = None, fs: float = 2.0,
             endpoint: bool = False) -> Tensor:
    """Zoomed DFT on [f1, f2] (scipy.signal.zoom_fft semantics: ``fn`` a
    scalar meaning [0, fn] or a pair [f1, f2], in units of ``fs``;
    ``endpoint`` includes f2 as the last sample)."""
    return ZoomFFT(x.shape[-1], fn, m=m, fs=fs, endpoint=endpoint)(x)
