"""Power spectral density estimators (dsc_tpu/models/psd.py; scipy.signal
semantics): ``welch``, ``periodogram``, ``csd``, ``coherence``,
``psd_spectrogram`` and ``detrend``.

Each estimator is one chain of torch ops: frame (fourier/base_fft.py ``frame_dense``,
a strided view) -> detrend -> window -> batched rfft -> |.|^2 -> average ->
scale. All segments ride the batched FFT core as one call, so a
1024-sample segment is one launch of the base-case kernel K12 on the
512-point half-size rows (fourier/core.py ``rfft_batched``); a segment in
the streaming range takes K6 + K7.

Power-of-two segment lengths only, as in the JAX package: the dsc FFT
rounds sizes up to the next power of two, and padding a PSD segment would
change the estimate. A signal shorter than ``nperseg`` raises where scipy
shrinks the segment.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..fourier import core as fft_core
from ..fourier import plan as fft_plan
from ..fourier import rfftfreq
from ..fourier.base_fft import frame_dense
from ..tensor import Tensor, from_numpy
from ..windows import design_window
from .stft import _device_array, _make_window


def _spectral_window(window, nperseg: int) -> np.ndarray:
    """Window spec -> float32 host array under scipy.signal's PSD
    convention: named windows are periodic (``get_window(...,
    fftbins=True)``), not the symmetric np.* forms of the STFT models.
    Accepts every scipy.signal.get_window name, (name, *params) tuple and
    bare kaiser beta through ``windows.design_window``; Tensors and
    array-likes pass through as given."""
    if isinstance(window, str) or (
            isinstance(window, tuple) and window and isinstance(window[0], str)) or (
            isinstance(window, (int, float)) and not isinstance(window, bool)):
        return design_window(window, nperseg, fftbins=True).astype(np.float32)
    return _make_window(window, nperseg)


def _median_bias(n: int) -> float:
    """Bias of the median of n chi^2_2 variates relative to their mean
    (scipy.signal._spectral_py._median_bias)."""
    ii_2 = 2.0 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1.0 + np.sum(1.0 / (ii_2 + 1.0) - 1.0 / ii_2))


def _detrend_segs(segs: torch.Tensor, nperseg: int, detrend: str) -> torch.Tensor:
    """Per-segment detrend over the last axis: 'constant' subtracts the
    mean, 'linear' a closed-form least-squares line over k = 0..nperseg-1
    (real or complex segments)."""
    if detrend == 'constant':
        return segs - segs.mean(-1, keepdim=True)
    if detrend == 'linear':
        k = torch.arange(nperseg, dtype=segs.real.dtype, device=segs.device)
        kc = k - (nperseg - 1) / 2.0
        denom = (kc * kc).sum()
        slope = (segs * kc).sum(-1, keepdim=True) / denom
        mean = segs.mean(-1, keepdim=True)
        return segs - (mean + slope * kc)
    return segs


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The median along ``dim`` as jnp.median takes it: the mean of the two
    middle values of an even count (torch.median returns the lower one)."""
    s = x.sort(dim).values
    m = s.shape[dim]
    lo, hi = s.narrow(dim, (m - 1) // 2, 1), s.narrow(dim, m // 2, 1)
    return (0.5 * (lo + hi)).squeeze(dim)


def _f32(v: float) -> float:
    """A host scalar rounded to float32, as the JAX package passes it."""
    return float(np.float32(v))


def _spectra(x: torch.Tensor, window: torch.Tensor, nperseg: int, hop: int, n_frames: int,
             detrend: str) -> torch.Tensor:
    """(b, n) float32 -> (b, n_frames, nperseg//2+1) complex64: every
    windowed segment of every row through one batched rfft."""
    spec, tables = fft_plan.get_plan(nperseg, 'real', torch.complex64)
    segs = _detrend_segs(frame_dense(x, nperseg, hop, n_frames), nperseg, detrend)
    fx = (segs * window).reshape(-1, nperseg)
    z = fft_core.rfft_batched(fx, spec, tables, nperseg)
    return z.reshape(x.shape[0], n_frames, -1)


def _double_inner(p: torch.Tensor) -> torch.Tensor:
    """One-sided doubling: every bin but DC and Nyquist carries its mirror."""
    p[..., 1:-1] *= 2.0
    return p


def _psd_args(x, who, nperseg, noverlap, scaling, detrend):
    if x.n_dim > 2:
        raise RuntimeError(f'{who}: expected a 1-D or 2-D signal, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError(f'{who} expects a real signal')
    if nperseg < 2 or nperseg & (nperseg - 1):
        raise RuntimeError(
            f'{who}: nperseg ({nperseg}) is not a power of two (the dsc '
            'FFT family is power-of-two)')
    n = x.shape[-1]
    if n < nperseg:
        raise RuntimeError(f'{who}: signal ({n}) shorter than nperseg ({nperseg})')
    if noverlap is None:
        noverlap = nperseg // 2
    if not 0 <= noverlap < nperseg:
        raise RuntimeError(f'{who}: noverlap ({noverlap}) must be in [0, nperseg)')
    if scaling not in ('density', 'spectrum'):
        raise RuntimeError(f'{who}: unknown scaling {scaling!r}')
    if detrend in (False, None):
        detrend = 'none'
    if detrend not in ('constant', 'linear', 'none'):
        raise RuntimeError(f'{who}: unknown detrend {detrend!r}')
    hop = nperseg - noverlap
    return n, hop, 1 + (n - nperseg) // hop, detrend


def _psd_scale(win: np.ndarray, fs: float, scaling: str) -> float:
    w64 = win.astype(np.float64)
    if scaling == 'density':
        return 1.0 / (fs * float(np.sum(w64 * w64)))
    return 1.0 / float(np.sum(w64)) ** 2


def _rows(x: Tensor) -> torch.Tensor:
    """A (n,) or (b, n) signal as (b, n) float32 rows."""
    data = x.torch.to(torch.float32)
    return data if x.n_dim == 2 else data[None, :]


def welch(x: Tensor, fs: float = 1.0, window='hann', nperseg: int = 256,
          noverlap: Optional[int] = None, detrend='constant', scaling: str = 'density',
          average: str = 'mean') -> tuple:
    """Welch average-periodogram PSD estimate (scipy.signal.welch
    semantics, one-sided). x: (n,) or (batch, n) real; ``nperseg`` a power
    of two. Returns ``(f, Pxx)`` Tensors: f the (nperseg//2+1,) sample
    frequencies, Pxx (nperseg//2+1,) (or batched) in V**2/Hz
    (``scaling='density'``) or V**2 (``'spectrum'``)."""
    if average not in ('mean', 'median'):
        raise RuntimeError(f'welch: unknown average {average!r}')
    n, hop, n_frames, detrend = _psd_args(x, 'welch', nperseg, noverlap, scaling, detrend)
    win = _spectral_window(window, nperseg)
    scale = _psd_scale(win, fs, scaling)
    data = _rows(x)
    with tracing.trace_op('welch', 'op;pipeline', tracing.tensor_args(x=x)):
        z = _spectra(data, _device_array(win, data), nperseg, hop, n_frames, detrend)
        power = z.real * z.real + z.imag * z.imag
        if average == 'median':
            pxx = _median(power, 1) / _f32(_median_bias(n_frames))
        else:
            pxx = power.mean(1)
        pxx = _double_inner(pxx * _f32(scale))
        res = Tensor._from_torch(pxx if x.n_dim == 2 else pxx[0])
    return rfftfreq(nperseg, d=1.0 / fs), res


def detrend(x: Tensor, type: str = 'linear') -> Tensor:  # noqa: A002
    """Remove the mean (``type='constant'``) or a least-squares line
    (``type='linear'``) from a signal (scipy.signal.detrend semantics over
    the last axis). x: (n,) or (batch, n) real."""
    if type not in ('constant', 'linear'):
        raise RuntimeError(f'detrend: unknown type {type!r}')
    if x.n_dim > 2:
        raise RuntimeError(f'detrend: expected a 1-D or 2-D signal, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError('detrend expects a real signal')
    data = x.torch if x.n_dim == 2 else x.torch[None, :]
    with tracing.trace_op('detrend', 'op;pipeline', tracing.tensor_args(x=x)):
        out = _detrend_segs(data, x.shape[-1], type)
        res = Tensor._from_torch(out if x.n_dim == 2 else out[0])
    return res


def _csd_common(x, y, who, fs, window, nperseg, noverlap, detrend, scaling, mode):
    """(re + i im) of the cross-spectral density (``mode='csd'``) or the
    magnitude-squared coherence (``'coherence'``) of same-shape real
    signals: both signals' segments ride one 2*b*n_frames-row batched rfft."""
    if x.shape != y.shape:
        raise RuntimeError(
            f'{who}: x and y must have the same shape, got {x.shape} vs {y.shape}')
    if y.dtype.is_complex:
        raise RuntimeError(f'{who} expects real signals')
    _, hop, n_frames, detrend = _psd_args(x, who, nperseg, noverlap, scaling, detrend)
    win = _spectral_window(window, nperseg)
    scale = _psd_scale(win, fs, scaling)
    xs, ys = _rows(x), _rows(y)
    b = xs.shape[0]
    with tracing.trace_op(who, 'op;pipeline', tracing.tensor_args(x=x, y=y)):
        z = _spectra(torch.cat([xs, ys]), _device_array(win, xs), nperseg, hop, n_frames,
                     detrend)
        zx, zy = z[:b], z[b:]
        cross = (zx.conj() * zy).mean(1)
        if mode == 'coherence':
            # the scale and the one-sided doubling cancel in the ratio
            pxx = (zx.real * zx.real + zx.imag * zx.imag).mean(1)
            pyy = (zy.real * zy.real + zy.imag * zy.imag).mean(1)
            out = (cross.real * cross.real + cross.imag * cross.imag) / (pxx * pyy)
        else:
            out = _double_inner(cross * _f32(scale))
        res = Tensor._from_torch(out if x.n_dim == 2 else out[0])
    return rfftfreq(nperseg, d=1.0 / fs), res


def csd(x: Tensor, y: Tensor, fs: float = 1.0, window='hann', nperseg: int = 256,
        noverlap: Optional[int] = None, detrend='constant', scaling: str = 'density') -> tuple:
    """Cross-spectral density Pxy = mean(conj(X)*Y) over Welch segments
    (scipy.signal.csd semantics, one-sided). x, y: same-shape (n,) or
    (batch, n) real signals; returns ``(f, Pxy)`` with Pxy a complex64
    Tensor (welch(x) == csd(x, x).real)."""
    return _csd_common(x, y, 'csd', fs, window, nperseg, noverlap, detrend, scaling, 'csd')


def coherence(x: Tensor, y: Tensor, fs: float = 1.0, window='hann', nperseg: int = 256,
              noverlap: Optional[int] = None, detrend='constant') -> tuple:
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx*Pyy)
    (scipy.signal.coherence semantics) in one chain: the scale and the
    one-sided doubling cancel in the ratio. Returns (f, Cxy) real Tensors."""
    return _csd_common(x, y, 'coherence', fs, window, nperseg, noverlap, detrend, 'density',
                       'coherence')


def psd_spectrogram(x: Tensor, fs: float = 1.0, window=('tukey', 0.25), nperseg: int = 256,
                    noverlap: Optional[int] = None, detrend='constant',
                    scaling: str = 'density', mode: str = 'psd') -> tuple:
    """scipy.signal.spectrogram semantics: per-segment one-sided spectra
    with psd/magnitude/complex scaling, tukey(0.25) default window and
    ``noverlap = nperseg // 8``. Returns ``(f, t, Sxx)`` with Sxx shaped
    (bins, n_frames), scipy's frequency-by-time orientation, plus a leading
    batch dim for (batch, n) input (the dsc-native
    :func:`~dsc_tpu_torch.models.spectrogram` is the log-power STFT)."""
    if mode not in ('psd', 'magnitude', 'complex'):
        raise RuntimeError(f'psd_spectrogram: unknown mode {mode!r}')
    if noverlap is None:
        noverlap = nperseg // 8
    n, hop, n_frames, detrend = _psd_args(x, 'psd_spectrogram', nperseg, noverlap, scaling,
                                          detrend)
    win = _spectral_window(window, nperseg)
    scale = _psd_scale(win, fs, scaling)
    data = _rows(x)
    with tracing.trace_op('psd_spectrogram', 'op;pipeline', tracing.tensor_args(x=x)):
        z = _spectra(data, _device_array(win, data), nperseg, hop, n_frames, detrend)
        if mode == 'complex':
            out = z * _f32(np.sqrt(_f32(scale)))
        elif mode == 'magnitude':
            out = torch.sqrt(z.real * z.real + z.imag * z.imag) * _f32(np.sqrt(_f32(scale)))
        else:
            out = _double_inner((z.real * z.real + z.imag * z.imag) * _f32(scale))
        out = out.transpose(1, 2)  # (b, bins, frames)
        res = Tensor._from_torch(out if x.n_dim == 2 else out[0])
    t = from_numpy(((np.arange(n_frames) * hop + nperseg / 2.0) / fs).astype(np.float32))
    return rfftfreq(nperseg, d=1.0 / fs), t, res


def periodogram(x: Tensor, fs: float = 1.0, window=None, detrend='constant',
                scaling: str = 'density') -> tuple:
    """Single-segment PSD estimate (scipy.signal.periodogram semantics,
    one-sided; scipy's default boxcar window is ``window=None``).
    x: (n,) or (batch, n) real with n a power of two. Returns (f, Pxx)."""
    return welch(x, fs=fs, window=window, nperseg=x.shape[-1], noverlap=0, detrend=detrend,
                 scaling=scaling)
