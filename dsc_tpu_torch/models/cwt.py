"""Continuous wavelet transform and CWT-based peak finding
(dsc_tpu/models/cwt.py): ``ricker``, ``morlet2``, ``cwt``, ``find_peaks_cwt``,
with scipy.signal semantics (the Du et al. 2006 ridge-line algorithm behind
find_peaks_cwt; ricker/morlet2/cwt as scipy shipped them).

The CWT is one chain on the batched FFT core: one rfft of the signal, one
of the stack of every width's wavelet, their product and one irfft of the
stack, then a per-width 'same' crop as one gather. At the transform sizes
where the core streams (``fourier/config.py`` ``core_streams``) the stack's
rows take K6 + K7 and the irfft reconstructs their spectra plainly; a
single signal row below the streaming batch rule rides the plain four-step
with K12 at its base cases. Ridge-line linking is sequential index logic
and runs on the host over one download, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..fourier import plan as fft_plan
from ..tensor import Tensor
from .stft import _device_array, _fft_convolve_rows


def ricker(points: int, a: float) -> np.ndarray:
    """Ricker ("Mexican hat") wavelet, unit-norm convention
    (2/(sqrt(3a) pi^(1/4)))(1 - x^2/a^2) exp(-x^2/(2a^2))."""
    amp = 2.0 / (np.sqrt(3.0 * a) * np.pi ** 0.25)
    x = np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0
    xsq = x * x
    return amp * (1.0 - xsq / (a * a)) * np.exp(-xsq / (2.0 * a * a))


def morlet2(points: int, s: float, w: float = 5.0) -> np.ndarray:
    """Complex Morlet wavelet exp(i w x) exp(-x^2/2) pi^(-1/4)/sqrt(s) with
    x = (t - (M-1)/2)/s (the scipy.signal.morlet2 convention)."""
    x = (np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0) / s
    return np.exp(1j * w * x) * np.exp(-0.5 * x * x) * np.pi ** -0.25 / np.sqrt(s)


def _cwt_program(x: torch.Tensor, kernels: torch.Tensor, offsets: torch.Tensor, n: int,
                 fft_n: int) -> torch.Tensor:
    """(n,) signal x (W, L) kernel stack -> (W, n) CWT rows
    (dsc_tpu/models/cwt.py:50-63): one batched full convolution in the
    frequency domain, per-width 'same' crops."""
    full = _fft_convolve_rows(x[None, :], kernels, fft_n)
    idx = offsets[:, None] + torch.arange(n, device=full.device)
    return torch.gather(full, 1, idx)


def cwt(data: Tensor, wavelet, widths, dtype=None) -> Tensor:
    """Continuous wavelet transform (scipy's cwt semantics): row w is the
    'same' convolution of ``data`` with the time-reversed conjugate of
    ``wavelet(min(10*w, n), w)``. ``wavelet`` is a callable like
    :func:`ricker` (real wavelets only). Returns a (len(widths), n)
    Tensor."""
    if isinstance(data, Tensor):
        if data.n_dim != 1:
            raise RuntimeError(f'cwt: expected a 1-D signal, got {data.n_dim}-D')
        if data.dtype.is_complex:
            raise RuntimeError('cwt: complex signals not supported')
        x = data.torch.to(torch.float32)
        n = data.shape[0]
    else:
        host = np.asarray(data, np.float32)
        if host.ndim != 1:
            raise RuntimeError('cwt: expected a 1-D signal')
        x = _device_array(host)
        n = host.size
    widths = np.atleast_1d(np.asarray(widths, np.float64))
    kernels, offsets = [], []
    maxlen = 0
    complex_wavelet = False
    for wdt in widths:
        m = int(min(10 * wdt, n))
        wav = np.conj(np.asarray(wavelet(m, wdt))[::-1])
        complex_wavelet |= np.iscomplexobj(wav)
        kernels.append(wav)
        offsets.append((m - 1) // 2)
        maxlen = max(maxlen, m)
    if complex_wavelet or dtype is not None and np.dtype(dtype).kind == 'c':
        raise RuntimeError('cwt: complex wavelets not supported (use a real wavelet like '
                           'ricker)')
    stack = np.zeros((len(widths), maxlen), np.float32)
    for i, kv in enumerate(kernels):
        stack[i, :kv.size] = kv.real
    fft_n = fft_plan.next_pow2(n + maxlen - 1)
    with tracing.trace_op('cwt', 'op;pipeline', {'n': n, 'widths': len(widths)}):
        out = _cwt_program(x, _device_array(stack, x), torch.tensor(offsets, device=x.device),
                           n, fft_n)
        res = Tensor._from_torch(out)
    return res


def _bool_relmax_rows(m: np.ndarray) -> np.ndarray:
    """Strict order-1 relative maxima along each row, 'clip' boundary
    (scipy _boolrelextrema semantics)."""
    left = np.empty_like(m)
    left[:, 1:] = m[:, :-1]
    left[:, 0] = m[:, 0]
    right = np.empty_like(m)
    right[:, :-1] = m[:, 1:]
    right[:, -1] = m[:, -1]
    return (m > left) & (m > right)


def _ridge_lines(matr: np.ndarray, max_distances, gap_thresh):
    """Du et al. ridge-line linking (scipy _identify_ridge_lines)."""
    relmax = _bool_relmax_rows(matr)
    has = np.nonzero(relmax.any(axis=1))[0]
    if has.size == 0:
        return []
    start = has[-1]
    lines = [[[start], [c], 0] for c in np.nonzero(relmax[start])[0]]
    done = []
    for row in range(start - 1, -1, -1):
        cols_here = np.nonzero(relmax[row])[0]
        for ln in lines:
            ln[2] += 1
        prev = np.asarray([ln[1][-1] for ln in lines])
        for col in cols_here:
            ln = None
            if prev.size:
                d = np.abs(col - prev)
                j = int(np.argmin(d))
                if d[j] <= max_distances[row]:
                    ln = lines[j]
            if ln is not None:
                ln[1].append(col)
                ln[0].append(row)
                ln[2] = 0
            else:
                lines.append([[row], [col], 0])
        for j in range(len(lines) - 1, -1, -1):
            if lines[j][2] > gap_thresh:
                done.append(lines[j])
                del lines[j]
    out = []
    for rows, cols, _gap in done + lines:
        order = np.argsort(rows)
        r = np.zeros(len(rows), np.intp)
        c = np.zeros(len(rows), np.intp)
        r[order] = rows
        c[order] = cols
        out.append((r, c))
    return out


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None, gap_thresh=None,
                   min_length=None, min_snr: float = 1.0, noise_perc: float = 10.0,
                   window_size: Optional[int] = None) -> np.ndarray:
    """CWT-based peak finding (scipy.signal.find_peaks_cwt semantics): the
    ricker CWT over ``widths`` on the device, then on the host: relative
    maxima linked into ridge lines across scales, and the lines long enough
    with enough SNR at the smallest scale kept. Returns sorted peak
    indices."""
    widths = np.atleast_1d(np.asarray(widths, np.float64))
    if widths.size == 0 or np.any(widths <= 0):
        raise RuntimeError('find_peaks_cwt: widths must be positive')
    if gap_thresh is None:
        gap_thresh = np.ceil(widths[0])
    if max_distances is None:
        max_distances = widths / 4.0
    if wavelet is None:
        wavelet = ricker
    cwt_dat = np.asarray(cwt(vector, wavelet, widths).numpy(), np.float64)
    # The FFT-based CWT turns regions a direct convolution leaves exactly
    # zero (flat stretches) into ~1e-7-relative wiggles, each a spurious
    # strict relative maximum: clamp them so that ties behave like scipy's
    # direct convolution.
    clamp = 3e-7 * np.abs(cwt_dat).max()
    cwt_dat[np.abs(cwt_dat) < clamp] = 0.0
    lines = _ridge_lines(cwt_dat, np.asarray(max_distances), gap_thresh)
    n = cwt_dat.shape[1]
    if min_length is None:
        min_length = np.ceil(cwt_dat.shape[0] / 4.0)
    if window_size is None:
        window_size = np.ceil(n / 20.0)
    window_size = int(window_size)
    half, odd = divmod(window_size, 2)
    row0 = cwt_dat[0]
    noises = np.empty_like(row0)
    for i in range(n):
        lo, hi = max(i - half, 0), min(i + half + odd, n)
        noises[i] = np.percentile(row0[lo:hi], noise_perc)
    keep = []
    for rows, cols in lines:
        if rows.size < min_length:
            continue
        snr = abs(cwt_dat[rows[0], cols[0]] / noises[cols[0]])
        if snr >= min_snr:
            keep.append(cols[0])
    return np.sort(np.asarray(keep, np.intp))
