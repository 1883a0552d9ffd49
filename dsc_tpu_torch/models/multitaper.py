"""Thomson multitaper PSD and the Lomb-Scargle periodogram
(dsc_tpu/models/multitaper.py).

- ``multitaper``: project the signal onto the first K discrete prolate
  spheroidal (Slepian) tapers (``windows._np_dpss``, designed on the host
  in float64) and average the K eigenspectra. The (b*K, n) tapered copies
  ride the batched FFT core as one rfft (K6 + K7 at the streaming sizes),
  and the adaptive (Thomson) weighting is a fixed number of iterations.
- ``lombscargle``: the classical tau-shifted least-squares periodogram of
  unevenly sampled data (scipy.signal.lombscargle semantics) in float64
  phase math on the device, over tiles of ``_FREQ_TILE`` frequencies so
  that the (nfreq, n) phase grid never exists whole.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..fourier import core as fft_core
from ..fourier import plan as fft_plan
from ..fourier import rfftfreq
from ..tensor import Tensor
from ..windows import _np_dpss
from .psd import _double_inner, _f32, _rows
from .stft import _device_array


def _dpss_and_ratios(n: int, nw: float, k: int):
    """(tapers (k, n) of unit energy, concentration ratios (k,)): the
    ratios by the autocorrelation inner product with the Dirichlet kernel,
    lambda_k = sum_m r_xx[m] * 4W sinc(2W m) (scipy's construction for
    return_ratios=True)."""
    tapers = _np_dpss(n, nw, k)
    w = nw / n
    m = np.arange(n, dtype=np.float64)
    r = 4.0 * w * np.sinc(2.0 * w * m)
    r[0] = 2.0 * w
    # autocorrelation of each taper, lags 0..n-1
    pad = 1 << int(np.ceil(np.log2(2 * n - 1)))
    spec = np.abs(np.fft.rfft(tapers, pad, axis=-1)) ** 2
    rxx = np.fft.irfft(spec, pad, axis=-1)[:, :n]
    ratios = rxx @ r
    return tapers, np.clip(ratios, 0.0, 1.0)


def _multitaper_program(x, tapers, ratios, fs, n, spec, tables, weighting, n_iter):
    """(b, n) real -> (b, n//2+1) one-sided PSD
    (dsc_tpu/models/multitaper.py:59-94)."""
    b, k = x.shape[0], tapers.shape[0]
    xt = (x[:, None, :] * tapers[None, :, :]).reshape(b * k, n)
    z = fft_core.rfft_batched(xt, spec, tables, n)
    sk = (z.real * z.real + z.imag * z.imag).reshape(b, k, -1)
    if weighting == 'unity':
        pxx = sk.mean(1)
    elif weighting == 'eigen':
        pxx = torch.einsum('k,bkf->bf', ratios / ratios.sum(), sk)
    else:  # adaptive (Thomson): d_k = S / (lam_k S + (1-lam_k) sig2)
        sig2 = (x * x).mean(-1, keepdim=True)[:, :, None]  # (b, 1, 1)
        lam = ratios[None, :, None]  # (1, k, 1)
        s = sk[:, :2, :].mean(1, keepdim=True)  # seed: the first two
        for _ in range(n_iter):
            d = s / (lam * s + (1.0 - lam) * sig2 + 1e-30)
            w2 = d * d * lam
            s = (w2 * sk).sum(1, keepdim=True) / w2.sum(1, keepdim=True)
        pxx = s[:, 0, :]
    # the tapers have unit energy, so the density scale is 1/fs
    return _double_inner(pxx / fs)


def multitaper(x: Tensor, fs: float = 1.0, nw: float = 4.0, k: Optional[int] = None,
               weighting: str = 'adaptive', n_iter: int = 5) -> tuple:
    """Thomson multitaper PSD estimate over the whole signal. x: (n,) or
    (batch, n) real with n a power of two; ``nw`` the time-bandwidth
    product; ``k`` tapers (default ``2*nw - 1`` rounded down); ``weighting``
    'unity', 'eigen' or 'adaptive' (Thomson's data-dependent weights,
    ``n_iter`` iterations). Returns ``(f, Pxx)``, one-sided in V**2/Hz."""
    if x.n_dim > 2:
        raise RuntimeError(f'multitaper: expected a 1-D or 2-D signal, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError('multitaper expects a real signal')
    n = x.shape[-1]
    if n < 8 or n & (n - 1):
        raise RuntimeError(
            f'multitaper: signal length ({n}) is not a power of two >= 8 (the dsc FFT '
            'family is power-of-two)')
    if weighting not in ('unity', 'eigen', 'adaptive'):
        raise RuntimeError(f'multitaper: unknown weighting {weighting!r}')
    if k is None:
        k = max(int(2 * nw) - 1, 1)
    if not 1 <= k <= n:
        raise RuntimeError(f'multitaper: k ({k}) must be in [1, {n}]')
    tapers, ratios = _dpss_and_ratios(n, float(nw), k)
    data = _rows(x)
    spec, tables = fft_plan.get_plan(n, 'real', torch.complex64)
    with tracing.trace_op('multitaper', 'op;pipeline', tracing.tensor_args(x=x)):
        pxx = _multitaper_program(
            data, _device_array(tapers.astype(np.float32), data),
            _device_array(ratios.astype(np.float32), data), _f32(fs), n, spec, tables,
            weighting, int(n_iter))
        res = Tensor._from_torch(pxx if x.n_dim == 2 else pxx[0])
    return rfftfreq(n, d=1.0 / fs), res


_FREQ_TILE = 512  # frequencies a tile: bounds the (tile, n) phase grid


def _lombscargle_program(t, y, freqs, normalize, precenter):
    """The tau-shifted Lomb-Scargle periodogram in float64, one (tile, n)
    block of trig and reductions at a time
    (dsc_tpu/models/multitaper.py:157-189)."""
    if precenter:
        y = y - y.mean()
    blocks = []
    for s in range(0, freqs.shape[0], _FREQ_TILE):
        wt = freqs[s:s + _FREQ_TILE, None] * t[None, :]  # (tile, n)
        # w*tau as one phase angle (arctan2/2), subtracted directly:
        # dividing by w and multiplying again loses the angle at large w*t
        wtau = torch.atan2(torch.sin(2.0 * wt).sum(1), torch.cos(2.0 * wt).sum(1)) / 2.0
        ph = wt - wtau[:, None]
        cph, sph = torch.cos(ph), torch.sin(ph)
        yc, ys = (y * cph).sum(1), (y * sph).sum(1)
        cc, ss = (cph * cph).sum(1), (sph * sph).sum(1)
        blocks.append(0.5 * (yc * yc / cc + ys * ys / (ss + 1e-300)))
    pgram = torch.cat(blocks)
    if normalize:
        pgram = pgram * 2.0 / (y * y).sum()
    return pgram


def lombscargle(x: Tensor, y: Tensor, freqs: Tensor, precenter: bool = False,
                normalize: bool = False) -> Tensor:
    """Lomb-Scargle periodogram of unevenly sampled data
    (scipy.signal.lombscargle semantics): sample times ``x`` (n,), values
    ``y`` (n,), angular frequencies ``freqs`` (nfreq,), all real 1-D. The
    phase math runs in float64 on the device; the result is float32."""
    for name, t in (('x', x), ('y', y), ('freqs', freqs)):
        if t.n_dim != 1:
            raise RuntimeError(f'lombscargle: {name} must be 1-D')
        if t.dtype.is_complex:
            raise RuntimeError(f'lombscargle: {name} must be real')
    if x.shape != y.shape:
        raise RuntimeError(f'lombscargle: x {x.shape} and y {y.shape} must match')
    with tracing.trace_op('lombscargle', 'op;pipeline',
                          tracing.tensor_args(x=x, y=y, freqs=freqs)):
        p = _lombscargle_program(x.torch.to(torch.float64), y.torch.to(torch.float64),
                                 freqs.torch.to(torch.float64), bool(normalize),
                                 bool(precenter))
        res = Tensor._from_torch(p.to(torch.float32))
    return res
