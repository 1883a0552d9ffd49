"""scipy.signal-compatible ``stft`` / ``istft`` and the COLA/NOLA checks
(dsc_tpu/models/stft_scipy.py).

The dsc-native STFT/ISTFT classes (stft.py) keep spectrograms in (frames,
bins) orientation; this is the scipy parity layer on the same engine:
boundary extension, tail padding, spectrum/psd scaling, (bins, frames)
orientation and the (f, t, Zxx) / (t, x) returns of scipy.signal.stft /
istft. After the host's size arithmetic, each direction is one chain of
torch ops (pad -> frame -> detrend -> window -> batched rfft; batched
irfft -> window -> overlap-add, stft.py ``_istft_program``), whose
transforms run K12 on the half-size rows of a 1024-sample segment.

As in the JAX package, ``nfft`` (default ``nperseg``) must be a power of
two.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..fourier import core as fft_core
from ..fourier import fftfreq, rfftfreq
from ..fourier import plan as fft_plan
from ..fourier.base_fft import frame_dense
from ..tensor import Tensor, from_numpy
from ..windows import design_window
from .psd import _detrend_segs, _f32, _rows, _spectral_window
from .stft import _device_array, _istft_program


def _f64_window(window, nperseg: int) -> np.ndarray:
    """Full-precision periodic window for the COLA/NOLA checks (the float32
    device window would fail the 1e-10 tolerance by rounding alone)."""
    if isinstance(window, (str, float, int)) or (
            isinstance(window, tuple) and window and isinstance(window[0], str)):
        return design_window(window, nperseg, fftbins=True)
    return np.asarray(window, np.float64)


# boundary name -> np.pad mode of the extension (scipy.signal.stft)
_BOUNDARIES = {'zeros': 'constant', 'even': 'reflect', 'odd': 'odd', 'constant': 'edge'}


def _pad_ext(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Extend the last axis of (b, n) by ``left`` and ``right`` samples as
    np.pad does with ``mode``: 'constant' (zeros), 'edge', 'reflect' and
    'odd' (reflect_type='odd'); a reflection is at most n - 1 long."""
    if mode == 'constant':
        return torch.nn.functional.pad(x, (left, right))
    first, last = x[:, :1], x[:, -1:]
    if mode == 'edge':
        head, tail = first.expand(-1, left), last.expand(-1, right)
    else:
        head = x[:, 1:left + 1].flip(-1)
        tail = x[:, x.shape[-1] - 1 - right:x.shape[-1] - 1].flip(-1)
        if mode == 'odd':
            head, tail = 2 * first - head, 2 * last - tail
    return torch.cat([head, x, tail], dim=-1)


def check_COLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """True when the window/hop pair satisfies the Constant OverLap-Add
    constraint (scipy.signal.check_COLA)."""
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise RuntimeError('check_COLA: need 0 <= noverlap < nperseg')
    win = _f64_window(window, nperseg)
    step = nperseg - noverlap
    binsums = np.asarray([win[i::step].sum() for i in range(step)])
    return bool(np.max(np.abs(binsums - np.median(binsums))) < tol)


def check_NOLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """True when the window/hop pair satisfies the NOnzero OverLap-Add
    constraint (scipy.signal.check_NOLA): the istft least-squares inverse
    exists."""
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise RuntimeError('check_NOLA: need 0 <= noverlap < nperseg')
    w2 = _f64_window(window, nperseg) ** 2
    step = nperseg - noverlap
    binsums = np.asarray([w2[i::step].sum() for i in range(step)])
    return bool(binsums.min() > tol * w2.max())


def stft(x: Tensor, fs: float = 1.0, window='hann', nperseg: int = 256,
         noverlap: Optional[int] = None, nfft: Optional[int] = None, detrend=False,
         return_onesided: bool = True, boundary: Optional[str] = 'zeros',
         padded: bool = True, scaling: str = 'spectrum') -> tuple:
    """Short-time Fourier transform with scipy.signal.stft semantics:
    returns ``(f, t, Zxx)`` with Zxx a complex64 Tensor shaped (bins,
    n_frames) (plus a leading batch dim for (batch, n) input).
    ``boundary`` extends the signal by nperseg//2 on both ends ('zeros' |
    'even' | 'odd' | 'constant' | None); ``padded`` zero-pads the tail to a
    whole number of hops. ``scaling='spectrum'`` divides by win.sum(),
    ``'psd'`` by sqrt(fs*sum(win^2)). ``nfft`` (default nperseg) must be a
    power of two."""
    if x.n_dim > 2:
        raise RuntimeError(f'stft: expected 1-D or 2-D input, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError('stft: expected a real signal (the one-sided rfft engine)')
    if noverlap is None:
        noverlap = nperseg // 2
    if not 0 <= noverlap < nperseg:
        raise RuntimeError('stft: need 0 <= noverlap < nperseg')
    if nfft is None:
        nfft = nperseg
    if nfft < nperseg or nfft & (nfft - 1):
        raise RuntimeError(
            f'stft: nfft ({nfft}) must be a power of two >= nperseg ({nperseg}) — the dsc '
            'FFT family is power-of-two')
    if scaling not in ('spectrum', 'psd'):
        raise RuntimeError(f'stft: unknown scaling {scaling!r}')
    if boundary is not None and boundary not in _BOUNDARIES:
        raise RuntimeError(f'stft: unknown boundary {boundary!r}')
    if detrend in (False, None):
        detrend = 'none'
    if detrend not in ('constant', 'linear', 'none'):
        raise RuntimeError(f'stft: unknown detrend {detrend!r}')
    n = x.shape[-1]
    if n < nperseg and boundary is None and not padded:
        raise RuntimeError(f'stft: signal ({n}) shorter than nperseg ({nperseg})')
    hop = nperseg - noverlap
    bpad = nperseg // 2 if boundary is not None else 0
    ext = n + 2 * bpad
    tail = (-(ext - nperseg)) % hop if padded else 0
    ext += tail
    if ext < nperseg:
        raise RuntimeError('stft: extended signal shorter than nperseg')
    n_frames = 1 + (ext - nperseg) // hop
    win = _spectral_window(window, nperseg)
    w64 = win.astype(np.float64)
    scale = 1.0 / w64.sum() if scaling == 'spectrum' else 1.0 / np.sqrt(fs * float(w64 @ w64))
    data = _rows(x)
    spec, tables = fft_plan.get_plan(nfft, 'real', torch.complex64)
    with tracing.trace_op('stft', 'op;pipeline', tracing.tensor_args(x=x)):
        if bpad:
            data = _pad_ext(data, bpad, bpad, _BOUNDARIES[boundary])
        if tail:
            data = torch.nn.functional.pad(data, (0, tail))
        segs = _detrend_segs(frame_dense(data, nperseg, hop, n_frames), nperseg, detrend)
        fx = (segs * _device_array(win, data)).reshape(-1, nperseg)
        if nperseg != nfft:
            fx = torch.nn.functional.pad(fx, (0, nfft - nperseg))
        z = fft_core.rfft_batched(fx, spec, tables, nfft).reshape(data.shape[0], n_frames, -1)
        z = z.transpose(1, 2) * _f32(scale)
        if not return_onesided:
            # the Hermitian mirror: bins nfft//2+1 .. nfft-1 are the
            # conjugates of bins nfft//2-1 .. 1
            z = torch.cat([z, z[:, 1:nfft // 2].flip(1).conj()], dim=1)
        res = Tensor._from_torch(z if x.n_dim == 2 else z[0])
    f = rfftfreq(nfft, d=1.0 / fs) if return_onesided else fftfreq(nfft, d=1.0 / fs)
    # scipy: frame centers on the extended signal, shifted back by
    # nperseg/2 (exactly, not nperseg//2) when a boundary extension ran
    t_np = (np.arange(n_frames) * hop + nperseg / 2.0) / fs
    if boundary is not None:
        t_np = t_np - (nperseg / 2.0) / fs
    return f, from_numpy(t_np.astype(np.float32)), res


def istft(z: Tensor, fs: float = 1.0, window='hann', nperseg: Optional[int] = None,
          noverlap: Optional[int] = None, nfft: Optional[int] = None,
          input_onesided: bool = True, boundary: bool = True,
          scaling: str = 'spectrum') -> tuple:
    """Inverse STFT with scipy.signal.istft semantics: ``z`` is the
    (bins, n_frames) Zxx of :func:`stft` (batch dim allowed). Runs the NOLA
    least-squares overlap-add inverse, undoes the stft scaling and
    (``boundary=True``) trims the nperseg//2 boundary extension. Returns
    ``(t, x)``."""
    if not input_onesided:
        raise RuntimeError('istft: only one-sided input is supported (feed the first '
                           'nfft//2+1 rows)')
    if z.n_dim not in (2, 3):
        raise RuntimeError(f'istft: expected (bins, frames) or batched, got {z.n_dim}-D')
    bins, n_frames = z.shape[-2], z.shape[-1]
    if nfft is None:
        nfft = 2 * (bins - 1)
    if nperseg is None:
        nperseg = nfft
    if nfft < nperseg or nfft & (nfft - 1):
        raise RuntimeError(f'istft: nfft ({nfft}) must be a power of two >= nperseg '
                           f'({nperseg})')
    if bins != nfft // 2 + 1:
        raise RuntimeError(f'istft: z has {bins} bins, expected {nfft // 2 + 1}')
    if noverlap is None:
        noverlap = nperseg // 2
    if not 0 <= noverlap < nperseg:
        raise RuntimeError('istft: need 0 <= noverlap < nperseg')
    hop = nperseg - noverlap
    if scaling not in ('spectrum', 'psd'):
        raise RuntimeError(f'istft: unknown scaling {scaling!r}')
    if not check_NOLA(window, nperseg, noverlap):
        raise RuntimeError('istft: window/hop fails NOLA — the inverse does not exist')
    win = _spectral_window(window, nperseg)
    w64 = win.astype(np.float64)
    unscale = w64.sum() if scaling == 'spectrum' else np.sqrt(fs * float(w64 @ w64))
    span = (n_frames - 1) * hop + nperseg
    # 1/sum(w^2) at every output sample (the exact least-squares inverse)
    wsq = np.zeros(span)
    for i in range(0, n_frames * hop, hop):
        wsq[i:i + nperseg] += w64 * w64
    tiny = float(np.finfo(np.float32).tiny)
    inv_wsq = (1.0 / np.maximum(wsq, tiny)).astype(np.float32)
    data = z.torch.to(torch.complex64)
    if z.n_dim == 2:
        data = data[None]
    spec, tables = fft_plan.get_plan(nfft, 'real', torch.complex64)
    with tracing.trace_op('istft', 'op;pipeline', tracing.tensor_args(z=z)):
        # (b, bins, frames) -> (b, frames, bins), the forward scale undone
        zz = data.transpose(1, 2) * _f32(unscale)
        out = _istft_program(zz, _device_array(win, zz), _device_array(inv_wsq, zz), tables,
                             nperseg, hop, n_frames, spec, nfft, span)
        if boundary:
            out = out[:, nperseg // 2:span - nperseg // 2]
        res = Tensor._from_torch(out if z.n_dim == 3 else out[0])
    t = from_numpy((np.arange(out.shape[-1]) / fs).astype(np.float32))
    return t, res


def _overlap_add_diag(v: np.ndarray, hop: int) -> np.ndarray:
    """sum_m v[k - m*hop] over all integer m (within bounds): the
    zero-frequency diagonal of the Gabor frame operator."""
    out = v.copy()
    for k in range(hop, v.size, hop):
        out[k:] += v[:-k]
        out[:-k] += v[k:]
    return out


def stft_dual_window(win, hop: int) -> np.ndarray:
    """Canonical dual window of ``win`` at hop ``hop`` (the window the
    least-squares ISTFT uses): w / sum_m |w[k - m*hop]|^2. Raises when the
    frame operator is singular (the STFT is not invertible)."""
    win = np.asarray(win)
    if win.ndim != 1:
        raise RuntimeError('stft_dual_window: win must be 1-D')
    if not 1 <= hop <= win.size:
        raise RuntimeError(f'stft_dual_window: hop ({hop}) must be in [1, {win.size}]')
    dd = _overlap_add_diag(win.real ** 2 + win.imag ** 2, hop)
    if not np.all(dd >= np.finfo(np.float64).resolution * dd.max()):
        raise RuntimeError('stft_dual_window: STFT not invertible (the squared-window '
                           'overlap-add has zeros)')
    return win / dd


def closest_STFT_dual_window(win, hop: int, desired_dual=None, scaled: bool = True):
    """The STFT dual window of ``win`` closest (least squares) to
    ``desired_dual`` (scipy.signal.closest_STFT_dual_window semantics): the
    canonical dual plus the part of (desired - its frame image) orthogonal
    to the dual-window constraint. Returns (window, alpha)."""
    win = np.asarray(win, np.float64) if not np.iscomplexobj(win) else np.asarray(win)
    if desired_dual is None:
        desired_dual = np.ones_like(win)
    desired_dual = np.asarray(desired_dual)
    if win.ndim != 1 or win.shape != desired_dual.shape:
        raise RuntimeError('closest_STFT_dual_window: win and desired_dual must be '
                           'equal-length 1-D')
    if not (np.all(np.isfinite(win)) and np.all(np.isfinite(desired_dual))):
        raise RuntimeError('closest_STFT_dual_window: entries must be finite')
    if not 1 <= hop <= win.size:
        raise RuntimeError(f'closest_STFT_dual_window: hop ({hop}) must be in '
                           f'[1, {win.size}]')
    w_d = stft_dual_window(win, hop)
    q_d = w_d * _overlap_add_diag(np.conj(win) * desired_dual, hop)
    if not scaled:
        return w_d + desired_dual - q_d, 1.0
    numer = np.conj(q_d).T @ w_d
    denom = q_d.real @ q_d.real + q_d.imag @ q_d.imag
    if not (abs(numer) > 0 and denom > np.finfo(np.float64).resolution):
        raise RuntimeError('closest_STFT_dual_window: numerically unstable scale; use '
                           'scaled=False')
    alpha = numer / denom
    return w_d + alpha * (desired_dual - q_d), alpha
