"""scipy.signal.ShortTimeFFT parity class (dsc_tpu/models/short_time_fft.py).

The division of labor is the JAX package's:

- host float64 NumPy owns the design-time math: window validation, the
  canonical dual window, the scaling factors and every slice and border
  index (``p_min``/``k_max``/the border methods are window scans run once
  and cached);
- the hot path (slicing the signal into overlapping frames, per-frame
  detrend, window, phase-shift roll and the batched FFT over every slice)
  is one chain of torch ops per call on the batched FFT core when ``mfft``
  is a power of two, so a 1024-point one-sided slice is a launch of K12 on
  its 512-point half-size rows; any other ``mfft`` sends the windowed
  frames through the chirp-z transform (czt.py);
- the inverse is the same chain backwards: batched inverse FFTs, the dual
  window and the overlap-add (stft.py ``_overlap_add``).

A callable detrender runs on the host over the framed signal, as in the
JAX package. The class raises ``ValueError`` on bad parameters, as scipy
does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..fourier import core as fft_core
from ..fourier import plan as fft_plan
from ..fourier.base_fft import frame_dense
from ..tensor import Tensor, from_numpy
from ..windows import design_window
from .psd import _detrend_segs, _f32
from .stft import _device_array, _overlap_add
from .stft_scipy import _overlap_add_diag, _pad_ext

_FFT_MODES = ('twosided', 'centered', 'onesided', 'onesided2X')
# padding name -> np.pad mode (stft_scipy._pad_ext)
_PADDINGS = {'zeros': 'constant', 'edge': 'edge', 'even': 'reflect', 'odd': 'odd'}


def _calc_dual_canonical_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical (minimal-L2) dual window; raises ValueError when the frame
    operator is singular (scipy _calc_dual_canonical_window)."""
    if hop > len(win):
        raise ValueError(f'hop={hop} is larger than window length {len(win)} => STFT '
                         'not invertible!')
    if issubclass(win.dtype.type, np.integer):
        raise ValueError('Parameter win cannot be of integer type => STFT not invertible!')
    dd = _overlap_add_diag(win.real ** 2 + win.imag ** 2, hop)
    if not np.all(dd >= np.finfo(win.dtype).resolution * dd.max()):
        raise ValueError('Short-time Fourier Transform not invertible!')
    return win / dd


def _as_batched(x, name: str, axis: int = -1):
    """Tensor | array-like -> ((b, n) float32 or complex64 rows, the
    leading shape after ``axis`` is moved last)."""
    if not isinstance(x, Tensor):
        x = from_numpy(np.asarray(x))
    if x.n_dim > 3:
        raise ValueError(f'{name}: at most 3-D input (rank-4 Tensor cap with the added '
                         'frequency axis)')
    if not -x.n_dim <= axis < x.n_dim:
        raise ValueError(f'{name}: axis {axis} out of range for {x.n_dim}-D input')
    data = x.torch.to(torch.complex64 if x.dtype.is_complex else torch.float32)
    data = torch.movedim(data, axis, -1)
    lead = tuple(data.shape[:-1])
    return data.reshape(-1, data.shape[-1]), lead


def _stft_program(x, win, tables, geom, pad, m_num, hop, q_num, detr, mfft, p_s, spec, mode,
                  fac, want_frames):
    """(b, n) rows -> (b, f_pts, q_num) complex64 spectrum, or (the
    chirp-z route, ``want_frames``) the windowed (b*q_num, mfft) frames
    (dsc_tpu/models/short_time_fft.py:120-179): slice extraction, boundary
    padding, detrend, window, phase roll and the batched FFT."""
    i0, i1, pl, pr = geom
    p = x[:, i0:i1]
    if pl or pr:
        p = _pad_ext(p, pl, pr, pad)
    segs = _detrend_segs(frame_dense(p, m_num, hop, q_num), m_num, detr)
    f = (segs * win.conj()).reshape(-1, m_num)  # scipy windows with win.conj()
    if m_num != mfft:
        f = torch.nn.functional.pad(f, (0, mfft - m_num))
    if p_s:
        f = f.roll(-p_s, -1)
    if want_frames:
        return f
    if mode in ('onesided', 'onesided2X'):
        z = fft_core.rfft_batched(f, spec, tables, mfft)
        if mode == 'onesided2X':
            # mfft is even on this (power-of-two) path: the last bin is unpaired
            z[:, 1:-1] *= fac
    else:
        z = fft_core.fft_batched(f.to(torch.complex64).contiguous(), spec, tables, False)
        if mode == 'centered':
            z = z.roll(mfft // 2, -1)
    return z.reshape(x.shape[0], q_num, -1).transpose(1, 2)


def _istft_program(z, dwin, tables, mfft, m_num, hop, q_num, spec, mode, p_s, fac, off, buf_n,
                   lpad, out_n):
    """(b, f_pts, q_num) complex64 spectrum -> (b, out_n) signal
    (dsc_tpu/models/short_time_fft.py:182-228): batched inverse FFT, the
    dual window and the overlap-add, frame q at sample off + q*hop of a
    margin-padded buffer (the margins absorb scipy's k0/k1 edge clipping)."""
    b = z.shape[0]
    z = z.transpose(1, 2).reshape(b * q_num, -1)
    if mode in ('onesided', 'onesided2X'):
        if mode == 'onesided2X':
            z = z.clone()
            z[:, 1:-1] *= _f32(1.0 / fac)
        f = fft_core.irfft_batched(z, spec, tables, mfft)
    else:
        if mode == 'centered':  # ifftshift
            z = z.roll(-(mfft // 2), -1)
        f = fft_core.fft_batched(z.contiguous(), spec, tables, True)
    return _dual_overlap_add(f, dwin, b, q_num, m_num, hop, p_s, off, buf_n, lpad, out_n)


def _dual_overlap_add(f, dwin, b, q_num, m_num, hop, p_s, off, buf_n, lpad, out_n):
    """Inverse-transformed frames (b*q_num, mfft) -> (b, out_n): undo the
    phase roll, crop to the window, times the dual window, overlap-add."""
    if p_s:
        f = f.roll(p_s, -1)
    frames = f[:, :m_num].reshape(b, q_num, m_num) * dwin
    return _overlap_add(frames, hop, off, buf_n)[:, lpad:lpad + out_n]


class ShortTimeFFT:
    """Short-time FFT with scipy.signal.ShortTimeFFT semantics: a sliding
    ``win`` advancing ``hop`` samples a slice, FFT length ``mfft`` (powers
    of two ride the batched FFT core, any other length the chirp-z
    transform), the zeroth slice centered at sample 0. Every property and
    method mirrors the scipy class. Signals and spectra are Tensors
    (array-likes accepted); compute is float32/complex64 on the device,
    design math float64 on the host."""

    def __init__(self, win: np.ndarray, hop: int, fs: float, *, fft_mode: str = 'onesided',
                 mfft: Optional[int] = None, dual_win: Optional[np.ndarray] = None,
                 scale_to: Optional[str] = None, phase_shift: Optional[int] = 0):
        win = win.numpy().copy() if isinstance(win, Tensor) else np.asarray(win)
        if not (win.ndim == 1 and win.size > 0):
            raise ValueError(f'Parameter win must be 1d, but {win.shape=}!')
        if not np.all(np.isfinite(win)):
            raise ValueError('Parameter win must have finite entries!')
        if not (hop >= 1 and isinstance(hop, (int, np.integer))):
            raise ValueError(f'Parameter {hop=} is not an integer >= 1!')
        if not np.iscomplexobj(win):
            win = win.astype(np.float64)
        self._win, self._hop = win, int(hop)
        self.fs = fs
        self._scaling: Optional[str] = None
        self._fac_mag = self._fac_psd = None
        self._pre_pad_cache = None
        self._post_pad_cache = (None, None)
        self._lower_border_cache = None
        self._upper_border_cache = (None, None)
        self._czt_cache = (None, None)
        self.mfft = len(win) if mfft is None else mfft
        if dual_win is not None:
            dual_win = np.asarray(dual_win)
            if dual_win.shape != win.shape:
                raise ValueError(f'{dual_win.shape=} must equal {win.shape=}!')
            if not np.all(np.isfinite(dual_win)):
                raise ValueError('Parameter dual_win must be a finite array!')
        self._dual_win = dual_win  # set before scaling
        if scale_to is not None:  # set before fft_mode
            self.scale_to(scale_to)
        self.fft_mode, self.phase_shift = fft_mode, phase_shift

    # -- alternate constructors ------------------------------------------
    @classmethod
    def from_dual(cls, dual_win: np.ndarray, hop: int, fs: float, *,
                  fft_mode: str = 'onesided', mfft: Optional[int] = None,
                  scale_to: Optional[str] = None,
                  phase_shift: Optional[int] = 0) -> 'ShortTimeFFT':
        """Instantiate from the dual window: ``win`` is its canonical dual
        (the involution property of the canonical dual)."""
        dual_win = np.asarray(dual_win)
        win = _calc_dual_canonical_window(dual_win, hop)
        return cls(win=win, hop=hop, fs=fs, fft_mode=fft_mode, mfft=mfft, dual_win=dual_win,
                   scale_to=scale_to, phase_shift=phase_shift)

    @classmethod
    def from_window(cls, win_param, fs: float, nperseg: int, noverlap: int, *,
                    symmetric_win: bool = False, fft_mode: str = 'onesided',
                    mfft: Optional[int] = None, scale_to: Optional[str] = None,
                    phase_shift: Optional[int] = 0) -> 'ShortTimeFFT':
        """Instantiate through the get_window designer (periodic by default,
        ``symmetric_win=True`` for the symmetric variant)."""
        win = design_window(win_param, nperseg, fftbins=not symmetric_win)
        return cls(win, hop=nperseg - noverlap, fs=fs, fft_mode=fft_mode, mfft=mfft,
                   scale_to=scale_to, phase_shift=phase_shift)

    @classmethod
    def from_win_equals_dual(cls, desired_win: np.ndarray, hop: int, fs: float, *,
                             fft_mode: str = 'onesided', mfft: Optional[int] = None,
                             scale_to: Optional[str] = None,
                             phase_shift: Optional[int] = 0) -> 'ShortTimeFFT':
        """Window equal to its own dual (up to scaling), closest to
        ``desired_win`` in least squares: each of the ``hop`` comb
        subsequences normalized to unit L2 norm. ``scale_to='unitary'``
        makes the STFT a unitary map (win / sqrt(mfft), dual * sqrt(mfft))."""
        desired_win = np.asarray(desired_win)
        if not (desired_win.ndim == 1 and desired_win.size > 0):
            raise ValueError(f'Parameter desired_win is not 1d, but {desired_win.shape=}!')
        if issubclass(desired_win.dtype.type, np.integer):
            raise ValueError('Parameter desired_win cannot be of integer type => cast to '
                             'float | complex')
        if not np.all(np.isfinite(desired_win)):
            raise ValueError('Parameter desired_win must have finite entries!')
        if not (1 <= hop <= len(desired_win) and isinstance(hop, (int, np.integer))):
            raise ValueError(f'Parameter {hop=} is not an integer between 1 and '
                             f'{len(desired_win)=}!')
        if scale_to not in ('magnitude', 'psd', 'unitary', None):
            raise ValueError(f"Parameter {scale_to=} not in ['magnitude', 'psd', 'unitary', "
                             'None]!')
        mfft_ = len(desired_win) if mfft is None else mfft
        s_fac = np.sqrt(mfft_) if scale_to == 'unitary' else 1
        win = desired_win.astype(np.complex128 if np.iscomplexobj(desired_win)
                                 else np.float64)
        rel_res = np.finfo(win.dtype).resolution * np.max(win.real)
        for m in range(hop):
            a = np.linalg.norm(desired_win[m::hop])
            if not a > rel_res:
                raise ValueError('Parameter desired_win does not have a valid STFT dual '
                                 f'window for {hop=}!')
            win[m::hop] /= a
        sft = cls(win=win / s_fac, hop=hop, fs=fs, fft_mode=fft_mode, mfft=mfft_,
                  dual_win=win * s_fac, phase_shift=phase_shift,
                  scale_to=None if scale_to == 'unitary' else scale_to)
        if scale_to == 'unitary':
            sft._scaling = 'unitary'
        return sft

    # -- simple attributes ------------------------------------------------
    @property
    def win(self) -> np.ndarray:
        """Window as a host float64/complex128 array (copy it to mutate)."""
        return self._win

    @property
    def hop(self) -> int:
        return self._hop

    @property
    def fs(self) -> float:
        return self._fs

    @fs.setter
    def fs(self, v: float):
        if not v > 0:
            raise ValueError(f'Sampling frequency fs={v} must be positive!')
        self._fs = v

    @property
    def T(self) -> float:
        return 1.0 / self._fs

    @T.setter
    def T(self, v: float):
        if not v > 0:
            raise ValueError(f'Sampling interval T={v} must be positive!')
        self._fs = 1.0 / v

    @property
    def fft_mode(self) -> str:
        return self._fft_mode

    @fft_mode.setter
    def fft_mode(self, t: str):
        if t not in _FFT_MODES:
            raise ValueError(f"fft_mode='{t}' not in {_FFT_MODES}!")
        if t in ('onesided', 'onesided2X') and np.iscomplexobj(self.win):
            raise ValueError(f"One-sided spectra, i.e., fft_mode='{t}', are not allowed for "
                             'complex-valued windows!')
        if t == 'onesided2X' and self.scaling is None:
            raise ValueError(f"For scaling is None, fft_mode='{t}' is invalid! Do "
                             "scale_to('psd') or scale_to('magnitude')!")
        self._fft_mode = t

    @property
    def mfft(self) -> int:
        return self._mfft

    @mfft.setter
    def mfft(self, n_: int):
        if not n_ >= self.m_num:
            raise ValueError(f'Attribute mfft={n_} needs to be at least the window length '
                             f'm_num={self.m_num}!')
        self._mfft = int(n_)

    @property
    def scaling(self) -> Optional[str]:
        return self._scaling

    def scale_to(self, scaling: str):
        """Scale the window (and dual) in place so that every STFT column
        is a 'magnitude' or 'psd' spectrum."""
        if scaling not in ('magnitude', 'psd'):
            raise ValueError(f"{scaling=} not in {{'magnitude', 'psd'}}!")
        if self._scaling == scaling:
            return
        s_fac = self.fac_psd if scaling == 'psd' else self.fac_magnitude
        self._win = self._win * s_fac
        if self._dual_win is not None:
            self._dual_win = self._dual_win / s_fac
        self._fac_mag, self._fac_psd = None, None
        self._scaling = scaling

    @property
    def phase_shift(self) -> Optional[int]:
        return self._phase_shift

    @phase_shift.setter
    def phase_shift(self, v: Optional[int]):
        if v is None:
            self._phase_shift = None
            return
        if not isinstance(v, (int, np.integer)):
            raise ValueError(f'phase_shift={v} has the unit samples and hence must be an '
                             'int or None!')
        if not -self.mfft < v < self.mfft:
            raise ValueError(f'-mfft < phase_shift < mfft does not hold for '
                             f'mfft={self.mfft}, phase_shift={v}!')
        self._phase_shift = int(v)

    # -- scaling factors ---------------------------------------------------
    @property
    def fac_magnitude(self) -> float:
        """Factor scaling STFT values to a magnitude spectrum."""
        if self.scaling == 'magnitude':
            return 1
        if self._fac_mag is None:
            self._fac_mag = 1 / abs(np.sum(self.win))
        return self._fac_mag

    @property
    def fac_psd(self) -> float:
        """Factor scaling STFT values to a PSD spectrum."""
        if self.scaling == 'psd':
            return 1
        if self._fac_psd is None:
            self._fac_psd = 1 / np.sqrt(
                np.sum(self.win.real ** 2 + self.win.imag ** 2) / self.T)
        return self._fac_psd

    # -- window geometry (host integer arithmetic, the JAX package's) -------
    @property
    def m_num(self) -> int:
        return len(self._win)

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    def _w2(self) -> np.ndarray:
        return self._win.real ** 2 + self._win.imag ** 2

    def _pre_padding(self):
        """(k_min, p_min): shift the window left until its overlap with
        t >= 0 vanishes (trailing window zeros do not count)."""
        if self._pre_pad_cache is not None:
            return self._pre_pad_cache
        w2 = self._w2()
        n0 = -self.m_num_mid
        for p_, n_ in enumerate(range(n0, n0 - self.m_num - 1, -self.hop)):
            n_next = n_ - self.hop
            if n_next + self.m_num <= 0 or not w2[n_next:].any():
                self._pre_pad_cache = (n_, -p_)
                return self._pre_pad_cache
        raise RuntimeError('unreachable: window has no nonzero sample')

    @property
    def k_min(self) -> int:
        """Leftmost sample index touched by the lowest slice (<= 0)."""
        return self._pre_padding()[0]

    @property
    def p_min(self) -> int:
        """Smallest slice index with window overlap into t >= 0 (<= 0)."""
        return self._pre_padding()[1]

    def _post_padding(self, n: int):
        """(k_max, p_max) for an n-sample signal: shift the window right
        until its overlap with t < t[n] vanishes."""
        if not n >= (m2p := self.m_num - self.m_num_mid):
            raise ValueError(f'Parameter n must be >= ceil(m_num/2) = {m2p}!')
        if self._post_pad_cache[0] == n:
            return self._post_pad_cache[1]
        w2 = self._w2()
        q1 = n // self.hop
        k1 = q1 * self.hop - self.m_num_mid
        for q_, k_ in enumerate(range(k1, n + self.m_num, self.hop), start=q1):
            n_next = k_ + self.hop
            if n_next >= n or not w2[:n - n_next].any():
                self._post_pad_cache = (n, (k_ + self.m_num, q_ + 1))
                return self._post_pad_cache[1]
        raise RuntimeError('unreachable: window has no nonzero sample')

    def k_max(self, n: int) -> int:
        """First sample index after the signal end not touched by any time
        slice."""
        return self._post_padding(n)[0]

    def p_max(self, n: int) -> int:
        """Index of the first non-overlapping upper time slice."""
        return self._post_padding(n)[1]

    def p_num(self, n: int) -> int:
        """Number of time slices: p_max(n) - p_min."""
        return self.p_max(n) - self.p_min

    @property
    def lower_border_end(self):
        """(sample, slice) indices where the pre-padding effects end."""
        if self._lower_border_cache is not None:
            return self._lower_border_cache
        w2 = self._w2()
        m0 = int(np.flatnonzero(w2)[0])
        k0 = -self.m_num_mid + m0
        for q_, k_ in enumerate(range(k0, self.hop + 1, self.hop)):
            if k_ + self.hop >= 0:
                self._lower_border_cache = (k_ + self.m_num, q_ + 1)
                return self._lower_border_cache
        self._lower_border_cache = (0, max(self.p_min, 0))
        return self._lower_border_cache

    def upper_border_begin(self, n: int):
        """(sample, slice) indices where the post-padding effects begin."""
        if not n >= (m2p := self.m_num - self.m_num_mid):
            raise ValueError(f'Parameter n must be >= ceil(m_num/2) = {m2p}!')
        if self._upper_border_cache[0] == n:
            return self._upper_border_cache[1]
        w2 = self._w2()
        q2 = n // self.hop + 1
        q1 = max((n - self.m_num) // self.hop - 1, -1)
        for q_ in range(q2, q1, -1):
            k_ = q_ * self.hop + (self.m_num - self.m_num_mid)
            if k_ <= n or not w2[n - k_:].any():
                ret = ((q_ + 1) * self.hop - self.m_num_mid, q_ + 1)
                self._upper_border_cache = (n, ret)
                return ret
        raise RuntimeError('unreachable: window has no nonzero sample')

    # -- time/frequency axes ---------------------------------------------
    @property
    def delta_t(self) -> float:
        """Time increment between slices: T * hop."""
        return self.T * self.hop

    @property
    def delta_f(self) -> float:
        """Width of the frequency bins: 1 / (mfft * T)."""
        return 1.0 / (self.mfft * self.T)

    @property
    def f_pts(self) -> int:
        """Number of points along the frequency axis."""
        return self.mfft // 2 + 1 if self.onesided_fft else self.mfft

    @property
    def onesided_fft(self) -> bool:
        return self.fft_mode in ('onesided', 'onesided2X')

    @property
    def f(self) -> np.ndarray:
        """Frequency values of the STFT (host float64 array)."""
        if self.onesided_fft:
            return np.fft.rfftfreq(self.mfft, self.T)
        freqs = np.fft.fftfreq(self.mfft, self.T)
        return np.fft.fftshift(freqs) if self.fft_mode == 'centered' else freqs

    def p_range(self, n: int, p0: Optional[int] = None, p1: Optional[int] = None):
        """Validated slice index range [p0, p1) for an n-sample signal."""
        p_max = self.p_max(n)
        p0_ = self.p_min if p0 is None else p0
        p1_ = p_max if p1 is None else p1
        if not self.p_min <= p0_ < p1_ <= p_max:
            raise ValueError(f'Invalid Parameter {p0=}, {p1=}, i.e., {self.p_min=} <= p0 < '
                             f'p1 <= {p_max=} does not hold for signal length {n=}!')
        return p0_, p1_

    def t(self, n: int, p0: Optional[int] = None, p1: Optional[int] = None,
          k_offset: int = 0) -> np.ndarray:
        """Slice center times for an n-sample signal (host float64 array)."""
        if not (n > 0 and isinstance(n, (int, np.integer))):
            raise ValueError(f'Parameter {n=} is not a positive integer!')
        p0, p1 = self.p_range(n, p0, p1)
        return np.arange(p0, p1) * self.delta_t + k_offset * self.T

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        """Nearest sample index k_p <= k (or >= k) on the slice-center grid
        (a multiple of hop)."""
        p_q, remainder = divmod(k, self.hop)
        if remainder == 0:
            return k
        return p_q * self.hop if left else (p_q + 1) * self.hop

    def extent(self, n: int, axes_seq: str = 'tf', center_bins: bool = False):
        """(t0, t1, f0, f1) bounding box for imshow-style plotting."""
        if axes_seq not in ('tf', 'ft'):
            raise ValueError(f"Parameter {axes_seq=} not in ['tf', 'ft']!")
        if self.onesided_fft:
            q0, q1 = 0, self.f_pts
        elif self.fft_mode == 'centered':
            q0 = -(self.mfft // 2)
            q1 = self.mfft // 2 if self.mfft % 2 == 0 else self.mfft // 2 + 1
        else:
            raise ValueError(f'Attribute fft_mode={self.fft_mode} must be in '
                             "['centered', 'onesided', 'onesided2X']")
        p0, p1 = self.p_min, self.p_max(n)
        if center_bins:
            t0, t1 = self.delta_t * (p0 - 0.5), self.delta_t * (p1 - 0.5)
            f0, f1 = self.delta_f * (q0 - 0.5), self.delta_f * (q1 - 0.5)
        else:
            t0, t1 = self.delta_t * p0, self.delta_t * p1
            f0, f1 = self.delta_f * q0, self.delta_f * q1
        return (t0, t1, f0, f1) if axes_seq == 'tf' else (f0, f1, t0, t1)

    # -- dual window ----------------------------------------------------
    @property
    def dual_win(self) -> np.ndarray:
        """Dual window (the canonical dual by default, computed lazily)."""
        if self._dual_win is None:
            self._dual_win = _calc_dual_canonical_window(self.win, self.hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        """True when the canonical dual window exists."""
        try:
            return len(self.dual_win) > 0
        except ValueError:
            return False

    # -- transform plumbing ----------------------------------------------
    def _is_pow2(self) -> bool:
        return self.mfft & (self.mfft - 1) == 0

    def _czt_plan(self):
        """Cached length-mfft unit-circle chirp-z transform (the exact DFT
        of any length)."""
        if self._czt_cache[0] != self.mfft:
            from .czt import CZT
            self._czt_cache = (self.mfft, CZT(self.mfft))
        return self._czt_cache[1]

    @staticmethod
    def _win_dev(w: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return _device_array(w.astype(np.complex64 if np.iscomplexobj(w) else np.float32), like)

    def _p_s(self) -> Optional[int]:
        if self.phase_shift is None:
            return None
        return (self.phase_shift + self.m_num_mid) % self.m_num

    def _x2_fac(self) -> float:
        return float(np.sqrt(2)) if self.scaling == 'psd' else 2.0

    def _onesided2x_vec(self, fac: float, like: torch.Tensor) -> torch.Tensor:
        """The onesided2X bin factors of the chirp-z route: ``fac`` on every
        bin with a mirror (the last one has none when mfft is even)."""
        vec = np.ones(self.f_pts, np.float32)
        vec[1:None if self.mfft % 2 else -1] = fac
        return torch.from_numpy(vec).to(like.device)

    # -- forward transforms ----------------------------------------------
    def stft(self, x, p0: Optional[int] = None, p1: Optional[int] = None, *,
             k_offset: int = 0, padding: str = 'zeros', axis: int = -1) -> Tensor:
        """Short-time Fourier transform of ``x`` (Tensor or array-like): a
        complex64 Tensor with the frequency axis where ``axis`` was and the
        p1-p0 time slices last."""
        return self.stft_detrend(x, None, p0, p1, k_offset=k_offset, padding=padding,
                                 axis=axis)

    def stft_detrend(self, x, detr, p0: Optional[int] = None, p1: Optional[int] = None, *,
                     k_offset: int = 0, padding: str = 'zeros', axis: int = -1) -> Tensor:
        """STFT with a per-slice trend removed first. ``detr`` is
        'constant' | 'linear' (on the device) | a callable applied slice by
        slice (on the host over the framed signal) | None."""
        if padding not in _PADDINGS:
            raise ValueError(f'Parameter padding={padding!r} not in {tuple(_PADDINGS)}!')
        callable_detr = callable(detr)
        if not (detr is None or callable_detr or detr in ('constant', 'linear')):
            raise ValueError(f'Parameter {detr=} is not a str, function or None!')
        xb, lead = _as_batched(x, 'stft', axis)
        if self.onesided_fft and xb.is_complex():
            raise ValueError(f'Complex-valued x not allowed for fft_mode={self.fft_mode!r}! '
                             "Set fft_mode to 'twosided' or 'centered'.")
        n = xb.shape[-1]
        if not n >= (m2p := self.m_num - self.m_num_mid):
            raise ValueError(f'Signal length n={n} of axis={axis} must be >= ceil(m_num/2) '
                             f'= {m2p}!')
        p0, p1 = self.p_range(n, p0, p1)
        q_num = p1 - p0
        k0 = p0 * self.hop - self.m_num_mid + k_offset
        k1 = k0 + q_num * self.hop + self.m_num
        geom = (max(k0, 0), min(k1, n), -min(k0, 0), max(k1 - n, 0))
        hop_eff = self.hop
        if callable_detr:
            # framed on the host: consecutive m_num-blocks, re-framed on the
            # device with hop == m_num
            xb = self._host_detrend_frames(xb, detr, geom, q_num, padding)
            geom = (0, xb.shape[-1], 0, 0)
            hop_eff = self.m_num
            detr_key = 'none'
        else:
            detr_key = detr if detr else 'none'
        win = self._win_dev(self.win, xb)
        pow2 = self._is_pow2()
        spec, tables = (fft_plan.get_plan(
            self.mfft, 'real' if self.onesided_fft else 'complex', torch.complex64)
            if pow2 else ((), None))
        with tracing.trace_op('ShortTimeFFT.stft', 'op;pipeline', tracing.tensor_args()):
            z = _stft_program(xb, win, tables, geom, _PADDINGS[padding], self.m_num, hop_eff,
                              q_num, detr_key, self.mfft, self._p_s(), spec, self.fft_mode,
                              _f32(self._x2_fac()), not pow2)
            if not pow2:
                z = self._czt_post(z, xb.shape[0], q_num)
            z = z.reshape(lead + (self.f_pts, q_num))
            if len(lead) and axis % (len(lead) + 1) != len(lead):
                # scipy's axes: frequency where the input axis was, time last
                z = torch.movedim(z, len(lead), axis % (len(lead) + 1))
            res = Tensor._from_torch(z.to(torch.complex64))
        return res

    def _host_detrend_frames(self, xb, detr, geom, q_num, padding):
        """Callable detrenders: frame in NumPy on the host, apply the
        callable to each slice (scipy passes each (..., m_num) slice) and
        hand back the frames flattened as (b, q_num*m_num)."""
        mode = _PADDINGS[padding]
        np_mode, kw = (('reflect', {'reflect_type': 'odd'}) if mode == 'odd' else (mode, {}))
        i0, i1, pl, pr = geom
        p = xb.cpu().numpy()
        p = p[:, i0:i1]
        if pl or pr:
            p = np.pad(p, ((0, 0), (pl, pr)), mode=np_mode, **kw)
        frames = np.stack([p[:, q * self.hop:q * self.hop + self.m_num]
                           for q in range(q_num)], axis=1)
        frames = np.stack([detr(frames[:, q]) for q in range(q_num)], axis=1)
        b = frames.shape[0]
        host = frames.reshape(b, -1).astype(np.complex64 if xb.is_complex() else np.float32)
        return torch.from_numpy(host).to(xb.device)

    def _czt_post(self, frames, b, q_num):
        """A non-power-of-two mfft: the windowed frames (b*q, mfft) through
        the chirp-z transform, then the fft_mode post-processing."""
        z = self._czt_plan()(Tensor._from_torch(frames.to(torch.complex64))).torch
        mode, mfft = self.fft_mode, self.mfft
        if mode in ('onesided', 'onesided2X'):
            z = z[:, :self.f_pts]
            if mode == 'onesided2X':
                z = z * self._onesided2x_vec(self._x2_fac(), z)
        elif mode == 'centered':
            z = z.roll(mfft // 2, -1)
        return z.reshape(b, q_num, -1).transpose(1, 2)

    def spectrogram(self, x, y=None, detr=None, *, p0: Optional[int] = None,
                    p1: Optional[int] = None, k_offset: int = 0, padding: str = 'zeros',
                    axis: int = -1) -> Tensor:
        """|STFT|^2 of ``x`` (a real Tensor), or the cross-spectrogram
        ``Sx * conj(Sy)`` when ``y`` is given (complex)."""
        sx = self.stft_detrend(x, detr, p0, p1, k_offset=k_offset, padding=padding,
                               axis=axis).torch
        if y is None or y is x:
            return Tensor._from_torch(sx.real * sx.real + sx.imag * sx.imag)
        sy = self.stft_detrend(y, detr, p0, p1, k_offset=k_offset, padding=padding,
                               axis=axis).torch
        return Tensor._from_torch(sx * sy.conj())

    # -- inverse ---------------------------------------------------------
    def istft(self, S, k0: int = 0, k1: Optional[int] = None, *, f_axis: int = -2,
              t_axis: int = -1) -> Tensor:
        """Inverse STFT of ``S`` (complex Tensor or array-like) over the
        sample range [k0, k1); the first time slice sits at ``p_min``. A
        real Tensor for the one-sided modes, complex64 otherwise."""
        if not isinstance(S, Tensor):
            S = from_numpy(np.asarray(S, np.complex64))
        if f_axis == t_axis:
            raise ValueError(f'{f_axis=} may not be equal to {t_axis=}!')
        nd = S.n_dim
        shape = S.shape
        f_ax = f_axis + nd if f_axis < 0 else f_axis
        t_ax = t_axis + nd if t_axis < 0 else t_axis
        if shape[f_ax] != self.f_pts:
            raise ValueError(f'S.shape[f_axis]={shape[f_ax]} must be equal to '
                             f'f_pts={self.f_pts} ({shape=})!')
        n_min = self.m_num - self.m_num_mid
        if not shape[t_ax] >= (q_num_min := self.p_num(n_min)):
            raise ValueError(f'S.shape[t_axis]={shape[t_ax]} needs to have at least '
                             f'{q_num_min} slices ({shape=})!')
        s = torch.movedim(S.torch.to(torch.complex64), (f_ax, t_ax), (-2, -1))
        lead = tuple(s.shape[:-2])
        s = s.reshape((-1,) + s.shape[-2:])

        q_max = s.shape[-1] + self.p_min
        k_max = (q_max - 1) * self.hop + self.m_num - self.m_num_mid
        k1 = k_max if k1 is None else k1
        if not self.k_min <= k0 < k1 <= k_max:
            raise ValueError(f'({self.k_min=}) <= ({k0=}) < ({k1=}) <= ({k_max=}) is '
                             'false!')
        if not (num_pts := k1 - k0) >= n_min:
            raise ValueError(f'({k1=}) - ({k0=}) = {num_pts} has to be at least half the '
                             f'window length {n_min}!')
        q0 = k0 // self.hop + self.p_min if k0 >= 0 else k0 // self.hop
        q1 = min(self.p_max(k1), q_max)
        q_num = q1 - q0
        s = s[:, :, q0 - self.p_min:q1 - self.p_min]
        base = q0 * self.hop - self.m_num_mid - k0
        lpad = max(0, -base)
        off = base + lpad
        buf_n = off + (q_num - 1) * self.hop + self.m_num
        out_n = k1 - k0
        dwin = self._win_dev(self.dual_win, s)
        with tracing.trace_op('ShortTimeFFT.istft', 'op;pipeline', tracing.tensor_args(S=S)):
            if self._is_pow2():
                spec, tables = fft_plan.get_plan(
                    self.mfft, 'real' if self.onesided_fft else 'complex', torch.complex64)
                y = _istft_program(s, dwin, tables, self.mfft, self.m_num, self.hop, q_num,
                                   spec, self.fft_mode, self._p_s(), self._x2_fac(), off,
                                   buf_n, lpad, out_n)
            else:
                y = self._czt_istft(s, dwin, q_num, off, buf_n, lpad, out_n)
            if not self.onesided_fft:
                y = y.to(torch.complex64)
            y = y.reshape(lead + (out_n,))
            if y.dim() > 1:
                dst = f_ax if f_ax < y.dim() else t_ax
                y = torch.movedim(y, -1, dst)
            res = Tensor._from_torch(y)
        return res

    def _czt_istft(self, s, dwin, q_num, off, buf_n, lpad, out_n):
        """A non-power-of-two mfft inverse: IDFT_m(X) = conj(DFT_m(conj(X)))/m
        through the cached chirp-z plan, then the dual-window overlap-add."""
        b = s.shape[0]
        mfft, mode = self.mfft, self.fft_mode
        z = s.transpose(1, 2).reshape(b * q_num, -1)
        if mode in ('onesided', 'onesided2X'):
            if mode == 'onesided2X':
                z = z * self._onesided2x_vec(_f32(1.0 / self._x2_fac()), z)
            # the Hermitian extension to all mfft bins (the last bin mirrors
            # only when mfft is odd)
            hi = self.f_pts - 1 if mfft % 2 == 0 else self.f_pts
            z = torch.cat([z, z[:, 1:hi].flip(-1).conj()], dim=-1)
        elif mode == 'centered':
            z = z.roll(-(mfft // 2), -1)
        w = self._czt_plan()(Tensor._from_torch(torch.conj_physical(z))).torch
        f = torch.conj_physical(w) * _f32(1.0 / mfft)
        if self.onesided_fft:
            f = f.real
        return _dual_overlap_add(f, dwin, b, q_num, self.m_num, self.hop, self._p_s(), off,
                                 buf_n, lpad, out_n)
