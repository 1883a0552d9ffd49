"""STFT / spectrogram pipeline (dsc_tpu/models/stft.py; BASELINE.json
config 4: sliding-window rfft + |.|^2 + log over streaming audio, traced end
to end with dsc.profile()).

The forward STFT (``_stft_program``) is one launch of K12s
(fourier/base_fft.py ``stft_base``) where the frames' batched rfft rides
K12r (config.batched_engine 'base': float32 frames of 512..8192 points):
the kernel frames the signal, windows it and writes the complex spectrum,
its power or its log power. Elsewhere it is plain passes
(``base_fft.stft_plain``): framing as a strided view of the signal
(``base_fft.frame_dense``, ``unfold``) copied once into the windowed frames,
the batched FFT engine (fourier/core.py ``rfft_batched``), power and log.
The inverse (``_istft_program``) runs the batched irfft and overlap-adds
the frames as ceil(frame/hop) shifted slice-adds, each over non-overlapping
hop-wide pieces, for any hop. psd.py, stft_scipy.py and short_time_fft.py
frame and overlap-add through the same helpers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import capture, tracing
from ..fourier import base_fft, config
from ..fourier import core as fft_core
from ..fourier import plan as fft_plan
from ..tensor import Tensor


_NP_WINDOWS = {'hann': np.hanning, 'hamming': np.hamming, 'blackman': np.blackman}


def _make_window(window, frame: int) -> np.ndarray:
    """Window spec -> float32 host array. Accepts a name ('hann',
    'hamming', 'blackman', 'rect'/None: the symmetric np.* convention; any
    other scipy.signal.get_window name or (name, *params) tuple resolves
    through ``windows.design_window``, symmetric), a dsc Tensor (e.g.
    dsc.kaiser(frame, beta)), or any array-like of length ``frame``."""
    if isinstance(window, Tensor):
        win = window.numpy()
    elif isinstance(window, str) and window in _NP_WINDOWS:
        win = _NP_WINDOWS[window](frame)
    elif window is None or (isinstance(window, str) and window == 'rect'):
        win = np.ones(frame)
    elif isinstance(window, str) or (
            isinstance(window, tuple) and window and isinstance(window[0], str)):
        from ..windows import design_window
        win = design_window(window, frame, fftbins=False)
    else:
        win = np.asarray(window)
    win = np.asarray(win, dtype=np.float32)
    if win.shape != (frame,):
        raise RuntimeError(f'window has shape {win.shape}, expected ({frame},)')
    return win


def _device_array(host: np.ndarray, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A host array (a window, taper, weights or taps) on ``like``'s device,
    else on the context's. Inside a ``dsc.compile`` function it is a
    constant of the program, which a CUDA graph's capture copies on the
    device where it could not upload from the host."""
    if like is not None:
        dev = like.device
    else:
        from ..context import device

        dev = device()
    if capture.current() is None:
        return torch.from_numpy(host).to(dev)
    return capture.created(lambda: Tensor._from_torch(torch.from_numpy(host).to(dev))).torch


def _placed(cache: dict, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A model's device array ``t`` on ``dev``: itself where it lies, else a
    copy kept in ``cache``, made at the first call there (a mesh program's
    shard on another card runs its trace run so, fuse.py)."""
    if t.device == dev:
        return t
    got = cache.get(dev)
    if got is None:
        got = cache[dev] = t.to(dev)
    return got


def _fft_convolve_rows(x: torch.Tensor, h: torch.Tensor, fft_n: int) -> torch.Tensor:
    """Full linear convolution of the rows of x (b, m) with the rows of h
    (c, k), b or c being 1 (broadcast), by one batched rfft of x, one of h
    and one irfft of their product, all at ``fft_n``."""
    spec, tables = fft_plan.get_plan(fft_n, 'real', torch.complex64)
    pad = torch.nn.functional.pad
    xs = fft_core.rfft_batched(pad(x, (0, fft_n - x.shape[-1])), spec, tables, fft_n)
    hs = fft_core.rfft_batched(pad(h, (0, fft_n - h.shape[-1])), spec, tables, fft_n)
    return fft_core.irfft_batched(xs * hs, spec, tables, fft_n)


def _overlap_add(frames: torch.Tensor, hop: int, off: int, out_n: int) -> torch.Tensor:
    """(b, n_frames, frame) -> (b, out_n): frame i added at sample
    off + i*hop. Frame i's piece c (samples c*hop ... c*hop + hop, the last
    one zero-padded to hop) lands at off + (i + c)*hop: for one c the pieces
    of all frames tile a contiguous run, one shifted slice-add, and
    ceil(frame/hop) of them in a fixed order for any hop."""
    b, n_frames, frame = frames.shape
    phases = -(-frame // hop)
    y = frames.new_zeros(b, max(out_n, off + (n_frames + phases - 1) * hop))
    for c in range(phases):
        piece = frames[:, :, c * hop:(c + 1) * hop]
        if piece.shape[-1] < hop:
            piece = torch.nn.functional.pad(piece, (0, hop - piece.shape[-1]))
        s = off + c * hop
        y[:, s:s + n_frames * hop] += piece.reshape(b, -1)
    return y[:, :out_n]


def _stft_program(x: torch.Tensor, window: torch.Tensor, tables, hop: int, n_frames: int,
                  spec, fft_n: int, mode: str = 'complex', eps: float = 0.0,
                  start: int = 0) -> torch.Tensor:
    """(b, n) float -> (b, n_frames, fft_n//2+1): the complex spectrogram, its
    power or the log of its power plus ``eps`` (``mode``), frame i starting
    at sample start + i*hop, samples outside the signal read as zeros, times
    the analysis window, zero-padded to fft_n. One K12s launch where the
    frames' batched rfft rides K12r, else the plain passes around the
    batched rfft."""
    b = x.shape[0]
    if config.batched_engine('r2c', x.dtype, b * n_frames, fft_n) == 'base':
        out = base_fft.stft_base(x, start, n_frames, hop, window, *tables, mode, eps)
    else:
        out = base_fft.stft_plain(x, start, n_frames, hop, window, fft_n, mode, eps,
                                  lambda fx: fft_core.rfft_batched(fx, spec, tables, fft_n))
    return out.reshape(b, n_frames, -1)


def _istft_program(z: torch.Tensor, window: torch.Tensor, inv_wsq: torch.Tensor, tables,
                   frame: int, hop: int, n_frames: int, spec, fft_n: int,
                   out_n: int) -> torch.Tensor:
    """(b, n_frames, fft_n//2+1) complex -> (b, out_n) float: batched irfft,
    synthesis window, overlap-add, times the 1/sum(w^2) computed on the host
    (dsc_tpu/models/stft.py:168-199)."""
    b = z.shape[0]
    y = fft_core.irfft_batched(z.reshape(b * n_frames, -1), spec, tables, fft_n)[:, :frame]
    frames = y.reshape(b, n_frames, frame) * window
    return _overlap_add(frames, hop, 0, out_n) * inv_wsq


class STFT:
    """Short-time Fourier transform producing (log-)power spectrograms."""

    def __init__(self, frame: int = 1024, hop: int = 256, window='hann', log: bool = True,
                 log_eps: float = 1e-10, mode: Optional[str] = None):
        """``mode``: 'log' (default), 'power', or 'complex' (the raw
        spectrogram, invertible with :class:`ISTFT`). ``log=False`` is a
        shorthand for mode='power'."""
        self.frame = frame
        self.hop = hop
        self.fft_n = fft_plan.next_pow2(frame)
        if mode is None:
            mode = 'log' if log else 'power'
        if mode not in ('log', 'power', 'complex'):
            raise RuntimeError(f'unknown STFT mode {mode!r}')
        self.mode = mode
        self.log_eps = log_eps if mode == 'log' else None
        self._window = _device_array(_make_window(window, frame))
        self._windows: dict = {}

    def __call__(self, x: Tensor) -> Tensor:
        """x: (n,) or (batch, n) float32 -> (n_frames, fft_n//2+1) float32
        (log-)power (with a leading batch dim for batched input), or the
        complex64 spectrogram in mode='complex'."""
        if x.n_dim > 2:
            raise RuntimeError(f'expected a 1-D or 2-D signal, got {x.n_dim}-D')
        batched = x.n_dim == 2
        n = x.shape[-1]
        if n < self.frame:
            raise RuntimeError(f'signal ({n}) shorter than frame ({self.frame})')
        fft_n = self.fft_n
        n_frames = 1 + (n - self.frame) // self.hop
        data = x.torch if batched else x.torch[None, :]
        with tracing.trace_op('stft', 'op;pipeline', tracing.tensor_args(x=x)):
            spec, tables = fft_plan.get_plan(fft_n, 'real', torch.complex64)
            window = _placed(self._windows, self._window, data.device)
            out = _stft_program(data, window, tables, self.hop, n_frames, spec, fft_n,
                                self.mode, self.log_eps or 0.0)
            res = Tensor._from_torch(out if batched else out[0])
        return res


def spectrogram(x: Tensor, frame: int = 1024, hop: int = 256, **kw) -> Tensor:
    return STFT(frame=frame, hop=hop, **kw)(x)


class ISTFT:
    """Inverse STFT: the signal from a mode='complex' spectrogram by
    windowed overlap-add.

    Uses the analysis window for synthesis (weighted least squares: each
    sample is sum(w * frame) / sum(w^2)), so ``ISTFT(...)(STFT(...,
    mode='complex')(x))`` reproduces ``x`` wherever the window coverage is
    nonzero: for a hann window everywhere but the first and last samples.
    """

    def __init__(self, frame: int = 1024, hop: int = 256, window='hann'):
        self.frame = frame
        self.hop = hop
        self.fft_n = fft_plan.next_pow2(frame)
        self._window_np = _make_window(window, frame)
        self._window = _device_array(self._window_np)
        self._windows: dict = {}
        self._inv_wsq_cache: dict = {}

    def _inv_wsq(self, n_frames: int, span: int, like: torch.Tensor) -> torch.Tensor:
        """1 / sum of squared windows at each output sample: it depends only
        on (window, hop, n_frames), so it is computed on the host in
        float64, once per spectrogram length and device (``like``'s)."""
        got = self._inv_wsq_cache.get((n_frames, like.device))
        if got is None:
            w2 = self._window_np.astype(np.float64) ** 2
            wsq = np.zeros(span, np.float64)
            for i in range(0, n_frames * self.hop, self.hop):
                wsq[i:i + self.frame] += w2
            tiny = float(np.finfo(np.float32).tiny)
            got = _device_array((1.0 / np.maximum(wsq, tiny)).astype(np.float32), like)
            self._inv_wsq_cache[(n_frames, like.device)] = got
        return got

    def __call__(self, z: Tensor, length: Optional[int] = None) -> Tensor:
        """z: (n_frames, fft_n//2+1) complex64 (or with a leading batch dim)
        -> (length,) / (batch, length) float32 signal. ``length`` defaults
        to the full span (n_frames-1)*hop + frame."""
        if z.n_dim not in (2, 3):
            raise RuntimeError(f'expected a 2-D or 3-D spectrogram, got {z.n_dim}-D')
        batched = z.n_dim == 3
        n_frames, n_freq = z.shape[-2], z.shape[-1]
        if n_freq != self.fft_n // 2 + 1:
            raise RuntimeError(
                f'spectrogram has {n_freq} bins, expected {self.fft_n // 2 + 1}')
        frame, hop = self.frame, self.hop
        span = (n_frames - 1) * hop + frame
        length = span if length is None else length
        if length > span:
            raise RuntimeError(f'length {length} exceeds the frame span {span}')
        spec, tables = fft_plan.get_plan(self.fft_n, 'real', torch.complex64)
        data = z.torch.to(torch.complex64)
        if not batched:
            data = data[None]
        inv_wsq = self._inv_wsq(n_frames, span, data)
        with tracing.trace_op('istft', 'op;pipeline', tracing.tensor_args(z=z)):
            window = _placed(self._windows, self._window, data.device)
            out = _istft_program(data, window, inv_wsq, tables, frame, hop, n_frames,
                                 spec, self.fft_n, span)[:, :length]
            res = Tensor._from_torch(out if batched else out[0])
        return res
