"""Fast Griffin-Lim phase reconstruction (Perraudin, Balazs & Søndergaard,
"A fast Griffin-Lim algorithm", 2013; librosa.griffinlim and
torchaudio.transforms.GriffinLim): audio whose STFT magnitude is a given
spectrogram, found by alternating projections on the STFT/ISTFT path of
stft.py.

Each iteration runs the inverse STFT of S * angles (``_istft_program``: the
batched irfft, K12ir, then the synthesis window and the overlap-add), the
forward STFT of that audio (``_stft_program``: K12s, which frames the
cropped audio with the centre's zeros, windows it and transforms it in one
launch), then the momentum step and the projection back onto the
magnitudes, as plain passes on the device. The iterations
share one plan, one device window and one 1/sum(w^2) table, and the loop
makes no host synchronisation and no upload.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import tracing
from ..fourier import plan as fft_plan
from ..tensor import Tensor
from .stft import ISTFT, _istft_program, _placed, _stft_program


class GriffinLim:
    """Fast Griffin-Lim: float32 audio from an STFT magnitude spectrogram.

    Each of ``n_iter`` iterations takes ``x = ISTFT(S * angles)``,
    ``rebuilt = STFT(x)``, ``angles = rebuilt - momentum / (1 + momentum) *
    previous rebuilt`` and ``angles /= |angles| + eps``; a last ISTFT gives
    the answer. ``momentum=0`` is plain Griffin-Lim. The STFT is that of
    :class:`STFT` (frames of ``frame`` samples every ``hop``, zero-padded to
    a power of two) with ``window`` for analysis and synthesis; ``center``
    pads ``frame // 2`` zeros at each end of the signal before framing (as
    librosa's ``pad_mode='constant'``), and the inverse drops them.
    """

    def __init__(self, frame: int = 1024, hop: int = 256, window='hann', n_iter: int = 32,
                 momentum: float = 0.99, center: bool = True, eps: float = 1e-16):
        if n_iter < 0:
            raise RuntimeError(f'n_iter must be >= 0, got {n_iter}')
        if momentum < 0:
            raise RuntimeError(f'momentum must be >= 0, got {momentum}')
        if not eps > 0:
            raise RuntimeError(f'eps must be > 0, got {eps}')
        self.frame = frame
        self.hop = hop
        self.fft_n = fft_plan.next_pow2(frame)
        self.n_iter = int(n_iter)
        self.momentum = float(momentum)
        self.center = bool(center)
        self.eps = float(eps)
        self._pad = frame // 2 if center else 0
        # the window on the device and the 1/sum(w^2) tables, shared with the inverse
        self._istft = ISTFT(frame, hop, window)

    def __call__(self, S: Tensor, length: Optional[int] = None,
                 angles: Optional[Tensor] = None) -> Tensor:
        """S: (n_frames, fft_n//2+1) float32 magnitudes (or with a leading
        batch dim) -> (length,) / (batch, length) float32 audio. ``length``
        defaults to (n_frames-1)*hop + frame less the centre padding; the
        STFT of ``length`` samples has to give n_frames frames. ``angles``:
        complex64 unit phasors of S's shape, the initial phase; None draws
        a uniform random phase on the device."""
        if S.n_dim not in (2, 3):
            raise RuntimeError(f'expected 2-D or 3-D magnitudes, got {S.n_dim}-D')
        batched = S.n_dim == 3
        n_frames, n_freq = S.shape[-2], S.shape[-1]
        if n_freq != self.fft_n // 2 + 1:
            raise RuntimeError(f'spectrogram has {n_freq} bins, expected {self.fft_n // 2 + 1}')
        if angles is not None and tuple(angles.shape) != tuple(S.shape):
            raise RuntimeError(f'angles have shape {tuple(angles.shape)}, '
                               f'the magnitudes {tuple(S.shape)}')
        frame, hop, fft_n, pad = self.frame, self.hop, self.fft_n, self._pad
        span = (n_frames - 1) * hop + frame
        length = span - 2 * pad if length is None else int(length)
        if length + pad > span or 1 + (length + 2 * pad - frame) // hop != n_frames:
            raise RuntimeError(f'length {length} does not fit {n_frames} frames of {frame} '
                               f'every {hop}')
        mags = S.torch.to(torch.float32)
        if not batched:
            mags = mags[None]
        spec, tables = fft_plan.get_plan(fft_n, 'real', torch.complex64)
        ist = self._istft
        inv_wsq = ist._inv_wsq(n_frames, span, mags)
        window = _placed(ist._windows, ist._window, mags.device)

        def inverse(z):
            y = _istft_program(z, window, inv_wsq, tables, frame, hop, n_frames, spec, fft_n,
                               span)
            if not pad:
                return y[:, :length]
            with tracing.trace_op('center', 'plain;pipeline'):
                return y[:, pad:pad + length]

        def forward(x):
            # frame i starts at sample i*hop - pad of the cropped view: K12s reads
            # zeros outside it, the plain passes pad it under the center span
            return _stft_program(x, window, tables, hop, n_frames, spec, fft_n, start=-pad)

        with tracing.trace_op('griffin_lim', 'op;pipeline',
                              tracing.tensor_args(S=S, angles=angles)):
            with tracing.trace_op('init', 'plain;pipeline'):
                if angles is None:
                    phase = torch.rand(mags.shape, device=mags.device) * (2 * math.pi)
                    z = torch.polar(mags, phase)
                else:
                    a = angles.torch.to(torch.complex64)
                    z = mags * (a if batched else a[None])
                # the inverse reads bins 0 and fft_n/2 as real, as numpy's irfft and
                # torch.istft do; the batched irfft would fold their imaginary parts in.
                # Every later spectrum is an rfft's, real there already.
                torch.view_as_real(z)[..., ::n_freq - 1, 1] = 0
            c = self.momentum / (1 + self.momentum)
            prev = None
            for _ in range(self.n_iter):
                rebuilt = forward(inverse(z))
                a = rebuilt
                if prev is not None and c:
                    with tracing.trace_op('momentum', 'plain;pipeline'):
                        a = torch.sub(rebuilt, prev, alpha=c)
                with tracing.trace_op('project', 'plain;pipeline'):
                    z = a * (mags / (a.abs() + self.eps))
                prev = rebuilt
            out = inverse(z)
            res = Tensor._from_torch(out if batched else out[0])
        return res
