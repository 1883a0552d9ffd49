"""Overlap-save block convolution: FIR-filter an arbitrarily long signal
with a bounded FFT size (dsc_tpu/models/ola.py).

The reference's filterFFT example (README.md:110-137) transforms the whole
signal at once, so its FFT grows with the input. Overlap-save splits the
signal into overlapping fft_n-sample blocks, runs one batched rfft, a
multiply by the kernel spectrum and one batched irfft over all of them,
and keeps the last hop = fft_n - (taps - 1) samples of each block. Every
block rides the batched FFT engine (fourier/core.py): at fft_n = 8192 the
half-size 4096-point transforms run the base-case kernel K12. The framing
is a strided view (``unfold``) of the zero-padded signal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..fourier import core as fft_core
from ..fourier import plan as fft_plan
from ..tensor import Tensor, from_numpy


class OverlapSave:
    """Streaming FIR filter over long signals with a fixed FFT size.

    ``OverlapSave(taps)(x)`` equals ``np.convolve(x, taps)`` (mode='full')
    for any signal length, with fft_n-point transforms whatever ``len(x)``,
    unlike ``fft_convolve`` whose transform grows with the signal. The
    kernel spectrum is computed once, at construction.
    """

    def __init__(self, taps, fft_n: Optional[int] = None):
        if isinstance(taps, np.ndarray):
            taps = from_numpy(taps)
        k = taps.shape[-1]
        if fft_n is None:
            # ~87% useful samples per block
            fft_n = max(fft_plan.next_pow2(8 * k), 256)
        if fft_n & (fft_n - 1):
            raise RuntimeError(f'fft_n must be a power of two, got {fft_n}')
        if fft_n < fft_plan.next_pow2(2 * k):
            raise RuntimeError(
                f'fft_n ({fft_n}) too small for {k} taps: need >= {fft_plan.next_pow2(2 * k)}')
        self.n_taps = k
        self.fft_n = fft_n
        self.hop = fft_n - (k - 1)
        # the plan itself, held: cache eviction cannot take it away
        self._spec, self._tables = fft_plan.get_plan(fft_n, 'real', torch.complex64)
        padded = torch.nn.functional.pad(taps.torch.to(torch.float32), (0, fft_n - k))
        self._kspec = fft_core.rfft_batched(padded.reshape(1, fft_n), self._spec,
                                            self._tables, fft_n)[0]

    def __call__(self, x: Tensor) -> Tensor:
        """x: (n,) or (batch, n) float32 -> (n + n_taps - 1,) float32 full
        convolution (with a leading batch dim for batched input)."""
        if x.n_dim not in (1, 2):
            raise RuntimeError(f'expected a 1-D or 2-D signal, got {x.n_dim}-D')
        batched = x.n_dim == 2
        n = x.shape[-1]
        k, fft_n, hop = self.n_taps, self.fft_n, self.hop
        out_len = n + k - 1
        n_blocks = -(-out_len // hop)
        data = x.torch.to(torch.float32)
        if not batched:
            data = data[None, :]
        with tracing.trace_op('overlap_save', 'op;pipeline', tracing.tensor_args(x=x)):
            b = data.shape[0]
            total = (n_blocks - 1) * hop + fft_n
            xp = torch.nn.functional.pad(data, (k - 1, total - n - (k - 1)))
            frames = xp.unfold(-1, fft_n, hop).reshape(b * n_blocks, fft_n)
            z = fft_core.rfft_batched(frames, self._spec, self._tables, fft_n)
            y = fft_core.irfft_batched(z * self._kspec, self._spec, self._tables, fft_n)
            out = y.reshape(b, n_blocks, fft_n)[:, :, k - 1:].reshape(b, -1)[:, :out_len]
            res = Tensor._from_torch(out if batched else out[0])
        return res


def overlap_save_convolve(signal: Tensor, taps: Tensor, fft_n: Optional[int] = None) -> Tensor:
    """One-shot ``np.convolve(signal, taps)`` via overlap-save blocks."""
    return OverlapSave(taps, fft_n=fft_n)(signal)
