"""FFT-based convolution (dsc_tpu/models/filter_fft.py; the reference
README's filterFFT example, README.md:110-137):
out = irfft(rfft(signal) * rfft(taps))[:n+taps-1].

``FilterFFT`` (the cached-spectrum streaming filter) comes with the fusion
tier (dsc_tpu/fuse.py), which is not ported yet.
"""

from __future__ import annotations

from ..fourier import irfft, rfft
from ..fourier.plan import next_pow2
from ..tensor import Tensor, mul


def fft_convolve(signal: Tensor, taps: Tensor, mode: str = 'full') -> Tensor:
    """1-D convolution via the frequency domain (np.convolve semantics,
    modes 'full'/'same'/'valid'). ``signal`` may be (n,) or batched
    (b, n) with 1-D ``taps``."""
    n = signal.shape[-1]
    k = taps.shape[-1]
    out_len = n + k - 1
    fft_n = next_pow2(out_len)
    conv = irfft(mul(rfft(signal, n=fft_n), rfft(taps, n=fft_n)))
    batched = signal.n_dim == 2

    def crop(lo, hi):
        return conv[:, lo:hi] if batched else conv[lo:hi]

    if mode == 'full':
        return crop(0, out_len)
    if mode == 'same':
        start = (k - 1) // 2
        return crop(start, start + n)
    if mode == 'valid':
        return crop(min(n, k) - 1, max(n, k))
    raise RuntimeError(f'unknown convolution mode {mode!r}')
