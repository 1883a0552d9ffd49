"""The flagship step of the port (__graft_entry__.entry of the JAX
package): the README filterFFT pipeline at 2^20 samples and 4097 Blackman
taps (BASELINE.json config 1), n = 2^21, as one ``dsc.compile`` program.

    fn, args = entry()
    out = fn(*args)     # (2^20 + 4096,) float32

The step takes the signal and the taps and computes both spectra, the
product and the inverse, as the JAX entry's step does; on a CUDA context
its calls replay one captured graph of K1-K4 (twice K1+K2, K5, K3+K4).
It runs on the context's device: the card unless ``init(device='cpu')``.
"""

from __future__ import annotations

import numpy as np

from .fourier import irfft, rfft
from .fourier.plan import next_pow2
from .fuse import compile as _compile
from .tensor import Tensor, from_numpy, mul


def entry(n: int = 2**20, taps: int = 4097):
    """(fn, example_args): the compiled filterFFT step over ``n`` samples
    and ``taps`` Blackman taps, and its arguments (a seeded normal signal,
    the taps)."""
    fft_n = next_pow2(n + taps - 1)
    out_len = n + taps - 1

    @_compile
    def filter_fft_step(signal: Tensor, kernel: Tensor) -> Tensor:
        spec = mul(rfft(signal, n=fft_n), rfft(kernel, n=fft_n))
        return irfft(spec)[:out_len]

    sig = from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    ker = from_numpy(np.blackman(taps).astype(np.float32))
    return filter_fft_step, (sig, ker)
