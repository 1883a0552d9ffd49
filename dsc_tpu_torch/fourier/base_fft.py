"""Base-case FFT kernel K12 (dsc_tpu/fourier/pallas_kernels.py).

Replaces ``_fft_block_kernel`` (pallas_kernels.py:55, called through
``fft_base_planar``): a batched forward DFT of 256..4096-point complex64
rows, the leaf of the four-step plan (core.fft_apply). The TPU kernel runs
each row as two DFT-matrix products on the MXU; the Hopper kernel
(csrc/base_fft.cu) runs an in-shared-memory radix-2 FFT per row
(csrc/fft_core.cuh).
"""

from __future__ import annotations

import torch

from ..kernels import build
from .config import BASE_KERNEL_MAX_N, BASE_KERNEL_MIN_N
from .core import stockham_fft


def fft_base_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: forward DFT of each row of ``x`` (B, n) with
    the plan's stage table ``w`` (n/2 entries)."""
    return stockham_fft(x, w)


def fft_base(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K12 on a CUDA tensor, its plain version on a CPU tensor."""
    b, n = x.shape
    if x.device.type == 'cpu':
        return fft_base_plain(x, w)
    if n & (n - 1) or not BASE_KERNEL_MIN_N <= n <= BASE_KERNEL_MAX_N:
        raise RuntimeError(f'base_fft: n={n} is not a power of two in '
                           f'[{BASE_KERNEL_MIN_N}, {BASE_KERNEL_MAX_N}]')
    build.check(x, torch.complex64, (b, n), 'x')
    build.check(w, torch.complex64, (n // 2,), 'w')
    y = torch.empty_like(x)
    if b:  # a grid of no blocks is refused at launch
        build.launch('base_fft', x.data_ptr(), y.data_ptr(), b, n, w.data_ptr())
    return y
