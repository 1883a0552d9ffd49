"""Base-case FFT kernel K12 (dsc_tpu/fourier/pallas_kernels.py).

Replaces ``_fft_block_kernel`` (pallas_kernels.py:55, called through
``fft_base_planar``): a batched forward DFT of 256..4096-point complex64
rows, the leaf of the four-step plan (core.fft_apply). The TPU kernel runs
each row as two DFT-matrix products on the MXU; the Hopper kernel
(csrc/base_fft.cu) runs each row through the register-resident radix-16
row pass of csrc/fft_rows_reg.cuh, R rows a block.

K12r (``rfft_base``, csrc/base_fft.cu base_rfft_kernel) is the batched real
FFT of float32 rows whose half-size transform is a K12 base case: K12's row
pass on the packed rows with the untangle (core.untangle) folded into its
store, so the half-size spectrum never reaches device memory.

K12ir (``irfft_base``, base_irfft_kernel) is its mirror, the batched inverse
real FFT of complex64 half spectra whose half-size transform is a K12 base
case: the entangle (core.entangle) folded into the row's load, K12's
unscaled inverse row pass and the 1/nh scale in its store.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build
from .config import BASE_KERNEL_MAX_N, BASE_KERNEL_MIN_N
from .core import entangle, stockham_fft, untangle

# K12 takes R rows of n points a block; the launcher derives the rest
# (R*n/16 threads, at most 1024, and R padded rows of shared memory) from R.
# ROWS[n] is the R of the fastest block size that chip_smoke.py --profile
# timed (4096, 8192 and 16384 points a block, over 2^24 values and over
# 1000 rows; PERF.md): 4096 points up to n = 2048, 8192 at 4096 (ahead at
# 1000 rows, 2.5% behind over 2^24 values).
ROWS = {256: 16, 512: 8, 1024: 4, 2048: 2, 4096: 2}
MIN_BLOCKS = 264      # R halves until the grid has two blocks a SM (132 SMs)


_SIZES = f'a power of two in [{BASE_KERNEL_MIN_N}, {BASE_KERNEL_MAX_N}]'  # K12's rows


def _takes(n: int) -> bool:
    return not n & (n - 1) and BASE_KERNEL_MIN_N <= n <= BASE_KERNEL_MAX_N


@functools.lru_cache(maxsize=None)
def block_rows(n: int, batch: int) -> int:
    """R, the rows a block of K12 over ``batch`` n-point rows: ROWS, halved
    until the grid has MIN_BLOCKS blocks (or R is 1)."""
    if n not in ROWS:
        raise ValueError(f'base_fft: n = {n} not supported')
    r = ROWS[n]
    while r > 1 and -(-batch // r) < MIN_BLOCKS:
        r //= 2
    return r


def fft_base_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: forward DFT of each row of ``x`` (B, n) with
    the plan's stage table ``w`` (n/2 entries)."""
    return stockham_fft(x, w)


def fft_base(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K12 on a CUDA tensor, its plain version on a CPU tensor."""
    b, n = x.shape
    if x.device.type == 'cpu':
        return fft_base_plain(x, w)
    if not _takes(n):
        raise RuntimeError(f'base_fft: n={n} is not {_SIZES}')
    return _launch(x, w, block_rows(n, b))


def _launch(x: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    """K12 with ``rows`` rows a block."""
    b, n = x.shape
    build.check(x, torch.complex64, (b, n), 'x')
    build.check(w, torch.complex64, (n // 2,), 'w')
    y = torch.empty_like(x)
    if b:  # a grid of no blocks is refused at launch
        build.launch('base_fft', x.data_ptr(), y.data_ptr(), b, n, w.data_ptr(), rows)
    return y


def rfft_base_plain(x: torch.Tensor, w: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """Plain version of K12r: the real spectrum (B, n/2 + 1) of each row of
    ``x`` (B, n), from the half-size transform of the packed rows z[t] =
    x[2t] + i*x[2t+1] (K12's plain version, with the n/2-point stage table
    ``w``) and the untangle with ``wu`` (n/2 + 1 entries W_n^k)."""
    b, n = x.shape
    z = torch.view_as_complex(x.contiguous().reshape(b, n // 2, 2))
    return untangle(fft_base_plain(z, w), wu)


def rfft_base(x: torch.Tensor, w: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """K12r on a CUDA tensor, its plain version on a CPU tensor."""
    b, n = x.shape
    if x.device.type == 'cpu':
        return rfft_base_plain(x, w, wu)
    if n % 2 or not _takes(n // 2):
        raise RuntimeError(f'base_rfft: n={n} is not twice {_SIZES}')
    return _launch_rfft(x, w, wu, block_rows(n // 2, b))


def _launch_rfft(x: torch.Tensor, w: torch.Tensor, wu: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """K12r with ``rows`` rows a block."""
    b, n = x.shape
    nh = n // 2
    build.check(x, torch.float32, (b, n), 'x', align=8)  # read as float2
    build.check(w, torch.complex64, (nh // 2,), 'w')
    build.check(wu, torch.complex64, (nh + 1,), 'wu')
    y = torch.empty((b, nh + 1), dtype=torch.complex64, device=x.device)
    if b:  # a grid of no blocks is refused at launch
        build.launch('base_rfft', x.data_ptr(), y.data_ptr(), b, nh, w.data_ptr(),
                     wu.data_ptr(), rows)
    return y


def irfft_base_plain(x: torch.Tensor, w: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """Plain version of K12ir: the real rows (B, 2*nh) of the half spectra
    ``x`` (B, nh + 1), from the entangle with ``wu`` (nh + 1 entries W_n^k,
    read at k < nh), the inverse of K12's plain version with the nh/2-point
    stage table ``w`` as conj(fft(conj z)) / nh, and the complex rows read
    as float pairs y[2t] + i*y[2t+1] = z[t]."""
    b, nh = x.shape[0], x.shape[1] - 1
    z = entangle(x, wu[:nh])
    y = torch.conj_physical(fft_base_plain(torch.conj_physical(z), w)) / nh
    return torch.view_as_real(y.contiguous()).reshape(b, 2 * nh)


def irfft_base(x: torch.Tensor, w: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """K12ir on a CUDA tensor, its plain version on a CPU tensor. A lazy
    conjugate or negative bit of ``x`` is resolved, and the rows made
    contiguous, before the kernel reads them."""
    b, m = x.shape
    if x.device.type == 'cpu':
        return irfft_base_plain(x, w, wu)
    if not _takes(m - 1):
        raise RuntimeError(f'base_irfft: {m} bins are not one more than {_SIZES}')
    x = x.resolve_conj().resolve_neg().contiguous()
    return _launch_irfft(x, w, wu, block_rows(m - 1, b))


def _launch_irfft(x: torch.Tensor, w: torch.Tensor, wu: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """K12ir with ``rows`` rows a block."""
    b, m = x.shape
    nh = m - 1
    if x.is_conj() or x.is_neg():
        raise RuntimeError('x: expected no lazy conjugate or negative bit')
    build.check(x, torch.complex64, (b, nh + 1), 'x', align=8)  # rows of nh + 1 float2
    build.check(w, torch.complex64, (nh // 2,), 'w')
    build.check(wu, torch.complex64, (nh + 1,), 'wu')
    y = torch.empty((b, 2 * nh), dtype=torch.float32, device=x.device)
    if b:  # a grid of no blocks is refused at launch
        build.launch('base_irfft', x.data_ptr(), y.data_ptr(), b, nh, w.data_ptr(),
                     wu.data_ptr(), rows)
    return y
