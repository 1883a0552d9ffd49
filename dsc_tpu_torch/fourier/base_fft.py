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

K12s (``stft_base``, base_stft_kernel) is the whole forward STFT of float32
signals whose frames' rfft rides K12r: the framing, the zeros outside the
signal and the analysis window in K12r's load, and the complex spectrum,
its power or its log power in K12r's store. Its plain version
(``stft_base_plain``) is the STFT's plain passes (``stft_plain``) around
K12r's wrapper.
"""

from __future__ import annotations

import functools

import torch

from .. import tracing
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


# -- K12s: the forward STFT in one launch ---------------------------------

# what an STFT writes of each bin X[k]; the index is K12s's mode
STFT_MODES = ('complex', 'power', 'log')


def frame_dense(x: torch.Tensor, frame: int, hop: int, n_frames: int) -> torch.Tensor:
    """(b, n) -> (b, n_frames, frame) with frames[:, i, j] = x[:, i*hop + j],
    a strided view of x (dsc_tpu/models/stft.py:56-80); samples past the
    end of x read as zeros."""
    need = (n_frames - 1) * hop + frame
    if x.shape[-1] < need:
        with tracing.trace_op('frame_pad', 'plain;pipeline'):
            x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    return x.unfold(-1, frame, hop)[:, :n_frames]


def stft_plain(x: torch.Tensor, start: int, n_frames: int, hop: int, window: torch.Tensor,
               fft_n: int, mode: str, eps: float, rfft) -> torch.Tensor:
    """The forward STFT as plain passes: (b, n) signal rows -> (b*n_frames,
    fft_n/2 + 1), frame i of a row starting at sample start + i*hop, samples
    outside the row reading as zeros (a negative ``start`` pads zeros before
    it, the ``center`` span), times ``window`` (its length is the frame's),
    zero-padded to fft_n, through ``rfft`` (the batched rfft of the
    (b*n_frames, fft_n) rows); the complex spectrum, or its power, or the
    log of the power plus ``eps`` (``mode``)."""
    b, frame = x.shape[0], window.shape[0]
    if start > 0:
        x = x[:, start:]
    elif start < 0:  # zeros before the signal, and after it as far as the frames reach
        tail = (n_frames - 1) * hop + frame + start - x.shape[-1]
        with tracing.trace_op('center', 'plain;pipeline'):
            x = torch.nn.functional.pad(x, (-start, max(0, tail)))
    frames = frame_dense(x, frame, hop, n_frames)
    with tracing.trace_op('window', 'plain;pipeline'):
        fx = (frames * window).reshape(b * n_frames, frame)
    if frame != fft_n:  # a frame that is not a power of two: zero-padded
        with tracing.trace_op('pad', 'plain;pipeline'):
            fx = torch.nn.functional.pad(fx, (0, fft_n - frame))
    z = rfft(fx)
    if mode == 'complex':
        return z
    with tracing.trace_op('power', 'plain;pipeline'):
        out = z.real * z.real + z.imag * z.imag
    if mode == 'power':
        return out
    with tracing.trace_op('log', 'plain;pipeline'):
        return torch.log(out + eps)


def stft_base_plain(x: torch.Tensor, start: int, n_frames: int, hop: int, window: torch.Tensor,
                    w: torch.Tensor, wu: torch.Tensor, mode: str = 'complex',
                    eps: float = 0.0) -> torch.Tensor:
    """Plain version of K12s: ``stft_plain`` with K12r's wrapper as the
    frames' rfft (its plain version on a CPU tensor), at n = 2*(len(wu) - 1)
    points with the tables ``w`` and ``wu`` of K12r."""
    return stft_plain(x, start, n_frames, hop, window, 2 * (wu.shape[0] - 1), mode, eps,
                      lambda fx: rfft_base(fx.contiguous(), w, wu))


def stft_base(x: torch.Tensor, start: int, n_frames: int, hop: int, window: torch.Tensor,
              w: torch.Tensor, wu: torch.Tensor, mode: str = 'complex',
              eps: float = 0.0) -> torch.Tensor:
    """K12s on a CUDA tensor, its plain version on a CPU tensor: the
    (b*n_frames, nh + 1) STFT of the float32 rows of ``x`` (b, valid), frame
    i of a row starting at sample start + i*hop, complex64 or, in mode
    'power' or 'log', float32. The rows may lie any distance apart; their
    samples are made contiguous if they are not."""
    if x.device.type == 'cpu':
        return stft_base_plain(x, start, n_frames, hop, window, w, wu, mode, eps)
    nh = wu.shape[0] - 1
    if not _takes(nh):
        raise RuntimeError(f'base_stft: {nh + 1} untangle twiddles are not one more than {_SIZES}')
    if x.stride(-1) != 1:
        x = x.contiguous()
    return _launch_stft(x, start, n_frames, hop, window, w, wu, mode, eps,
                        block_rows(nh, x.shape[0] * n_frames))


def _launch_stft(x: torch.Tensor, start: int, n_frames: int, hop: int, window: torch.Tensor,
                 w: torch.Tensor, wu: torch.Tensor, mode: str, eps: float,
                 rows: int) -> torch.Tensor:
    """K12s with ``rows`` rows a block."""
    b, valid = x.shape
    nh, frame = wu.shape[0] - 1, window.shape[0]
    if mode not in STFT_MODES:
        raise RuntimeError(f'base_stft: unknown mode {mode!r}')
    if not (0 < frame <= 2 * nh and hop > 0 and n_frames >= 0):
        raise RuntimeError(f'base_stft: frame {frame}, hop {hop}, {n_frames} frames '
                           f'at {2 * nh} points')
    if not x.is_cuda or x.dtype != torch.float32 or x.stride(-1) != 1:
        raise RuntimeError(f'x: expected CUDA float32 rows of contiguous samples, got '
                           f'{x.dtype} on {x.device} with strides {x.stride()}')
    build.check(window, torch.float32, (frame,), 'window', align=8)  # read as float2
    build.check(w, torch.complex64, (nh // 2,), 'w')
    build.check(wu, torch.complex64, (nh + 1,), 'wu')
    dtype = torch.complex64 if mode == 'complex' else torch.float32
    y = torch.empty((b * n_frames, nh + 1), dtype=dtype, device=x.device)
    if b * n_frames:  # a grid of no blocks is refused at launch
        # one signal row: its stride is never stepped over
        stride = x.stride(0) if b > 1 else 0
        build.launch('base_stft', x.data_ptr(), y.data_ptr(), b * n_frames, n_frames, stride,
                     start, valid, hop, frame, nh, window.data_ptr(), w.data_ptr(),
                     wu.data_ptr(), STFT_MODES.index(mode), eps, rows)
    return y
