"""Packed half-size real FFT: kernels K1-K4 (dsc_tpu/fourier/packed_fused.py).

rfft of n = n1*n2 real samples as ONE complex FFT of nh = n/2 points:
z[t] = x[2t] + i*x[2t+1] (on the card a float2 load *is* this packing),
a four-step FFT of z viewed as (n1, m2), m2 = n2/2, and the hermitian
untangle

    X[k] = (Z[k] + conj Z[nh-k])/2 - i*W_n^k*(Z[k] - conj Z[nh-k])/2,

k = 0..nh (Z[nh] = Z[0]). The inverse entangles
Z[k] = (X[k] + conj X[nh-k])/2 + i*W_n^-k*(X[k] - conj X[nh-k])/2, runs
the inverse four-step, and its complex output read as floats is the real
signal: even samples in the real parts, odd samples in the imaginary ones.

Four kernels, each a pass over device memory (csrc/packed_rfft.cu):

  K1 rfft_phase_a    column DFT_n1 of z + four-step twiddle W_nh^(k1*j2)
                     -> At (n1, m2), row k1 contiguous; x may be shorter
                     than n: the samples past its end count as zeros
  K2 rfft_phase_b    row DFT_m2 of At (Z[k1 + n1*k2] = Z_T[k1, k2]) +
                     untangle -> natural (nh+1,) spectrum
  K3 irfft_phase_a   entangle (of the real parts of X[0] and X[nh], as
                     np.fft.irfft) + inverse row DFT_m2 + twiddle
                     W_nh^-(k1*j2) -> Y (n1, m2)
  K4 irfft_phase_b   inverse column DFT_n1, 1/nh scale -> (n,) real

K1 and K4 are the column pass that the streaming kernels share
(csrc/stream_columns.cuh: batch 1, L = n1, M = m2), C columns a block from
``stream.block_columns(n1, m2, 1, 8)``. K1 reads the signal unpadded and
zeros what lies past its end as it loads, so the filterFFT's zero padding
is never written to device memory; K4 stores in place, scaled by 1/nh. K2
and K3 run the register-resident row pass (csrc/fft_rows_reg.cuh), P row
pairs a block from ``block_pairs``.

The mirror operand of the untangle, Z[nh-k] = Z_T[n1-k1, m2-1-k2] (and
Z_T[0, (m2-k2) mod m2] for k1 = 0), lies in row n1-k1, so the phase-B
kernels give each block the rows k1 and n1-k1 together. The TPU engine's
boundary-row DFT and k1 = 0 fix rows (packed_fused.py:856-883, :913-921)
exist because a TPU tile pair cannot see rows across 128-row tiles; they
have no counterpart here. The spectrum is in natural order, not the TPU's
half-T layout.

Each kernel has a plain PyTorch version (``*_plain``) with the same inputs
and outputs. The wrappers launch the kernel for CUDA tensors and run the
plain version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from . import stream
from .core import entangle, stockham_fft, untangle
from .plan import PackedTables


def supported(n1: int, n2: int) -> bool:
    """The split the packed engine takes (dsc_tpu packed_fused.py:952-963):
    the inner (n1, n2/2) split is streaming-legal, n1 a multiple of 512
    and n2/2 of 256."""
    m2 = n2 // 2
    return (stream.supported(n1, m2, np.complex64)
            and n1 % (4 * stream.LANES) == 0
            and m2 % (2 * stream.LANES) == 0)


def _sizes(t: PackedTables):
    n1, m2 = 2 * t.w_n1.shape[0], 2 * t.w_m2.shape[0]
    return n1, m2, n1 * m2


# K2 and K3 take P row pairs a block (rows k, their mirrors n1 - k); the
# launcher derives the rest (2P*m2/16 threads, at most 1024, and 2P padded
# rows of shared memory) from P. PAIRS[m2] (K2) and INV_PAIRS[m2] (K3) are
# the P of the fastest block shape that chip_smoke.py --profile timed
# (PERF.md). K2 stores the spectrum in runs of P values, and at P = 2
# (16-byte runs) took 1.8-2.1x as long as at P = 4, so P >= 4 (32 bytes)
# wherever 1024 threads allow it (not at m2 = 4096); at m2 = 512 every P
# took the same host-bound time, and P = 4 keeps n1/(2P) >= 128 blocks at
# the smallest split, n1 = 1024. K3 loads the spectrum in the same runs,
# but loads of 16-byte runs cost it less: P = 2 took 7-8% less time than
# P = 4 at m2 = 2048 (2^24, 2^25); at m2 = 1024 P = 4 was within 2% of the
# fastest at 2^23 in two runs (2^22 and m2 = 512 read the host's time).
PAIRS = {512: 4, 1024: 8, 2048: 4, 4096: 2}
INV_PAIRS = {512: 4, 1024: 4, 2048: 2, 4096: 2}


def block_pairs(m2: int, inverse: bool = False) -> int:
    """P, the row pairs a block of K2 (K3 with ``inverse``) over rows of m2
    points."""
    table = INV_PAIRS if inverse else PAIRS
    if m2 not in table:
        raise ValueError(f'{"irfft_phase_a" if inverse else "rfft_phase_b"}: '
                         f'm2 = {m2} not supported')
    return table[m2]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _check_signal(x: torch.Tensor, nh: int) -> None:
    if x.dim() != 1 or not 1 <= x.numel() <= 2 * nh:
        raise RuntimeError(f'rfft_phase_a: x must hold 1 ... {2 * nh} samples, '
                           f'got shape {tuple(x.shape)}')


def rfft_phase_a_plain(x: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """K1: (valid,) f32, 1 <= valid <= n, zero-padded to n -> At (n1, m2)
    c64, At[k1, j2] = W_nh^(k1*j2) * sum_j1 z[j1*m2 + j2] W_n1^(j1*k1).
    The kernel reads the same unpadded x and takes the samples past its end
    as zeros: the same function."""
    n1, m2, nh = _sizes(t)
    _check_signal(x, nh)
    x = torch.nn.functional.pad(x, (0, 2 * nh - x.numel()))
    z = torch.view_as_complex(x.reshape(n1, m2, 2))
    a = stockham_fft(z.transpose(0, 1).contiguous(), t.w_n1)   # (m2, n1)
    dev = x.device
    e = torch.arange(m2, device=dev)[:, None] * torch.arange(n1, device=dev)[None, :]
    return (a * t.twiddle.at(e)).transpose(0, 1).contiguous()


def rfft_phase_b_plain(at: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """K2: At (n1, m2) -> the natural (nh+1,) c64 rfft spectrum."""
    _, _, nh = _sizes(t)
    z = stockham_fft(at, t.w_m2).transpose(0, 1).reshape(-1)  # Z[k1 + n1*k2]
    return untangle(z, t.untangle.at(torch.arange(nh + 1, device=at.device)))


def irfft_phase_a_plain(spec: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """K3: natural (nh+1,) c64 spectrum -> Y (n1, m2) c64. As np.fft.irfft,
    it reads only the real parts of X[0] and X[nh]."""
    n1, m2, nh = _sizes(t)
    dev = spec.device
    spec = spec.clone()
    spec.imag[[0, nh]] = 0
    z = entangle(spec, t.untangle.at(torch.arange(nh, device=dev)))
    zt = z.reshape(m2, n1).transpose(0, 1).contiguous()         # Z_T[k1, k2]
    y = stockham_fft(zt, t.w_m2.conj())
    e = torch.arange(n1, device=dev)[:, None] * torch.arange(m2, device=dev)[None, :]
    return y * t.twiddle.at(e).conj()


def irfft_phase_b_plain(y: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """K4: Y (n1, m2) c64 -> (n,) f32, x[2t] + i*x[2t+1] = z[t] =
    (1/nh) * sum_k1 Y[k1, t % m2] W_n1^-(k1 * (t // m2))."""
    _, _, nh = _sizes(t)
    c = stockham_fft(y.transpose(0, 1).contiguous(), t.w_n1.conj())  # (m2, n1)
    z = c.transpose(0, 1).contiguous() * (1.0 / nh)
    return torch.view_as_real(z).reshape(-1)


def rfft_packed_plain(x: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """Plain version of K1+K2: (valid,) f32, zero-padded to n -> (n/2+1,)
    c64."""
    return rfft_phase_b_plain(rfft_phase_a_plain(x, t), t)


def irfft_packed_plain(spec: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """Plain version of K3+K4: (n/2+1,) c64 -> (n,) f32."""
    return irfft_phase_b_plain(irfft_phase_a_plain(spec, t), t)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_tables(t: PackedTables) -> None:
    for name, tab in (('w_n1', t.w_n1), ('w_m2', t.w_m2),
                      ('twiddle.lo', t.twiddle.lo), ('twiddle.hi', t.twiddle.hi),
                      ('untangle.lo', t.untangle.lo),
                      ('untangle.hi', t.untangle.hi)):
        build.check(tab, torch.complex64, tab.shape, name)


def rfft_phase_a(x: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor. ``x``: 1 ... n
    float32 samples; those past its end count as zeros."""
    if x.device.type == 'cpu':
        return rfft_phase_a_plain(x, t)
    n1, m2, _ = _sizes(t)
    return _launch_phase_a(x, t, stream.block_columns(n1, m2, 1, 8))


def _launch_phase_a(x: torch.Tensor, t: PackedTables, columns: int) -> torch.Tensor:
    """K1 with ``columns`` columns a block. The kernel's float2 loads need
    8-byte aligned data, which a sliced view may lack: ``build.aligned``
    copies such a view."""
    n1, m2, nh = _sizes(t)
    _check_signal(x, nh)
    x = build.aligned(x)
    build.check(x, torch.float32, (x.numel(),), 'x')
    _check_tables(t)
    at = torch.empty((n1, m2), dtype=torch.complex64, device=x.device)
    build.launch('rfft_phase_a', x.data_ptr(), at.data_ptr(), x.numel(), n1, m2,
                 t.w_n1.data_ptr(), t.twiddle.lo.data_ptr(),
                 t.twiddle.hi.data_ptr(), t.twiddle.bits, columns)
    return at


def rfft_phase_b(at: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if at.device.type == 'cpu':
        return rfft_phase_b_plain(at, t)
    return _launch_phase_b(at, t, block_pairs(_sizes(t)[1]))


def _launch_phase_b(at: torch.Tensor, t: PackedTables, pairs: int) -> torch.Tensor:
    """K2 with ``pairs`` row pairs a block."""
    n1, m2, nh = _sizes(t)
    build.check(at, torch.complex64, (n1, m2), 'at')
    _check_tables(t)
    spec = torch.empty(nh + 1, dtype=torch.complex64, device=at.device)
    build.launch('rfft_phase_b', at.data_ptr(), spec.data_ptr(), n1, m2,
                 t.w_m2.data_ptr(), t.untangle.lo.data_ptr(),
                 t.untangle.hi.data_ptr(), t.untangle.bits, pairs)
    return spec


def irfft_phase_a(spec: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if spec.device.type == 'cpu':
        return irfft_phase_a_plain(spec, t)
    return _launch_inv_phase_a(spec, t, block_pairs(_sizes(t)[1], inverse=True))


def _launch_inv_phase_a(spec: torch.Tensor, t: PackedTables, pairs: int) -> torch.Tensor:
    """K3 with ``pairs`` row pairs a block."""
    n1, m2, nh = _sizes(t)
    build.check(spec, torch.complex64, (nh + 1,), 'spec')
    _check_tables(t)
    y = torch.empty((n1, m2), dtype=torch.complex64, device=spec.device)
    build.launch('irfft_phase_a', spec.data_ptr(), y.data_ptr(), n1, m2,
                 t.w_m2.data_ptr(), t.untangle.lo.data_ptr(),
                 t.untangle.hi.data_ptr(), t.untangle.bits,
                 t.twiddle.lo.data_ptr(), t.twiddle.hi.data_ptr(),
                 t.twiddle.bits, pairs)
    return y


def irfft_phase_b(y: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """K4 on a CUDA tensor, its plain version on a CPU tensor."""
    if y.device.type == 'cpu':
        return irfft_phase_b_plain(y, t)
    n1, m2, _ = _sizes(t)
    return _launch_inv_phase_b(y, t, stream.block_columns(n1, m2, 1, 8))


def _launch_inv_phase_b(y: torch.Tensor, t: PackedTables, columns: int) -> torch.Tensor:
    """K4 with ``columns`` columns a block."""
    n1, m2, nh = _sizes(t)
    build.check(y, torch.complex64, (n1, m2), 'y')
    _check_tables(t)
    out = torch.empty(2 * nh, dtype=torch.float32, device=y.device)
    build.launch('irfft_phase_b', y.data_ptr(), out.data_ptr(), n1, m2,
                 t.w_n1.data_ptr(), 1.0 / nh, columns)
    return out


def rfft_packed(x: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """(valid,) f32, 1 <= valid <= n, zero-padded to n -> (n/2+1,) c64
    through K1 and K2."""
    return rfft_phase_b(rfft_phase_a(x, t), t)


def irfft_packed(spec: torch.Tensor, t: PackedTables) -> torch.Tensor:
    """(n/2+1,) c64 -> (n,) f32 through K3 and K4."""
    return irfft_phase_b(irfft_phase_a(spec, t), t)
