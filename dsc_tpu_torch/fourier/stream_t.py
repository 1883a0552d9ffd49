"""The streaming four-step FFT of one vector into and out of the T layout:
kernels K8, K9 and K10 (dsc_tpu/fourier/pallas_stream_t.py).

For n = n1*n2 the T layout stores a spectrum X as S (n1, n2) complex64,
S[k1, k2] = X[k1 + n1*k2]; the half-T layout of a real input's spectrum
keeps columns 0..n2/2, S (n1, n2/2 + 1), because the rest is the conjugate
mirror S[k1, k2] = conj S[n1 - k1, n2 - 1 - k2] (k1 >= 1) and
S[0, k2] = conj S[0, n2 - k2]. The TPU layout's pad rows and 128-lane
padding are not carried over. The kernels (csrc/fourstep_stream_t.cu):

  K8  stream_phase_b_t      column DFT_n2 of K6's Z (n2, n1), column k1
                            stored as row k1 of S (half: values 0..n2/2);
                            forward: S[k1, k2] = sum_j2 Z[j2, k1] W_n2^(j2*k2)
  K9  stream_inv_phase_a_t  row inverse DFT_n2 of S (a half-T row rebuilt
                            from its mirror row first) and the inverse
                            four-step twiddle, on the register-resident row
                            pass (csrc/fft_rows_reg.cuh), R rows a block in
                            the T layout (``block_rows``), a row pair a
                            block in the half-T layout:
                            Y[k1, j2] = W_n^(-k1*j2) * sum_k2 S[k1, k2] W_n2^(-k2*j2)
  K10 stream_inv_phase_b_t  column inverse DFT_n1 of Y, 1/n:
                            x[n2*j1 + j2] = (1/n) sum_k1 Y[k1, j2] W_n1^(-k1*j1),
                            complex64 or the float32 real part

``fourstep_to_t`` is K6 + K8, ``fourstep_from_t`` K9 + K10. The tables are
the 'stream' plan's (plan.StreamTables). Each kernel has a plain PyTorch
version (``*_plain``) with the same inputs and outputs; the wrappers launch
the kernel for CUDA tensors and run the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from ..kernels import build
from . import core, plan, stream

# K9 takes R rows of n2 points a block in the T layout; the launcher derives
# the rest (R*n2/16 threads, at most 1024, and R padded rows of shared
# memory) from R. ROWS[n2] is the R of the fastest block size that
# chip_smoke.py --profile timed (4096, 8192 and 16384 points a block;
# PERF.md): 4096 points (R = 1 ahead of R = 2 by 2% at 2^24 and 2^25; at
# n2 <= 1024 every R, 64 blocks at 2^18 among them, took the wrapper's
# host time) and one 8192-point row (10% ahead of two at 2^26).
ROWS = {512: 8, 1024: 4, 2048: 2, 4096: 1, 8192: 1}


def width(n2: int, half: bool) -> int:
    """Stored columns of S: n2, or n2/2 + 1 in the half-T layout."""
    return n2 // 2 + 1 if half else n2


def block_rows(n2: int) -> int:
    """R, the rows a block of K9 over rows of n2 points in the T layout."""
    if n2 not in ROWS:
        raise ValueError(f'stream_inv_phase_a_t: n2 = {n2} not supported')
    return ROWS[n2]


def unhalf(s: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """The full S (n1, n2) of a half-T S (n1, n2/2 + 1): columns above n2/2
    from the conjugate mirror."""
    h = n2 // 2
    row0 = s[:1, 1:h].flip(1).conj()                     # S[0, n2 - k2]
    rest = s[1:, :h - 1].flip(0).flip(1).conj()          # S[n1 - k1, n2 - 1 - k2]
    return torch.cat([s, torch.cat([row0, rest], dim=0)], dim=1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def phase_b_t_plain(z: torch.Tensor, t: plan.StreamTables, half: bool) -> torch.Tensor:
    """K8: Z (n2, n1) c64 -> S (n1, n2), or (n1, n2/2 + 1) with ``half``."""
    n1, n2, _ = stream._sizes(t)
    s = core.stockham_fft(z.t().contiguous(), t.w_n2)   # [k1, k2]
    return s[:, :width(n2, half)].contiguous()


def inv_phase_a_t_plain(s: torch.Tensor, t: plan.StreamTables, half: bool) -> torch.Tensor:
    """K9: S (n1, n2) or half (n1, n2/2 + 1) c64 -> Y (n1, n2) c64."""
    n1, n2, _ = stream._sizes(t)
    full = unhalf(s, n1, n2) if half else s
    y = core.stockham_fft(full, t.w_n2.conj())          # [k1, j2]
    dev = s.device
    e = torch.arange(n1, device=dev)[:, None] * torch.arange(n2, device=dev)[None, :]
    return y * t.twiddle.at(e).conj()


def inv_phase_b_t_plain(y: torch.Tensor, t: plan.StreamTables,
                        real_output: bool) -> torch.Tensor:
    """K10: Y (n1, n2) c64 -> x (n,), c64 or (``real_output``) f32."""
    n1, n2, n = stream._sizes(t)
    c = core.stockham_fft(y.t().contiguous(), t.w_n1.conj())   # [j2, j1]
    x = c.t().reshape(n) * (1.0 / n)
    return x.real.contiguous() if real_output else x


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def phase_b_t(z: torch.Tensor, t: plan.StreamTables, half: bool) -> torch.Tensor:
    """K8 on a CUDA tensor, its plain version on a CPU tensor."""
    if z.device.type == 'cpu':
        return phase_b_t_plain(z, t, half)
    n1, n2, _ = stream._sizes(t)
    return _launch_phase_b_t(z, t, half, stream.block_columns(n2, n1, 1))


def _launch_phase_b_t(z: torch.Tensor, t: plan.StreamTables, half: bool,
                      columns: int) -> torch.Tensor:
    """K8 with ``columns`` columns a block."""
    n1, n2, _ = stream._sizes(t)
    build.check(z, torch.complex64, (n2, n1), 'z')
    stream._check_tables(t)
    s = torch.empty((n1, width(n2, half)), dtype=torch.complex64, device=z.device)
    build.launch('stream_phase_b_t', z.data_ptr(), s.data_ptr(), n1, n2, int(half),
                 t.w_n2.data_ptr(), columns)
    return s


def inv_phase_a_t(s: torch.Tensor, t: plan.StreamTables, half: bool) -> torch.Tensor:
    """K9 on a CUDA tensor, its plain version on a CPU tensor."""
    if s.device.type == 'cpu':
        return inv_phase_a_t_plain(s, t, half)
    n2 = stream._sizes(t)[1]
    return _launch_inv_phase_a_t(s, t, half, 1 if half else block_rows(n2))


def _launch_inv_phase_a_t(s: torch.Tensor, t: plan.StreamTables, half: bool,
                          rows: int) -> torch.Tensor:
    """K9 with ``rows`` rows a block (the T layout; a half-T block holds one
    row pair whatever ``rows`` says)."""
    n1, n2, _ = stream._sizes(t)
    build.check(s, torch.complex64, (n1, width(n2, half)), 's')
    stream._check_tables(t)
    y = torch.empty((n1, n2), dtype=torch.complex64, device=s.device)
    build.launch('stream_inv_phase_a_t', s.data_ptr(), y.data_ptr(), n1, n2, int(half),
                 t.w_n2.data_ptr(), t.twiddle.lo.data_ptr(), t.twiddle.hi.data_ptr(),
                 t.twiddle.bits, rows)
    return y


def inv_phase_b_t(y: torch.Tensor, t: plan.StreamTables, real_output: bool) -> torch.Tensor:
    """K10 on a CUDA tensor, its plain version on a CPU tensor."""
    if y.device.type == 'cpu':
        return inv_phase_b_t_plain(y, t, real_output)
    n1, n2, _ = stream._sizes(t)
    return _launch_inv_phase_b_t(y, t, real_output,
                                 stream.block_columns(n1, n2, 1, 4 if real_output else 8))


def _launch_inv_phase_b_t(y: torch.Tensor, t: plan.StreamTables, real_output: bool,
                          columns: int) -> torch.Tensor:
    """K10 with ``columns`` columns a block."""
    n1, n2, n = stream._sizes(t)
    build.check(y, torch.complex64, (n1, n2), 'y')
    stream._check_tables(t)
    out = torch.empty(n, dtype=torch.float32 if real_output else torch.complex64,
                      device=y.device)
    build.launch('stream_inv_phase_b_t', y.data_ptr(), out.data_ptr(), n1, n2,
                 int(real_output), t.w_n1.data_ptr(), 1.0 / n, columns)
    return out


def _tables(n1: int, n2: int) -> plan.StreamTables:
    n = n1 * n2
    if (n1, n2) != stream.factors(n):
        raise ValueError(f'T layout: split {(n1, n2)} is not factors({n}) = '
                         f'{stream.factors(n)}')
    return plan.get_plan(n, 'stream', torch.complex64)[1]


def fourstep_to_t(x: torch.Tensor, n1: int, n2: int, half: bool) -> torch.Tensor:
    """Forward n-point FFT of one vector x (n,), float32 (real input) or
    complex64, into the T layout S (n1, n2), or with ``half`` (a float32
    input) the half-T layout (n1, n2/2 + 1): K6 + K8
    (pallas_stream_t.py:568 ``fourstep_to_t_p``)."""
    t = _tables(n1, n2)
    if half and x.dtype != torch.float32:
        raise ValueError(f'the half-T layout takes a real (float32) input, got {x.dtype}')
    z = stream.phase_a(build.aligned(x.reshape(1, n1 * n2)), t, False)
    return phase_b_t(z, t, half)


def fourstep_from_t(s: torch.Tensor, n1: int, n2: int, half: bool,
                    real_output: bool) -> torch.Tensor:
    """Inverse n-point FFT (1/n) of a T-layout S (n1, n2), or half-T S
    (n1, n2/2 + 1), to the natural (n,) complex64, or float32 with
    ``real_output``: K9 + K10 (pallas_stream_t.py:620 ``fourstep_from_t_p``)."""
    t = _tables(n1, n2)
    y = inv_phase_a_t(build.aligned(s), t, half)
    return inv_phase_b_t(y, t, real_output)
