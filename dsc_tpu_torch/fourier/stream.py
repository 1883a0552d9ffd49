"""The natural streaming four-step FFT: kernels K6 and K7
(dsc_tpu/fourier/pallas_stream.py).

An n-point transform of each row of x (B, n), n = n1*n2, in two passes
over device memory (csrc/fourstep_stream.cu), with s = -1 forward and +1
inverse:

  K6 stream_phase_a  column DFT_n1 of x viewed as (n1, n2), four-step
                     twiddle, transposed store:
                     Z[b*n2 + j2, k1] = W_n^(s*k1*j2)
                                        * sum_j1 x[b, n2*j1 + j2] W_n1^(s*j1*k1)
  K7 stream_phase_b  column DFT_n2 of Z, 1/n on the inverse:
                     X[b*n2 + k2, k1] = scale * sum_j2 Z[b*n2 + j2, k1] W_n2^(s*j2*k2),
                     which is X[b, k1 + n1*k2], the natural order

K6 reads float32 (real input, the rfft) or complex64; K7 writes complex64
or, with ``real_output``, the float32 real part (the irfft tail). The
inverse flips the sign of the tables in the kernels: no conjugation pass.
The tables come from the 'stream' plan (plan.StreamTables).

Here also live the size rules that decide, as on the TPU, which transforms
take the two kernels (config.py): the split ``factors`` and ``supported``
with the batch grouping ``_group``. The grouping only sizes the TPU's
copies; the kernels need none, but the rule stays the JAX package's. And
here lives ``block_columns``, the choice of the block size C of the column
pass that K6, K7, K8, K10 and the packed K1, K4 share
(csrc/stream_columns.cuh); the launcher derives the rest of the geometry
from C.

Each kernel has a plain PyTorch version (``*_plain``) with the same inputs
and outputs; the wrappers launch the kernel for CUDA tensors and run the
plain version for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..kernels import build
from . import core, plan

LANES = 128
FACTOR_MIN = 512
FACTOR_MAX = 8192


def factors(n: int) -> Tuple[int, int]:
    """Balanced (n1, n2) split for the streaming kernels (pallas_stream.py:77-82)."""
    n1 = min(1 << (n.bit_length() // 2), FACTOR_MAX)
    return n1, n // n1


def _group(batch: int, nf: int) -> int:
    """Consecutive batch rows grouped per copy (pallas_stream.py:96-102)."""
    g = min(batch, max(1, FACTOR_MAX // nf))
    while batch % g:
        g -= 1
    return g


def supported(n1: int, n2: int, dtype, batch: int = 1) -> bool:
    """pallas_stream.py:105-117: complex64 only; each factor a power of two
    in [256, 8192] that batch grouping lifts to >= FACTOR_MIN rows."""
    if np.dtype(dtype) != np.complex64:
        return False
    for f in (n1, n2):
        if not (256 <= f <= FACTOR_MAX) or f & (f - 1):
            return False
        if _group(batch, f) * f < FACTOR_MIN:
            return False
    return n1 % LANES == 0 and n2 % LANES == 0


# The column pass (csrc/stream_columns.cuh) takes C consecutive columns a
# block; the launcher derives the rest (C*L/16 threads, at most 1024, and
# the shared-memory exchange) from C. COLUMNS[out_bytes][L] is the C of the
# fastest block size that chip_smoke.py --profile timed for each column
# length L and output value size (8 bytes: complex64, 4: the float32 real
# part; PERF.md): C*L = 4096 points up to L = 512, 8192 at 1024 and 2048,
# and C >= 32 / out_bytes wherever a block can hold that many columns,
# since a column store of runs under a 32-byte sector took K7 and K10 over
# twice as long.
COLUMNS = {
    8: {256: 16, 512: 8, 1024: 8, 2048: 4, 4096: 4, 8192: 2},
    4: {256: 16, 512: 8, 1024: 8, 2048: 8, 4096: 4, 8192: 2},
}
MIN_BLOCKS = 512      # C halves until the grid has this many blocks


@functools.lru_cache(maxsize=None)
def block_columns(L: int, M: int, batch: int, out_bytes: int = 8) -> int:
    """C, the columns a block of the column pass over ``batch`` (L, M)
    matrices whose output values take ``out_bytes``: COLUMNS, halved until
    the grid has MIN_BLOCKS blocks (or C is 1)."""
    if L not in COLUMNS[out_bytes] or M < 1 or M & (M - 1):
        raise ValueError(f'column pass: L = {L}, M = {M} not supported')
    c = min(COLUMNS[out_bytes][L], M)
    while c > 1 and batch * (M // c) < MIN_BLOCKS:
        c //= 2
    return c


def _sizes(t: plan.StreamTables):
    n1, n2 = 2 * t.w_n1.shape[0], 2 * t.w_n2.shape[0]
    return n1, n2, n1 * n2


def _table(w: torch.Tensor, inverse: bool) -> torch.Tensor:
    return w.conj() if inverse else w


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def phase_a_plain(x: torch.Tensor, t: plan.StreamTables, inverse: bool) -> torch.Tensor:
    """K6: x (B, n) f32 or c64 -> Z (B*n2, n1) c64."""
    n1, n2, n = _sizes(t)
    b = x.shape[0]
    cols = x.reshape(b, n1, n2).transpose(1, 2).reshape(b * n2, n1)
    a = core.stockham_fft(cols.to(torch.complex64), _table(t.w_n1, inverse))
    dev = x.device
    e = torch.arange(n2, device=dev)[:, None] * torch.arange(n1, device=dev)[None, :]
    tw = _table(t.twiddle.at(e), inverse)
    return (a.reshape(b, n2, n1) * tw).reshape(b * n2, n1)


def phase_b_plain(z: torch.Tensor, t: plan.StreamTables, inverse: bool,
                  real_output: bool = False) -> torch.Tensor:
    """K7: Z (B*n2, n1) c64 -> X (B, n), c64 or (``real_output``) f32."""
    n1, n2, n = _sizes(t)
    b = z.shape[0] // n2
    cols = z.reshape(b, n2, n1).transpose(1, 2).reshape(b * n1, n2)
    c = core.stockham_fft(cols, _table(t.w_n2, inverse))          # [b*n1 + k1, k2]
    y = c.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    if inverse:
        y = y * (1.0 / n)
    return y.real.contiguous() if real_output else y


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_tables(t: plan.StreamTables) -> None:
    for name, tab in (('w_n1', t.w_n1), ('w_n2', t.w_n2),
                      ('twiddle.lo', t.twiddle.lo), ('twiddle.hi', t.twiddle.hi)):
        build.check(tab, torch.complex64, tab.shape, name)


def phase_a(x: torch.Tensor, t: plan.StreamTables, inverse: bool) -> torch.Tensor:
    """K6 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == 'cpu':
        return phase_a_plain(x, t, inverse)
    n1, n2, _ = _sizes(t)
    return _launch_phase_a(x, t, inverse, block_columns(n1, n2, x.shape[0]))


def _launch_phase_a(x: torch.Tensor, t: plan.StreamTables, inverse: bool,
                    columns: int) -> torch.Tensor:
    """K6 with ``columns`` columns a block."""
    n1, n2, n = _sizes(t)
    b = x.shape[0]
    if x.dtype not in (torch.float32, torch.complex64):
        raise RuntimeError(f'stream_phase_a: x must be float32 or complex64, got {x.dtype}')
    build.check(x, x.dtype, (b, n), 'x')
    _check_tables(t)
    z = torch.empty((b * n2, n1), dtype=torch.complex64, device=x.device)
    if b:  # a grid of no blocks is refused at launch
        build.launch('stream_phase_a', x.data_ptr(), z.data_ptr(), b, n1, n2,
                     int(x.dtype == torch.float32), int(inverse), t.w_n1.data_ptr(),
                     t.twiddle.lo.data_ptr(), t.twiddle.hi.data_ptr(), t.twiddle.bits,
                     columns)
    return z


def phase_b(z: torch.Tensor, t: plan.StreamTables, inverse: bool,
            real_output: bool = False) -> torch.Tensor:
    """K7 on a CUDA tensor, its plain version on a CPU tensor."""
    if z.device.type == 'cpu':
        return phase_b_plain(z, t, inverse, real_output)
    n1, n2, _ = _sizes(t)
    return _launch_phase_b(z, t, inverse, real_output,
                           block_columns(n2, n1, z.shape[0] // n2, 4 if real_output else 8))


def _launch_phase_b(z: torch.Tensor, t: plan.StreamTables, inverse: bool, real_output: bool,
                    columns: int) -> torch.Tensor:
    """K7 with ``columns`` columns a block."""
    n1, n2, n = _sizes(t)
    b = z.shape[0] // n2
    build.check(z, torch.complex64, (b * n2, n1), 'z')
    _check_tables(t)
    out = torch.empty((b, n), dtype=torch.float32 if real_output else torch.complex64,
                      device=z.device)
    if b:
        build.launch('stream_phase_b', z.data_ptr(), out.data_ptr(), b, n1, n2,
                     int(inverse), int(real_output), t.w_n2.data_ptr(),
                     (1.0 / n) if inverse else 1.0, columns)
    return out


def fourstep_stream(x: torch.Tensor, n1: int, n2: int, inverse: bool,
                    real_output: bool = False) -> torch.Tensor:
    """n-point FFT of each row of x, (B, n) or (n,), float32 (real input)
    or complex64, through K6 and K7 (pallas_stream.py:636
    ``fourstep_stream_p``). Returns complex64 of x's shape, or float32 when
    ``real_output`` is set; the inverse is scaled by 1/n."""
    n = n1 * n2
    if (n1, n2) != factors(n):
        raise ValueError(f'fourstep_stream: split {(n1, n2)} is not factors({n}) = '
                         f'{factors(n)}')
    _, t = plan.get_plan(n, 'stream', torch.complex64)
    lead = x.shape[:-1]
    z = phase_a(build.aligned(x.reshape(-1, n)), t, inverse)
    return phase_b(z, t, inverse, real_output).reshape(*lead, n)
