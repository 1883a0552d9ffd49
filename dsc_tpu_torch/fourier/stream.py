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

The d-way sharded four-step (parallel/sharded_fft.py) runs the two
kernels on one shard's blocks (pallas_stream.py:728 ``phase_a_local_p``
and :767 ``phase_b_local_p``), with the tables of the whole n-point plan:

  K6 local  phase_a_local: the shard's columns col0 .. col0 + m - 1 of x
            viewed as (n1, n2), as an (n1, m) block -> (m, n1), row j
            times W_n^(s*k1*(col0 + j))
  K7 local  phase_b_local: the exchanged (n2, n1/d) block, column
            DFT_n2 in place, 1/n on the inverse (n the whole length)

``dist_supported`` is the JAX package's rule for which splits shard. The
two local kernels have a column pass of their own (csrc/stream_local.cu on
csrc/cluster_columns.cuh): groups of W = 4 columns of the (L, M) block (8
where the block or the output is float32) held across a thread-block
cluster of Q CTAs, P = L/Q rows each, the clusters persistent; the
geometry from ``local_geometry``, the grid from ``grid_clusters``.

Each kernel has a plain PyTorch version (``*_plain``) with the same inputs
and outputs; the wrappers launch the kernel for CUDA tensors, on the
tensor's own device, and run the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

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


class LocalGeometry(NamedTuple):
    """The cluster column pass of one (L, M) block (K6 local, K7 local):
    groups of ``columns`` (W) columns, clusters of ``cluster`` (Q) CTAs of
    ``threads`` threads and ``smem`` bytes of shared memory each."""
    columns: int
    cluster: int
    threads: int
    smem: int


LOCAL_MAX_ROWS = 1024     # P = L/Q rows a CTA, P*W/16 threads of 16 values
LOCAL_L = (512, 8192)     # the column lengths a shard's block has
LOCAL_M_MIN = 256         # the narrowest block: 2 x 128 lanes a shard


@functools.lru_cache(maxsize=None)
def local_geometry(L: int, M: int, out_bytes: int = 8, in_bytes: int = 8) -> LocalGeometry:
    """(W, Q, threads, shared bytes) of the cluster column pass over an
    (L, M) block whose input and output values take ``in_bytes`` and
    ``out_bytes`` (8: complex64, 4: K6 local's float32 input or K7 local's
    float32 real output): runs of 32 bytes, so W = 4 columns a group of
    complex64 and 8 where either side is float32; Q = L/1024 CTAs a cluster
    (1 up to L = 1024), so that a CTA holds P = L/Q <= 1024 rows of the W
    columns, 16 values a thread in registers; its shared memory is the
    ring's tile (P x W), the exchange between passes (W columns of
    P + P/16 + 16/W float2; csrc/cluster_columns.cuh local_smem_bytes) and
    the mbarrier."""
    lo, hi = LOCAL_L
    if (not lo <= L <= hi or L & (L - 1) or M < LOCAL_M_MIN or M & (M - 1)
            or out_bytes not in (4, 8) or in_bytes not in (4, 8)):
        raise ValueError(f'cluster column pass: L = {L}, M = {M}, {in_bytes}-byte input, '
                         f'{out_bytes}-byte output not supported')
    q = max(1, L // LOCAL_MAX_ROWS)
    p = L // q
    w = 32 // min(in_bytes, out_bytes)
    return LocalGeometry(w, q, p * w // 16, (p * w + w * (p + p // 16 + 16 // w)) * 8 + 8)


def grid_clusters(M: int, geo: LocalGeometry, active: int) -> int:
    """The persistent grid's clusters for M/W column groups when ``active``
    clusters fit the card at once: as few as take the same number of
    rounds, so that every cluster walks as many groups (but the last
    round's)."""
    groups = M // geo.columns
    rounds = -(-groups // min(groups, active))
    return -(-groups // rounds)


@functools.lru_cache(maxsize=None)
def local_launch_info(phase_b: bool, flag: bool, inverse: bool, L: int, M: int,
                      geo: LocalGeometry, device_index: int) -> dict:
    """What a launch of K6 local (``phase_b`` False, ``flag``: real input)
    or K7 local (``flag``: real output) at ``geo`` gets on the card
    ``device_index``: the clusters that can be active at once, registers and
    local memory a thread, shared memory and threads a CTA. Raises when the
    card can hold no cluster of that geometry; the wrappers call it before
    the first launch at a geometry."""
    lib = build.load()
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        err = lib.dsc_stream_local_info(int(phase_b), int(flag), int(inverse), L, M,
                                        geo.columns, geo.cluster, info)
    who = 'stream_phase_b_local' if phase_b else 'stream_phase_a_local'
    if err:
        raise RuntimeError(f'{who}: ({L}, {M}) at {geo}: CUDA error {err} '
                           f'({lib.dsc_error_string(err).decode()})')
    out = dict(zip(('clusters', 'registers', 'local_bytes', 'smem', 'threads'), info))
    if out['clusters'] <= 0:
        raise RuntimeError(f'{who}: no cluster of {geo.cluster} CTAs with {geo.smem} bytes of '
                           f'shared memory fits cuda:{device_index}')
    if (out['smem'], out['threads']) != (geo.smem, geo.threads):
        raise RuntimeError(f'{who}: the launcher takes {out}, local_geometry says {geo}')
    return out


def _complex64(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.complex64
    return np.dtype(dtype) == np.complex64


def dist_supported(n1: int, n2: int, d: int, dtype) -> bool:
    """pallas_stream.py:712: complex64, a supported split, and each factor
    divisible by the d shards into an even count of >= 2 LANES-wide
    blocks."""
    if not _complex64(dtype) or not supported(n1, n2, np.complex64):
        return False
    for f in (n1, n2):
        loc = f // d
        if f % d or loc % LANES or (loc // LANES) % 2 or loc < 2 * LANES:
            return False
    return True


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


def phase_a_local_plain(x: torch.Tensor, t: plan.StreamTables, col0: int,
                        inverse: bool) -> torch.Tensor:
    """K6 on one shard: x (n1, m) f32 or c64, columns col0 .. col0 + m - 1
    of the whole (n1, n2) input of the plan's n -> Z (m, n1) c64, row j
    times W_n^(s*k1*(col0 + j))."""
    n1, n2, _ = _sizes(t)
    m = x.shape[1]
    if x.shape[0] != n1 or not 0 <= col0 <= n2 - m:
        raise ValueError(f'phase_a_local: block {tuple(x.shape)} at column {col0} of '
                         f'({n1}, {n2})')
    cols = x.transpose(0, 1).to(torch.complex64).contiguous()
    a = core.stockham_fft(cols, _table(t.w_n1, inverse))
    dev = x.device
    e = (col0 + torch.arange(m, device=dev))[:, None] * torch.arange(n1, device=dev)[None, :]
    return a * _table(t.twiddle.at(e), inverse)


def phase_b_local_plain(z: torch.Tensor, t: plan.StreamTables, n1_local: int, inverse: bool,
                        real_output: bool = False) -> torch.Tensor:
    """K7 on one shard: the exchanged Z (n2, n1_local) c64 -> X (n2,
    n1_local), the column DFT_n2 in place, scaled by 1/n (the plan's whole
    n) on the inverse; c64 or (``real_output``) f32."""
    _, n2, n = _sizes(t)
    if tuple(z.shape) != (n2, n1_local):
        raise ValueError(f'phase_b_local: block {tuple(z.shape)}, want {(n2, n1_local)}')
    c = core.stockham_fft(z.transpose(0, 1).contiguous(), _table(t.w_n2, inverse))
    y = c.transpose(0, 1)
    if inverse:
        y = y * (1.0 / n)
    return y.real.contiguous() if real_output else y.contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_tables(t: plan.StreamTables, device=None) -> None:
    for name, tab in (('w_n1', t.w_n1), ('w_n2', t.w_n2),
                      ('twiddle.lo', t.twiddle.lo), ('twiddle.hi', t.twiddle.hi)):
        build.check(tab, torch.complex64, tab.shape, name)
        if device is not None and tab.device != device:
            raise RuntimeError(f'{name}: tables on {tab.device}, data on {device}')


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


def phase_a_local(x: torch.Tensor, t: plan.StreamTables, col0: int,
                  inverse: bool) -> torch.Tensor:
    """K6 local on a CUDA tensor (launched on its device), its plain
    version on a CPU tensor."""
    if x.device.type == 'cpu':
        return phase_a_local_plain(x, t, col0, inverse)
    n1 = 2 * t.w_n1.shape[0]
    return _launch_phase_a_local(x, t, col0, inverse,
                                 local_geometry(n1, x.shape[-1], 8,
                                                4 if x.dtype == torch.float32 else 8))


def _launch_phase_a_local(x: torch.Tensor, t: plan.StreamTables, col0: int, inverse: bool,
                          geo: LocalGeometry) -> torch.Tensor:
    """K6 local at the cluster geometry ``geo``."""
    n1, n2, _ = _sizes(t)
    m = x.shape[-1]
    if x.dtype not in (torch.float32, torch.complex64):
        raise RuntimeError(f'stream_phase_a_local: x must be float32 or complex64, '
                           f'got {x.dtype}')
    build.check(x, x.dtype, (n1, m), 'x')
    _check_tables(t, x.device)
    if not 0 <= col0 <= n2 - m:
        raise RuntimeError(f'stream_phase_a_local: columns {col0} .. {col0 + m - 1} '
                           f'outside 0 .. {n2 - 1}')
    real = x.dtype == torch.float32
    info = local_launch_info(False, real, inverse, n1, m, geo, x.device.index)
    z = torch.empty((m, n1), dtype=torch.complex64, device=x.device)
    build.launch('stream_phase_a_local', x.data_ptr(), z.data_ptr(), n1, m, int(col0),
                 int(real), int(inverse), t.w_n1.data_ptr(), t.twiddle.lo.data_ptr(),
                 t.twiddle.hi.data_ptr(), t.twiddle.bits, geo.columns, geo.cluster,
                 grid_clusters(m, geo, info['clusters']), device=x.device)
    return z


def phase_b_local(z: torch.Tensor, t: plan.StreamTables, n1_local: int, inverse: bool,
                  real_output: bool = False) -> torch.Tensor:
    """K7 local on a CUDA tensor (launched on its device), its plain
    version on a CPU tensor."""
    if z.device.type == 'cpu':
        return phase_b_local_plain(z, t, n1_local, inverse, real_output)
    n2 = 2 * t.w_n2.shape[0]
    return _launch_phase_b_local(z, t, n1_local, inverse, real_output,
                                 local_geometry(n2, n1_local, 4 if real_output else 8))


def _launch_phase_b_local(z: torch.Tensor, t: plan.StreamTables, n1_local: int, inverse: bool,
                          real_output: bool, geo: LocalGeometry) -> torch.Tensor:
    """K7 local at the cluster geometry ``geo``: one (n2, n1_local) block,
    scaled by 1/n of the whole transform on the inverse."""
    _, n2, n = _sizes(t)
    build.check(z, torch.complex64, (n2, n1_local), 'z')
    _check_tables(t, z.device)
    info = local_launch_info(True, real_output, inverse, n2, n1_local, geo, z.device.index)
    out = torch.empty((n2, n1_local), dtype=torch.float32 if real_output else torch.complex64,
                      device=z.device)
    build.launch('stream_phase_b_local', z.data_ptr(), out.data_ptr(), n2, n1_local,
                 int(inverse), int(real_output), t.w_n2.data_ptr(),
                 (1.0 / n) if inverse else 1.0, geo.columns, geo.cluster,
                 grid_clusters(n1_local, geo, info['clusters']), device=z.device)
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
    _, t = plan.get_plan(n, 'stream', torch.complex64, x.device)
    lead = x.shape[:-1]
    z = phase_a(build.aligned(x.reshape(-1, n)), t, inverse)
    return phase_b(z, t, inverse, real_output).reshape(*lead, n)
