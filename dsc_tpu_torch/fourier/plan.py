"""FFT plan cache for dsc_tpu_torch (dsc_tpu/fourier/plan.py).

Rebuild of the reference plan cache (dsc/src/dsc.cpp:182-267,
dsc/include/dsc_fft.h:33-55). A plan holds twiddle tables as tensors on
the context's device plus a static *spec* of how the transform is
factorized. Tables are computed on the host in float64 and rounded once
to the working precision, which keeps 2^24-point float32 transforms within
1e-4 of NumPy. The cache is an LRU bounded by DSC_MAX_FFT_PLANS (default
16, as in the reference). A compiled function's trace run fills the cache
before its CUDA graph is captured; a plan missing during the capture
raises (``get_plan``).

Besides the reference's 'complex' and 'real' plans, a 'packed' plan holds
the tables of the packed half-size real FFT (packed_fused.py): the
column and row DFT tables and the two twiddles that are as large as the
data, each factored into two short tables (``Factored``). A 'stream' plan
holds those of the natural streaming four-step (stream.py): the DFT
tables of both factors and the four-step twiddle W_n^(k1*j2), factored.

``lookups`` counts the cache's hits and misses since the last
``reset_lookups()``; a miss builds its plan inside a ``plan`` span
(tracing.py).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from .. import tracing
from ..capture import capturing
from . import stream

MAX_FFT_PLANS = int(os.environ.get('DSC_MAX_FFT_PLANS', '16'))

# Largest transform handled by a single base case; above it the four-step
# factorization splits the work.
BASE_MAX = 4096

# Largest real transform using the half-size even/odd packing on the core
# path; above it the full-size complex engine runs (dsc_tpu plan.py).
RFFT_PACK_MAX = 2**16

_plans: 'OrderedDict[Tuple, Any]' = OrderedDict()
_lock = threading.Lock()
lookups = {'hit': 0, 'miss': 0}


def reset_lookups() -> None:
    with _lock:
        lookups['hit'] = lookups['miss'] = 0


def clear_plans() -> None:
    with _lock:
        _plans.clear()


def num_plans() -> int:
    return len(_plans)


def next_pow2(n: int) -> int:
    """dsc_pow2_n equivalent (reference dsc.h:122-132): next power of two
    >= n."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def build_spec(n: int) -> Tuple:
    """Static factorization spec for an n-point transform (n = power of 2).

    ('base', n)                      single base-case FFT
    ('split', n1, n2, spec1, spec2)  Bailey four-step, n = n1*n2
    """
    if n <= BASE_MAX:
        return ('base', n)
    # balanced factors that fit the base case: 2^24 -> 4096 x 4096
    n1 = min(1 << (n.bit_length() // 2), BASE_MAX)
    n2 = n // n1
    return ('split', n1, n2, build_spec(n1), build_spec(n2))


def _w_table(n: int) -> np.ndarray:
    """FFT stage twiddles w[p] = exp(-2*pi*i*p/n), p < n/2, in float64
    (dsc_init_plan parity, dsc_fft.h:33-55)."""
    p = np.arange(max(n // 2, 1), dtype=np.float64)
    return np.exp(-2j * np.pi * p / n)


def _split_twiddle(n1: int, n2: int) -> np.ndarray:
    """Four-step inter-stage twiddle laid out (n2, n1):
    T[j2, k1] = exp(-2i*pi*k1*j2/n)."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    return np.exp(-2j * np.pi * np.outer(j2, k1) / n)


def _rfft_untangle(n: int) -> np.ndarray:
    """Real-FFT untangling twiddles exp(-2i*pi*k/n), k = 0..n/2 (the
    reference RFFT plan's extra twiddle set, dsc_fft.h:178-238)."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    return np.exp(-2j * np.pi * k / n)


class Factored(NamedTuple):
    """W_period^e = hi[e >> bits] * lo[e & (2^bits - 1)] for 0 <= e <
    period: two tables of about sqrt(period) entries in place of one as
    large as the data. Both are exact float64 phasors rounded once, so the
    product is within two roundings of W_period^e."""

    lo: torch.Tensor
    hi: torch.Tensor
    bits: int

    def at(self, e: torch.Tensor) -> torch.Tensor:
        """W_period^e for the integer exponents ``e``, formed as the kernels
        form it."""
        return self.hi[e >> self.bits] * self.lo[e & ((1 << self.bits) - 1)]


class PackedTables(NamedTuple):
    w_n1: torch.Tensor      # column DFT stage twiddles, n1/2 entries
    w_m2: torch.Tensor      # row DFT stage twiddles, m2/2 entries
    twiddle: Factored       # four-step twiddle W_{n/2}^(k1*j2)
    untangle: Factored      # real-FFT untangle twiddle W_n^k


class StreamTables(NamedTuple):
    w_n1: torch.Tensor      # column DFT_n1 stage twiddles, n1/2 entries
    w_n2: torch.Tensor      # row DFT_n2 stage twiddles, n2/2 entries
    twiddle: Factored       # four-step twiddle W_n^(k1*j2)


def _factored(period: int, dtype, device) -> Factored:
    bits = (period.bit_length()) // 2
    lo = np.exp(-2j * np.pi * np.arange(1 << bits, dtype=np.float64) / period)
    hi = np.exp(-2j * np.pi * (np.arange(max(period >> bits, 1), dtype=np.float64)
                               * (1 << bits)) / period)
    return Factored(_dev(lo, dtype, device), _dev(hi, dtype, device), bits)


def _dev(table: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def packed_tables(n1: int, n2: int, dtype, device) -> PackedTables:
    """Tables of the packed real FFT of n = n1*n2 points split (n1, n2/2)."""
    m2 = n2 // 2
    return PackedTables(
        _dev(_w_table(n1), dtype, device),
        _dev(_w_table(m2), dtype, device),
        _factored(n1 * m2, dtype, device),
        _factored(n1 * n2, dtype, device),
    )


def stream_tables(n1: int, n2: int, dtype, device) -> StreamTables:
    """Tables of the natural streaming four-step of n = n1*n2 points."""
    return StreamTables(_dev(_w_table(n1), dtype, device),
                        _dev(_w_table(n2), dtype, device),
                        _factored(n1 * n2, dtype, device))


def _build_tables(spec: Tuple, dtype, device) -> Any:
    if spec[0] == 'base':
        return _dev(_w_table(spec[1]), dtype, device)
    _, n1, n2, s1, s2 = spec
    return (
        _dev(_split_twiddle(n1, n2), dtype, device),
        _build_tables(s1, dtype, device),
        _build_tables(s2, dtype, device),
    )


def _build_plan(n: int, fft_type: str, dtype, device) -> Tuple[Tuple, Any]:
    if fft_type in ('packed', 'stream'):
        n1, n2 = stream.factors(n)
        spec = (fft_type, n1, n2)
        build = packed_tables if fft_type == 'packed' else stream_tables
        tables = build(n1, n2, dtype, device)
    elif fft_type == 'real':
        if n > RFFT_PACK_MAX:
            # large real transforms run the full-size complex engine
            spec = build_spec(n)
            tables = (_build_tables(spec, dtype, device), None)
        else:
            spec = build_spec(n // 2 if n > 1 else 1)
            tables = (_build_tables(spec, dtype, device),
                      _dev(_rfft_untangle(n), dtype, device))
    else:
        spec = build_spec(n)
        tables = _build_tables(spec, dtype, device)
    return spec, tables


def get_plan(n: int, fft_type: str, dtype: torch.dtype, device=None) -> Tuple[Tuple, Any]:
    """Probe-or-build a plan for an n-point transform (n = power of 2).

    fft_type: 'complex', 'real' (reference dsc_fft_type), 'packed' or
    'stream'.
    ``dtype`` is the complex working dtype; ``device``: where the tables
    live (None: the context's device; a CUDA device without an index is
    the current one). Returns (spec, tables).
    """
    if device is None:
        from ..context import device as _device

        device = _device()
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    key = (n, fft_type, dtype, str(device))
    with _lock:
        if key in _plans:
            lookups['hit'] += 1
            _plans.move_to_end(key)
            return _plans[key]
        lookups['miss'] += 1
    if capturing():
        # the upload of new tables cannot be captured into a CUDA graph
        raise RuntimeError(
            f'dsc.compile: the {fft_type} FFT plan of {n} points was evicted from the plan '
            f'cache between the compiled function\'s trace run and its CUDA graph capture: '
            f'the function needs more than DSC_MAX_FFT_PLANS={MAX_FFT_PLANS} plans; '
            'raise DSC_MAX_FFT_PLANS')
    with tracing.trace_op(fft_type, 'plan;fft', {'n': n}):
        spec, tables = _build_plan(n, fft_type, dtype, device)
    with _lock:
        _plans[key] = (spec, tables)
        while len(_plans) > MAX_FFT_PLANS:
            _plans.popitem(last=False)
    return spec, tables
