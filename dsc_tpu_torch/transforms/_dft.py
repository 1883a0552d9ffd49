"""Exact-length batched DFT: the engine under ``dsc_tpu_torch.transforms``
(dsc_tpu/transforms/_dft.py), the scipy.fft-parity tier.

The dsc FFT family keeps the reference identity "sizes round up to the
next power of two" (reference dsc.cpp:2023-2028). This tier evaluates the
length-n DFT exactly for any n: powers of two ride the port's FFT core
(fourier/core.py ``fft_batched``, ``rfft_batched``, ``irfft_batched``,
which launch K12, K6/K7 and K11 by the core's own rule, fourier/config.py),
every other length rides Bluestein's identity
nk = (n^2 + k^2 - (k-n)^2)/2 as one circular convolution at the next
power of two m >= 2n-1.

Plans (the chirp tables and the power-of-two core plan underneath) live
in a bounded LRU under a lock, keyed on the device as well, so a CPU plan
never serves a CUDA call. Each table is uploaded once, when its plan is
built; an entry keeps the core plan's tables it was built with, so the
core's own LRU may evict that plan without breaking it. Chirp phases use
the exact integer reduction ``k^2 mod 2n`` before the float64 multiply
(float theta*k^2 loses the angle past k ~ 1e6); the chirp kernel's
spectrum is computed on the host in float64 (np.fft) at plan time, like
every design-time table of this tier. The chirp products, pads and slices
are plain torch ops, as they are one XLA program on the JAX side.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Tuple

import numpy as np
import torch

from ..capture import capturing
from ..fourier import config, core
from ..fourier import plan as fft_plan

_lock = threading.Lock()
_plans: 'OrderedDict[Tuple, Tuple[Tuple, Any]]' = OrderedDict()


def _cache_get(key: Tuple):
    with _lock:
        if key in _plans:
            _plans.move_to_end(key)
            return _plans[key]
    return None


def _cache_put(key: Tuple, value) -> None:
    with _lock:
        _plans[key] = value
        while len(_plans) > fft_plan.MAX_FFT_PLANS:
            _plans.popitem(last=False)


def _unit_chirp(num: np.ndarray, denom: int, sign: float) -> np.ndarray:
    """exp(sign * 1j * pi * num / denom), integer quadratic ``num``
    reduced mod 2*denom BEFORE the float multiply (exact at any index)."""
    red = np.mod(num, 2 * denom).astype(np.float64)
    return np.exp(sign * 1j * np.pi * red / denom)


def upload(table: np.ndarray, device, dtype=np.complex64) -> torch.Tensor:
    """A float64 design table rounded once to ``dtype`` and copied onto
    ``device``: plan time only. A CUDA graph cannot capture the upload, so
    a plan missing during a ``dsc.compile`` capture raises (fourier/plan.py
    ``get_plan`` does the same)."""
    if capturing():
        raise RuntimeError(
            'dsc.compile: a transforms plan was evicted between the compiled function\'s '
            f'trace run and its CUDA graph capture; raise DSC_MAX_FFT_PLANS '
            f'(now {fft_plan.MAX_FFT_PLANS})')
    return torch.from_numpy(np.ascontiguousarray(table, dtype=dtype)).to(device)


def dft_plan(n: int, device) -> Tuple[Tuple, Any]:
    """(static, tables) for an exact length-n c2c DFT of (B, n) rows on
    ``device``: ``static`` names the route, ``tables`` holds the core
    plan's tables and the chirp tables (complex64 on ``device``)."""
    if n < 1:
        raise RuntimeError(f'transforms: n ({n}) must be >= 1')
    key = ('c2c', n, str(device))
    hit = _cache_get(key)
    if hit is not None:
        return hit
    if n & (n - 1) == 0:
        spec, tables = fft_plan.get_plan(n, 'complex', torch.complex64, device)
        entry = (('pow2', n, spec), (tables,))
    else:
        m = fft_plan.next_pow2(2 * n - 1)
        spec, tables = fft_plan.get_plan(m, 'complex', torch.complex64, device)
        k = np.arange(n, dtype=np.int64)
        pre = _unit_chirp(k * k, n, -1.0)  # w^(k^2/2), w = exp(-2j*pi/n)
        kc = np.arange(-(n - 1), n, dtype=np.int64)  # conv kernel support
        v = np.zeros(m, dtype=np.complex128)
        v[: 2 * n - 1] = _unit_chirp(kc * kc, n, +1.0)
        vspec = np.fft.fft(v)  # host f64 design math
        entry = (('blue', n, m, spec),
                 (tables, upload(pre, device), upload(vspec, device)))
    _cache_put(key, entry)
    return entry


def rdft_plan(n: int, device) -> Tuple[Tuple, Any]:
    """Plan for an exact length-n r2c transform: pow2 n uses the core's
    'real' plan (half-size packing up to plan.RFFT_PACK_MAX, streaming
    above by the core's rule); other n shares the Bluestein c2c plan and
    slices the half spectrum."""
    if n < 1:
        raise RuntimeError(f'transforms: n ({n}) must be >= 1')
    if n & (n - 1) == 0:
        key = ('r2c', n, str(device))
        hit = _cache_get(key)
        if hit is not None:
            return hit
        spec, tables = fft_plan.get_plan(n, 'real', torch.complex64, device)
        entry = (('pow2r', n, spec), (tables,))
        _cache_put(key, entry)
        return entry
    return dft_plan(n, device)


def dft_rows(x: torch.Tensor, tabs: Any, static: Tuple, inverse: bool) -> torch.Tensor:
    """(B, n) float32 or complex64 -> (B, n) complex64 exact DFT; the
    inverse carries the backward 1/n."""
    if static[0] == 'pow2':
        _, n, spec = static
        (tables,) = tabs
        # float32 rows that stream take K6's real-input variant; the
        # core's plain path wants complex rows
        if config.batched_engine('c2c', x.dtype, x.shape[0], n) != 'stream':
            x = x.to(torch.complex64)
        return core.fft_batched(x, spec, tables, inverse)
    _, n, m, spec = static
    tables, pre, vspec = tabs
    if inverse and x.is_complex():
        x = x.conj()
    u = core._pad_crop(x * pre, m)  # chirp pre-multiply, zero-pad to m
    f = core.fft_batched(u, spec, tables, False)
    c = core.fft_batched(f * vspec, spec, tables, True)
    y = c[:, n - 1: 2 * n - 1] * pre
    if inverse:
        return torch.conj_physical(y) * (1.0 / n)
    return y


def rdft_rows(x: torch.Tensor, tabs: Any, static: Tuple) -> torch.Tensor:
    """(B, n) float32 -> (B, n//2+1) complex64 exact half spectrum."""
    if static[0] == 'pow2r':
        _, n, spec = static
        (tables,) = tabs
        return core.rfft_batched(x, spec, tables, n)
    n = static[1]
    return dft_rows(x, tabs, static, inverse=False)[:, : n // 2 + 1]


def irdft_rows(x: torch.Tensor, tabs: Any, static: Tuple) -> torch.Tensor:
    """(B, n//2+1) complex64 half spectrum -> (B, n) float32 (backward
    1/n), the input taken as the lower half of a Hermitian spectrum (the
    c2r convention: only the real part of the DC/Nyquist bins and the
    given interior bins contribute)."""
    if static[0] == 'pow2r':
        _, n, spec = static
        (tables,) = tabs
        return core.irfft_batched(x, spec, tables, n)
    n = static[1]
    # the full Hermitian spectrum: bins 1..ceil(n/2)-1 mirrored conjugated
    # into the upper half; Re(ifft(full)) is then exactly the c2r
    # transform for any input (unpaired imaginary parts cancel out of the
    # real part)
    mirror = torch.conj_physical(x[:, 1: (n + 1) // 2].flip(1))
    full = torch.cat([x, mirror], dim=1)
    return dft_rows(full, tabs, static, inverse=True).real
