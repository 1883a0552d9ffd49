"""scipy.fft-parity FFT family: exact lengths, norms, n-D, shifts
(dsc_tpu/transforms/exact.py).

The dsc FFT surface (dsc_tpu_torch.fft/ifft/rfft/irfft) keeps the
reference's pad-to-pow2 identity (reference dsc.cpp:2023-2028). This tier
mirrors ``scipy.fft`` instead: exact length-n transforms for any n (pow2
rides the FFT core, others Bluestein, _dft.py), ``norm`` =
backward/ortho/forward, axis/axes/s handling, Hermitian transforms, shifts
and fast-length helpers. scipy.fft is the executable spec.

Each public call is one chain of torch ops on the input's device (move the
axis last, fit it to n, the transform, the norm scale); signals and
spectra are Tensors (array-likes accepted), read in natural order through
``Tensor.torch`` (a spectrum in the T layout turns natural in place).
Compute is float32/complex64 whatever the input's width, as in the JAX
package; design math is float64 on the host.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..fourier import core
from ..fourier import fftfreq as _fftfreq
from ..fourier import plan as fft_plan
from ..fourier import rfftfreq as _rfftfreq
from ..tensor import Tensor, _finish, from_numpy
from . import _dft

__all__ = [
    'fft', 'ifft', 'rfft', 'irfft', 'hfft', 'ihfft',
    'fft2', 'ifft2', 'rfft2', 'irfft2', 'hfft2', 'ihfft2',
    'fftn', 'ifftn', 'rfftn', 'irfftn', 'hfftn', 'ihfftn',
    'fftshift', 'ifftshift', 'fftfreq', 'rfftfreq',
    'next_fast_len', 'prev_fast_len',
    'get_workers', 'set_workers',
]

_NORMS = ('backward', 'ortho', 'forward')


def _norm_scale(norm: Optional[str], n: int, forward: bool, who: str) -> float:
    """Extra scale on top of the engine convention (forward unscaled,
    inverse 1/n)."""
    if norm is None:
        norm = 'backward'
    if norm not in _NORMS:
        raise RuntimeError(f"{who}: invalid norm {norm!r} (use 'backward', "
                           "'ortho' or 'forward')")
    if norm == 'backward':
        return 1.0
    if norm == 'ortho':
        return 1.0 / math.sqrt(n) if forward else math.sqrt(n)
    return 1.0 / n if forward else float(n)


def _as_tensor(x) -> Tensor:
    return x if isinstance(x, Tensor) else from_numpy(np.asarray(x))


def _values_of(x: Tensor) -> torch.Tensor:
    """x's values in natural order, complex64 or float32 (dsc_tpu
    exact._planes_of)."""
    return x.torch.to(torch.complex64 if x.dtype.is_complex else torch.float32)


def _resolve_axis(ndim: int, axis: int, who: str) -> int:
    ax = axis + ndim if axis < 0 else axis
    if ax < 0 or ax >= ndim:
        raise RuntimeError(f'{who}: axis {axis} is out of bounds for a '
                           f'{ndim}-D tensor')
    return ax


def _scaled(y: torch.Tensor, scale: float) -> torch.Tensor:
    return y if scale == 1.0 else y * scale


# --------------------------------------------------------------------------
# the transforms over one axis (moveaxis -> (B, len) rows fitted to n, the
# np.fft n contract: truncate, or zero-pad at the end)
# --------------------------------------------------------------------------


def _c2c(v: torch.Tensor, static, tabs, n: int, axis: int, inverse: bool,
         scale: float) -> torch.Tensor:
    rows, lead = core._rows(v, axis, n)
    y = _dft.dft_rows(rows, tabs, static, inverse)
    return core._unrows(_scaled(y, scale), lead, axis)


def _r2c(v: torch.Tensor, static, tabs, n: int, axis: int, scale: float,
         conj_out: bool) -> torch.Tensor:
    rows, lead = core._rows(v, axis, n)
    y = _dft.rdft_rows(rows, tabs, static)
    if conj_out:
        y = torch.conj_physical(y)
    return core._unrows(_scaled(y, scale), lead, axis)


def _c2r(v: torch.Tensor, static, tabs, n: int, axis: int, scale: float,
         conj_in: bool) -> torch.Tensor:
    m = n // 2 + 1
    rows, lead = core._rows(v, axis, m)
    rows = rows.to(torch.complex64, copy=True)
    if conj_in:
        rows.conj_physical_()
    # the c2r contract ignores the imaginary parts of the DC and (even n)
    # Nyquist bins (pocketfft/scipy behavior); the core's untangle path
    # would otherwise fold them into the output for non-Hermitian input
    rows.imag[:, 0] = 0.0
    if n % 2 == 0 and m > 1:
        rows.imag[:, m - 1] = 0.0
    y = _dft.irdft_rows(rows, tabs, static)
    return core._unrows(_scaled(y, scale), lead, axis)


# --------------------------------------------------------------------------
# 1-D public surface
# --------------------------------------------------------------------------


def _fft_1d(x, n, axis, norm, inverse, who) -> Tensor:
    x = _as_tensor(x)
    ax = _resolve_axis(x.n_dim, axis, who)
    nn = x.shape[ax] if n is None else int(n)
    v = _values_of(x)
    static, tabs = _dft.dft_plan(nn, v.device)
    scale = _norm_scale(norm, nn, forward=not inverse, who=who)
    with tracing.trace_op(who, 'op;transforms', tracing.tensor_args(x=x)):
        y = _c2c(v, static, tabs, nn, ax, inverse, scale)
    return _finish(y, None)


def fft(x, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None) -> Tensor:
    """Exact length-n DFT over ``axis`` (scipy.fft.fft semantics)."""
    return _fft_1d(x, n, axis, norm, inverse=False, who='tf.fft')


def ifft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None) -> Tensor:
    """Exact inverse DFT (scipy.fft.ifft semantics)."""
    return _fft_1d(x, n, axis, norm, inverse=True, who='tf.ifft')


def _real_values(x: Tensor, who: str) -> torch.Tensor:
    if x.dtype.is_complex:
        raise RuntimeError(f'{who}: expected a real input (scipy.fft '
                           'raises here too); use fft for complex input')
    return x.torch.to(torch.float32)


def _r2c_1d(x, n, axis, norm, conj_out, who) -> Tensor:
    x = _as_tensor(x)
    ax = _resolve_axis(x.n_dim, axis, who)
    nn = x.shape[ax] if n is None else int(n)
    v = _real_values(x, who)
    static, tabs = _dft.rdft_plan(nn, v.device)
    if conj_out:
        # ihfft: conj(rfft(x, n))/n under the backward norm
        scale = _norm_scale(norm, nn, forward=False, who=who) / nn
    else:
        scale = _norm_scale(norm, nn, forward=True, who=who)
    with tracing.trace_op(who, 'op;transforms', tracing.tensor_args(x=x)):
        y = _r2c(v, static, tabs, nn, ax, scale, conj_out)
    return _finish(y, None)


def rfft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None) -> Tensor:
    """Half-spectrum DFT of real input, out length n//2+1
    (scipy.fft.rfft semantics)."""
    return _r2c_1d(x, n, axis, norm, conj_out=False, who='tf.rfft')


def ihfft(x, n: Optional[int] = None, axis: int = -1,
          norm: Optional[str] = None) -> Tensor:
    """Inverse of hfft: conj(rfft(x, n))/n under the backward norm
    (np.fft.ihfft identity; scipy.fft.ihfft semantics)."""
    return _r2c_1d(x, n, axis, norm, conj_out=True, who='tf.ihfft')


def _c2r_1d(x, n, axis, norm, conj_in, forward_like, who) -> Tensor:
    x = _as_tensor(x)
    ax = _resolve_axis(x.n_dim, axis, who)
    if n is None:
        nn = 2 * (x.shape[ax] - 1)
        if nn < 1:
            raise RuntimeError(f'{who}: cannot infer the output length '
                               'from a length-1 input; pass n explicitly')
    else:
        nn = int(n)
    if nn < 1:
        raise RuntimeError(f'{who}: n ({nn}) must be >= 1')
    v = _values_of(x)
    static, tabs = _dft.rdft_plan(nn, v.device)
    # the engine's irdft carries 1/n; hfft (forward-like) wants the raw
    # sum under the backward norm -> fold n back in
    scale = _norm_scale(norm, nn, forward=forward_like, who=who)
    if forward_like:
        scale *= nn
    with tracing.trace_op(who, 'op;transforms', tracing.tensor_args(x=x)):
        y = _c2r(v, static, tabs, nn, ax, scale, conj_in)
    return _finish(y, None)


def irfft(x, n: Optional[int] = None, axis: int = -1,
          norm: Optional[str] = None) -> Tensor:
    """Inverse of rfft, real output of length n (default 2*(m-1);
    scipy.fft.irfft semantics: pass n for odd-length signals)."""
    return _c2r_1d(x, n, axis, norm, conj_in=False, forward_like=False,
                   who='tf.irfft')


def hfft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None) -> Tensor:
    """DFT of a Hermitian-symmetric signal given its half spectrum: real
    output of length n (scipy.fft.hfft = irfft(conj(x), n) * n)."""
    return _c2r_1d(x, n, axis, norm, conj_in=True, forward_like=True,
                   who='tf.hfft')


# --------------------------------------------------------------------------
# n-D wrappers: one 1-D transform per axis
# --------------------------------------------------------------------------


def _resolve_axes(ndim: int, s, axes, who: str):
    """(s, axes) pair resolution (the scipy.fft *n contract)."""
    if axes is None:
        if s is not None:
            axes = tuple(range(ndim - len(tuple(s)), ndim))
        else:
            axes = tuple(range(ndim))
    else:
        axes = tuple(int(a) for a in axes)
    axes = tuple(_resolve_axis(ndim, a, who) for a in axes)
    if len(set(axes)) != len(axes):
        raise RuntimeError(f'{who}: repeated axes {axes}')
    if s is not None:
        s = tuple(int(v) for v in s)
        if len(s) != len(axes):
            raise RuntimeError(f'{who}: s and axes have different lengths '
                               f'({len(s)} vs {len(axes)})')
    return s, axes


def _fftn_like(x, s, axes, norm, inverse, who) -> Tensor:
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, who)
    y = x
    for i, ax in enumerate(axes):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse, who)
    return y


def fftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """N-D DFT over ``axes`` (scipy.fft.fftn semantics)."""
    return _fftn_like(x, s, axes, norm, inverse=False, who='tf.fftn')


def ifftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """N-D inverse DFT (scipy.fft.ifftn semantics)."""
    return _fftn_like(x, s, axes, norm, inverse=True, who='tf.ifftn')


def fft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return fftn(x, s, axes, norm)


def ifft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return ifftn(x, s, axes, norm)


def rfftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """N-D DFT of real input: rfft over the last transform axis, then
    complex DFTs over the rest (scipy.fft.rfftn semantics)."""
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, 'tf.rfftn')
    n_last = s[-1] if s is not None else None
    y = rfft(x, n_last, axes[-1], norm)
    for i, ax in enumerate(axes[:-1]):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse=False, who='tf.rfftn')
    return y


def rfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return rfftn(x, s, axes, norm)


def irfftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """Inverse of rfftn (scipy.fft.irfftn semantics; pass s to pin the
    last-axis output length)."""
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, 'tf.irfftn')
    y = x
    for i, ax in enumerate(axes[:-1]):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse=True, who='tf.irfftn')
    n_last = s[-1] if s is not None else None
    return irfft(y, n_last, axes[-1], norm)


def irfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return irfftn(x, s, axes, norm)


def hfftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """N-D transform of Hermitian-symmetric input: forward DFTs over the
    leading axes, hfft over the last (scipy.fft.hfftn composition)."""
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, 'tf.hfftn')
    y = x
    for i, ax in enumerate(axes[:-1]):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse=False, who='tf.hfftn')
    n_last = s[-1] if s is not None else None
    return hfft(y, n_last, axes[-1], norm)


def hfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return hfftn(x, s, axes, norm)


def ihfftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """Inverse of hfftn (scipy.fft.ihfftn contract: ihfft over the last
    transform axis, inverse DFTs over the rest)."""
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, 'tf.ihfftn')
    n_last = s[-1] if s is not None else None
    y = ihfft(x, n_last, axes[-1], norm)
    for i, ax in enumerate(axes[:-1]):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse=True, who='tf.ihfftn')
    return y


def ihfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return ihfftn(x, s, axes, norm)


# --------------------------------------------------------------------------
# shifts and helpers
# --------------------------------------------------------------------------


def _shift_like(x, axes, sign: int, who: str) -> Tensor:
    x = _as_tensor(x)
    if axes is None:
        ax_list = tuple(range(x.n_dim))
    elif isinstance(axes, (int, np.integer)):
        ax_list = (_resolve_axis(x.n_dim, int(axes), who),)
    else:
        ax_list = tuple(_resolve_axis(x.n_dim, int(a), who) for a in axes)
    # fftshift rolls by +n//2, ifftshift by -(n//2) == +ceil(n/2)-n
    shifts = [(x.shape[a] // 2) if sign > 0 else -(x.shape[a] // 2) for a in ax_list]
    v = _values_of(x)
    with tracing.trace_op(who, 'op;transforms', tracing.tensor_args(x=x)):
        y = torch.roll(v, shifts, ax_list) if ax_list else v.clone()
    return _finish(y, None)


def fftshift(x, axes=None) -> Tensor:
    """Shift the zero-frequency bin to the center (scipy.fft.fftshift)."""
    return _shift_like(x, axes, +1, 'tf.fftshift')


def ifftshift(x, axes=None) -> Tensor:
    """Inverse of fftshift (scipy.fft.ifftshift)."""
    return _shift_like(x, axes, -1, 'tf.ifftshift')


def fftfreq(n: int, d: float = 1.0) -> Tensor:
    """DFT sample frequencies (scipy.fft.fftfreq signature, Tensor out)."""
    return _fftfreq(n, d)


def rfftfreq(n: int, d: float = 1.0) -> Tensor:
    return _rfftfreq(n, d)


def next_fast_len(target: int, real: bool = False) -> int:
    """Smallest length >= target that this engine transforms fastest.

    The FFT core is radix-2 (fourier/plan.py), so "fast" here means the
    next power of two, unlike scipy's 5-smooth answer; Bluestein covers
    every other length at a constant-factor cost. ``real`` is accepted for
    signature parity (pow2 is optimal for both paths)."""
    del real
    if target < 1:
        raise RuntimeError(f'next_fast_len: target ({target}) must be >= 1')
    return fft_plan.next_pow2(target)


def prev_fast_len(target: int, real: bool = False) -> int:
    """Largest fast (power-of-two) length <= target."""
    del real
    if target < 1:
        raise RuntimeError(f'prev_fast_len: target ({target}) must be >= 1')
    return 1 << (target.bit_length() - 1)


# --------------------------------------------------------------------------
# workers context (scipy.fft.set_workers/get_workers parity)
# --------------------------------------------------------------------------

_workers_local = threading.local()


def get_workers() -> int:
    """Current workers-context value (scipy.fft.get_workers parity;
    default 1). The transforms run on the tensor's device, whose runtime
    owns the parallelism, so the value is advisory: honored as the API
    contract, not a thread pool."""
    return getattr(_workers_local, 'value', 1)


@contextlib.contextmanager
def set_workers(workers: int):
    """Context manager mirroring scipy.fft.set_workers: everything inside
    sees ``get_workers() == workers``, so code written against scipy.fft
    ports over unchanged."""
    workers = int(workers)
    if workers == 0:
        raise RuntimeError('tf.set_workers: workers must not be zero')
    if workers < 0:
        # scipy parity: -1 means "all cpus", -2 all-but-one, ...; values
        # below -cpu_count are rejected (scipy.fft._pocketfft.helper)
        ncpu = os.cpu_count() or 1
        if workers < -ncpu:
            raise RuntimeError(
                f'tf.set_workers: workers ({workers}) exceeds the number '
                f'of available CPUs ({ncpu}); must be >= -{ncpu}'
            )
    prev = get_workers()
    _workers_local.value = workers
    try:
        yield
    finally:
        _workers_local.value = prev
