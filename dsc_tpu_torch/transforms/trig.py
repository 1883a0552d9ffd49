"""scipy.fft-parity DCT/DST: types 1-4, 1-D and n-D, all norms
(dsc_tpu/transforms/trig.py).

Every transform reduces to the tier's exact DFT engine (_dft.py: pow2
rides the FFT core, other lengths Bluestein): types I/II embed the signal
in a symmetric/antisymmetric extension and take one real FFT of length 2n
or 2(n±1); types III/IV pre-twiddle into a complex length-2n
positive-exponent DFT and read the answer off its real or imaginary part.
The twiddle tables are computed on the host in float64 at plan time and
uploaded once, complex64 on the input's device; the extension, twiddles,
boundary terms and norm scale are plain torch ops around the engine.

scipy.fft.dct/idct/dst/idst/dctn/idctn/dstn/idstn are the executable
spec, including the ``orthogonalize`` boundary-element sqrt(2) factors and
the backward/ortho/forward norms.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..fourier import core
from ..tensor import Tensor, _finish
from . import _dft
from .exact import _as_tensor, _resolve_axes, _resolve_axis, _values_of

__all__ = [
    'dct', 'idct', 'dst', 'idst',
    'dctn', 'idctn', 'dstn', 'idstn',
]

_NORMS = ('backward', 'ortho', 'forward')


def _logical_len(kind: str, type_: int, n: int) -> int:
    """The transform's natural denominator M (scipy's forward norm is
    1/M, ortho is sqrt(1/M)): 2(n-1) for DCT-I, 2(n+1) for DST-I, 2n
    for every other type."""
    if type_ == 1:
        return 2 * (n - 1) if kind == 'dct' else 2 * (n + 1)
    return 2 * n


def _trig_plan(kind: str, type_: int, n: int, device) -> Tuple[Tuple, Any]:
    """(static, tables) for a length-n DCT/DST of the given type over
    (B, n) rows on ``device``. static = (kind, type, n, inner-DFT static);
    tables = (inner tables, *twiddle tables)."""
    if type_ not in (1, 2, 3, 4):
        raise RuntimeError(f'{kind}: type {type_} is invalid (scipy.fft '
                           'defines types 1-4)')
    if n < 1:
        raise RuntimeError(f'{kind}: n ({n}) must be >= 1')
    if kind == 'dct' and type_ == 1 and n < 2:
        raise RuntimeError('dct: type I requires n >= 2 (scipy.fft '
                           'raises here too)')
    key = ('trig', kind, type_, n, str(device))
    hit = _dft._cache_get(key)
    if hit is not None:
        return hit
    m = _logical_len(kind, type_, n)
    k = np.arange(n, dtype=np.int64)
    if type_ in (1, 2):
        # real symmetric/antisymmetric extension -> one real FFT
        istatic, itabs = _dft.rdft_plan(m, device)
        if type_ == 2:
            # post-twiddle exp(-i*pi*(k + dst)/ (2n)); DST-II reads
            # bins 1..n so its table is indexed k+1
            off = 0 if kind == 'dct' else 1
            red = np.mod(k + off, 4 * n).astype(np.float64)
            tw = np.exp(-1j * np.pi * red / (2 * n))
            tabs = (itabs, _dft.upload(tw, device))
        else:
            tabs = (itabs,)
    else:
        # complex pre-twiddled positive-exponent DFT of length 2n
        istatic, itabs = _dft.dft_plan(m, device)
        if type_ == 3:
            off = 0 if kind == 'dct' else 1
            pre = np.exp(1j * np.pi * (k + off).astype(np.float64) / (2 * n))
            tabs = (itabs, _dft.upload(pre, device))
        else:
            pre = np.exp(1j * np.pi * (2 * k + 1).astype(np.float64) / (4 * n))
            post = np.exp(1j * np.pi * k.astype(np.float64) / (2 * n))
            tabs = (itabs, _dft.upload(pre, device), _dft.upload(post, device))
    entry = ((kind, type_, n, istatic), tabs)
    _dft._cache_put(key, entry)
    return entry


def _trig_rows(x: torch.Tensor, tabs: Any, static: Tuple) -> torch.Tensor:
    """(B, n) float32 rows -> (B, n) unnormalized scipy 'backward'
    DCT/DST."""
    kind, type_, n, istatic = static
    if type_ == 1:
        (itabs,) = tabs
        if kind == 'dct':
            # even extension [x, x[n-2:0:-1]] of length 2(n-1)
            ext = torch.cat([x, x[:, 1:n - 1].flip(1)], dim=1)
            return _dft.rdft_rows(ext, itabs, istatic).real[:, :n]
        # odd extension [0, x, 0, -rev(x)] of length 2(n+1)
        z = torch.zeros_like(x[:, :1])
        ext = torch.cat([z, x, z, -x.flip(1)], dim=1)
        return -_dft.rdft_rows(ext, itabs, istatic).imag[:, 1:n + 1]
    if type_ == 2:
        itabs, tw = tabs
        if kind == 'dct':
            ext = torch.cat([x, x.flip(1)], dim=1)
            return (_dft.rdft_rows(ext, itabs, istatic)[:, :n] * tw).real
        ext = torch.cat([x, -x.flip(1)], dim=1)
        # y = -Im(tw * F[k+1])
        return -(_dft.rdft_rows(ext, itabs, istatic)[:, 1:n + 1] * tw).imag
    m = 2 * n
    if type_ == 3:
        itabs, pre = tabs
        c = x * pre
        if kind == 'dst':
            # the twiddled sequence lives at positions 1..n of the
            # length-2n input (m - n - 1 zeros after it; m = 2n > n)
            c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
        s = _dft.dft_rows(core._pad_crop(c, m), itabs, istatic, inverse=True) * m
        if kind == 'dct':
            return 2.0 * s.real[:, :n] - x[:, :1]
        sgn = (1 - 2 * (torch.arange(n, device=x.device) % 2)).to(x.dtype)
        return 2.0 * s.imag[:, :n] - sgn * x[:, n - 1:n]
    itabs, pre, post = tabs
    s = _dft.dft_rows(core._pad_crop(x * pre, m), itabs, istatic, inverse=True)[:, :n] * m
    q = post * s
    return 2.0 * (q.real if kind == 'dct' else q.imag)


def _trig_prog(x: torch.Tensor, tabs: Any, static: Tuple, n: int, axis: int,
               scale: float, ortho: bool) -> torch.Tensor:
    """Fit to n, the orthogonalize input factor, the transform, the
    orthogonalize output factor and the norm scale."""
    kind, type_, _, _ = static
    x, lead = core._rows(x, axis, n)
    r2 = math.sqrt(2.0)
    if ortho and ((kind == 'dct' and type_ == 1) or type_ == 3):
        # input-side boundary factors (scipy ``orthogonalize``):
        # DCT-I: x[0], x[-1] *= sqrt2; DCT-III: x[0] *= sqrt2;
        # DST-III: x[-1] *= sqrt2
        x = x.clone()
        if type_ == 1:
            x[:, 0] *= r2
            x[:, -1] *= r2
        else:
            x[:, 0 if kind == 'dct' else n - 1] *= r2
    y = _trig_rows(x, tabs, static)
    if ortho and ((kind == 'dct' and type_ == 1) or type_ == 2):
        # output-side: DCT-I: y[0], y[-1] /= sqrt2; DCT-II: y[0] /=
        # sqrt2; DST-II: y[-1] /= sqrt2
        y = y.clone()
        if type_ == 1:
            y[:, 0] *= 1.0 / r2
            y[:, -1] *= 1.0 / r2
        else:
            y[:, 0 if kind == 'dct' else n - 1] *= 1.0 / r2
    if scale != 1.0:
        y = y * scale
    return core._unrows(y, lead, axis)


def _trig_scale(kind: str, type_: int, n: int, norm: Optional[str],
                inverse: bool, who: str) -> float:
    if norm is None:
        norm = 'backward'
    if norm not in _NORMS:
        raise RuntimeError(f"{who}: invalid norm {norm!r} (use "
                           "'backward', 'ortho' or 'forward')")
    m = _logical_len(kind, type_, n)
    if norm == 'ortho':
        return 1.0 / math.sqrt(m)
    forward_scaled = (norm == 'forward') != inverse
    return 1.0 / m if forward_scaled else 1.0


_INV_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


def _trig_1d(x, kind, type_, n, axis, norm, orthogonalize, inverse,
             who) -> Tensor:
    type_ = int(type_)
    x = _as_tensor(x)
    ax = _resolve_axis(x.n_dim, axis, who)
    nn = x.shape[ax] if n is None else int(n)
    eff_type = _INV_TYPE[type_] if inverse else type_
    if orthogonalize is None:
        orthogonalize = (norm == 'ortho')
    scale = _trig_scale(kind, eff_type, nn, norm, inverse, who)
    v = _values_of(x)
    static, tabs = _trig_plan(kind, eff_type, nn, v.device)
    args = (tabs, static, nn, ax, scale, bool(orthogonalize))
    with tracing.trace_op(who, 'op;transforms', tracing.tensor_args(x=x)):
        if v.is_complex():
            # the real and imaginary parts transform apart
            y = torch.complex(_trig_prog(v.real, *args), _trig_prog(v.imag, *args))
        else:
            y = _trig_prog(v, *args)
    return _finish(y, None)


def dct(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None,
        orthogonalize: Optional[bool] = None) -> Tensor:
    """Discrete cosine transform, types I-IV (scipy.fft.dct
    semantics incl. norm and orthogonalize)."""
    return _trig_1d(x, 'dct', type, n, axis, norm, orthogonalize,
                    inverse=False, who='tf.dct')


def idct(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None,
         orthogonalize: Optional[bool] = None) -> Tensor:
    """Inverse DCT: the type-(1,3,2,4) transform with the backward
    1/M scale (scipy.fft.idct semantics)."""
    return _trig_1d(x, 'dct', type, n, axis, norm, orthogonalize,
                    inverse=True, who='tf.idct')


def dst(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None,
        orthogonalize: Optional[bool] = None) -> Tensor:
    """Discrete sine transform, types I-IV (scipy.fft.dst semantics)."""
    return _trig_1d(x, 'dst', type, n, axis, norm, orthogonalize,
                    inverse=False, who='tf.dst')


def idst(x, type: int = 2, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None,
         orthogonalize: Optional[bool] = None) -> Tensor:
    """Inverse DST (scipy.fft.idst semantics)."""
    return _trig_1d(x, 'dst', type, n, axis, norm, orthogonalize,
                    inverse=True, who='tf.idst')


def _trig_nd(x, kind, type_, s, axes, norm, orthogonalize, inverse,
             who) -> Tensor:
    x = _as_tensor(x)
    s_r, axes_r = _resolve_axes(x.n_dim, s, axes, who)
    fn = {('dct', False): dct, ('dct', True): idct,
          ('dst', False): dst, ('dst', True): idst}[(kind, inverse)]
    y = x
    for i, ax in enumerate(axes_r):
        nn = s_r[i] if s_r is not None else None
        y = fn(y, type=type_, n=nn, axis=ax, norm=norm,
               orthogonalize=orthogonalize)
    return y


def dctn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None,
         orthogonalize: Optional[bool] = None) -> Tensor:
    """n-D DCT over ``axes`` (scipy.fft.dctn semantics)."""
    return _trig_nd(x, 'dct', type, s, axes, norm, orthogonalize,
                    inverse=False, who='tf.dctn')


def idctn(x, type: int = 2, s=None, axes=None,
          norm: Optional[str] = None,
          orthogonalize: Optional[bool] = None) -> Tensor:
    """n-D inverse DCT (scipy.fft.idctn semantics)."""
    return _trig_nd(x, 'dct', type, s, axes, norm, orthogonalize,
                    inverse=True, who='tf.idctn')


def dstn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None,
         orthogonalize: Optional[bool] = None) -> Tensor:
    """n-D DST over ``axes`` (scipy.fft.dstn semantics)."""
    return _trig_nd(x, 'dst', type, s, axes, norm, orthogonalize,
                    inverse=False, who='tf.dstn')


def idstn(x, type: int = 2, s=None, axes=None,
          norm: Optional[str] = None,
          orthogonalize: Optional[bool] = None) -> Tensor:
    """n-D inverse DST (scipy.fft.idstn semantics)."""
    return _trig_nd(x, 'dst', type, s, axes, norm, orthogonalize,
                    inverse=True, who='tf.idstn')
