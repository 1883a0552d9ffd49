"""The dsc_tpu_torch Tensor: a NumPy-compatible tensor over one torch.Tensor
(dsc_tpu/tensor.py).

What the reference tensor layer (dsc/src/dsc.cpp:342-1953,
python/dsc/tensor.py) makes observable:

- four dtypes and max rank 4 (dsc.h:72-76)
- views share storage: ``reshape``, ``view``, same-dtype ``cast``,
  ``conj``/``real`` of real input and ``out=`` results all write through
  to every other view of the buffer (dsc.cpp:599-636)
- basic indexing (ints and slices) returns copies (dsc.h:238-243), and a
  1-element result unwraps to a Python scalar (python/dsc/tensor.py:91-103);
  ``__setitem__`` writes in place and cycles a right-hand side that does not
  broadcast modulo its size (dsc.cpp:1032-1040)
- NumPy's protocols, where the JAX package's Tensor has none: ``np.asarray(t)``
  downloads as ``t.numpy()`` does, an index past an axis raises
  ``TensorIndexError`` (a RuntimeError, as the reference's, and an
  IndexError, so that ``list(t)`` and ``iter(t)`` end), and NumPy's operators
  and ufuncs defer to the Tensor's own (``ndarray + t`` is a Tensor)
- binary ops follow the reference promotion table, including the Python
  scalar rule (tensor.py:435-456: int/float -> F32, complex -> C32)
- unary ops, clip, pow and the reductions (defaults axis=-1,
  keepdims=True; keepdims=False on 1-D input gives shape (1,))
- the creation set (arange, full, ones, zeros, empty and the ``*_like``
  forms) and the layout ops (cast, concat, transpose)

Every tensor lives on the context's device (``dsc.init(..., device=)``).
The compute is ``ops/kernels.py``; its large float32 and complex64 ops run
kernel K5 (``ops/stream_map.py``).

A spectrum that a single-vector fft or rfft returns is stored in the T
layout (``_Buffer.layout``, fourier/stream_t.py), as the JAX package's
``Planar.fourstep`` is: add/sub/mul/div (and pow on the full layout) of two
such tensors of one layout, or of one and a Python scalar, and ``conj``
compute on the stored values and keep the layout (dsc_tpu
planar.binary_pp/binary_ps); the half-T layout keeps only real scalars and
add/sub/mul/div, which leave a spectrum Hermitian. Any other read goes
through ``Tensor.torch``, which turns the buffer into natural order in
place the first time; ``numpy()`` reads a natural copy and leaves the
layout alone.
"""

from __future__ import annotations

import math
import weakref
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import capture, interop, tracing
from .context import _get_ctx, device as _device
from .dtype import DTYPE_TO_NP, Dtype, ScalarType, np_to_dtype, promote, scalar_dtype
from .interop import DTYPE_OF_TORCH, TORCH_DTYPE
from .ops import kernels as K

DSC_MAX_DIMS = 4  # reference dsc.h:72-76

TensorType = Union['Tensor', np.ndarray]


def _logical_shape(layout) -> Tuple[int, ...]:
    n1, n2, half = layout
    return (n1 * n2 // 2 + 1,) if half else (n1 * n2,)


def _no_free() -> None:
    pass


# set by utils.debug.nan_guard: called on every op's output
_nan_check = None


class _Buffer:
    """Refcounted-buffer equivalent (reference dsc_tensor_buffer): owns one
    torch tensor and registers its bytes with the context's accounting.

    ``layout`` is None for natural order, or (n1, n2, half) for a spectrum
    X stored as S (n1, n2), or (n1, n2/2 + 1) with ``half``, with
    X[k1 + n1*k2] = S[k1, k2] (fourier/stream_t.py)."""

    __slots__ = ('data', 'nbytes', 'layout', '_free', '__weakref__')

    def __init__(self, data: torch.Tensor, layout=None):
        self.data = data
        self.layout = layout
        self._account()

    def _account(self) -> None:
        nbytes = self.data.numel() * self.data.element_size()
        self.nbytes = nbytes
        if capture.untracked():
            # a compiled function's tensors and dsc.map's pseudo-tensors
            self._free = _no_free
            return
        ctx = _get_ctx()
        ctx.alloc(nbytes)
        self._free = weakref.finalize(self, ctx.free, nbytes)

    def natural(self) -> torch.Tensor:
        """The values in natural order: the data itself, or a natural copy
        of a T layout's S."""
        if self.layout is None:
            return self.data
        m = _logical_shape(self.layout)[0]
        return self.data.t().reshape(-1)[:m].contiguous()

    def materialize(self) -> None:
        """Natural order in place of a T layout (the JAX package's
        Planar.materialize, which keeps its planes beside the copy)."""
        if self.layout is None:
            return
        self.data = self.natural()
        self.layout = None
        self._free()
        self._account()


class Tensor:
    __slots__ = ('_buf', '_shape', '_dtype')

    def __init__(self, data, dtype: Optional[Dtype] = None):
        """A Tensor copied in from ``data`` (an array, a torch tensor or
        anything ``np.asarray`` takes), cast to ``dtype`` if given, as
        ``from_numpy`` does; from a Tensor, a view of it (dsc_tpu
        tensor.py:91-119)."""
        if isinstance(data, Tensor):
            self._buf, self._shape, self._dtype = data._buf, data._shape, data._dtype
            return
        if isinstance(data, torch.Tensor):
            if dtype is not None:
                data = K.cast(data, TORCH_DTYPE[dtype])
            if data.dtype not in DTYPE_OF_TORCH:
                raise RuntimeError(f'cannot create a Tensor of dtype {data.dtype}')

            def make():
                return Tensor._from_torch(data.to(_device(), copy=True))
        else:
            host = np.asarray(data)
            if dtype is not None:
                host = host.astype(DTYPE_TO_NP[dtype])
            np_to_dtype(host.dtype)  # raises on dtypes outside the four

            def make():
                return Tensor._from_torch(interop.put(host))
        t = capture.created(make)
        self._buf, self._shape, self._dtype = t._buf, t._shape, t._dtype

    @classmethod
    def _from_torch(cls, data: torch.Tensor) -> 'Tensor':
        if data.dim() > DSC_MAX_DIMS:
            raise RuntimeError(
                f'cannot create a Tensor with {data.dim()} dimensions, '
                f'max is {DSC_MAX_DIMS}')
        data = data.contiguous()
        if data.data_ptr() % 16:
            # an offset view: the kernels take 16-byte aligned data
            data = data.clone()
        if _nan_check is not None:
            _nan_check(data)
        t = cls.__new__(cls)
        t._buf = _Buffer(data)
        t._shape = tuple(data.shape)
        t._dtype = DTYPE_OF_TORCH[data.dtype]
        return t

    @classmethod
    def _from_t(cls, storage: torch.Tensor, n1: int, n2: int, half: bool) -> 'Tensor':
        """The C32 spectrum whose T-layout storage is ``storage`` (n1, n2),
        or (n1, n2/2 + 1) with ``half``; its shape is (n,), or (n/2 + 1,)."""
        layout = (n1, n2, half)
        cols = n2 // 2 + 1 if half else n2
        if storage.dtype != torch.complex64 or tuple(storage.shape) != (n1, cols):
            raise RuntimeError(f'T layout {layout}: expected complex64 {(n1, cols)}, '
                               f'got {storage.dtype} {tuple(storage.shape)}')
        if _nan_check is not None:
            _nan_check(storage)
        t = cls.__new__(cls)
        t._buf = _Buffer(storage.contiguous(), layout)
        t._shape = _logical_shape(layout)
        t._dtype = Dtype.C32
        return t

    def _copy(self) -> 'Tensor':
        """A Tensor of this shape, dtype and layout over a copy of the
        buffer."""
        t = Tensor.__new__(Tensor)
        t._buf = _Buffer(self._buf.data.clone(), self._buf.layout)
        t._shape, t._dtype = self._shape, self._dtype
        return t

    @classmethod
    def _view_of(cls, base: 'Tensor', shape: Tuple[int, ...]) -> 'Tensor':
        t = cls.__new__(cls)
        t._buf = base._buf
        t._shape = tuple(shape)
        t._dtype = base._dtype
        return t

    # -- data access --------------------------------------------------------

    @property
    def torch(self) -> torch.Tensor:
        """The storage, viewed in this tensor's shape (no copy); a buffer in
        a T layout turns into natural order first, in place."""
        self._buf.materialize()
        return self._buf.data.view(self._shape)

    @property
    def _layout(self):
        """(n1, n2, half) when this tensor is a whole spectrum stored in a T
        layout (its shape is the layout's logical one), else None: a
        reshaped view reads natural order."""
        layout = self._buf.layout
        if layout is None or self._shape != _logical_shape(layout):
            return None
        return layout

    @property
    def _stored(self) -> torch.Tensor:
        """The buffer's values as stored: S when ``_layout`` is set."""
        return self._buf.data

    @property
    def device(self) -> torch.device:
        return self._buf.data.device

    @property
    def dtype(self) -> Dtype:
        return self._dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def n_dim(self) -> int:
        return len(self._shape)

    @property
    def ne(self) -> int:
        return int(math.prod(self._shape))

    def __len__(self) -> int:
        return self._shape[0]

    def __str__(self) -> str:
        return str(self.numpy())

    def __repr__(self) -> str:
        return f'Tensor(dtype={self._dtype}, shape={self._shape})\n{self.numpy()}'

    def numpy(self) -> np.ndarray:
        capture.check_concrete('Tensor.numpy()')
        # a natural copy of a T layout; the buffer keeps its layout
        return interop.get(self._buf.natural().view(self._shape))

    def __bytes__(self) -> bytes:
        return self.numpy().tobytes()

    def tobytes(self) -> bytes:
        return bytes(self)

    # NumPy's protocols: a download, and its operators defer to the Tensor's
    __array_ufunc__ = None

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        if copy is False:
            raise ValueError('a Tensor becomes a NumPy array only by a copy to the host')
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)

    def cast(self, dtype: Dtype) -> 'Tensor':
        return cast(self, dtype)

    def reshape(self, *shape) -> 'Tensor':
        return reshape(self, *shape)

    def transpose(self, axes=None) -> 'Tensor':
        return transpose(self, axes)

    # -- indexing (reference tensor.py:193-267, dsc.cpp:829-1169) ------------

    def __getitem__(self, item):
        key = _normalize_key(item, self._shape)
        with tracing.trace_op('get', 'op;indexing', tracing.tensor_args(x=self)):
            res = _index(self.torch, key)
        if res.numel() == 1:
            # any 1-element result unwraps (python/dsc/tensor.py:91-103)
            capture.check_concrete('the 1-element unwrap of __getitem__')
            v = res.reshape(()).item()
            return complex(v) if self._dtype.is_complex else float(v)
        return Tensor._from_torch(res)

    def __setitem__(self, key, value):
        nkey = _normalize_key(key, self._shape)
        vals = _value_for_set(value, self)
        with tracing.trace_op('set', 'op;indexing', tracing.tensor_args(x=self)):
            _set(self.torch, nkey, vals)

    # -- operator protocol (reference tensor.py:269-297) ---------------------

    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(other, self)

    def __sub__(self, other):
        return sub(self, other)

    def __rsub__(self, other):
        return sub(other, self)

    def __mul__(self, other):
        return mul(self, other)

    def __rmul__(self, other):
        return mul(other, self)

    def __truediv__(self, other):
        return true_div(self, other)

    def __rtruediv__(self, other):
        return true_div(other, self)

    def __pow__(self, other):
        return power(self, other)

    def __rpow__(self, other):
        return power(other, self)


# ---------------------------------------------------------------------------
# indexing helpers
# ---------------------------------------------------------------------------


class TensorIndexError(IndexError, RuntimeError):
    """An integer index past its axis: the RuntimeError the JAX package
    raises, and an IndexError, which ends Python's sequence iteration."""


def _normalize_key(item, shape):
    if isinstance(item, (int, np.integer, slice)):
        item = (item,)
    if not isinstance(item, tuple):
        raise RuntimeError(f'cannot index Tensor with object {item}')
    if len(item) > len(shape):
        raise RuntimeError(
            f'too many indices for Tensor with {len(shape)} dimensions')
    out = []
    for i, k in enumerate(item):
        if isinstance(k, (int, np.integer)):
            dim = shape[i]
            k = int(k)
            # negative wrap (reference dsc.cpp:839-846)
            kk = k + dim if k < 0 else k
            if kk < 0 or kk >= dim:
                raise TensorIndexError(
                    f'index {k} is out of bounds for axis {i} with size {dim}')
            out.append(kk)
        elif isinstance(k, slice):
            out.append(k)
        else:
            raise RuntimeError(f'cannot index Tensor with object {k}')
    return tuple(out)


def _index(t: torch.Tensor, key) -> torch.Tensor:
    """numpy basic indexing; torch slices take no negative step, so those
    axes gather their indices instead."""
    for ax in reversed(range(len(key))):
        k = key[ax]
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            idx = torch.arange(*k.indices(t.shape[ax]), device=t.device)
            with tracing.trace_op('index_select', 'plain;indexing'):
                t = t.index_select(ax, idx)
            key = key[:ax] + (slice(None),) + key[ax + 1:]
    with tracing.trace_op('index', 'plain;indexing'):
        return t[key].clone()


def _value_for_set(value, target: 'Tensor') -> torch.Tensor:
    """The right-hand side of ``target[key] = value`` in the target's dtype
    (reference _wrap, tensor.py:121-150: values are cast to the tensor's
    dtype), never a view of the target's own buffer."""
    tdt = TORCH_DTYPE[target.dtype]
    if isinstance(value, Tensor):
        v = K.cast(value.torch, tdt)
        return v.clone() if value._buf is target._buf else v
    np_dt = DTYPE_TO_NP[target.dtype]
    host = value.astype(np_dt) if isinstance(value, np.ndarray) else np.asarray(value, np_dt)
    if host.ndim == 0:
        # a fill, not an upload: a CUDA graph can capture it
        return torch.full((), host.item(), dtype=tdt, device=target.device)
    return interop.put(host, target.torch.device)


def _set(t: torch.Tensor, key, v: torch.Tensor) -> None:
    """``t[key] = v`` in place for a basic-indexing key: ``v`` broadcasts to
    the region, or else is cycled over it in C order (reference tensor_set,
    dsc.cpp:1032-1040). torch slices take no negative step, so such an axis
    is written through the same elements in ascending order, flipped."""
    pos_key, flips, out_ax = [], [], 0
    for ax, k in enumerate(key):
        if isinstance(k, slice):
            start, stop, step = k.indices(t.shape[ax])
            if step < 0:
                cnt = len(range(start, stop, step))
                k = slice(start + step * (cnt - 1), start + 1, -step) if cnt else slice(0, 0)
                flips.append(out_ax)
            out_ax += 1
        pos_key.append(k)
    region = t[tuple(pos_key)]
    try:
        vals = torch.broadcast_to(v, region.shape)
    except RuntimeError:
        flat = v.reshape(-1)
        n = region.numel()
        vals = flat.repeat(-(-n // flat.numel()))[:n].reshape(region.shape)
    region.copy_(vals.flip(flips) if flips else vals)


# ---------------------------------------------------------------------------
# binary ops (reference dsc.cpp:1247-1310, tensor.py:435-456)
# ---------------------------------------------------------------------------


def _operand_dtype(x) -> Dtype:
    if isinstance(x, Tensor):
        return x.dtype
    if isinstance(x, np.ndarray):
        return np_to_dtype(x.dtype)
    if isinstance(x, (bool, int, float, complex, np.number)):
        return scalar_dtype(complex(x) if np.iscomplexobj(x) else x)
    raise RuntimeError(f'cannot wrap object {x!r} as a Tensor')


def _operand(x, dtype: Dtype):
    """Tensor operand -> torch tensor in ``dtype``; Python scalars stay
    scalars (torch applies them in the tensor's dtype, as the reference's
    1-element wrap does)."""
    if isinstance(x, np.ndarray):
        x = from_numpy(x)
    if isinstance(x, Tensor):
        return x.torch.to(TORCH_DTYPE[dtype])
    if dtype.is_complex:
        return complex(x)
    return float(x)


def _can_broadcast(sa, sb) -> bool:
    """Right-aligned dims equal or 1 (reference dsc.cpp:1174-1184)."""
    for da, db in zip(reversed(sa), reversed(sb)):
        if da != db and da != 1 and db != 1:
            return False
    return True


def _shape_of(x):
    return x.shape if isinstance(x, (Tensor, np.ndarray)) else ()


def _finish(res: torch.Tensor, out: Optional[Tensor]) -> Tensor:
    """A fresh tensor, or ``res`` written into ``out`` and a view of it
    returned (reference tensor.py:423-432)."""
    if out is None:
        return Tensor._from_torch(res)
    if tuple(res.shape) != out.shape:
        raise RuntimeError(
            f'out tensor has shape {out.shape}, expected {tuple(res.shape)}')
    if DTYPE_OF_TORCH[res.dtype] != out.dtype:
        raise RuntimeError(
            f'out tensor has dtype {out.dtype}, '
            f'expected {DTYPE_OF_TORCH[res.dtype]}')
    out.torch.copy_(res)
    return Tensor._view_of(out, out.shape)


# ops that keep a Hermitian spectrum Hermitian (dsc_tpu planar._herm_preserved)
_HERMITIAN_OPS = ('add', 'sub', 'mul', 'div')


def _binary_in_layout(xa, xb, name: str) -> Optional[Tensor]:
    """``xa <name> xb`` on the stored values of T-layout spectra, the result
    in the same layout (dsc_tpu planar.binary_pp/binary_ps): two operands of
    one layout, or one and a Python scalar. None where the rule does not
    apply and the op reads natural order."""
    la = xa._layout if isinstance(xa, Tensor) else None
    lb = xb._layout if isinstance(xb, Tensor) else None
    layout = la or lb
    if layout is None:
        return None
    half = layout[2]
    if la is not None and lb is not None:
        if la != lb or (half and name not in _HERMITIAN_OPS):
            return None
        a, b = xa._stored, xb._stored
    else:
        s = xb if la is not None else xa
        if isinstance(s, (bool, int, float, np.floating, np.integer)):
            s = complex(float(s), 0.0)
        elif isinstance(s, (complex, np.complexfloating)):
            s = complex(s)
        else:
            return None
        if half and (s.imag != 0 or name not in _HERMITIAN_OPS):
            return None
        a, b = (xa._stored, s) if la is not None else (s, xb._stored)
    args = tracing.tensor_args(xa=xa if isinstance(xa, Tensor) else None,
                               xb=xb if isinstance(xb, Tensor) else None)
    with tracing.trace_op(name, 'op;binary', args):
        res = K.binary(name, a, b)
    return Tensor._from_t(res, *layout)


def _binary_op(xa, xb, out: Optional[Tensor], name: str) -> Tensor:
    if not isinstance(xa, (Tensor, np.ndarray)) and not isinstance(
            xb, (Tensor, np.ndarray)):
        raise RuntimeError(f'{name}: at least one operand must be a Tensor')
    if out is None:
        res = _binary_in_layout(xa, xb, name)
        if res is not None:
            return res
    sa, sb = _shape_of(xa), _shape_of(xb)
    if not _can_broadcast(sa, sb):
        raise RuntimeError(f'cannot broadcast {sa} and {sb}')
    out_dtype = promote(_operand_dtype(xa), _operand_dtype(xb))
    args = tracing.tensor_args(xa=xa if isinstance(xa, Tensor) else None,
                               xb=xb if isinstance(xb, Tensor) else None)
    with tracing.trace_op(name, 'op;binary', args):
        res = K.binary(name, _operand(xa, out_dtype), _operand(xb, out_dtype))
    return _finish(res, out)


def add(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'add')


def sub(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'sub')


def mul(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'mul')


def true_div(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'div')


def power(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'pow')


# ---------------------------------------------------------------------------
# unary ops (reference dsc.cpp:1312-1769)
# ---------------------------------------------------------------------------


def _unary_op(x: Tensor, out: Optional[Tensor], name: str, fn) -> Tensor:
    with tracing.trace_op(name, 'op;unary', tracing.tensor_args(x=x)):
        res = fn(x.torch)
    return _finish(res, out)


def _unary_fn(name: str):
    return lambda data: K.unary(name, data)


def cos(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'cos', _unary_fn('cos'))


def sin(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'sin', _unary_fn('sin'))


def sinc(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'sinc', _unary_fn('sinc'))


def logn(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'logn', _unary_fn('logn'))


def log2(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'log2', _unary_fn('log2'))


def log10(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'log10', _unary_fn('log10'))


def exp(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'exp', _unary_fn('exp'))


def sqrt(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'sqrt', _unary_fn('sqrt'))


def absolute(x: Tensor, out: Optional[Tensor] = None) -> Tensor:
    return _unary_op(x, out, 'abs', K.absolute)


def angle(x: Tensor) -> Tensor:
    return _unary_op(x, None, 'angle', K.angle)


def conj(x: Tensor) -> Tensor:
    # a view of real input (reference dsc.cpp:1543-1560)
    if x.dtype.is_real:
        return Tensor._view_of(x, x.shape)
    layout = x._layout
    if layout is not None:
        # conj keeps a spectrum's layout, and a Hermitian one Hermitian
        with tracing.trace_op('conj', 'op;unary', tracing.tensor_args(x=x)):
            res = K.conj(x._stored)
        return Tensor._from_t(res, *layout)
    return _unary_op(x, None, 'conj', K.conj)


def real(x: Tensor) -> Tensor:
    # a view of real input (reference dsc.cpp:1562-1594)
    if x.dtype.is_real:
        return Tensor._view_of(x, x.shape)
    return _unary_op(x, None, 'real', lambda data: data.real)


def imag(x: Tensor) -> Tensor:
    if x.dtype.is_real:
        # np.imag(real) == zeros (reference dsc.cpp:1596-1622)
        return _unary_op(x, None, 'imag', torch.zeros_like)
    return _unary_op(x, None, 'imag', lambda data: data.imag)


def i0(x, dtype: Dtype = Dtype.F32) -> Tensor:
    x = _wrap(x, dtype)
    if x.dtype.is_complex:
        raise RuntimeError('i0 is defined for real tensors only')
    return _unary_op(x, None, 'i0', K.i0)


def clip(x: Tensor, x_min: Optional[float] = None, x_max: Optional[float] = None,
         out: Optional[Tensor] = None) -> Tensor:
    lo = x_min if x_min is not None else float('-inf')
    hi = x_max if x_max is not None else float('inf')
    with tracing.trace_op('clip', 'op;unary', tracing.tensor_args(x=x)):
        res = K.clip(x.torch, lo, hi)
    return _finish(res, out)


# ---------------------------------------------------------------------------
# reductions (reference dsc.cpp:1771-1953; defaults axis=-1, keepdims=True
# per dsc.h:358-380)
# ---------------------------------------------------------------------------


def _reduce_op(x: Tensor, out, axis: int, keepdims: bool, name: str, fn) -> Tensor:
    nd = x.n_dim
    ax = axis + nd if axis < 0 else axis
    if ax < 0 or ax >= nd:
        raise RuntimeError(f'axis {axis} is out of bounds for a {nd}-D tensor')
    with tracing.trace_op(name, 'op;reduction', tracing.tensor_args(x=x)):
        res = fn(x.torch, ax, keepdims)
    if res.dim() == 0:
        # keepdims=False on 1-D input: the reference leaves this broken
        # ("Fixme", dsc.cpp:1798-1799); a 1-element 1-D tensor, as dsc_tpu
        res = res.reshape(1)
    return _finish(res, out)


def sum(x: Tensor, out=None, axis: int = -1, keepdims: bool = True) -> Tensor:  # noqa: A001
    return _reduce_op(x, out, axis, keepdims, 'sum', K.reduce_sum)


def mean(x: Tensor, out=None, axis: int = -1, keepdims: bool = True) -> Tensor:
    return _reduce_op(x, out, axis, keepdims, 'mean', K.reduce_mean)


def max(x: Tensor, out=None, axis: int = -1, keepdims: bool = True) -> Tensor:  # noqa: A001
    return _reduce_op(x, out, axis, keepdims, 'max', K.reduce_max)


def min(x: Tensor, out=None, axis: int = -1, keepdims: bool = True) -> Tensor:  # noqa: A001
    return _reduce_op(x, out, axis, keepdims, 'min', K.reduce_min)


# ---------------------------------------------------------------------------
# creation + layout
# ---------------------------------------------------------------------------


def _check_shape(shape) -> None:
    if len(shape) > DSC_MAX_DIMS or len(shape) < 1:
        raise RuntimeError(
            f'cannot create a Tensor with {len(shape)} dimensions, '
            f'max is {DSC_MAX_DIMS}')


def from_numpy(x: np.ndarray) -> Tensor:
    np_to_dtype(x.dtype)  # raises on dtypes outside the four
    _check_shape(x.shape)
    return capture.created(lambda: Tensor._from_torch(interop.put(x)))


def _wrap(x, dtype: Dtype) -> Tensor:
    """A Tensor as it is, an array uploaded, a Python scalar as a
    1-element tensor of ``dtype``'s kind (dsc_tpu tensor._wrap: F64 and the
    complex dtypes keep their width, everything else is F32)."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, np.ndarray):
        return from_numpy(x)
    if isinstance(x, complex):
        dt = Dtype.C64 if dtype == Dtype.C64 else Dtype.C32
    elif isinstance(x, (bool, int, float, np.floating, np.integer)):
        dt = dtype if dtype in (Dtype.F64, Dtype.C32, Dtype.C64) else Dtype.F32
    else:
        raise RuntimeError(f'cannot wrap object {x!r} as a Tensor')
    return from_numpy(np.asarray([x], DTYPE_TO_NP[dt]))


def arange(n: int, dtype: Dtype = Dtype.F32) -> Tensor:
    def make():
        with tracing.trace_op('arange', 'op;creation', {'n': n}):
            return Tensor._from_torch(K.arange(n, TORCH_DTYPE[dtype], _device()))

    return capture.created(make)


def randn(*shape: int, dtype: Dtype = Dtype.F32) -> Tensor:
    """Standard normal samples from the context's seeded generator."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    _check_shape(shape)
    ctx = _get_ctx()

    def make():
        host = torch.randn(shape, generator=ctx.generator, dtype=TORCH_DTYPE[dtype])
        return Tensor._from_torch(host.to(_device()))

    return capture.created(make)


def full(shape, fill_value: ScalarType, dtype: Dtype = Dtype.F32) -> Tensor:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    _check_shape(shape)

    def make():
        with tracing.trace_op('full', 'op;creation', {'shape': list(shape)}):
            return Tensor._from_torch(
                K.full(shape, fill_value, TORCH_DTYPE[dtype], _device()))

    return capture.created(make)


def _like_dtype(x, dtype: Optional[Dtype]) -> Dtype:
    if dtype is not None:
        return dtype
    return x.dtype if isinstance(x, Tensor) else np_to_dtype(x.dtype)


def ones(shape, dtype: Dtype = Dtype.F32) -> Tensor:
    return full(shape, 1, dtype=dtype)


def ones_like(x, dtype: Optional[Dtype] = None) -> Tensor:
    return full(x.shape, 1, dtype=_like_dtype(x, dtype))


def zeros(shape, dtype: Dtype = Dtype.F32) -> Tensor:
    return full(shape, 0, dtype=dtype)


def zeros_like(x, dtype: Optional[Dtype] = None) -> Tensor:
    return full(x.shape, 0, dtype=_like_dtype(x, dtype))


def full_like(x, fill_value: ScalarType, dtype: Optional[Dtype] = None) -> Tensor:
    return full(x.shape, fill_value, dtype=_like_dtype(x, dtype))


def empty(shape, dtype: Dtype = Dtype.F32) -> Tensor:
    # zeros, as dsc_tpu gives: a deterministic "uninitialised" tensor
    return full(shape, 0, dtype=dtype)


def empty_like(x, dtype: Optional[Dtype] = None) -> Tensor:
    return empty(x.shape, dtype=_like_dtype(x, dtype))


# ---------------------------------------------------------------------------
# layout ops (reference dsc.cpp:587-827)
# ---------------------------------------------------------------------------


def cast(x: Tensor, dtype: Dtype) -> Tensor:
    # a same-dtype cast is a view of the input (reference dsc.cpp:587-590)
    if x.dtype == dtype:
        return Tensor._view_of(x, x.shape)
    with tracing.trace_op('cast', 'op;layout', tracing.tensor_args(x=x)):
        res = K.cast(x.torch, TORCH_DTYPE[dtype])
    return Tensor._from_torch(res)


def view(x: Tensor) -> Tensor:
    return Tensor._view_of(x, x.shape)


def concat(tensors: Sequence[Tensor], axis: Optional[int] = 0) -> Tensor:
    if not (isinstance(tensors, (tuple, list)) and len(tensors) > 0
            and all(isinstance(t, Tensor) for t in tensors)):
        raise RuntimeError(f'cannot concatenate tensors {tensors}')
    out_dtype = tensors[0].dtype
    for t in tensors[1:]:
        out_dtype = promote(out_dtype, t.dtype)
    arrays = [K.cast(t.torch, TORCH_DTYPE[out_dtype]) for t in tensors]
    with tracing.trace_op('concat', 'op;layout', {'n': len(tensors)}):
        # axis=None flattens everything (reference dsc.cpp:665-746)
        res = K.concat(arrays, None if axis is None else int(axis))
    return Tensor._from_torch(res)


def transpose(x: Tensor, axes=None) -> Tensor:
    """A copy (reference dsc.cpp:764-827); the 1-D transpose is a view."""
    if x.n_dim == 1:
        return Tensor._view_of(x, x.shape)
    if axes is not None and len(tuple(axes)) == 0:
        axes = None
    if axes is None:
        ax = tuple(reversed(range(x.n_dim)))
    else:
        ax = tuple(int(a) + x.n_dim if a < 0 else int(a) for a in axes)
        if sorted(ax) != list(range(x.n_dim)):
            raise RuntimeError(f'cannot transpose axes {axes}')
    with tracing.trace_op('transpose', 'op;layout', tracing.tensor_args(x=x)):
        res = K.transpose(x.torch, ax)
    return Tensor._from_torch(res)


def reshape(x: Tensor, *shape) -> Tensor:
    """Storage-sharing view with -1 inference (reference dsc.cpp:599-636)."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    if not all(isinstance(s, (int, np.integer)) for s in shape):
        raise RuntimeError(f'cannot reshape tensor with shape {shape}')
    shape = tuple(int(s) for s in shape)
    _check_shape(shape)
    known = math.prod(s for s in shape if s != -1)
    n_infer = shape.count(-1)
    if n_infer > 1:
        raise RuntimeError('can only infer one dimension in reshape')
    if any(s <= 0 and s != -1 for s in shape):
        raise RuntimeError(f'invalid reshape dimension in {shape}')
    if n_infer == 1:
        if x.ne % known:
            raise RuntimeError(f'cannot reshape {x.shape} into {shape}')
        shape = tuple(x.ne // known if s == -1 else s for s in shape)
    elif known != x.ne:
        raise RuntimeError(f'cannot reshape {x.shape} into {shape}')
    return Tensor._view_of(x, shape)
