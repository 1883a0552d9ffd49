"""The dsc_tpu_torch Tensor: a NumPy-compatible tensor over one torch.Tensor
(dsc_tpu/tensor.py).

What the reference tensor layer (dsc/src/dsc.cpp:342-827,
python/dsc/tensor.py) makes observable, for the subset ported so far:

- four dtypes and max rank 4 (dsc.h:72-76)
- ``reshape`` returns a view sharing storage and byte accounting
  (dsc.cpp:599-636)
- basic indexing (ints and slices) returns copies (dsc.h:238-243), and a
  1-element result unwraps to a Python scalar (python/dsc/tensor.py:91-103)
- binary ops follow the reference promotion table, including the Python
  scalar rule (tensor.py:435-456: int/float -> F32, complex -> C32)

Every tensor lives on the context's device (``dsc.init(..., device=)``).
Views with write-through, ``__setitem__``, unary ops and reductions are
not ported yet.
"""

from __future__ import annotations

import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from . import interop, tracing
from .context import _get_ctx
from .dtype import Dtype, np_to_dtype, promote, scalar_dtype
from .interop import DTYPE_OF_TORCH, TORCH_DTYPE
from .ops import kernels as K

DSC_MAX_DIMS = 4  # reference dsc.h:72-76


class _Buffer:
    """Refcounted-buffer equivalent (reference dsc_tensor_buffer): owns one
    torch tensor and registers its bytes with the context's accounting."""

    __slots__ = ('data', 'nbytes', '__weakref__')

    def __init__(self, data: torch.Tensor):
        ctx = _get_ctx()
        nbytes = data.numel() * data.element_size()
        ctx.alloc(nbytes)
        self.data = data
        self.nbytes = nbytes
        weakref.finalize(self, ctx.free, nbytes)


class Tensor:
    __slots__ = ('_buf', '_shape', '_dtype')

    @classmethod
    def _from_torch(cls, data: torch.Tensor) -> 'Tensor':
        if data.dim() > DSC_MAX_DIMS:
            raise RuntimeError(
                f'cannot create a Tensor with {data.dim()} dimensions, '
                f'max is {DSC_MAX_DIMS}')
        t = cls.__new__(cls)
        t._buf = _Buffer(data.contiguous())
        t._shape = tuple(data.shape)
        t._dtype = DTYPE_OF_TORCH[data.dtype]
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
        """The storage, viewed in this tensor's shape (no copy)."""
        return self._buf.data.view(self._shape)

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

    def __repr__(self) -> str:
        return f'Tensor(dtype={self._dtype}, shape={self._shape})\n{self.numpy()}'

    def numpy(self) -> np.ndarray:
        return interop.get(self.torch)

    def reshape(self, *shape) -> 'Tensor':
        return reshape(self, *shape)

    # -- indexing (reference tensor.py:193-267, dsc.cpp:829-1169) ------------

    def __getitem__(self, item):
        key = _normalize_key(item, self._shape)
        with tracing.trace_op('get', 'op;indexing', tracing.tensor_args(x=self)):
            res = _index(self.torch, key)
        if res.numel() == 1:
            # any 1-element result unwraps (python/dsc/tensor.py:91-103)
            v = res.reshape(()).item()
            return complex(v) if self._dtype.is_complex else float(v)
        return Tensor._from_torch(res)

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


# ---------------------------------------------------------------------------
# indexing helpers
# ---------------------------------------------------------------------------


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
                raise RuntimeError(
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
            t = t.index_select(ax, idx)
            key = key[:ax] + (slice(None),) + key[ax + 1:]
    return t[key].clone()


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


def _binary_op(xa, xb, out: Optional[Tensor], name: str) -> Tensor:
    if not isinstance(xa, (Tensor, np.ndarray)) and not isinstance(
            xb, (Tensor, np.ndarray)):
        raise RuntimeError(f'{name}: at least one operand must be a Tensor')
    sa, sb = _shape_of(xa), _shape_of(xb)
    if not _can_broadcast(sa, sb):
        raise RuntimeError(f'cannot broadcast {sa} and {sb}')
    out_dtype = promote(_operand_dtype(xa), _operand_dtype(xb))
    args = tracing.tensor_args(xa=xa if isinstance(xa, Tensor) else None,
                               xb=xb if isinstance(xb, Tensor) else None)
    shape = tuple(torch.broadcast_shapes(sa, sb))
    with tracing.trace_op(name, 'op;binary', args):
        res = K.binary(name, _operand(xa, out_dtype), _operand(xb, out_dtype),
                       shape)
    return _finish(res, out)


def add(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'add')


def sub(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'sub')


def mul(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'mul')


def true_div(xa, xb, out: Optional[Tensor] = None) -> Tensor:
    return _binary_op(xa, xb, out, 'div')


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
    return Tensor._from_torch(interop.put(x))


def randn(*shape: int, dtype: Dtype = Dtype.F32) -> Tensor:
    """Standard normal samples from the context's seeded generator."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    _check_shape(shape)
    ctx = _get_ctx()
    host = torch.randn(shape, generator=ctx.generator,
                       dtype=TORCH_DTYPE[dtype])
    return Tensor._from_torch(host.to(ctx.device))


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
