"""Python half of the C ABI front door, over the port.

The C ABI (cpp/include/dsc.h) reaches the runtime through an embedded
interpreter: the port's shim (dsc_tpu_torch/cpp/dsc_shim.cpp) imports
this module and forwards every call to it, so C/C++ callers and Python
share one context, one plan cache and one tracing ring.

Everything here speaks in *handles* (int64 keys into a registry of live
Tensors) and flat host buffers, so the C side needs no Python object
knowledge. The functions and their signatures are those of the JAX
package's capi.py.

The ABI has no device argument (dsc.h ``dsc_ctx_init``): ``ctx_init``
initialises the context on the card, and a C caller asks for the CPU with
the environment variable ``DSC_DEVICE=cpu``; any value other than
``cuda`` and ``cpu`` raises.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

import numpy as np

import dsc_tpu_torch as dsc
from dsc_tpu_torch.dtype import DTYPE_TO_NP, Dtype

_registry: Dict[int, dsc.Tensor] = {}
_next_handle = 1
_lock = threading.Lock()


def _put(t: dsc.Tensor) -> int:
    global _next_handle
    with _lock:
        h = _next_handle
        _next_handle += 1
        _registry[h] = t
    return h


def _get(h: int) -> dsc.Tensor:
    return _registry[h]


# -- lifecycle ---------------------------------------------------------------


def ctx_init(main_mem: int, scratch_mem: int) -> int:
    device = os.environ.get('DSC_DEVICE', 'cuda')
    if device not in ('cuda', 'cpu'):
        raise RuntimeError(f"DSC_DEVICE={device!r}: expected 'cuda' (the default) or 'cpu'")
    try:
        dsc.init(main_mem, scratch_mem, device=device)
    except RuntimeError:
        return -1
    return 0


def ctx_clear() -> None:
    dsc.clear()


def tensor_free(h: int) -> None:
    with _lock:
        _registry.pop(h, None)


def used_mem() -> int:
    return dsc.used_mem()


# -- creation ----------------------------------------------------------------


def tensor_from_buffer(data: bytes, dtype: int, shape: tuple) -> int:
    np_dt = DTYPE_TO_NP[Dtype(dtype)]
    arr = np.frombuffer(data, dtype=np_dt).reshape(shape).copy()
    return _put(dsc.from_numpy(arr))


def tensor_to_buffer(h: int) -> bytes:
    return _get(h).tobytes()


def tensor_shape(h: int) -> tuple:
    return _get(h).shape


def tensor_dtype(h: int) -> int:
    return _get(h).dtype.value


def wrap_scalar(re: float, im: float, dtype: int) -> int:
    dt = Dtype(dtype)
    if dt.is_complex:
        val = complex(re, im)
    else:
        val = re
    return _put(dsc.full((1,), val, dtype=dt))


def arange(n: int, dtype: int) -> int:
    return _put(dsc.arange(n, Dtype(dtype)))


def randn(shape: tuple, dtype: int) -> int:
    return _put(dsc.randn(*shape, dtype=Dtype(dtype)))


def full(shape: tuple, re: float, im: float, dtype: int) -> int:
    dt = Dtype(dtype)
    fill = complex(re, im) if dt.is_complex else re
    return _put(dsc.full(tuple(shape), fill, dtype=dt))


# -- ops ----------------------------------------------------------------------

_BINARY = {
    'add': dsc.add,
    'sub': dsc.sub,
    'mul': dsc.mul,
    'div': dsc.true_div,
    'pow': dsc.power,
}

_UNARY = {
    'cos': dsc.cos,
    'sin': dsc.sin,
    'sinc': dsc.sinc,
    'logn': dsc.logn,
    'log2': dsc.log2,
    'log10': dsc.log10,
    'exp': dsc.exp,
    'sqrt': dsc.sqrt,
    'abs': dsc.absolute,
    'angle': dsc.angle,
    'conj': dsc.conj,
    'real': dsc.real,
    'imag': dsc.imag,
    'i0': dsc.i0,
}

_REDUCE = {
    'sum': dsc.sum,
    'mean': dsc.mean,
    'max': dsc.max,
    'min': dsc.min,
}


def binary_op(name: str, ha: int, hb: int) -> int:
    return _put(_BINARY[name](_get(ha), _get(hb)))


def binary_scalar(name: str, ha: int, re: float, im: float, is_complex: int,
                  reflected: int) -> int:
    s = complex(re, im) if is_complex else re
    if reflected:
        return _put(_BINARY[name](s, _get(ha)))
    return _put(_BINARY[name](_get(ha), s))


def unary_op(name: str, h: int) -> int:
    return _put(_UNARY[name](_get(h)))


def clip(h: int, lo: float, hi: float, has_lo: int, has_hi: int) -> int:
    return _put(
        dsc.clip(
            _get(h),
            lo if has_lo else None,
            hi if has_hi else None,
        )
    )


def reduce_op(name: str, h: int, axis: int, keepdims: int) -> int:
    return _put(_REDUCE[name](_get(h), axis=axis, keepdims=bool(keepdims)))


# -- layout -------------------------------------------------------------------


def reshape(h: int, shape: tuple) -> int:
    return _put(dsc.reshape(_get(h), *shape))


def transpose(h: int, axes: tuple) -> int:
    return _put(dsc.transpose(_get(h), axes if len(axes) else None))


def concat(handles: tuple, axis: int, flatten: int) -> int:
    ts = [_get(h) for h in handles]
    return _put(dsc.concat(ts, None if flatten else axis))


def cast(h: int, dtype: int) -> int:
    return _put(dsc.cast(_get(h), Dtype(dtype)))


def get_slice(h: int, starts: tuple, stops: tuple, steps: tuple,
              is_index: tuple) -> int:
    """NumPy-style mixed int/slice indexing; the C side passes
    start==stop==step sentinels for plain indices like the reference ABI
    (dsc.cpp:898-948)."""
    NONE = 2**31 - 1
    key = []
    for st, sp, ss, ii in zip(starts, stops, steps, is_index):
        if ii:
            key.append(st)
        else:
            key.append(
                slice(
                    None if st == NONE else st,
                    None if sp == NONE else sp,
                    None if ss == NONE else ss,
                )
            )
    res = _get(h)[tuple(key)]
    if not isinstance(res, dsc.Tensor):
        res = dsc.full((1,), res,
                       dtype=_get(h).dtype)
    return _put(res)


def set_slice(h: int, hv: int, starts: tuple, stops: tuple, steps: tuple,
              is_index: tuple) -> None:
    NONE = 2**31 - 1
    key = []
    for st, sp, ss, ii in zip(starts, stops, steps, is_index):
        if ii:
            key.append(st)
        else:
            key.append(
                slice(
                    None if st == NONE else st,
                    None if sp == NONE else sp,
                    None if ss == NONE else ss,
                )
            )
    _get(h)[tuple(key)] = _get(hv)


# -- fft ----------------------------------------------------------------------

_FFT = {
    'fft': dsc.fft,
    'ifft': dsc.ifft,
    'rfft': dsc.rfft,
    'irfft': dsc.irfft,
}


def fft_op(name: str, h: int, n: int, axis: int) -> int:
    return _put(_FFT[name](_get(h), n=n, axis=axis))


def fftfreq(n: int, d: float, dtype: int) -> int:
    return _put(dsc.fftfreq(n, d, Dtype(dtype)))


def rfftfreq(n: int, d: float, dtype: int) -> int:
    return _put(dsc.rfftfreq(n, d, Dtype(dtype)))


def plan_fft(n: int, dtype: int) -> None:
    dsc.plan_fft(n, Dtype(dtype))


_FFT2 = {
    'fft2': dsc.fft2,
    'ifft2': dsc.ifft2,
    'rfft2': dsc.rfft2,
    'irfft2': dsc.irfft2,
}


def fft2_op(name: str, h: int, n0: int, n1: int, ax0: int, ax1: int) -> int:
    return _put(_FFT2[name](_get(h), s=(n0, n1), axes=(ax0, ax1)))


_WINDOWS = {
    'hanning': dsc.hanning,
    'hamming': dsc.hamming,
    'blackman': dsc.blackman,
}


def window(kind: str, n: int, beta: float, dtype: int) -> int:
    if kind == 'kaiser':
        return _put(dsc.kaiser(n, beta, dtype=Dtype(dtype)))
    return _put(_WINDOWS[kind](n, dtype=Dtype(dtype)))


# -- tracing -------------------------------------------------------------------


def traces_record(record: int) -> None:
    from dsc_tpu_torch import tracing

    tracing.set_recording(bool(record))


def dump_traces(path: str) -> None:
    from dsc_tpu_torch import tracing

    tracing.dump_traces(path)


def clear_traces() -> None:
    from dsc_tpu_torch import tracing

    tracing.clear_traces()
