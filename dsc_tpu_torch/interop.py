"""Host <-> device interop (dsc_tpu/interop.py).

numpy arrays cross to and from torch tensors on the context's device. The
JAX package's complex-transfer staging and complex128-to-host routing are
TPU workarounds: a CUDA device moves and computes complex64/complex128
directly, so neither is carried over.

``from_half_t`` converts a spectrum in the JAX package's hermitian-half
transposed layout (dsc_tpu/fourier/pallas_stream_t.py, planes H with
X[k1 + n1*k2] = H[k1, k2]) into the port's natural (n/2+1,) complex64
Tensor, and ``from_t`` a T or half-T spectrum into a port Tensor that keeps
the layout, so spectra computed by the reference can feed the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .dtype import Dtype

TORCH_DTYPE = {
    Dtype.F32: torch.float32,
    Dtype.F64: torch.float64,
    Dtype.C32: torch.complex64,
    Dtype.C64: torch.complex128,
}

DTYPE_OF_TORCH = {v: k for k, v in TORCH_DTYPE.items()}


def put(host_arr: np.ndarray, device=None) -> torch.Tensor:
    """Copy a host array onto ``device`` (default: the context's)."""
    if device is None:
        from .context import device as _device

        device = _device()
    return torch.tensor(np.ascontiguousarray(host_arr), device=device)


def get(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor to a host array (never a view of the tensor)."""
    return t.detach().to('cpu', copy=True).numpy()


def from_half_t(hr: np.ndarray, hi: np.ndarray, n1: int, n2: int):
    """Half-T planes (n1 + pad, >= n2/2 + 1) of an n = n1*n2 real-input
    spectrum -> the natural (n/2+1,) C32 Tensor: X[k1 + n1*k2] = H[k1, k2]
    (the map of dsc_tpu/planar.py Planar.to_numpy). It is ``from_t``'s
    half-T Tensor, turned into natural order in place."""
    t = from_t(hr, hi, n1, n2, True)
    t._buf.materialize()
    return t


def from_t(hr: np.ndarray, hi: np.ndarray, n1: int, n2: int, half: bool):
    """T planes (n1, n2), or half-T planes (n1 + pad, >= n2/2 + 1), of an
    n = n1*n2 spectrum -> a C32 Tensor stored in the same layout
    (fourier/stream_t.py), without the planes' pad rows and lane padding."""
    from .tensor import Tensor

    cols = n2 // 2 + 1 if half else n2
    s = np.empty((n1, cols), np.complex64)
    s.real = np.asarray(hr, np.float32)[:n1, :cols]
    s.imag = np.asarray(hi, np.float32)[:n1, :cols]
    return Tensor._from_t(put(s), n1, n2, half)
