"""Host <-> device interop (dsc_tpu/interop.py).

numpy arrays cross to and from torch tensors on the context's device. The
JAX package's complex-transfer staging and complex128-to-host routing are
TPU workarounds: a CUDA device moves and computes complex64/complex128
directly, so neither is carried over.

``from_half_t`` converts a spectrum in the JAX package's hermitian-half
transposed layout (dsc_tpu/fourier/pallas_stream_t.py, planes H with
X[k1 + n1*k2] = H[k1, k2]) into the port's natural (n/2+1,) complex64
Tensor, so spectra computed by the reference can feed the port.
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
    (the map of dsc_tpu/planar.py Planar.to_numpy)."""
    from .tensor import from_numpy

    m = n1 * n2 // 2 + 1
    cols = n2 // 2 + 1
    re = np.asarray(hr, np.float32)[:n1, :cols].T.reshape(-1)[:m]
    im = np.asarray(hi, np.float32)[:n1, :cols].T.reshape(-1)[:m]
    out = np.empty(m, np.complex64)
    out.real = re
    out.imag = im
    return from_numpy(out)
