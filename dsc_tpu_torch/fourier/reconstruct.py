"""Hermitian spectrum reconstruction: kernel K11
(dsc_tpu/fourier/pallas_reconstruct.py).

irfft of a large spectrum runs a full-size inverse transform of

    full[k] = X[k]            for k <= n/2
    full[k] = conj(X[n - k])  for n/2 < k < n

from the (B, n/2+1) spectrum X. The kernel (csrc/reconstruct.cu) is one
coalesced pass: each thread copies a head value or reads a tail value
backwards and writes it forwards. The TPU kernel's exchange-matrix
matmuls and 127-lane shift are TPU workarounds and have no counterpart.

The kernel takes what the TPU kernel takes (pallas_reconstruct.py:205): a
single complex64 row with n/2 an even multiple of CHUNK values. Every
other spectrum, on either device, takes the plain version, as the JAX
package runs XLA there. That includes complex128, on which the TPU kernel
raises (it stores float32 into float64 buffers); the port gives the value.
full[n/2] is X[n/2] as given: the TPU kernel conjugates it, which changes
nothing on a valid spectrum, whose X[n/2] is real.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..kernels import build

CHUNK = 2**16  # the TPU kernel's tail chunk (pallas_reconstruct.py:41)


def reconstruct_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n/2+1) -> (B, n) with the conjugate mirror as the upper half."""
    with tracing.trace_op('reconstruct', 'plain;fft'):
        return torch.cat([x, x[:, 1:n // 2].flip(1).conj()], dim=1)


def kernel_takes(x: torch.Tensor, n: int) -> bool:
    """Whether K11 serves this spectrum (pallas_reconstruct.py:205)."""
    chunks, rest = divmod(n // 2, CHUNK)
    return (x.dtype == torch.complex64 and x.shape[0] == 1 and rest == 0
            and chunks >= 2 and chunks % 2 == 0)


def reconstruct_spectrum(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n/2+1) complex -> (B, n): K11 on a CUDA tensor it takes, the
    plain version otherwise."""
    if x.device.type == 'cpu' or not kernel_takes(x, n):
        return reconstruct_plain(x, n)
    x = build.aligned(x)
    build.check(x, torch.complex64, (1, n // 2 + 1), 'x')
    full = torch.empty((1, n), dtype=torch.complex64, device=x.device)
    build.launch('reconstruct', x.data_ptr(), full.data_ptr(), n)
    return full
