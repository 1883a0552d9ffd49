"""Debug / observability helpers (dsc_tpu/utils/debug.py).

- ``DSC_DEBUG``-gated stderr logging (reference dsc.h:14-34) via the env
  var or ``enable_debug_logging()``;
- ``nan_guard``: every op's output is checked for NaN inside the block,
  the role ``jax_debug_nans`` plays in the JAX package. Its
  ``interpret_kernels=True`` (the JAX package's Pallas interpreter) has no
  counterpart on a CUDA device: no switch swaps a CUDA kernel for its plain
  version, so it raises there. On a CPU context every kernel already runs
  its plain version, and the flag changes nothing.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager

import torch

from .. import capture, tensor

_debug = bool(os.environ.get('DSC_DEBUG'))


def enable_debug_logging(on: bool = True) -> None:
    global _debug
    _debug = on


def log_debug(msg: str) -> None:
    if _debug:
        print(f'[DSC DEBUG] {msg}', file=sys.stderr)


def _check_nan(data: torch.Tensor) -> None:
    """Raise if an op's output holds a NaN; not inside a graph capture nor
    on a pseudo-tensor, whose values are not there to read."""
    if data.device.type == 'meta' or capture.capturing():
        return
    if (data.dtype.is_floating_point or data.dtype.is_complex) and bool(torch.isnan(data).any()):
        raise FloatingPointError(f'nan_guard: NaN in an op output of shape {tuple(data.shape)}')


@contextmanager
def nan_guard(interpret_kernels: bool = False):
    """Fail fast on the first op whose output holds a NaN (the reference's
    ASan/assert analog for numeric bugs)."""
    if interpret_kernels:
        from ..context import device

        if device().type == 'cuda':
            raise RuntimeError(
                'nan_guard(interpret_kernels=True): the port runs its hand-written CUDA '
                'kernels on a CUDA device and has no interpreter for them; no switch swaps '
                "a kernel for its plain version (run under init(device='cpu') for the "
                'plain versions)')
    prev = tensor._nan_check
    tensor._nan_check = _check_nan
    try:
        yield
    finally:
        tensor._nan_check = prev
