"""Elementwise compute for the dsc_tpu_torch op set (dsc_tpu/ops/kernels.py).

Binary arithmetic only so far: add/sub/mul/true_div on operands already
cast to the promoted dtype (the reference table, dtype.promote). Complex
operands use torch's complex arithmetic, the functor math of the
reference (dsc_ops.h:46-90).

On the JAX package's TPU path an f32 elementwise op with at least
``MAP_MIN_ELEMS`` elements runs in the streaming map kernel
(dsc_tpu/ops/pallas_map.py, ``_map_kernel``, K5). That kernel is not yet
ported, so such an op on a CUDA tensor raises instead of running a plain
version in its place; on CPU tensors the plain op runs, as the JAX
package's XLA path does off the TPU.
"""

from __future__ import annotations

import math
import operator

import torch

# dsc_tpu/ops/pallas_map.py MIN_ELEMS: at or above this many result
# elements the reference streams the op through K5
MAP_MIN_ELEMS = 2**21

BINARY = {
    'add': operator.add,
    'sub': operator.sub,
    'mul': operator.mul,
    'div': operator.truediv,
}


def check_map_route(device_type: str, name: str, ne: int) -> None:
    """Raise where the JAX package would stream an ``ne``-element op
    through K5 and the tensor is on CUDA."""
    if device_type == 'cuda' and ne >= MAP_MIN_ELEMS:
        raise NotImplementedError(
            f'{name} of {ne} elements on CUDA runs TPU kernel K5 '
            '(dsc_tpu/ops/pallas_map.py _map_kernel) in the JAX package, '
            'which is not ported yet (ROADMAP.md, queue 2)')


def binary(name: str, a, b, shape) -> torch.Tensor:
    """``a <name> b`` where each operand is a tensor or a Python scalar of
    the result dtype and ``shape`` is the broadcast result shape."""
    dev = a.device if isinstance(a, torch.Tensor) else b.device
    check_map_route(dev.type, name, math.prod(shape))
    return BINARY[name](a, b)
