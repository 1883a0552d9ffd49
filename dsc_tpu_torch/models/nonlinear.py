"""Sliding-window nonlinear/adaptive filters: ``medfilt``, ``medfilt2d``,
``order_filter``, ``wiener`` (dsc_tpu/models/nonlinear.py).

scipy.signal semantics, zero-padded edges, on the input's device in its
dtype. The JAX package stacks the k window taps as k shifted copies of the
padded signal and reduces over that leading axis. Here the window is the
last axis: ``unfold`` gives it as a view of the padded signal (the median
filters; ``torch.median`` over it, NaN-propagating as ``jnp.median`` is,
and the picked value where ``jnp.median``'s float32 midpoint overflows
above ~1.7e38, ROADMAP F8),
or the selected taps of ``order_filter`` are stacked on it and sorted
(``torch.sort`` puts NaN last, as ``jnp.sort`` does). The reduction copies
the window, k times the signal. ``wiener``'s two local sums are k - 1
shifted in-place adds into one accumulator, in the order of the JAX
package's reduction over its stack (equal to it bit for bit on the CPU),
with no stack at all.

As in the JAX package, ``medfilt`` and ``wiener`` take a 2-D input as a
batch of rows (scipy filters it as an image), and ``wiener``'s ``mysize``
is one odd int.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..tensor import Tensor


def _check_1d2d(x: Tensor, who: str):
    if x.n_dim > 2:
        raise RuntimeError(f'{who}: expected a 1-D or 2-D signal, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError(f'{who} expects a real signal')
    return x.n_dim == 2


def _median_program(x: torch.Tensor, k: int) -> torch.Tensor:
    """(b, n) -> the median of each zero-padded k-sample window, (b, n)."""
    pad = k // 2
    xp = F.pad(x, (pad, pad))
    return torch.median(xp.unfold(-1, k, 1), dim=-1).values


def medfilt(x: Tensor, kernel_size: int = 3) -> Tensor:
    """Sliding-window median filter (scipy.signal.medfilt semantics:
    zero-padded edges, odd ``kernel_size``). x: (n,) or (batch, n)."""
    if kernel_size < 1 or kernel_size % 2 == 0:
        raise RuntimeError(
            f'medfilt: kernel_size ({kernel_size}) must be odd and >= 1'
        )
    batched = _check_1d2d(x, 'medfilt')
    xt = x.torch if batched else x.torch[None, :]
    with tracing.trace_op('medfilt', 'op;pipeline', tracing.tensor_args(x=x)):
        out = _median_program(xt, int(kernel_size))
    return Tensor._from_torch(out if batched else out[0])


def _local_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """The sum of each zero-padded k-sample window of the rows of ``x``,
    added tap by tap from the first (the JAX package's order)."""
    pad = k // 2
    n = x.shape[1]
    xp = F.pad(x, (pad, pad))
    acc = xp[:, :n].clone()
    for i in range(1, k):
        acc.add_(xp[:, i:i + n])
    return acc


def _wiener_program(x: torch.Tensor, noise: Optional[float], k: int) -> torch.Tensor:
    l_mean = _local_sum(x, k) / k
    l_var = _local_sum(x * x, k) / k - l_mean * l_mean
    if noise is None:
        noise = torch.mean(l_var)
    res = l_mean + (1.0 - noise / torch.clamp(l_var, min=1e-30)) * (x - l_mean)
    return torch.where(l_var < noise, l_mean, res)


def wiener(x: Tensor, mysize: int = 3,
           noise: Optional[float] = None) -> Tensor:
    """Adaptive Wiener filter (scipy.signal.wiener 1-D semantics):
    local mean/variance over a ``mysize`` window (zero-padded edges),
    noise power estimated as the mean local variance when not given (a
    given one is rounded to float32, as the JAX package takes it).
    x: (n,) or (batch, n)."""
    if mysize < 1 or mysize % 2 == 0:
        raise RuntimeError(
            f'wiener: mysize ({mysize}) must be odd and >= 1'
        )
    batched = _check_1d2d(x, 'wiener')
    xt = x.torch if batched else x.torch[None, :]
    with tracing.trace_op('wiener', 'op;pipeline', tracing.tensor_args(x=x)):
        out = _wiener_program(
            xt, None if noise is None else float(np.float32(noise)), int(mysize))
    return Tensor._from_torch(out if batched else out[0])


def medfilt2d(x: Tensor, kernel_size=3) -> Tensor:
    """2-D median filter (scipy.signal.medfilt2d semantics: zero-padded
    edges, odd kernel sides). x: (m, n) real; ``kernel_size`` a scalar
    or (k1, k2). The k1*k2 window is two ``unfold`` views of the padded
    image and one median over their flattened taps."""
    if x.n_dim != 2:
        raise RuntimeError(f'medfilt2d: expected a 2-D image, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError('medfilt2d expects a real image')
    ks = (int(kernel_size), int(kernel_size)) \
        if np.isscalar(kernel_size) else tuple(int(k) for k in kernel_size)
    if len(ks) != 2 or any(k < 1 or k % 2 == 0 for k in ks):
        raise RuntimeError(
            f'medfilt2d: kernel_size ({kernel_size}) must be odd and >= 1')
    k1, k2 = ks
    m, n = x.shape
    with tracing.trace_op('medfilt2d', 'op;pipeline', tracing.tensor_args(x=x)):
        xp = F.pad(x.torch, (k2 // 2, k2 // 2, k1 // 2, k1 // 2))
        taps = xp.unfold(0, k1, 1).unfold(1, k2, 1).reshape(m, n, k1 * k2)
        out = torch.median(taps, dim=-1).values
    return Tensor._from_torch(out)


def _order_program(x: torch.Tensor, offsets, rank: int, shape) -> torch.Tensor:
    """The ``rank``-th smallest of the taps at ``offsets`` of each
    zero-padded window of the odd ``shape`` (1-D or 2-D)."""
    xp = F.pad(x, [p for k in reversed(shape) for p in (k // 2, k // 2)])
    taps = torch.stack([xp[tuple(slice(o, o + n) for o, n in zip(off, x.shape))]
                        for off in offsets], dim=-1)
    return torch.sort(taps, dim=-1).values[..., rank]


def order_filter(x: Tensor, domain, rank: int) -> Tensor:
    """Rank-order filter (scipy.signal.order_filter semantics): at each
    position, sort the neighbors selected by the nonzero entries of the
    odd-shaped 0/1 ``domain`` mask (zero-padded edges) and keep the
    ``rank``-th smallest. 1-D or 2-D real input; the selected taps
    become shifted slices stacked on a last axis and one sort."""
    if x.dtype.is_complex:
        raise RuntimeError('order_filter expects a real signal')
    dom = np.asarray(domain)
    if x.n_dim != dom.ndim or x.n_dim not in (1, 2):
        raise RuntimeError(
            f'order_filter: input is {x.n_dim}-D but domain is '
            f'{dom.ndim}-D (1-D and 2-D supported)')
    if any(s % 2 == 0 for s in dom.shape):
        raise RuntimeError('order_filter: domain sides must be odd')
    offsets = tuple(tuple(int(i) for i in idx)
                    for idx in np.argwhere(dom != 0))
    if not offsets:
        raise RuntimeError('order_filter: domain selects no samples')
    if not 0 <= rank < len(offsets):
        raise RuntimeError(
            f'order_filter: rank ({rank}) out of range for '
            f'{len(offsets)} selected samples')
    with tracing.trace_op('order_filter', 'op;pipeline', tracing.tensor_args(x=x)):
        out = _order_program(x.torch, offsets, int(rank), dom.shape)
    return Tensor._from_torch(out)
