"""The comparison that decides ``correct``: the numbers a configuration names (its
``checks``: each a ``name``, a ``kind`` and a ``limit``), each read between what the timed
path produced and the plain reference's float64 result, over every sampled answer.

Kinds:

- ``max_abs_over_max_ref``: max |got - ref| / max |ref| (a signal's worst sample against its
  largest);
- ``max_abs``: max |got - ref| (a log-power's worst bin, in nepers);
- ``mean_abs``: the mean of |got - ref| (a log-power's typical bin).

An answer of another shape, or one with a NaN, reads inf.
"""

from __future__ import annotations

import math

import torch


def gap(kind: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    if tuple(got.shape) != tuple(ref.shape):
        return math.inf
    err = (got.to(device=ref.device, dtype=torch.float64) - ref).abs()
    diff = float(err.max())
    if math.isnan(diff):
        return math.inf
    if kind == 'max_abs':
        return diff
    if kind == 'mean_abs':
        return float(err.mean())
    if kind == 'max_abs_over_max_ref':
        return diff / float(ref.abs().max())
    raise ValueError(f'unknown comparison {kind!r}')
