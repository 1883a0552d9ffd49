"""The log-depth scan of an affine recurrence with one constant map,
x[k] = A x[k-1] + v[k], that ``statespace.py`` (the simulators' state
update), ``splines.py`` (the first-order scalar map and the second-order
2x2 companion map) and ``iir.py`` (a section's state below the Toeplitz
route and at the base of its ladder) share.

The JAX package runs these recurrences as ``lax.associative_scan`` over
(M, v) pairs with one M a position, a (T, m, m) stack. Here A is the same
at every step, so the doubling step of stride d applies A^d at every
position: a scan over T steps needs the ceil(log2 T) matrices A, A^2, A^4,
..., made on the host in float64 and uploaded once (squared on the device
for ``iir.py``'s float32 sections), and each step is one
(b, T - d, m) x (m, m) product and one add, in place. The values equal the
associative scan's up to the order of the additions.
"""

from __future__ import annotations

import numpy as np
import torch


def scan_maps(A, steps: int, device=None) -> torch.Tensor:
    """The maps of the doubling steps of a scan over ``steps`` steps:
    (A^(2^i))^T for 2^i < steps, as an (L, m, m) tensor, L = ceil(log2
    steps) (0 for one step). A host ``A`` (a NumPy array or nested list) is
    squared on the host in float64 and the stack moved to ``device`` at
    once; a tensor ``A`` is squared where it lies, in its dtype, so no value
    crosses to the host (``iir.py`` calls it inside a CUDA graph capture)."""
    host = not isinstance(A, torch.Tensor)
    p = torch.from_numpy(np.atleast_2d(np.asarray(A, np.float64))) if host else A
    maps = []
    d = 1
    while d < steps:
        maps.append(p.T)
        p = p @ p
        d *= 2
    stack = torch.stack(maps) if maps else p.new_zeros((0,) + tuple(p.shape))
    return stack.to(device) if host else stack


def affine_scan_(w: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """Every state of x[k] = A x[k-1] + w[:, k], x[0] = w[:, 0], written
    over ``w`` (b, T, m) in place, in ceil(log2 T) doubling steps batched
    over rows and positions; ``maps`` is ``scan_maps(A, T, w.device)`` in
    ``w``'s dtype. After the step of stride d, w[:, k] holds the sum of
    A^j v[k - j] over j < 2d."""
    m = w.shape[2]
    d = 1
    for p in maps:
        # the product reads the states of the previous step in full before
        # the add writes over them
        w[:, d:].add_(w[:, :-d] * p if m == 1 else torch.matmul(w[:, :-d], p))
        d *= 2
    return w
