"""Size rules of the streaming two-pass FFT (dsc_tpu/fourier/pallas_stream.py).

Only the split and the legality test are ported: they decide, as on the
TPU, which transforms the two-pass kernels take (config.py). The natural-
layout kernel bodies (K6 ``_phase_a_kernel``, K7 ``_phase_b_kernel``) are
not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

LANES = 128
FACTOR_MIN = 512
FACTOR_MAX = 8192


def factors(n: int) -> Tuple[int, int]:
    """Balanced (n1, n2) split for the streaming kernels (pallas_stream.py:77-82)."""
    n1 = min(1 << (n.bit_length() // 2), FACTOR_MAX)
    return n1, n // n1


def _group(batch: int, nf: int) -> int:
    """Consecutive batch rows grouped per copy (pallas_stream.py:96-102)."""
    g = min(batch, max(1, FACTOR_MAX // nf))
    while batch % g:
        g -= 1
    return g


def supported(n1: int, n2: int, dtype, batch: int = 1) -> bool:
    """pallas_stream.py:105-117: complex64 only; each factor a power of two
    in [256, 8192] that batch grouping lifts to >= FACTOR_MIN rows."""
    if np.dtype(dtype) != np.complex64:
        return False
    for f in (n1, n2):
        if not (256 <= f <= FACTOR_MAX) or f & (f - 1):
            return False
        if _group(batch, f) * f < FACTOR_MIN:
            return False
    return n1 % LANES == 0 and n2 % LANES == 0
