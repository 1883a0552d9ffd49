"""Dtype system for dsc_tpu_torch (a copy of dsc_tpu/dtype.py: numpy only).

Rebuild of the reference dtype system
(reference: dsc/include/dsc_dtype.h:51-78, python/dsc/dtype.py).

Four dtypes — F32, F64, C32, C64 — with the reference's exact binary
promotion table (note: it is NOT NumPy's table, e.g. F64 x C32 -> C32).
"""

from __future__ import annotations

import enum
from typing import Union

import numpy as np

ScalarType = Union[bool, int, float, complex]


class Dtype(enum.Enum):
    """Mirrors the reference enum dsc_dtype (dsc_dtype.h:51-56)."""

    F32 = 0
    F64 = 1
    C32 = 2
    C64 = 3

    def __repr__(self) -> str:
        return DTYPE_NAMES[self]

    def __str__(self) -> str:
        return DTYPE_NAMES[self]

    @property
    def is_complex(self) -> bool:
        return self in (Dtype.C32, Dtype.C64)

    @property
    def is_real(self) -> bool:
        return not self.is_complex

    @property
    def as_real(self) -> 'Dtype':
        """Complex dtype -> its real component dtype (dsc_dtype.h real_of)."""
        if self == Dtype.C32:
            return Dtype.F32
        if self == Dtype.C64:
            return Dtype.F64
        return self

    @property
    def as_complex(self) -> 'Dtype':
        if self == Dtype.F32:
            return Dtype.C32
        if self == Dtype.F64:
            return Dtype.C64
        return self


DTYPE_NAMES = {
    Dtype.F32: 'f32',
    Dtype.F64: 'f64',
    Dtype.C32: 'c32',
    Dtype.C64: 'c64',
}

# Size in bytes (dsc_dtype.h:58-63)
DTYPE_SIZE = {
    Dtype.F32: 4,
    Dtype.F64: 8,
    Dtype.C32: 8,
    Dtype.C64: 16,
}

# Binary promotion table — EXACT copy of the reference semantics
# (DSC_DTYPE_CONVERSION_TABLE, dsc_dtype.h:73-78). Rows = lhs, cols = rhs.
# Quirk preserved: F64 x C32 -> C32 (not C64 as NumPy would say).
DTYPE_CONVERSION_TABLE = [
    [Dtype.F32, Dtype.F64, Dtype.C32, Dtype.C64],
    [Dtype.F64, Dtype.F64, Dtype.C32, Dtype.C64],
    [Dtype.C32, Dtype.C32, Dtype.C32, Dtype.C64],
    [Dtype.C64, Dtype.C64, Dtype.C64, Dtype.C64],
]


def promote(a: Dtype, b: Dtype) -> Dtype:
    return DTYPE_CONVERSION_TABLE[a.value][b.value]


# NumPy <-> dsc mapping (python/dsc/dtype.py:53-58)
NP_TO_DTYPE = {
    np.dtype(np.float32): Dtype.F32,
    np.dtype(np.float64): Dtype.F64,
    np.dtype(np.complex64): Dtype.C32,
    np.dtype(np.complex128): Dtype.C64,
}

DTYPE_TO_NP = {
    Dtype.F32: np.dtype(np.float32),
    Dtype.F64: np.dtype(np.float64),
    Dtype.C32: np.dtype(np.complex64),
    Dtype.C64: np.dtype(np.complex128),
}


def np_to_dtype(np_dtype) -> Dtype:
    key = np.dtype(np_dtype)
    if key not in NP_TO_DTYPE:
        raise RuntimeError(f'NumPy dtype {np_dtype} is not supported')
    return NP_TO_DTYPE[key]


def scalar_dtype(x: ScalarType) -> Dtype:
    """Python scalar -> default dtype (reference tensor.py:438-448:
    int/float -> F32, complex -> C32)."""
    if isinstance(x, complex):
        return Dtype.C32
    return Dtype.F32
