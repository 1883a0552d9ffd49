"""Streaming elementwise map: kernel K5 (dsc_tpu/ops/pallas_map.py).

The JAX package streams a large float32 elementwise op through one Pallas
kernel (``_map_kernel``) when ``eligible()`` admits its operands, and
leaves every other op to XLA. The port keeps that routing rule exactly
(``classify``/``eligible``) and replaces the kernel with
``csrc/stream_map.cu``: one pass over device memory with 16-byte loads and
stores, each block one short chunk of the output, one instantiation per
body and operand kinds (``INSTANTIATIONS``).

Operands are tensors or Python scalars. Their kinds (``classify``):

- ``full``: the output's shape, streamed;
- ``brow``: a broadcast row, shape (M,) or (1, .., M) against a (..., M)
  output, read as ``row[i % M]``;
- ``scalar``: a 1-element tensor (read once per thread on the card, never
  through ``.item()``) or a Python scalar (passed by value).

Bodies (``REAL_BODIES``, ``COMPLEX_BODIES``; the kernel's op codes follow
their order):

- float32: add/sub/mul/div; sin/cos as the fast Cody-Waite + minimax
  polynomial of dsc_tpu/ops/kernels.py:230-264; exp, logn, log2, log10,
  sqrt, sinc; clip(x, lo, hi);
- complex64 (interleaved, the port's one complex layout): add/sub/mul/div
  with the planar formulas of dsc_tpu/planar.py:_complex_math, division
  as (ar*br + ai*bi)/d.

The JAX package streams complex arithmetic on planar spectra
(planar.py:250-321). The port has no planar storage, so its complex route
(``eligible_complex``) takes a complex64 add/sub/mul/div of >= MIN_ELEMS
elements whose operands have one shape, or one of which is a Python scalar.

``stream_map`` launches the kernel for CUDA tensors and runs
``stream_map_plain``, the same formulas in torch ops, for CPU tensors (and
for the meta tensors of dsc.map's shape trace, ops/map_gen.py). The
op layer (ops/kernels.py) classifies its operands once, with ``route`` or
``route_complex``, and hands the result down as ``layout``.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..kernels import build

LANES = 128
# longest broadcast row the JAX kernel replicates, in 128-lane rows
CHUNK_ROWS = 16384
# elements below this take the plain path (dsc_tpu pallas_map.MIN_ELEMS)
MIN_ELEMS = 2**21

# body -> number of operands; the order is csrc/stream_map.cu's op codes
REAL_BODIES = {
    'add': 2, 'sub': 2, 'mul': 2, 'div': 2,
    'sin': 1, 'cos': 1, 'exp': 1, 'logn': 1, 'log2': 1, 'log10': 1,
    'sqrt': 1, 'sinc': 1, 'clip': 3,
}
COMPLEX_BODIES = ('add', 'sub', 'mul', 'div')

# operand kinds as the kernel reads them
_FULL, _BROW, _VALUE, _POINTER = 0, 1, 2, 3
_HOST_KIND = {'full': _FULL, 'brow': _BROW, 'scalar': _POINTER}

# the kernel's op codes
_CODES = {**{(torch.float32, b): i for i, b in enumerate(REAL_BODIES)},
          **{(torch.complex64, b): len(REAL_BODIES) + i for i, b in enumerate(COMPLEX_BODIES)}}

# operand kinds as the kernels' template arguments (csrc/stream_map.cuh Kind)
KIND_ARGS = {'full': 'kF', 'brow': 'kB', 'scalar': 'kS'}


def _instantiations():
    """(dtype, body, kinds) -> the kernel template csrc/stream_map.cu
    instantiates for it (its ``admitted``): a unary body on a full operand;
    a binary body on (full, full), a scalar or a broadcast row on either
    side of a full operand; clip on every placement of full, brow and scalar
    with at least one full; a complex body on (full, full) or a scalar on
    either side. These are exactly the combinations ``_layout`` admits."""
    table = {}
    binary = [('full', 'full'), ('full', 'scalar'), ('scalar', 'full'),
              ('full', 'brow'), ('brow', 'full')]
    for body, arity in REAL_BODIES.items():
        name = 'k' + body.capitalize()
        if arity == 1:
            combos = [('full',)]
        elif arity == 2:
            combos = binary
        else:
            combos = [ks for ks in itertools.product(KIND_ARGS, repeat=3) if 'full' in ks]
        for ks in combos:
            args = ', '.join(KIND_ARGS[k] for k in ks)
            table[(torch.float32, body, ks)] = f'map_kernel<RealBody<{name}>, 1, {args}>'
    for body in COMPLEX_BODIES:
        for ks in binary[:3]:
            table[(torch.complex64, body, ks)] = (
                f'cmap_kernel<kC{body.capitalize()}, {", ".join(KIND_ARGS[k] for k in ks)}>')
    return table


INSTANTIATIONS = _instantiations()


def instantiation(body: str, dtype: torch.dtype, kinds) -> str:
    """The kernel template ``body`` over operands of ``kinds`` runs; raises
    on a combination the kernel has no instantiation for."""
    key = (dtype, body, tuple(kinds))
    if key not in INSTANTIATIONS:
        raise ValueError(f'stream_map: no {dtype} {body} kernel for kinds {list(kinds)}')
    return INSTANTIATIONS[key]


# ---------------------------------------------------------------------------
# the routing rule (dsc_tpu/ops/pallas_map.py:295-356)
# ---------------------------------------------------------------------------


def classify(shapes):
    """(target_shape, kinds) with kinds[i] in {'full', 'scalar', 'brow'},
    or None when some operand fits no streamable pattern
    (pallas_map._classify)."""
    shp = [tuple(s) for s in shapes]
    sizes = [math.prod(s) for s in shp]
    mx = max(sizes)
    if mx == 1:
        return None
    fulls = {s for s, ne in zip(shp, sizes) if ne == mx}
    if len(fulls) != 1:
        return None
    tgt = next(iter(fulls))
    m = tgt[-1]
    kinds = []
    for s, ne in zip(shp, sizes):
        if ne == mx:
            kinds.append('full')
        elif ne == 1:
            kinds.append('scalar')
        elif (len(tgt) >= 2 and ne == m and s[-1] == m
              and all(d == 1 for d in s[:-1])):
            kinds.append('brow')
        else:
            return None
    return tgt, kinds


def route(shapes, dtypes):
    """(shape, kinds) of the operands when the JAX package's rule
    (pallas_map.eligible) streams them, else None: float32, every operand
    full-shape, 1-element or a broadcast row, at least MIN_ELEMS elements,
    a count that is a multiple of 128, and a broadcast row of M % 128 == 0
    and M/128 <= CHUNK_ROWS. ``dtypes`` are torch dtypes."""
    cl = classify(shapes)
    if cl is None:
        return None
    tgt, kinds = cl
    ne = math.prod(tgt)
    if ne < MIN_ELEMS or ne % LANES:
        return None
    if any(d != torch.float32 for d in dtypes):
        return None
    if 'brow' in kinds:
        m = tgt[-1]
        if m % LANES or m // LANES > CHUNK_ROWS:
            return None
    return cl


def eligible(shapes, dtypes) -> bool:
    """Whether ``route`` streams the operands."""
    return route(shapes, dtypes) is not None


def route_complex(shape_a, shape_b):
    """(shape, kinds) of the port's complex64 route for add/sub/mul/div,
    else None: operands of one shape, or one of them a Python scalar (shape
    None), at least MIN_ELEMS elements. At power-of-two spectra this is the
    decision of the JAX package's planar route."""
    shapes = [tuple(s) for s in (shape_a, shape_b) if s is not None]
    if len(shapes) == 2 and shapes[0] != shapes[1]:
        return None
    if math.prod(shapes[0]) < MIN_ELEMS:
        return None
    return shapes[0], ['scalar' if s is None else 'full' for s in (shape_a, shape_b)]


def eligible_complex(shape_a, shape_b) -> bool:
    """Whether ``route_complex`` streams the operands."""
    return route_complex(shape_a, shape_b) is not None


# ---------------------------------------------------------------------------
# the bodies' plain formulas
# ---------------------------------------------------------------------------


def _f32(c: float) -> float:
    """``c`` rounded to float32, as the kernel holds it."""
    return float(np.float32(c))


# fast f32 sin/cos (dsc_tpu/ops/kernels.py:217-264): Cody-Waite reduction
# x = k*pi + r with a 4-part pi, then a degree-9 odd minimax polynomial
_INV_PI = _f32(0.3183098861837907)
_PI_PARTS = tuple(_f32(c) for c in (3.140625, 0.0009670257568359375,
                                     6.2771141e-07, 1.2154201e-10))
_SINPOLY = tuple(_f32(c) for c in (0.9999999946625908, -0.16666656657956302,
                                    0.008333024646433733,
                                    -0.00019807388155308192,
                                    2.601842986663649e-06))
_PI = _f32(math.pi)


def _sin_reduced(r):
    r2 = r * r
    p = r2 * _SINPOLY[4] + _SINPOLY[3]
    for c in _SINPOLY[2::-1]:
        p = p * r2 + c
    return r * p


def fast_sin_f32(x: torch.Tensor) -> torch.Tensor:
    k = torch.round(x * _INV_PI)
    r = x
    for part in _PI_PARTS:
        r = r - k * part
    s = _sin_reduced(r)
    return torch.where((k.to(torch.int32) & 1) == 1, -s, s)


def fast_cos_f32(x: torch.Tensor) -> torch.Tensor:
    # cos(x) = sin(x + pi/2) against the half-integer grid j = k - 1/2
    k = torch.round(x * _INV_PI + 0.5)
    j = k - 0.5
    r = x
    for part in _PI_PARTS:
        r = r - j * part
    s = _sin_reduced(r)
    return torch.where((k.to(torch.int32) & 1) == 1, -s, s)


def _sinc(x):
    px = x * _PI
    return torch.where(x == 0, 1.0, torch.sin(px) / px)


def _clip(x, lo, hi):
    if isinstance(x, torch.Tensor) or isinstance(lo, torch.Tensor):
        y = torch.where(x < lo, lo, x)
    else:  # two scalars: torch.where takes no Python bool
        y = lo if x < lo else x
    return torch.where(y > hi, hi, y)


_REAL_FNS = {
    'add': lambda a, b: a + b,
    'sub': lambda a, b: a - b,
    'mul': lambda a, b: a * b,
    'div': lambda a, b: a / b,
    'sin': fast_sin_f32,
    'cos': fast_cos_f32,
    'exp': torch.exp,
    'logn': torch.log,
    'log2': torch.log2,
    'log10': torch.log10,
    'sqrt': torch.sqrt,
    'sinc': _sinc,
    'clip': _clip,
}


def complex_math(ar, ai, br, bi, name: str):
    """Complex add/sub/mul/div on real and imaginary parts
    (dsc_tpu/planar.py:_complex_math)."""
    if name == 'add':
        return ar + br, ai + bi
    if name == 'sub':
        return ar - br, ai - bi
    if name == 'mul':
        return ar * br - ai * bi, ar * bi + ai * br
    if name == 'div':
        d = br * br + bi * bi
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d
    raise ValueError(f'no complex body {name!r}')


def _parts(x):
    if isinstance(x, torch.Tensor):
        return x.real, x.imag
    x = complex(x)
    return x.real, x.imag


# ---------------------------------------------------------------------------
# plain version and kernel wrapper
# ---------------------------------------------------------------------------


def _layout(body: str, operands):
    """(output shape, kinds, dtype) of ``body`` over ``operands``; raises
    on what the kernel does not take."""
    if body not in REAL_BODIES:
        raise ValueError(f'stream_map: no body {body!r}')
    if len(operands) != REAL_BODIES[body]:
        raise ValueError(f'stream_map: {body} takes {REAL_BODIES[body]} '
                         f'operands, got {len(operands)}')
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.complex64}:
        raise ValueError(f'stream_map: operands must share float32 or '
                         f'complex64, got {sorted(map(str, dtypes))}')
    dtype = dtypes.pop()
    cl = classify([tuple(x.shape) if isinstance(x, torch.Tensor) else ()
                   for x in operands])
    if cl is None:
        raise ValueError('stream_map: operands are not full, brow or scalar')
    shape, kinds = cl
    if dtype == torch.float32 and any(isinstance(x, complex) for x in operands):
        raise ValueError('stream_map: a complex scalar needs complex64 tensors')
    instantiation(body, dtype, kinds)
    return shape, kinds, dtype


def stream_map_plain(body: str, *operands) -> torch.Tensor:
    """Plain PyTorch version of K5: ``body`` over ``operands`` with the
    kernel's formulas in the same order."""
    shape, kinds, dtype = _layout(body, operands)
    m = shape[-1]
    rows = 'brow' in kinds
    args = []
    for x, kind in zip(operands, kinds):
        if not isinstance(x, torch.Tensor):
            args.append(x)
        elif kind == 'full':
            args.append(x.reshape(-1, m) if rows else x.reshape(-1))
        elif kind == 'brow':
            args.append(x.reshape(m))
        else:
            args.append(x.reshape(()))
    if dtype == torch.complex64:
        yr, yi = complex_math(*_parts(args[0]), *_parts(args[1]), body)
        return torch.complex(yr, yi).reshape(shape)
    return _REAL_FNS[body](*args).reshape(shape)


def stream_map(body: str, *operands, layout=None) -> torch.Tensor:
    """K5 on CUDA tensors, its plain version on CPU tensors. ``layout``:
    the (shape, kinds) that ``route`` or ``route_complex`` returned for
    these operands, which then are not classified again."""
    shape, kinds = _layout(body, operands)[:2] if layout is None else layout
    first = next(x for x in operands if isinstance(x, torch.Tensor))
    device, dtype = first.device, first.dtype
    if device.type in ('cpu', 'meta'):
        # meta: dsc.map records the plain formulas op by op (map_gen.py)
        return stream_map_plain(body, *operands)
    args = []
    for i in range(3):
        if i >= len(operands):
            args += [None, 0.0, 0.0, _VALUE, 0]
            continue
        x, kind = operands[i], kinds[i]
        if not isinstance(x, torch.Tensor):
            v = complex(x)
            args += [None, v.real, v.imag, _VALUE, 0]
            continue
        if x.device != device:
            raise RuntimeError(f'stream_map: operands on {x.device} and {device}')
        build.check(x, dtype, x.shape, f'stream_map operand {i}')
        if kind == 'brow' and shape[-1] % 4:
            raise RuntimeError(f'stream_map: a broadcast row of {shape[-1]} '
                               'elements is not a multiple of 4')
        args += [x.data_ptr(), 0.0, 0.0, _HOST_KIND[kind], shape[-1] if kind == 'brow' else 0]
    out = torch.empty(shape, dtype=dtype, device=device)
    n = out.numel()
    if n == 0:
        return out
    build.launch('stream_map', _CODES[dtype, body], *args, out.data_ptr(), n)
    return out
