"""K5g: the streaming map with a body generated from a dsc.map function
(dsc_tpu/fuse.py _Mapped, which runs the user's function inside the Pallas
streaming kernel dsc_tpu/ops/pallas_map.py:_map_kernel through
``stream_map_multi``, :459).

One signature of a ``dsc.map`` function goes through four steps, all in
this module, before its first launch:

1. ``trace``: the function runs once on port Tensors over ``meta`` tensors
   of the operands' shapes, under a ``TorchDispatchMode`` that records the
   aten ops. On ``meta`` the port's ops take their plain formulas (the
   fast sin/cos polynomial, ``_sinc``, ``_clip`` of ops/stream_map.py), so
   the record is the port's plain version, op by op, with no device work.
2. ``lower``: each recorded op becomes one line of CUDA C++ through the
   lowering table (``_ARITH``, ``_UNARY``, ``_COMPARE``, reciprocal, clamp
   and its min/max forms, minimum/maximum, where, pow by a scalar, casts,
   the int32 parity test of the fast sin/cos, views that keep the
   elementwise correspondence). Any op outside the table, any
   value of another shape class than full, broadcast row or scalar, and any
   output that is not float32 of the broadcast shape give None: the
   signature then runs as a ``dsc.compile`` program instead (fuse.py), a
   decision made before any build.
3. ``generate``: the kernel source is csrc/stream_map.cuh (K5's skeleton:
   chunk of kVec x 256 float4 groups a block, operand kinds as template
   arguments, the ragged tail) plus one body functor of N inputs and M
   outputs and one ``extern "C"`` entry point.
4. ``MapKernel``: on CUDA tensors it builds the source once with nvcc for
   sm_90a (kernels/build.py ``build_generated``, cached under
   build/kernels/gen/) and launches it; on CPU tensors it runs the plain
   version, ``interpret``, which replays the recorded op list in torch
   ops. A failed build or launch raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import build
from .stream_map import KIND_ARGS

# the most operands and outputs a generated body takes
MAX_INPUTS = 8
MAX_OUTPUTS = 4


class Op(NamedTuple):
    func: Any        # the aten OpOverload
    args: tuple
    kwargs: dict
    out: Any         # the meta tensor it returned


class _Recorder(TorchDispatchMode):
    """Records every aten op run inside it, with its result."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append(Op(func, args, kwargs, out))
        return out


def trace(run) -> Tuple[List[Op], Any]:
    """Run ``run()`` (the function over port Tensors whose storages are
    meta tensors) under the recorder; (ops, its result)."""
    rec = _Recorder()
    with rec:
        res = run()
    return rec.ops, res


# ---------------------------------------------------------------------------
# lowering: the recorded ops -> lines of a CUDA body
# ---------------------------------------------------------------------------

class Value(NamedTuple):
    expr: str                # a C expression, or None for a literal
    ctype: str               # 'float', 'int' or 'bool'
    shape: Tuple[int, ...]
    lit: Any = None          # the Python value of a literal


class Unsupported(Exception):
    """An op or value outside the lowering table."""


# the dtypes the port's plain formulas compute in: float32 values, the int32
# quadrant of the fast sin/cos, and comparison masks
_CTYPE = {torch.float32: 'float', torch.int32: 'int', torch.bool: 'bool'}

_ARITH = {'add': '+', 'sub': '-', 'mul': '*', 'div': '/'}
_COMPARE = {'lt': '<', 'le': '<=', 'gt': '>', 'ge': '>=', 'eq': '==', 'ne': '!='}
# float32 unary ops: the libm function torch calls for each on the card
# (sin, cos and sinc of the values under K5's size, a broadcast row; round of
# the fast sin/cos)
_UNARY = {'exp': 'expf', 'log': 'logf', 'log2': 'log2f', 'log10': 'log10f', 'sqrt': 'sqrtf',
          'sin': 'sinf', 'cos': 'cosf', 'round': 'rintf', 'sinc': 'dsc_sinc'}
# ops whose result is their first operand's values in another shape
_VIEWS = {'view', 'detach'}
# pow by a scalar exponent as torch computes it (x*x for 2, ...)
_POW = {2.0: '({0} * {0})', 3.0: '({0} * {0} * {0})', 0.5: 'sqrtf({0})', 1.0: '{0}',
        -1.0: '(1.0f / {0})', -2.0: '(1.0f / ({0} * {0}))', -0.5: 'rsqrtf({0})'}


def _literal(v, ctype: str) -> str:
    """``v`` as a C literal of ``ctype``."""
    if ctype == 'bool':
        return 'true' if bool(v) else 'false'
    if ctype == 'int':
        return str(int(v))
    f = np.float32(float(v))
    if np.isnan(f):
        return 'NAN'
    if np.isinf(f):
        return 'INFINITY' if f > 0 else '(-INFINITY)'
    text = str(f)
    if 'e' not in text and '.' not in text:
        text += '.0'
    return f'{text}f' if f >= 0 else f'({text}f)'


class _Lowering:
    """The body of one signature: N inputs of ``kinds`` broadcast to
    ``shape``."""

    def __init__(self, shape: Tuple[int, ...], kinds: Sequence[str]):
        self.shape = tuple(shape)
        self.n = math.prod(shape)
        self.m = shape[-1]
        self.brow = 'brow' in kinds
        self.vals: Dict[int, Value] = {}
        self.lines: List[str] = []

    # -- the shape classes: full, broadcast row, scalar ----------------------

    def check_shape(self, shape) -> Tuple[int, ...]:
        """``shape`` if a value of it is full (any row-major shape of the
        output's count: element i of the flat order), a broadcast row ((1,
        .., 1, M): element i % M) or a scalar; torch's broadcasting of a
        row against a full value then pairs the same elements as the
        kernel does."""
        shape = tuple(shape)
        ne = math.prod(shape)
        if ne in (1, self.n):
            return shape
        if self.brow and ne == self.m and shape[-1] == self.m:
            return shape
        raise Unsupported(f'a value of shape {shape} against {self.shape}')

    # -- operands ------------------------------------------------------------

    def operand(self, a) -> Value:
        if isinstance(a, torch.Tensor):
            v = self.vals.get(id(a))
            if v is not None:
                return v
            if a.dim() == 0 and a.device.type == 'cpu' and a.dtype in _CTYPE:
                return Value(None, _CTYPE[a.dtype], (), a.item())
            raise Unsupported('a tensor that is neither an operand nor computed from one')
        if isinstance(a, bool):
            return Value(None, 'bool', (), a)
        if isinstance(a, int):
            return Value(None, 'int', (), a)
        if isinstance(a, float):
            return Value(None, 'float', (), a)
        raise Unsupported(f'an argument of type {type(a).__name__}')

    @staticmethod
    def as_type(v: Value, ctype: str) -> str:
        if v.expr is None:
            return _literal(v.lit, ctype)
        if v.ctype == ctype:
            return v.expr
        if ctype == 'bool':
            return f'({v.expr} != 0)'
        return f'(({ctype}){v.expr})'

    def define(self, out: torch.Tensor, expr: str) -> None:
        if out.dtype not in _CTYPE:
            raise Unsupported(f'a result of dtype {out.dtype}')
        ctype = _CTYPE[out.dtype]
        name = f'v{len(self.lines)}'
        self.lines.append(f'const {ctype} {name} = {expr};')
        self.vals[id(out)] = Value(name, ctype, self.check_shape(out.shape))

    def literal(self, out: torch.Tensor, value) -> None:
        if out.dtype not in _CTYPE:
            raise Unsupported(f'a result of dtype {out.dtype}')
        self.vals[id(out)] = Value(None, _CTYPE[out.dtype], self.check_shape(out.shape), value)

    # -- the table -------------------------------------------------------------

    def lower(self, op: Op) -> None:
        name = op.func.__name__.split('.')[0]
        if name.endswith('_'):
            raise Unsupported(f'the in-place op {op.func}')
        a = _bound(op)
        out = op.out
        if not isinstance(out, torch.Tensor):
            raise Unsupported(f'{op.func} returns {type(out).__name__}')
        ctype = _CTYPE.get(out.dtype)
        if name in _VIEWS:
            src = self.operand(a['self'])
            self.vals[id(out)] = src._replace(shape=self.check_shape(out.shape))
            return
        if name == '_to_copy':
            if a.get('device') not in (None, out.device) or ctype is None:
                raise Unsupported(f'a copy to {a.get("device")} {out.dtype}')
            src = self.operand(a['self'])
            self.define(out, self.as_type(src, ctype))
            return
        if name == 'scalar_tensor':
            self.literal(out, a['s'])
            return
        if name == 'full':
            self.literal(out, a['fill_value'])
            return
        if name == 'zeros_like':
            self.operand(a['self'])
            self.literal(out, 0)
            return
        if ctype is None:
            raise Unsupported(f'{op.func} gives {out.dtype}')
        if name in _ARITH:
            if a.get('alpha', 1) != 1 or a.get('rounding_mode') is not None:
                raise Unsupported(f'{op.func} with {a}')
            x, y = self.operand(a['self']), self.operand(a['other'])
            self.define(out, f'({self.as_type(x, ctype)} {_ARITH[name]} '
                             f'{self.as_type(y, ctype)})')
        elif name == 'rsub':
            if a.get('alpha', 1) != 1:
                raise Unsupported(f'{op.func} with alpha')
            x, y = self.operand(a['self']), self.operand(a['other'])
            self.define(out, f'({self.as_type(y, ctype)} - {self.as_type(x, ctype)})')
        elif name == 'neg':
            self.define(out, f'(-{self.as_type(self.operand(a["self"]), ctype)})')
        elif name == 'abs' and ctype == 'float':
            self.define(out, f'fabsf({self.as_type(self.operand(a["self"]), ctype)})')
        elif name in _UNARY and ctype == 'float':
            self.define(out, f'{_UNARY[name]}({self.as_type(self.operand(a["self"]), ctype)})')
        elif name == 'reciprocal' and ctype == 'float':
            self.define(out, f'(1.0f / {self.as_type(self.operand(a["self"]), ctype)})')
        elif name == 'pow':
            self.lower_pow(out, a, ctype)
        elif name in ('clamp', 'clamp_min', 'clamp_max') and ctype == 'float':
            # clamp_min has only ``min``, clamp_max only ``max``
            x = self.as_type(self.operand(a['self']), ctype)
            lo, hi = a.get('min'), a.get('max')
            lo_e = '(-INFINITY)' if lo is None else self.as_type(self.operand(lo), ctype)
            hi_e = 'INFINITY' if hi is None else self.as_type(self.operand(hi), ctype)
            self.define(out, f'dsc_clamp({x}, {lo_e}, {hi_e})')
        elif name in ('minimum', 'maximum') and ctype == 'float':
            x, y = self.operand(a['self']), self.operand(a['other'])
            self.define(out, f'dsc_{name}({self.as_type(x, ctype)}, {self.as_type(y, ctype)})')
        elif name == 'where':
            c = self.operand(a['condition'])
            x, y = self.operand(a['self']), self.operand(a['other'])
            self.define(out, f'({self.as_type(c, "bool")} ? {self.as_type(x, ctype)} : '
                             f'{self.as_type(y, ctype)})')
        elif name in _COMPARE:
            x, y = self.operand(a['self']), self.operand(a['other'])
            t = 'float' if 'float' in (x.ctype, y.ctype) else 'int'
            self.define(out, f'({self.as_type(x, t)} {_COMPARE[name]} {self.as_type(y, t)})')
        elif name == 'bitwise_and' and ctype == 'int':
            # the quadrant's parity in the fast sin/cos
            x, y = self.operand(a['self']), self.operand(a['other'])
            self.define(out, f'({self.as_type(x, ctype)} & {self.as_type(y, ctype)})')
        else:
            raise Unsupported(f'the op {op.func}')

    def lower_pow(self, out, a, ctype: str) -> None:
        # the port's power records pow.Tensor_Tensor with the exponent a
        # literal; a tensor exponent is outside the table
        if ctype != 'float':
            raise Unsupported('pow on integers')
        x, e = self.operand(a['self']), self.operand(a['exponent'])
        xe = self.as_type(x, ctype)
        if e.expr is None and float(e.lit) in _POW:
            self.define(out, _POW[float(e.lit)].format(xe))
            return
        if e.expr is not None and e.shape != () and math.prod(e.shape) != 1:
            raise Unsupported('pow by a tensor exponent')
        self.define(out, f'powf({xe}, {self.as_type(e, ctype)})')


def _bound(op: Op) -> Dict[str, Any]:
    """The op's arguments by their schema names."""
    out: Dict[str, Any] = {}
    params = op.func._schema.arguments
    for p, v in zip(params, op.args):
        out[p.name] = v
    out.update(op.kwargs)
    for p in params:
        if p.name not in out and p.has_default_value():
            out[p.name] = p.default_value
    return out


def lower(ops: Sequence[Op], inputs: Sequence[torch.Tensor], outputs: Sequence[torch.Tensor],
          shape, kinds) -> Optional[List[str]]:
    """The body's lines for the recorded ``ops`` (inputs -> outputs, every
    output float32 of ``shape``), or None where some op, value or output
    is outside the lowering table."""
    if not 1 <= len(inputs) <= MAX_INPUTS or not 1 <= len(outputs) <= MAX_OUTPUTS:
        return None
    low = _Lowering(shape, kinds)
    for i, t in enumerate(inputs):
        low.vals[id(t)] = Value(f'in[{i}]', 'float', tuple(t.shape))
    try:
        for op in ops:
            low.lower(op)
        results = []
        for q, t in enumerate(outputs):
            v = low.vals.get(id(t))
            if v is None or t.dtype != torch.float32 or math.prod(t.shape) != low.n:
                raise Unsupported(f'output {q}')
            results.append(f'out[{q}] = {low.as_type(v, "float")};')
    except Unsupported:
        return None
    return low.lines + results


def generate(lines: Sequence[str], kinds: Sequence[str], n_out: int) -> str:
    """The CUDA source of one generated body: stream_map.cuh, the body
    functor and the entry point."""
    n_in = len(kinds)
    body = '\n'.join(f'    {line}' for line in lines)
    kind_args = ', '.join(KIND_ARGS[k] for k in kinds)
    return f'''// K5g: a dsc.map body generated by dsc_tpu_torch/ops/map_gen.py on the
// streaming skeleton of K5 (stream_map.cuh).
#include "stream_map.cuh"

namespace {{

struct Body {{
  __device__ __forceinline__ void operator()(const float (&in)[{n_in}], float (&out)[{n_out}]) const {{
{body}
  }}
}};

}}  // namespace

extern "C" int dsc_map_gen(const void* const* in, const int* rows, void* const* out,
                           long long n, void* stream) {{
  return launch_generated<Body, {n_out}, {kind_args}>(in, rows, out, n, stream);
}}
'''


# ---------------------------------------------------------------------------
# the plain version and the kernel wrapper
# ---------------------------------------------------------------------------


def _substitute(x, env: Dict[int, torch.Tensor], device):
    if isinstance(x, torch.Tensor):
        if id(x) in env:
            return env[id(x)]
        if x.device.type == 'meta':
            raise RuntimeError('map_gen.interpret: a tensor outside the record')
        return x
    if isinstance(x, torch.device) and x.type == 'meta':
        return device
    if isinstance(x, (list, tuple)):
        return type(x)(_substitute(v, env, device) for v in x)
    return x


def interpret(ops: Sequence[Op], inputs: Sequence[torch.Tensor],
              outputs: Sequence[torch.Tensor], operands: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Plain version of K5g: the recorded op list replayed in torch ops on
    ``operands`` (tensors of the traced shapes)."""
    device = operands[0].device
    env = {id(t): x for t, x in zip(inputs, operands)}
    for op in ops:
        args = _substitute(op.args, env, device)
        kwargs = {k: _substitute(v, env, device) for k, v in op.kwargs.items()}
        env[id(op.out)] = op.func(*args, **kwargs)
    return [env[id(t)].contiguous() for t in outputs]


class MapKernel:
    """One signature's K5g: its record, its generated source and, once
    built, its library."""

    def __init__(self, ops, inputs, outputs, shape, kinds, source: str):
        self.ops, self.inputs, self.outputs = ops, inputs, outputs
        self.shape, self.kinds, self.source = tuple(shape), tuple(kinds), source
        self.rows = [shape[-1] if k == 'brow' else 0 for k in kinds]
        self._lib = None

    def plain(self, operands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = interpret(self.ops, self.inputs, self.outputs, operands)
        return [o.reshape(self.shape) for o in outs]

    def __call__(self, operands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """K5g on CUDA tensors, its plain version on CPU tensors."""
        device = operands[0].device
        if device.type == 'cpu':
            return self.plain(operands)
        for i, (x, kind) in enumerate(zip(operands, self.kinds)):
            if x.device != device:
                raise RuntimeError(f'dsc.map: operands on {x.device} and {device}')
            build.check(x, torch.float32, x.shape, f'dsc.map operand {i}')
            if kind == 'brow' and self.shape[-1] % 4:
                raise RuntimeError(f'dsc.map: a broadcast row of {self.shape[-1]} elements '
                                   'is not a multiple of 4')
        if self._lib is None:
            self._lib = build.build_generated(self.source)
        outs = [torch.empty(self.shape, dtype=torch.float32, device=device)
                for _ in self.outputs]
        build.launch_generated(self._lib, operands, self.rows, outs, math.prod(self.shape))
        return outs
