"""dsc.compile and dsc.map on a CUDA device (dsc_tpu/fuse.py).

The JAX package traces a Python function of Tensors once into one XLA
program, so a pipeline runs as one device dispatch. The counterpart here
is one captured CUDA graph per argument signature: its replay runs every
kernel of the function (K1-K4 and the K5 spectrum multiply of a filterFFT
step) with no Python between them.

``dsc.compile(fn)`` keeps the JAX contract:

- arguments are Tensors, NumPy arrays (wrapped) or Python scalars; a
  program is keyed by every Tensor argument's (shape, dtype, buffer shape,
  T layout) and every scalar's value, so a scalar is STATIC: each distinct
  value is its own program (and K5 takes it by value, baked into the
  captured launch);
- programs sit in an LRU of ``DSC_MAX_PROGRAMS`` (32) per wrapper
  (``n_programs``, ``clear_cache``);
- ``fn`` is functional: it runs on copies of its Tensor arguments that the
  program owns, so writes to an argument do not reach the caller's Tensor;
- a creation op inside ``fn`` (``from_numpy``, ``randn``, ``full``, ...)
  is a program constant, the same values every call (capture.py);
- a concrete read (``Tensor.numpy()``, a 1-element unwrap, ``print``)
  raises a RuntimeError that speaks of concrete values;
- each call records one ``compile:<name>`` tracing event; the ops'
  events are recorded in the trace run only;
- only the outputs returned to the caller count against the context's
  memory cap.

A program's first call is its trace run: ``fn`` runs on the argument
copies, building every kernel it reaches and filling the FFT plan cache.
On a CUDA device that run is the warm-up on a side stream, after which
``fn`` runs once more under ``torch.cuda.graph`` capture; each call then
copies its arguments into the graph's input buffers, replays the graph and
clones the outputs out, so it returns fresh Tensors as the JAX package
does, at the cost of one device copy per argument and per output. On the
CPU the program re-runs ``fn`` on its own argument copies with the
recorded constants.

``mesh=``, ``in_specs=`` and ``out_specs=`` (the JAX package's sharded
programs) are not ported: ROADMAP queue 1 item 9, the sharded tier.

``dsc.map(fn)`` fuses an elementwise function into one streaming pass,
kernel K5g (ops/map_gen.py): the signature's route is decided from the
function's recorded op list before any build; a signature outside the
lowering table, or whose operands K5's routing rule does not stream, runs
as the ``dsc.compile`` program of the same function.
"""

from __future__ import annotations

import functools
import os
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from . import capture, tracing
from .context import device
from .interop import TORCH_DTYPE
from .ops import map_gen
from .ops import stream_map as sm
from .tensor import Tensor, _Buffer, from_numpy

__all__ = ['compile', 'map']


def _max_programs() -> int:
    try:
        return max(1, int(os.environ.get('DSC_MAX_PROGRAMS', '32')))
    except ValueError:
        return 32


def _spec_of(t: Tensor) -> Tuple:
    """What a program needs of a Tensor beside its values: the view shape,
    the dtype, the buffer's shape and its T layout (a reshape view shares
    a buffer of another shape)."""
    return (t._shape, t._dtype, tuple(t._buf.data.shape), t._buf.layout)


def _tensor_over(storage: torch.Tensor, spec: Tuple) -> Tensor:
    """A Tensor over ``storage`` matching ``_spec_of``."""
    shape, dtype, _, layout = spec
    t = Tensor.__new__(Tensor)
    t._buf = _Buffer(storage, layout)
    t._shape, t._dtype = shape, dtype
    return t


def _flatten_result(res) -> Tuple[Tuple, List[Tensor]]:
    """(structure, Tensors) of a function's return value: a Tensor or
    nested tuples/lists of Tensors."""
    if isinstance(res, Tensor):
        return ('t',), [res]
    if isinstance(res, (tuple, list)):
        kind = 'tuple' if isinstance(res, tuple) else 'list'
        structs, leaves = [], []
        for r in res:
            s, ls = _flatten_result(r)
            structs.append(s)
            leaves.extend(ls)
        return (kind, tuple(structs)), leaves
    raise RuntimeError(
        'dsc.compile functions must return a Tensor or a tuple/list of '
        f'Tensors, got {type(res).__name__}')


def _unflatten_result(struct: Tuple, it) -> Any:
    if struct[0] == 't':
        return next(it)
    children = [_unflatten_result(s, it) for s in struct[1]]
    return tuple(children) if struct[0] == 'tuple' else children


# argument slots: how each call argument enters the program
_SLOT_TENSOR = 't'
_SLOT_STATIC = 's'


class _Program:
    """One signature of a compiled function: its argument buffers, its
    constants and, on a CUDA device, its captured graph."""

    def __init__(self, fn, name: str, slots: Tuple):
        self.fn = fn
        self.slots = slots
        self.state = capture.Program(name)
        self.storages: Optional[List[torch.Tensor]] = None
        self.graph = None
        self.struct = None
        self.outs: List[Tensor] = []

    def _execute(self) -> Tuple[Tuple, List[Tensor]]:
        """Run ``fn`` on Tensors over the program's argument buffers."""
        it = iter(self.storages)
        args, kwargs = [], {}
        with capture.running(self.state):
            for kind, name, payload in self.slots:
                v = _tensor_over(next(it), payload) if kind == _SLOT_TENSOR else payload
                if name is None:
                    args.append(v)
                else:
                    kwargs[name] = v
            return _flatten_result(self.fn(*args, **kwargs))

    def _capture(self) -> None:
        """The trace run on a side stream, then the capture of a second run
        into a CUDA graph, then its first replay."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._execute()
        torch.cuda.current_stream().wait_stream(side)
        self.state.replaying()
        graph = torch.cuda.CUDAGraph()
        with tracing.suppressed(), torch.cuda.graph(graph):
            self.struct, self.outs = self._execute()
        self.graph = graph
        graph.replay()

    def run(self, tensors: List[Tensor]) -> Tuple[Tuple, List[Tensor]]:
        """(structure, output Tensors) of one call; the outputs belong to
        the program and are cloned by the caller."""
        if self.storages is None:
            self.storages = [t._buf.data.clone() for t in tensors]
            if device().type == 'cuda':
                self._capture()
                return self.struct, self.outs
            return self._execute()
        for st, t in zip(self.storages, tensors):
            st.copy_(t._buf.data)
        if self.graph is not None:
            self.graph.replay()
            return self.struct, self.outs
        self.state.replaying()
        with tracing.suppressed():
            return self._execute()


class _Compiled:
    """One compiled wrapper: a signature-keyed LRU of programs."""

    def __init__(self, fn, mesh=None, in_specs=None, out_specs=None):
        if mesh is not None or in_specs is not None or out_specs is not None:
            raise NotImplementedError(
                'dsc.compile(mesh=, in_specs=, out_specs=): sharded programs are not '
                'ported to the CUDA device yet (ROADMAP queue 1 item 9, the sharded tier)')
        self._fn = fn
        self._name = getattr(fn, '__name__', 'fn')
        self.__doc__ = getattr(fn, '__doc__', None)
        self.__name__ = self._name
        self._programs: 'OrderedDict[Tuple, _Program]' = OrderedDict()

    def __call__(self, *args, **kwargs):
        if capture.current() is not None:
            # inside another program's function: inline, as a nested jit is
            return self._fn(*args, **kwargs)
        slots, tensors = [], []
        for name, a in [(None, a) for a in args] + sorted(kwargs.items()):
            if isinstance(a, np.ndarray):
                a = from_numpy(a)
            if isinstance(a, Tensor):
                slots.append((_SLOT_TENSOR, name, _spec_of(a)))
                tensors.append(a)
            elif isinstance(a, (bool, int, float, complex, str, type(None))):
                slots.append((_SLOT_STATIC, name, a))
            else:
                raise RuntimeError(
                    'dsc.compile arguments must be Tensors, NumPy arrays '
                    f'or Python scalars, got {type(a).__name__}')
        key = tuple(slots)
        prog = self._programs.get(key)
        fresh = prog is None
        if fresh:
            prog = _Program(self._fn, self._name, key)
        else:
            self._programs.move_to_end(key)
        with tracing.trace_op(f'compile:{self._name}', 'op;compile', {'n_args': len(tensors)}):
            struct, outs = prog.run(tensors)
            # fresh Tensors, counted against the memory cap
            result = [t._copy() for t in outs]
        if fresh:
            # cached once its trace run has succeeded
            while len(self._programs) >= _max_programs():
                self._programs.popitem(last=False)
            self._programs[key] = prog
        return _unflatten_result(struct, iter(result))

    @property
    def n_programs(self) -> int:
        return len(self._programs)

    def clear_cache(self) -> None:
        self._programs.clear()


def compile(fn=None, *, mesh=None, in_specs=None, out_specs=None):  # noqa: A001
    """Compile ``fn(*tensors) -> Tensor(s)`` into one program per argument
    signature: a captured CUDA graph on a CUDA device. Usable as a
    decorator::

        @dsc.compile
        def pipeline(sig, flt):
            return dsc.irfft(dsc.rfft(sig) * dsc.rfft(flt))

    See the module docstring for the semantics and restrictions."""
    if fn is None:
        return functools.partial(compile, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    return _Compiled(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


class _Mapped:
    """One fused-elementwise wrapper: a signature-keyed LRU of programs,
    each ('stream', map_gen.MapKernel, result structure) or ('compile',),
    the route through the ``dsc.compile`` program of the same function."""

    def __init__(self, fn):
        self._fn = fn
        self._name = getattr(fn, '__name__', 'fn')
        self.__doc__ = getattr(fn, '__doc__', None)
        self.__name__ = self._name
        self._programs: 'OrderedDict[Tuple, Tuple]' = OrderedDict()
        self._fallback = _Compiled(fn)

    def _make_program(self, args: Tuple[Tensor, ...]) -> Tuple:
        """('stream', kernel, struct) when K5g takes this signature, else
        ('compile',): decided from the traced op list, before any build."""
        if any(a._buf.layout is not None for a in args):
            return ('compile',)
        shapes = [a._shape for a in args]
        layout = sm.route(shapes, [TORCH_DTYPE[a._dtype] for a in args])
        if layout is None:
            return ('compile',)
        shape, kinds = layout
        metas = [torch.empty(s, dtype=torch.float32, device='meta') for s in shapes]

        def run():
            ts = [Tensor._from_torch(m) for m in metas]
            return _flatten_result(self._fn(*ts))

        with capture.pseudo(), tracing.suppressed():
            try:
                ops, (struct, outs) = map_gen.trace(run)
            except Exception:  # fn does not trace on shapes alone: not elementwise
                return ('compile',)
        if any(o._shape != tuple(shape) or o._buf.layout is not None for o in outs):
            return ('compile',)
        out_data = [o._buf.data for o in outs]
        lines = map_gen.lower(ops, metas, out_data, shape, kinds)
        if lines is None:
            return ('compile',)
        source = map_gen.generate(lines, kinds, len(outs))
        kernel = map_gen.MapKernel(ops, metas, out_data, shape, kinds, source)
        return ('stream', kernel, struct)

    def __call__(self, *args):
        args = tuple(from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
        if not args or not all(isinstance(a, Tensor) for a in args):
            raise RuntimeError(
                'dsc.map takes one or more Tensor/ndarray arguments '
                '(bake scalar constants into the function body)')
        key = tuple((a._shape, a._dtype, a._buf.layout is not None) for a in args)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._make_program(args)
            while len(self._programs) >= _max_programs():
                self._programs.popitem(last=False)
            self._programs[key] = prog
        else:
            self._programs.move_to_end(key)
        if prog[0] == 'compile':
            return self._fallback(*args)
        _, kernel, struct = prog
        with tracing.trace_op(f'map:{self._name}', 'op;map', {'n_args': len(args)}):
            outs = kernel([a.torch for a in args])
            result = [Tensor._from_torch(o) for o in outs]
        return _unflatten_result(struct, iter(result))

    @property
    def n_programs(self) -> int:
        return len(self._programs)


def map(fn, *tensors):  # noqa: A001 - public name, mirrors dsc.compile
    """Fuse an elementwise Tensor pipeline into one streaming pass.

    ``dsc.map(fn)`` returns a reusable wrapper; ``dsc.map(fn, x, y)``
    applies it at once. ``fn`` must be elementwise: every output element
    depends only on the same-position input elements (chained + - * /,
    clip, transcendentals; reductions, FFTs and slicing compose under
    ``dsc.compile`` instead). Eager chains pay one read and write of
    device memory per op; under ``dsc.map`` the chain runs inside one
    generated kernel (K5g) that reads each operand and writes each output
    once. Operands follow K5's routing rule (float32, at least 2^21
    elements, full, 1-element or broadcast-row operands); any other
    signature, and any function with an op outside the lowering table, runs
    as one ``dsc.compile`` program of the same function, with the same
    results."""
    wrapper = _Mapped(fn)
    if tensors:
        return wrapper(*tensors)
    return wrapper
