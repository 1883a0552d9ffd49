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

``dsc.compile(fn, mesh=, in_specs=, out_specs=)`` is the JAX package's
sharded program over a device mesh (parallel/mesh.py), in one process.
PyTorch has no SPMD partitioner, so the program is the single-device one
run once a shard: each distinct device of the mesh holds one program
(one captured CUDA graph) for the shard's signature, replayed for every
shard that lies on it, with that device current and the context's device
read as it (``context.on_device``), so that what ``fn`` creates lands on
the shard's device. ``fn`` runs on a shard inside ``flags.xla_only()``,
which gates no route: a shard launches the kernels that the
single-device call launches.

- ``in_specs`` align with the positional arguments, one
  ``PartitionSpec`` (``parallel.P``) or None each. A Tensor or NumPy
  argument with ``P('data')`` is cut along dim 0 into one block a 'data'
  coordinate, replicated over the other axes; with ``P(('data',
  'model'))`` into one block a device, block c_data * |model| + c_model,
  as ``NamedSharding`` orders a tuple (parallel/mesh.py). ``P()`` or no spec
  replicates it: one copy a distinct device, kept while the Tensor's
  buffer is unchanged (``torch.Tensor._version``), so a replicated filter
  uploads once. A ``Sharded`` argument with no spec, or with the spec of
  its placement, is used where it lies; any other is gathered and placed.
  A Tensor in the T or half-T layout raises.
- Results: with ``out_specs=P('data')`` (or an axis tuple), or with no
  spec for a result whose blocks tile along the first sharded argument's
  layout, a ``Sharded`` over the mesh, cut over that axis or tuple; a
  result equal on every shard comes back as one Tensor on the mesh's first
  device, and so does a result with ``P()`` whose blocks tile (gathered
  there) or one cut along two dimensions.
- The separability check. Running ``fn`` once a shard is exact only where
  the program mixes no values across a cut dimension; GSPMD would insert a
  collective where it does, and the port has none. So the first call of
  each signature runs the shards and ``fn`` on the global arguments, on
  the mesh's first device, twice: on seeded probe arguments of the same
  shapes and dtypes, placed as the caller's (``_seeded``; the shards'
  trace runs and captures), and on the caller's. Each time the joined
  shard results must tile the global ones and every value agree within
  ``MESH_BOUND`` of max |global|, with no floor, so that a first call of
  small, zero or equal rows cannot certify a program that mixes them.
  Where they do not (a reduction or an FFT over a cut dimension), the call
  raises NotImplementedError and caches nothing. The cost: two global
  evaluations and one more run of the shards a signature, and the global
  problem's memory on the first device; later calls pay nothing.
- Arguments cut differently. Where the shards of the specs' own placement
  fail the check, or cannot run (an elementwise product of a block and a
  replicated argument of the global shape, or of blocks cut over other
  axes), the first call tries each cut argument's layout in turn on every
  argument of its rank and of its size along the cut dimensions, the
  others replicated: the reshard GSPMD would do with a collective, done
  here by placing those arguments anew, on this call and every later one.
  The first placement that the check passes is the program's; where none
  does, the specs' own failure is raised.

``dsc.map(fn)`` fuses an elementwise function into one streaming pass,
kernel K5g (ops/map_gen.py): the signature's route is decided from the
function's recorded op list before any build; a signature outside the
lowering table, or whose operands K5's routing rule does not stream, runs
as the ``dsc.compile`` program of the same function.
"""

from __future__ import annotations

import functools
import itertools
import os
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import capture, context, flags, tracing
from .interop import DTYPE_OF_TORCH, TORCH_DTYPE
from .ops import map_gen
from .ops import stream_map as sm
from .parallel.mesh import Mesh, PartitionSpec, Sharded, axes_of, on
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
    """One signature of a compiled function on one device: its argument
    buffers, its constants and, on a CUDA device, its captured graph."""

    def __init__(self, fn, name: str, slots: Tuple, dev: torch.device):
        self.fn = fn
        self.slots = slots
        self.device = dev
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
        into a CUDA graph on that stream, then its first replay. The stream
        is made on the program's device: ``torch.cuda.graph``'s default
        capture stream is one for the whole process, made on the device
        current at its first use, and a capture there of work on another
        card fails at the first allocation."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._execute()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.state.replaying()
        graph = torch.cuda.CUDAGraph()
        with tracing.suppressed(), torch.cuda.graph(graph, stream=side):
            self.struct, self.outs = self._execute()
        self.graph = graph
        graph.replay()

    def run(self, storages: Sequence[torch.Tensor]) -> Tuple[Tuple, List[Tensor]]:
        """(structure, output Tensors) of one call on the argument buffers
        ``storages``; the outputs belong to the program and are cloned by
        the caller."""
        if self.storages is None:
            self.storages = [s.clone() for s in storages]
            if self.device.type == 'cuda':
                self._capture()
                return self.struct, self.outs
            return self._execute()
        for st, s in zip(self.storages, storages):
            st.copy_(s)
        if self.graph is not None:
            self.graph.replay()
            return self.struct, self.outs
        self.state.replaying()
        with tracing.suppressed():
            return self._execute()


_SCALARS = (bool, int, float, complex, str, type(None))


def _signature(args: Tuple, kwargs: Dict, take, kinds: str) -> Tuple[Tuple, List]:
    """(slots, values) of a call: each argument, positional ones first and
    then keywords by name, is a static slot (a Python scalar) or a Tensor
    slot, whose (payload, value) ``take(position, name, argument)`` gives
    (None: not an argument ``kinds`` names)."""
    slots, values = [], []
    for pos, (name, a) in enumerate([(None, a) for a in args] + sorted(kwargs.items())):
        if isinstance(a, _SCALARS):
            slots.append((_SLOT_STATIC, name, a))
            continue
        got = take(pos, name, a)
        if got is None:
            raise RuntimeError(f'dsc.compile arguments must be {kinds} or Python scalars, '
                               f'got {type(a).__name__}')
        slots.append((_SLOT_TENSOR, name, got[0]))
        values.append(got[1])
    return tuple(slots), values


class _Wrapper:
    """A compiled function: a signature-keyed LRU of ``DSC_MAX_PROGRAMS``
    programs. Called inside another program's function, it runs the
    function inline, as a nested jit does."""

    def __init__(self, fn):
        self._fn = fn
        self._name = getattr(fn, '__name__', 'fn')
        self.__doc__ = getattr(fn, '__doc__', None)
        self.__name__ = self._name
        self._programs: 'OrderedDict[Tuple, Any]' = OrderedDict()

    def __call__(self, *args, **kwargs):
        if capture.current() is not None:
            return self._fn(*args, **kwargs)
        return self._call(*args, **kwargs)

    def _cached(self, key: Tuple):
        prog = self._programs.get(key)
        if prog is not None:
            self._programs.move_to_end(key)
        return prog

    def _keep(self, key: Tuple, prog) -> None:
        while len(self._programs) >= _max_programs():
            self._programs.popitem(last=False)
        self._programs[key] = prog

    @property
    def n_programs(self) -> int:
        return len(self._programs)

    def clear_cache(self) -> None:
        self._programs.clear()


class _Compiled(_Wrapper):
    """One compiled wrapper on the context's device."""

    def _call(self, *args, **kwargs):
        def take(pos, name, a):
            if isinstance(a, np.ndarray):
                a = from_numpy(a)
            return (_spec_of(a), a) if isinstance(a, Tensor) else None

        key, tensors = _signature(args, kwargs, take, 'Tensors, NumPy arrays')
        prog = self._cached(key)
        fresh = prog is None
        if fresh:
            prog = _Program(self._fn, self._name, key, context.device())
        with tracing.trace_op(f'compile:{self._name}', 'op;compile', {'n_args': len(tensors)}):
            struct, outs = prog.run([t._buf.data for t in tensors])
            # fresh Tensors, counted against the memory cap
            result = [t._copy() for t in outs]
        if fresh:
            # cached once its trace run has succeeded
            self._keep(key, prog)
        return _unflatten_result(struct, iter(result))


# ---------------------------------------------------------------------------
# mesh programs
# ---------------------------------------------------------------------------

# the separability check: the joined shard results against the global run,
# relative to max |global| (no floor: a check on small values certifies
# nothing)
MESH_BOUND = 1e-4
# the seed of the check's probe arguments
_PROBE_SEED = 0


# a layout: {dimension: the mesh axes that cut it, major to minor}, in
# dimension order; axes of size 1 are left out, and so is a dimension
# they alone cut
Layout = Dict[int, Tuple[str, ...]]


class _Input(NamedTuple):
    """A Tensor argument of a mesh program: its block on each mesh device
    (the buffer a shard's program copies in), the shard's slot payload
    (``_spec_of``'s tuple), its layout, and the global buffer (a callable)
    with its payload, for the check."""
    blocks: List[torch.Tensor]
    spec: Tuple
    layout: Layout
    glob: Any
    glob_spec: Tuple


class _Output(NamedTuple):
    """How a result leaves a mesh program: its layout (empty: equal on every
    shard), whether it is joined into one Tensor, and its global shape."""
    layout: Layout
    joined: bool
    shape: Tuple[int, ...]


def _layout_of(spec, shape: Tuple[int, ...], mesh: Mesh, who: str,
               divide: bool = True) -> Layout:
    """The layout of the PartitionSpec ``spec`` over ``shape``: each entry
    a mesh axis, a tuple of them or None."""
    if not isinstance(spec, PartitionSpec):
        raise RuntimeError(f'dsc.compile: {who}: expected a PartitionSpec or None, got {spec!r}')
    if len(spec) > len(shape):
        raise RuntimeError(f'dsc.compile: {who}: {spec} names {len(spec)} dimensions of a '
                           f'{len(shape)}-D value {shape}')
    layout: Layout = {}
    named: List[str] = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = axes_of(entry) if isinstance(entry, (str, tuple, list)) else (entry,)
        for axis in axes:
            if not isinstance(axis, str):
                raise RuntimeError(f'dsc.compile: {who}: {spec}: {axis!r} is not a mesh axis name')
            if axis not in mesh.axis_names:
                raise RuntimeError(
                    f'dsc.compile: {who}: mesh axis {axis!r} not in {mesh.axis_names}')
            if axis in named:
                raise RuntimeError(f'dsc.compile: {who}: {spec} names mesh axis {axis!r} twice')
            named.append(axis)
        size = mesh.axis_size(axes)
        if divide and shape[dim] % size:
            raise RuntimeError(f'dsc.compile: {who}: dimension {dim} of {shape} is not divisible '
                               f'by the mesh axes {entry!r} ({size})')
        axes = tuple(a for a in axes if mesh.shape[a] > 1)
        if axes:
            layout[dim] = axes
    return layout


def _spec_text(layout: Layout) -> str:
    parts = [None] * (max(layout) + 1 if layout else 0)
    for dim, axes in layout.items():
        parts[dim] = axes[0] if len(axes) == 1 else axes
    return repr(PartitionSpec(*parts))


def _tiled(shape: Tuple[int, ...], layout: Layout, mesh: Mesh) -> Tuple[int, ...]:
    """The global shape whose blocks under ``layout`` have ``shape``."""
    out = list(shape)
    for dim, axes in layout.items():
        out[dim] *= mesh.axis_size(axes)
    return tuple(out)


def _free_axes(layout: Layout, mesh: Mesh) -> List[str]:
    """The mesh axes that ``layout`` does not cut along."""
    cut = [a for axes in layout.values() for a in axes]
    return [a for a in mesh.axis_names if a not in cut]


def _block_index(axes: Tuple[str, ...], coords: Dict[str, int], mesh: Mesh) -> int:
    """The block of a dimension cut over ``axes`` that the device at
    ``coords`` holds: its flat index over ``axes``, major to minor."""
    index = 0
    for axis in axes:
        index = index * mesh.shape[axis] + coords[axis]
    return index


def _natural(t: Tensor) -> torch.Tensor:
    """A copy of a program output's values in natural order, in its shape."""
    data = t._buf.data.clone() if t._buf.layout is None else t._buf.natural()
    return data.view(t._shape)


def _agree(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Same shape and dtype, and every value within MESH_BOUND of
    max |want|; a non-finite value must be matched exactly."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if want.numel() == 0:
        return True
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    err = torch.where(same, 0.0, (got - want).abs().double())
    finite = torch.where(torch.isfinite(want), want.abs().double(), 0.0)
    return bool(err.max() <= MESH_BOUND * float(finite.max()))


def _seeded(shape: Tuple[int, ...], dtype: torch.dtype, dev: torch.device,
            gen: torch.Generator) -> torch.Tensor:
    """A probe argument: floating values (and complex values' real and
    imaginary parts) uniform in [0.25, 0.75), away from the zeros and
    negatives of log, sqrt and division; integers in [1, 3); booleans at
    random."""
    if dtype.is_complex:
        return (0.25 + 0.25j) + 0.5 * torch.rand(shape, generator=gen, dtype=dtype, device=dev)
    if dtype.is_floating_point:
        return 0.25 + 0.5 * torch.rand(shape, generator=gen, dtype=dtype, device=dev)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen, device=dev) > 0
    return torch.randint(1, 3, shape, generator=gen, dtype=dtype, device=dev)


class _MeshProgram:
    """One signature of a mesh program: one ``_Program`` a distinct device,
    the result structure and how each result leaves."""

    def __init__(self, fn, name: str, slots: Tuple, devices: Sequence[torch.device]):
        self.programs = {dev: _Program(fn, name, slots, dev) for dev in devices}
        self.struct: Optional[Tuple] = None
        self.outputs: List[_Output] = []
        # the layout each argument runs in (_MeshCompiled._placements)
        self.layouts: List[Layout] = []

    def run(self, mesh: Mesh, inputs: Sequence[_Input]) -> List[List[torch.Tensor]]:
        """Each shard's results, in natural order, in mesh device order."""
        results = []
        for i, dev in enumerate(mesh.device_list):
            with on(dev), context.on_device(dev), flags.xla_only():
                self.struct, outs = self.programs[dev].run([inp.blocks[i] for inp in inputs])
                results.append([_natural(o) for o in outs])
        return results


class _MeshCompiled(_Wrapper):
    """One compiled wrapper over a mesh: its programs are ``_MeshProgram``s
    (the module docstring)."""

    def __init__(self, fn, mesh: Mesh, in_specs=None, out_specs=None):
        if not isinstance(mesh, Mesh):
            raise RuntimeError(f'dsc.compile: mesh= takes a parallel.Mesh, got {mesh!r}')
        super().__init__(fn)
        self._mesh = mesh
        self._in_specs = None if in_specs is None else tuple(in_specs)
        self._out_specs = out_specs
        self._devices = list(dict.fromkeys(mesh.device_list))
        self._coords = [{a: int(c) for a, c in zip(mesh.axis_names,
                                                   np.unravel_index(i, mesh.devices.shape))}
                        for i in range(mesh.size)]
        # sticky placement: a replicated Tensor's copies, by its buffer:
        # (the buffer's data, its version counter, {device: copy})
        self._replicas: 'weakref.WeakKeyDictionary' = weakref.WeakKeyDictionary()

    # -- placement -----------------------------------------------------------

    def _replicated(self, t: Tensor) -> List[torch.Tensor]:
        """The Tensor's buffer on each mesh device: itself where it lies,
        else a copy kept until the buffer is replaced or written to."""
        buf = t._buf
        data = buf.data
        hit = self._replicas.get(buf)
        if hit is None or hit[0] is not data or hit[1] != data._version:
            copies = {dev: data if data.device == dev else data.to(dev) for dev in self._devices}
            hit = (data, data._version, copies)
            self._replicas[buf] = hit
        return [hit[2][dev] for dev in self._mesh.device_list]

    def _cut(self, g: torch.Tensor, layout: Layout) -> List[torch.Tensor]:
        """The block of ``g`` each mesh device's coordinates select, on that
        device (a view where it lies there and is contiguous)."""
        mesh = self._mesh
        blocks = []
        for dev, coords in zip(mesh.device_list, self._coords):
            b = g
            for dim, axes in layout.items():
                size = g.shape[dim] // mesh.axis_size(axes)
                b = b.narrow(dim, _block_index(axes, coords, mesh) * size, size)
            blocks.append(b.to(dev).contiguous())
        return blocks

    def _lies(self, a: Sharded, spec, who: str) -> Optional[Layout]:
        """The layout of a Sharded argument laid out on this mesh as ``spec``
        asks (None: as it is), else None."""
        mesh = self._mesh
        if a.mesh is not mesh or a.tail is not None or a.dtype not in DTYPE_OF_TORCH:
            return None
        axes = tuple(x for x in axes_of(a.axis) if mesh.shape[x] > 1)
        layout = {a.dim: axes} if axes else {}
        if spec is not None and _layout_of(spec, a.shape, mesh, who) != layout:
            return None
        block = list(a.shape)
        for dim, axes in layout.items():
            block[dim] //= mesh.axis_size(axes)
        if all(tuple(s.shape) == tuple(block) and s.device == dev
               for s, dev in zip(a.shards, mesh.device_list)):
            return layout
        return None

    def _input(self, a, spec, who: str) -> _Input:
        mesh = self._mesh
        if isinstance(a, Sharded):
            layout = self._lies(a, spec, who)
            if layout is not None:
                shape = tuple(a.shards[0].shape)
                dtype = DTYPE_OF_TORCH[a.dtype]
                return _Input([s.contiguous() for s in a.shards], (shape, dtype, shape, None),
                              layout, a.full, (a.shape, dtype, a.shape, None))
            a = Tensor._from_torch(a.full())
        elif isinstance(a, np.ndarray):
            with context.on_device(mesh.device_list[0]):
                a = from_numpy(a)
        if a._buf.layout is not None:
            raise RuntimeError(
                f'dsc.compile(mesh=...): {who} is stored in the T or half-T layout (the JAX '
                "package's hermitian-half / fourstep planes), which a PartitionSpec cannot cut; "
                'pass a natural-order copy')
        glob_spec = _spec_of(a)
        layout = {} if spec is None else _layout_of(spec, a._shape, mesh, who)
        if not layout:
            return _Input(self._replicated(a), glob_spec, {}, lambda: a._buf.data, glob_spec)
        blocks = self._cut(a.torch, layout)
        shape = tuple(blocks[0].shape)
        return _Input(blocks, (shape, a._dtype, shape, None), layout, lambda: a._buf.data,
                      glob_spec)

    def _probe(self, inp: _Input, gen: torch.Generator) -> _Input:
        """``inp`` with seeded values (``_seeded``) in place of the caller's,
        placed as ``inp`` is: the check's second argument set, which a
        small, zero or constant first call cannot make pass."""
        mesh = self._mesh
        shape, dtype = inp.glob_spec[0], inp.glob_spec[1]
        if inp.layout:
            g = _seeded(shape, TORCH_DTYPE[dtype], mesh.device_list[0], gen)
            return inp._replace(blocks=self._cut(g, inp.layout), glob=lambda: g,
                                glob_spec=(shape, dtype, shape, None))
        g = _seeded(inp.glob_spec[2], TORCH_DTYPE[dtype], mesh.device_list[0], gen)
        copies = {dev: g.to(dev) for dev in self._devices}
        return inp._replace(blocks=[copies[dev] for dev in mesh.device_list], glob=lambda: g)

    def _placed(self, inp: _Input, layout: Layout) -> _Input:
        """``inp`` placed under ``layout`` from its global value: cut, or
        replicated where ``layout`` is empty; ``inp`` where it lies so."""
        if layout == inp.layout:
            return inp
        shape, dtype = inp.glob_spec[0], inp.glob_spec[1]
        g = inp.glob().reshape(shape)
        if layout:
            blocks = self._cut(g, layout)
            block = tuple(blocks[0].shape)
            return inp._replace(blocks=blocks, spec=(block, dtype, block, None), layout=layout)
        copies = {dev: g.to(dev).contiguous() for dev in self._devices}
        return inp._replace(blocks=[copies[dev] for dev in self._mesh.device_list],
                            spec=(shape, dtype, shape, None), layout={})

    def _placements(self, inputs: Sequence[_Input]) -> List[List[Layout]]:
        """The argument layouts a first call tries, in order (the module
        docstring): the specs' own, then each cut argument's layout on every
        argument of its rank and of its size along the dimensions it cuts,
        the others replicated."""
        out = [[inp.layout for inp in inputs]]
        for lead in inputs:
            if not lead.layout:
                continue
            shape = lead.glob_spec[0]
            cand = [lead.layout if len(inp.glob_spec[0]) == len(shape)
                    and all(inp.glob_spec[0][d] == shape[d] for d in lead.layout) else {}
                    for inp in inputs]
            if cand not in out:
                out.append(cand)
        return out

    # -- the separability check ----------------------------------------------

    def _global_run(self, slots: Tuple, inputs: Sequence[_Input]) -> List[torch.Tensor]:
        """``fn`` once on copies of the global arguments on the mesh's first
        device: its results in natural order."""
        dev = self._mesh.device_list[0]
        it = iter(inputs)
        glob_slots = tuple((kind, name, next(it).glob_spec if kind == _SLOT_TENSOR else p)
                           for kind, name, p in slots)
        prog = _Program(self._fn, self._name, glob_slots, dev)
        prog.storages = [inp.glob().to(dev, copy=True) for inp in inputs]
        with on(dev), context.on_device(dev), flags.xla_only():
            return [_natural(o) for o in prog._execute()[1]]

    def _join(self, blocks: Sequence[torch.Tensor], layout: Layout,
              rest: Dict[str, int]) -> torch.Tensor:
        """The blocks of the shards at coordinates ``rest`` of the axes
        outside ``layout``, joined on the mesh's first device."""
        mesh = self._mesh
        dev = mesh.device_list[0]
        dims = list(layout)
        # the shard holding each combination of blocks, one array axis a
        # cut dimension
        holder = np.empty([mesh.axis_size(layout[d]) for d in dims], dtype=np.int64)
        for i, coords in enumerate(self._coords):
            if all(coords[a] == c for a, c in rest.items()):
                holder[tuple(_block_index(layout[d], coords, mesh) for d in dims)] = i

        def cat(arr, k):
            if k == len(dims):
                return blocks[int(arr)].to(dev)
            return torch.cat([cat(arr[c], k + 1) for c in range(arr.shape[0])], dims[k])

        return cat(holder, 0)

    def _outputs(self, results, glob: List[torch.Tensor], default: Layout,
                 inputs: Sequence[_Input]) -> List[_Output]:
        """Each result's ``_Output``, once the shards' results are held to
        the global run; NotImplementedError where they disagree."""
        mesh = self._mesh
        specs = self._out_specs
        if specs is None or isinstance(specs, PartitionSpec):
            specs = [specs] * len(glob)
        elif len(specs) != len(glob):
            raise RuntimeError(f'dsc.compile out_specs has {len(specs)} entries for '
                               f'{len(glob)} output tensors')
        cut = ', '.join(f'argument {k} with {_spec_text(inp.layout)}'
                        for k, inp in enumerate(inputs) if inp.layout)
        cut = cut or 'every argument replicated'
        outputs = []
        for k, (spec, want) in enumerate(zip(specs, glob)):
            local, shape = tuple(results[0][k].shape), tuple(want.shape)
            replicate = spec is None or spec == PartitionSpec()
            if replicate:
                layout = {d: axes for d, axes in default.items() if d < len(local)}
            else:
                layout = _layout_of(spec, local, mesh, f'out_specs of output {k}', divide=False)
            if layout and _tiled(local, layout, mesh) == shape:
                out = _Output(layout, (spec is not None and replicate) or len(layout) > 1,
                              shape)
            elif replicate and local == shape:
                out = _Output({}, False, shape)
            else:
                raise NotImplementedError(
                    f'dsc.compile(mesh=...) of {self._name}: output {k} of shape {local} on a '
                    f'shard does not tile to the global {shape} with {cut}; the port has no '
                    'collective to reshard it')
            free = _free_axes(out.layout, mesh)
            for rest in itertools.product(*(range(mesh.shape[a]) for a in free)):
                joined = self._join([r[k] for r in results], out.layout, dict(zip(free, rest)))
                if not _agree(joined, want):
                    raise NotImplementedError(
                        f'dsc.compile(mesh=...) of {self._name}: output {k} computed shard by '
                        f'shard differs from the function on the global arguments, with {cut}: '
                        'the function mixes values across a cut dimension (a reduction or an '
                        'FFT over it), where GSPMD would insert a collective and the port has '
                        'none; replicate that argument or cut another dimension')
            outputs.append(out)
        return outputs

    # -- call ------------------------------------------------------------------

    def _call(self, *args, **kwargs):
        if self._in_specs is not None and len(self._in_specs) > len(args):
            raise RuntimeError(f'dsc.compile in_specs has {len(self._in_specs)} entries for '
                               f'{len(args)} positional arguments')

        def take(pos, name, a):
            if not isinstance(a, (Tensor, Sharded, np.ndarray)):
                return None
            spec = (self._in_specs[pos] if self._in_specs is not None and name is None
                    and pos < len(self._in_specs) else None)
            inp = self._input(a, spec, f'argument {pos if name is None else name}')
            return (inp.spec, tuple(sorted(inp.layout.items()))), inp

        key, inputs = _signature(args, kwargs, take,
                                 'Tensors, NumPy arrays, Sharded values')
        prog = self._cached(key)
        fresh = prog is None
        with tracing.trace_op(f'compile:{self._name}', 'op;compile', {'n_args': len(inputs)}):
            if fresh:
                prog, results = self._certify(key, inputs)
            else:
                results = prog.run(self._mesh, [self._placed(inp, layout) for inp, layout
                                                in zip(inputs, prog.layouts)])
            values = [self._result(out, [r[k] for r in results])
                      for k, out in enumerate(prog.outputs)]
        if fresh:
            # cached once the check has passed
            self._keep(key, prog)
        return _unflatten_result(prog.struct, iter(values))

    def _certify(self, key: Tuple, inputs: Sequence[_Input]):
        """A signature's first call: (the program, its results on the
        caller's arguments) of the first placement (``_placements``) whose
        shards join to ``fn`` on the global arguments, on seeded probe
        values (the shards' trace runs and captures) and then on the
        caller's. Where none does, the specs' own failure is raised."""
        mesh = self._mesh
        gen = torch.Generator(mesh.device_list[0]).manual_seed(_PROBE_SEED)
        probe = [self._probe(inp, gen) for inp in inputs]
        glob_probe, glob = self._global_run(key, probe), None
        failure = None
        for layouts in self._placements(inputs):
            placed = [self._placed(inp, layout) for inp, layout in zip(inputs, layouts)]
            it = iter(placed)
            slots = tuple((kind, name, next(it).spec if kind == _SLOT_TENSOR else p)
                          for kind, name, p in key)
            prog = _MeshProgram(self._fn, self._name, slots, self._devices)
            prog.layouts = layouts
            default = next((layout for layout in layouts if layout), {})
            try:
                prog.outputs = self._outputs(
                    prog.run(mesh, [self._placed(p, layout) for p, layout in zip(probe, layouts)]),
                    glob_probe, default, placed)
                results = prog.run(mesh, placed)
                if glob is None:
                    glob = self._global_run(key, inputs)
                self._outputs(results, glob, default, placed)
                return prog, results
            except Exception as err:  # a shard run that raises, or the check
                failure = failure or err
        raise failure

    def _result(self, out: _Output, blocks: List[torch.Tensor]):
        """One result: a Sharded, or a Tensor on the mesh's first device."""
        if not out.layout:
            return Tensor._from_torch(blocks[0])
        if out.joined:
            return Tensor._from_torch(self._join(
                blocks, out.layout, dict.fromkeys(_free_axes(out.layout, self._mesh), 0)))
        (dim, axes), = out.layout.items()
        return Sharded(self._mesh, axes, dim, blocks, out.shape)


def compile(fn=None, *, mesh=None, in_specs=None, out_specs=None):  # noqa: A001
    """Compile ``fn(*tensors) -> Tensor(s)`` into one program per argument
    signature: a captured CUDA graph on a CUDA device. Usable as a
    decorator::

        @dsc.compile
        def pipeline(sig, flt):
            return dsc.irfft(dsc.rfft(sig) * dsc.rfft(flt))

    With ``mesh=`` (a ``parallel.Mesh``) the program runs once a shard over
    the mesh: ``in_specs`` (a ``parallel.P`` or None for each positional
    argument) say how the arguments are cut, ``out_specs`` (one spec for
    every result, or one for each) how the results leave::

        mesh = dsc.make_mesh((8, 1))
        pipe = dsc.compile(pipeline, mesh=mesh,
                           in_specs=(P('data'), P()), out_specs=P('data'))

    The first call of each signature also runs ``fn`` on the global
    arguments, on seeded probe values and on the caller's, and refuses
    (NotImplementedError) a program whose shards do not join to those
    results.

    See the module docstring for the semantics and restrictions."""
    if fn is None:
        return functools.partial(compile, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    if mesh is None:
        if in_specs is not None or out_specs is not None:
            raise RuntimeError('dsc.compile: in_specs/out_specs need mesh=')
        return _Compiled(fn)
    return _MeshCompiled(fn, mesh, in_specs, out_specs)


class _Mapped(_Wrapper):
    """One fused-elementwise wrapper: its programs are ('stream',
    map_gen.MapKernel, result structure) or ('compile',), the route through
    the ``dsc.compile`` program of the same function."""

    def __init__(self, fn):
        super().__init__(fn)
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

        with capture.pseudo(), tracing.suppressed(), flags.kernel_trace():
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
        prog = self._cached(key)
        if prog is None:
            prog = self._make_program(args)
            self._keep(key, prog)
        if prog[0] == 'compile':
            return self._fallback(*args)
        _, kernel, struct = prog
        with tracing.trace_op(f'map:{self._name}', 'op;map', {'n_args': len(args)}):
            outs = kernel([a.torch for a in args])
            result = [Tensor._from_torch(o) for o in outs]
        return _unflatten_result(struct, iter(result))


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
