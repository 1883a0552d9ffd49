"""Device meshes and sharded values (dsc_tpu/parallel/mesh.py).

The JAX package is single-controller: one process holds the global array
and ``shard_map`` runs a local body on every device of a ``Mesh``. The
port keeps that shape in one process:

- a ``Mesh`` is a grid of ``torch.device``s with named axes ('data' for
  the batch, 'model' for the transform length); by default every CUDA
  device on 'data';
- a device may appear more than once, which makes a virtual mesh: four
  entries of ``cuda:0`` run a 4-way partition, offsets and exchanges
  included, on one card, as ``--xla_force_host_platform_device_count``
  gives the JAX package eight host devices;
- a ``Sharded`` value holds one shard a mesh device: the block of the
  global array that the device's coordinates along one mesh axis, or a
  tuple of them, select, replicated over the other axes;
- a ``PartitionSpec`` (``P``) says how ``dsc.compile(mesh=...)`` places an
  argument or a result (fuse.py): one entry a dimension, a mesh axis name,
  a tuple of them or None, as ``jax.sharding.PartitionSpec``; ``P()``
  replicates.

A dimension cut over a tuple of axes is cut into the product of their
sizes, in ``NamedSharding``'s order, major to minor over the tuple: under
``P(('data', 'model'))`` the device at (c_data, c_model) holds block
c_data * |model| + c_model, under ``P(('model', 'data'))`` block
c_model * |data| + c_data.

There is no process group here: an exchange between shards is a set of
block copies (``Tensor.copy_``), peer copies between distinct cards and
slice copies on one device.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# one mesh axis name, or a tuple of them cutting one dimension
Axes = Union[str, Tuple[str, ...]]


def axes_of(axis: Axes) -> Tuple[str, ...]:
    """The tuple of mesh axis names that ``axis`` names."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_key(axis: Axes) -> Axes:
    """``axis`` as a name where it names one axis, else as a tuple: the
    form a Sharded value keeps (``P(('data',))`` is ``P('data')``)."""
    axes = axes_of(axis)
    return axes[0] if len(axes) == 1 else axes


class Mesh:
    """A grid of devices with named axes; ``shape[axis]`` is the axis's
    size, as for ``jax.sharding.Mesh``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise RuntimeError(f'mesh of {devices.ndim} dims with axis names {axis_names}')
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> 'OrderedDict[str, int]':
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_list(self) -> List[torch.device]:
        """The devices in row-major order: shard i of a Sharded lies on
        device_list[i]."""
        return list(self.devices.flat)

    def _dims(self, axis: Axes) -> List[int]:
        """The positions of the axes ``axis`` names; RuntimeError for an
        axis the mesh lacks or one named twice."""
        axes = axes_of(axis)
        for a in axes:
            if a not in self.axis_names:
                raise RuntimeError(f'mesh axis {a!r} not in {self.axis_names}')
        if len(set(axes)) != len(axes):
            raise RuntimeError(f'mesh axes {axes} name an axis twice')
        return [self.axis_names.index(a) for a in axes]

    def axis_size(self, axis: Axes) -> int:
        """The number of blocks ``axis`` cuts a dimension into: the product
        of the sizes of the axes it names."""
        return int(np.prod([self.devices.shape[d] for d in self._dims(axis)], dtype=np.int64))

    def groups(self, axis: Axes) -> List[List[int]]:
        """The flat device indices grouped along ``axis`` (one axis or a
        tuple): one group for each coordinate of the other axes, ordered by
        the flat index over ``axis``, major to minor, which is the block
        each device holds."""
        dims = self._dims(axis)
        idx = np.arange(self.size).reshape(self.devices.shape)
        moved = np.moveaxis(idx, dims, range(idx.ndim - len(dims), idx.ndim))
        return moved.reshape(-1, self.axis_size(axis)).tolist()

    def __repr__(self) -> str:
        return f'Mesh({dict(self.shape)}, devices={[str(d) for d in self.device_list]})'


class PartitionSpec(tuple):
    """The mesh axis, or tuple of axes, that cuts each dimension (None: not
    cut), as
    ``jax.sharding.PartitionSpec``; trailing dimensions not named are not
    cut, and ``P()`` replicates."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f'P({", ".join(map(repr, self))})'


P = PartitionSpec


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', torch.cuda.current_device())
    return d


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ('data', 'model'),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2-D ('data', 'model') mesh. Default: every CUDA device on
    'data'. With no CUDA device, ``devices`` must be given (e.g. eight
    entries of ``torch.device('cpu')``): the mesh never falls back to the
    CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA device; pass devices= to build a mesh of '
                               'other devices (e.g. [torch.device("cpu")] * 8)')
        devices = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise RuntimeError(f'mesh shape {shape} != {n} devices')
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def on(device: torch.device):
    """The context a local body runs in: ``device`` made current (its
    current stream takes the launches and copies), nothing on the CPU."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Sharded:
    """A value over ``mesh`` cut along ``dim`` into one block a coordinate
    of mesh axis ``axis``, or a flat coordinate over a tuple of axes (the
    module docstring): ``shards[i]`` lies on ``mesh.device_list[i]``.
    The global value is the blocks of any group (``mesh.groups(axis)``)
    joined along ``dim``, flattened and followed by ``tail`` where there
    is one (the last bin of a half spectrum), and reshaped to ``shape``.
    ``np.asarray`` and ``full()`` gather it."""

    def __init__(self, mesh: Mesh, axis: Axes, dim: int, shards: Sequence[torch.Tensor],
                 shape: Tuple[int, ...], tail: Optional[torch.Tensor] = None):
        if len(shards) != mesh.size:
            raise RuntimeError(f'{len(shards)} shards for a mesh of {mesh.size} devices')
        mesh.axis_size(axis)  # raises for an axis the mesh lacks or one named twice
        self.mesh, self.axis, self.dim = mesh, axis_key(axis), dim
        self.shards = list(shards)
        self.tail = tail
        self.shape = tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def blocks(self, group: Sequence[int]) -> List[torch.Tensor]:
        return [self.shards[i] for i in group]

    def full(self) -> torch.Tensor:
        """The global value gathered onto the first device of the mesh."""
        dev = self.mesh.device_list[0]
        g = torch.cat([b.to(dev) for b in self.blocks(self.mesh.groups(self.axis)[0])],
                      self.dim)
        if self.tail is not None:
            g = torch.cat([g.reshape(-1), self.tail.to(dev).reshape(-1)])
        return g.reshape(self.shape)

    def numpy(self) -> np.ndarray:
        return self.full().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f'Sharded(shape={self.shape}, dtype={self.dtype}, axis={self.axis!r}, '
                f'dim={self.dim}, mesh={dict(self.mesh.shape)})')
