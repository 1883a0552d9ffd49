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
  global array that the device's coordinate along one mesh axis selects,
  replicated over the other axes.

There is no process group here: an exchange between shards is a set of
block copies (``Tensor.copy_``), peer copies between distinct cards and
slice copies on one device.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


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

    def groups(self, axis: str) -> List[List[int]]:
        """The flat device indices grouped along ``axis``: one group for
        each coordinate of the other axes, ordered by the coordinate along
        ``axis``."""
        if axis not in self.axis_names:
            raise RuntimeError(f'mesh axis {axis!r} not in {self.axis_names}')
        idx = np.arange(self.size).reshape(self.devices.shape)
        ax = self.axis_names.index(axis)
        return np.moveaxis(idx, ax, -1).reshape(-1, self.devices.shape[ax]).tolist()

    def __repr__(self) -> str:
        return f'Mesh({dict(self.shape)}, devices={[str(d) for d in self.device_list]})'


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
    of mesh axis ``axis``: ``shards[i]`` lies on ``mesh.device_list[i]``.
    The global value is the blocks of any group (``mesh.groups(axis)``)
    joined along ``dim``, flattened and followed by ``tail`` where there
    is one (the last bin of a half spectrum), and reshaped to ``shape``.
    ``np.asarray`` and ``full()`` gather it."""

    def __init__(self, mesh: Mesh, axis: str, dim: int, shards: Sequence[torch.Tensor],
                 shape: Tuple[int, ...], tail: Optional[torch.Tensor] = None):
        if len(shards) != mesh.size:
            raise RuntimeError(f'{len(shards)} shards for a mesh of {mesh.size} devices')
        self.mesh, self.axis, self.dim = mesh, axis, dim
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
