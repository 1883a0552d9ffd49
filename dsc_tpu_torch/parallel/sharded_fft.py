"""Sharded FFTs over a device mesh (dsc_tpu/parallel/sharded_fft.py).

Two parallelism strategies, with the JAX package's names, arguments and
errors:

1. **Batch sharding (DP)**: ``sharded_batched_fft`` / ``_rfft``: each
   device transforms its shard of the batch with the single-device core
   (fourier/core.py), K6/K7 or K12 where the core takes them; no exchange.

2. **Transform sharding**: one FFT of n = n1*n2 points split over the d
   devices of a mesh axis. ``distributed_fft`` runs the core's column
   FFTs on each device's n2/d columns, the four-step twiddle on its rows,
   one all-to-all and the row FFTs. ``distributed_fft_stream`` is the
   streaming four-step itself sharded: K6 local on each column block (its
   global first column col0 in the twiddle, fourier/stream.py
   ``phase_a_local``), the all-to-all, K7 local on the exchanged block
   (``phase_b_local``); ``distributed_rfft_stream`` and
   ``distributed_irfft_stream`` run it at n/2 on the even/odd packing,
   with the Hermitian (un)tangle on the shards.

A local body runs with its device made current (mesh.on) on that
device's current stream, so each launch lands on the device of its
shard. The all-to-all is d*d block copies into new buffers: peer copies
between cards, slice copies on one device, and no block is overwritten
while it is read, also on a virtual mesh that repeats a device. The real
transform's mirror X[h - k] takes each shard's partner block (and one
column of a third shard) by copy: the spectrum is never gathered.

Inputs are tensors (or numpy arrays), which are placed, or ``Sharded``
values: one laid out on this mesh as the function needs is used where it
lies, any other is gathered and placed anew. Results are ``Sharded``
values (``np.asarray`` gathers them).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fourier import core as fft_core
from ..fourier import plan as fft_plan
from ..fourier import stream
from ..kernels import build
from .mesh import Mesh, Sharded, on

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128,
            torch.complex64: torch.complex64, torch.complex128: torch.complex128}


def _input(x):
    """A Sharded value as it is, anything else as a torch tensor."""
    return x if isinstance(x, Sharded) else _as_tensor(x)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    raise TypeError(f'expected a torch tensor, a numpy array or a Sharded value, '
                    f'got {type(x).__name__}')


def _place(x, mesh: Mesh, axis: str, dim: int, layout: Tuple[int, ...],
           shape: Tuple[int, ...], dtype: Optional[torch.dtype] = None,
           has_tail: bool = False, who: str = 'shard') -> Sharded:
    """``x`` as a Sharded value whose blocks cut ``layout`` (the value's
    data, after the tail where ``has_tail``, viewed so) along ``dim`` over
    mesh axis ``axis``; a Sharded ``x`` so laid out on this mesh stays
    where it lies (cast where ``dtype`` differs)."""
    d = mesh.shape[axis]
    if layout[dim] % d:
        raise RuntimeError(f'{who}: dimension {dim} of {layout} is not divisible by the '
                           f'mesh axis {axis!r} ({d})')
    block = (*layout[:dim], layout[dim] // d, *layout[dim + 1:])
    if isinstance(x, Sharded):
        if (x.mesh is mesh and x.axis == axis and x.dim == dim and x.shape == tuple(shape)
                and (x.tail is not None) == has_tail
                and all(tuple(s.shape) == block for s in x.shards)):
            if dtype is None or x.dtype == dtype:
                return x
            return Sharded(mesh, axis, dim, [s.to(dtype) for s in x.shards], shape,
                           None if x.tail is None else x.tail.to(dtype))
        x = x.full()
    t = _as_tensor(x)
    if tuple(t.shape) != tuple(shape):
        raise RuntimeError(f'{who}: expected shape {tuple(shape)}, got {tuple(t.shape)}')
    dtype = dtype or t.dtype
    tail = None
    if has_tail:
        flat = t.reshape(-1)
        t, tail = flat[:-1], flat[-1:].to(mesh.device_list[0], dtype)
    t = t.reshape(layout)
    devices = mesh.device_list
    shards: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        for p, i in enumerate(group):
            s = torch.empty(block, dtype=dtype, device=devices[i])
            s.copy_(t.narrow(dim, p * block[dim], block[dim]), non_blocking=True)
            shards[i] = s
    return Sharded(mesh, axis, dim, shards, shape, tail)


def _map_groups(x: Sharded, body: Callable, dim: int, shape,
                tail: bool = False) -> Sharded:
    """Run ``body(blocks, devices)`` on each group of ``x`` along its axis;
    it returns the group's output blocks (and the tail where ``tail``)."""
    mesh = x.mesh
    devices = mesh.device_list
    shards: List[Optional[torch.Tensor]] = [None] * mesh.size
    last = None
    for group in mesh.groups(x.axis):
        out = body(x.blocks(group), [devices[i] for i in group])
        if tail:
            out, t = out
            last = t if last is None else last
        for i, s in zip(group, out):
            shards[i] = s
    return Sharded(mesh, x.axis, dim, shards, shape, last)


def _all_to_all(blocks: Sequence[torch.Tensor], devices: Sequence[torch.device],
                split_dim: int, concat_dim: int) -> List[torch.Tensor]:
    """``jax.lax.all_to_all(tiled=True)`` over a group: device j gets piece
    j (along ``split_dim``) of every block, joined along ``concat_dim`` in
    block order; d*d copies into new buffers."""
    d = len(blocks)
    piece = blocks[0].shape[split_dim] // d
    width = blocks[0].shape[concat_dim]
    shape = list(blocks[0].shape)
    shape[split_dim], shape[concat_dim] = piece, width * d
    outs = []
    for j, dev in enumerate(devices):
        with on(dev):
            out = torch.empty(shape, dtype=blocks[0].dtype, device=dev)
            for i, b in enumerate(blocks):
                out.narrow(concat_dim, i * width, width).copy_(
                    b.narrow(split_dim, j * piece, piece), non_blocking=True)
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# batch sharding
# ---------------------------------------------------------------------------


def shard_batch(x, mesh: Mesh, axis: str = 'data') -> Sharded:
    """Place a (batch, ...) array with the batch dim sharded over ``axis``."""
    x = _input(x)
    shape = tuple(x.shape)
    return _place(x, mesh, axis, 0, shape, shape, who='shard_batch')


def sharded_batched_fft(x, mesh: Mesh, inverse: bool = False, axis: str = 'data') -> Sharded:
    """Batched FFT with the batch dimension sharded over the mesh (DP).
    x: (b, n) complex, b divisible by mesh axis size."""
    x = _input(x)
    b, n = x.shape
    cdt = _COMPLEX[x.dtype]
    xs = _place(x, mesh, axis, 0, (b, n), (b, n), cdt, who='sharded_batched_fft')

    def body(blocks, devices):
        out = []
        for xb, dev in zip(blocks, devices):
            spec, tables = fft_plan.get_plan(n, 'complex', cdt, dev)
            with on(dev):
                out.append(fft_core.fft_batched(xb, spec, tables, inverse))
        return out

    return _map_groups(xs, body, 0, (b, n))


def sharded_batched_rfft(x, mesh: Mesh, axis: str = 'data') -> Sharded:
    """Batch-sharded REAL FFT: rows of x (b, n) f32 are transformed
    independently, one shard of rows per device, each running the
    single-device rfft engine (K6/K7 at large n). Returns (b, n/2+1)
    complex64."""
    x = _input(x)
    b, n = x.shape
    xs = _place(x, mesh, axis, 0, (b, n), (b, n), torch.float32, who='sharded_batched_rfft')

    def body(blocks, devices):
        out = []
        for xb, dev in zip(blocks, devices):
            spec, tables = fft_plan.get_plan(n, 'real', torch.complex64, dev)
            with on(dev):
                out.append(fft_core.rfft_batched(xb, spec, tables, n))
        return out

    return _map_groups(xs, body, 0, (b, n // 2 + 1))


# ---------------------------------------------------------------------------
# transform sharding through the core
# ---------------------------------------------------------------------------


def _choose_split(n: int, d: int) -> Tuple[int, int]:
    """n = n1 * n2 with both divisible by the mesh size d."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n1 % d or n2 % d:
        raise RuntimeError(
            f'distributed fft needs n1 ({n1}) and n2 ({n2}) divisible by '
            f'the mesh axis size ({d})'
        )
    return n1, n2


@functools.lru_cache(maxsize=64)
def _split_twiddle(n: int, n1: int, n2: int, p: int, d: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """Rows p*n2/d .. (p+1)*n2/d - 1 of Tt[j2, k1] = exp(-2i*pi*k1*j2/n),
    float64 phasors rounded once to ``dtype``, on ``device``."""
    n2d = n2 // d
    j2 = np.arange(p * n2d, (p + 1) * n2d, dtype=np.float64)
    k1 = np.arange(n1, dtype=np.float64)
    tt = np.exp(-2j * np.pi * np.outer(j2, k1) / n)
    return torch.from_numpy(tt).to(device=device, dtype=dtype)


def distributed_fft(x, mesh: Mesh, axis: str = 'model', inverse: bool = False) -> Sharded:
    """FFT of each row of x (b, n), with the *transform* factorized over the
    mesh axis: local column FFTs -> sharded twiddle -> all_to_all -> local
    row FFTs. Returns (b, n) in natural order.
    """
    x = _input(x)
    b, n = x.shape
    d = mesh.shape[axis]
    n1, n2 = _choose_split(n, d)
    cdt = _COMPLEX[x.dtype]
    xs = _place(x, mesh, axis, 2, (b, n1, n2), (b, n), cdt, who='distributed_fft')
    n1d, n2d = n1 // d, n2 // d

    def body(blocks, devices):
        cols = []
        for p, (xb, dev) in enumerate(zip(blocks, devices)):
            # xb: (b, n1, n2/d), this device's j2 columns
            spec1, tables1 = fft_plan.get_plan(n1, 'complex', cdt, dev)
            with on(dev):
                if inverse:
                    xb = torch.conj_physical(xb)
                a = xb.transpose(1, 2).reshape(b * n2d, n1)
                a = fft_core.fft_batched(a, spec1, tables1, False).reshape(b, n2d, n1)
                # the twiddle's rows j2 of this device
                cols.append(a * _split_twiddle(n, n1, n2, p, d, cdt, dev)[None])
        # the four-step transpose: (b, n2/d, n1) -> (b, n2, n1/d)
        rows = _all_to_all(cols, devices, 2, 1)
        out = []
        for a, dev in zip(rows, devices):
            spec2, tables2 = fft_plan.get_plan(n2, 'complex', cdt, dev)
            with on(dev):
                c = a.transpose(1, 2).reshape(b * n1d, n2)
                c = fft_core.fft_batched(c, spec2, tables2, False).reshape(b, n1d, n2)
                # C[b, k1, k2] -> X[b, k1 + n1*k2]: (b, n2, n1/d) blocks of
                # X.reshape(b, n2, n1)
                y = c.transpose(1, 2)
                out.append((torch.conj_physical(y) * (1.0 / n) if inverse else y).contiguous())
        return out

    return _map_groups(xs, body, 2, (b, n))


# ---------------------------------------------------------------------------
# the streaming four-step, sharded
# ---------------------------------------------------------------------------


def _stream_local(blocks: Sequence[torch.Tensor], devices: Sequence[torch.device], n1: int,
                  n2: int, inverse: bool, real_output: bool = False) -> List[torch.Tensor]:
    """The local phase A -> all_to_all -> local phase B of one group: the
    (n1, n2/d) column blocks of x.reshape(n1, n2) -> the (n2, n1/d) column
    blocks of X.reshape(n2, n1) (natural order once joined)."""
    n = n1 * n2
    d = len(blocks)
    n2d = n2 // d
    zs = []
    for p, (xb, dev) in enumerate(zip(blocks, devices)):
        t = fft_plan.get_plan(n, 'stream', torch.complex64, dev)[1]
        with on(dev):
            # this device's columns start at global column p * n2/d
            zs.append(stream.phase_a_local(xb, t, p * n2d, inverse))
    # four-step transpose across devices: (n2/d, n1) -> (n2, n1/d)
    zs = _all_to_all(zs, devices, 1, 0)
    out = []
    for z, dev in zip(zs, devices):
        t = fft_plan.get_plan(n, 'stream', torch.complex64, dev)[1]
        with on(dev):
            out.append(stream.phase_b_local(z, t, n1 // d, inverse, real_output))
    return out


def distributed_fft_stream(x, mesh: Mesh, axis: str = 'model', inverse: bool = False) -> Sharded:
    """ONE huge FFT with the STREAMING four-step itself sharded over the
    mesh: each device runs K6 local on its column block of
    x.reshape(n1, n2) (global-column twiddles through col0), the four-step
    transpose is one all-to-all, and each device runs K7 local on its k1
    shard.

    x: (n,) complex64 with n = n1*n2 a power of two; each factor must be
    divisible by the mesh axis into >= 2 even 128-wide blocks
    (stream.dist_supported). Returns (n,) natural order.
    """
    x = _input(x)
    n = x.shape[-1]
    if len(x.shape) != 1:
        raise RuntimeError(
            f'distributed_fft_stream expects a single (n,) vector, got '
            f'{len(x.shape)}-D (batch rows shard with sharded_batched_fft)'
        )
    d = mesh.shape[axis]
    n1, n2 = stream.factors(n)
    if not stream.dist_supported(n1, n2, d, x.dtype):
        raise RuntimeError(
            f'distributed_fft_stream: n={n} (factors {n1}x{n2}) is not '
            f'streamable over {d} devices — need complex64 and both '
            f'factors divisible by {d} into even >= 2-tile 128-lane '
            f'blocks'
        )
    xs = _place(x, mesh, axis, 1, (n1, n2), (n,), who='distributed_fft_stream')
    return _map_groups(xs, _dist_stream_mapped(mesh, axis, n1, n2, inverse), 1, (n,))


@functools.lru_cache(maxsize=4)
def _half_phasors(n: int) -> torch.Tensor:
    """Untangle phasors w_k = exp(-2i*pi*k/n), k = 0..n/2, computed in host
    float64 and rounded once to complex64 (the packed single-device
    engine's twiddle discipline)."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    return torch.from_numpy(np.exp(-2j * np.pi * k / n).astype(np.complex64))


@functools.lru_cache(maxsize=64)
def _phasor_block(n: int, rows: int, cols: int, d: int, p: int,
                  device: torch.device) -> torch.Tensor:
    """w_k of ``_half_phasors(n)`` at k = r*cols + c for column block p of
    a (rows, cols) layout cut into d, on ``device``."""
    cd = cols // d
    w = _half_phasors(n)[:rows * cols].reshape(rows, cols)
    return w[:, p * cd:(p + 1) * cd].to(device).contiguous()


def _mirror(blocks: Sequence[torch.Tensor], j: int, device: torch.device,
            tail: Optional[torch.Tensor]) -> torch.Tensor:
    """Block j of V[(h - k)] for the column blocks of V.reshape(R, C), h =
    R*C, k = r*C + c: at c > 0 it is V[R-1-r, C-c], the partner block
    d-1-j (its columns 1..) and column 0 of block (d-j) mod d, copied to
    ``device`` and flipped there; at k = 0 it is ``tail`` (V[h], the
    inverse) or V[0] (None, the forward: Z[(h - k) mod h])."""
    d = len(blocks)
    partner = blocks[d - 1 - j][:, 1:].to(device, non_blocking=True)
    with on(device):
        if j == 0:
            col = torch.roll(blocks[0][:, 0].flip(0), 1)
            if tail is not None:
                col[0] = tail.to(device)[0]
        else:
            col = blocks[d - j][:, 0].to(device, non_blocking=True).flip(0)
        return torch.cat([col[:, None], partner.flip((0, 1))], dim=1)


def _dist_stream_mapped(mesh: Mesh, axis: str, n1: int, n2: int, inverse: bool,
                        real_output: bool = False):
    """The per-group body of the sharded streaming four-step (the body of
    distributed_fft_stream) over ``mesh``'s axis ``axis``: blocks, devices
    -> output blocks (``mesh`` and ``axis`` as the JAX package's, which
    maps over them; here ``_map_groups`` does)."""
    def body(blocks, devices):
        return _stream_local([build.aligned(b) for b in blocks], devices, n1, n2,
                             inverse, real_output)

    return body


def _dist_rfft_supported(n: int, mesh: Mesh, axis: str, who: str):
    d = mesh.shape[axis]
    if n % 2:
        raise RuntimeError(f'{who}: n must be even, got {n}')
    h = n // 2
    n1, n2 = stream.factors(h)
    if not stream.dist_supported(n1, n2, d, np.complex64):
        raise RuntimeError(
            f'{who}: n={n} (half-size factors {n1}x{n2}) is not '
            f'streamable over {d} devices — need both factors divisible '
            f'by {d} into even >= 2-tile 128-lane blocks'
        )
    return h, n1, n2


def distributed_rfft_stream(x, mesh: Mesh, axis: str = 'model') -> Sharded:
    """ONE huge REAL FFT sharded over the mesh: the half-size packing
    z[t] = x[2t] + i*x[2t+1] on top of the sharded streaming four-step,
    then the Hermitian untangle X[k] = E[k] + w_k O[k] on each shard, its
    mirror Z[(h-k) mod h] taken from the partner shard by copy.

    x: (n,) float32, n/2 = n1*n2 streamable over the mesh axis
    (dist_supported). Returns the (n/2+1,) complex64 half spectrum.
    """
    x = _input(x)
    n = x.shape[-1]
    if len(x.shape) != 1:
        raise RuntimeError(
            f'distributed_rfft_stream expects a single (n,) vector, got '
            f'{len(x.shape)}-D (batch rows shard with sharded_batched_rfft)'
        )
    h, n1, n2 = _dist_rfft_supported(n, mesh, axis, 'distributed_rfft_stream')
    d = mesh.shape[axis]
    # (n1, n2, 2) float32: the packed z's (n1, n2) layout, re and im last
    xs = _place(x, mesh, axis, 1, (n1, n2, 2), (n,), torch.float32,
                who='distributed_rfft_stream')
    mapped = _dist_stream_mapped(mesh, axis, n1, n2, inverse=False)
    w_h = _half_phasors(n)[h]

    def body(blocks, devices):
        y = mapped([torch.view_as_complex(b) for b in blocks], devices)  # (n2, n1/d)
        out = []
        for j, (z, dev) in enumerate(zip(y, devices)):
            m = _mirror(y, j, dev, None)
            w = _phasor_block(n, n2, n1, d, j, dev)
            with on(dev):
                zc = m.conj()
                out.append(0.5 * (z + zc) + w * (-0.5j * (z - zc)))
        with on(devices[0]):
            # X[h] = Re Z[0] + w_h Im Z[0]
            z0 = y[0][:1, 0]
            last = z0.real.to(torch.complex64) + w_h.to(devices[0]) * z0.imag
        return out, last

    return _map_groups(xs, body, 1, (h + 1,), tail=True)


def distributed_irfft_stream(x, mesh: Mesh, axis: str = 'model') -> Sharded:
    """Inverse of distributed_rfft_stream: (n/2+1,) complex64 Hermitian
    half spectrum -> (n,) float32, via the entangle
    ``Z[k] = E[k] + i conj(w_k) D[k]`` (D = (X[k] - conj(X[h-k]))/2) on
    each shard, the sharded streaming inverse four-step at n/2 and the
    even/odd re-interleave."""
    x = _input(x)
    nh = x.shape[-1]
    if len(x.shape) != 1:
        raise RuntimeError(
            f'distributed_irfft_stream expects a single (n/2+1,) '
            f'vector, got {len(x.shape)}-D'
        )
    n = 2 * (nh - 1)
    h, n1, n2 = _dist_rfft_supported(n, mesh, axis, 'distributed_irfft_stream')
    d = mesh.shape[axis]
    xs = _place(x, mesh, axis, 1, (n1, n2), (nh,), torch.complex64, has_tail=True,
                who='distributed_irfft_stream')
    mapped = _dist_stream_mapped(mesh, axis, n1, n2, inverse=True)

    def body(blocks, devices):
        zs = []
        for j, (xb, dev) in enumerate(zip(blocks, devices)):
            m = _mirror(blocks, j, dev, xs.tail)
            w = _phasor_block(n, n1, n2, d, j, dev)
            with on(dev):
                mc = m.conj()
                # Z = E + i conj(w) D
                zs.append(0.5 * (xb + mc) + 1j * (w.conj() * (0.5 * (xb - mc))))
        y = mapped(zs, devices)  # z = IFFT_h(Z), 1/h in K7 local
        # x[2t] = Re z[t], x[2t+1] = Im z[t]
        return [torch.view_as_real(b) for b in y]

    return _map_groups(xs, body, 1, (n,))
