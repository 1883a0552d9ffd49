"""Context + memory management for dsc_tpu_torch (dsc_tpu/context.py).

The observable contract of the reference context (dsc/src/dsc.cpp:140-322,
python/dsc/context.py) on one explicit torch device:

- ``init(main_mem, scratch_mem=0, device='cuda')`` sets the byte cap and
  the device every tensor lives on; double-init raises. CPU use is opt-in
  (``device='cpu'``). Without a GPU, ``init`` does not move to the CPU:
  the first CUDA allocation raises.
- auto-init on the CUDA device with 10% of its memory + a message if the
  user never calls ``init`` (reference context.py:13-26)
- ``used_mem`` / ``print_mem_usage``: live byte accounting of every tensor
  buffer (reference dsc.cpp:310-322)
- allocation beyond the cap raises ``MemoryError`` (reference
  dsc_allocator.cpp:112-114)

``on_device(dev)`` makes ``device()`` read ``dev`` on the calling thread
for a block: a mesh program (fuse.py) runs each shard so, and what the
shard's function creates (constants, FFT plans, windows) lands on the
shard's device.

Op temporaries live in PyTorch's caching allocator, as they live in XLA's
arena in the JAX package; only tensor buffers count against the cap.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional

import torch


class DscContext:
    def __init__(self, main_mem: int, scratch_mem: int, device: torch.device):
        self.main_mem = int(main_mem)
        # kept for API parity (the reference's linear scratch arena)
        self.scratch_mem = int(scratch_mem)
        self.device = device
        self._used = 0
        self._lock = threading.Lock()
        self._n_buffers = 0
        # randn draws from a host generator, so a seed gives the same
        # numbers on every device
        self._gen = torch.Generator().manual_seed(int(os.environ.get('DSC_SEED', '0')))

    # -- memory accounting ------------------------------------------------

    def alloc(self, nbytes: int) -> None:
        with self._lock:
            if self._used + nbytes > self.main_mem:
                raise MemoryError(
                    f'error allocating {nbytes} bytes: '
                    f'{self._used}/{self.main_mem} bytes already in use '
                    f'(grow the pool via dsc.init)'
                )
            self._used += nbytes
            self._n_buffers += 1

    def free(self, nbytes: int) -> None:
        with self._lock:
            self._used -= nbytes
            self._n_buffers -= 1

    @property
    def used_mem(self) -> int:
        return self._used

    # -- PRNG --------------------------------------------------------------

    @property
    def generator(self) -> torch.Generator:
        return self._gen

    def manual_seed(self, seed: int) -> None:
        self._gen.manual_seed(int(seed))


_ctx: Optional[DscContext] = None
_ctx_lock = threading.Lock()


def _default_mem(device: torch.device) -> int:
    """10% of the device's memory (the reference takes 10% of RAM)."""
    if device.type == 'cuda' and torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(device).total_memory * 0.1)
    return 4 * 2**30


def _get_ctx() -> DscContext:
    global _ctx
    if _ctx is None:
        with _ctx_lock:
            if _ctx is None:
                device = torch.device('cuda')
                mem = _default_mem(device)
                print(
                    f'dsc_tpu_torch: init() was not called, defaulting to {mem} '
                    f'bytes on {device}'
                )
                _ctx = DscContext(mem, mem, device)
    return _ctx


def init(main_mem: int, scratch_mem: int = 0, device='cuda') -> None:
    """Initialize the context: a main pool cap of ``main_mem`` bytes on
    ``device``. Raises on double-init (reference context.py:29-34)."""
    global _ctx
    with _ctx_lock:
        if _ctx is not None:
            raise RuntimeError('dsc is already initialized')
        _ctx = DscContext(main_mem, scratch_mem if scratch_mem else main_mem,
                          torch.device(device))


def clear() -> None:
    """Empty the FFT plan cache and reap dead buffers; live tensors keep
    their bytes and stay valid (the documented divergence from the
    reference's dsc_ctx_clear, README "dsc.clear()")."""
    import gc

    from .fourier import plan as _plan

    _plan.clear_plans()
    gc.collect()


def shutdown() -> None:
    """Tear down the context entirely (reference dsc_ctx_free)."""
    global _ctx
    with _ctx_lock:
        _ctx = None


def used_mem() -> int:
    return _get_ctx().used_mem


def print_mem_usage() -> None:
    ctx = _get_ctx()
    print(
        f'dsc_tpu_torch: using {ctx.used_mem}/{ctx.main_mem} bytes '
        f'({100.0 * ctx.used_mem / max(ctx.main_mem, 1):.1f}%) '
        f'across {ctx._n_buffers} buffers on {ctx.device}'
    )


def manual_seed(seed: int) -> None:
    _get_ctx().manual_seed(seed)


_local = threading.local()


@contextmanager
def on_device(dev: torch.device):
    """Within the block, ``device()`` is ``dev`` on this thread."""
    prev = getattr(_local, 'device', None)
    _local.device = dev
    try:
        yield
    finally:
        _local.device = prev


def default_device() -> torch.device:
    """The context's device: cuda:0 unless ``init(device=...)`` named
    another (``'cpu'`` among them); never a CPU fallback."""
    dev = _get_ctx().device
    return torch.device('cuda', 0) if dev.type == 'cuda' and dev.index is None else dev


def device() -> torch.device:
    """The device tensors are created on: the context's, or the one an
    enclosing ``on_device`` names."""
    dev = getattr(_local, 'device', None)
    return _get_ctx().device if dev is None else dev
