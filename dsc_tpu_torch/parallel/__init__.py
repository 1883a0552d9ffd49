"""The sharded tier (dsc_tpu/parallel): device meshes and FFTs sharded
over them, in one process (mesh.py)."""

from .mesh import Mesh, Sharded, make_mesh
from .sharded_fft import (
    distributed_fft,
    distributed_fft_stream,
    distributed_irfft_stream,
    distributed_rfft_stream,
    shard_batch,
    sharded_batched_fft,
    sharded_batched_rfft,
)

__all__ = [
    'make_mesh',
    'shard_batch',
    'sharded_batched_fft',
    'sharded_batched_rfft',
    'distributed_fft',
    'distributed_fft_stream',
    'distributed_rfft_stream',
    'distributed_irfft_stream',
]
