"""Thread-local flags of engine selection (dsc_tpu/flags.py), kept as
markers that gate nothing.

In the JAX package ``xla_only()`` turns every Pallas gate off while a
``dsc.compile(mesh=...)`` program traces, because a Pallas kernel is an
opaque custom call that XLA's SPMD partitioner cannot split; and
``kernel_trace()`` tells the ops that they are being traced inside a
Pallas kernel body (``dsc.map``), where they must lower to plain vector
code.

Here neither reason holds. A mesh program (fuse.py) runs the single-device
program once a shard, so no partitioner has to see through a kernel, and
each shard launches the kernels that the single-device call launches;
``dsc.map`` records its body's aten ops on ``meta`` tensors, which reach no
kernel. So no route reads either flag: a CUDA tensor takes its kernel
inside both. The flags keep the JAX package's names and depth semantics,
and say what is under way: a mesh program's run of ``fn`` on a shard
(``xla_only``), the record of a ``dsc.map`` body (``kernel_trace``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_tls = threading.local()


def xla_only_active() -> bool:
    """True while a mesh program runs its function on a shard."""
    return getattr(_tls, 'depth', 0) > 0


@contextmanager
def xla_only():
    _tls.depth = getattr(_tls, 'depth', 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def kernel_trace_active() -> bool:
    """True while ``dsc.map`` records the body of a generated kernel."""
    return getattr(_tls, 'kdepth', 0) > 0


@contextmanager
def kernel_trace():
    _tls.kdepth = getattr(_tls, 'kdepth', 0) + 1
    try:
        yield
    finally:
        _tls.kdepth -= 1
