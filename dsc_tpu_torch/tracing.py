"""Tracing engine for dsc_tpu_torch (dsc_tpu/tracing.py).

The reference (dsc/include/dsc_tracing.h, dsc/src/dsc_tracing.cpp) records
Begin/End events in a preallocated ring and dumps Chrome trace-event JSON
for Perfetto. Here tracing is gated at runtime by a flag checked on the op
path; events carry the op name, category, shapes, dtypes, devices, byte
sizes, microsecond timestamps and pid/tid.

A span is an enqueue span: its Begin and End are the host clock when the
call entered and returned. CUDA launches are asynchronous, and a span
never waits for the device, so recording changes neither the order nor
the overlap of the calls in flight; on a device, an op's time comes from
the device timeline (``profile(xprof_dir=)``, or any torch.profiler run),
to which each span is linked as described below.

Spans sit at the port's layer boundaries; the layer is the head of the
category, ``op`` reading as ``api``:

- ``api``     the public ops (``op;fft``, ``op;binary``, ``op;pipeline``, ...);
- ``wrapper`` each kernel launch, named after its kernel (kernels/build.py),
              and the kernel library's build or load;
- ``plain``   each ATen pass the port issues around its kernels (the
              untangle, the Hermitian reconstruction, pads, broadcast
              arithmetic, index copies, the STFT's framing, power and log);
- ``plan``    the build of an FFT plan on a cache miss (fourier/plan.py).

Each span knows its parent, the span open on its thread when it began, by
the B/E nesting on one ``tid``; its Begin carries ``args.root``, the
sequence number of the outermost span open on its thread, which all spans
of one public call share. While torch.profiler runs, each recorded span is
also a ``record_function`` named ``dsc.<layer>.<name>`` on the profiler's
clock, so the device work launched inside it is correlated to it.

While recording, ``totals()`` keeps per (layer, name) the number of spans,
their total ns and their self ns (each span's duration less the time its
children took, their own cost of recording included); ``DSC_MAX_TRACES``
caps the ring of events only, and the totals drop nothing. With recording
off ``trace_op`` returns one shared null context: no event, no clock read.

``suppressed()`` turns op events off for a block: a compiled program
records its ops' events in its trace run only, and one
``compile:<name>`` event for each call.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler

from .dtype import DTYPE_SIZE

# DSC_MAX_TRACES equivalent (reference dsc.cpp:25-27, default 1000)
MAX_TRACES = int(os.environ.get('DSC_MAX_TRACES', '1000'))

_record = False


class _Local(threading.local):
    """This thread's open spans, and whether ``suppressed()`` holds."""

    suppressed = False

    def __init__(self):
        self.stack: List['_Span'] = []


_local = _Local()
_events: List[Dict[str, Any]] = []
# kept Begin events whose End is still to come: the ring saves room for them
_open_kept = 0
# (layer, name) -> [count, total ns, self ns]
_totals: Dict[Tuple[str, str], List[int]] = {}
_seq = itertools.count()
_lock = threading.Lock()
_NULL = nullcontext()
_clock = time.monotonic_ns
# os.getpid() is a system call: read once, and again in a forked child
_pid = os.getpid()


def _forked() -> None:
    global _pid
    _pid = os.getpid()


os.register_at_fork(after_in_child=_forked)


def now_us() -> int:
    return _clock() // 1000


def layer_of(cat: str) -> str:
    """The layer a category names: its head, ``op`` read as ``api``."""
    layer = _layers.get(cat)
    if layer is None:
        head = cat.split(';', 1)[0]
        layer = _layers[cat] = 'api' if head == 'op' else head
    return layer


_layers: Dict[str, str] = {}


@contextmanager
def suppressed():
    """No op events inside the block, on this thread."""
    prev = _local.suppressed
    _local.suppressed = True
    try:
        yield
    finally:
        _local.suppressed = prev


def is_recording() -> bool:
    return _record


def set_recording(record: bool) -> None:
    """dsc_traces_record equivalent (reference dsc.cpp:327-329)."""
    global _record
    _record = bool(record)


def clear_traces() -> None:
    """dsc_clear_traces equivalent (reference dsc.cpp:335-337); the totals
    are reset too."""
    global _open_kept
    with _lock:
        _events.clear()
        _totals.clear()
        _open_kept = 0


def num_traces() -> int:
    return len(_events)


def _room() -> bool:
    """Whether the ring keeps another Begin: room for it, its End and the
    Ends of the spans open."""
    return len(_events) + _open_kept + 2 <= MAX_TRACES


def totals() -> Dict[Tuple[str, str], Dict[str, int]]:
    """(layer, name) -> {'count', 'total_ns', 'self_ns'} of the spans that
    ended while recording, since the last ``clear_traces()``."""
    with _lock:
        return {key: {'count': c, 'total_ns': t, 'self_ns': s}
                for key, (c, t, s) in _totals.items()}


class _Span:
    """One recorded span: the RAII dsc_trace_tracker (dsc_tracing.h:328-426)."""

    __slots__ = ('name', 'cat', 'args', 'key', 'stack', 'seq', 'kept', 'rf', 'entered', 't0',
                 'child_ns')

    def __init__(self, name: str, cat: str, args: Optional[Dict[str, Any]]):
        self.name, self.cat, self.args = name, cat, args
        self.key = (layer_of(cat), name)

    def __enter__(self):
        global _open_kept
        self.entered = _clock()
        st = self.stack = _local.stack
        self.seq = next(_seq)
        self.child_ns = 0
        self.kept = False
        if _room():
            with _lock:
                self.kept = _room()
                if self.kept:
                    _open_kept += 1
                    args = dict(self.args) if self.args else {}
                    args['root'] = st[0].seq if st else self.seq
                    _events.append({'name': self.name, 'cat': self.cat, 'ph': 'B',
                                    'ts': self.entered // 1000, 'pid': _pid,
                                    'tid': threading.get_ident() % 2**31, 'args': args})
        st.append(self)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function('dsc.%s.%s' % self.key)
            self.rf.__enter__()
        self.t0 = _clock()
        return None

    def __exit__(self, *exc):
        global _open_kept
        t1 = _clock()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        st = self.stack
        st.pop()
        dur = t1 - self.t0
        with _lock:
            tot = _totals.get(self.key)
            if tot is None:
                tot = _totals[self.key] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - self.child_ns
            if self.kept:
                _open_kept -= 1
                _events.append({'name': self.name, 'cat': self.cat, 'ph': 'E',
                                'ts': t1 // 1000, 'pid': _pid,
                                'tid': threading.get_ident() % 2**31})
        if st:
            # the parent's self time leaves out this span and its recording
            st[-1].child_ns += _clock() - self.entered
        return False


def trace_op(name: str, cat: str, args: Optional[Dict[str, Any]] = None):
    """A span ``name`` in the layer ``cat`` names (``layer_of``): Begin on
    entry, End on exit, host clock. With recording off, or inside
    ``suppressed()``, one shared null context."""
    if not _record or _local.suppressed:
        return _NULL
    return _Span(name, cat, args)


def tensor_args(**tensors) -> Dict[str, Any]:
    """Shapes, dtypes, device and byte size of each Tensor argument (the
    reference's per-op arg structs, dsc_tracing.h:20-163); nothing while
    the ring keeps no more Begin events."""
    if not _record or not _room():
        return {}
    out: Dict[str, Any] = {}
    for key, t in tensors.items():
        if t is None:
            continue
        # from the metadata: reading t.torch would turn a T layout natural
        out[f'{key}_shape'] = list(t.shape)
        out[f'{key}_dtype'] = str(t.dtype)
        out[f'{key}_backend'] = t.device.type
        out[f'{key}_nbytes'] = t.ne * DTYPE_SIZE[t.dtype]
    return out


def dump_traces(path: str, extra_events=None) -> None:
    """dsc_dump_traces equivalent: Chrome trace-event JSON consumable by
    Perfetto (reference dsc_tracing.cpp:260-280); ``extra_events`` (the
    device timeline of ``profile(xprof_dir=)``) are appended."""
    with _lock:
        events = list(_events) + list(extra_events or ())
    with open(path, 'w') as f:
        json.dump({'traceEvents': events, 'displayTimeUnit': 'ms'}, f)
