"""Tracing engine for dsc_tpu_torch (dsc_tpu/tracing.py).

The reference (dsc/include/dsc_tracing.h, dsc/src/dsc_tracing.cpp) records
Begin/End events in a preallocated ring and dumps Chrome trace-event JSON
for Perfetto. Here tracing is gated at runtime by a flag checked on the op
path; events carry the op name, category, shapes, dtypes, devices, byte
sizes, microsecond timestamps and pid/tid.

CUDA launches are asynchronous, so while recording each traced op waits
for the device (``torch.cuda.synchronize()``) before its End event: the
event then spans the device work, as the reference's does by
timestamping inside the op. A stream that is capturing a CUDA graph
(dsc.compile, fuse.py) is not waited for: the call is illegal there, and
no op event is recorded during a capture anyway.

``suppressed()`` turns op events off for a block: a compiled program
records its ops' events in its trace run only, and one
``compile:<name>`` event for each call.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from .dtype import DTYPE_SIZE

# DSC_MAX_TRACES equivalent (reference dsc.cpp:25-27, default 1000)
MAX_TRACES = int(os.environ.get('DSC_MAX_TRACES', '1000'))

_record = False
_suppressed = threading.local()
_events: List[Dict[str, Any]] = []
_lock = threading.Lock()


def now_us() -> int:
    return time.monotonic_ns() // 1000


@contextmanager
def suppressed():
    """No op events inside the block, on this thread."""
    prev = getattr(_suppressed, 'on', False)
    _suppressed.on = True
    try:
        yield
    finally:
        _suppressed.on = prev


def is_recording() -> bool:
    return _record


def set_recording(record: bool) -> None:
    """dsc_traces_record equivalent (reference dsc.cpp:327-329)."""
    global _record
    _record = bool(record)


def clear_traces() -> None:
    """dsc_clear_traces equivalent (reference dsc.cpp:335-337)."""
    with _lock:
        _events.clear()


def num_traces() -> int:
    return len(_events)


def _append(ev: Dict[str, Any]) -> None:
    with _lock:
        if len(_events) >= MAX_TRACES:
            # preallocated-ring semantics: drop new events past capacity
            return
        _events.append(ev)


@contextmanager
def trace_op(name: str, cat: str, args: Optional[Dict[str, Any]] = None):
    """RAII-equivalent of dsc_trace_tracker (dsc_tracing.h:328-426):
    records a Begin event on entry and an End event on exit."""
    if not _record or getattr(_suppressed, 'on', False):
        yield
        return
    pid = os.getpid()
    tid = threading.get_ident() % 2**31
    begin = {'name': name, 'cat': cat, 'ph': 'B', 'ts': now_us(),
             'pid': pid, 'tid': tid}
    if args:
        begin['args'] = args
    _append(begin)
    try:
        yield
    finally:
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        _append({'name': name, 'cat': cat, 'ph': 'E', 'ts': now_us(),
                 'pid': pid, 'tid': tid})


def tensor_args(**tensors) -> Dict[str, Any]:
    """Shapes, dtypes, device and byte size of each Tensor argument (the
    reference's per-op arg structs, dsc_tracing.h:20-163)."""
    if not _record:
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
