"""Profiler / Perfetto UX for dsc_tpu_torch (dsc_tpu/profiler.py).

``start_recording`` / ``stop_recording(file)`` toggle tracing and dump
Chrome trace-event JSON, and ``profile()`` is the context-manager wrapper
(reference python/dsc/profiler.py). ``stop_recording`` can serve the trace
over localhost and print a ui.perfetto.dev deep link like the reference
(profiler.py:35-44).

The dsc events are host enqueue spans (tracing.py): on a device, an op's
time comes from the device timeline. ``profile(xprof_dir=...)`` also runs
the region under ``torch.profiler`` (CPU activity, and CUDA activity on a
CUDA context), writes its Chrome trace under ``xprof_dir`` and merges its
events (the device's kernels and copies among them) into the dsc trace
file on the dsc tracing clock, each profiler process under a pid of its
own above ``1 << 22``, as the JAX package merges its xprof trace
(dsc_tpu/profiler.py:88-146). Under the profiler each dsc span is also a
``dsc.<layer>.<name>`` range on its clock, to which the device work it
launched is correlated; the merged file holds each span once, as its dsc
event.
"""

from __future__ import annotations

import http.server
import os
import sys
import time
from contextlib import contextmanager
from typing import Optional

from . import tracing

__all__ = ['start_recording', 'stop_recording', 'profile']


def start_recording() -> None:
    tracing.set_recording(True)


def _serve_traces(file_path: str, port: int = 9001) -> None:
    """Serve ``file_path`` over localhost until Perfetto has fetched it and
    print the deep link (reference profiler.py:35-44)."""
    abs_path = os.path.abspath(file_path)
    directory = os.path.dirname(abs_path) or '.'
    filename = os.path.basename(abs_path)
    served = {'trace': False}

    class _Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, directory=directory, **kwargs)

        def end_headers(self):
            self.send_header('Access-Control-Allow-Origin', '*')
            super().end_headers()

        def do_GET(self):
            super().do_GET()
            if self.path.lstrip('/') == filename:
                served['trace'] = True

        def log_message(self, *args):
            pass

    with http.server.HTTPServer(('127.0.0.1', port), _Handler) as httpd:
        print('Open URL in browser: https://ui.perfetto.dev/#!/?url='
              f'http://127.0.0.1:{port}/{filename}')
        while not served['trace']:
            httpd.handle_request()


def stop_recording(file: Optional[str] = None, serve: Optional[bool] = None,
                   _extra_events=None) -> None:
    """Stop tracing; if ``file`` is given dump Chrome trace-event JSON there
    and (interactively) serve it for ui.perfetto.dev."""
    tracing.set_recording(False)
    if file:
        tracing.dump_traces(file, extra_events=_extra_events)
        if serve is None:
            serve = sys.stdout.isatty() and not os.environ.get('DSC_NO_SERVE')
        if serve:
            _serve_traces(file)
    tracing.clear_traces()


# the profiler's events get pids far above any real os.getpid(), so the
# merged view keeps dsc ops and the profiler's processes apart
_DEVICE_PID_BASE = 1 << 22
# the annotation whose start fixes the profiler's clock against dsc's
_MARK = 'dsc_profile_start'
# the profiler's copies of the dsc spans (tracing.py), left out of the merge
_SPAN_COPY = 'dsc.'


def _load_profiler_events(path: str, mark_us: float):
    """The Chrome trace torch.profiler wrote to ``path`` -> its events on
    the dsc tracing clock: ``mark_us`` is the dsc clock when the ``_MARK``
    annotation began, whose own ``ts`` is on the profiler's clock."""
    import json

    with open(path) as f:
        events = json.load(f).get('traceEvents', [])
    marks = [ev['ts'] for ev in events if ev.get('name') == _MARK and 'ts' in ev]
    if not marks:
        raise RuntimeError(f'no {_MARK} event in {path}')
    offset = mark_us - float(marks[0])
    pids = {}
    out = []
    for ev in events:
        if not isinstance(ev, dict) or 'pid' not in ev:
            continue
        ev = dict(ev)
        ev['pid'] = _DEVICE_PID_BASE + pids.setdefault(ev['pid'], len(pids))
        if 'ts' in ev:
            ev['ts'] = round(float(ev['ts']) + offset, 3)
        out.append(ev)
    return out


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from .context import device

    activities = [ProfilerActivity.CPU]
    if device().type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    prof = torch_profile(activities=activities)
    prof.__enter__()
    mark_us = tracing.now_us()
    with torch.profiler.record_function(_MARK):
        pass
    return prof, mark_us


@contextmanager
def profile(file: str = 'traces.json', serve: Optional[bool] = None,
            xprof_dir: Optional[str] = None):
    """``with dsc.profile(): ...`` (reference profiler.py:57-63).

    With ``xprof_dir`` the region also runs under ``torch.profiler``: its
    Chrome trace is written under ``xprof_dir`` and its events (CPU ops,
    and the kernels and copies on the card) are merged into ``file`` next
    to the dsc-level events, time-aligned, as extra Perfetto processes.
    The dsc events are host enqueue spans; an op's device time is in the
    merged device timeline."""
    prof = None
    if xprof_dir:
        prof, mark_us = _start_profiler()
    start_recording()
    try:
        yield
    finally:
        extra = None
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(xprof_dir, exist_ok=True)
            path = os.path.join(xprof_dir, f'torch_profile.{os.getpid()}.'
                                           f'{time.time_ns()}.trace.json')
            try:
                prof.export_chrome_trace(path)
                extra = [ev for ev in _load_profiler_events(path, float(mark_us))
                         if not str(ev.get('name', '')).startswith(_SPAN_COPY)]
            except Exception as e:  # the merge is best-effort, as in dsc_tpu
                print(f'dsc_tpu_torch: xprof merge failed: {e}', file=sys.stderr)
        stop_recording(file, serve=serve, _extra_events=extra)
