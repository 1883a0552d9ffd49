"""Profiler / Perfetto UX for dsc_tpu_torch (dsc_tpu/profiler.py).

``start_recording`` / ``stop_recording(file)`` toggle tracing and dump
Chrome trace-event JSON, and ``profile()`` is the context-manager wrapper
(reference python/dsc/profiler.py). ``stop_recording`` can serve the trace
over localhost and print a ui.perfetto.dev deep link like the reference
(profiler.py:35-44). The JAX package's ``xprof_dir`` option (a device
timeline merged into the same file) is not ported yet.
"""

from __future__ import annotations

import http.server
import os
import sys
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


def stop_recording(file: Optional[str] = None, serve: Optional[bool] = None) -> None:
    """Stop tracing; if ``file`` is given dump Chrome trace-event JSON there
    and (interactively) serve it for ui.perfetto.dev."""
    tracing.set_recording(False)
    if file:
        tracing.dump_traces(file)
        if serve is None:
            serve = sys.stdout.isatty() and not os.environ.get('DSC_NO_SERVE')
        if serve:
            _serve_traces(file)
    tracing.clear_traces()


@contextmanager
def profile(file: str = 'traces.json', serve: Optional[bool] = None):
    """``with dsc.profile(): ...`` (reference profiler.py:57-63)."""
    start_recording()
    try:
        yield
    finally:
        stop_recording(file, serve=serve)
