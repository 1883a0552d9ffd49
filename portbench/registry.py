"""Find the benchmark's pieces by name.

BENCHMARK.json at the checkout's root names the cells and metrics. Under portbench/,
``workloads/<cell>.json`` holds a cell's configuration and traffic parameters,
``configs/<config>.json`` a configuration's published parameters and the names of its
pipeline (``pipelines/<name>.py``, the program as a user calls it) and plain reference
(``reference/<name>.py``), and ``metrics/<metric>.py`` the reader of one metric. A new cell,
configuration or metric is a new file and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> Dict[str, Any]:
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def _json(kind: str, name: str) -> Dict[str, Any]:
    path = HERE / kind / f'{name}.json'
    if not path.is_file():
        raise FileNotFoundError(f'no {kind[:-1]} {name!r}: {path} is missing')
    return json.loads(path.read_text())


def config(name: str) -> Dict[str, Any]:
    return _json('configs', name)


def workload(name: str) -> Dict[str, Any]:
    """The cell ``name``: its entry in BENCHMARK.json merged with workloads/<name>.json,
    which has to name the same configuration and traffic."""
    entry = next((w for w in benchmark()['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'BENCHMARK.json has no workload {name!r}')
    data = _json('workloads', name)
    for key in ('config', 'traffic'):
        if data[key] != entry[key]:
            raise ValueError(f'workloads/{name}.json: {key} {data[key]!r} is not '
                             f'BENCHMARK.json\'s {entry[key]!r}')
    return {**data, 'name': name, 'chips': entry['chips']}


def module(kind: str, name: str) -> ModuleType:
    """portbench/<kind>/<name>.py, imported once a process (a name may hold dots)."""
    key = f'portbench.{kind}.{name}'
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    path = HERE / kind / f'{name}.py'
    if not path.is_file():
        raise FileNotFoundError(f'no {kind} module {name!r}: {path} is missing')
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def pipeline(cfg: Dict[str, Any]) -> ModuleType:
    return module('pipelines', cfg['pipeline'])


def reference(cfg: Dict[str, Any]) -> ModuleType:
    return module('reference', cfg['reference'])


def metric(name: str) -> ModuleType:
    return module('metrics', name)


def metrics_of(trace: bool) -> list:
    """BENCHMARK.json's end-to-end metrics, or with ``trace`` its per-layer ones: a run reports
    each that its reader finds something to read for."""
    return benchmark()['per_layer' if trace else 'end_to_end']
