"""One run of one cell: set-up, the measured window, the traced window, the check.

Set-up (``setup_s``, from the process's start) imports the port, initialises the card,
builds or loads the kernels, makes the pool of inputs from the seed on the device, uploads it
through the port's public API and warms up every shape the cell uses for ``warmup_s``
seconds (at least two turns of the pool): a process's first tens of calls run slower.

The loop is closed, with ``in_flight`` calls in flight: the host issues call i + 1 on the
next input of the pool, then waits on call i's CUDA event, as a user does who consumes one
result while the next is computed. A call's latency runs from the start of its issue to the
moment the host sees its event complete; its host time from the start of its issue to the
return of the port's call (the enqueue).

With ``trace`` the run measures the same window (for the host times and the launch counter),
then TRACE_S seconds with torch.profiler recording the card's activity alone (the per-layer
metrics' window: it costs the host little), then SPANS_S seconds with the host's operators
and spans of its own (``portbench.<op>``, around each public call, each call and each wait)
recorded too, which slow the host: that window only names what the host was doing in the
card's idle gaps and splits the device time by public op.

Once the windows have closed and the memory peak has been read, the program's state is freed
and the sampled answers (the last answer for each input of the pool, and one answer from
early in the window, at a call the seed draws) are compared with the plain reference of the
configuration, by each of the configuration's ``checks``.
"""

from __future__ import annotations

import gc
import random
import subprocess
import sys
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import compare, registry
from portbench import trace as tracing

TRACE_S = 2.0
# the window with the host's spans and operators traced too, for the breakdown alone
SPANS_S = 0.5
# torch.profiler now and then records no device event at all: such a window is traced again
PROFILE_TRIES = 3
# the early answer kept for the check is one of the window's first EARLY calls
EARLY = 64
# top-level modules no run may load: JAX and the package the port was made from
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'dsc_tpu')
PEAKS = registry.HERE / 'peaks.json'

_NULL = nullcontext()


def quiet(name: str):
    return _NULL


def traced(name: str):
    return torch.profiler.record_function(tracing.SPAN + name)


class _Done:
    """The event of a call on the CPU, whose work is done when the call returns."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


def _event(cuda: bool):
    return torch.cuda.Event() if cuda else _Done()


def drive(pipe, state, args: list, seconds: float, in_flight: int, cuda: bool,
          span: Callable = quiet, min_calls: int = 0,
          sample_at: Optional[int] = None) -> Dict[str, Any]:
    """Calls on the pool's inputs in turn until ``seconds`` have passed since the first was
    issued (and at least ``min_calls``), then the last ones waited for."""
    pool = len(args)
    latency: List[float] = []
    host: List[float] = []
    ended: List[float] = []
    pending: deque = deque()
    ring: deque = deque(maxlen=pool)
    early = None
    calls = 0
    start = time.perf_counter()
    stop = start + seconds

    def wait_oldest():
        issued, ev = pending.popleft()
        with span('wait'):
            ev.synchronize()
        done = time.perf_counter()
        latency.append(done - issued)
        ended.append(done - start)

    while calls < min_calls or time.perf_counter() < stop:
        j = calls % pool
        issued = time.perf_counter()
        with span('call'):
            out = pipe.call(state, args[j], span)
        host.append(time.perf_counter() - issued)
        ev = _event(cuda)
        ev.record()
        pending.append((issued, ev))
        ring.append((j, out))
        if calls == sample_at:
            early = (j, out)
        calls += 1
        if len(pending) >= in_flight:
            wait_oldest()
    while pending:
        wait_oldest()
    end = time.perf_counter()
    return {'calls': calls, 'latency_s': latency, 'host_s': host, 'ended_s': ended,
            'seconds': end - start,
            'kept': ([early] if early else []) + list(ring)}


def card(cuda: bool) -> Dict[str, Any]:
    if not cuda:
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': 1}


def power_limit_w() -> Optional[float]:
    """The card's power limit (nvidia-smi), or None where it cannot be read."""
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader,nounits', '--id=0'],
                             capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def peak_bytes_per_s(kind: str) -> Optional[float]:
    import json

    entry = json.loads(PEAKS.read_text()).get(kind)
    return None if entry is None else float(entry['hbm_bytes_per_s'])


def forbidden_modules() -> List[str]:
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def _profile(pipe, state, args, seconds, in_flight, cuda, host: bool):
    """A window of ``seconds`` under torch.profiler: the card's activity alone, which costs
    the host little, or with ``host`` the host's spans and operators too, which slow it."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    for _ in range(PROFILE_TRIES):
        _sync(cuda)
        with profile(activities=acts) as prof:
            win = drive(pipe, state, args, seconds, in_flight, cuda,
                        span=traced if host else quiet)
            _sync(cuda)
        got = {**tracing.collect(prof), 'calls': win['calls']}
        if got['device'] or not cuda:
            break
        print('torch.profiler recorded no device event: the window is traced again',
              file=sys.stderr)
    return got


def run(name: str, seed: int, seconds: float, trace: bool, t0: float, device: str = 'cuda',
        cell: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of cell ``name`` (``cell``: its workload, else read by name): the result's
    line, whose last key ``checks`` holds the numbers compared, each with its limit.
    Set-up's stages go to standard error, in seconds from the process's start."""
    from dsc_tpu_torch.kernels import build

    cell = cell if cell is not None else registry.workload(name)
    cfg = registry.config(cell['config'])
    pipe = registry.pipeline(cfg)
    cuda = torch.device(device).type == 'cuda'
    pool = int(cell['pool'])
    in_flight = int(cell['in_flight'])

    def stage(what):
        print(f'set-up: {what} at {time.perf_counter() - t0:.3f} s', file=sys.stderr)

    stage('imports')
    state = pipe.setup(cfg, cell, device)
    _sync(cuda)
    stage('the port and the card initialised')
    raw = pipe.make_inputs(cfg, cell, seed, device)
    args = [pipe.prepare(state, r) for r in raw]
    _sync(cuda)
    stage('the pool made and uploaded')
    drive(pipe, state, args, 0, 1, cuda, min_calls=1)
    stage('the first call (kernels built or loaded, plans made)')
    drive(pipe, state, args, float(cell['warmup_s']), in_flight, cuda, min_calls=2 * pool)
    _sync(cuda)
    gc.collect()
    setup_s = time.perf_counter() - t0
    stage('warm-up')
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()

    collections = [g['collections'] for g in gc.get_stats()]
    win = drive(pipe, state, args, seconds, in_flight, cuda,
                sample_at=random.Random(seed).randrange(EARLY))
    launches = dict(build.launches)
    per_s = [0] * (int(win['seconds']) + 1)
    for t in win['ended_s']:
        per_s[int(t)] += 1
    print(f'calls completed in each second of the window: {per_s}; the longest issue '
          f'{max(win["host_s"], default=0) * 1e3:.3f} ms; garbage collections by generation: '
          f'{[g["collections"] - c for g, c in zip(gc.get_stats(), collections)]}',
          file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    record: Dict[str, Any] = {
        'setup_s': setup_s, 'window_s': win['seconds'], 'calls': win['calls'],
        'latency_s': win['latency_s'], 'host_s': win['host_s'], 'launches': launches,
        'peak_bytes': window_peak, 'samples_per_call': pipe.samples(cfg, cell),
        'bytes_needed': pipe.bytes_needed(cfg, cell), 'trace': None,
    }
    kept = [(j, pipe.result(out)) for j, out in win['kept']]
    del win

    spans = None
    if trace:
        record['trace'] = _profile(pipe, state, args, min(TRACE_S, seconds), in_flight, cuda,
                                   host=False)
        spans = _profile(pipe, state, args, min(SPANS_S, seconds), in_flight, cuda, host=True)
    peak = max(peak, window_peak, torch.cuda.max_memory_allocated() if cuda else 0)

    dev = card(cuda)
    record['peak_bytes_per_s'] = peak_bytes_per_s(dev['kind'])
    metrics = {}
    for m in registry.metrics_of(trace):
        value = registry.metric(m['name']).read(record)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev['memory_peak_bytes'] = peak
    if cuda:
        dev['power_limit_w'] = power_limit_w()
    result: Dict[str, Any] = {'correct': False, 'attempted': record['calls'], 'failed': 0,
                              'metrics': metrics, 'device': dev}
    if trace:
        got = tracing.busy_ns(record['trace'])
        if got is not None:
            dev['busy_s'], dev['window_s'] = got[0] / 1e9, got[1] / 1e9
        parts = tracing.breakdown(record['trace'], spans)
        if parts is not None:
            result['breakdown'] = parts
            print(f'traced window: {record["trace"]["calls"]} calls; device ms a call: '
                  + ', '.join(f'{op[:60]} {s * 1e3 / record["trace"]["calls"]}'
                              for op, s in parts['device_ops']), file=sys.stderr)
        per_op = tracing.by_span(spans)
        if per_op:
            print('device ms a call by public op (host spans on): ' + ', '.join(
                f'{op} {ns / 1e6 / spans["calls"]}' for op, ns in sorted(per_op.items())),
                file=sys.stderr)

    # the program's state goes before the reference runs
    del args, state
    gc.collect()
    pipe.teardown()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = registry.reference(cfg)
    worst = {c['name']: 0.0 for c in cfg['checks']}
    failed = 0
    for j, got in kept:
        want = ref.run(cfg, raw[j])
        bad = False
        for c in cfg['checks']:
            value = compare.gap(c['kind'], got, want)
            bad |= value > c['limit']
            worst[c['name']] = max(worst[c['name']], value)
        failed += bad
        del want
    result['failed'] = failed
    result['correct'] = bool(kept) and failed == 0
    result['checks'] = {c['name']: {'value': worst[c['name']], 'limit': c['limit']}
                        for c in cfg['checks']}
    return result


def check_lines(checks: Dict[str, Any]) -> List[str]:
    return [f'check {name}: {c["value"]!r} (limit {c["limit"]!r})' for name, c in checks.items()]
