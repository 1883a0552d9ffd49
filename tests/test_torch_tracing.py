"""The port's tracing (dsc_tpu_torch/tracing.py) on the CPU: the null context
while recording is off, enqueue spans that never synchronize, the span tree
(B/E nesting and ``args.root``), self time, the ring and the totals, the
``dsc.<layer>.<name>`` copies under torch.profiler and their alignment in
``profile(xprof_dir=)``, the plan-cache counter, and the spans at the layer
boundaries: public ops, kernel launches and the library's load, plain passes
and plan builds."""

import json
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import torch.autograd.profiler as autograd_profiler  # noqa: E402

import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch import profiler, tracing  # noqa: E402
from dsc_tpu_torch.fourier import plan  # noqa: E402
from dsc_tpu_torch.kernels import build  # noqa: E402

M, N, TAPS = 1000, 2048, 255


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**30, device='cpu')
    yield
    dt.shutdown()


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear_traces()
    yield
    tracing.set_recording(False)
    tracing.clear_traces()


@pytest.fixture
def recording():
    tracing.set_recording(True)
    yield
    tracing.set_recording(False)


def _rand(n, seed):
    return dt.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def _filterfft(s, b):
    """The README's filterFFT: five public calls (rfft, rfft, mul, irfft, get)."""
    return dt.irfft(dt.rfft(s, n=N) * dt.rfft(b, n=N))[:M]


def _tree(events):
    """(layer, name, depth, root) of each span in Begin order, from the B/E nesting."""
    out, depth = [], 0
    for e in events:
        if e['ph'] == 'B':
            out.append((tracing.layer_of(e['cat']), e['name'], depth, e['args']['root']))
            depth += 1
        else:
            depth -= 1
    assert depth == 0
    return out


@pytest.mark.parametrize('cat,layer', [('op;fft', 'api'), ('op;compile', 'api'),
                                       ('wrapper;launch', 'wrapper'), ('plain;fft', 'plain'),
                                       ('plan;fft', 'plan')])
def test_layer_of(cat, layer):
    assert tracing.layer_of(cat) == layer


def test_recording_off_returns_the_shared_null_context(monkeypatch):
    entered = []
    monkeypatch.setattr(autograd_profiler, '_is_profiler_enabled', True)
    monkeypatch.setattr(autograd_profiler, 'record_function',
                        lambda name: entered.append(name))
    ctx = tracing.trace_op('rfft', 'op;fft', {'n': 1})
    assert ctx is tracing.trace_op('k', 'wrapper;launch') is tracing._NULL
    with ctx:
        _filterfft(_rand(M, 0), _rand(TAPS, 1))
    assert tracing.num_traces() == 0 and tracing.totals() == {} and entered == []


def test_suppressed_records_nothing(recording):
    with tracing.suppressed():
        assert tracing.trace_op('rfft', 'op;fft') is tracing._NULL
    with tracing.trace_op('rfft', 'op;fft'):
        pass
    assert tracing.num_traces() == 2


def test_self_time_with_a_fake_clock(monkeypatch, recording):
    now = [0]
    monkeypatch.setattr(tracing, '_clock', lambda: now[0])
    with tracing.trace_op('outer', 'op;test'):
        now[0] = 10
        with tracing.trace_op('first', 'plain;test'):
            now[0] = 40
        now[0] = 50
        with tracing.trace_op('second', 'wrapper;test'):
            now[0] = 55
            with tracing.trace_op('first', 'plain;test'):
                now[0] = 60
            now[0] = 80
        now[0] = 100
    got = tracing.totals()
    assert got[('api', 'outer')] == {'count': 1, 'total_ns': 100, 'self_ns': 100 - 30 - 30}
    assert got[('wrapper', 'second')] == {'count': 1, 'total_ns': 30, 'self_ns': 30 - 5}
    assert got[('plain', 'first')] == {'count': 2, 'total_ns': 35, 'self_ns': 35}
    assert [e['ts'] for e in tracing._events] == [0, 0, 0, 0, 0, 0, 0, 0]


def test_filterfft_records_api_spans_over_plain_spans(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: syncs.append(a))
    s, b = _rand(M, 2), _rand(TAPS, 3)
    want = _filterfft(s, b).numpy()
    plan.reset_lookups()
    tracing.set_recording(True)
    got = _filterfft(s, b).numpy()
    tracing.set_recording(False)
    np.testing.assert_array_equal(got, want)
    assert plan.lookups == {'hit': 3, 'miss': 0}
    assert syncs == []
    tree = _tree(tracing._events)
    top = [(name, root) for layer, name, depth, root in tree if depth == 0]
    assert [name for name, _ in top] == ['rfft', 'rfft', 'mul', 'irfft', 'get']
    assert len({root for _, root in top}) == 5
    # every span under a public op carries that op's root
    root = None
    for layer, name, depth, r in tree:
        if depth == 0:
            assert layer == 'api'
            root = r
        else:
            assert r == root and layer == 'plain'
    assert {(layer, name) for layer, name, depth, _ in tree if depth} == {
        ('plain', 'pad'), ('plain', 'untangle'), ('plain', 'mul'), ('plain', 'entangle'),
        ('plain', 'index')}
    totals = tracing.totals()
    assert totals[('api', 'rfft')]['count'] == 2 and totals[('plain', 'pad')]['count'] == 2
    for t in totals.values():
        assert 0 <= t['self_ns'] <= t['total_ns']


def test_stft_records_its_plain_passes():
    stft = dt.models.STFT(frame=256, hop=64, window='hann', mode='log')
    x = dt.from_numpy(np.random.default_rng(4).standard_normal((2, 2048)).astype(np.float32))
    stft(x)  # its plan built
    tracing.set_recording(True)
    stft(x)
    tracing.set_recording(False)
    tree = _tree(tracing._events)
    assert tree[0][:3] == ('api', 'stft', 0)
    assert [(layer, name) for layer, name, depth, _ in tree[1:]] == [
        ('plain', 'window'), ('plain', 'untangle'), ('plain', 'power'), ('plain', 'log')]


def test_cycling_17_plans_through_the_lru_counts_misses(monkeypatch, recording):
    monkeypatch.setattr(plan, 'MAX_FFT_PLANS', 16)
    plan.clear_plans()
    plan.reset_lookups()
    sizes = [2**k for k in range(1, 18)]
    for _ in range(2):
        for n in sizes:
            plan.get_plan(n, 'complex', torch.complex64, 'cpu')
    assert plan.lookups == {'hit': 0, 'miss': 34}
    assert tracing.totals()[('plan', 'complex')]['count'] == 34
    plan.get_plan(2**17, 'complex', torch.complex64, 'cpu')
    assert plan.lookups == {'hit': 1, 'miss': 34}
    plan.reset_lookups()
    assert plan.lookups == {'hit': 0, 'miss': 0}
    plan.clear_plans()


def test_ring_keeps_whole_spans_and_the_totals_drop_nothing(monkeypatch, recording):
    monkeypatch.setattr(tracing, 'MAX_TRACES', 7)
    for _ in range(5):
        with tracing.trace_op('outer', 'op;test'):
            with tracing.trace_op('inner', 'plain;test'):
                pass
    _tree(tracing._events)  # balanced
    assert tracing.num_traces() == 6
    assert tracing.tensor_args(x=_rand(4, 9)) == {}  # the ring keeps no more arguments
    assert tracing.totals()[('plain', 'inner')]['count'] == 5
    tracing.clear_traces()
    assert tracing.num_traces() == 0 and tracing.totals() == {}


def test_profiler_copies_every_span_with_its_nesting():
    from torch.profiler import ProfilerActivity, profile

    s, b = _rand(M, 5), _rand(TAPS, 6)
    _filterfft(s, b)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.set_recording(True)
        _filterfft(s, b)
        tracing.set_recording(False)
    ring = [(f'dsc.{layer}.{name}', depth) for layer, name, depth, _ in _tree(tracing._events)]

    def depth(ev):
        d, p = 0, ev.cpu_parent
        while p is not None:
            d += p.name.startswith('dsc.')
            p = p.cpu_parent
        return d

    copies = sorted((e for e in prof.events() if e.name.startswith('dsc.')),
                    key=lambda e: e.time_range.start)
    assert [(e.name, depth(e)) for e in copies] == ring


def test_profile_xprof_dir_aligns_each_span(tmp_path, monkeypatch):
    loaded = []
    load = profiler._load_profiler_events
    monkeypatch.setattr(profiler, '_load_profiler_events',
                        lambda *a: loaded.append(load(*a)) or loaded[-1])
    s, b = _rand(M, 7), _rand(TAPS, 8)
    _filterfft(s, b)
    path = tmp_path / 'traces.json'
    with dt.profile(str(path), serve=False, xprof_dir=str(tmp_path / 'xprof')):
        _filterfft(s, b)
    events = json.loads(path.read_text())['traceEvents']
    begins = [e for e in events if e.get('ph') == 'B']
    # the merged file holds each span once: the profiler's copies are left out
    assert not any(str(e.get('name', '')).startswith('dsc.') for e in events)
    assert any(e.get('pid', 0) >= 1 << 22 for e in events)
    copies = sorted((e for e in loaded[0] if str(e.get('name', '')).startswith('dsc.')
                     and e.get('ph') == 'X'), key=lambda e: e['ts'])
    assert [e['name'] for e in copies] == [
        f'dsc.{tracing.layer_of(e["cat"])}.{e["name"]}' for e in begins]
    for ring, copy in zip(begins, copies):
        assert abs(copy['ts'] - ring['ts']) <= 1000, (ring, copy)


def test_launch_records_a_wrapper_span_and_counts(monkeypatch, recording):
    called = []
    lib = types.SimpleNamespace(dsc_base_fft=lambda *a: called.append(a) or 0)
    monkeypatch.setattr(build, '_lib', lib)
    monkeypatch.setattr(build, 'launches', dict.fromkeys(build.launches, 0))
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda *a: types.SimpleNamespace(cuda_stream=42))
    with tracing.trace_op('fft', 'op;fft'):
        build.launch('base_fft', 1, 2, 3, 4, 5, 6)
    assert called == [(1, 2, 3, 4, 5, 6, 42)]
    assert build.launches['base_fft'] == 1
    assert [(layer, name, depth) for layer, name, depth, _ in _tree(tracing._events)] == [
        ('api', 'fft', 0), ('wrapper', 'base_fft', 1)]
    assert tracing.totals()[('wrapper', 'base_fft')]['count'] == 1


def test_library_load_is_a_wrapper_span(monkeypatch, recording):
    monkeypatch.setattr(build, '_lib', None)
    monkeypatch.setattr(build, '_stale', lambda: False)
    monkeypatch.setattr(build.ctypes, 'CDLL', lambda path: mock.MagicMock())
    lib = build.load()
    assert build.load() is lib
    assert tracing.totals()[('wrapper', 'load')]['count'] == 1
