"""Each metric's reader on a canned record: two calls of a traced window with known device
and host events (ns), and an untraced window's host times and launch counts."""

import pytest

from portbench import registry, trace

KERNEL = 'void (anonymous namespace)::stream_column_kernel<false, false, 4, false, true>(float2*)'
ATEN = 'void at::native::vectorized_elementwise_kernel<4, at::native::MulFunctor<float>>()'
S = trace.SPAN
# two calls, each: host span 'call' with an 'rfft' span launching the port's kernel (corr 1,
# 3) and a 'multiply' span whose ATen op launches a kernel (corr 2, 4), then a 'wait'
# the runtime's calls (correlation ids 1, 3) and the operators (ids 2, 4, which their
# kernels name as linked ids) share a number space: 2 is also a runtime call's id
U, O, R = False, False, True
HOST = [
    (S + 'call', 0, 100, 90, U), (S + 'rfft', 10, 40, 91, U),
    ('cudaLaunchKernel', 20, 30, 1, R), (S + 'multiply', 50, 90, 92, U),
    ('aten::mul', 55, 85, 2, O), ('cudaLaunchKernel', 60, 70, 11, R),
    (S + 'wait', 100, 400, 93, U), (S + 'call', 400, 500, 94, U), (S + 'rfft', 410, 440, 95, U),
    ('cudaLaunchKernel', 420, 430, 3, R), (S + 'multiply', 450, 490, 96, U),
    ('aten::mul', 455, 485, 4, O), ('cudaLaunchKernel', 460, 470, 2, R),
    (S + 'wait', 500, 700, 97, U),
]
DEVICE = [(KERNEL, 100, 300, 1, 0), (ATEN, 300, 350, 11, 2), (KERNEL, 450, 650, 3, 0),
          (ATEN, 650, 700, 2, 4)]


def record(traced=True):
    return {
        'setup_s': 7.5, 'window_s': 2.0, 'calls': 4000, 'samples_per_call': 2**20,
        'latency_s': [0.001 * (1 + i % 100) for i in range(1000)],
        'host_s': [1e-4, 3e-4], 'launches': {'rfft_phase_a': 8000, 'rfft_phase_b': 4000},
        'peak_bytes': 3 * 2**30, 'bytes_needed': 10**6, 'peak_bytes_per_s': 4e12,
        'trace': {'device': DEVICE, 'host': HOST, 'calls': 2, 'launches': 2} if traced else None,
    }


@pytest.mark.parametrize('name,expected', [
    ('setup_s', 7.5),
    ('samples_per_s', 4000 * 2**20 / 2.0 / 1e6),
    # the exclusive method: position 0.95 * 1001 = 950.95, between 95 and 96 ms
    ('call_ms_p95', 95.95),
    ('peak_mib', 3072.0),
    ('host_ms', 0.2),
    ('launches', 3.0),
    # ATen's kernels: 50 + 50 ns over 2 calls
    ('torch_op_ms', 50 / 1e6),
    # 10^6 bytes at 4e12 B/s is 250 ns a call, over 250 ns of device time a call
    ('roofline_pct', 100.0),
    # window 0..700 ns, busy 100..350 and 450..700
    ('idle_pct', 100 * 200 / 700),
])
def test_reader(name, expected):
    assert registry.metric(name).read(record()) == pytest.approx(expected)


@pytest.mark.parametrize('name', ['torch_op_ms', 'roofline_pct', 'idle_pct'])
def test_trace_reader_without_a_trace_returns_nothing(name):
    assert registry.metric(name).read(record(traced=False)) is None
    empty = {**record(), 'trace': {'device': [], 'host': HOST, 'calls': 2, 'launches': 0}}
    assert registry.metric(name).read(empty) is None


def test_p95_needs_200_calls():
    assert registry.metric('call_ms_p95').read({**record(), 'latency_s': [0.001] * 199}) is None


def test_roofline_without_a_peak_returns_nothing():
    assert registry.metric('roofline_pct').read({**record(), 'peak_bytes_per_s': None}) is None


def test_device_time_by_span():
    assert trace.by_span(record()['trace']) == {'rfft': 400, 'multiply': 100}


def test_window_without_spans_is_the_device_activity():
    tr = {**record()['trace'], 'host': [h for h in HOST if h[4]]}
    assert trace.window(tr) == (100, 700)
    assert registry.metric('idle_pct').read({**record(), 'trace': tr}) == pytest.approx(
        100 * 100 / 600)


def test_breakdown():
    tr = record()['trace']
    got = trace.breakdown(tr, tr)
    assert got['device_ops'] == [[KERNEL, 400e-9], [ATEN, 100e-9]]
    # idle 0..100 (middle 50: the first multiply span, inside aten::mul) and 350..450
    # (middle 400: the second call has just begun)
    assert got['idle_gaps'] == [[f'{S}multiply / {S}multiply', 100e-9],
                                [f'{S}call / {S}call', 100e-9]]


def test_busy_merges_overlaps():
    assert trace.busy([(0, 10), (5, 20), (30, 40)], 2, 35) == [(2, 20), (30, 35)]
