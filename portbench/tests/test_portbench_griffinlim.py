"""The Griffin-Lim cell at a tiny size on the CPU: its pipeline against its plain reference,
whole runs that are correct, the faults it can have and the bfloat16 control read not
correct; its sizes; the ``device_ops`` reader on canned records."""

import time

import pytest
import torch

from portbench import compare, harness, registry

NAME = 'griffinlim.clips'
SEED = 2**31 + 91
# two clips of 8,192 samples (33 frames) holding 0.1-0.3 s of signal
TINY = {'shape': [2, 8192], 'valid_s': [0.1, 0.3], 'warmup_s': 0.02}


@pytest.fixture
def cell():
    return {**registry.workload(NAME), **TINY}


def _parts(cell):
    cfg = registry.config(cell['config'])
    return cfg, registry.pipeline(cfg), registry.reference(cfg)


def test_pipeline_matches_reference(cell):
    cfg, pipe, ref = _parts(cell)
    state = pipe.setup(cfg, cell, 'cpu')
    try:
        for r in pipe.make_inputs(cfg, cell, SEED, 'cpu'):
            got = pipe.result(pipe.call(state, pipe.prepare(state, r), harness.quiet))
            want = ref.run(cfg, r)
            assert got.shape == (2, 8192) and got.dtype == torch.float32
            for c in cfg['checks']:
                value = compare.gap(c['kind'], got, want)
                assert value < c['limit'] / 10, (c['name'], value)
    finally:
        pipe.teardown()


def test_same_seed_same_inputs(cell):
    cfg, pipe, _ = _parts(cell)
    a = pipe.make_inputs(cfg, cell, SEED, 'cpu')
    b = pipe.make_inputs(cfg, cell, SEED, 'cpu')
    c = pipe.make_inputs(cfg, cell, SEED + 1, 'cpu')
    assert len(a) == cell['pool']
    for x, y, z in zip(a, b, c):
        assert x['length'] == 8192 and x['magnitudes'].shape == (2, 33, 513)
        for k in ('magnitudes', 'angles'):
            assert torch.equal(x[k], y[k]) and not torch.equal(x[k], z[k])
        assert torch.allclose(x['angles'].abs(), torch.ones(()), atol=1e-6)


def _run(cell, trace=False):
    result = harness.run(NAME, SEED, 0.2, trace, time.perf_counter(), 'cpu', cell)
    assert list(result)[-1] == 'checks'
    return result


@pytest.mark.parametrize('trace', [False, True])
def test_sound_run_is_correct(trace, cell):
    result = _run(cell, trace)
    assert result['correct'] and result['failed'] == 0 and result['attempted'] > 0
    got = set(result['metrics'])
    if trace:
        assert got == {'host_ms', 'launches'}
    else:
        assert {'setup_s', 'samples_per_s'} <= got <= {'setup_s', 'samples_per_s', 'call_ms_p95'}


def _control(cfg, ref):
    import dsc_tpu_torch as dsc

    return {'prepare': lambda state, raw: raw,
            'call': lambda state, raw, span: dsc.Tensor(ref.control(cfg, raw))}


def _unchanged(pipe):
    """A step that returns its state unchanged: every call answers what the first did."""
    first = []
    call = pipe.call

    def stale(state, args, span):
        if not first:
            first.append(call(state, args, span))
        return first[0]

    return {'call': stale}


def _half_batch(pipe):
    """Half of the batch left out: the second half of the clips never computed."""
    import dsc_tpu_torch as dsc
    call = pipe.call

    def half(state, args, span):
        t = call(state, args, span).torch.clone()
        t[t.shape[0] // 2:] = 0
        return dsc.Tensor(t)

    return {'call': half}


def _altered(pipe):
    """One answer altered where it is produced: one sample of each result moved."""
    import dsc_tpu_torch as dsc
    call = pipe.call

    def altered(state, args, span):
        t = call(state, args, span).torch.clone()
        flat = t.view(-1)
        flat[flat.numel() // 3] += 0.5 * float(flat.abs().max()) + 1.0
        return dsc.Tensor(t)

    return {'call': altered}


@pytest.mark.parametrize('fault', [_unchanged, _half_batch, _altered],
                         ids=['unchanged', 'half_batch', 'altered'])
def test_broken_path_is_not_correct(fault, cell, monkeypatch):
    _, pipe, _ = _parts(cell)
    for attr, fn in fault(pipe).items():
        monkeypatch.setattr(pipe, attr, fn)
    assert not _run(cell)['correct']


def test_control_is_not_correct(cell, monkeypatch):
    """The control, the reference in bfloat16 in the program's place, fails a limit."""
    cfg, pipe, ref = _parts(cell)
    for attr, fn in _control(cfg, ref).items():
        monkeypatch.setattr(pipe, attr, fn)
    result = _run(cell)
    assert not result['correct']
    assert any(c['value'] > c['limit'] for c in result['checks'].values())


def test_sizes():
    """64 clips of 220,500 samples: 862 frames of 513 bins, 28,301,184 bins and 14,112,000
    samples a call; 32 iterations of 28 bytes a bin and 8 a sample, then the last inverse's
    12 and 4."""
    cell = registry.workload(NAME)
    cfg = registry.config(cell['config'])
    pipe = registry.pipeline(cfg)
    assert pipe.frames(cfg, cell) == 862
    assert pipe.samples(cfg, cell) == 14_112_000
    bins = 28_301_184
    assert pipe.bytes_needed(cfg, cell) == 32 * (28 * bins + 8 * 14_112_000) + 12 * bins + (
        4 * 14_112_000) == 29_366_595_072


def test_configuration_states_the_deployment():
    cfg = registry.config('griffinlim')
    assert (cfg['n_fft'], cfg['hop'], cfg['win_length'], cfg['n_iter']) == (1024, 256, 1024, 32)
    assert (cfg['momentum'], cfg['eps'], cfg['center'], cfg['pad_mode']) == (
        0.99, 1e-16, True, 'constant')
    assert cfg['window'] == 'periodic_hann' and cfg['reduced'] == []
    assert {c['kind'] for c in cfg['checks']} == {'max_abs_over_max_ref', 'mean_abs'}


# three device events over two calls; an empty or missing trace reads nothing
DEVICE = [('void at::native::vectorized_elementwise_kernel<4>()', 0, 10, 1, 0),
          ('Memcpy DtoD (Device -> Device)', 10, 20, 2, 0),
          ('void (anonymous namespace)::base_fft_kernel<9>(float2 const*)', 20, 90, 3, 0)]


@pytest.mark.parametrize('trace,expected', [
    ({'device': DEVICE, 'host': [], 'calls': 2}, 1.5),
    ({'device': DEVICE[:1], 'host': [], 'calls': 1}, 1.0),
    ({'device': [], 'host': [], 'calls': 2}, None),
    ({'device': DEVICE, 'host': [], 'calls': 0}, None),
    (None, None),
])
def test_device_ops_reader(trace, expected):
    assert registry.metric('device_ops').read({'trace': trace}) == expected
