"""The check that decides ``correct``, at a tiny size on the CPU: each cell's pipeline
against its plain reference, the bfloat16 control and the faults the cells can have all read
above the limit, and a run with the timed path broken underneath comes out not correct."""

import time

import pytest
import torch

from portbench import compare, harness, registry

CELLS = ['filterfft.long', 'spectrogram.clips', 'filterfft.multichannel']
SEED = 2**31 + 77


def _parts(cell):
    cfg = registry.config(cell['config'])
    return cfg, registry.pipeline(cfg), registry.reference(cfg)


@pytest.mark.parametrize('name', CELLS)
def test_pipeline_matches_reference(name, tiny):
    cell = tiny(name)
    cfg, pipe, ref = _parts(cell)
    state = pipe.setup(cfg, cell, 'cpu')
    try:
        for r in pipe.make_inputs(cfg, cell, SEED, 'cpu'):
            got = pipe.result(pipe.call(state, pipe.prepare(state, r), harness.quiet))
            want = ref.run(cfg, r)
            for c in cfg['checks']:
                value = compare.gap(c['kind'], got, want)
                assert value < c['limit'] / 10, (c['name'], value)
    finally:
        pipe.teardown()


@pytest.mark.parametrize('name', CELLS)
def test_same_seed_same_inputs(name, tiny):
    cell = tiny(name)
    cfg, pipe, _ = _parts(cell)
    a = pipe.make_inputs(cfg, cell, SEED, 'cpu')
    b = pipe.make_inputs(cfg, cell, SEED, 'cpu')
    c = pipe.make_inputs(cfg, cell, SEED + 1, 'cpu')
    assert len(a) == cell['pool']
    for x, y, z in zip(a, b, c):
        for k in x:
            assert torch.equal(x[k], y[k])
        assert not all(torch.equal(x[k], z[k]) for k in x if x[k].numel() > 255)


def _run(name, cell, trace=False):
    result = harness.run(name, SEED, 0.2, trace, time.perf_counter(), 'cpu', cell)
    assert list(result)[-1] == 'checks'
    return result


@pytest.mark.parametrize('name', CELLS)
@pytest.mark.parametrize('trace', [False, True])
def test_sound_run_is_correct(name, trace, tiny):
    result = _run(name, tiny(name), trace)
    assert result['correct'] and result['failed'] == 0 and result['attempted'] > 0
    # the CPU has no device events: only the host's per-layer metrics are read; a p95 needs
    # 200 calls, which a short run on a busy CPU may not make
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
    """Half of the batch left out: the second half of the rows never computed."""
    import dsc_tpu_torch as dsc
    call = pipe.call

    def half(state, args, span):
        t = call(state, args, span).torch.clone()
        t[t.shape[0] // 2:] = 0
        return dsc.Tensor(t)

    return {'call': half}


def _altered(pipe):
    """One answer altered where it is produced: one value of each result moved."""
    import dsc_tpu_torch as dsc
    call = pipe.call

    def altered(state, args, span):
        t = call(state, args, span).torch.clone()
        flat = t.view(-1)
        flat[flat.numel() // 3] += 0.5 * float(flat.abs().max()) + 1.0
        return dsc.Tensor(t)

    return {'call': altered}


FAULTS = {'unchanged': _unchanged, 'half_batch': _half_batch, 'altered': _altered}
# the faults each cell can have: one chip (no exchange); a single signal has no batch
CASES = [(n, f) for n in CELLS for f in FAULTS
         if not (f == 'half_batch' and n == 'filterfft.long')]


@pytest.mark.parametrize('name,fault', CASES)
def test_broken_path_is_not_correct(name, fault, tiny, monkeypatch):
    cell = tiny(name)
    _, pipe, _ = _parts(cell)
    for attr, fn in FAULTS[fault](pipe).items():
        monkeypatch.setattr(pipe, attr, fn)
    assert not _run(name, cell)['correct']


@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(name, tiny, monkeypatch):
    """The control, the reference in bfloat16 in the program's place, fails the limit."""
    cell = tiny(name)
    cfg, pipe, ref = _parts(cell)
    for attr, fn in _control(cfg, ref).items():
        monkeypatch.setattr(pipe, attr, fn)
    result = _run(name, cell)
    assert not result['correct']
    assert any(c['value'] > c['limit'] for c in result['checks'].values())


def test_gap_kinds():
    ref = torch.tensor([1.0, -4.0, 2.0], dtype=torch.float64)
    got = torch.tensor([1.0, -3.0, 2.0])
    assert compare.gap('max_abs', got, ref) == 1.0
    assert compare.gap('max_abs_over_max_ref', got, ref) == 0.25
    assert compare.gap('mean_abs', got, ref) == pytest.approx(1 / 3)
    assert compare.gap('max_abs', got[:2], ref) == float('inf')
    assert compare.gap('max_abs', torch.tensor([float('nan'), -4.0, 2.0]), ref) == float('inf')
