"""BENCHMARK.json against the benchmark's contract, and every piece it names found by name."""

import json
import math
import re

import pytest

from portbench import registry

SPEC = registry.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in SPEC['workloads']]
METRICS = SPEC['end_to_end'] + SPEC['per_layer']


def test_top_level_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                         'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['portbench']
    assert SPEC['command'][1] == 'portbench/run.py'
    assert 1 <= SPEC['run_seconds'] <= 51
    assert len((registry.ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (SPEC['run_seconds'] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize('entry', SPEC['configs'], ids=lambda c: c['name'])
def test_config_file(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(entry['name'])
    assert entry['file'] == f'portbench/configs/{entry["name"]}.json'
    cfg = registry.config(entry['name'])
    assert cfg['name'] == entry['name'] and cfg['source'] == entry['source']
    assert cfg['reduced'] == entry['reduced']
    assert 1 <= len(entry['source']) <= 200 and 1 <= len(entry['why']) <= 200
    assert hasattr(registry.pipeline(cfg), 'call') and hasattr(registry.reference(cfg), 'run')
    for c in cfg['checks']:
        assert set(c) == {'name', 'kind', 'limit'} and NAME.match(c['name'])


@pytest.mark.parametrize('name', CELLS)
def test_workload_file(name):
    entry = next(w for w in SPEC['workloads'] if w['name'] == name)
    assert set(entry) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(name) and NAME.match(entry['traffic']) and entry['chips'] == 1
    assert len(entry['why']) <= 200 and '\n' not in entry['why']
    cell = registry.workload(name)
    assert cell['config'] in {c['name'] for c in SPEC['configs']}
    assert cell['pool'] >= 4 and cell['in_flight'] >= 2 and cell['warmup_s'] >= 0.25


@pytest.mark.parametrize('m', METRICS, ids=lambda m: m['name'])
def test_metric_reader(m):
    assert NAME.match(m['name']) and UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    assert callable(registry.metric(m['name']).read)
    if m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace') and 0.01 <= m['bound'] <= 0.25
    else:
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        assert m['moves'] in {e['name'] for e in SPEC['end_to_end']}
        assert m['layer'] and '\n' not in m['layer']


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_reports_enough(name):
    # the harness reports every metric in every cell: none may be limited to some cells
    assert not any('workloads' in m for m in METRICS)
    e2e = {m['name'] for m in registry.metrics_of(False)}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert registry.metrics_of(True)
    assert name in CELLS


def test_names_are_unique():
    for group in (SPEC['configs'], SPEC['workloads'], METRICS):
        names = [g['name'] for g in group]
        assert len(names) == len(set(names))
    assert len({(w['config'], w['traffic']) for w in SPEC['workloads']}) == len(CELLS)


# each public op's arguments read once and results written once: for one signal of 2^24
# (n = 2^25) 201,326,600 (rfft) + 134,218,756 (the taps' rfft) + 402,653,208 (multiply) +
# 268,435,464 (irfft); for 32 x 2^20 (n = 2^21) 402,653,440 + 8,389,636 + 545,260,040 +
# 536,871,168; for 64 clips of 220,500 the clips and the 64 x 858 x 513 spectrogram
@pytest.mark.parametrize('name,expected', [
    ('filterfft.long', 1_006_634_028),
    ('filterfft.multichannel', 1_493_174_284),
    ('spectrogram.clips', 169_127_424),
])
def test_bytes_needed(name, expected):
    cell = registry.workload(name)
    cfg = registry.config(cell['config'])
    assert registry.pipeline(cfg).bytes_needed(cfg, cell) == expected


@pytest.mark.parametrize('shape,expected', [([2**23], 503_317_548), ([16, 2**20], 754_976_268)])
def test_bytes_needed_at_other_sizes(shape, expected):
    """One signal of 2^23 (n = 2^24) and 16 x 2^20: the sums the cells were first sized at."""
    cell = {**registry.workload('filterfft.long'), 'shape': shape}
    cfg = registry.config('filterfft')
    assert registry.pipeline(cfg).bytes_needed(cfg, cell) == expected


def test_peak_table():
    peaks = json.loads((registry.HERE / 'peaks.json').read_text())
    assert math.isclose(peaks['NVIDIA H100 80GB HBM3']['hbm_bytes_per_s'], 3.35e12)
