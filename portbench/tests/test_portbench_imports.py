"""What a run imports: never JAX or the package the port was made from; the references
nothing of the port either. And a run with no card, or with no port beside it, prints no
result and exits with another code than 0."""

import shutil
import subprocess
import sys

import pytest

from portbench import registry

ROOT = str(registry.ROOT)


def _python(code, cwd=ROOT):
    return subprocess.run([sys.executable, '-c', code], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_run_loads_no_jax():
    out = _python(f"""
import sys
sys.path.insert(0, {ROOT!r})
from portbench import harness, registry
for c in registry.benchmark()['configs']:
    cfg = registry.config(c['name'])
    registry.pipeline(cfg), registry.reference(cfg)
for m in registry.benchmark()['end_to_end'] + registry.benchmark()['per_layer']:
    registry.metric(m['name'])
print(harness.forbidden_modules())
""")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_references_load_nothing_of_the_port():
    out = _python(f"""
import sys
sys.path.insert(0, {ROOT!r})
from portbench import registry
for c in registry.benchmark()['configs']:
    registry.reference(registry.config(c['name']))
print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'jax', 'jaxlib', 'flax', 'dsc_tpu',
                                                          'dsc_tpu_torch'}}))
""")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_forbidden_names_are_compared_whole():
    from portbench import harness

    assert 'dsc_tpu_torch' in sys.modules
    assert 'dsc_tpu_torch' not in harness.forbidden_modules()


def test_no_card_no_result():
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload', 'filterfft.long',
                          '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip('this machine has a CUDA device')
    assert out.stdout == ''


def test_without_the_port_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and portbench/: the port is missing."""
    shutil.copy(registry.ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(registry.HERE, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = _python("""
import runpy, sys
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.argv = ['portbench/run.py', '--workload', 'filterfft.long', '--seed', '1',
            '--seconds', '1', '--trace', '0']
runpy.run_path('portbench/run.py', run_name='__main__')
""", cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ''
