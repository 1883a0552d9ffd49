"""One short run of each cell on the card (marker ``gpu``): it prints a result with
``correct`` true and every end-to-end metric of the cell."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import registry

CELLS = [w['name'] for w in registry.benchmark()['workloads']]


@pytest.mark.gpu
@pytest.mark.parametrize('name', CELLS)
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload', name, '--seed',
                          '2147483999', '--seconds', '1', '--trace', '0'],
                         cwd=registry.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], result
    assert set(result['metrics']) == {m['name'] for m in registry.metrics_of(False)}
