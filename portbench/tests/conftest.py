import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell's traffic at a size the CPU runs in well under a second
TINY = {
    'filterfft.long': {'shape': [1 << 14]},
    'filterfft.multichannel': {'shape': [4, 1 << 12]},
    'spectrogram.clips': {'shape': [4, 22050], 'valid_s': [0.3, 1.0]},
}


@pytest.fixture
def tiny():
    """cell name -> its workload at a tiny size, with a short warm-up."""
    from portbench import registry

    def make(name):
        return {**registry.workload(name), **TINY[name], 'warmup_s': 0.02}

    return make


@pytest.fixture(autouse=True)
def port_released():
    """A run that fails part way leaves the port initialised: release it."""
    yield
    import dsc_tpu_torch as dsc

    dsc.shutdown()
