"""Every public name of dsc_tpu's modules has its counterpart in
dsc_tpu_torch, but for the names on ``EXCLUDED``, each with its reason;
and the port's counterparts of tests/test_tracing.py's recording tests.

A public name is one that does not start with an underscore. A module
bound in a module is a public name only where it is that module's own
submodule (``dsc_tpu.fourier.plan``): the port must then have a submodule
of that name, loaded or not. Any other bound module is an import, and an
import of the JAX package that the port lacks is on ``EXCLUDED`` too.
"""

import importlib
import importlib.util
import types
from typing import Union

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch import context, tensor, tracing  # noqa: E402

MODULES = ['', 'fourier', 'transforms', 'models', 'parallel', 'flags', 'tracing', 'profiler',
           'windows', 'context', 'capi', 'dtype', 'utils', 'tensor', 'interop']

_PLANAR = 'planar storage is left out by design (ROADMAP queue 1): complex values are complex64'
_PALLAS = 'a Pallas kernel file: its bodies are the CUDA sources under dsc_tpu_torch/csrc'
_JAX = 'the JAX module itself, imported'
_TYPING = 'a typing or functools name, imported'

# (module, name) -> why the port has no counterpart
EXCLUDED = {
    ('', 'planar'): _PLANAR,
    ('fourier', 'Planar'): _PLANAR,
    ('tensor', 'Planar'): _PLANAR,
    ('tensor', 'planar_ops'): _PLANAR,
    ('fourier', 'packed'): 'the unfused packed engine; packed_fused.py is the one the routes '
                           'take (ROADMAP queue 1)',
    ('fourier', 'pallas_kernels'): _PALLAS,
    ('fourier', 'pallas_reconstruct'): _PALLAS,
    ('fourier', 'pallas_stream'): _PALLAS,
    ('fourier', 'pallas_stream_t'): _PALLAS,
    ('context', 'on_tpu'): 'JAX-only: which backend runs; context.on_device fills its role',
    ('interop', 'move'): 'JAX-only: a device_put with planar staging; context.on_device and '
                         'Tensor.to fill its role',
    ('interop', 'ensure_placement'): 'JAX-only: placement across PJRT devices; context.on_device '
                                     'fills its role',
    ('interop', 'device_for_np_dtype'): 'JAX-only: homes complex128 on the host of a TPU; '
                                        'context.on_device fills its role',
    ('fourier', 'interop'): 'the JAX package\'s interop module, imported',
    ('tensor', 'flags'): 'the JAX package\'s flags module, imported (dsc_tpu_torch.flags '
                         'exists)',
    ('windows', 'jax'): _JAX,
    ('windows', 'jnp'): _JAX,
    ('context', 'jax'): _JAX,
    ('tensor', 'jax'): _JAX,
    ('tensor', 'jnp'): _JAX,
    ('interop', 'jax'): _JAX,
    ('interop', 'jnp'): _JAX,
    ('context', 'weakref'): 'the weakref module, imported',
    ('windows', 'partial'): _TYPING,
    ('tensor', 'partial'): _TYPING,
    ('interop', 'partial'): _TYPING,
    ('tensor', 'List'): _TYPING,
    ('tensor', 'OrderedDict'): _TYPING,
    ('interop', 'Optional'): _TYPING,
}

# submodules that a module binds once something imports them: imported
# here, so that what the comparison sees does not hang on the tests run
# before it
for _name in ('planar', 'fourier.packed', 'fourier.pallas_kernels', 'fourier.pallas_reconstruct',
              'fourier.pallas_stream', 'fourier.pallas_stream_t'):
    importlib.import_module(f'dsc_tpu.{_name}')


def _module(package: str, name: str) -> types.ModuleType:
    return importlib.import_module(package + (f'.{name}' if name else ''))


def _submodule(jmod: types.ModuleType, name: str) -> bool:
    value = getattr(jmod, name)
    return isinstance(value, types.ModuleType) and value.__name__ == f'{jmod.__name__}.{name}'


def _has(port: types.ModuleType, name: str, submodule: bool) -> bool:
    if submodule:
        return importlib.util.find_spec(f'{port.__name__}.{name}') is not None
    return hasattr(port, name)


def _public(jmod: types.ModuleType):
    """(name, whether it is a submodule) of each public name of ``jmod``:
    its own submodules, the names that are not modules, and the imported
    modules that EXCLUDED lists."""
    for name in dir(jmod):
        if name.startswith('_'):
            continue
        submodule = _submodule(jmod, name)
        if (isinstance(getattr(jmod, name), types.ModuleType) and not submodule
                and not any(key[1] == name for key in EXCLUDED)):
            continue  # an import of a module that no entry names
        yield name, submodule


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


@pytest.mark.parametrize('module', MODULES, ids=lambda m: m or 'dsc_tpu')
def test_every_public_name_has_a_counterpart(module):
    jmod, port = _module('dsc_tpu', module), _module('dsc_tpu_torch', module)
    names = dict(_public(jmod))
    assert names, module
    missing = sorted(name for name, submodule in names.items()
                     if (module, name) not in EXCLUDED and not _has(port, name, submodule))
    assert missing == [], f'dsc_tpu_torch.{module} lacks {missing}'


@pytest.mark.parametrize('key', sorted(EXCLUDED), ids=lambda k: '.'.join(filter(None, k)))
def test_each_exclusion_is_a_name_the_port_lacks(key):
    """An entry names a public name of the JAX module that the port does
    not have, with a reason: none is stale."""
    module, name = key
    jmod, port = _module('dsc_tpu', module), _module('dsc_tpu_torch', module)
    assert hasattr(jmod, name)
    assert not _has(port, name, _submodule(jmod, name))
    assert EXCLUDED[key].strip()


def test_names_of_this_slice():
    import dsc_tpu_torch.utils as tutils
    from dsc_tpu_torch.utils import debug

    assert (tutils.enable_debug_logging, tutils.log_debug, tutils.nan_guard) == (
        debug.enable_debug_logging, debug.log_debug, debug.nan_guard)
    assert tutils.__all__ == dsc_tpu.utils.__all__
    assert tensor.TensorType == Union['Tensor', np.ndarray]  # as dsc_tpu.tensor's
    assert tracing.is_recording() is False


def test_default_device_is_the_contexts(monkeypatch):
    """cuda:0 on a CUDA context, whether or not a card is there (no CPU
    fallback); the CPU on a CPU context; never the on_device override."""
    assert context.default_device() == torch.device('cpu')
    with context.on_device(torch.device('meta')):
        assert context.default_device() == torch.device('cpu')
    monkeypatch.setattr(context, '_ctx', None)
    dt.init(2**20)
    assert context.default_device() == torch.device('cuda', 0)
    monkeypatch.setattr(context, '_ctx', None)
    dt.init(2**20, device='cuda:1')
    assert context.default_device() == torch.device('cuda', 1)


# ---------------------------------------------------------------------------
# tests/test_tracing.py's recording tests, on the port
# ---------------------------------------------------------------------------


def test_recording_off_is_free():
    tracing.clear_traces()
    x = dt.from_numpy(np.random.default_rng(0).standard_normal(8).astype(np.float32))
    _ = x * 2.0
    assert tracing.num_traces() == 0 and not tracing.is_recording()


def test_start_stop_recording(tmp_path):
    tracing.clear_traces()
    dt.start_recording()
    assert tracing.is_recording()
    x = dt.from_numpy(np.random.default_rng(1).standard_normal(8).astype(np.float32))
    _ = x + 1.0
    assert tracing.num_traces() > 0
    dt.stop_recording(str(tmp_path / 't.json'), serve=False)
    assert not tracing.is_recording()
    assert tracing.num_traces() == 0  # cleared after the dump
    assert (tmp_path / 't.json').stat().st_size > 0


def test_trace_ring_capacity():
    tracing.clear_traces()
    old = tracing.MAX_TRACES
    tracing.MAX_TRACES = 10
    try:
        dt.start_recording()
        x = dt.from_numpy(np.random.default_rng(2).standard_normal(8).astype(np.float32))
        for _ in range(20):
            _ = x + 1.0
        assert tracing.num_traces() == 10
    finally:
        dt.stop_recording()
        tracing.MAX_TRACES = old
        tracing.clear_traces()
