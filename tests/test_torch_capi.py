"""The port's C-ABI surface (dsc_tpu_torch/capi.py) against the JAX
package's (dsc_tpu/capi.py) on the same buffers: shapes, dtype codes and
values (atol = rtol = 1e-5, as tests/conftest.py's all_close), slices with
the 2^31 - 1 sentinel the C side passes; and the port's C shim and C++
harness (dsc_tpu_torch/cpp: cpp/tests/test_filterfft.cpp over
dsc_tpu_torch.capi) built with g++ and run on the CPU.

The port's context is process-wide: the module initialises it through
``capi.ctx_init`` with DSC_DEVICE=cpu and puts back whatever context and
environment it found, in a ``finally``."""

import gc
import json
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from dsc_tpu import capi as jcapi  # noqa: E402
from dsc_tpu_torch import capi as tcapi  # noqa: E402
from dsc_tpu_torch import context as tcontext  # noqa: E402
from dsc_tpu_torch.dtype import DTYPE_TO_NP, Dtype  # noqa: E402

EPS = 1e-5
NONE = 2**31 - 1
F32, F64, C32, C64 = 0, 1, 2, 3
NP = {F32: np.float32, F64: np.float64, C32: np.complex64, C64: np.complex128}


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    saved_ctx, saved_env = tcontext._ctx, os.environ.get('DSC_DEVICE')
    tcontext._ctx = None
    os.environ['DSC_DEVICE'] = 'cpu'
    try:
        assert tcapi.ctx_init(2**32, 2**30) == 0
        assert tcontext.device().type == 'cpu'
        # the JAX imports leave a large heap that the gc.collect() after every
        # test (tests/conftest.py) would otherwise rescan each time
        gc.freeze()
        yield
    finally:
        gc.unfreeze()
        tcontext._ctx = saved_ctx
        if saved_env is None:
            os.environ.pop('DSC_DEVICE', None)
        else:
            os.environ['DSC_DEVICE'] = saved_env


def _data(code, shape, seed=0, positive=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if positive:
        x = np.abs(x) + 0.25
    if code in (C32, C64):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(NP[code])


def _put(code, x):
    """The same buffer through both front doors: (JAX handle, port handle)."""
    return tuple(c.tensor_from_buffer(x.tobytes(), code, x.shape) for c in (jcapi, tcapi))


def _read(capi, h):
    code = capi.tensor_dtype(h)
    arr = np.frombuffer(capi.tensor_to_buffer(h), DTYPE_TO_NP[Dtype(code)])
    return code, arr.reshape(capi.tensor_shape(h))


def _same(hj, ht, eps=EPS):
    """Both handles hold the same shape, dtype code and values."""
    (cj, aj), (ct, at) = _read(jcapi, hj), _read(tcapi, ht)
    assert jcapi.tensor_shape(hj) == tcapi.tensor_shape(ht)
    assert cj == ct
    assert np.isclose(at, aj, atol=eps, rtol=eps, equal_nan=True).all()
    return at


def _both(name, *args):
    return getattr(jcapi, name)(*args), getattr(tcapi, name)(*args)


# -- buffers and creation ------------------------------------------------------


@pytest.mark.parametrize('code', [F32, F64, C32, C64])
def test_roundtrip_buffer(code):
    x = _data(code, (3, 4), code)
    hj, ht = _put(code, x)
    assert tcapi.tensor_shape(ht) == (3, 4) and tcapi.tensor_dtype(ht) == code
    assert tcapi.tensor_to_buffer(ht) == x.tobytes()
    _same(hj, ht, 0)
    tcapi.tensor_free(ht)
    with pytest.raises(KeyError):
        tcapi.tensor_shape(ht)


@pytest.mark.parametrize('args', [(2.5, 0.0, F32), (-1.0, 0.0, F64), (1.5, -2.0, C32),
                                  (0.0, 3.0, C64)])
def test_wrap_scalar_and_full(args):
    _same(*_both('wrap_scalar', *args), 0)
    _same(*_both('full', (2, 3), *args), 0)


@pytest.mark.parametrize('code', [F32, F64])
def test_arange(code):
    _same(*_both('arange', 17, code), 0)


@pytest.mark.parametrize('code', [F32, C32])
def test_randn_shape_and_dtype(code):
    # the two packages draw from different generators: shape, code, finite
    hj, ht = _both('randn', (64, 32), code)
    assert tcapi.tensor_shape(ht) == jcapi.tensor_shape(hj) == (64, 32)
    assert tcapi.tensor_dtype(ht) == jcapi.tensor_dtype(hj) == code
    _, a = _read(tcapi, ht)
    assert np.isfinite(a).all() and 0.5 < a.std() < 1.5


# -- ops -------------------------------------------------------------------------


@pytest.mark.parametrize('code', [F32, F64, C32, C64])
@pytest.mark.parametrize('name', ['add', 'sub', 'mul', 'div'])
def test_binary_op(name, code):
    a, b = _data(code, (4, 5), 1), _data(code, (4, 5), 2, positive=True)
    (ja, ta), (jb, tb) = _put(code, a), _put(code, b)
    _same(jcapi.binary_op(name, ja, jb), tcapi.binary_op(name, ta, tb))


@pytest.mark.parametrize('code', [F32, F64])
def test_binary_pow(code):
    a, b = _data(code, (6,), 1, positive=True), _data(code, (6,), 2)
    (ja, ta), (jb, tb) = _put(code, a), _put(code, b)
    _same(jcapi.binary_op('pow', ja, jb), tcapi.binary_op('pow', ta, tb))


@pytest.mark.parametrize('reflected', [0, 1])
@pytest.mark.parametrize('name', ['add', 'sub', 'mul', 'div', 'pow'])
def test_binary_scalar(name, reflected):
    x = _data(F32, (8,), 3, positive=True)
    hj, ht = _put(F32, x)
    _same(jcapi.binary_scalar(name, hj, 1.5, 0.0, 0, reflected),
          tcapi.binary_scalar(name, ht, 1.5, 0.0, 0, reflected))


@pytest.mark.parametrize('name', ['add', 'mul', 'div'])
def test_binary_complex_scalar(name):
    x = _data(C32, (8,), 4)
    hj, ht = _put(C32, x)
    _same(jcapi.binary_scalar(name, hj, 0.5, -2.0, 1, 0),
          tcapi.binary_scalar(name, ht, 0.5, -2.0, 1, 0))


UNARY = ['cos', 'sin', 'sinc', 'logn', 'log2', 'log10', 'exp', 'sqrt', 'abs', 'angle', 'conj',
         'real', 'imag', 'i0']


@pytest.mark.parametrize('name', UNARY)
def test_unary_op(name):
    x = _data(F32, (3, 7), 5, positive=True)
    hj, ht = _put(F32, x)
    _same(jcapi.unary_op(name, hj), tcapi.unary_op(name, ht))


@pytest.mark.parametrize('name', ['exp', 'sqrt', 'abs', 'angle', 'conj', 'real', 'imag'])
def test_unary_op_complex(name):
    x = _data(C32, (9,), 6)
    hj, ht = _put(C32, x)
    _same(jcapi.unary_op(name, hj), tcapi.unary_op(name, ht))


@pytest.mark.parametrize('has_lo,has_hi', [(1, 1), (1, 0), (0, 1)])
def test_clip(has_lo, has_hi):
    x = _data(F32, (10,), 7)
    hj, ht = _put(F32, x)
    _same(jcapi.clip(hj, -0.5, 0.75, has_lo, has_hi), tcapi.clip(ht, -0.5, 0.75, has_lo, has_hi))


@pytest.mark.parametrize('axis,keepdims', [(-1, 0), (0, 1)])
@pytest.mark.parametrize('name', ['sum', 'mean', 'max', 'min'])
def test_reduce_op(name, axis, keepdims):
    x = _data(F32, (4, 6), 8)
    hj, ht = _put(F32, x)
    _same(jcapi.reduce_op(name, hj, axis, keepdims), tcapi.reduce_op(name, ht, axis, keepdims))


# -- layout ----------------------------------------------------------------------


def test_reshape_transpose_concat_cast():
    x = _data(F32, (2, 3, 4), 9)
    hj, ht = _put(F32, x)
    _same(*(c.reshape(h, (6, 4)) for c, h in ((jcapi, hj), (tcapi, ht))), 0)
    _same(*(c.transpose(h, (1, 0, 2)) for c, h in ((jcapi, hj), (tcapi, ht))), 0)
    _same(*(c.transpose(h, ()) for c, h in ((jcapi, hj), (tcapi, ht))), 0)
    yj, yt = _put(F32, _data(F32, (2, 3, 4), 10))
    _same(jcapi.concat((hj, yj), 0, 0), tcapi.concat((ht, yt), 0, 0), 0)
    _same(jcapi.concat((hj, yj), 0, 1), tcapi.concat((ht, yt), 0, 1), 0)
    for code in (F64, C32):
        _same(jcapi.cast(hj, code), tcapi.cast(ht, code))


# -- slices ------------------------------------------------------------------------


# (starts, stops, steps, is_index) as the C side passes them
SLICES = {
    'x[1, ::-1]': ((1, NONE), (1, NONE), (1, -1), (1, 0)),
    'x[:, 2]': ((NONE, 2), (NONE, 2), (NONE, 2), (0, 1)),
    'x[1:4, ::2]': ((1, NONE), (4, NONE), (NONE, 2), (0, 0)),
    'x[-2:, -1]': ((-2, -1), (NONE, -1), (NONE, -1), (0, 1)),
    'x[2, 3]': ((2, 3), (2, 3), (2, 3), (1, 1)),
}


@pytest.mark.parametrize('key', list(SLICES))
def test_get_slice(key):
    x = _data(F32, (5, 5), 11)
    hj, ht = _put(F32, x)
    _same(jcapi.get_slice(hj, *SLICES[key]), tcapi.get_slice(ht, *SLICES[key]), 0)


def test_set_slice():
    x = _data(F32, (5, 5), 12)
    hj, ht = _put(F32, x)
    vj, vt = _put(F32, np.asarray([9.0, 9.0], np.float32))
    _both_set = [(jcapi, hj, vj), (tcapi, ht, vt)]
    for c, h, v in _both_set:
        c.set_slice(h, v, (2, 1), (4, 1), (1, 1), (0, 1))
    got = _same(hj, ht, 0)
    x[2:4, 1] = 9.0
    assert np.array_equal(got, x)
    rj, rt = _put(F32, np.arange(5, dtype=np.float32))
    jcapi.set_slice(hj, rj, (0, NONE), (0, NONE), (0, NONE), (1, 0))
    tcapi.set_slice(ht, rt, (0, NONE), (0, NONE), (0, NONE), (1, 0))
    _same(hj, ht, 0)


# -- fft ---------------------------------------------------------------------------


@pytest.mark.parametrize('name,code,n,axis', [
    ('fft', C32, -1, -1), ('fft', C32, 96, -1), ('ifft', C32, -1, 0), ('fft', F32, -1, -1),
    ('rfft', F32, -1, -1), ('rfft', F32, 100, 0), ('irfft', C32, -1, -1), ('ifft', C64, -1, -1),
])
def test_fft_op(name, code, n, axis):
    x = _data(code, (8, 64), 13)
    hj, ht = _put(code, x)
    _same(jcapi.fft_op(name, hj, n, axis), tcapi.fft_op(name, ht, n, axis), 1e-4)


@pytest.mark.parametrize('name', ['fft2', 'ifft2', 'rfft2', 'irfft2'])
def test_fft2_op(name):
    code = F32 if name == 'rfft2' else C32
    x = _data(code, (16, 32), 14)
    hj, ht = _put(code, x)
    _same(jcapi.fft2_op(name, hj, -1, -1, 0, 1), tcapi.fft2_op(name, ht, -1, -1, 0, 1), 1e-4)


@pytest.mark.parametrize('name', ['fftfreq', 'rfftfreq'])
def test_freqs(name):
    _same(*_both(name, 16, 0.25, F32))
    _same(*_both(name, 9, 1.0, F64))


def test_plan_fft():
    assert _both('plan_fft', 1024, C32) == (None, None)


@pytest.mark.parametrize('kind,beta', [('hanning', 0.0), ('hamming', 0.0), ('blackman', 0.0),
                                       ('kaiser', 8.6)])
def test_window(kind, beta):
    _same(*_both('window', kind, 65, beta, F32))


# -- lifecycle and tracing -----------------------------------------------------------


def test_lifecycle():
    hj, ht = _put(F32, np.ones((256,), np.float32))
    assert tcapi.used_mem() >= 1024 and jcapi.used_mem() >= 1024
    # a second init is refused, as the JAX package's
    assert tcapi.ctx_init(2**20, 0) == -1 == jcapi.ctx_init(2**20, 0)
    tcapi.ctx_clear()
    assert tcapi.tensor_shape(ht) == (256,)
    tcapi.tensor_free(ht)
    tcapi.tensor_free(ht)  # freeing twice is a no-op, as the JAX package's
    jcapi.tensor_free(hj)


def test_ctx_init_device_comes_from_the_environment(monkeypatch):
    monkeypatch.setenv('DSC_DEVICE', 'tpu')
    with pytest.raises(RuntimeError, match='DSC_DEVICE'):
        tcapi.ctx_init(2**20, 0)
    saved = tcontext._ctx
    tcontext._ctx = None
    try:
        monkeypatch.delenv('DSC_DEVICE')
        assert tcapi.ctx_init(2**20, 0) == 0
        # the card unless the caller asks for the CPU
        assert tcontext.device().type == 'cuda'
    finally:
        tcontext._ctx = saved


def test_traces(tmp_path):
    path = tmp_path / 'traces.json'
    tcapi.clear_traces()
    tcapi.traces_record(1)
    try:
        hj, ht = _put(F32, np.ones((64,), np.float32))
        tcapi.fft_op('rfft', ht, -1, -1)
    finally:
        tcapi.traces_record(0)
    tcapi.dump_traces(str(path))
    events = json.loads(path.read_text())
    events = events['traceEvents'] if isinstance(events, dict) else events
    assert any(e.get('name') == 'rfft' for e in events)
    tcapi.clear_traces()


# -- the C++ harness through the port's shim --------------------------------------------


def _toolchain_missing():
    if shutil.which('g++') is None:
        return 'g++ not found'
    if shutil.which('python3-config') is None:
        return 'python3-config not found'
    if subprocess.run(['python3-config', '--ldflags', '--embed'], capture_output=True).returncode:
        return 'python3-config --embed failed'
    return None


def test_cpp_harness_on_the_cpu(tmp_path):
    missing = _toolchain_missing()
    if missing:
        pytest.skip(missing)
    from dsc_tpu_torch.cpp import build as cbuild

    harness = cbuild.build(tmp_path)
    rc, out = cbuild.run(harness, 'cpu', timeout=300)
    assert rc == 0, out
    assert 'ALL OK' in out
