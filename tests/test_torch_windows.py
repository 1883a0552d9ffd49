"""The window tier of dsc_tpu_torch (windows.py) against dsc_tpu.windows and
scipy.signal on the same sizes and parameters, its top-level exports, and
the ``Tensor(data, dtype)`` constructor against ``dsc_tpu.Tensor``."""

import gc

import numpy as np
import pytest
import scipy.signal as sps
import scipy.signal.windows as spw

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu import windows as JW  # noqa: E402
from dsc_tpu_torch import windows as W  # noqa: E402


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    # the heap the imports and compiles leave: the gc.collect() after every
    # test (tests/conftest.py) would otherwise rescan it each time
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _close(got, ref, tol=2e-6):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30) if ref.size else 1.0
    assert np.abs(got - ref).max(initial=0.0) <= tol * scale


def _same(got, jax_t):
    """The port's window equals dsc_tpu's in shape, dtype and value."""
    ref = jax_t.numpy()
    out = got.numpy()
    assert out.dtype == ref.dtype
    _close(out, ref)


NUMPY_FAMILY = {
    'hanning': (np.hanning, ()),
    'hamming': (np.hamming, ()),
    'blackman': (np.blackman, ()),
    'bartlett': (np.bartlett, ()),
    'kaiser': (np.kaiser, (8.6,)),
}


@pytest.mark.parametrize('n', [0, 1, 2, 33, 64])
@pytest.mark.parametrize('name', list(NUMPY_FAMILY))
def test_numpy_family(name, n):
    ref_fn, params = NUMPY_FAMILY[name]
    got = getattr(dt, name)(n, *params)
    _same(got, getattr(dsc_tpu, name)(n, *params))
    _close(got.numpy(), ref_fn(n, *params))
    # float64 carries only the float64 rounding of the device formula
    got64 = getattr(dt, name)(n, *params, dtype=dt.Dtype.F64).numpy()
    assert got64.dtype == np.float64
    assert np.abs(got64 - ref_fn(n, *params)).max(initial=0.0) < 1e-13


@pytest.mark.parametrize('alpha', [0.0, 0.3, 1.0])
@pytest.mark.parametrize('n', [1, 2, 33, 64])
def test_tukey(n, alpha):
    got = dt.tukey(n, alpha)
    _same(got, dsc_tpu.tukey(n, alpha))
    _close(got.numpy(), spw.tukey(n, alpha))


def test_window_errors():
    with pytest.raises(RuntimeError, match='real dtype'):
        dt.hanning(8, dtype=dt.Dtype.C32)
    with pytest.raises(RuntimeError, match='alpha'):
        dt.tukey(8, 1.5)


PLAIN = ['flattop', 'blackmanharris', 'nuttall', 'boxcar', 'triang', 'barthann', 'bohman',
         'parzen', 'cosine', 'lanczos', 'hann']


@pytest.mark.parametrize('name', PLAIN)
@pytest.mark.parametrize('n', [2, 63, 64])
def test_plain_windows(name, n):
    for sym in (True, False):
        got = getattr(W, name)(n, sym=sym)
        _same(got, getattr(JW, name)(n, sym=sym))
        _close(got.numpy(), getattr(spw, name)(n, sym=sym))
    got64 = getattr(W, name)(n, sym=True, dtype=dt.Dtype.F64).numpy()
    assert np.abs(got64 - getattr(spw, name)(n, sym=True)).max() < 1e-14


def test_single_sample_and_empty():
    for name in PLAIN:
        assert getattr(W, name)(1).numpy().tolist() == [1.0]
        assert getattr(W, name)(0).shape == (0,)


@pytest.mark.parametrize('n', [32, 65])
def test_parameterized_windows(n):
    cases = [
        ('gaussian', (n, 7.5), {}),
        ('gaussian', (n, 7.5), {'sym': False}),
        ('general_gaussian', (n, 1.5, 7.0), {}),
        ('general_hamming', (n, 0.7), {}),
        ('general_cosine', (n, [0.4, 0.5, 0.1]), {}),
        ('exponential', (n,), {'tau': 9.0}),
        ('exponential', (n,), {'center': 4.0, 'tau': 9.0, 'sym': False}),
        ('taylor', (n, 5, 40.0), {}),
        ('chebwin', (n, 80.0), {}),
        ('chebwin', (n, 80.0), {'sym': False}),
    ]
    for name, args, kw in cases:
        got = getattr(W, name)(*args, **kw)
        _same(got, getattr(JW, name)(*args, **kw))
        _close(got.numpy(), getattr(spw, name)(*args, **kw), tol=4e-6)


def test_kbd_and_dpss():
    _same(W.kaiser_bessel_derived(64, 9.0), JW.kaiser_bessel_derived(64, 9.0))
    with pytest.raises(RuntimeError):
        W.kaiser_bessel_derived(63, 9.0)
    _same(W.dpss(128, 3.0), JW.dpss(128, 3.0))
    got = W.dpss(128, 3.0, 4, dtype=dt.Dtype.F64).numpy()
    assert got.shape == (4, 128)
    _close(got, spw.dpss(128, 3.0, 4), tol=1e-7)


GET_SPECS = ['hann', 'hamming', 'blackman', 'flattop', 'boxcar', 'triang', 'blackmanharris',
             'nuttall', 'barthann', 'bohman', 'parzen', 'cosine', 'lanczos', 'bartlett',
             ('kaiser', 8.6), ('gaussian', 7.0), ('tukey', 0.33), ('chebwin', 90.0),
             ('exponential', None, 12.0), ('general hamming', 0.62), 4.2]


@pytest.mark.parametrize('spec', GET_SPECS, ids=str)
@pytest.mark.parametrize('fftbins', [True, False])
def test_get_window(spec, fftbins):
    got = dt.get_window(spec, 64, fftbins=fftbins)
    _same(got, dsc_tpu.get_window(spec, 64, fftbins=fftbins))
    _close(got.numpy(), sps.get_window(spec, 64, fftbins=fftbins))
    assert np.array_equal(W.design_window(spec, 64, fftbins=fftbins),
                          JW.design_window(spec, 64, fftbins=fftbins))


@pytest.mark.parametrize('spec', ['not_a_window', 'kaiser', ('kbd', 5.0)], ids=str)
def test_get_window_errors(spec):
    with pytest.raises(RuntimeError) as port_err:
        dt.get_window(spec, 32)
    with pytest.raises(RuntimeError) as jax_err:
        dsc_tpu.get_window(spec, 32)
    assert str(port_err.value) == str(jax_err.value)


def test_top_level_exports():
    names = ['compile', 'map', 'windows', 'get_window', 'hanning', 'hamming', 'blackman',
             'kaiser', 'bartlett', 'tukey']
    for name in names:
        assert hasattr(dt, name) and hasattr(dsc_tpu, name), name
        if name != 'windows':
            assert name in dt.__all__
    assert dt.windows is W
    assert dt.get_window is W.get_window


@pytest.mark.parametrize('dtype', [None, 'F32', 'F64', 'C32', 'C64'])
def test_tensor_constructor(dtype):
    x = np.random.default_rng(5).standard_normal((3, 4))
    t = dt.Tensor(x) if dtype is None else dt.Tensor(x, getattr(dt.Dtype, dtype))
    j = (dsc_tpu.Tensor(x) if dtype is None
         else dsc_tpu.Tensor(x, getattr(dsc_tpu.Dtype, dtype)))
    assert t.shape == j.shape and str(t.dtype) == str(j.dtype)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    # copied in: the array is not shared
    x[0, 0] = 7.0
    assert t.numpy()[0, 0] != 7.0


def test_tensor_constructor_view_and_sources():
    base = dt.from_numpy(np.arange(6, dtype=np.float32))
    v = dt.Tensor(base)
    jv = dsc_tpu.Tensor(dsc_tpu.from_numpy(np.arange(6, dtype=np.float32)))
    assert v.shape == jv.shape and v.dtype == dt.Dtype.F32
    v[0] = 9.0  # a view: the write reaches the base
    assert base.numpy()[0] == 9.0
    # a list, a torch tensor, and a dtype given with a Tensor (ignored, as in dsc_tpu)
    np.testing.assert_array_equal(dt.Tensor([1.0, 2.0]).numpy(), dsc_tpu.Tensor([1.0, 2.0]).numpy())
    tt = dt.Tensor(torch.arange(4, dtype=torch.float32), dt.Dtype.F64)
    assert tt.dtype == dt.Dtype.F64 and tt.numpy().tolist() == [0.0, 1.0, 2.0, 3.0]
    assert dt.Tensor(base, dt.Dtype.F64).dtype == dt.Dtype.F32
    with pytest.raises(RuntimeError):
        dt.Tensor(np.arange(4))  # int64 is none of the four dtypes
    with pytest.raises(RuntimeError):
        dt.Tensor(np.zeros((1, 1, 1, 1, 2), np.float32))
