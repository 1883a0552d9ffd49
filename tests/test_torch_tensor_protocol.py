"""NumPy's protocols on the port's Tensor, where the JAX package's Tensor
has none (ROADMAP F7), on the CPU.

- ``np.asarray(t)`` equals ``t.numpy()`` for 1-D and 2-D tensors of the four
  dtypes; a ``dtype`` casts; ``copy=False`` raises, since the values cross
  to the host; inside ``dsc.compile`` it raises as ``t.numpy()`` does.
- An index past an axis raises ``TensorIndexError``: a RuntimeError with the
  JAX package's text, and an IndexError, so ``list(t)`` and ``iter(t)`` end
  after ``len(t)`` elements.
- NumPy's operators and ufuncs defer to the Tensor's: ``ndarray + t`` and
  ``np.float32(2) * t`` are Tensors.
- Models that take array-likes take Tensors: ``sepfir2d`` with Tensor
  kernels, ``cspline1d_eval`` at Tensor points.
- In each case the JAX package's Tensor still raises its out-of-bounds
  RuntimeError.
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402
from dsc_tpu_torch.tensor import TensorIndexError  # noqa: E402

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _values(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _reference_raises(fn):
    with pytest.raises(RuntimeError, match='out of bounds'):
        fn()


@pytest.mark.parametrize('shape', [(3,), (5, 4)], ids=['1-D', '2-D'])
@pytest.mark.parametrize('dtype', DTYPES, ids=lambda d: d.__name__)
def test_asarray_is_numpy(dtype, shape):
    x = _values(shape, dtype)
    t = dt.from_numpy(x)
    arr = np.asarray(t)
    assert isinstance(arr, np.ndarray) and arr.dtype == x.dtype
    assert np.array_equal(arr, t.numpy()) and np.array_equal(arr, x)
    assert np.asarray(t, dtype=np.complex128).dtype == np.complex128
    assert np.array_equal(np.array(t), x)
    _reference_raises(lambda: np.asarray(dsc_tpu.from_numpy(x)))


def test_asarray_without_a_copy_raises():
    with pytest.raises(ValueError):
        np.asarray(dt.from_numpy(_values(3, np.float32)), copy=False)


@pytest.mark.parametrize('shape', [(3,), (5, 4), (1,)], ids=['1-D', '2-D', 'one'])
@pytest.mark.parametrize('dtype', DTYPES, ids=lambda d: d.__name__)
def test_list_and_iter_end(dtype, shape):
    x = _values(shape, dtype)
    t = dt.from_numpy(x)
    items = list(t)
    assert len(items) == len(t) == shape[0]
    for item, row in zip(items, x):
        got = item.numpy() if isinstance(item, dt.Tensor) else np.asarray(item)
        assert np.array_equal(got, row)
    assert sum(1 for _ in iter(t)) == len(t)
    _reference_raises(lambda: list(dsc_tpu.from_numpy(x)))


@pytest.mark.parametrize('key', [3, -4, (0, 7), (9, slice(None))], ids=str)
def test_index_past_an_axis(key):
    x = _values((3, 7) if isinstance(key, tuple) else 3, np.float32)
    t, tj = dt.from_numpy(x), dsc_tpu.from_numpy(x)
    with pytest.raises(TensorIndexError) as info:
        t[key]
    assert isinstance(info.value, IndexError) and isinstance(info.value, RuntimeError)
    with pytest.raises(RuntimeError) as ref:
        tj[key]
    assert str(info.value) == str(ref.value)
    with pytest.raises(TensorIndexError):
        t[key] = 1.0


def test_numpy_operators_defer_to_the_tensor():
    x = _values(4, np.float32)
    a = _values(4, np.float32, seed=1)
    t = dt.from_numpy(x)
    for got, want in ((a + t, t + a), (a * t, t * a), (np.float32(2) * t, t * 2.0),
                      (np.float64(3) - t, 3.0 - t), (a / t, dt.from_numpy(a) / t)):
        assert isinstance(got, dt.Tensor)
        assert np.array_equal(got.numpy(), want.numpy())
    with pytest.raises(TypeError):
        np.sin(t)
    _reference_raises(lambda: a + dsc_tpu.from_numpy(x))


def test_asarray_inside_compile_raises():
    compiled = dt.compile(lambda s: dt.from_numpy(np.asarray(s) * 2.0))
    with pytest.raises(RuntimeError, match='concrete value'):
        compiled(dt.from_numpy(_values(4, np.float32)))


def test_sepfir2d_with_tensor_kernels():
    im = _values((33, 47), np.float32, seed=2)
    hrow = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16
    hcol = np.array([-1.0, 2.0, 5.0, 2.0, -1.0]) / 7
    want = tm.sepfir2d(dt.from_numpy(im), hrow, hcol).numpy()
    got = tm.sepfir2d(dt.from_numpy(im), dt.from_numpy(hrow), dt.from_numpy(hcol)).numpy()
    assert np.array_equal(got, want)
    _reference_raises(lambda: jm.sepfir2d(dsc_tpu.from_numpy(im), dsc_tpu.from_numpy(hrow),
                                          dsc_tpu.from_numpy(hcol)))


def test_cspline1d_eval_at_tensor_points():
    c = tm.cspline1d(dt.from_numpy(_values(64, np.float32, seed=3)))
    newx = np.linspace(-3.0, 70.0, 101)
    want = tm.cspline1d_eval(c, newx)
    assert np.array_equal(tm.cspline1d_eval(c, dt.from_numpy(newx)), want)
    cj = jm.cspline1d(dsc_tpu.from_numpy(_values(64, np.float32, seed=3)))
    _reference_raises(lambda: jm.cspline1d_eval(cj, dsc_tpu.from_numpy(newx)))
