"""dsc_tpu_torch Tensor subset against dsc_tpu on the same inputs
(dsc_tpu/tensor.py): round trips, binary arithmetic with the reference
promotion and scalar rules, basic slicing."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402

NP_DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
OPS = ['add', 'sub', 'mul', 'true_div']


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == 'c':
        x = x + 1j * rng.standard_normal(shape)
    # keep divisors away from 0
    return (x + np.sign(x.real) * 0.5).astype(dtype)


def _same(got: np.ndarray, ref: np.ndarray, eps=1e-5):
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype
    assert np.allclose(got, ref, atol=eps, rtol=eps)


@pytest.mark.parametrize('dtype', NP_DTYPES)
def test_numpy_round_trip(dtype):
    x = _rand((3, 5), dtype, 0)
    t = dt.from_numpy(x)
    assert t.shape == (3, 5) and t.n_dim == 2 and t.ne == 15
    assert t.dtype.name == dsc_tpu.from_numpy(x).dtype.name
    back = t.numpy()
    assert back.dtype == x.dtype
    np.testing.assert_array_equal(back, x)
    back[0, 0] = 7  # a copy, not a view of the tensor
    assert t.numpy()[0, 0] != 7


@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('dtype', NP_DTYPES)
def test_binary_same_dtype(op, dtype):
    a, b = _rand((4, 33), dtype, 1), _rand((4, 33), dtype, 2)
    got = getattr(dt, op)(dt.from_numpy(a), dt.from_numpy(b)).numpy()
    ref = getattr(dsc_tpu, op)(dsc_tpu.from_numpy(a), dsc_tpu.from_numpy(b)).numpy()
    _same(got, ref)


PROMOTIONS = [(np.float32, np.float64), (np.float64, np.complex64),
              (np.float32, np.complex128), (np.complex64, np.complex128)]


@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('da,db', PROMOTIONS)
def test_binary_promotion(op, da, db):
    a, b = _rand((17,), da, 3), _rand((17,), db, 4)
    got = getattr(dt, op)(dt.from_numpy(a), dt.from_numpy(b)).numpy()
    ref = getattr(dsc_tpu, op)(dsc_tpu.from_numpy(a), dsc_tpu.from_numpy(b)).numpy()
    _same(got, ref)


@pytest.mark.parametrize('scalar', [2.5, 3, -1.5 + 0.25j])
@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.complex64])
def test_scalar_operands(scalar, dtype):
    a = _rand((9,), dtype, 5)
    ta, ja = dt.from_numpy(a), dsc_tpu.from_numpy(a)
    for got, ref in ((ta * scalar, ja * scalar), (scalar - ta, scalar - ja),
                     (ta / scalar, ja / scalar), (scalar + ta, scalar + ja)):
        _same(got.numpy(), ref.numpy())


@pytest.mark.parametrize('op', OPS)
def test_broadcast_operands(op):
    a, b = _rand((5, 1, 8), np.float32, 6), _rand((3, 1), np.complex64, 7)
    got = getattr(dt, op)(dt.from_numpy(a), dt.from_numpy(b)).numpy()
    ref = getattr(dsc_tpu, op)(dsc_tpu.from_numpy(a), dsc_tpu.from_numpy(b)).numpy()
    _same(got, ref)
    with pytest.raises(RuntimeError):
        getattr(dt, op)(dt.from_numpy(a), dt.from_numpy(np.ones((4, 2), np.float32)))


def test_crop_slice_and_scalar_unwrap():
    x = _rand((1000,), np.float32, 8)
    t, j = dt.from_numpy(x), dsc_tpu.from_numpy(x)
    _same(t[: 1000 - 37].numpy(), j[: 1000 - 37].numpy())
    _same(t[10:500:3].numpy(), j[10:500:3].numpy())
    _same(t[::-2].numpy(), x[::-2])
    assert t[-1] == j[-1] and isinstance(t[-1], float)
    assert t[3:4] == float(x[3])
    m = dt.from_numpy(_rand((6, 7), np.complex64, 9))
    _same(m[:, 2:5].numpy(), m.numpy()[:, 2:5])
    _same(m[4].numpy(), m.numpy()[4])
    assert isinstance(m[1, 2], complex)
    with pytest.raises(RuntimeError):
        m[6]
