"""The public op set of dsc_tpu_torch against dsc_tpu on the same inputs
(dsc_tpu/tensor.py, dsc_tpu/ops/kernels.py): unary ops with the complex
branch cuts, pow, clip, the reductions, cast/concat/transpose,
``__setitem__``, write-through views and the creation set, across the four
dtypes. Shape and dtype are asserted before values (atol = rtol = 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch.ops import stream_map as sm  # noqa: E402

NP_DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
DT = {np.float32: dt.Dtype.F32, np.float64: dt.Dtype.F64,
      np.complex64: dt.Dtype.C32, np.complex128: dt.Dtype.C64}
JDT = {np.float32: dsc_tpu.Dtype.F32, np.float64: dsc_tpu.Dtype.F64,
       np.complex64: dsc_tpu.Dtype.C32, np.complex128: dsc_tpu.Dtype.C64}
# complex values on the branch cuts: negative reals with +0 and -0
# imaginary parts, the imaginary axis, zero
CUTS = np.array([-2 + 0j, complex(-2, -0.0), 3j, -3j, 1 + 0j, complex(-0.5, -0.0),
                 0j, complex(-1e-3, -0.0)])


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


def _rand(shape, dtype, seed, positive=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == 'c':
        x = x + 1j * rng.standard_normal(shape)
        flat = x.reshape(-1)
        k = min(flat.size, len(CUTS))
        flat[:k] = CUTS[:k]
    elif positive:
        x = np.abs(x) + 0.1
    return x.astype(dtype)


def _same(got, ref, eps=1e-5):
    got = got.numpy() if hasattr(got, 'numpy') else np.asarray(got)
    ref = ref.numpy() if hasattr(ref, 'numpy') else np.asarray(ref)
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, atol=eps, rtol=eps)


def _both(x):
    return dt.from_numpy(x), dsc_tpu.from_numpy(x)


UNARY = ['cos', 'sin', 'sinc', 'logn', 'log2', 'log10', 'exp', 'sqrt',
         'absolute', 'angle', 'conj', 'real', 'imag']


@pytest.mark.parametrize('dtype', NP_DTYPES)
@pytest.mark.parametrize('name', UNARY)
def test_unary(name, dtype):
    x = _rand((4, 33), dtype, 1, positive=name in ('logn', 'log2', 'log10', 'sqrt'))
    t, j = _both(x)
    _same(getattr(dt, name)(t), getattr(dsc_tpu, name)(j))


@pytest.mark.parametrize('name', ['logn', 'sqrt', 'log10'])
def test_complex_branch_cuts_match_numpy(name):
    t = dt.from_numpy(CUTS.astype(np.complex64))
    ref = {'logn': np.log, 'sqrt': np.sqrt, 'log10': np.log10}[name](CUTS)
    got = getattr(dt, name)(t).numpy()
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite].astype(np.complex64), atol=1e-5,
                               rtol=1e-5)
    assert np.array_equal(np.signbit(got.imag), np.signbit(ref.imag))


def test_unary_out_and_i0():
    x = _rand((3, 8), np.float32, 2)
    t, j = _both(x)
    out = dt.zeros((3, 8))
    res = dt.exp(t, out=out)
    _same(out, dsc_tpu.exp(j))
    _same(res, out)
    _same(dt.i0(t), dsc_tpu.i0(j))
    _same(dt.i0(t.cast(dt.Dtype.F64)), dsc_tpu.i0(j.cast(dsc_tpu.Dtype.F64)))
    _same(dt.i0(1.5), dsc_tpu.i0(1.5))
    with pytest.raises(RuntimeError):
        dt.i0(dt.from_numpy(_rand(4, np.complex64, 3)))


@pytest.mark.parametrize('dtype', NP_DTYPES)
def test_pow(dtype):
    a = _rand((5, 9), dtype, 4, positive=True)
    b = _rand((5, 9), dtype, 5)
    if np.dtype(dtype).kind == 'c':
        a.reshape(-1)[:3] = 0     # zero bases: 0^b = 0, 0^0 = 1
        b.reshape(-1)[1] = 0
    (ta, ja), (tb, jb) = _both(a), _both(b)
    _same(dt.power(ta, tb), dsc_tpu.power(ja, jb))
    _same(ta ** 2, ja ** 2)
    _same(2 ** tb, 2 ** jb)
    _same(ta ** 0.5, ja ** 0.5)


@pytest.mark.parametrize('dtype', NP_DTYPES)
@pytest.mark.parametrize('bounds', [(-0.5, 0.75), (None, 0.25), (-0.25, None)])
def test_clip(dtype, bounds):
    x = _rand((6, 7), dtype, 6)
    t, j = _both(x)
    _same(dt.clip(t, *bounds), dsc_tpu.clip(j, *bounds))


REDUCE = ['sum', 'mean', 'max', 'min']


@pytest.mark.parametrize('dtype', NP_DTYPES)
@pytest.mark.parametrize('name', REDUCE)
@pytest.mark.parametrize('axis,keepdims', [(-1, True), (0, False), (1, True), (2, False)])
def test_reductions(name, dtype, axis, keepdims):
    x = _rand((3, 4, 5), dtype, 7)
    if np.dtype(dtype).kind == 'c':
        x[0, 1, :3] = x[0, 1, 0].real + 1j * np.array([1.0, -2.0, 3.0])  # real ties
    t, j = _both(x)
    got = getattr(dt, name)(t, axis=axis, keepdims=keepdims)
    _same(got, getattr(dsc_tpu, name)(j, axis=axis, keepdims=keepdims))


@pytest.mark.parametrize('name', REDUCE)
def test_reduction_defaults_and_1d(name):
    x = _rand((6, 10), np.float32, 8)
    t, j = _both(x)
    got = getattr(dt, name)(t)
    assert got.shape == (6, 1)
    _same(got, getattr(dsc_tpu, name)(j))
    v = _rand((10,), np.float32, 9)
    got = getattr(dt, name)(dt.from_numpy(v), keepdims=False)
    assert got.shape == (1,)
    _same(got, getattr(dsc_tpu, name)(dsc_tpu.from_numpy(v), keepdims=False))
    with pytest.raises(RuntimeError):
        getattr(dt, name)(t, axis=2)


@pytest.mark.parametrize('src', NP_DTYPES)
@pytest.mark.parametrize('dst', NP_DTYPES)
def test_cast(src, dst):
    x = _rand((3, 5), src, 10)
    t, j = _both(x)
    got = dt.cast(t, DT[dst])
    _same(got, dsc_tpu.cast(j, JDT[dst]))
    if src == dst:  # a view of the input
        got[0, 0] = 7
        assert t[0, 0] == 7


@pytest.mark.parametrize('axis', [0, 1, -1, None])
def test_concat(axis):
    xs = [_rand((2, 3), np.float32, 11), _rand((2, 3), np.float64, 12),
          _rand((2, 3), np.complex64, 13)]
    got = dt.concat([dt.from_numpy(x) for x in xs], axis=axis)
    _same(got, dsc_tpu.concat([dsc_tpu.from_numpy(x) for x in xs], axis=axis))
    with pytest.raises(RuntimeError):
        dt.concat([])


@pytest.mark.parametrize('axes', [None, (1, 0, 2), (2, 0, 1), (-1, -2, -3)])
def test_transpose(axes):
    x = _rand((2, 3, 4), np.complex64, 14)
    t, j = _both(x)
    _same(dt.transpose(t, axes), dsc_tpu.transpose(j, axes))
    _same(t.transpose(axes), j.transpose(axes))
    with pytest.raises(RuntimeError):
        dt.transpose(t, (0, 0, 1))


SET_CASES = [
    ((slice(None),), 'same'),
    ((1,), 'row'),
    ((slice(None), 2), 'col'),
    ((slice(None, None, -2), slice(1, 5)), 'cycle'),
    ((slice(4, 0, -1), slice(None, None, -3)), 'cycle'),
    ((2, 3), 'scalar'),
    ((slice(1, 3),), 'tensor'),
    ((slice(None), slice(None, None, -1)), 'self'),
]


@pytest.mark.parametrize('dtype', NP_DTYPES)
@pytest.mark.parametrize('key,value', SET_CASES)
def test_setitem(dtype, key, value):
    x = _rand((5, 6), dtype, 15)
    t, j = _both(x)
    region = np.empty((5, 6))[key].shape
    if value == 'same':
        v = _rand(region, np.float64, 16)
    elif value in ('row', 'col'):
        v = _rand(region[-1:], np.complex128, 17)
    elif value == 'cycle':
        v = _rand((3,), np.float32, 18)   # does not broadcast: cycled
    elif value == 'scalar':
        v = 2.5
    elif value == 'tensor':
        v = None
        t[key], j[key] = dt.from_numpy(_rand((6,), dtype, 19)), \
            dsc_tpu.from_numpy(_rand((6,), dtype, 19))
    else:
        v = None
        t[key], j[key] = t, j
    if v is not None:
        t[key] = v
        j[key] = v
    _same(t, j)


def test_write_through_views():
    x = _rand((4, 6), np.float32, 20)
    t, j = _both(x)
    flat, jflat = t.reshape(24), j.reshape(24)
    v, jv = dt.view(t), dsc_tpu.view(j)
    c, r = dt.conj(t), dt.real(t)
    flat[3:7] = 1.5
    jflat[3:7] = 1.5
    v[3] = -2.0
    jv[3] = -2.0
    for view in (t, flat, v, c, r):
        _same(view.reshape(4, 6), j)
    out = dt.zeros((4, 6))
    alias = out.reshape(2, 12)
    dt.add(t, 1.0, out=out)
    _same(alias, dsc_tpu.add(j, 1.0).reshape(2, 12))
    _same(dt.imag(t), dsc_tpu.imag(j))


@pytest.mark.parametrize('dtype', NP_DTYPES)
def test_creation(dtype):
    d, jd = DT[dtype], JDT[dtype]
    _same(dt.arange(17, dtype=d), dsc_tpu.arange(17, dtype=jd))
    _same(dt.full((2, 3), 1.5, dtype=d), dsc_tpu.full((2, 3), 1.5, dtype=jd))
    _same(dt.full(4, 2, dtype=d), dsc_tpu.full(4, 2, dtype=jd))
    for name in ('ones', 'zeros', 'empty'):
        _same(getattr(dt, name)((3, 2), dtype=d), getattr(dsc_tpu, name)((3, 2), dtype=jd))
    x = _rand((2, 5), dtype, 21)
    t, j = _both(x)
    for name in ('ones_like', 'zeros_like', 'empty_like'):
        _same(getattr(dt, name)(t), getattr(dsc_tpu, name)(j))
        _same(getattr(dt, name)(x), getattr(dsc_tpu, name)(x))
    _same(dt.full_like(t, 3, dtype=dt.Dtype.F64), dsc_tpu.full_like(j, 3, dtype=dsc_tpu.Dtype.F64))
    with pytest.raises(RuntimeError):
        dt.zeros((1, 1, 1, 1, 1))


def test_tensor_text_and_bytes():
    x = _rand((2, 3), np.float64, 22)
    t, j = _both(x)
    assert str(t) == str(j)
    assert bytes(t) == bytes(j) == t.tobytes()


def test_public_ops_on_the_k5_route(monkeypatch):
    """With MIN_ELEMS lowered, the eligible public ops run stream_map's
    plain version and still agree with dsc_tpu."""
    monkeypatch.setattr(sm, 'MIN_ELEMS', 1024)
    calls = []
    plain = sm.stream_map_plain
    monkeypatch.setattr(sm, 'stream_map_plain',
                        lambda body, *ops: calls.append(body) or plain(body, *ops))
    a, b = _rand((8, 256), np.float32, 23), _rand((8, 256), np.float32, 24)
    z = _rand((2048,), np.complex64, 25)
    (ta, ja), (tb, jb), (tz, jz) = _both(a), _both(b), _both(z)
    _same(ta + tb, ja + jb)
    _same(ta * 0.5, ja * 0.5)
    _same(ta - tb[0, 0], ja - jb[0, 0])            # a Python float from indexing
    _same(ta / dt.from_numpy(b[0]), ja / jb[0])    # a broadcast row
    for name in ('sin', 'cos', 'exp', 'sinc'):
        _same(getattr(dt, name)(ta), getattr(dsc_tpu, name)(ja))
    _same(dt.sqrt(dt.absolute(ta)), dsc_tpu.sqrt(dsc_tpu.absolute(ja)))
    _same(dt.clip(ta, -0.5, 0.5), dsc_tpu.clip(ja, -0.5, 0.5))
    _same(tz * tz, jz * jz)
    _same(tz / (1 - 2j), jz / (1 - 2j))
    _same(ta ** 2, ja ** 2)                        # pow never streams
    _same(ta.cast(dt.Dtype.F64) + 1.0, ja.cast(dsc_tpu.Dtype.F64) + 1.0)
    assert calls == ['add', 'mul', 'sub', 'div', 'sin', 'cos', 'exp', 'sinc', 'sqrt',
                     'clip', 'mul', 'div']
