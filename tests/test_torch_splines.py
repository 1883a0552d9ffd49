"""The spline tier of dsc_tpu_torch (models/splines.py) against
dsc_tpu.models and scipy.signal on the same inputs, on the CPU.

- ``symiirorder1`` and ``symiirorder2`` (1-D and batched, the JAX test's
  poles), ``cspline1d`` at lamb 0, 0.1, 1 and 5 (the first-order program and
  the smoothing symiirorder2 cascade), ``qspline1d``: within 1e-6 of the
  largest value of the JAX package's result (float32 results of float64
  scans whose additions run in another order), and within the JAX tests'
  bounds of scipy.signal (tests/test_splines.py: 1e-6, symiirorder2 2e-6);
- ``cspline1d_eval``, ``qspline1d_eval`` and ``gauss_spline`` (host float64
  copies): within 1e-12 of the JAX package;
- ``cspline2d`` (lamb 0, 1/200, 1, 5), ``qspline2d``, ``sepfir2d`` (3 taps,
  kernels as long as the image's sides, a kernel longer than twice a side,
  where the symmetric extension reflects more than once, and two different
  kernels) and ``spline_filter`` on a 33 x 47 image: within 1e-6 of the JAX
  package (sepfir2d with its kernels swapped: ROADMAP F6), and within the
  JAX test's bounds of scipy (the smoothing cases 5e-3 overall and 5e-4
  inside, since scipy truncates the boundary series);
- the caller's input unchanged after each call (a float64 Tensor too,
  which the float64 cast would not copy), and every RuntimeError text equal
  to the JAX package's.
"""

import gc

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402

PORT = 1e-6  # against the JAX package, relative to the largest value
EXACT = 1e-12  # the host float64 copies
IMAGE = (33, 47)


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _sig(shape=200, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _both(name, x, *args, **kw):
    """The port's and the JAX package's ``name`` on the same float32 input,
    as float64 arrays; the port's input is held unchanged."""
    xt = dt.from_numpy(x)
    got = getattr(tm, name)(xt, *args, **kw)
    assert isinstance(got, dt.Tensor) and got.dtype == dt.Dtype.F32
    assert np.array_equal(xt.numpy(), x)
    ref = getattr(jm, name)(dsc_tpu.from_numpy(x), *args, **kw).numpy()
    return got.numpy().astype(np.float64), ref.astype(np.float64)


def _error_text(fn, *args, **kw):
    with pytest.raises(RuntimeError) as info:
        fn(*args, **kw)
    return str(info.value)


# ------------------------------------------------------------ 1-D filters

@pytest.mark.parametrize('shape', [200, (3, 200)], ids=['1-D', 'batched'])
@pytest.mark.parametrize('c0,z1', [(2.0, 0.5), (1.0, -0.268), (0.7, 0.8)])
def test_symiirorder1(c0, z1, shape):
    x = _sig(shape)
    got, ref = _both('symiirorder1', x, c0, z1)
    assert _rel(got, ref) < PORT
    for row, xr in zip(np.atleast_2d(got), np.atleast_2d(x)):
        assert _rel(row, sps.symiirorder1(xr.astype(np.float64), c0, z1)) < 1e-6


@pytest.mark.parametrize('shape', [200, (3, 200)], ids=['1-D', 'batched'])
@pytest.mark.parametrize('r,omega', [(0.5, 0.3), (0.8, 1.2), (0.3, 2.0), (0.284, 1.256)])
def test_symiirorder2(r, omega, shape):
    x = _sig(shape)
    got, ref = _both('symiirorder2', x, r, omega)
    assert _rel(got, ref) < PORT
    for row, xr in zip(np.atleast_2d(got), np.atleast_2d(x)):
        assert _rel(row, sps.symiirorder2(xr.astype(np.float64), r, omega)) < 2e-6


@pytest.mark.parametrize('name,args', [('symiirorder1', (2.0, 0.5)),
                                       ('symiirorder2', (0.8, 1.2))])
def test_symiirorder_precision_argument(name, args):
    """A looser precision shortens the boundary series on both sides."""
    got, ref = _both(name, _sig(), *args, precision=1e-3)
    assert _rel(got, ref) < PORT


@pytest.mark.parametrize('shape', [200, (3, 200)], ids=['1-D', 'batched'])
@pytest.mark.parametrize('lamb', [0.0, 0.1, 1.0, 5.0])
def test_cspline1d(lamb, shape):
    x = _sig(shape)
    got, ref = _both('cspline1d', x, lamb=lamb)
    assert _rel(got, ref) < PORT
    for row, xr in zip(np.atleast_2d(got), np.atleast_2d(x)):
        assert _rel(row, sps.cspline1d(xr.astype(np.float64), lamb=lamb)) < 1e-6


@pytest.mark.parametrize('shape', [200, (3, 200)], ids=['1-D', 'batched'])
def test_qspline1d(shape):
    x = _sig(shape)
    got, ref = _both('qspline1d', x)
    assert _rel(got, ref) < PORT
    for row, xr in zip(np.atleast_2d(got), np.atleast_2d(x)):
        assert _rel(row, sps.qspline1d(xr.astype(np.float64))) < 1e-6


@pytest.mark.parametrize('name,args', [('symiirorder1', (2.0, 0.5)),
                                       ('symiirorder2', (0.8, 1.2)),
                                       ('cspline1d', ()), ('cspline1d', (1.0,)),
                                       ('qspline1d', ())])
def test_float64_input_unchanged(name, args):
    x = _sig().astype(np.float64)
    xt = dt.from_numpy(x)
    out = getattr(tm, name)(xt, *args)
    assert np.array_equal(xt.numpy(), x) and out.dtype == dt.Dtype.F32
    ref = getattr(jm, name)(dsc_tpu.from_numpy(x), *args).numpy()
    assert _rel(out.numpy(), ref) < PORT


# ------------------------------------------------------------- evaluation

NEWX = np.linspace(-5, 210, 500)  # crosses both mirror boundaries


@pytest.mark.parametrize('kind', ['cspline', 'qspline'])
@pytest.mark.parametrize('dx,x0', [(1.0, 0.0), (0.5, -3.0)])
def test_spline_eval_equals_jax(kind, dx, x0):
    x = _sig()
    cj = getattr(sps, f'{kind}1d')(x.astype(np.float64))
    got = getattr(tm, f'{kind}1d_eval')(cj, NEWX, dx=dx, x0=x0)
    ref = getattr(jm, f'{kind}1d_eval')(cj, NEWX, dx=dx, x0=x0)
    assert got.dtype == np.float64 and _rel(got, ref) < EXACT
    if (dx, x0) == (1.0, 0.0):
        assert _rel(got, getattr(sps, f'{kind}1d_eval')(cj, NEWX)) < EXACT
    # Tensor coefficients from the port's own transform
    cjt = getattr(tm, f'{kind}1d')(dt.from_numpy(x))
    got = getattr(tm, f'{kind}1d_eval')(cjt, NEWX, dx=dx, x0=x0)
    ref = getattr(jm, f'{kind}1d_eval')(cjt.numpy(), NEWX, dx=dx, x0=x0)
    assert _rel(got, ref) < EXACT
    if kind == 'cspline' and dx == 1.0 and x0 == 0.0:
        assert np.abs(tm.cspline1d_eval(cjt, np.arange(200.0)) - x).max() < 1e-4


def test_gauss_spline_equals_jax():
    x = np.linspace(-3, 3, 50)
    for n in (1, 3, 5):
        got = tm.gauss_spline(x, n)
        assert _rel(got, jm.gauss_spline(x, n)) < EXACT
        assert np.allclose(got, sps.gauss_spline(x, n))
    xt = dt.from_numpy(x.astype(np.float32))
    assert _rel(tm.gauss_spline(xt, 3), jm.gauss_spline(x.astype(np.float32), 3)) < EXACT


# -------------------------------------------------------------------- 2-D

def _image():
    return np.random.default_rng(4).standard_normal(IMAGE).astype(np.float32)


@pytest.mark.parametrize('lamb', [0.0, 1.0 / 200.0, 1.0, 5.0])
def test_cspline2d(lamb):
    im = _image()
    got, ref = _both('cspline2d', im, lamb)
    assert _rel(got, ref) < PORT
    want = sps.cspline2d(im.astype(np.float64), lamb)
    if lamb <= 1.0 / 144.0:
        assert _rel(got, want) < 1e-5
    else:
        # scipy's C truncates the boundary series at its first small term
        assert _rel(got, want) < 5e-3
        assert np.abs(got - want)[4:-4, 4:-4].max() < 5e-4 * np.abs(want).max()


def test_qspline2d():
    im = _image()
    got, ref = _both('qspline2d', im)
    assert _rel(got, ref) < PORT
    assert _rel(got, sps.qspline2d(im.astype(np.float64))) < 1e-5


HS = {  # (hrow, hcol): along axis 1 (47 samples) and axis 0 (33)
    '3 taps': (np.array([0.25, 0.5, 0.15]), np.array([0.25, 0.5, 0.15])),
    'as long as the sides': (np.hanning(49)[1:-1], np.hanning(35)[1:-1]),
    'hcol longer than twice its side': (np.array([1.0]), np.hanning(99)[1:-1]),
    'two kernels': (np.array([0.25, 0.5, 0.15]), np.array([0.1, 0.2, 0.3, 0.25, 0.15])),
}


def _sepfir2d_numpy(im, hrow, hcol):
    """float64 reference: np.pad(mode='symmetric'), then np.convolve along
    the rows with hrow and along the columns with hcol ('valid')."""
    x = np.pad(im, ((0, 0), (hrow.size // 2,) * 2), mode='symmetric')
    x = np.stack([np.convolve(r, hrow, 'valid') for r in x])
    x = np.pad(x, ((hcol.size // 2,) * 2, (0, 0)), mode='symmetric')
    return np.stack([np.convolve(c, hcol, 'valid') for c in x.T]).T


@pytest.mark.parametrize('case', list(HS))
def test_sepfir2d(case):
    """The port against the JAX package with the kernels swapped (F6: the
    JAX package convolves the rows with hcol and the columns with hrow),
    against a NumPy float64 reference, and against scipy where scipy reads
    no further than the image (kernels shorter than its sides)."""
    im = _image()
    hrow, hcol = HS[case]
    xt = dt.from_numpy(im)
    got = tm.sepfir2d(xt, hrow, hcol)
    assert got.dtype == dt.Dtype.F32 and np.array_equal(xt.numpy(), im)
    got = got.numpy().astype(np.float64)
    assert _rel(got, jm.sepfir2d(dsc_tpu.from_numpy(im), hcol, hrow).numpy()) < PORT
    assert _rel(got, _sepfir2d_numpy(im.astype(np.float64), hrow, hcol)) < 1e-6
    if case in ('3 taps', 'two kernels'):
        want = sps.sepfir2d(im.astype(np.float64), hrow, hcol)
        assert _rel(got, want) < 1e-5
    if case == 'two kernels':
        jax = jm.sepfir2d(dsc_tpu.from_numpy(im), hrow, hcol).numpy()
        assert _rel(jax, want) > 1e-2


def test_pad_symmetric_equals_numpy():
    from dsc_tpu_torch.models.splines import _pad_symmetric

    x = np.arange(15.0).reshape(3, 5)
    for p in (0, 1, 3, 5, 6, 11, 23):
        for dim in (0, 1):
            widths = [(p, p) if d == dim else (0, 0) for d in range(2)]
            got = _pad_symmetric(torch.from_numpy(x), p, dim).numpy()
            assert np.array_equal(got, np.pad(x, widths, mode='symmetric')), (p, dim)


def test_spline_filter():
    im = _image()
    got, ref = _both('spline_filter', im, 5.0)
    assert _rel(got, ref) < PORT
    assert _rel(got, sps.spline_filter(im.astype(np.float64), 5.0)) < 5e-3


def test_2d_float64_input_unchanged():
    im = _image().astype(np.float64)
    t = dt.from_numpy(im)
    for fn in (lambda: tm.cspline2d(t, 1.0), lambda: tm.qspline2d(t),
               lambda: tm.sepfir2d(t, [1.0, 2.0, 1.0], [0.5]), lambda: tm.spline_filter(t)):
        assert fn().dtype == dt.Dtype.F32
        assert np.array_equal(t.numpy(), im)


# ----------------------------------------------------------------- errors

def _errors(m, mk):
    x = mk(_sig())
    return {
        'symiirorder1 series does not converge': lambda: m.symiirorder1(x, 0.7, 0.9),
        'symiirorder1 |z1| >= 1': lambda: m.symiirorder1(x, 1.0, 1.5),
        'symiirorder1 complex': lambda: m.symiirorder1(
            mk(np.ones(8, np.complex64)), 1.0, 0.5),
        'symiirorder1 3-D': lambda: m.symiirorder1(mk(np.ones((2, 2, 8), np.float32)), 1.0, 0.5),
        'symiirorder2 r >= 1': lambda: m.symiirorder2(x, 1.0, 0.5),
        'symiirorder2 too short': lambda: m.symiirorder2(mk(np.ones(3, np.float32)), 0.5, 0.5),
        'symiirorder2 3-D': lambda: m.symiirorder2(mk(np.ones((2, 2, 8), np.float32)), 0.5, 0.5),
        'cspline1d lamb below 1/144': lambda: m.cspline1d(x, lamb=1e-4),
        'cspline1d complex': lambda: m.cspline1d(mk(np.ones(8, np.complex64))),
        'qspline1d lamb': lambda: m.qspline1d(x, lamb=1.0),
        'qspline1d 3-D': lambda: m.qspline1d(mk(np.ones((2, 2, 8), np.float32))),
        'cspline2d 1-D': lambda: m.cspline2d(x),
        'qspline2d lamb': lambda: m.qspline2d(mk(_image()), lamb=1.0),
        'qspline2d 1-D': lambda: m.qspline2d(x),
        'sepfir2d even hrow': lambda: m.sepfir2d(mk(_image()), np.ones(4), [1.0]),
        'sepfir2d even hcol': lambda: m.sepfir2d(mk(_image()), [1.0], np.ones(2)),
        'sepfir2d 2-D kernel': lambda: m.sepfir2d(mk(_image()), np.ones((3, 3)), [1.0]),
        'sepfir2d 1-D input': lambda: m.sepfir2d(x, [1.0], [1.0]),
        'cspline1d_eval empty': lambda: m.cspline1d_eval(np.zeros(0), NEWX),
        'qspline1d_eval 2-D': lambda: m.qspline1d_eval(np.ones((2, 2)), NEWX),
    }


@pytest.mark.parametrize('case', list(_errors(tm, np.asarray)))
def test_error_texts_equal_jax(case):
    got = _error_text(_errors(tm, dt.from_numpy)[case])
    assert got == _error_text(_errors(jm, dsc_tpu.from_numpy)[case])
