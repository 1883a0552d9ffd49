"""The LTI conversions of dsc_tpu_torch (models/lti.py, host float64) against
dsc_tpu.models and scipy.signal on the same inputs: every name the port
exports from lti.py (BadCoefficients, bilinear, deconvolve, normalize,
sos2zpk, tf2zpk, unit_impulse, zpk2sos, zpk2tf). The port's module is a
copy of the JAX package's host code, so each result equals the JAX
package's exactly; against scipy, the bounds of tests/test_lti.py."""

import gc
import importlib
import warnings

import numpy as np
import pytest
import scipy.signal as sps

import dsc_tpu.models as jm
import dsc_tpu_torch.models as tm

# the package's name ``lti`` is the factory of models/ltisys.py, as in the JAX
# package: the module is reached by its import path
tlti = importlib.import_module('dsc_tpu_torch.models.lti')


@pytest.fixture(scope='module', autouse=True)
def frozen_heap():
    # the heap the imports leave: the gc.collect() after every test
    # (tests/conftest.py) would otherwise rescan it each time
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()


def _resp(sos, w):
    z = np.exp(1j * w)
    h = np.ones_like(z, complex)
    for r in np.atleast_2d(sos):
        h *= (r[0] + r[1] / z + r[2] / z ** 2) / (r[3] + r[4] / z + r[5] / z ** 2)
    return h


def _equal(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == r.dtype and np.array_equal(g, r), (g, r)


def _quiet(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return fn(*args)


TF_CASES = [([0.0, 2.0, 4.0, 2.0], [2.0, 1.0, 0.5, 0.25]),
            (list(sps.butter(5, 0.3)[0]), list(sps.butter(5, 0.3)[1])),
            ([1.0, -0.5], [1.0, 0.3, 0.2]), ([3.0], [1.0, 0.5])]


@pytest.mark.parametrize('b,a', TF_CASES)
def test_normalize_and_tf2zpk(b, a):
    _equal(_quiet(tm.normalize, b, a), _quiet(jm.normalize, b, a))
    bn, an = _quiet(tm.normalize, b, a)
    bs, as_ = _quiet(sps.normalize, b, a)
    assert np.allclose(bn, bs) and np.allclose(an, as_)
    z1, p1, k1 = _quiet(tm.tf2zpk, b, a)
    _equal((z1, p1, k1), _quiet(jm.tf2zpk, b, a))
    z2, p2, k2 = _quiet(sps.tf2zpk, b, a)
    assert np.allclose(np.sort_complex(z1), np.sort_complex(z2))
    assert np.allclose(np.sort_complex(p1), np.sort_complex(p2))
    assert abs(k1 - k2) < 1e-14 * max(1.0, abs(k2))


@pytest.mark.parametrize('design', [(5, 0.3, 'low'), (4, [0.2, 0.5], 'bandpass'),
                                    (3, 0.4, 'high')])
def test_zpk2tf_roundtrip(design):
    z, p, k = sps.butter(*design, output='zpk')
    b1, a1 = tm.zpk2tf(z, p, k)
    _equal((b1, a1), jm.zpk2tf(z, p, k))
    b2, a2 = sps.zpk2tf(z, p, k)
    assert b1.dtype == np.float64  # conjugate-symmetric -> real coefficients
    assert np.allclose(b1, b2) and np.allclose(a1, a2)
    z1, p1, k1 = tm.tf2zpk(b1, a1)
    assert np.allclose(np.sort_complex(p1), np.sort_complex(p)) and abs(k1 - k) < 1e-12


def test_zpk2tf_keeps_complex_coefficients():
    z, p, k = [1j], [0.5], 2.0
    _equal(tm.zpk2tf(z, p, k), jm.zpk2tf(z, p, k))
    b, _ = tm.zpk2tf(z, p, k)
    assert np.iscomplexobj(b) and np.allclose(b, sps.zpk2tf(z, p, k)[0])


@pytest.mark.parametrize('order,wn,btype', [(5, 0.3, 'low'), (4, [0.2, 0.5], 'bandpass'),
                                            (6, 0.25, 'high')])
def test_sos2zpk_and_zpk2sos(order, wn, btype):
    sos = sps.butter(order, wn, btype, output='sos')
    z1, p1, k1 = tm.sos2zpk(sos)
    _equal((z1, p1, k1), jm.sos2zpk(sos))
    z2, p2, k2 = sps.sos2zpk(sos)
    assert np.allclose(np.sort_complex(z1), np.sort_complex(z2))
    assert np.allclose(np.sort_complex(p1), np.sort_complex(p2))
    assert abs(k1 - k2) < 1e-14
    z, p, k = sps.butter(order, wn, btype, output='zpk')
    got = tm.zpk2sos(z, p, k)
    _equal(got, jm.zpk2sos(z, p, k))
    w = np.linspace(1e-3, np.pi - 1e-3, 1024)
    assert np.abs(_resp(got, w) - _resp(sps.zpk2sos(z, p, k), w)).max() < 1e-12
    # an odd order's first-order section leaves a trailing zero in b and a
    b1, a1 = (np.trim_zeros(v, 'b') for v in tm.sos2tf(got))
    b2, a2 = sps.zpk2tf(z, p, k)
    assert np.allclose(b1, b2, atol=1e-12) and np.allclose(a1, a2, atol=1e-12)


@pytest.mark.parametrize('ba,aa,fs', [([1.0, 2.0], [1.0, 1.5, 3.0], 10.0),
                                      ([0.5], [1.0, 0.2], 2.0),
                                      ([1.0, 0.0, 4.0], [1.0, 0.1, 9.0], 5.0)])
def test_bilinear(ba, aa, fs):
    got = tm.bilinear(ba, aa, fs=fs)
    _equal(got, jm.bilinear(ba, aa, fs=fs))
    ref = sps.bilinear(ba, aa, fs=fs)
    assert np.allclose(got[0], ref[0], atol=1e-14) and np.allclose(got[1], ref[1], atol=1e-14)


@pytest.mark.parametrize('signal,divisor', [
    (np.random.default_rng(0).standard_normal(50), [1.0, 0.5, -0.2]),
    ([1.0, 2.0], [1.0, 0.0, 0.0]), ([2.0, 3.0, 1.0], [2.0, 1.0])])
def test_deconvolve(signal, divisor):
    q1, r1 = tm.deconvolve(signal, divisor)
    _equal((q1, r1), jm.deconvolve(signal, divisor))
    q2, r2 = sps.deconvolve(signal, divisor)
    if len(signal) >= len(divisor):
        assert np.allclose(q1, q2) and np.allclose(r1, r2, atol=1e-12)
    else:  # a zero quotient and the signal as the remainder (scipy: an empty quotient)
        assert np.allclose(q1, [0.0]) and np.allclose(r1, signal)
    assert np.allclose(np.convolve(divisor, q1)[:len(signal)] + r1, signal, atol=1e-10)


@pytest.mark.parametrize('args', [(7,), (7, 'mid'), ((3, 3), (1, 2)), (5, 2), ((4, 6), 'mid'),
                                  ((2, 5), 1)])
def test_unit_impulse(args):
    _equal(tm.unit_impulse(*args), jm.unit_impulse(*args))
    assert np.array_equal(tm.unit_impulse(*args), sps.unit_impulse(*args))


def test_unit_impulse_dtype():
    got = tm.unit_impulse(4, 1, dtype=np.float32)
    assert got.dtype == np.float32 and np.array_equal(got, jm.unit_impulse(4, 1, np.float32))


def test_bad_coefficients_warning():
    assert issubclass(tm.BadCoefficients, UserWarning) and tm.BadCoefficients is not \
        jm.BadCoefficients
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        b, a = tm.normalize([0.0, 1.0], [2.0, 0.5])
    assert any(issubclass(r.category, tlti.BadCoefficients) for r in rec)
    assert np.allclose(b, [0.5]) and np.allclose(a, [1.0, 0.25])
    # an all-zero numerator keeps one (zero) coefficient, as in the JAX package
    _equal(_quiet(tm.normalize, [0.0, 0.0], [1.0, 0.5]), _quiet(jm.normalize, [0.0, 0.0],
                                                                 [1.0, 0.5]))


@pytest.mark.parametrize('module', ['iir', 'lti'])
def test_module_imports_nothing_of_the_jax_package(module):
    import ast
    import importlib
    import inspect

    tree = ast.parse(inspect.getsource(importlib.import_module(f'dsc_tpu_torch.models.{module}')))
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or '' for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert not any(n.startswith(('jax', 'dsc_tpu')) and not n.startswith('dsc_tpu_torch')
                   for n in names)
