"""Pole placement, equiripple FIR design and peak detection of dsc_tpu_torch
(models/placepoles.py, remez.py, peaks.py) against dsc_tpu.models and
scipy.signal on the same inputs, on the CPU.

- All three are the JAX package's NumPy code on the host, so every result
  equals the reference's bit for bit (``_same``; remez's taps as the same
  float32 or float64 values).
- ``place_poles``: a single-input gain within 1e-6 of scipy's (Ackermann's
  gain is unique) and the computed poles within 1e-6 of the request; a
  multi-input system places its poles within 1e-8 (tests/test_placepoles.py).
- ``remez``: the taps within 1e-4 of scipy's and the ripple within 1% of
  scipy's (tests/test_psd_fir.py), the taps uploaded to the context's device
  in the dtype asked for. The 128-tap case of ROADMAP's reference defects
  stays out of the scipy-parity cases: the exchange stops short of the
  optimum there, in the reference as in the port, and a test of its own
  records the gap.
- ``find_peaks`` and the rest: indices equal to scipy's, properties within
  1e-10 (tests/test_peaks.py), over the reference's 40 fuzz seeds and the
  plateau and standalone cases; a float32 Tensor input gives the results of
  its values as a NumPy array, a 2-D one raises, and a download inside
  ``dsc.compile`` raises.
- Every RuntimeError text equals the JAX package's.
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


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _same(got, ref):
    """Equal bit for bit: arrays (dtype and shape too), scalars, nested
    tuples and dicts."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref)
        for k in ref:
            _same(got[k], ref[k])
        return
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
        return
    g, r = np.asarray(got), np.asarray(ref)
    assert g.dtype == r.dtype and g.shape == r.shape, (g.dtype, r.dtype, g.shape, r.shape)
    assert np.array_equal(g, r, equal_nan=True), (g, r)


def _both(name, *args, **kw):
    got = getattr(tm, name)(*args, **kw)
    _same(got, getattr(jm, name)(*args, **kw))
    return got


def _error_text(fn, *args, **kw):
    with pytest.raises(RuntimeError) as info:
        fn(*args, **kw)
    return str(info.value)


def _same_error(name, *args, **kw):
    assert _error_text(getattr(tm, name), *args, **kw) == \
        _error_text(getattr(jm, name), *args, **kw)


# ------------------------------------------------------------- place_poles

BUNCH_FIELDS = ('gain_matrix', 'computed_poles', 'requested_poles', 'X', 'rtol', 'nb_iter')


def _placed(a, b, poles, **kw):
    got = tm.place_poles(a, b, poles, **kw)
    ref = jm.place_poles(a, b, poles, **kw)
    assert repr(got) == repr(ref)
    for field in BUNCH_FIELDS:
        if getattr(ref, field) is None:
            assert getattr(got, field) is None
        else:
            _same(getattr(got, field), getattr(ref, field))
    return got


def _poles(rng, n):
    p = np.unique(np.round(-rng.uniform(0.5, 3.0, n), 3))[:n]
    while p.size < n:
        p = np.append(p, p.min() * 1.13 - 0.1)
    return p


@pytest.mark.parametrize('seed', range(5))
def test_place_poles_single_input(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, 1))
    poles = _poles(rng, n)
    got = _placed(a, b, poles)
    ref = sps.place_poles(a, b, poles)
    assert np.allclose(got.gain_matrix, ref.gain_matrix, atol=1e-6, rtol=1e-6)
    assert np.abs(got.computed_poles - np.sort_complex(poles.astype(complex))).max() < 1e-6


@pytest.mark.parametrize('seed', range(8))
def test_place_poles_multi_input(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(3, 7))
    m = int(rng.integers(2, min(n, 4)))
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, m))
    poles = _poles(rng, n)
    got = _placed(a, b, poles, method='KNV0' if seed % 2 else 'YT')
    assert np.abs(got.computed_poles - np.sort_complex(poles.astype(complex))).max() < 1e-8
    assert got.gain_matrix.shape == (m, n) and np.isrealobj(got.gain_matrix)


def test_place_poles_complex_pairs_and_errors():
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((4, 4)), rng.standard_normal((4, 2))
    poles = np.array([-1 + 2j, -1 - 2j, -3.0, -4.0])
    got = _placed(a, b, poles)
    assert np.abs(got.computed_poles - np.sort_complex(poles)).max() < 1e-8
    a1, b1 = rng.standard_normal((3, 3)), rng.standard_normal((3, 1))
    got = _placed(a1, b1, [-1 + 1j, -1 - 1j, -2.0])
    want = sps.place_poles(a1, b1, [-1 + 1j, -1 - 1j, -2.0])
    assert np.allclose(got.gain_matrix, want.gain_matrix, atol=1e-8, rtol=1e-8)
    for args, kw in (((a, b, [-1 + 2j, -1 + 2j, -3.0, -4.0]), {}),
                     ((a, b, [-1.0, -2.0]), {}),
                     ((np.diag([1.0, 2.0]), np.asarray([[1.0], [0.0]]), [-1.0, -2.0]), {}),
                     ((a, b, poles), {'method': 'XY'}),
                     ((np.ones((2, 3)), b, poles), {})):
        _same_error('place_poles', *args, **kw)


# ------------------------------------------------------------------ remez

def _ripple(taps, bands, desired, weight):
    w = np.linspace(0, 0.5, 4001)
    h = np.abs(np.polyval(taps[::-1], np.exp(-2j * np.pi * w))
               * np.exp(1j * np.pi * w * (len(taps) - 1)))
    e = 0.0
    for i in range(len(desired)):
        m = (w >= bands[2 * i]) & (w <= bands[2 * i + 1])
        e = max(e, (np.abs(h[m] - desired[i]) * weight[i]).max())
    return e


def _remez_both(*args, **kw):
    got = tm.remez(*args, **kw)
    assert isinstance(got, dt.Tensor) and got.device == dt.context.device()
    _same(got.numpy(), jm.remez(*args, **kw).numpy())
    return got.numpy()


REMEZ_CASES = [  # tests/test_psd_fir.py's, and chip_smoke.py phase 12's 101 taps
    (73, [0, 0.2, 0.25, 0.5], [1, 0], [1, 1]),
    (65, [0, 0.1, 0.15, 0.35, 0.4, 0.5], [0, 1, 0], [1, 1, 1]),
    (64, [0, 0.2, 0.3, 0.5], [1, 0], [1, 2]),   # even taps (type II)
    (31, [0, 0.15, 0.2, 0.5], [1, 0], [1, 10]),
    (101, [0, 0.1, 0.15, 0.5], [1, 0], [1, 1]),
]


@pytest.mark.parametrize('numtaps,bands,desired,weight', REMEZ_CASES)
def test_remez_matches_jax_and_scipy(numtaps, bands, desired, weight):
    got = _remez_both(numtaps, bands, desired, weight=weight)
    assert got.dtype == np.float32
    ref = sps.remez(numtaps, bands, desired, weight=weight, fs=1.0)
    assert np.abs(got - ref).max() < 1e-4
    e_got = _ripple(got.astype(np.float64), bands, desired, weight)
    assert e_got < _ripple(ref, bands, desired, weight) * 1.01 + 1e-9


def test_remez_float64_fs_units_and_errors():
    got = _remez_both(51, [0, 200, 250, 500], [1, 0], fs=1000.0, dtype=dt.Dtype.F64)
    assert got.dtype == np.float64
    assert np.abs(got - sps.remez(51, [0, 200, 250, 500], [1, 0], fs=1000.0)).max() < 1e-4
    for args in ((51, [0, 0.2, 0.25], [1, 0]), (51, [0, 0.2, 0.25, 0.5], [1]),
                 (64, [0, 0.2, 0.25, 0.5], [1, 1]), (2, [0, 0.2, 0.25, 0.5], [1, 0]),
                 (51, [0, 0.3, 0.25, 0.5], [1, 0])):
        _same_error('remez', *args)
    _same_error('remez', 51, [0, 0.2, 0.25, 0.5], [1, 0], weight=[1.0])


def test_remez_128_taps_keeps_the_reference_defect():
    """ROADMAP, reference defects: at 128 taps over [0, .1, .2, .4, .45, .5]
    the exchange stops short of the optimum. The port keeps the reference's
    taps; they lie more than 0.05 from scipy's, whose ripple is lower."""
    bands, desired, weight = [0, 0.1, 0.2, 0.4, 0.45, 0.5], [0, 1, 0], [1, 1, 1]
    got = _remez_both(128, bands, desired, dtype=dt.Dtype.F64)
    ref = sps.remez(128, bands, desired)
    assert np.abs(got - ref).max() > 0.05
    assert _ripple(got, bands, desired, weight) > 1.05 * _ripple(ref, bands, desired, weight)


# ------------------------------------------------------------------ peaks

def test_find_peaks_simple_and_plateaus():
    x = np.array([0, 1, 0, 2, 2, 2, 0, 3, 0, 1, 1, 0], np.float64)
    p, _ = _both('find_peaks', x)
    assert np.array_equal(p, sps.find_peaks(x)[0])
    p, props = _both('find_peaks', x, plateau_size=2)
    p2, props2 = sps.find_peaks(x, plateau_size=2)
    assert np.array_equal(p, p2)
    for k in props2:
        assert np.allclose(props[k], props2[k]), k


def _fuzz_case(seed):
    """tests/test_peaks.py's fuzz: a random walk (plateaus in some) and a
    random set of conditions."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 400))
    x = np.cumsum(rng.standard_normal(n))
    if rng.random() < 0.3:
        x = np.round(x * 2) / 2
    kw = {}
    if rng.random() < 0.5:
        kw['height'] = float(rng.normal(0, 2))
    if rng.random() < 0.4:
        kw['threshold'] = float(rng.uniform(0, 0.5))
    if rng.random() < 0.5:
        kw['distance'] = int(rng.integers(1, 10))
    if rng.random() < 0.5:
        kw['prominence'] = float(rng.uniform(0, 2))
    if rng.random() < 0.4:
        kw['width'] = float(rng.uniform(0, 4))
    if rng.random() < 0.3:
        kw['wlen'] = int(rng.integers(3, 50))
    if rng.random() < 0.3:
        kw['rel_height'] = float(rng.uniform(0.1, 1.0))
    return x, kw


@pytest.mark.parametrize('seed', range(40))
def test_find_peaks_fuzz(seed):
    x, kw = _fuzz_case(seed)
    p, props = _both('find_peaks', x, **kw)
    p2, props2 = sps.find_peaks(x, **kw)
    assert np.array_equal(p, p2), kw
    assert sorted(props) == sorted(props2)
    for k in props2:
        assert np.allclose(props[k], props2[k], atol=1e-10), (k, kw)


def test_find_peaks_every_condition_with_intervals():
    rng = np.random.default_rng(21)
    x = np.round(np.cumsum(rng.standard_normal(3000)) * 4) / 4
    kw = {'height': (-5.0, 30.0), 'threshold': (0.0, 2.0), 'distance': 4,
          'prominence': (0.5, None), 'width': (1.0, 50.0), 'wlen': 101, 'rel_height': 0.7,
          'plateau_size': (1, 6)}
    p, props = _both('find_peaks', x, **kw)
    p2, props2 = sps.find_peaks(x, **kw)
    assert p.size > 10 and np.array_equal(p, p2)
    assert sorted(props) == sorted(props2)
    for k in props2:
        assert np.allclose(props[k], props2[k], atol=1e-10), k


@pytest.mark.parametrize('wlen', [None, 21])
def test_peak_prominences_and_widths(wlen):
    x = np.cumsum(np.random.default_rng(7).standard_normal(256))
    pk = sps.find_peaks(x)[0]
    for u, v in zip(_both('peak_prominences', x, pk, wlen), sps.peak_prominences(x, pk, wlen=wlen)):
        assert np.allclose(u, v)
    for rh in (0.3, 0.5, 1.0):
        got = _both('peak_widths', x, pk, rel_height=rh, wlen=wlen)
        for u, v in zip(got, sps.peak_widths(x, pk, rel_height=rh, wlen=wlen)):
            assert np.allclose(u, v)


def test_peak_errors():
    x = np.cumsum(np.random.default_rng(7).standard_normal(64))
    _same_error('peak_prominences', x, [len(x) + 5])
    _same_error('peak_prominences', x, [3], wlen=2)
    _same_error('peak_prominences', x, [[3]])
    _same_error('peak_widths', x, [3], rel_height=-1.0)
    _same_error('find_peaks', x, distance=0.5)
    _same_error('find_peaks', x.reshape(8, 8))
    _same_error('argrelmax', x, order=0)
    _same_error('argrelmin', x, mode='reflect')


@pytest.mark.parametrize('order', [1, 2, 3])
@pytest.mark.parametrize('mode', ['clip', 'wrap'])
def test_argrel(order, mode):
    x = np.round(np.random.default_rng(9).standard_normal(128) * 3) / 3  # ties too
    for name in ('argrelmax', 'argrelmin'):
        got = _both(name, x, order, mode)
        assert np.array_equal(got[0], getattr(sps, name)(x, order=order, mode=mode)[0])
    got = _both('argrelextrema', x, np.greater_equal, order, mode)
    assert np.array_equal(got[0], sps.argrelextrema(x, np.greater_equal, order=order,
                                                    mode=mode)[0])


def test_tensor_input_downloads_once():
    """A float32 Tensor gives what its values give as a NumPy array; so does
    the JAX package's Tensor."""
    x = np.cumsum(np.random.default_rng(1).standard_normal(4096)).astype(np.float32)
    xt, xj = dt.from_numpy(x), dsc_tpu.from_numpy(x)
    kw = {'height': 0.0, 'distance': 5, 'prominence': 1.0, 'width': 2.0}
    got = tm.find_peaks(xt, **kw)
    _same(got, tm.find_peaks(x.astype(np.float64), **kw))
    _same(got, jm.find_peaks(xj, **kw))
    p = got[0]
    _same(tm.peak_prominences(xt, p), jm.peak_prominences(xj, p))
    _same(tm.peak_widths(xt, p), jm.peak_widths(xj, p))
    _same(tm.argrelmax(xt, 3), jm.argrelmax(xj, 3))
    _same(tm.argrelmin(xt, 2, 'wrap'), jm.argrelmin(xj, 2, 'wrap'))
    assert _error_text(tm.find_peaks, dt.from_numpy(x.reshape(2, -1))) == \
        _error_text(jm.find_peaks, dsc_tpu.from_numpy(x.reshape(2, -1)))
    assert _error_text(tm.find_peaks, dt.from_numpy(x.astype(np.complex64))) == \
        _error_text(jm.find_peaks, dsc_tpu.from_numpy(x.astype(np.complex64)))


@pytest.mark.parametrize('name,args', [('find_peaks', ()), ('peak_prominences', ([5],)),
                                       ('argrelmax', ())])
def test_peaks_inside_compile_raise(name, args):
    """The download is not baked into a captured program: it raises, as
    every Tensor.numpy() inside dsc.compile does."""
    def fn(s):
        out = getattr(tm, name)(s, *args)
        return dt.from_numpy(np.asarray(out[0], np.float32))

    compiled = dt.compile(fn)
    with pytest.raises(RuntimeError, match='concrete value'):
        compiled(dt.from_numpy(np.sin(np.arange(64) / 3.0).astype(np.float32)))
