"""The design-support tier of dsc_tpu_torch (models/filter_extras.py)
against dsc_tpu.models and scipy.signal on the same inputs, on the CPU.

- The host functions are the JAX package's NumPy code: the analog
  prototypes, the lp2* transforms in tf and zpk form, ``bilinear_zpk``,
  ``lfiltic``, ``unique_roots``, ``findfreqs``, ``abcd_normalize``,
  ``choose_conv_method`` and ``freqz_sos`` equal the reference's bit for bit
  (``_same``), and are held to scipy.signal with tests/test_filter_extras.py's
  bounds (1e-10 for the zpk forms, 1e-9 for ellipap and besselap).
- ``unique_roots`` equals scipy's as a sorted set; its order is the
  reference's (a conjugate pair comes out 3-1j before 3+1j, scipy's the
  other way round).
- ``lfiltic`` continues a filter: the port's ``lfilter`` of the second half
  started from its state equals the one-pass filter within 1e-5 of the
  largest value, and scipy's within 1e-4.
- ``dfreqresp`` and ``dbode`` (ROADMAP F9): for a biproper system they
  equal the reference's bit for bit; for a strictly proper transfer function
  or zpk system they equal scipy's (H within 1e-12, the phase within 1e-9
  degrees), where the reference's are wrong. ``dbode``'s ``w`` is in
  rad/sample, as scipy's is; the reference scales it by dt.
- ``fftconvolve`` runs the port's FFT convolutions: 1-D (one signal and a
  batch of two) and 2-D, in the three modes, within 2e-6 of the largest value
  of the JAX package's (tests/test_filter_extras.py's bound) and of scipy's.
- Every RuntimeError text equals the JAX package's.
"""

import gc
import importlib

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402

CONV = 2e-6  # fftconvolve: relative to the largest value (tests/test_filter_extras.py)


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    # the conftest collects after every test: freeze what the imports left
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _same(got, ref):
    """Equal bit for bit: arrays (dtype and shape too), scalars, nested
    tuples."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
        return
    g, r = np.asarray(got), np.asarray(ref)
    assert g.dtype == r.dtype and g.shape == r.shape, (g.dtype, r.dtype, g.shape, r.shape)
    assert np.array_equal(g, r, equal_nan=True), (g, r)


def _both(name, *args, **kw):
    """The port's ``name`` and the JAX package's on the same arguments,
    equal bit for bit; returns the port's."""
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


def _zpk_close(got, want, tol=1e-10):
    z1, p1, k1 = got
    z2, p2, k2 = want
    assert np.allclose(np.sort_complex(np.atleast_1d(z1)), np.sort_complex(np.atleast_1d(z2)),
                       atol=tol)
    assert np.allclose(np.sort_complex(np.atleast_1d(p1)), np.sort_complex(np.atleast_1d(p2)),
                       atol=tol)
    assert abs(k1 - k2) < tol * max(abs(k2), 1.0)


# ------------------------------------------------------- analog prototypes

@pytest.mark.parametrize('n', [1, 2, 3, 5, 8])
def test_analog_prototypes(n):
    _zpk_close(_both('buttap', n), sps.buttap(n))
    _zpk_close(_both('cheb1ap', n, 1.0), sps.cheb1ap(n, 1.0))
    _zpk_close(_both('cheb2ap', n, 40.0), sps.cheb2ap(n, 40.0))
    _zpk_close(_both('ellipap', n, 1.0, 40.0), sps.ellipap(n, 1.0, 40.0), 1e-9)
    _zpk_close(_both('besselap', n), sps.besselap(n), 1e-9)


def test_prototype_errors():
    for name, args in (('buttap', (0,)), ('cheb1ap', (0, 1.0)), ('cheb2ap', (0, 40.0)),
                       ('ellipap', (0, 1.0, 40.0)), ('besselap', (0,))):
        _same_error(name, *args)
    _same_error('besselap', 3, norm='mag')


# ------------------------------------------------ lowpass band transforms

TF_TRANSFORMS = [('lp2lp', (2.0,)), ('lp2hp', (2.0,)), ('lp2bp', (2.0, 0.5)),
                 ('lp2bs', (2.0, 0.5))]


@pytest.mark.parametrize('name,args', TF_TRANSFORMS)
@pytest.mark.parametrize('proto', ['butter 3', 'cheby2 4'])
def test_lp_transforms_tf(name, args, proto):
    b, a = (sps.butter(3, 1.0, analog=True) if proto == 'butter 3'
            else sps.cheby2(4, 40.0, 1.0, analog=True))
    b1, a1 = _both(name, b, a, *args)
    b2, a2 = getattr(sps, name)(b, a, *args)
    # the same transfer function up to a common normalization
    assert np.allclose(b1 / a1[0], np.atleast_1d(b2) / a2[0], atol=1e-10)
    assert np.allclose(a1 / a1[0], a2 / a2[0], atol=1e-10)


@pytest.mark.parametrize('name,args', TF_TRANSFORMS)
@pytest.mark.parametrize('proto', ['buttap 4', 'cheb2ap 5', 'ellipap 3'])
def test_lp_transforms_zpk(name, args, proto):
    z, p, k = {'buttap 4': lambda: sps.buttap(4), 'cheb2ap 5': lambda: sps.cheb2ap(5, 40.0),
               'ellipap 3': lambda: sps.ellipap(3, 1.0, 40.0)}[proto]()
    got = _both(f'{name}_zpk', z, p, k, *args)
    _zpk_close(got, getattr(sps, f'{name}_zpk')(z, p, k, *args), 1e-9)


@pytest.mark.parametrize('fs', [10.0, 2.0])
def test_bilinear_zpk(fs):
    for z, p, k in (sps.buttap(4), sps.cheb2ap(3, 30.0)):
        _zpk_close(_both('bilinear_zpk', z, p, k, fs), sps.bilinear_zpk(z, p, k, fs))


# --------------------------------------------------------- small utilities

LFILTIC_CASES = {
    'butter 4': sps.butter(4, 0.3),
    'a[0] = 2': (np.array([0.5, 0.2, 0.1]), np.array([2.0, -0.4, 0.3])),
    'fir 5': (np.array([0.1, 0.2, 0.4, 0.2, 0.1]), np.array([1.0])),
    'long a': (np.array([1.0, 0.5]), np.array([1.0, -0.5, 0.2, -0.1])),
}


@pytest.mark.parametrize('case', sorted(LFILTIC_CASES))
@pytest.mark.parametrize('past', ['y and x', 'y', 'short y and x'])
def test_lfiltic(case, past):
    b, a = LFILTIC_CASES[case]
    rng = np.random.default_rng(len(case) + len(past))
    y, x = rng.standard_normal(10), rng.standard_normal(10)
    if past == 'short y and x':
        y, x = y[:1], x[:1]
    args = (b, a, y) if past == 'y' else (b, a, y, x)
    got = _both('lfiltic', *args)
    assert np.allclose(got, sps.lfiltic(*args), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('case', sorted(LFILTIC_CASES))
def test_lfiltic_continues_a_filter(case):
    """The second half filtered from lfiltic's state equals the one-pass
    filter (the port's lfilter both times) and scipy's."""
    b, a = LFILTIC_CASES[case]
    sig = np.random.default_rng(0).standard_normal(2 * 4096).astype(np.float32)
    half = sig.size // 2
    whole = tm.lfilter(b, a, dt.from_numpy(sig)).numpy().astype(np.float64)
    first = tm.lfilter(b, a, dt.from_numpy(sig[:half])).numpy().astype(np.float64)
    zi = tm.lfiltic(b, a, first[::-1], sig[:half][::-1].astype(np.float64))
    cont, _ = tm.lfilter(b, a, dt.from_numpy(sig[half:]), zi=zi)
    cont = cont.numpy().astype(np.float64)
    top = np.abs(whole).max()
    assert np.abs(cont - whole[half:]).max() <= 1e-5 * top
    ref = sps.lfilter(b, a, sig.astype(np.float64))
    assert np.abs(cont - ref[half:]).max() <= 1e-4 * top


def test_lfiltic_error():
    _same_error('lfiltic', [1.0], [0.0, 1.0], [1.0])


UNIQUE_CASES = {
    'reals': [1.0, 1.0001, 2.0, 2.0, 3.0],
    'conjugate pair': [3 + 1j, 3 - 1j, 1.0, 1.0001, -2.0],
    'clusters': [0.5 + 0.5j, 0.5005 + 0.5j, 0.5 - 0.5j, 0.4998 - 0.5j, -1.0, -1.0, -1.0],
}


@pytest.mark.parametrize('rtype', ['min', 'max', 'avg'])
@pytest.mark.parametrize('case', sorted(UNIQUE_CASES))
def test_unique_roots(case, rtype):
    roots = UNIQUE_CASES[case]
    u, m = _both('unique_roots', roots, tol=1e-3, rtype=rtype)
    us, ms = sps.unique_roots(roots, tol=1e-3, rtype=rtype)
    # the same (root, multiplicity) pairs as a sorted set: the order differs
    key = np.lexsort((np.round(u.imag, 9), np.round(u.real, 9)))
    key_s = np.lexsort((np.round(np.asarray(us).imag, 9), np.round(np.asarray(us).real, 9)))
    assert np.allclose(u[key], np.asarray(us)[key_s], atol=1e-12)
    assert np.array_equal(m[key], np.asarray(ms)[key_s])


def test_unique_roots_order_of_a_conjugate_pair():
    """The reference's order (ROADMAP, reference defects): 3-1j before 3+1j,
    scipy's the other way round; the multiplicities agree."""
    u, m = _both('unique_roots', [3 + 1j, 3 - 1j])
    us, ms = sps.unique_roots([3 + 1j, 3 - 1j])
    assert list(u) == [3 - 1j, 3 + 1j] and list(us) == [3 + 1j, 3 - 1j]
    assert list(m) == list(ms) == [1, 1]
    _same_error('unique_roots', [1.0, 2.0], rtype='mean')


@pytest.mark.parametrize('num,den', [([1.0, 2.0], [1.0, 1.4, 1.0]), ([1.0], [1.0, 8.0, 25.0]),
                                     ([1.0, 0.0], [1.0, 0.2, 100.0]), ([2.0], [1.0])])
def test_findfreqs_ba(num, den):
    got = _both('findfreqs', num, den, 15)
    assert np.allclose(got, sps.findfreqs(num, den, 15), rtol=1e-12)


def test_findfreqs_zp():
    z, p, _ = sps.cheb2ap(5, 40.0)
    got = _both('findfreqs', z, p, 40, kind='zp')
    assert np.allclose(got, sps.findfreqs(z, p, 40, kind='zp'), rtol=1e-12)
    _same_error('findfreqs', [1.0], [1.0, 1.0], 10, kind='xy')


def test_abcd_normalize():
    for kw in ({'A': np.eye(2), 'B': np.ones((2, 1)), 'C': np.ones((1, 2))},
               {'A': [[0.5]], 'B': [[1.0]], 'C': [[2.0]], 'D': [[0.0]]},
               {'B': np.ones((3, 2)), 'C': np.ones((1, 3))},
               {'A': np.eye(3), 'D': np.ones((2, 4))} | {'B': np.ones((3, 4))}):
        got = _both('abcd_normalize', **kw)
        for g, w in zip(got, sps.abcd_normalize(**kw)):
            assert np.array_equal(g, w)
    _same_error('abcd_normalize', A=np.eye(2), B=np.ones((2, 1)))
    _same_error('abcd_normalize', A=np.eye(2), B=np.ones((3, 1)), C=np.ones((1, 2)))


def test_aliases():
    assert tm.choose_conv_method(np.ones(5), np.ones(3)) == 'fft' == \
        jm.choose_conv_method(np.ones(5), np.ones(3))
    sos = sps.butter(4, 0.3, output='sos')
    for kw in ({}, {'worN': 64, 'fs': 1000.0}):
        got = _both('freqz_sos', sos, **kw)
        _same(got, tm.sosfreqz(sos, **kw))
        want = sps.freqz_sos(sos, **kw)
        assert np.allclose(got[0], want[0]) and np.allclose(got[1], want[1], atol=1e-12)


# ------------------------------------------------ discrete responses (F9)

BIPROPER = sps.cont2discrete(sps.tf2ss([1.0, 3.0, 3.0], [1.0, 2.0, 1.0]), 0.1)
STRICT = {  # strictly proper discrete systems: the reference evaluates them wrong
    'tf 1 / (z - 0.5)': ([1.0], [1.0, -0.5], 0.1),
    'tf (z + 0.3) / (z^2 - z + 0.5)': ([1.0, 0.3], [1.0, -1.0, 0.5], 0.02),
    'zpk 2 / (z - 0.5)': ([], [0.5], 2.0, 0.1),
    'zpk (z - 0.2) / (z^2 + 0.25)': ([0.2], [0.5j, -0.5j], 1.5, 1.0),
}


@pytest.mark.parametrize('kw', [{'n': 200}, {'w': np.linspace(0.01, 3.0, 50)}], ids=['n', 'w'])
def test_dfreqresp_biproper_equals_jax_and_scipy(kw):
    for system in (BIPROPER, ([1.0, -0.2], [1.0, 0.5], 0.1), (*sps.tf2zpk([1.0, -0.2],
                                                                           [1.0, 0.5]), 0.1)):
        got = tm.dfreqresp(system, **kw)
        if len(system) != 4:
            _same(got, jm.dfreqresp(system, **kw))
        want = sps.dfreqresp(system, **kw)
        assert np.allclose(got[0], want[0], rtol=1e-14)
        assert np.abs(got[1] - want[1]).max() <= 1e-12 * np.abs(want[1]).max()


def test_dbode_biproper_equals_jax_and_scipy():
    got = _both('dbode', BIPROPER, n=100)
    want = sps.dbode(BIPROPER, n=100)
    for g, w in zip(got, want):
        assert np.allclose(g, w, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize('case', sorted(STRICT))
def test_f9_strictly_proper_follows_scipy(case):
    """ROADMAP F9: the port aligns b and a as polynomials in z (and
    evaluates a zpk system in z) as scipy does; the reference evaluates
    b(z^-1) / a(z^-1) of the unaligned coefficients."""
    system = STRICT[case]
    w, h = tm.dfreqresp(system, n=64)
    ws, hs = sps.dfreqresp(system, n=64)
    assert np.array_equal(w, ws)
    assert np.abs(h - hs).max() <= 1e-12 * np.abs(hs).max()
    _, hj = jm.dfreqresp(system, n=64)
    assert np.abs(hj - hs).max() > 0.1 * np.abs(hs).max()
    wb, mag, phase = tm.dbode(system, n=4096)
    wbs, mags, phases = sps.dbode(system, n=4096)
    assert np.allclose(wb, wbs, rtol=1e-14)
    assert np.abs(mag - mags).max() <= 1e-9
    assert np.abs(phase - phases).max() <= 1e-9
    _, magj, phasej = jm.dbode(system, n=4096)
    assert np.abs(phasej - phases).max() > 10.0


def test_f9_dbode_w_in_rad_per_sample():
    """scipy's dbode evaluates at ``w`` rad/sample and returns w / dt; the
    reference evaluates at w * dt and returns w."""
    system = STRICT['tf 1 / (z - 0.5)']
    w = np.linspace(0.01, 3.0, 50)
    got, want = tm.dbode(system, w=w), sps.dbode(system, w=w)
    for g, s in zip(got, want):
        assert np.allclose(g, s, rtol=1e-12, atol=1e-9)
    assert np.allclose(got[0], w / 0.1)
    assert np.allclose(jm.dbode(system, w=w)[0], w)


def test_dfreqresp_error():
    _same_error('dfreqresp', ([1.0], [1.0]))
    _same_error('dfreqresp', np.ones(3))


# ------------------------------------------------------------ fftconvolve

def _conv_inputs(sig_shape, k_shape, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(sig_shape).astype(np.float32),
            rng.standard_normal(k_shape).astype(np.float32))


_JAX_CONV = {}


def _jax_fftconvolve(a, b, mode):
    """The JAX package's fftconvolve, once a case."""
    key = (a.shape, b.shape, mode)
    if key not in _JAX_CONV:
        _JAX_CONV[key] = jm.fftconvolve(dsc_tpu.from_numpy(a), dsc_tpu.from_numpy(b),
                                        mode=mode).numpy()
    return _JAX_CONV[key]


@pytest.mark.parametrize('mode', ['full', 'same', 'valid'])
@pytest.mark.parametrize('shapes', [((500,), (33,)), ((2, 300), (17,)), ((40, 36), (5, 5)),
                                    ((24, 31), (6, 3))], ids=str)
def test_fftconvolve(shapes, mode):
    a, b = _conv_inputs(*shapes)
    got = tm.fftconvolve(dt.from_numpy(a), dt.from_numpy(b), mode=mode)
    assert isinstance(got, dt.Tensor) and got.dtype == dt.Dtype.F32
    got = got.numpy().astype(np.float64)
    jax = _jax_fftconvolve(a, b, mode)
    if a.ndim == 2 and b.ndim == 1:
        want = np.stack([sps.fftconvolve(r.astype(np.float64), b.astype(np.float64), mode=mode)
                         for r in a])
    else:
        want = sps.fftconvolve(a.astype(np.float64), b.astype(np.float64), mode=mode)
    assert got.shape == jax.shape == want.shape
    top = np.abs(want).max()
    assert np.abs(got - jax).max() <= CONV * top
    assert np.abs(got - want).max() <= CONV * top


def test_fftconvolve_routes_on_n_dim(monkeypatch):
    fe = importlib.import_module('dsc_tpu_torch.models.filter_extras')
    calls = []
    monkeypatch.setattr(fe, 'fft_convolve', lambda *a, **k: calls.append('1-D'))
    monkeypatch.setattr(fe, 'fft_convolve2', lambda *a, **k: calls.append('2-D'))
    a1, a2 = dt.from_numpy(np.ones(8, np.float32)), dt.from_numpy(np.ones((4, 4), np.float32))
    tm.fftconvolve(a1, a1)
    tm.fftconvolve(a2, a2)
    tm.fftconvolve(a2, a1)  # a batch of rows with 1-D taps
    assert calls == ['1-D', '2-D', '1-D']
