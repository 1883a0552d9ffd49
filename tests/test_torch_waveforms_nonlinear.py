"""The signal-generation tier of dsc_tpu_torch (models/waveforms.py,
nonlinear.py) against dsc_tpu.models and scipy.signal on the same seeded
inputs, on the CPU.

- ``chirp`` (all four methods), ``sawtooth``, ``gausspulse``, ``sweep_poly``
  on a host, a float64 Tensor and a float32 Tensor time axis: float32
  results within one float32 rounding (1.2e-7 of the largest value) of the
  JAX package's and within the JAX tests' 1e-4 of scipy float64
  (tests/test_waveforms.py); float64 results within 1e-11 of the JAX
  package's (its XLA cos differs from torch's in the last bits) and 1e-9 of
  scipy's. ``square`` equals the JAX package's sample for sample, on
  negative times, exact multiples of 2 pi and one ulp either side of
  duty * 2 pi, and scipy's on the JAX test's grid.
- ``max_len_seq`` and ``vectorstrength`` (host code) equal the JAX
  package's and scipy's.
- ``medfilt`` (k = 1, 3, 7, 21), ``medfilt2d`` and ``order_filter`` equal
  the JAX package's and scipy's exactly, on inputs with NaN and +-inf too
  (against the JAX package: NaN in a median window gives NaN, a rank takes
  NaN as the largest value). ``wiener`` within 2e-6 of the largest value of
  the JAX package's (float32 sums in one order; the JAX package's XLA
  divides by k as a multiply by 1/k) and within the JAX test's 1e-4 of
  scipy; the data keep the local variance away from the noise edge.
- The reference's departures from scipy, on both sides: 2-D ``medfilt`` and
  ``wiener`` filter rows, ``wiener``'s ``mysize`` is one int, ``chirp`` has
  no ``vertex_zero``, ``gausspulse`` no ``retquad`` / ``retenv`` /
  ``'cutoff'``; and one the port does not copy (ROADMAP F8): the JAX
  package's median of values above ~1.7e38 overflows to inf.
- Under ``dsc.compile`` the waves and filters give the eager values; the
  slice end to end (chirp + noise -> sosfilt -> medfilt -> welch) against the
  JAX package and scipy.
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

F32_PORT = 1.2e-7   # float32 results vs the JAX package's: one rounding
F32_SCIPY = 1e-4    # tests/test_waveforms.py
F64_PORT = 1e-11
F64_SCIPY = 1e-9
WIENER_PORT = 2e-6


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _t(n=2048, fs=8000.0):
    return np.arange(n) / fs


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _time_axes(t):
    """The same time axis as a host array, a float64 Tensor and a float32
    Tensor, with the float64 values each stands for."""
    t32 = t.astype(np.float32)
    return {'host': (t, t, t), 'f64': (dt.from_numpy(t), dsc_tpu.from_numpy(t), t),
            'f32': (dt.from_numpy(t32), dsc_tpu.from_numpy(t32), t32.astype(np.float64))}


def _wave(name, kind, t, ref_fn, *args, **kw):
    """The port's and the JAX package's wave on time axis ``kind`` in both
    dtypes, against each other and against scipy's float64 wave."""
    tp, tj, t64 = _time_axes(t)[kind]
    want = ref_fn(t64)
    for dtype, port_bound, scipy_bound in (('F32', F32_PORT, F32_SCIPY),
                                           ('F64', F64_PORT, F64_SCIPY)):
        got = getattr(tm, name)(tp, *args, dtype=getattr(dt.Dtype, dtype), **kw)
        assert isinstance(got, dt.Tensor) and got.dtype == getattr(dt.Dtype, dtype)
        ref = getattr(jm, name)(tj, *args, dtype=getattr(dsc_tpu.Dtype, dtype), **kw).numpy()
        assert _rel(got.numpy(), ref) <= port_bound, dtype
        assert _rel(got.numpy(), want) <= scipy_bound, dtype


def _error_text(fn, *args, **kw):
    with pytest.raises(RuntimeError) as info:
        fn(*args, **kw)
    return str(info.value)


# -------------------------------------------------------------- waveforms

@pytest.mark.parametrize('kind', ['host', 'f64', 'f32'])
@pytest.mark.parametrize('method', ['linear', 'quadratic', 'logarithmic', 'hyperbolic'])
def test_chirp(method, kind):
    t = _t()
    _wave('chirp', kind, t, lambda t64: sps.chirp(t64, 100.0, t[-1], 900.0, method=method),
          100.0, t[-1], 900.0, method=method)


@pytest.mark.parametrize('method', ['logarithmic', 'hyperbolic'])
def test_chirp_constant_frequency_and_phase(method):
    t = _t()
    _wave('chirp', 'host', t,
          lambda t64: sps.chirp(t64, 100.0, t[-1], 100.0, method=method, phi=90.0),
          100.0, t[-1], 100.0, method=method, phi=90.0)


@pytest.mark.parametrize('kind', ['host', 'f64', 'f32'])
@pytest.mark.parametrize('width', [1.0, 0.5, 0.0, 0.3])
def test_sawtooth(width, kind):
    t = 2 * np.pi * 3.7 * _t()
    _wave('sawtooth', kind, t, lambda t64: sps.sawtooth(t64, width=width), width=width)


@pytest.mark.parametrize('kind', ['host', 'f64', 'f32'])
def test_gausspulse(kind):
    t = np.linspace(-0.01, 0.01, 2001)
    _wave('gausspulse', kind, t, lambda t64: sps.gausspulse(t64, fc=1000.0, bw=0.5),
          fc=1000.0, bw=0.5)


@pytest.mark.parametrize('kind', ['host', 'f64', 'f32'])
def test_sweep_poly(kind):
    p = [0.025, -0.36, 1.25, 2.0]
    _wave('sweep_poly', kind, _t(), lambda t64: sps.sweep_poly(t64, p, phi=30.0), p, phi=30.0)


def test_sweep_poly_poly_forms():
    t = _t()
    p = np.array([0.025, -0.36, 1.25, 2.0])
    want = tm.sweep_poly(t, p, dtype=dt.Dtype.F64).numpy()
    for poly in (np.poly1d(p), list(p), dt.from_numpy(p)):
        assert np.array_equal(tm.sweep_poly(t, poly, dtype=dt.Dtype.F64).numpy(), want)
    with pytest.raises(RuntimeError, match='out of bounds'):
        jm.sweep_poly(t, dsc_tpu.from_numpy(p))


def _square_axis(duty):
    """Negative and positive times, exact multiples of 2 pi, and the
    points one ulp either side of duty * 2 pi in several periods; no
    subnormal time (XLA on the CPU flushes those to zero)."""
    base = 2 * np.pi * 5.3 * np.arange(-2048, 2048) / 8000.0
    k = np.arange(-6, 7)
    edges = k * (2 * np.pi) + duty * (2 * np.pi)
    t = np.concatenate([base, k * (2 * np.pi), edges, np.nextafter(edges, np.inf),
                        np.nextafter(edges, -np.inf), [-0.0, 0.0]])
    return t[(t == 0) | (np.abs(t) >= np.finfo(np.float64).tiny)]


@pytest.mark.parametrize('duty', [0.0, 0.25, 0.5, 0.9, 1.0])
def test_square(duty):
    t = _square_axis(duty)
    for dtype in ('F32', 'F64'):
        got = tm.square(dt.from_numpy(t), duty, dtype=getattr(dt.Dtype, dtype)).numpy()
        ref = jm.square(dsc_tpu.from_numpy(t), duty,
                        dtype=getattr(dsc_tpu.Dtype, dtype)).numpy()
        assert np.array_equal(got, ref)
        assert np.array_equal(tm.square(t, duty, dtype=getattr(dt.Dtype, dtype)).numpy(), ref)
    grid = t[:4096]
    assert np.array_equal(tm.square(grid, duty).numpy(), sps.square(grid, duty))


def test_sawtooth_edges_equal_the_reference():
    t = _square_axis(0.3)
    got = tm.sawtooth(dt.from_numpy(t), 0.3, dtype=dt.Dtype.F64).numpy()
    ref = jm.sawtooth(dsc_tpu.from_numpy(t), 0.3, dtype=dsc_tpu.Dtype.F64).numpy()
    assert np.abs(got - ref).max() <= 1e-15


def test_wave_of_a_complex_tensor_raises_as_the_reference():
    z = np.arange(4, dtype=np.complex64)
    for name, args in (('chirp', (1.0, 1.0, 2.0)), ('square', ()), ('sawtooth', ()),
                       ('gausspulse', ()), ('sweep_poly', ([1.0],))):
        assert _error_text(getattr(tm, name), dt.from_numpy(z), *args) == \
            _error_text(getattr(jm, name), dsc_tpu.from_numpy(z), *args)


WAVE_ERRORS = [('chirp', (_t(64), 100.0, 1.0, 900.0), {'method': 'nope'}),
               ('chirp', (_t(64), -1.0, 1.0, 900.0), {'method': 'logarithmic'}),
               ('chirp', (_t(64), 1.0, 1.0, 0.0), {'method': 'hyperbolic'}),
               ('square', (_t(64),), {'duty': 1.5}), ('sawtooth', (_t(64),), {'width': -0.1}),
               ('gausspulse', (_t(64),), {'fc': -5.0}), ('gausspulse', (_t(64),), {'bwr': 1.0}),
               ('max_len_seq', (40,), {}), ('max_len_seq', (4,), {'taps': [5]}),
               ('max_len_seq', (4,), {'length': -1}), ('max_len_seq', (4,), {'state': [0] * 4}),
               ('vectorstrength', (np.ones((2, 2)), 1.0), {}),
               ('vectorstrength', (np.ones(3), [1.0, -1.0]), {})]


@pytest.mark.parametrize('name,args,kw', WAVE_ERRORS,
                         ids=[f'{e[0]}-{i}' for i, e in enumerate(WAVE_ERRORS)])
def test_wave_error_text_equals_the_reference(name, args, kw):
    assert _error_text(getattr(tm, name), *args, **kw) == \
        _error_text(getattr(jm, name), *args, **kw)


def test_scipy_options_the_reference_lacks():
    """chirp has no vertex_zero, gausspulse no retquad / retenv / 'cutoff',
    in both packages; scipy takes each."""
    t = _t(64)
    sps.chirp(t, 100.0, t[-1], 900.0, method='quadratic', vertex_zero=False)
    sps.gausspulse(t, retquad=True, retenv=True)
    assert sps.gausspulse('cutoff') > 0
    for mod in (tm, jm):
        with pytest.raises(TypeError):
            mod.chirp(t, 100.0, t[-1], 900.0, method='quadratic', vertex_zero=False)
        with pytest.raises(TypeError):
            mod.gausspulse(t, retquad=True)
        with pytest.raises(TypeError):
            mod.gausspulse(t, retenv=True)
        with pytest.raises(ValueError):
            mod.gausspulse('cutoff')


@pytest.mark.parametrize('nbits', [2, 3, 5, 8, 12])
def test_max_len_seq(nbits):
    got = tm.max_len_seq(nbits)
    for a, b in zip(got, jm.max_len_seq(nbits)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ref = sps.max_len_seq(nbits)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_max_len_seq_state_length_taps():
    kw = {'state': [1, 0, 1, 1, 0, 0, 1], 'length': 300, 'taps': [6, 3]}
    got = tm.max_len_seq(7, **kw)
    for a, b, c in zip(got, jm.max_len_seq(7, **kw), sps.max_len_seq(7, **kw)):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_vectorstrength():
    events = np.sort(np.random.default_rng(3).uniform(0, 2.0, 500))
    for period in (0.1, [0.05, 0.1, 0.3]):
        got = tm.vectorstrength(events, period)
        ref = jm.vectorstrength(events, period)
        want = sps.vectorstrength(events, period)
        for g, r, w in zip(got, ref, want):
            assert np.array_equal(np.asarray(g), np.asarray(r))
            assert np.allclose(g, w, rtol=1e-12, atol=1e-14)
    # Tensor events (both packages) and a Tensor period (the port's Tensor
    # converts; the JAX package's raises)
    periods = np.array([0.05, 0.1, 0.3])
    got = tm.vectorstrength(dt.from_numpy(events), dt.from_numpy(periods))
    assert all(np.array_equal(g, r) for g, r in zip(got, tm.vectorstrength(events, periods)))
    with pytest.raises(RuntimeError, match='out of bounds'):
        jm.vectorstrength(dsc_tpu.from_numpy(events), dsc_tpu.from_numpy(periods))


def test_waves_under_compile():
    """A wave of a Tensor t is traced; a wave of a host t is a constant of
    the program. The compiled values are the eager ones."""
    t = _t(4096)
    tt = dt.from_numpy(t)

    def waves(t_dev):
        return dt.add(tm.chirp(t_dev, 100.0, t[-1], 900.0, method='logarithmic'),
                      tm.square(2 * np.pi * 50.0 * t, 0.3))

    compiled = dt.compile(waves)
    want = waves(tt).numpy()
    for _ in range(3):
        assert np.array_equal(compiled(tt).numpy(), want)
    assert compiled.n_programs == 1


# -------------------------------------------------------------- nonlinear

def _sig(shape=501, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _specials(x):
    """``x`` with NaN, +inf and -inf at a few places, some in one window."""
    x = x.copy()
    flat = x.reshape(-1)
    flat[[5, 40, 41, 42, 200]] = [np.nan, np.inf, np.inf, -np.inf, np.nan]
    flat[[300, 301, 302]] = np.inf
    return x


@pytest.mark.parametrize('k', [1, 3, 7, 21])
def test_medfilt(k):
    x = _sig(seed=k)
    got = tm.medfilt(dt.from_numpy(x), k).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, jm.medfilt(dsc_tpu.from_numpy(x), k).numpy())
    assert np.array_equal(got, sps.medfilt(x.astype(np.float64), k))
    specials = _specials(x)
    assert np.array_equal(tm.medfilt(dt.from_numpy(specials), k).numpy(),
                          jm.medfilt(dsc_tpu.from_numpy(specials), k).numpy(), equal_nan=True)


def test_median_of_huge_values_is_scipys():
    """ROADMAP F8: jnp.median takes the midpoint (a + b) * 0.5 in float32,
    which overflows above ~1.7e38; the port's median is the picked value,
    as scipy's is."""
    rng = np.random.default_rng(12)
    x = (rng.uniform(1.8e38, 3.3e38, 64) * rng.choice([-1.0, 1.0], 64)).astype(np.float32)
    got = tm.medfilt(dt.from_numpy(x), 3).numpy()
    assert np.array_equal(got, sps.medfilt(x.astype(np.float64), 3)) and np.isfinite(got).all()
    assert not np.isfinite(jm.medfilt(dsc_tpu.from_numpy(x), 3).numpy()).all()
    im = x.reshape(8, 8)
    got = tm.medfilt2d(dt.from_numpy(im), 3).numpy()
    assert np.array_equal(got, sps.medfilt2d(im, 3)) and np.isfinite(got).all()
    assert not np.isfinite(jm.medfilt2d(dsc_tpu.from_numpy(im), 3).numpy()).all()


def test_medfilt_float64():
    x = _sig().astype(np.float64)
    got = tm.medfilt(dt.from_numpy(x), 5).numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got, jm.medfilt(dsc_tpu.from_numpy(x), 5).numpy())
    assert np.array_equal(got, sps.medfilt(x, 5))


def test_medfilt_2d_input_is_a_batch_of_rows():
    xs = _sig((3, 128), seed=1)
    got = tm.medfilt(dt.from_numpy(xs), 5).numpy()
    assert np.array_equal(got, jm.medfilt(dsc_tpu.from_numpy(xs), 5).numpy())
    rows = np.stack([sps.medfilt(r.astype(np.float64), 5) for r in xs])
    assert np.array_equal(got, rows)
    # scipy filters the 2-D input as an image with a 5 x 5 window
    assert not np.array_equal(got, sps.medfilt(xs.astype(np.float64), 5))


@pytest.mark.parametrize('ks', [3, (3, 5), 7, (1, 3)], ids=str)
def test_medfilt2d(ks):
    im = _sig((33, 47), seed=2)
    got = tm.medfilt2d(dt.from_numpy(im), ks).numpy()
    assert np.array_equal(got, jm.medfilt2d(dsc_tpu.from_numpy(im), ks).numpy())
    assert np.array_equal(got, sps.medfilt2d(im, ks))
    specials = _specials(im)
    assert np.array_equal(tm.medfilt2d(dt.from_numpy(specials), ks).numpy(),
                          jm.medfilt2d(dsc_tpu.from_numpy(specials), ks).numpy(),
                          equal_nan=True)


CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])


@pytest.mark.parametrize('domain,ranks', [(CROSS, range(5)), (np.ones((3, 3)), (0, 4, 8)),
                                          (np.ones((3, 5)), (7,))], ids=['cross', '3x3', '3x5'])
def test_order_filter_2d(domain, ranks):
    im = _sig((33, 47), seed=3)
    specials = _specials(im)
    for rank in ranks:
        got = tm.order_filter(dt.from_numpy(im), domain, rank).numpy()
        assert np.array_equal(got, jm.order_filter(dsc_tpu.from_numpy(im), domain, rank).numpy())
        assert np.array_equal(got, sps.order_filter(im, domain, rank))
        assert np.array_equal(tm.order_filter(dt.from_numpy(specials), domain, rank).numpy(),
                              jm.order_filter(dsc_tpu.from_numpy(specials), domain,
                                              rank).numpy(), equal_nan=True)


@pytest.mark.parametrize('domain,rank', [(np.ones(5), 2), (np.array([1, 0, 1, 1, 0, 0, 1]), 3),
                                         (np.array([1, 1, 0, 1, 1]), 2),
                                         (np.array([1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1]), 3),
                                         (np.ones(11), 0)],
                         ids=['5', 'sparse7', 'sparse5', 'sparse11', '11'])
def test_order_filter_1d(domain, rank):
    """Held to scipy on the signal as a 1-row image: scipy 1.17's 1-D path
    (ndimage's rank_filter) counts some domains' zeros as taps."""
    x = _sig(seed=4)
    got = tm.order_filter(dt.from_numpy(x), domain, rank).numpy()
    assert np.array_equal(got, jm.order_filter(dsc_tpu.from_numpy(x), domain, rank).numpy())
    assert np.array_equal(got, sps.order_filter(x[None], domain[None], rank)[0])
    # a Tensor domain (the port's Tensor converts; the JAX package's raises)
    assert np.array_equal(tm.order_filter(dt.from_numpy(x), dt.from_numpy(
        domain.astype(np.float32)), rank).numpy(), got)


def test_order_filter_tensor_domain_reference_raises():
    x = _sig(seed=4)
    with pytest.raises(RuntimeError, match='out of bounds'):
        jm.order_filter(dsc_tpu.from_numpy(x), dsc_tpu.from_numpy(np.ones(5, np.float32)), 2)


@pytest.mark.parametrize('k,noise', [(3, None), (5, 0.5), (21, None), (21, 0.8)])
def test_wiener(k, noise):
    x = _sig(seed=k + 10)
    got = tm.wiener(dt.from_numpy(x), k, noise).numpy()
    assert got.dtype == np.float32
    assert _rel(got, jm.wiener(dsc_tpu.from_numpy(x), k, noise).numpy()) <= WIENER_PORT
    ref = sps.wiener(x.astype(np.float64), k, noise)
    assert np.abs(got - ref).max() < 1e-4 * max(np.abs(ref).max(), 1.0)


def test_wiener_float64_and_noise_rounded_to_float32():
    x = _sig(seed=7).astype(np.float64)
    got = tm.wiener(dt.from_numpy(x), 5, 0.1).numpy()
    assert got.dtype == np.float64
    assert _rel(got, jm.wiener(dsc_tpu.from_numpy(x), 5, 0.1).numpy()) <= 1e-12
    assert np.array_equal(got, tm.wiener(dt.from_numpy(x), 5, float(np.float32(0.1))).numpy())
    assert not np.array_equal(got, sps.wiener(x, 5, 0.1))
    assert _rel(got, sps.wiener(x, 5, float(np.float32(0.1)))) <= 1e-12


def test_wiener_2d_input_is_a_batch_of_rows():
    xs = _sig((3, 128), seed=5)
    got = tm.wiener(dt.from_numpy(xs), 3, 0.5).numpy()
    assert _rel(got, jm.wiener(dsc_tpu.from_numpy(xs), 3, 0.5).numpy()) <= WIENER_PORT
    rows = np.stack([sps.wiener(r.astype(np.float64), 3, 0.5) for r in xs])
    assert np.abs(got - rows).max() < 1e-4 * max(np.abs(rows).max(), 1.0)
    # scipy filters the 2-D input as an image with a 3 x 3 window
    assert _rel(got, sps.wiener(xs.astype(np.float64), 3, 0.5)) > 0.1


def test_wiener_mysize_is_one_int():
    x = _sig()
    sps.wiener(x.astype(np.float64), (3,))
    for mod, pkg in ((tm, dt), (jm, dsc_tpu)):
        with pytest.raises(TypeError):
            mod.wiener(pkg.from_numpy(x), (3,))


NONLINEAR_ERRORS = [('medfilt', ((501,),), {'kernel_size': 4}),
                    ('medfilt', ((2, 3, 4),), {}), ('medfilt', ((8,), np.complex64), {}),
                    ('wiener', ((501,),), {'mysize': 0}), ('wiener', ((2, 3, 4),), {}),
                    ('medfilt2d', ((8,),), {}), ('medfilt2d', ((8, 8), np.complex64), {}),
                    ('medfilt2d', ((8, 8),), {'kernel_size': (3, 4)}),
                    ('order_filter', ((8,), np.complex64, np.ones(3), 0), {}),
                    ('order_filter', ((8, 8), np.float32, np.ones(3), 0), {}),
                    ('order_filter', ((8,), np.float32, np.ones(4), 0), {}),
                    ('order_filter', ((8,), np.float32, np.zeros(3), 0), {}),
                    ('order_filter', ((8,), np.float32, np.ones(3), 3), {})]


@pytest.mark.parametrize('name,args,kw', NONLINEAR_ERRORS,
                         ids=[f'{e[0]}-{i}' for i, e in enumerate(NONLINEAR_ERRORS)])
def test_nonlinear_error_text_equals_the_reference(name, args, kw):
    shape, *rest = args
    dtype = rest.pop(0) if rest and isinstance(rest[0], type) else np.float32
    x = np.ones(shape, dtype)
    assert _error_text(getattr(tm, name), dt.from_numpy(x), *rest, **kw) == \
        _error_text(getattr(jm, name), dsc_tpu.from_numpy(x), *rest, **kw)


def test_filters_under_compile():
    x = _sig((2, 512), seed=8)
    xt = dt.from_numpy(x)

    def chain(s):
        return dt.add(tm.medfilt(s, 5), tm.wiener(s, 7))

    def image(s):
        return tm.order_filter(tm.medfilt2d(s, 3), CROSS, 1)

    for fn in (chain, image):
        compiled = dt.compile(fn)
        want = fn(xt).numpy()
        for _ in range(2):
            assert np.array_equal(compiled(xt).numpy(), want)


# ---------------------------------------------------------- the slice

def test_signal_chain_against_the_reference_and_scipy():
    """chirp + seeded noise -> an elliptic design (iirdesign) -> sosfilt ->
    medfilt(5) -> welch(1024), on both packages and as scipy float64 stages
    applied to the port's previous stage."""
    n = 2**14
    t = np.arange(n) / 8000.0
    noise = 0.1 * _sig(n, seed=9)
    sos = tm.iirdesign(0.2, 0.3, 1.0, 60.0, ftype='ellip')
    x = tm.chirp(dt.from_numpy(t), 50.0, t[-1], 1500.0) + dt.from_numpy(noise)
    xj = jm.chirp(dsc_tpu.from_numpy(t), 50.0, t[-1], 1500.0) + dsc_tpu.from_numpy(noise)
    assert _rel(x.numpy(), xj.numpy()) <= F32_PORT
    y, yj = tm.sosfilt(sos, x), jm.sosfilt(sos, xj)
    y64 = y.numpy().astype(np.float64)
    assert _rel(y64, sps.sosfilt(sos, x.numpy().astype(np.float64))) <= 1e-4
    z, zj = tm.medfilt(y, 5), jm.medfilt(yj, 5)
    assert np.array_equal(z.numpy(), sps.medfilt(y64, 5))
    f, p = tm.welch(z, nperseg=1024)
    fj, pj = jm.welch(zj, nperseg=1024)
    f_ref, p_ref = sps.welch(z.numpy().astype(np.float64), nperseg=1024)
    assert np.allclose(np.asarray(f), f_ref)
    assert _rel(p.numpy(), p_ref) <= 1e-4
    # the whole chain against the JAX package's (sosfilt's float32 products
    # add in another order, and medfilt passes their ulps on)
    assert _rel(p.numpy(), pj.numpy()) <= 1e-5
    assert np.allclose(np.asarray(f), fj.numpy())
