"""The FFT-domain utilities (models/spectral.py) and FIR design
(models/fir.py) of dsc_tpu_torch against dsc_tpu.models and scipy.signal /
float64 NumPy on the same inputs, on the CPU: resample (down, up, same,
batched), upfirdn, resample_poly, hilbert, hilbert2, envelope, the
messages of _check_signal; firwin (every band shape and window form),
firwin2, kaiser_beta/kaiser_atten/kaiserord, savgol_coeffs and
savgol_filter, minimum_phase, firls, gammatone and firwin_2d. Port results
are held to dsc_tpu within 1e-5 of the largest value and to the float64
references within the JAX package's tolerances (tests/test_models.py,
tests/test_psd_fir.py, tests/test_iir.py, tests/test_envelope.py,
tests/test_convolve_firls.py, tests/test_sigutils.py)."""

import gc
import warnings

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402
from dsc_tpu_torch.dtype import Dtype  # noqa: E402

PORT_BOUND = 1e-5  # against dsc_tpu, relative to the largest value


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(v):
    return v.numpy() if hasattr(v, 'numpy') else np.asarray(v)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _both(fn_name, *args, **kw):
    """The port's and dsc_tpu's call of ``fn_name`` on the same numpy
    arguments (arrays become each package's Tensor)."""
    def conv(pkg):
        return [pkg.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]

    return (getattr(tm, fn_name)(*conv(dt), **kw), getattr(jm, fn_name)(*conv(dsc_tpu), **kw))


def _np_resample(x, num):
    """The scipy.signal.resample algorithm on the full spectrum
    (tests/test_models.py::test_resample)."""
    n = x.shape[-1]
    X = np.fft.fft(x.astype(np.float64), axis=-1)
    Y = np.zeros(x.shape[:-1] + (num,), complex)
    N = min(n, num)
    nyq = N // 2
    Y[..., :nyq] = X[..., :nyq]
    Y[..., -(nyq - 1):] = X[..., -(nyq - 1):]
    if num < n:
        Y[..., nyq] = X[..., nyq] + X[..., n - nyq]
    elif num > n:
        Y[..., nyq] = 0.5 * X[..., nyq]
        Y[..., num - nyq] = np.conj(Y[..., nyq])
    else:
        Y[..., nyq] = X[..., nyq]
    return np.fft.ifft(Y, axis=-1).real * (num / n)


@pytest.mark.parametrize('shape,num', [(512, 128), (512, 512), ((3, 256), 64)])
def test_resample(shape, num):
    x = _rand(shape, 11)
    got = tm.resample(dt.from_numpy(x), num)
    if num != 512:  # two cases against dsc_tpu: a compile each
        assert _rel(got, jm.resample(dsc_tpu.from_numpy(x), num)) < PORT_BOUND
    assert np.abs(got.numpy() - _np_resample(x, num)).max() < 1e-4


@pytest.mark.parametrize('up,down', [(1, 1), (3, 1), (1, 4), (3, 2)])
def test_upfirdn(up, down):
    rng = np.random.default_rng(up * 10 + down)
    x = rng.standard_normal(777).astype(np.float32)
    h = rng.standard_normal(31).astype(np.float32)
    got = tm.upfirdn(h, dt.from_numpy(x), up, down)
    if (up, down) == (3, 2):  # one case against dsc_tpu: a compile each
        assert _rel(got, jm.upfirdn(h, dsc_tpu.from_numpy(x), up, down)) < PORT_BOUND
    assert _rel(got, sps.upfirdn(h.astype(np.float64), x.astype(np.float64), up, down)) < 1e-4
    if (up, down) == (3, 2):
        xs = _rand((2, 300), 50)
        got = tm.upfirdn(h[:9], dt.from_numpy(xs), 2, 3)
        ref = sps.upfirdn(h[:9].astype(np.float64), xs.astype(np.float64), 2, 3, axis=-1)
        assert _rel(got, ref) < 1e-4


@pytest.mark.parametrize('n,up,down', [(1000, 3, 2), (999, 7, 5), (512, 5, 1), (1000, 4, 6)])
def test_resample_poly(n, up, down):
    x = _rand(n, n + up + down)
    got = tm.resample_poly(dt.from_numpy(x), up, down)
    if (n, up, down) == (1000, 3, 2):  # one case against dsc_tpu: a compile each
        assert _rel(got, jm.resample_poly(dsc_tpu.from_numpy(x), up, down)) < PORT_BOUND
    r64 = sps.resample_poly(x.astype(np.float64), up, down)
    assert got.shape == r64.shape
    assert np.abs(got.numpy() - r64).max() < 1e-4 * max(np.abs(r64).max(), 1.0)


def test_resample_poly_batched_taps_and_identity():
    xs = _rand((2, 777), 3)
    got, ref = _both('resample_poly', xs, 3, 4)
    assert _rel(got, ref) < PORT_BOUND
    assert _rel(got, sps.resample_poly(xs.astype(np.float64), 3, 4, axis=-1)) < 1e-4
    taps = sps.firwin(41, 0.3)
    got, ref = _both('resample_poly', xs[0], 2, 3, window=taps)
    assert _rel(got, ref) < PORT_BOUND
    assert _rel(got, sps.resample_poly(xs[0].astype(np.float64), 2, 3, window=taps)) < 1e-4
    x1 = dt.from_numpy(xs[0])
    assert tm.resample_poly(x1, 2, 2) is x1
    with pytest.raises(RuntimeError, match='must be >= 1'):
        tm.resample_poly(x1, 0, 1)


def _np_hilbert(x):
    n = x.shape[-1]
    h = np.zeros(n)
    h[0] = h[n // 2] = 1
    h[1:n // 2] = 2
    return np.fft.ifft(np.fft.fft(x.astype(np.float64), axis=-1) * h, axis=-1)


@pytest.mark.parametrize('shape', [1024, (3, 256)], ids=['1d', 'batched'])
def test_hilbert(shape):
    x = _rand(shape, 12)
    got, ref = _both('hilbert', x)
    assert got.dtype == Dtype.C32 and _rel(got, ref) < PORT_BOUND
    assert np.abs(got.numpy() - _np_hilbert(x)).max() < 1e-4
    assert np.array_equal(got.numpy().real, x)


def test_hilbert2():
    x = _rand((64, 128), 2)
    got, ref = _both('hilbert2', x)
    assert got.dtype == Dtype.C32 and _rel(got, ref) < PORT_BOUND
    assert _rel(got, sps.hilbert2(x.astype(np.float64))) < 1e-5
    with pytest.raises(RuntimeError, match='2-D signal'):
        tm.hilbert2(dt.from_numpy(x[0]))
    with pytest.raises(RuntimeError, match='power-of-two sides'):
        tm.hilbert2(dt.from_numpy(np.ones((60, 64), np.float32)))


def test_check_signal_messages():
    for fn, args in ((tm.resample, (128,)), (tm.hilbert, ())):
        name = fn.__name__
        with pytest.raises(RuntimeError, match=f'{name}: length 500 is not a power of two '
                           r'\(the dsc FFT family is power-of-two; pad/crop explicitly '
                           r'first\)'):
            fn(dt.from_numpy(_rand(500, 0)), *args)
        with pytest.raises(RuntimeError, match=f'{name}: expected a 1-D or 2-D signal, '
                           'got 3-D'):
            fn(dt.from_numpy(_rand((2, 2, 8), 0)), *args)
    with pytest.raises(RuntimeError, match=r'num \(100\) must be a power of two'):
        tm.resample(dt.from_numpy(_rand(512, 0)), 100)


def _am(n=500):
    t = np.arange(n) / n
    return (np.cos(2 * np.pi * 30 * t) * (1 + 0.5 * np.cos(2 * np.pi * 3 * t))
            + 0.2 * t).astype(np.float32)


@pytest.mark.parametrize('kw', [dict(), dict(bp_in=(5, 60)), dict(squared=True),
                                dict(residual='all'), dict(residual=None), dict(n_out=250),
                                dict(n_out=1000), dict(bp_in=(None, 50))], ids=str)
def test_envelope(kw):
    x = _am()
    got, ref = _both('envelope', x, **kw)
    assert _rel(got, ref) < PORT_BOUND
    r64 = np.asarray(sps.envelope(x.astype(np.float64), **kw))
    assert got.shape == r64.shape
    assert np.abs(got.numpy() - r64).max() < 1e-5 * max(np.abs(r64).max(), 1e-30)


def test_envelope_batched_and_errors():
    xb = np.stack([_am(), _am()[::-1].copy()])
    got, ref = _both('envelope', xb)
    assert _rel(got, ref) < PORT_BOUND
    assert _rel(got, np.asarray(sps.envelope(xb.astype(np.float64)))) < 1e-5
    with pytest.raises(RuntimeError, match='unknown residual'):
        tm.envelope(dt.from_numpy(_am()), residual='bogus')
    with pytest.raises(RuntimeError, match='invalid bp_in'):
        tm.envelope(dt.from_numpy(_am()), bp_in=(400, 10))


@pytest.mark.parametrize('numtaps,cutoff,kw', [
    (31, 0.3, {}),
    (255, 0.1, dict(window=('kaiser', 5.0))),
    (41, [0.2, 0.5], dict(pass_zero=False)),
    (41, [0.2, 0.5], dict(window='blackman')),
    (33, 0.4, dict(pass_zero=False, window='hann')),
    (30, 100.0, dict(fs=1000.0, window=None)),
    (31, 0.3, dict(scale=False, window=('tukey', 0.5))),
], ids=str)
def test_firwin(numtaps, cutoff, kw):
    got, ref = _both('firwin', numtaps, cutoff, **kw)
    assert _rel(got, ref) < PORT_BOUND
    skw = dict(kw, window='boxcar') if 'window' in kw and kw['window'] is None else kw
    assert np.abs(got.numpy() - sps.firwin(numtaps, cutoff, **skw)).max() < 1e-5
    h64 = tm.firwin(numtaps, cutoff, dtype=Dtype.F64, **kw)
    assert h64.dtype == Dtype.F64


def test_firwin_array_window():
    """An array window: dsc_tpu's ``window in ('rect', 'boxcar')`` raises
    on it (a reference defect); the port takes it as it takes a Tensor."""
    win = np.hanning(31)
    with pytest.raises(ValueError, match='truth value'):
        jm.firwin(31, 0.3, window=win)
    got = tm.firwin(31, 0.3, window=win)
    ref = jm.firwin(31, 0.3, window=dsc_tpu.from_numpy(win.astype(np.float32)))
    assert _rel(got, ref) < PORT_BOUND
    assert _rel(got, tm.firwin(31, 0.3, window=dt.from_numpy(win.astype(np.float32)))) == 0.0
    assert np.abs(got.numpy() - sps.firwin(31, 0.3, window='hann')).max() < 1e-5


def test_firwin_errors():
    with pytest.raises(RuntimeError, match='odd number of taps'):
        tm.firwin(30, 0.3, pass_zero=False)
    with pytest.raises(RuntimeError, match='strictly inside'):
        tm.firwin(31, 1.0)
    with pytest.raises(RuntimeError, match='increasing'):
        tm.firwin(31, [0.5, 0.2])
    with pytest.raises(RuntimeError, match='window has shape'):
        tm.firwin(31, 0.3, window=np.ones(5))


@pytest.mark.parametrize('numtaps,freq,gain', [
    (31, [0, 0.5, 1.0], [1, 1, 0]),
    (64, [0, 0.25, 0.5, 1.0], [0, 1, 1, 0]),
    (45, [0, 0.1, 0.2, 0.6, 1.0], [1, 1, 0.2, 0.2, 1]),
], ids=str)
def test_firwin2(numtaps, freq, gain):
    got, ref = _both('firwin2', numtaps, freq, gain)
    assert _rel(got, ref) < PORT_BOUND
    assert np.abs(got.numpy() - sps.firwin2(numtaps, freq, gain)).max() < 1e-5
    with pytest.raises(RuntimeError, match='start at 0'):
        tm.firwin2(31, [0.1, 1.0], [1, 0])


def test_kaiser_design():
    for a in (10.0, 30.0, 60.0):
        assert tm.kaiser_beta(a) == jm.kaiser_beta(a) == sps.kaiser_beta(a)
    assert tm.kaiser_atten(51, 0.1) == jm.kaiser_atten(51, 0.1)
    assert np.isclose(tm.kaiser_atten(51, 0.1), sps.kaiser_atten(51, 0.1))
    assert tm.kaiserord(65.0, 0.05) == jm.kaiserord(65.0, 0.05) == sps.kaiserord(65.0, 0.05)
    with pytest.raises(RuntimeError, match='too small'):
        tm.kaiserord(5.0, 0.1)


@pytest.mark.parametrize('wl,po,d', [(31, 3, 0), (11, 2, 1), (7, 4, 2), (1, 0, 0)])
def test_savgol(wl, po, d):
    np.testing.assert_array_equal(tm.savgol_coeffs(wl, po, d), jm.savgol_coeffs(wl, po, d))
    assert np.abs(tm.savgol_coeffs(wl, po, d) - sps.savgol_coeffs(wl, po, d)).max() < 1e-12
    x = _rand(1000, wl + po)
    got = tm.savgol_filter(dt.from_numpy(x), wl, po, deriv=d)
    if wl == 31:  # one case against dsc_tpu: a compile each
        assert _rel(got, jm.savgol_filter(dsc_tpu.from_numpy(x), wl, po, deriv=d)) < PORT_BOUND
    r64 = sps.savgol_filter(x.astype(np.float64), wl, po, deriv=d)
    assert np.abs(got.numpy() - r64).max() < 1e-4 * max(np.abs(r64).max(), 1e-9)


def test_savgol_batched_and_errors():
    xs = _rand((2, 300), 4)
    got, ref = _both('savgol_filter', xs, 11, 3)
    assert _rel(got, ref) < PORT_BOUND
    assert np.abs(got.numpy() - sps.savgol_filter(xs.astype(np.float64), 11, 3)).max() < 1e-4
    with pytest.raises(RuntimeError, match='only mode'):
        tm.savgol_filter(dt.from_numpy(xs), 11, 3, mode='nearest')
    with pytest.raises(RuntimeError, match='exceeds the signal length'):
        tm.savgol_filter(dt.from_numpy(xs[:, :5]), 11, 3)
    with pytest.raises(RuntimeError, match='must be odd'):
        tm.savgol_coeffs(10, 3)


def test_minimum_phase():
    h = sps.remez(151, [0, 0.2, 0.3, 1.0], [1, 0], fs=2.0)
    # the discrete Hilbert construction is itself approximate: 1e-4
    # (tests/test_sigutils.py)
    for kw, bound in ((dict(half=True), 1e-10), (dict(half=False), 1e-10),
                      (dict(method='hilbert'), 1e-4)):
        got = tm.minimum_phase(h, **kw)
        np.testing.assert_array_equal(got, jm.minimum_phase(h, **kw))
        assert np.abs(got - sps.minimum_phase(h, **kw)).max() < bound


@pytest.mark.parametrize('args', [
    (31, [0, 0.2, 0.3, 1.0], [1, 1, 0, 0], None),
    (51, [0, 0.3, 0.4, 0.7, 0.8, 1.0], [0, 0, 1, 1, 0, 0], [1.0, 2.0, 0.5]),
], ids=str)
def test_firls(args):
    nt, bands, des, w = args
    got = tm.firls(nt, bands, des, weight=w)
    np.testing.assert_array_equal(got, jm.firls(nt, bands, des, weight=w))
    assert np.abs(got - sps.firls(nt, bands, des, weight=w)).max() < 1e-12
    with pytest.raises(RuntimeError, match='must be odd'):
        tm.firls(30, [0, 0.5, 0.6, 1.0], [1, 1, 0, 0])


def test_gammatone_and_firwin_2d():
    for ft in ('fir', 'iir'):
        for f, fs in [(440.0, 16000.0), (0.3, 2.0)]:
            b1, a1 = tm.gammatone(f, ft, fs=fs)
            jb, ja = jm.gammatone(f, ft, fs=fs)
            np.testing.assert_array_equal(b1, jb)
            np.testing.assert_array_equal(a1, ja)
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                b2, a2 = sps.gammatone(f, ft, fs=fs)
            assert np.allclose(b1, b2, atol=1e-15) and np.allclose(a1, a2, atol=1e-12)
    with pytest.raises(RuntimeError, match='freq must be in'):
        tm.gammatone(3000.0, 'fir', fs=2000.0)
    for args, kw in ((((15, 17), ('hamming', 'hann')), dict(fc=0.3)),
                     (((15, 15), 'hamming'), dict(fc=0.4, circular=True))):
        got = tm.firwin_2d(*args, **kw)
        assert np.abs(got - jm.firwin_2d(*args, **kw)).max() < 1e-6
        assert np.abs(got - sps.firwin_2d(*args, **kw)).max() < 1e-6
    with pytest.raises(RuntimeError, match='fc is required'):
        tm.firwin_2d((15, 17), ('hamming', 'hann'))
