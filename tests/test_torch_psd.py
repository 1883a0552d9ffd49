"""The PSD estimators of dsc_tpu_torch (models/psd.py) against
dsc_tpu.models and scipy.signal in float64 on the same inputs, on the CPU:
welch (windows, scalings, every detrend mode, the median average at an
even and an odd segment count, batched), periodogram, csd, coherence,
psd_spectrogram in its three modes, detrend, the shared helpers
(_spectral_window, _median_bias, _detrend_segs) and the argument errors.
Each port result is held to dsc_tpu within 1e-5 of the largest value and
to scipy within the JAX package's tolerances (tests/test_psd_fir.py)."""

import gc

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu.models.psd as jpsd  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402
from dsc_tpu_torch.fourier import base_fft  # noqa: E402
from dsc_tpu_torch.models import psd as tpsd  # noqa: E402

PORT_BOUND = 1e-5  # against dsc_tpu, relative to the largest value


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


def _sig(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 1000.0
    x = np.sin(2 * np.pi * 97.0 * t) + 0.5 * rng.standard_normal(n)
    return x.astype(np.float32)


def _np(v):
    return v.numpy() if hasattr(v, 'numpy') else np.asarray(v)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _both(*arrays):
    return [dt.from_numpy(a) for a in arrays], [dsc_tpu.from_numpy(a) for a in arrays]


X = _sig(4096, 0)
XB = np.stack([_sig(4096, s) for s in (1, 2, 3)])
TREND = _sig(4096, 3) + np.linspace(0, 50, 4096, dtype=np.float32)


@pytest.mark.parametrize('kw,sig,tol', [
    (dict(nperseg=256), X, 2e-4),
    (dict(nperseg=128, noverlap=32, window='hamming', scaling='spectrum', fs=8.0), X, 2e-4),
    (dict(nperseg=256, window=None), XB, 2e-4),
    (dict(nperseg=64, window=('kaiser', 6.0), fs=1000.0), XB, 2e-4),
    (dict(nperseg=256, detrend='constant'), TREND, 5e-4),
    (dict(nperseg=256, detrend='linear'), TREND, 5e-4),
    (dict(nperseg=256, detrend=False), TREND, 5e-4),
    # median: 31 segments (odd) and 16 (even: the mean of the middle two)
    (dict(nperseg=256, average='median'), X, 2e-4),
    (dict(nperseg=256, noverlap=0, average='median'), X, 2e-4),
    (dict(nperseg=256, noverlap=0, average='median'), XB, 2e-4),
])
def test_welch(kw, sig, tol):
    (tx,), (jx,) = _both(sig)
    f, got = tm.welch(tx, **kw)
    jf, ref = jm.welch(jx, **kw)
    assert _rel(f, jf) == 0.0
    assert _rel(got, ref) < PORT_BOUND
    skw = dict(kw, window='boxcar') if 'window' in kw and kw['window'] is None else kw
    f64, p64 = sps.welch(sig.astype(np.float64), axis=-1, **skw)
    np.testing.assert_allclose(f.numpy(), f64, rtol=1e-6)
    assert _rel(got, p64) < tol


def test_median_helper_even_and_odd():
    p = torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 9.0, 7.0, 1.0]]).T
    np.testing.assert_array_equal(tpsd._median(p, 0).numpy(), [2.5, 6.0])
    np.testing.assert_array_equal(tpsd._median(p[:3], 0).numpy(), [3.0, 7.0])


@pytest.mark.parametrize('window', ['hann', ('tukey', 0.25), 'hamming', 6.0, None])
def test_spectral_window_and_median_bias(window):
    got, ref = tpsd._spectral_window(window, 256), jpsd._spectral_window(window, 256)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    for n in (1, 2, 15, 16, 8191):
        assert abs(tpsd._median_bias(n) - jpsd._median_bias(n)) < 1e-6


@pytest.mark.parametrize('mode', ['constant', 'linear', 'none'])
def test_detrend_segs(mode):
    segs = np.random.default_rng(4).standard_normal((2, 5, 64)).astype(np.float32)
    segs += np.linspace(0, 9, 64, dtype=np.float32)
    got = tpsd._detrend_segs(torch.from_numpy(segs), 64, mode)
    ref = np.asarray(jpsd._detrend_segs(segs, 64, mode))
    assert _rel(got, ref) < PORT_BOUND


@pytest.mark.parametrize('kind', ['constant', 'linear'])
def test_detrend(kind):
    for sig in (TREND, XB):
        (tx,), (jx,) = _both(sig)
        got = tm.detrend(tx, type=kind)
        assert _rel(got, jm.detrend(jx, type=kind)) < PORT_BOUND
        ref = sps.detrend(sig.astype(np.float64), type=kind, axis=-1)
        assert np.abs(got.numpy() - ref).max() < 1e-3


@pytest.mark.parametrize('sig', [X, XB], ids=['1d', 'batched'])
def test_periodogram(sig):
    (tx,), (jx,) = _both(sig)
    f, got = tm.periodogram(tx, fs=100.0)
    jf, ref = jm.periodogram(jx, fs=100.0)
    assert _rel(f, jf) == 0.0 and _rel(got, ref) < PORT_BOUND
    _, p64 = sps.periodogram(sig.astype(np.float64), fs=100.0, axis=-1)
    assert _rel(got, p64) < 2e-4


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = (0.7 * x + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    return x, np.roll(y, 3, axis=-1)


@pytest.mark.parametrize('shape', [4096, (2, 4096)], ids=['1d', 'batched'])
def test_csd_and_coherence(shape):
    x, y = _pair(shape, 5)
    (tx, ty), (jx, jy) = _both(x, y)
    f, got = tm.csd(tx, ty, fs=10.0, nperseg=256)
    jf, ref = jm.csd(jx, jy, fs=10.0, nperseg=256)
    assert got.dtype == dt.Dtype.C32 and _rel(f, jf) == 0.0
    assert _rel(got, ref) < PORT_BOUND
    _, p64 = sps.csd(x.astype(np.float64), y.astype(np.float64), fs=10.0, nperseg=256, axis=-1)
    assert _rel(got, p64) < 2e-4
    _, c = tm.coherence(tx, ty, nperseg=256)
    assert _rel(c, jm.coherence(jx, jy, nperseg=256)[1]) < PORT_BOUND
    _, c64 = sps.coherence(x.astype(np.float64), y.astype(np.float64), nperseg=256, axis=-1)
    assert np.abs(c.numpy() - c64).max() < 5e-4
    # welch(x) == csd(x, x).real
    _, pxx = tm.welch(tx, fs=10.0, nperseg=256)
    _, pz = tm.csd(tx, tx, fs=10.0, nperseg=256)
    # (the bound of tests/test_psd_fir.py::test_csd_of_self_is_welch)
    assert _rel(pz.numpy().real, pxx) < 1e-6
    assert np.abs(pz.numpy().imag).max() < 1e-6 * pxx.numpy().max()


@pytest.mark.parametrize('mode', ['psd', 'magnitude', 'complex'])
def test_psd_spectrogram(mode):
    for sig in (X, XB[:2]):
        (tx,), (jx,) = _both(sig)
        f, t, got = tm.psd_spectrogram(tx, fs=50.0, nperseg=128, mode=mode)
        jf, jt, ref = jm.psd_spectrogram(jx, fs=50.0, nperseg=128, mode=mode)
        assert _rel(f, jf) == 0.0 and _rel(t, jt) == 0.0
        assert _rel(got, ref) < PORT_BOUND
        f64, t64, s64 = sps.spectrogram(sig.astype(np.float64), fs=50.0, nperseg=128,
                                        mode=mode, axis=-1)
        np.testing.assert_allclose(t.numpy(), t64, rtol=1e-6)
        assert _rel(got, s64) < 5e-4


def test_welch_segments_ride_k12(monkeypatch):
    """nperseg = 1024: one batched rfft, whose 512-point half-size rows are
    one call of K12r's wrapper (the base-case kernel with the untangle in
    its store) for all segments."""
    calls = []
    rfft_base = base_fft.rfft_base

    def spy(x, w, wu):
        calls.append(tuple(x.shape))
        return rfft_base(x, w, wu)

    monkeypatch.setattr(base_fft, 'rfft_base', spy)
    tm.welch(dt.from_numpy(_sig(2**14, 6)), nperseg=1024)
    x, y = _pair((2, 2**13), 7)
    tm.csd(dt.from_numpy(x), dt.from_numpy(y), nperseg=1024)
    assert calls == [(31, 1024), (2 * 2 * 15, 1024)]


def test_errors():
    tx = dt.from_numpy(X)
    with pytest.raises(RuntimeError, match='not a power of two'):
        tm.welch(tx, nperseg=100)
    with pytest.raises(RuntimeError, match='shorter than nperseg'):
        tm.welch(dt.from_numpy(X[:100]), nperseg=256)
    with pytest.raises(RuntimeError, match='noverlap'):
        tm.welch(tx, nperseg=256, noverlap=256)
    with pytest.raises(RuntimeError, match='unknown average'):
        tm.welch(tx, average='max')
    with pytest.raises(RuntimeError, match='unknown detrend'):
        tm.welch(tx, detrend='quadratic')
    with pytest.raises(RuntimeError, match='unknown scaling'):
        tm.welch(tx, scaling='power')
    with pytest.raises(RuntimeError, match='same shape'):
        tm.csd(tx, dt.from_numpy(X[:2048]))
    with pytest.raises(RuntimeError, match='expects a real signal'):
        tm.welch(dt.from_numpy(X.astype(np.complex64)))
    with pytest.raises(RuntimeError, match='unknown mode'):
        tm.psd_spectrogram(tx, mode='angle')
    with pytest.raises(RuntimeError, match='unknown type'):
        tm.detrend(tx, type='none')
