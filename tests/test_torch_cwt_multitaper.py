"""The CWT family (models/cwt.py) and the multitaper and Lomb-Scargle
estimators (models/multitaper.py) of dsc_tpu_torch against dsc_tpu.models
and scipy.signal / float64 NumPy on the same inputs, on the CPU: ricker,
morlet2, cwt (one case at the smallest transform size whose rows stream,
with the JAX package's K6/K7 in interpret mode), find_peaks_cwt, the DPSS
tapers and concentration ratios field by field, multitaper in every
weighting, batched, and lombscargle (a frequency count that is no multiple
of the tile, normalized and precentered). Port results are held to
dsc_tpu within 1e-5 of the largest value and to the float64 references
within the JAX package's tolerances (tests/test_cwt.py,
tests/test_multitaper.py)."""

import gc
import importlib

import numpy as np
import pytest
import scipy.signal as sps
from scipy.signal._peak_finding import _cwt as sp_cwt
from scipy.signal._peak_finding import _ricker as sp_ricker

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
from dsc_tpu.fourier import config as jconfig  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402
from dsc_tpu_torch.fourier import core, stream  # noqa: E402

# the modules by name: the packages' attribute ``multitaper`` is the function
jmt = importlib.import_module('dsc_tpu.models.multitaper')
tmt = importlib.import_module('dsc_tpu_torch.models.multitaper')

PORT_BOUND = 1e-5  # against dsc_tpu, relative to the largest value


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _rel(got, ref):
    got = got.numpy() if hasattr(got, 'numpy') else np.asarray(got)
    ref = ref.numpy() if hasattr(ref, 'numpy') else np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_ricker_and_morlet2():
    for m, a in [(100, 7.0), (55, 3.5), (10, 1.0)]:
        np.testing.assert_array_equal(tm.ricker(m, a), jm.ricker(m, a))
        assert np.allclose(tm.ricker(m, a), sp_ricker(m, a))
    np.testing.assert_array_equal(tm.morlet2(201, 20.0), jm.morlet2(201, 20.0))


def test_cwt():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 600)
    x = (np.sin(2 * np.pi * 7 * t) + 0.3 * rng.standard_normal(600)).astype(np.float32)
    widths = np.arange(1, 31)
    got = tm.cwt(dt.from_numpy(x), tm.ricker, widths)
    assert _rel(got, jm.cwt(dsc_tpu.from_numpy(x), jm.ricker, widths)) < PORT_BOUND
    assert _rel(got, sp_cwt(x.astype(np.float64), sp_ricker, widths)) < 1e-5
    # a host array in, as scipy takes it
    assert _rel(tm.cwt(x, tm.ricker, widths), got) == 0.0
    with pytest.raises(RuntimeError, match='complex wavelets'):
        tm.cwt(dt.from_numpy(x), tm.morlet2, widths)


def test_cwt_streaming_rows(monkeypatch):
    """n = 2^16 with widths 2 and 4: fft_n = 2^17, the smallest transform
    whose rows stream. The kernel stack's rfft and the irfft of its two
    rows take K6 + K7 (the irfft after the plain reconstruction); the one
    signal row is under the streaming batch rule and rides the plain
    four-step. The JAX side runs its K6/K7 in interpret mode."""
    n, widths = 2**16, [2.0, 4.0]
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    assert not core.config.core_streams(1, 2**17, True)
    assert core.config.core_streams(2, 2**17, True)
    calls = []
    fourstep = stream.fourstep_stream

    def spy(rows, n1, n2, inverse, real_output=False):
        calls.append((tuple(rows.shape), rows.dtype, inverse))
        return fourstep(rows, n1, n2, inverse, real_output=real_output)

    monkeypatch.setattr(stream, 'fourstep_stream', spy)
    got = tm.cwt(dt.from_numpy(x), tm.ricker, widths)
    assert calls == [((2, 2**17), torch.float32, False), ((2, 2**17), torch.complex64, True)]
    monkeypatch.setattr(jconfig, 'STREAM_MODE', 'on')
    ref = jm.cwt(dsc_tpu.from_numpy(x), jm.ricker, widths)
    assert _rel(got, ref) < PORT_BOUND
    assert _rel(got, sp_cwt(x.astype(np.float64), sp_ricker, widths)) < 1e-5


def _peaks_signal(seed, n=500):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    sig = np.zeros(n)
    for _ in range(int(rng.integers(2, 6))):
        c, w, a = rng.uniform(0.1, 0.9), rng.uniform(0.01, 0.05), rng.uniform(0.5, 2.0)
        sig += a * np.exp(-((t - c) / w) ** 2)
    return (sig + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize('seed', range(3))
def test_find_peaks_cwt(seed):
    sig = _peaks_signal(seed)
    widths = np.arange(1, 20)
    got = tm.find_peaks_cwt(sig, widths)
    np.testing.assert_array_equal(got, jm.find_peaks_cwt(sig, widths))
    np.testing.assert_array_equal(got, sps.find_peaks_cwt(sig.astype(np.float64), widths))
    if seed == 0:
        for kw in [dict(min_snr=2.0), dict(noise_perc=25), dict(min_length=10),
                   dict(gap_thresh=3.0)]:
            np.testing.assert_array_equal(tm.find_peaks_cwt(sig, widths, **kw),
                                          sps.find_peaks_cwt(sig.astype(np.float64), widths,
                                                             **kw))
        with pytest.raises(RuntimeError, match='positive'):
            tm.find_peaks_cwt(sig, [-1.0])


def _sig(n, fs, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    return (np.sin(2 * np.pi * 60.0 * t) + 0.5 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize('n,nw,k', [(1024, 4.0, 7), (512, 3.0, 4)])
def test_dpss_and_ratios(n, nw, k):
    tapers, ratios = tmt._dpss_and_ratios(n, nw, k)
    jt, jr = jmt._dpss_and_ratios(n, nw, k)
    np.testing.assert_allclose(tapers, jt, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ratios, jr, atol=1e-6, rtol=0)
    st, sr = sps.windows.dpss(n, nw, k, return_ratios=True)
    np.testing.assert_allclose(ratios, sr, atol=1e-6)


@pytest.mark.parametrize('weighting', ['unity', 'eigen', 'adaptive'])
def test_multitaper(weighting):
    n, fs, k = 1024, 500.0, 7
    x = _sig(n, fs)
    f, got = tm.multitaper(dt.from_numpy(x), fs=fs, nw=4.0, k=k, weighting=weighting)
    jf, ref = jm.multitaper(dsc_tpu.from_numpy(x), fs=fs, nw=4.0, k=k, weighting=weighting)
    assert _rel(f, jf) == 0.0 and _rel(got, ref) < PORT_BOUND
    assert np.allclose(f.numpy(), np.fft.rfftfreq(n, 1 / fs))
    if weighting == 'adaptive':
        # Parseval: the one-sided power integrates to the variance
        assert abs(got.numpy().sum() * fs / n / np.var(x) - 1.0) < 0.05
        return
    tapers, lam = sps.windows.dpss(n, 4.0, k, return_ratios=True)
    s = np.abs(np.fft.rfft(tapers * x[None, :].astype(np.float64), axis=-1)) ** 2
    p64 = s.mean(axis=0) if weighting == 'unity' else ((lam / lam.sum())[:, None] * s).sum(0)
    p64 = p64 / fs
    p64[1:-1] *= 2.0
    assert _rel(got, p64) < 1e-5


def test_multitaper_batched_and_errors():
    n, fs = 512, 100.0
    xb = np.stack([_sig(n, fs, s) for s in range(3)])
    _, p = tm.multitaper(dt.from_numpy(xb), fs=fs, nw=3.0, k=4, weighting='unity')
    _, jp = jm.multitaper(dsc_tpu.from_numpy(xb), fs=fs, nw=3.0, k=4, weighting='unity')
    assert p.shape == (3, n // 2 + 1) and _rel(p, jp) < PORT_BOUND
    _, p1 = tm.multitaper(dt.from_numpy(xb[1]), fs=fs, nw=3.0, k=4, weighting='unity')
    assert np.allclose(p.numpy()[1], p1.numpy(), rtol=1e-5, atol=1e-8)
    with pytest.raises(RuntimeError, match='not a power of two'):
        tm.multitaper(dt.from_numpy(_sig(1000, fs)))
    with pytest.raises(RuntimeError, match='unknown weighting'):
        tm.multitaper(dt.from_numpy(xb[0]), weighting='bogus')
    with pytest.raises(RuntimeError, match='k \\(600\\)'):
        tm.multitaper(dt.from_numpy(xb[0]), k=600)


@pytest.mark.parametrize('n,nf,kw', [(700, 1000, {}),
                                     (700, 1000, dict(precenter=True, normalize=True)),
                                     (129, 777, {})], ids=['plain', 'normalized', 'ragged'])
def test_lombscargle(n, nf, kw):
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0.0, 10.0, n))
    y = np.cos(2 * np.pi * 3.0 * t) + 0.4 * rng.standard_normal(n)
    freqs = np.linspace(0.5, 40.0, nf) * 2 * np.pi
    got = tm.lombscargle(dt.from_numpy(t), dt.from_numpy(y), dt.from_numpy(freqs), **kw)
    ref = jm.lombscargle(dsc_tpu.from_numpy(t), dsc_tpu.from_numpy(y),
                         dsc_tpu.from_numpy(freqs), **kw)
    assert got.dtype == dt.Dtype.F32 and _rel(got, ref) < PORT_BOUND
    y64 = y - y.mean() if kw.get('precenter') else y
    p64 = sps.lombscargle(t, y64, freqs, normalize=kw.get('normalize', False))
    assert _rel(got, p64) < 1e-6
    with pytest.raises(RuntimeError, match='must match'):
        tm.lombscargle(dt.from_numpy(t), dt.from_numpy(y[:-1]), dt.from_numpy(freqs))
