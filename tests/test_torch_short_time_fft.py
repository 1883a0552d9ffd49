"""The ShortTimeFFT class of dsc_tpu_torch (models/short_time_fft.py)
against dsc_tpu.models.ShortTimeFFT and scipy.signal.ShortTimeFFT on the
same inputs, on the CPU: the host geometry field by field, the derived
windows (dual_win, scaled win) within 1e-6, every fft_mode, scaling and
phase shift, a non-power-of-two mfft (the chirp-z route) forward and back,
a two-sided complex input and a complex window, the padding modes, the
device and host (callable) detrenders, batched input over any axis, the
spectrogram and cross-spectrogram, istft with its k0/k1 slicing, the
alternate constructors and the validation errors. Port results are held
to dsc_tpu within 1e-5 of the largest value and to scipy within the JAX
package's tolerances (tests/test_short_time_fft.py)."""

import gc

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402

PORT_BOUND = 1e-5  # against dsc_tpu, relative to the largest value


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _sig(n=801, seed=3, cplx=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if cplx:
        x = x + 1j * rng.standard_normal(n)
    return x.astype(np.complex64 if cplx else np.float32)


def _three(win, hop, fs, **kw):
    """(scipy, dsc_tpu, dsc_tpu_torch) instances of one configuration."""
    w = np.asarray(win)
    return (sps.ShortTimeFFT(w, hop, fs, **kw), jm.ShortTimeFFT(w, hop, fs, **kw),
            tm.ShortTimeFFT(w, hop, fs, **kw))


def _np(v):
    return v.numpy() if hasattr(v, 'numpy') else np.asarray(v)


def _close(ours, ref, tol=2e-4):
    """The JAX package's scipy bound: tol times max(1, the largest value)."""
    got, ref = _np(ours), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.max(np.abs(got - ref)) < tol * max(1.0, float(np.max(np.abs(ref))))


def _same(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= PORT_BOUND * max(np.abs(ref).max(), 1e-30)


GEOM_CASES = [
    dict(m=64, hop=16),
    dict(m=63, hop=17),
    dict(m=48, hop=48),
    dict(m=33, hop=5, mfft=64),
    dict(m=40, hop=8, mfft=50),
]


@pytest.mark.parametrize('case', GEOM_CASES, ids=str)
def test_geometry_field_by_field(case):
    win = sps.windows.gaussian(case['m'], std=case['m'] / 6, sym=True)
    kw = {'mfft': case['mfft']} if 'mfft' in case else {}
    ref, jx, ours = _three(win, case['hop'], 8.0, **kw)
    n = 5 * case['m'] + 3
    for other in (ref, jx):
        for name in ('m_num', 'm_num_mid', 'k_min', 'p_min', 'lower_border_end', 'delta_t',
                     'delta_f', 'f_pts', 'invertible'):
            assert getattr(ours, name) == getattr(other, name), name
        for name in ('k_max', 'p_max', 'p_num', 'upper_border_begin', 'p_range', 'extent'):
            assert getattr(ours, name)(n) == getattr(other, name)(n), name
        assert ours.extent(n, 'ft', True) == other.extent(n, 'ft', True)
        assert ours.nearest_k_p(37, left=False) == other.nearest_k_p(37, left=False)
        np.testing.assert_allclose(ours.f, other.f)
        np.testing.assert_allclose(ours.t(n, k_offset=7), other.t(n, k_offset=7))
        np.testing.assert_allclose(ours.dual_win, other.dual_win, rtol=1e-12, atol=1e-6)


def test_zero_padded_window_borders():
    win = np.zeros(50)
    win[10:40] = sps.windows.hann(30, sym=True)
    ref, jx, ours = _three(win, 8, 1.0)
    for other in (ref, jx):
        assert (ours.k_min, ours.p_min, ours.lower_border_end) == \
            (other.k_min, other.p_min, other.lower_border_end)
        assert (ours.k_max(200), ours.p_max(200), ours.upper_border_begin(200)) == \
            (other.k_max(200), other.p_max(200), other.upper_border_begin(200))


STFT_CASES = [
    dict(),
    dict(fft_mode='twosided'),
    dict(fft_mode='centered'),
    dict(fft_mode='onesided2X', scale_to='psd'),
    dict(fft_mode='onesided2X', scale_to='magnitude', mfft=128),
    dict(phase_shift=None),
    dict(phase_shift=-3),
    dict(mfft=100),  # not a power of two: the chirp-z route
    dict(mfft=77, fft_mode='twosided'),
]


@pytest.mark.parametrize('kw', STFT_CASES, ids=str)
def test_stft(kw):
    ref, jx, ours = _three(sps.windows.hann(64, sym=True), 16, 500.0, **kw)
    x = _sig(777)
    got = ours.stft(x)
    assert got.dtype == dt.Dtype.C32
    _same(got, jx.stft(x))
    _close(got, ref.stft(x.astype(np.float64)))


@pytest.mark.parametrize('padding', ['zeros', 'edge', 'even', 'odd'])
def test_stft_padding_modes(padding):
    ref, jx, ours = _three(sps.windows.hamming(48, sym=True), 12, 1.0)
    x = _sig(301, seed=9)
    got = ours.stft(x, padding=padding)
    _same(got, jx.stft(x, padding=padding))
    _close(got, ref.stft(x.astype(np.float64), padding=padding))


def test_stft_slice_range_and_k_offset():
    ref, jx, ours = _three(sps.windows.hann(32, sym=True), 8, 2.0)
    x = _sig(260, seed=5)
    got = ours.stft(x, p0=2, p1=20, k_offset=16)
    _same(got, jx.stft(x, p0=2, p1=20, k_offset=16))
    _close(got, ref.stft(x.astype(np.float64), p0=2, p1=20, k_offset=16))


def test_stft_detrend_modes():
    ref, jx, ours = _three(sps.windows.hann(64, sym=True), 32, 1.0)
    x = (_sig(600, seed=1) + np.linspace(0, 4, 600)).astype(np.float32)
    fn = lambda seg: seg - np.mean(seg, axis=-1, keepdims=True)  # noqa: E731
    for detr in ('constant', 'linear', fn):
        got = ours.stft_detrend(x, detr)
        _same(got, jx.stft_detrend(x, detr))
        _close(got, ref.stft_detrend(x.astype(np.float64), detr))


@pytest.mark.parametrize('mode', ['twosided', 'centered'])
def test_stft_complex_input_twosided(mode):
    ref, jx, ours = _three(sps.windows.hann(32, sym=True), 8, 1.0, fft_mode=mode)
    x = _sig(300, seed=2, cplx=True)
    got = ours.stft(x)
    _same(got, jx.stft(x))
    _close(got, ref.stft(x.astype(np.complex128)))
    with pytest.raises(ValueError, match='Complex-valued x not allowed'):
        tm.ShortTimeFFT(sps.windows.hann(32, sym=True), 8, 1.0).stft(x)


def test_stft_batched_and_axis():
    ref, jx, ours = _three(sps.windows.hann(32, sym=True), 16, 1.0)
    x = np.stack([_sig(300, seed=s) for s in range(3)])
    for xs, axis in ((x, -1), (x.T, 0)):
        got = ours.stft(xs, axis=axis)
        _same(got, jx.stft(xs, axis=axis))
        _close(got, ref.stft(xs.astype(np.float64), axis=axis))


def test_spectrogram_and_cross():
    ref, jx, ours = _three(sps.windows.hann(64, sym=True), 16, 1.0)
    x, y = _sig(500, seed=4), _sig(500, seed=7)
    got = ours.spectrogram(x)
    assert got.dtype == dt.Dtype.F32
    _same(got, jx.spectrogram(x))
    _close(got, ref.spectrogram(x.astype(np.float64)))
    got = ours.spectrogram(x, y)
    _same(got, jx.spectrogram(x, y))
    _close(got, ref.spectrogram(x.astype(np.float64), y.astype(np.float64)))


ISTFT_CASES = [
    dict(),
    dict(fft_mode='centered'),
    dict(fft_mode='onesided2X', scale_to='psd'),
    dict(phase_shift=4),
    dict(mfft=80),  # the chirp-z inverse
    dict(mfft=81, fft_mode='twosided'),
]


@pytest.mark.parametrize('kw', ISTFT_CASES, ids=str)
def test_istft_round_trip(kw):
    ref, jx, ours = _three(sps.windows.hann(48, sym=True), 12, 1.0, **kw)
    x = _sig(400, seed=11)
    s = ours.stft(x)
    got = ours.istft(s)
    _same(got, jx.istft(jx.stft(x)))
    _close(got, ref.istft(ref.stft(x.astype(np.float64))), tol=5e-4)
    back = ours.istft(s, k1=len(x)).numpy()
    assert np.max(np.abs(back - x)) < 5e-4


def test_istft_k0_k1_and_batched():
    ref, jx, ours = _three(sps.windows.hann(32, sym=True), 8, 1.0)
    x = _sig(300, seed=13)
    s, js, s_ref = ours.stft(x), jx.stft(x), ref.stft(x.astype(np.float64))
    for k0, k1 in [(0, 300), (40, 200), (16, None)]:
        got = ours.istft(s, k0=k0, k1=k1)
        _same(got, jx.istft(js, k0=k0, k1=k1))
        _close(got, ref.istft(s_ref, k0=k0, k1=k1), tol=5e-4)
    xb = np.stack([_sig(260, seed=q) for q in range(2)])
    got = ours.istft(ours.stft(xb))
    _same(got, jx.istft(jx.stft(xb)))
    _close(got, ref.istft(ref.stft(xb.astype(np.float64))), tol=5e-4)
    # the frequency axis first: istft puts the time axis where it was
    sb = ours.stft(xb)
    st = dt.from_numpy(np.ascontiguousarray(np.moveaxis(sb.numpy(), 0, -1)))
    _close(ours.istft(st, f_axis=0, t_axis=1), ref.istft(
        np.moveaxis(ref.stft(xb.astype(np.float64)), 0, -1), f_axis=0, t_axis=1), tol=5e-4)


def test_complex_window_twosided():
    win = sps.windows.hann(32, sym=True) * np.exp(1j * np.linspace(0, np.pi, 32))
    ref, jx, ours = _three(win, 8, 1.0, fft_mode='twosided')
    with pytest.raises(ValueError, match='One-sided spectra'):
        tm.ShortTimeFFT(win, 8, 1.0, fft_mode='onesided')
    x = _sig(200, seed=17)
    got = ours.stft(x)
    _same(got, jx.stft(x))
    _close(got, ref.stft(x.astype(np.float64)))
    back = ours.istft(got)
    _same(back, jx.istft(jx.stft(x)))
    _close(back, ref.istft(ref.stft(x.astype(np.float64))), tol=5e-4)


def test_scaling_and_constructors():
    ref, jx, ours = _three(sps.windows.hann(64, sym=True), 16, 250.0)
    assert np.isclose(ours.fac_magnitude, ref.fac_magnitude)
    assert np.isclose(ours.fac_psd, ref.fac_psd)
    for sft in (ref, jx, ours):
        sft.scale_to('psd')
    np.testing.assert_allclose(ours.win, jx.win, rtol=1e-12)
    np.testing.assert_allclose(ours.dual_win, ref.dual_win, atol=1e-6)
    assert ours.fac_psd == ref.fac_psd == 1
    for args, kw in ((('hann', 100.0, 64, 48), {}),
                     ((('kaiser', 8.0), 1.0, 50, 25), dict(symmetric_win=True))):
        o, r = tm.ShortTimeFFT.from_window(*args, **kw), sps.ShortTimeFFT.from_window(*args, **kw)
        np.testing.assert_allclose(o.win, r.win, rtol=1e-9)
        assert o.hop == r.hop
    dual = sps.windows.gaussian(51, std=8, sym=True)
    o, r = tm.ShortTimeFFT.from_dual(dual, 10, 1.0), sps.ShortTimeFFT.from_dual(dual, 10, 1.0)
    np.testing.assert_allclose(o.win, r.win, rtol=1e-12)
    np.testing.assert_allclose(o.dual_win, r.dual_win, rtol=1e-12)
    desired = sps.windows.hann(48, sym=True) + 0.1
    for scale in (None, 'magnitude', 'psd', 'unitary'):
        o = tm.ShortTimeFFT.from_win_equals_dual(desired, 12, 1.0, scale_to=scale)
        r = sps.ShortTimeFFT.from_win_equals_dual(desired, 12, 1.0, scale_to=scale)
        np.testing.assert_allclose(o.win, r.win, rtol=1e-12)
        np.testing.assert_allclose(o.dual_win, r.dual_win, rtol=1e-12)
        assert o.scaling == r.scaling


def test_setters_and_validation():
    win = sps.windows.hann(32, sym=True)
    sft = tm.ShortTimeFFT(win, 8, 4.0)
    assert sft.T == 0.25
    sft.T = 0.5
    assert sft.fs == 2.0
    for attr, value in (('fs', -1), ('T', 0), ('mfft', 16), ('fft_mode', 'bogus'),
                        ('fft_mode', 'onesided2X'), ('phase_shift', 99),
                        ('phase_shift', 1.5)):
        with pytest.raises(ValueError):
            setattr(sft, attr, value)
    for args in ((win, 0, 1.0), (np.ones((4, 4)), 2, 1.0), (win * np.nan, 2, 1.0)):
        with pytest.raises(ValueError):
            tm.ShortTimeFFT(*args)
    with pytest.raises(ValueError, match='Invalid Parameter'):
        sft.stft(_sig(200), p0=-99, p1=1)
    with pytest.raises(ValueError, match='padding'):
        sft.stft(_sig(200), padding='wrap')
    gap = np.zeros(32)
    gap[:8] = 1.0  # hop 16 leaves samples no window covers
    o = tm.ShortTimeFFT(gap, 16, 1.0)
    assert o.invertible is False
    with pytest.raises(ValueError, match='not invertible'):
        _ = o.dual_win
