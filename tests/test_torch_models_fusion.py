"""The models that ride the fusion tier, in dsc_tpu_torch against
dsc_tpu.models and NumPy / scipy.signal on the same inputs, on the CPU:
FilterFFT (one dsc.compile program per step, 1-D and batched),
fft_convolve2, correlate2d, correlate, convolve, oaconvolve, convolve2d,
OverlapSave, STFT in its three modes, the ISTFT round trip, spectrogram,
and entry() at a small n. Both packages get the same numpy taps, windows
and signals."""

import gc

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402
from dsc_tpu_torch import fuse  # noqa: E402
from dsc_tpu_torch.entry import entry  # noqa: E402
from dsc_tpu_torch.fourier import base_fft  # noqa: E402

NUMPY_BOUND = 1e-4  # against float64 NumPy, relative to the largest value


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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    got = got.numpy() if hasattr(got, 'numpy') else np.asarray(got)
    ref = np.asarray(ref.numpy() if hasattr(ref, 'numpy') else ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _both(*arrays):
    return [dt.from_numpy(a) for a in arrays], [dsc_tpu.from_numpy(a) for a in arrays]


TAPS = np.blackman(129).astype(np.float32)


def test_filter_fft_1d_and_batched():
    block = _rand(1024, 1)
    batch = _rand((3, 1024), 2)
    ff, jf = tm.FilterFFT(TAPS, 1024), jm.FilterFFT(TAPS, 1024)
    assert ff.fft_n == jf.fft_n == 2048 and ff.out_len == jf.out_len == 1152
    np.testing.assert_allclose(ff.kernel_spec.numpy(), jf.kernel_spec.numpy(), atol=1e-5,
                               rtol=1e-5)
    got = ff(dt.from_numpy(block))
    assert _rel(got, jf(dsc_tpu.from_numpy(block))) < 1e-5
    assert _rel(got, np.convolve(block.astype(np.float64), TAPS)) < NUMPY_BOUND
    gb = ff(dt.from_numpy(batch))
    assert gb.shape == (3, 1152)
    assert _rel(gb, jf(dsc_tpu.from_numpy(batch))) < 1e-5
    # each step is a dsc.compile program, one per signature, reused
    assert isinstance(ff._step, fuse._Compiled)
    ff(dt.from_numpy(block))
    assert ff._step.n_programs == 1 and ff._step_b.n_programs == 1
    with pytest.raises(RuntimeError, match='expected block of 1024'):
        ff(dt.from_numpy(block[:100]))


@pytest.mark.parametrize('mode', ['full', 'same', 'valid'])
def test_fft_convolve2_and_convolve(mode):
    img, ker = _rand((20, 30), 3), _rand((5, 4), 4)
    (ti, tk), (ji, jk) = _both(img, ker)
    got = tm.fft_convolve2(ti, tk, mode=mode)
    assert _rel(got, jm.fft_convolve2(ji, jk, mode=mode)) < 1e-5
    assert _rel(got, sps.convolve(img.astype(np.float64), ker, mode=mode)) < NUMPY_BOUND
    assert _rel(tm.convolve(ti, tk, mode=mode), got) == 0.0
    sig = _rand(300, 5)
    (ts, tt), (js, jt) = _both(sig, TAPS[:17])
    got1 = tm.convolve(ts, tt, mode=mode, method='direct')
    assert _rel(got1, jm.convolve(js, jt, mode=mode)) < 1e-5
    assert _rel(got1, np.convolve(sig.astype(np.float64), TAPS[:17], mode=mode)) < NUMPY_BOUND


def test_correlations():
    img, ker = _rand((20, 30), 6), _rand((5, 4), 7)
    (ti, tk), (ji, jk) = _both(img, ker)
    got = tm.correlate2d(ti, tk)
    assert _rel(got, jm.correlate2d(ji, jk)) < 1e-5
    assert _rel(got, sps.correlate2d(img.astype(np.float64), ker)) < NUMPY_BOUND
    sig = _rand(1000, 8)
    (ts, tv), (js, jv) = _both(sig, TAPS[:17])
    for mode in ('valid', 'same', 'full'):
        got = tm.correlate(ts, tv, mode=mode)
        assert _rel(got, jm.correlate(js, jv, mode=mode)) < 1e-5
        assert _rel(got, np.correlate(sig.astype(np.float64), TAPS[:17], mode=mode)) < NUMPY_BOUND
    with pytest.raises(RuntimeError, match='must be >='):
        tm.correlate(tv, ts)


@pytest.mark.parametrize('mode', ['full', 'same', 'valid'])
def test_oaconvolve(mode):
    sig = _rand((2, 4096), 9)  # the batch of test_overlap_save: one JAX program
    (ts, tt), (js, jt) = _both(sig, TAPS[:17])
    got = tm.oaconvolve(ts, tt, mode=mode)  # n >= 8k: the overlap-save route
    assert _rel(got, jm.oaconvolve(js, jt, mode=mode)) < 1e-5
    ref = sps.oaconvolve(sig[1].astype(np.float64), TAPS[:17], mode=mode)
    assert _rel(got[1], ref) < NUMPY_BOUND
    short = _rand(64, 10)
    got = tm.oaconvolve(dt.from_numpy(short), dt.from_numpy(TAPS[:17]), mode=mode)  # one FFT
    assert _rel(got, np.convolve(short.astype(np.float64), TAPS[:17], mode=mode)) < NUMPY_BOUND


@pytest.mark.parametrize('boundary,fill', [('fill', 0.0), ('fill', 0.5), ('wrap', 0.0),
                                           ('symm', 0.0)])
def test_convolve2d(boundary, fill):
    img, ker = _rand((20, 30), 11), _rand((5, 4), 12)
    (ti, tk), (ji, jk) = _both(img, ker)
    for mode in ('full', 'same', 'valid'):
        got = tm.convolve2d(ti, tk, mode, boundary=boundary, fillvalue=fill)
        ref = sps.convolve2d(img.astype(np.float64), ker, mode, boundary=boundary,
                             fillvalue=fill)
        assert _rel(got, ref) < NUMPY_BOUND
        if mode == 'same':
            assert _rel(got, jm.convolve2d(ji, jk, mode, boundary=boundary,
                                           fillvalue=fill)) < 1e-5


def test_overlap_save():
    sig = _rand((2, 4096), 13)
    taps = TAPS[:17]
    got = tm.OverlapSave(taps)(dt.from_numpy(sig))
    ref = jm.OverlapSave(taps)(dsc_tpu.from_numpy(sig))
    assert got.shape == ref.shape == (2, 4096 + 16)
    assert _rel(got, ref) < 1e-5
    assert _rel(got[0], np.convolve(sig[0].astype(np.float64), taps)) < NUMPY_BOUND
    # the fft_n = 8192 blocks of chip_smoke.py's OverlapSave rows: on the card
    # K12r and K12ir on the 4096-point half-size transforms
    one = _rand(20000, 14)
    got = tm.overlap_save_convolve(dt.from_numpy(one), dt.from_numpy(TAPS), fft_n=8192)
    assert _rel(got, np.convolve(one.astype(np.float64), TAPS)) < NUMPY_BOUND
    with pytest.raises(RuntimeError, match='power of two'):
        tm.OverlapSave(TAPS, fft_n=1000)
    with pytest.raises(RuntimeError, match='too small'):
        tm.OverlapSave(TAPS, fft_n=128)


def _np_stft(x, frame, hop, win):
    frames = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64), frame, axis=-1)
    return np.fft.rfft(frames[..., ::hop, :] * win, axis=-1)


@pytest.mark.parametrize('mode', ['log', 'power', 'complex'])
def test_stft_modes(mode):
    x = _rand((2, 4096), 15)
    st, jst = tm.STFT(256, 64, 'hann', mode=mode), jm.STFT(256, 64, 'hann', mode=mode)
    got = st(dt.from_numpy(x))
    ref = jst(dsc_tpu.from_numpy(x))
    assert got.shape == ref.shape == (2, 61, 129)
    assert str(got.dtype) == str(ref.dtype)
    z = _np_stft(x, 256, 64, np.hanning(256))
    want = {'complex': z, 'power': np.abs(z) ** 2,
            'log': np.log(np.abs(z) ** 2 + 1e-10)}[mode]
    if mode == 'log':  # absolute error: the log of a near-zero bin
        assert np.abs(got.numpy() - ref.numpy()).max() < 1e-3
        assert np.abs(got.numpy() - want).max() < 1e-3
    else:
        assert _rel(got, ref) < 1e-5
        assert _rel(got, want) < NUMPY_BOUND
    # one vector gives one spectrogram
    assert st(dt.from_numpy(x[0])).shape == (61, 129)


def test_stft_frame_1024_rides_k12(monkeypatch):
    """A 1024-sample frame: the batched core runs the frames' rfft, whose
    512-point half-size transform is a K12 base case, through K12r's
    wrapper (its plain version on a CPU tensor), as the JAX core runs its
    base kernel."""
    calls = []
    rfft_base = base_fft.rfft_base
    monkeypatch.setattr(base_fft, 'rfft_base',
                        lambda x, w, wu: calls.append(x.shape) or rfft_base(x, w, wu))
    x = _rand(8192, 16)
    got = tm.spectrogram(dt.from_numpy(x), 1024, 256, window='hann')
    assert calls and all(s[-1] == 1024 for s in calls)
    want = np.log(np.abs(_np_stft(x, 1024, 256, np.hanning(1024))) ** 2 + 1e-10)
    assert got.shape == want.shape == (29, 513)
    assert np.abs(got.numpy() - want).max() < 1e-3


@pytest.mark.parametrize('mode', ['log', 'power', 'complex'])
def test_stft_program_sends_riding_frames_to_k12s(mode, monkeypatch):
    """An STFT whose frames ride K12r (frame 1024, float32) hands the signal
    to K12s's wrapper with its mode and eps, once a call, on a CPU tensor
    too; with the rule sending the frames to 'plain' it runs the plain
    passes around the batched rfft instead: on a CPU tensor both give the
    same numbers, bit for bit."""
    from dsc_tpu_torch.fourier import config

    calls = []
    stft_base = base_fft.stft_base

    def spy(x, start, n_frames, hop, window, w, wu, mode, eps):
        calls.append((tuple(x.shape), start, n_frames, hop, window.shape, mode, eps))
        return stft_base(x, start, n_frames, hop, window, w, wu, mode, eps)

    monkeypatch.setattr(base_fft, 'stft_base', spy)
    x = dt.from_numpy(_rand((2, 8192), 19))
    got = tm.STFT(1024, 256, 'hann', mode=mode)(x)
    eps = 1e-10 if mode == 'log' else 0.0
    assert calls == [((2, 8192), 0, 29, 256, (1024,), mode, eps)]
    monkeypatch.setattr(config, 'batched_engine', lambda *a: 'plain')
    plain = tm.STFT(1024, 256, 'hann', mode=mode)(x)
    assert len(calls) == 1
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_griffin_lim_forward_reads_the_cropped_view(monkeypatch):
    """Griffin-Lim's forward STFT hands K12s's wrapper the inverse's output
    cropped by a view, no copy, with frame 0 at sample -frame/2 of it: the
    centre's zeros are read, not written."""
    calls = []
    stft_base = base_fft.stft_base

    def spy(x, start, *args):
        calls.append((x.is_contiguous(), x.stride(0), tuple(x.shape), start))
        return stft_base(x, start, *args)

    monkeypatch.setattr(base_fft, 'stft_base', spy)
    S = dt.Tensor(torch.rand(2, 20, 513, generator=torch.Generator().manual_seed(3)))
    tm.GriffinLim(1024, 256, 'hann', n_iter=2)(S)
    span = 19 * 256 + 1024
    assert calls == [(False, span, (2, span - 1024), -512)] * 2


def test_istft_round_trip():
    x = _rand((2, 4096), 17)
    Z = tm.STFT(256, 64, mode='complex')(dt.from_numpy(x))
    jZ = jm.STFT(256, 64, mode='complex')(dsc_tpu.from_numpy(x))
    got = tm.ISTFT(256, 64)(Z, length=4096)
    ref = jm.ISTFT(256, 64)(jZ, length=4096)
    assert got.shape == ref.shape == (2, 4096)
    # where the windows overlap fully: at the ends 1/sum(w^2) is large and
    # magnifies float32 rounding in either package
    assert _rel(got[:, 256:-256], ref[:, 256:-256]) < 1e-5
    assert np.abs(got.numpy()[:, 256:-256] - x[:, 256:-256]).max() < 1e-5
    # a hop that does not divide the frame, and a window given by name
    y = tm.ISTFT(250, 60, 'hamming')(tm.STFT(250, 60, 'hamming', mode='complex')(
        dt.from_numpy(x[0])))
    span = (1 + (4096 - 250) // 60 - 1) * 60 + 250
    assert y.shape == (span,)
    assert np.abs(y.numpy()[250:-250] - x[0, 250:span - 250]).max() < 1e-5
    with pytest.raises(RuntimeError, match='bins'):
        tm.ISTFT(512, 64)(Z)


def test_stft_windows_from_the_window_tier():
    x = _rand(2048, 18)
    for win, ref in ((dt.kaiser(256, 8.0), np.kaiser(256, 8.0)),
                     (('tukey', 0.25), sps.get_window(('tukey', 0.25), 256, fftbins=False))):
        got = tm.STFT(256, 128, win, mode='power')(dt.from_numpy(x))
        assert _rel(got, np.abs(_np_stft(x, 256, 128, ref)) ** 2) < NUMPY_BOUND


def test_entry_small():
    fn, (sig, ker) = entry(n=4096, taps=129)
    assert isinstance(fn, fuse._Compiled)
    got = fn(sig, ker)
    assert got.shape == (4096 + 128,)
    ref = np.convolve(sig.numpy().astype(np.float64), ker.numpy().astype(np.float64))
    assert _rel(got, ref) < NUMPY_BOUND
    eager = dt.irfft(dt.mul(dt.rfft(sig, n=8192), dt.rfft(ker, n=8192)))[:4096 + 128]
    assert _rel(got, eager) < 1e-6
    np.testing.assert_array_equal(ker.numpy(), np.blackman(129).astype(np.float32))
    assert fn.n_programs == 1


def test_model_exports():
    names = ['FilterFFT', 'fft_convolve2', 'correlate2d', 'correlate', 'convolve', 'oaconvolve',
             'convolve2d', 'OverlapSave', 'overlap_save_convolve', 'STFT', 'ISTFT', 'spectrogram']
    for name in names:
        assert name in tm.__all__ and hasattr(jm, name), name
