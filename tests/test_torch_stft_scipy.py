"""scipy.signal-compatible stft / istft of dsc_tpu_torch (models/stft_scipy.py)
and the framing and inverse helpers of models/stft.py, against dsc_tpu and
scipy.signal in float64 on the same inputs, on the CPU: every boundary
mode, padding, nfft, scaling, detrend and two-sided case of the JAX
package's tests/test_stft_scipy.py, the istft round trip (a hop that does
not divide the segment among them: the overlap-add's zero-padded last
piece), batched
input, COLA/NOLA, the dual windows and the errors. Port results are held to
dsc_tpu within 1e-5 of the largest value and to scipy within the JAX
tests' tolerances."""

import gc
import importlib

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu.models.stft_scipy as jss  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402
from dsc_tpu_torch.fourier import base_fft, plan  # noqa: E402
from dsc_tpu_torch.models import stft_scipy as tss  # noqa: E402

# the modules by name: the packages' attribute ``stft`` is the function
jstft = importlib.import_module('dsc_tpu.models.stft')
tstft = importlib.import_module('dsc_tpu_torch.models.stft')

PORT_BOUND = 1e-5  # against dsc_tpu, relative to the largest value


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _sig(n=3000, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _rel(got, ref):
    got = got.numpy() if hasattr(got, 'numpy') else np.asarray(got)
    ref = ref.numpy() if hasattr(ref, 'numpy') else np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


X = _sig()

STFT_CONFIGS = [
    dict(),
    dict(noverlap=192),
    dict(boundary='even'),
    dict(boundary='odd'),
    dict(boundary='constant'),
    dict(boundary=None),
    dict(padded=False),
    dict(nfft=512),
    dict(scaling='psd'),
    dict(detrend='linear'),
    dict(detrend='constant'),
    dict(window=('tukey', 0.4)),
    dict(nperseg=200, nfft=256),
    dict(return_onesided=False),
]


@pytest.mark.parametrize('kw', STFT_CONFIGS, ids=str)
def test_stft(kw):
    f, t, z = tm.stft(dt.from_numpy(X), fs=100.0, **kw)
    jf, jt, jz = jm.stft(dsc_tpu.from_numpy(X), fs=100.0, **kw)
    assert z.dtype == dt.Dtype.C32
    assert _rel(f, jf) == 0.0 and _rel(t, jt) == 0.0
    assert _rel(z, jz) < PORT_BOUND
    f2, t2, z2 = sps.stft(X.astype(np.float64), fs=100.0, **kw)
    assert np.allclose(f.numpy(), f2) and np.allclose(t.numpy(), t2, atol=1e-5)
    assert _rel(z, z2) < 1e-5


@pytest.mark.parametrize('kw', [
    dict(nperseg=256),
    dict(nperseg=256, noverlap=192),
    dict(nperseg=256, scaling='psd'),
    dict(nperseg=128, noverlap=96),
    dict(nperseg=256, noverlap=100),  # hop 156 does not divide 256
], ids=str)
def test_istft_round_trip(kw):
    _, _, z = tm.stft(dt.from_numpy(X), fs=100.0, **kw)
    t, xr = tm.istft(z, fs=100.0, **kw)
    _, _, jz = jm.stft(dsc_tpu.from_numpy(X), fs=100.0, **kw)
    jt, jx = jm.istft(jz, fs=100.0, **kw)
    assert _rel(t, jt) == 0.0 and _rel(xr, jx) < PORT_BOUND
    t2, x2 = sps.istft(sps.stft(X.astype(np.float64), fs=100.0, **kw)[2], fs=100.0, **kw)
    assert xr.shape == x2.shape
    assert np.abs(xr.numpy()[:X.size] - X).max() < 1e-5
    assert np.abs(xr.numpy() - x2).max() < 1e-5
    assert np.allclose(t.numpy(), t2, atol=1e-5)


def test_stft_batched():
    xb = np.random.default_rng(1).standard_normal((3, 2000)).astype(np.float32)
    f, t, z = tm.stft(dt.from_numpy(xb), nperseg=256)
    assert z.shape == (3, 129, 17)
    _, xr = tm.istft(z, nperseg=256)
    assert np.abs(xr.numpy()[:, :2000] - xb).max() < 1e-5
    _, _, z0 = tm.stft(dt.from_numpy(xb[0]), nperseg=256)
    assert np.allclose(z.numpy()[0], z0.numpy(), atol=1e-6)
    assert _rel(z, jm.stft(dsc_tpu.from_numpy(xb), nperseg=256)[2]) < PORT_BOUND


@pytest.mark.parametrize('frame,hop,n_frames,n', [(8, 3, 5, 20), (8, 4, 5, 20),
                                                  (8, 3, 6, 20), (16, 16, 2, 32)])
def test_frame_dense(frame, hop, n_frames, n):
    """Frames of (b, n) with the zero tail when the last frame overruns,
    against the reference's slice-and-concatenate framing."""
    x = np.random.default_rng(2).standard_normal((2, n)).astype(np.float32)
    got = base_fft.frame_dense(torch.from_numpy(x), frame, hop, n_frames)
    ref = np.asarray(jstft._frame_dense(x, frame, hop, n_frames))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('frame,hop', [(256, 64), (256, 100)], ids=['hop_divides', 'scatter'])
def test_istft_program(frame, hop):
    """The batched inverse, window and overlap-add, with a hop that divides
    the frame and one that does not (the last piece of each frame
    zero-padded to the hop; the reference scatter-adds it)."""
    rng = np.random.default_rng(3)
    n_frames, fft_n = 9, 256
    z = (rng.standard_normal((2, n_frames, fft_n // 2 + 1))
         + 1j * rng.standard_normal((2, n_frames, fft_n // 2 + 1))).astype(np.complex64)
    z[..., 0] = z[..., 0].real
    z[..., -1] = z[..., -1].real
    win = np.hanning(frame).astype(np.float32)
    out_n = (n_frames - 1) * hop + frame
    inv_wsq = rng.uniform(0.5, 2.0, out_n).astype(np.float32)
    spec, tables = plan.get_plan(fft_n, 'real', torch.complex64)
    got = tstft._istft_program(torch.from_numpy(z), torch.from_numpy(win),
                               torch.from_numpy(inv_wsq), tables, frame, hop, n_frames, spec,
                               fft_n, out_n)
    from dsc_tpu.fourier import plan as jplan
    jspec, jtables = jplan.get_plan(fft_n, 'real', np.complex64)
    ref = jstft._istft_program(z.real, z.imag, win, inv_wsq, jtables, frame, hop, n_frames,
                               jspec, fft_n, out_n)
    assert _rel(got, np.asarray(ref)) < PORT_BOUND


@pytest.mark.parametrize('mode', ['constant', 'edge', 'reflect', 'odd'])
def test_pad_ext(mode):
    x = np.random.default_rng(4).standard_normal((2, 9)).astype(np.float32)
    for left, right in ((3, 0), (0, 4), (8, 8)):
        got = tss._pad_ext(torch.from_numpy(x), left, right, mode)
        kw = dict(mode='reflect', reflect_type='odd') if mode == 'odd' else dict(mode=mode)
        np.testing.assert_allclose(got.numpy(), np.pad(x, ((0, 0), (left, right)), **kw),
                                   rtol=1e-6, atol=1e-6)


def test_cola_nola_and_f64_window():
    cases = [('hann', 256, 128), ('hann', 256, 192), ('boxcar', 256, 0), ('hann', 256, 100),
             (('tukey', 0.5), 256, 64), ('hann', 255, 127), ('blackman', 256, 192),
             ('hamming', 256, 128)]
    for w, n, no in cases:
        assert tm.check_COLA(w, n, no) == sps.check_COLA(w, n, no) == jm.check_COLA(w, n, no)
        assert tm.check_NOLA(w, n, no) == sps.check_NOLA(w, n, no) == jm.check_NOLA(w, n, no)
        np.testing.assert_allclose(tss._f64_window(w, n), jss._f64_window(w, n), rtol=1e-12)


def test_dual_windows():
    rng = np.random.default_rng(0)
    for win, hop in [(np.hanning(64), 16), (np.hamming(48), 12), (rng.uniform(0.2, 1.0, 40), 8)]:
        d = tm.stft_dual_window(win, hop)
        np.testing.assert_allclose(d, jm.stft_dual_window(win, hop), rtol=1e-12)
        np.testing.assert_allclose(tss._overlap_add_diag(win, hop),
                                   jss._overlap_add_diag(win, hop), rtol=1e-12)
        for kw in [dict(), dict(scaled=False), dict(desired_dual=np.hanning(len(win)))]:
            g, ga = tm.closest_STFT_dual_window(win, hop, **kw)
            r, ra = sps.closest_STFT_dual_window(win, hop, **kw)
            assert np.allclose(g, r) and abs(ga - ra) < 1e-12
    with pytest.raises(RuntimeError, match='not invertible'):
        tm.stft_dual_window(np.hanning(64), 64)


def test_errors():
    x = dt.from_numpy(_sig(512))
    with pytest.raises(RuntimeError, match='power of two'):
        tm.stft(x, nperseg=200)
    with pytest.raises(RuntimeError, match='unknown boundary'):
        tm.stft(x, boundary='bogus')
    with pytest.raises(RuntimeError, match='unknown scaling'):
        tm.stft(x, scaling='bogus')
    _, _, z = tm.stft(x, nperseg=256)
    with pytest.raises(RuntimeError, match='fails NOLA'):
        tm.istft(z, nperseg=256, window=np.zeros(256))
    with pytest.raises(RuntimeError, match='one-sided'):
        tm.istft(z, input_onesided=False)
