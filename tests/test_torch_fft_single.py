"""The single-vector slice of dsc_tpu_torch on CPU tensors: fft/ifft and
rfft/irfft of one vector in the streaming range, into and out of the T and
half-T spectrum layouts, the elementwise ops that keep a layout, the ones
that read natural order, fft_convolve at n = 2^19 and the chirp-z
transform, through the public API of both packages on the same inputs.

The JAX package runs with ``fft_config.STREAM_MODE = 'on'``, so its
kernels K6/K8/K9/K10 run in interpret mode; its results are computed once
per module. The port runs the plain versions of K6/K8/K9/K10. Spies on the
kernel wrappers show which kernels each call reaches.

Bounds, relative to max: 3e-5 against the JAX package (its bf16x3 DFT
stages are good to about 1e-5), 1e-5 against np.fft / np.convolve /
scipy.signal in float64."""

import gc

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models  # noqa: E402
from dsc_tpu.fourier import config as jconfig  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch.dtype import Dtype  # noqa: E402
from dsc_tpu_torch.fourier import reconstruct, stream, stream_t  # noqa: E402

JAX_BOUND = 3e-5
NUMPY_BOUND = 1e-5
N = 2**18
T18, H18, H19 = (512, 512, False), (512, 512, True), (1024, 512, True)


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**33, device='cpu')
    yield
    dt.shutdown()


RNG = np.random.default_rng(41)


def _c(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(np.complex64)


V, V2 = _c(N), _c(N)
W, W2 = (RNG.standard_normal(N).astype(np.float32) for _ in range(2))
W19 = RNG.standard_normal(2 * N).astype(np.float32)
SP = np.fft.rfft(RNG.standard_normal(N)).astype(np.complex64)   # a natural spectrum
SIG = RNG.standard_normal(N + 10000).astype(np.float32)          # fft_n = 2^19
TAPS = np.blackman(255).astype(np.float32)


def _f(x):
    return np.fft.fft(x.astype(np.complex128))


def _r(x):
    return np.fft.rfft(x.astype(np.float64))


# kernels counted by the spies, in this order
KERNELS = ('K6', 'K7', 'K8', 'K9', 'K10', 'K11')

# name -> (call on a package, exact value in float64, launches of KERNELS,
# the port's result layout)
CASES = {
    'fft c64 2^18': (lambda d: d.fft(d.from_numpy(V)), lambda: _f(V),
                     (1, 0, 1, 0, 0, 0), T18),
    'fft f32 2^18': (lambda d: d.fft(d.from_numpy(W)), lambda: _f(W),
                     (1, 0, 1, 0, 0, 0), T18),
    'ifft of fft 2^18': (lambda d: d.ifft(d.fft(d.from_numpy(V))), lambda: V,
                         (1, 0, 1, 1, 1, 0), None),
    'rfft 2^18': (lambda d: d.rfft(d.from_numpy(W)), lambda: _r(W), (1, 0, 1, 0, 0, 0), H18),
    'irfft of rfft 2^18': (lambda d: d.irfft(d.rfft(d.from_numpy(W))), lambda: W,
                           (1, 0, 1, 1, 1, 0), None),
    'rfft 2^19': (lambda d: d.rfft(d.from_numpy(W19)), lambda: _r(W19),
                  (1, 0, 1, 0, 0, 0), H19),
    'irfft of rfft 2^19': (lambda d: d.irfft(d.rfft(d.from_numpy(W19))), lambda: W19,
                           (1, 0, 1, 1, 1, 0), None),
    # an fft of a T-layout spectrum reads natural order: K6 + K7
    'fft of fft 2^18': (lambda d: d.fft(d.fft(d.from_numpy(V))), lambda: _f(_f(V)),
                        (2, 1, 1, 0, 0, 0), None),
    # same-layout ops compute on the stored values and keep the layout
    'mul full-T': (lambda d: d.fft(d.from_numpy(V)) * d.fft(d.from_numpy(V2)),
                   lambda: _f(V) * _f(V2), (2, 0, 2, 0, 0, 0), T18),
    'add half-T': (lambda d: d.rfft(d.from_numpy(W)) + d.rfft(d.from_numpy(W2)),
                   lambda: _r(W) + _r(W2), (2, 0, 2, 0, 0, 0), H18),
    'div half-T by 3.0': (lambda d: d.rfft(d.from_numpy(W)) / 3.0, lambda: _r(W) / 3.0,
                          (1, 0, 1, 0, 0, 0), H18),
    'complex scalar minus full-T': (lambda d: (0.5 - 2j) - d.fft(d.from_numpy(V)),
                                    lambda: (0.5 - 2j) - _f(V), (1, 0, 1, 0, 0, 0), T18),
    'conj full-T': (lambda d: d.conj(d.fft(d.from_numpy(V))), lambda: np.conj(_f(V)),
                    (1, 0, 1, 0, 0, 0), T18),
    'pow full-T': (lambda d: d.fft(d.from_numpy(V)) ** 2.0, lambda: _f(V) ** 2,
                   (1, 0, 1, 0, 0, 0), T18),
    # what a layout cannot hold reads natural order
    'pow half-T': (lambda d: d.rfft(d.from_numpy(W)) ** 2.0, lambda: _r(W) ** 2,
                   (1, 0, 1, 0, 0, 0), None),
    'half-T times complex scalar': (lambda d: d.rfft(d.from_numpy(W)) * (1 + 1j),
                                    lambda: _r(W) * (1 + 1j), (1, 0, 1, 0, 0, 0), None),
    'half-T times natural spectrum': (lambda d: d.rfft(d.from_numpy(W)) * d.from_numpy(SP),
                                      lambda: _r(W) * SP, (1, 0, 1, 0, 0, 0), None),
    'reshaped full-T times 2.0': (lambda d: d.reshape(d.fft(d.from_numpy(V)), (2, N // 2)) * 2.0,
                                  lambda: (_f(V) * 2.0).reshape(2, N // 2),
                                  (1, 0, 1, 0, 0, 0), None),
    'fft_convolve n=2^19': (lambda d: d.models.fft_convolve(d.from_numpy(SIG), d.from_numpy(TAPS)),
                            lambda: np.convolve(SIG.astype(np.float64), TAPS.astype(np.float64)),
                            (2, 0, 2, 1, 1, 0), None),
}


@pytest.fixture(scope='module')
def jax_results():
    """Every case through dsc_tpu with its streaming kernels on (interpret
    mode), computed once; and the planes of the JAX half-T rfft of W with
    the JAX irfft of them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, 'STREAM_MODE', 'on')
        res = {name: call(dsc_tpu).numpy() for name, (call, *_) in CASES.items()}
        spec = dsc_tpu.rfft(dsc_tpu.from_numpy(W))
        pp = spec._planar
        res['half-T planes'] = (np.asarray(pp.re), np.asarray(pp.im), pp.fourstep)
        res['irfft of the half-T planes'] = dsc_tpu.irfft(spec).numpy()
    # the compiles leave a large heap that the gc.collect() after every test
    # (tests/conftest.py) would otherwise rescan each time
    gc.freeze()
    yield res
    gc.unfreeze()


@pytest.fixture
def launches(monkeypatch):
    """Calls of each kernel wrapper (their plain versions run here)."""
    seen = dict.fromkeys(KERNELS, 0)

    def spy(module, attr, key, counts=lambda *a: 1):
        fn = getattr(module, attr)

        def wrapped(*args, **kw):
            seen[key] += counts(*args)
            return fn(*args, **kw)
        monkeypatch.setattr(module, attr, wrapped)

    spy(stream, 'phase_a', 'K6')
    spy(stream, 'phase_b', 'K7')
    spy(stream_t, 'phase_b_t', 'K8')
    spy(stream_t, 'inv_phase_a_t', 'K9')
    spy(stream_t, 'inv_phase_b_t', 'K10')
    spy(reconstruct, 'reconstruct_spectrum', 'K11', reconstruct.kernel_takes)
    return seen


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('name', list(CASES))
def test_public_api_matches_jax_and_numpy(name, jax_results, launches):
    call, exact, counts, layout = CASES[name]
    res = call(dt)
    got = res.numpy()
    ref = jax_results[name]
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype
    assert _rel(got, ref) < JAX_BOUND
    assert _rel(got, exact()) < NUMPY_BOUND
    assert tuple(launches[k] for k in KERNELS) == counts
    assert res._layout == layout


def test_state_carried_across(jax_results, launches):
    """The JAX package's half-T rfft planes, carried into the port with
    interop.from_t, invert in the port (K9 + K10) to the JAX irfft's value."""
    hr, hi, fourstep = jax_results['half-T planes']
    assert fourstep == H18
    spec = dt.from_t(hr, hi, *fourstep)
    assert spec.shape == (N // 2 + 1,) and spec.dtype == Dtype.C32
    assert spec._layout == H18
    assert _rel(spec.numpy(), _r(W)) < JAX_BOUND
    got = dt.irfft(spec).numpy()
    ref = jax_results['irfft of the half-T planes']
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    assert _rel(got, ref) < JAX_BOUND
    assert _rel(got, W) < NUMPY_BOUND
    assert (launches['K9'], launches['K10'], launches['K7']) == (1, 1, 0)


def test_layout_materializes_in_place_once():
    """numpy() leaves the layout alone; the first dense read turns the
    buffer natural in place, for every view, with the byte accounting
    following the buffer."""
    x = dt.rfft(dt.from_numpy(W))
    view = dt.reshape(x, (1, N // 2 + 1))
    used = dt.used_mem()
    assert x._layout == H18 and view._layout is None
    first = x.numpy()
    assert x._layout == H18 and dt.used_mem() == used
    dense = view.torch
    assert x._layout is None and x._buf.layout is None
    assert dt.used_mem() == used - (512 * 257 - (N // 2 + 1)) * 8
    assert np.array_equal(dense.numpy().reshape(-1), first)
    assert np.array_equal(x.numpy(), first)


def test_profile_keeps_the_layout(tmp_path):
    """Tracing reads metadata only: the traced ifft still reads the T layout."""
    x = dt.fft(dt.from_numpy(V))
    with dt.profile(str(tmp_path / 'traces.json'), serve=False):
        y = dt.ifft(x * 2.0)
    assert x._layout == T18
    assert _rel(y.numpy(), 2 * V) < NUMPY_BOUND


# -- the chirp-z transform (tests/test_czt.py's sizes) ------------------------


@pytest.mark.parametrize('n', [331, 1000, 4097])
def test_czt_is_exact_dft_of_any_length(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    got = dt.models.czt(dt.from_numpy(x)).numpy()
    ref = dsc_tpu.models.czt(dsc_tpu.from_numpy(x)).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert _rel(got, ref) < JAX_BOUND
    assert _rel(got, _f(x)) < NUMPY_BOUND


def test_czt_real_input_custom_points():
    x = np.random.default_rng(1).standard_normal(500).astype(np.float32)
    w, a = np.exp(-2j * np.pi / 300), np.exp(1j * 0.3)
    got = dt.models.czt(dt.from_numpy(x), m=219, w=w, a=a).numpy()
    ref = dsc_tpu.models.czt(dsc_tpu.from_numpy(x), m=219, w=w, a=a).numpy()
    assert got.shape == ref.shape == (219,) and got.dtype == ref.dtype
    assert _rel(got, ref) < JAX_BOUND
    assert _rel(got, sps.czt(x.astype(np.float64), 219, w, a)) < NUMPY_BOUND


def test_czt_batched_and_plan_reuse():
    plan, jplan = dt.models.CZT(777), dsc_tpu.models.CZT(777)
    for seed in range(2):
        xb = np.random.default_rng(seed).standard_normal((3, 777)).astype(np.float32)
        got = plan(dt.from_numpy(xb)).numpy()
        ref = jplan(dsc_tpu.from_numpy(xb)).numpy()
        assert got.shape == ref.shape == (3, 777) and got.dtype == ref.dtype
        assert _rel(got, ref) < JAX_BOUND
        assert _rel(got, sps.czt(xb.astype(np.float64), axis=-1)) < NUMPY_BOUND


@pytest.mark.parametrize('fn,m,endpoint', [
    ([0.1, 0.3], 128, False), ([0.1, 0.3], 128, True), (0.4, 64, False),
])
def test_zoom_fft_matches_jax_and_scipy(fn, m, endpoint):
    x = np.random.default_rng(4).standard_normal(500).astype(np.float32)
    got = dt.models.zoom_fft(dt.from_numpy(x), fn, m=m, endpoint=endpoint).numpy()
    ref = dsc_tpu.models.zoom_fft(dsc_tpu.from_numpy(x), fn, m=m, endpoint=endpoint).numpy()
    assert got.shape == ref.shape == (m,) and got.dtype == ref.dtype
    assert _rel(got, ref) < JAX_BOUND
    assert _rel(got, sps.zoom_fft(x.astype(np.float64), fn, m=m, endpoint=endpoint)) \
        < NUMPY_BOUND


def test_zoomfft_class_and_points():
    x = np.random.default_rng(12).standard_normal(64).astype(np.float32)
    zf = dt.models.ZoomFFT(64, [0.1, 0.4], m=33, fs=2.0)
    ref = sps.ZoomFFT(64, [0.1, 0.4], m=33, fs=2)
    got = zf(dt.from_numpy(x)).numpy()
    assert _rel(got, ref(x.astype(np.float64))) < 1e-4
    assert np.abs(zf.points() - ref.points()).max() < 1e-12
    assert np.abs(zf.points() - dsc_tpu.models.ZoomFFT(64, [0.1, 0.4], m=33).points()).max() \
        < 1e-12
    w = 0.99 * np.exp(-2j * np.pi / 30)
    c = dt.models.CZT(64, 20, w=w, a=1.1)
    assert np.abs(c.points() - sps.CZT(64, 20, w=w, a=1.1).points()).max() < 1e-12
    assert np.abs(dt.models.czt_points(20, w, 1.1)
                  - dsc_tpu.models.czt_points(20, w, 1.1)).max() == 0


def test_czt_at_2_18_rides_the_t_layout(launches):
    """n = 100 000: fft_n = 2^18, the T path (K6 + K8 for the chirp kernel's
    spectrum and the signal's, a same-layout multiply, K9 + K10)."""
    x = np.random.default_rng(5).standard_normal(100_000).astype(np.float32)
    got = dt.models.czt(dt.from_numpy(x))
    assert got.shape == (100_000,) and got.dtype == Dtype.C32
    assert _rel(got.numpy(), _f(x)) < NUMPY_BOUND
    assert tuple(launches[k] for k in KERNELS) == (2, 0, 2, 1, 1, 0)


def test_czt_rejects_bad_args():
    x = dt.from_numpy(np.zeros(16, np.float32))
    with pytest.raises(RuntimeError):
        dt.models.CZT(0)
    with pytest.raises(RuntimeError):
        dt.models.CZT(16, m=0)
    with pytest.raises(RuntimeError):
        dt.models.CZT(8)(x)
    with pytest.raises(RuntimeError):
        dt.models.zoom_fft(x, [0.1, 0.2, 0.3])
    with pytest.raises(RuntimeError):
        dt.models.czt_points(0)
