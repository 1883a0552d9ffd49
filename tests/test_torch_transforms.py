"""The exact-length engine (transforms/_dft.py) and the scipy.fft-parity FFT
family (transforms/exact.py) of dsc_tpu_torch against dsc_tpu.transforms
and scipy.fft on the same inputs, on the CPU: every length kind (pow2, even
composite, odd, prime, 1), the norms, axes and the n-D family, the
Hermitian transforms on half spectra that are not Hermitian (the c2r
contract), a Bluestein call whose inner transform streams (the JAX
package's K6/K7 in interpret mode), a T-layout input, float64/complex128
inputs, the plan cache and the errors. Port results are held to dsc_tpu
within 1e-5 of the largest value where a case is in JAX_HELD, and every
result to scipy.fft within the JAX package's bound
(tests/test_transforms.py ``_close``)."""

import gc
import pathlib
import re

import numpy as np
import pytest
import scipy.fft as sft

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.transforms as jtf  # noqa: E402
from dsc_tpu.fourier import config as jconfig  # noqa: E402
from dsc_tpu.fourier import core as jcore  # noqa: E402
from dsc_tpu.fourier import plan as jplan  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.transforms as ttf  # noqa: E402
from dsc_tpu_torch.fourier import config, core, plan, stream  # noqa: E402
from dsc_tpu_torch.transforms import _dft  # noqa: E402

PORT_BOUND = 1e-5   # against dsc_tpu, relative to the largest value
SCIPY_BOUND = 2e-4  # against scipy.fft in float64 (tests/test_transforms.py _close)


def _sig(shape, seed, cplx=False, dtype=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype or (np.complex64 if cplx else np.float32))


Z = {n: _sig(n, n, cplx=True) for n in (16, 12, 15, 17, 1)}
X = {n: _sig(n, 100 + n) for n in (16, 12, 15, 17, 1, 18)}
# half spectra whose DC and (even n) Nyquist bins have imaginary parts
H = {n: _sig(n // 2 + 1, 200 + n, cplx=True) for n in (16, 1024, 12, 1000, 15)}
A = _sig((6, 10), 7, cplx=True)
B3 = _sig((3, 5, 8), 8)
C3 = _sig((3, 5, 8), 9, cplx=True)
S69 = _sig((6, 9), 10, cplx=True)
F64 = _sig(12, 11, dtype=np.float64)
C128 = _sig(8, 12, cplx=True, dtype=np.complex128)
# 2 x 40000: Bluestein at m = 2^17, whose two rows stream (K6/K7)
BS = _sig((2, 40000), 13, cplx=True)


def _c(a):
    return a.astype(np.complex128)


# name -> (call on a transforms module and its package, scipy.fft reference)
CASES = {
    'fft 16': (lambda tf, d: tf.fft(d.from_numpy(Z[16])), lambda: sft.fft(_c(Z[16]))),
    'fft 12 ortho': (lambda tf, d: tf.fft(d.from_numpy(Z[12]), norm='ortho'),
                     lambda: sft.fft(_c(Z[12]), norm='ortho')),
    'ifft 15': (lambda tf, d: tf.ifft(d.from_numpy(Z[15])), lambda: sft.ifft(_c(Z[15]))),
    'fft 17 forward': (lambda tf, d: tf.fft(d.from_numpy(Z[17]), norm='forward'),
                       lambda: sft.fft(_c(Z[17]), norm='forward')),
    'fft 1': (lambda tf, d: tf.fft(d.from_numpy(Z[1])), lambda: sft.fft(_c(Z[1]))),
    'rfft 17': (lambda tf, d: tf.rfft(d.from_numpy(X[17])), lambda: sft.rfft(X[17])),
    'irfft 16 non-Hermitian': (lambda tf, d: tf.irfft(d.from_numpy(H[16]), n=16),
                               lambda: sft.irfft(_c(H[16]), n=16)),
    'irfft 1024 non-Hermitian': (lambda tf, d: tf.irfft(d.from_numpy(H[1024]), n=1024),
                                 lambda: sft.irfft(_c(H[1024]), n=1024)),
    'irfft 12 non-Hermitian': (lambda tf, d: tf.irfft(d.from_numpy(H[12]), n=12),
                               lambda: sft.irfft(_c(H[12]), n=12)),
    'irfft 1000 non-Hermitian': (lambda tf, d: tf.irfft(d.from_numpy(H[1000]), n=1000),
                                 lambda: sft.irfft(_c(H[1000]), n=1000)),
    'hfft 16 non-Hermitian': (lambda tf, d: tf.hfft(d.from_numpy(H[16]), n=16),
                              lambda: sft.hfft(_c(H[16]), n=16)),
    'hfft 1024 non-Hermitian': (lambda tf, d: tf.hfft(d.from_numpy(H[1024]), n=1024),
                                lambda: sft.hfft(_c(H[1024]), n=1024)),
    'hfft 12 non-Hermitian': (lambda tf, d: tf.hfft(d.from_numpy(H[12]), n=12),
                              lambda: sft.hfft(_c(H[12]), n=12)),
    'hfft 1000 non-Hermitian': (lambda tf, d: tf.hfft(d.from_numpy(H[1000]), n=1000),
                                lambda: sft.hfft(_c(H[1000]), n=1000)),
    'ihfft 15': (lambda tf, d: tf.ihfft(d.from_numpy(X[15])), lambda: sft.ihfft(X[15])),
    'fft axis 0 (6, 10)': (lambda tf, d: tf.fft(d.from_numpy(A), axis=0),
                           lambda: sft.fft(_c(A), axis=0)),
    'fftn (3, 5, 8) s=(2, 6, 8)': (lambda tf, d: tf.fftn(d.from_numpy(C3), s=(2, 6, 8)),
                                   lambda: sft.fftn(_c(C3), s=(2, 6, 8))),
    'irfftn (3, 5, 8)': (lambda tf, d: tf.irfftn(d.from_numpy(sft.rfftn(B3).astype(np.complex64)),
                                                 s=(3, 5, 8)),
                         lambda: sft.irfftn(sft.rfftn(B3).astype(np.complex64), s=(3, 5, 8))),
    'fftshift (6, 9) axes 1': (lambda tf, d: tf.fftshift(d.from_numpy(S69), axes=1),
                               lambda: sft.fftshift(S69, axes=1)),
    'fft 12 float64 input': (lambda tf, d: tf.fft(d.from_numpy(F64)), lambda: sft.fft(F64)),
    'irfft 15 complex128 input': (lambda tf, d: tf.irfft(d.from_numpy(C128), n=15),
                                  lambda: sft.irfft(C128, n=15)),
    'fft 2 x 40000 (Bluestein m = 2^17, streaming rows)': (
        lambda tf, d: tf.fft(d.from_numpy(BS)), lambda: sft.fft(_c(BS))),
    # the rest: scipy.fft alone
    'ifft 12 forward': (lambda tf, d: tf.ifft(d.from_numpy(Z[12]), norm='forward'),
                        lambda: sft.ifft(_c(Z[12]), norm='forward')),
    'ifft 17 ortho': (lambda tf, d: tf.ifft(d.from_numpy(Z[17]), norm='ortho'),
                      lambda: sft.ifft(_c(Z[17]), norm='ortho')),
    'fft 16 real input': (lambda tf, d: tf.fft(d.from_numpy(X[16])), lambda: sft.fft(X[16])),
    'fft 15 real input': (lambda tf, d: tf.fft(d.from_numpy(X[15])), lambda: sft.fft(X[15])),
    'fft 15 n=8 (truncate)': (lambda tf, d: tf.fft(d.from_numpy(Z[15]), n=8),
                              lambda: sft.fft(_c(Z[15]), n=8)),
    'fft 15 n=20 (pad)': (lambda tf, d: tf.fft(d.from_numpy(Z[15]), n=20),
                          lambda: sft.fft(_c(Z[15]), n=20)),
    'fft axis -2 (6, 10)': (lambda tf, d: tf.fft(d.from_numpy(A), axis=-2),
                            lambda: sft.fft(_c(A), axis=-2)),
    'rfft 12 ortho': (lambda tf, d: tf.rfft(d.from_numpy(X[12]), norm='ortho'),
                      lambda: sft.rfft(X[12], norm='ortho')),
    'rfft 16 forward': (lambda tf, d: tf.rfft(d.from_numpy(X[16]), norm='forward'),
                        lambda: sft.rfft(X[16], norm='forward')),
    'rfft 1': (lambda tf, d: tf.rfft(d.from_numpy(X[1])), lambda: sft.rfft(X[1])),
    'irfft 15 non-Hermitian ortho': (lambda tf, d: tf.irfft(d.from_numpy(H[15]), n=15,
                                                            norm='ortho'),
                                     lambda: sft.irfft(_c(H[15]), n=15, norm='ortho')),
    'irfft 18 default n': (lambda tf, d: tf.irfft(d.from_numpy(sft.rfft(X[18]).astype(
        np.complex64))), lambda: sft.irfft(sft.rfft(X[18]).astype(np.complex64))),
    'irfft 1': (lambda tf, d: tf.irfft(d.from_numpy(H[16][:3]), n=1),
                lambda: sft.irfft(_c(H[16][:3]), n=1)),
    'hfft 15 forward': (lambda tf, d: tf.hfft(d.from_numpy(H[15]), n=15, norm='forward'),
                        lambda: sft.hfft(_c(H[15]), n=15, norm='forward')),
    'ihfft 16 ortho': (lambda tf, d: tf.ihfft(d.from_numpy(X[16]), norm='ortho'),
                       lambda: sft.ihfft(X[16], norm='ortho')),
    'fft2 (6, 10) s=(4, 12)': (lambda tf, d: tf.fft2(d.from_numpy(A), s=(4, 12)),
                               lambda: sft.fft2(_c(A), s=(4, 12))),
    'ifftn (3, 5, 8) axes (1, 2) ortho': (
        lambda tf, d: tf.ifftn(d.from_numpy(C3), axes=(1, 2), norm='ortho'),
        lambda: sft.ifftn(_c(C3), axes=(1, 2), norm='ortho')),
    'rfft2 (3, 5, 8)': (lambda tf, d: tf.rfft2(d.from_numpy(B3)), lambda: sft.rfft2(B3)),
    'rfftn (3, 5, 8)': (lambda tf, d: tf.rfftn(d.from_numpy(B3)), lambda: sft.rfftn(B3)),
    'irfft2 (6, 10)': (lambda tf, d: tf.irfft2(d.from_numpy(A), s=(6, 18)),
                       lambda: sft.irfft2(_c(A), s=(6, 18))),
    'hfft2 (6, 10)': (lambda tf, d: tf.hfft2(d.from_numpy(A), s=(6, 16)),
                      lambda: sft.hfft2(_c(A), s=(6, 16))),
    'ihfft2 (3, 5, 8)': (lambda tf, d: tf.ihfft2(d.from_numpy(B3)), lambda: sft.ihfft2(B3)),
    'hfftn (3, 5, 8) s=(5, 14)': (lambda tf, d: tf.hfftn(d.from_numpy(C3), s=(5, 14)),
                                  lambda: sft.hfftn(_c(C3), s=(5, 14))),
    'ihfftn (3, 5, 8)': (lambda tf, d: tf.ihfftn(d.from_numpy(B3)), lambda: sft.ihfftn(B3)),
    'ifftshift (6, 9)': (lambda tf, d: tf.ifftshift(d.from_numpy(S69)),
                         lambda: sft.ifftshift(S69)),
    'fftshift (3, 5, 8) real': (lambda tf, d: tf.fftshift(d.from_numpy(B3), axes=(0, 2)),
                                lambda: sft.fftshift(B3, axes=(0, 2))),
    'ifft(fft(x)) 15': (lambda tf, d: tf.ifft(tf.fft(d.from_numpy(Z[15]))), lambda: _c(Z[15])),
    'irfft(rfft(x)) 18': (lambda tf, d: tf.irfft(tf.rfft(d.from_numpy(X[18])), n=18),
                          lambda: X[18].astype(np.float64)),
}
# the cases held to dsc_tpu (each a 2-7 s JAX compile)
JAX_HELD = list(CASES)[:22]
STREAMING = 'fft 2 x 40000 (Bluestein m = 2^17, streaming rows)'


@pytest.fixture(scope='module')
def jax_results():
    """The JAX_HELD cases through dsc_tpu.transforms, computed once; the
    streaming case with the JAX package's K6/K7 on (interpret mode)."""
    res = {}
    for name in JAX_HELD:
        with pytest.MonkeyPatch.context() as mp:
            if name == STREAMING:
                mp.setattr(jconfig, 'STREAM_MODE', 'on')
            res[name] = CASES[name][0](jtf, dsc_tpu).numpy()
    # the compiles leave a large heap that the gc.collect() after every test
    # (tests/conftest.py) would otherwise rescan each time
    gc.freeze()
    yield res
    gc.unfreeze()


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


def _rel(got, ref):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize('name', list(CASES))
def test_exact_matches_scipy_and_jax(name, jax_results):
    call, ref = CASES[name]
    out = call(ttf, dt).numpy()
    want = ref()
    # float32 / complex64 out whatever the input's width, as in dsc_tpu
    assert out.dtype == (np.complex64 if np.iscomplexobj(want) else np.float32)
    assert _rel(out, want) < SCIPY_BOUND
    if name in jax_results:
        assert out.dtype == jax_results[name].dtype
        assert _rel(out, jax_results[name]) < PORT_BOUND


def test_c2r_contract_zeroes_the_dc_and_nyquist_imaginary_parts():
    """The core's untangle path (pow2 n <= 2^16) keeps Im X[0] and
    Im X[n/2] (the reference defect, ROADMAP §3); the tier's c2r zeroes
    them before the core, as dsc_tpu's _c2r_prog does."""
    spec, tables = plan.get_plan(16, 'real', torch.complex64)
    raw = core.irfft_batched(torch.from_numpy(H[16][None]), spec, tables, 16)[0].numpy()
    want = sft.irfft(_c(H[16]), n=16)
    assert _rel(raw, want) > 1e-2  # 0.067 on this spectrum
    assert _rel(ttf.irfft(dt.from_numpy(H[16]), n=16).numpy(), want) < 1e-6


def test_core_irfft_one_point_matches_the_jax_core():
    """n = 1: no half-size transform; the JAX core returns the real part
    (dsc_tpu/fourier/core.py irfft_batched_p)."""
    x = H[16][None, :1]
    jspec, jtables = jplan.get_plan(1, 'real', np.complex64)
    ref = np.asarray(jcore.irfft_batched_p(x.real, x.imag, jspec, jtables, 1))
    spec, tables = plan.get_plan(1, 'real', torch.complex64)
    got = core.irfft_batched(torch.from_numpy(x), spec, tables, 1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_bluestein_inner_transform_streams(monkeypatch):
    """2 x 40000: m = 2^17, whose two rows take the streaming four-step
    (config.core_streams) for the forward and the inverse; one row would
    not."""
    assert _dft.dft_plan(40000, torch.device('cpu'))[0][:3] == ('blue', 40000, 2**17)
    assert config.core_streams(2, 2**17) and not config.core_streams(1, 2**17)
    calls = []
    for name in ('phase_a', 'phase_b'):
        fn = getattr(stream, name)

        def spy(z, t, inverse, *rest, fn=fn, name=name):
            calls.append((name, tuple(z.shape), inverse))
            return fn(z, t, inverse, *rest)

        monkeypatch.setattr(stream, name, spy)
    ttf.fft(dt.from_numpy(BS))
    assert calls == [('phase_a', (2, 2**17), False), ('phase_b', (2 * 256, 512), False),
                     ('phase_a', (2, 2**17), True), ('phase_b', (2 * 256, 512), True)]


def test_t_layout_input():
    """dsc_tpu_torch.fft of one 2^18 vector returns a spectrum in the T
    layout; the tier reads it in natural order."""
    x = _sig(2**18, 14, cplx=True)
    s = dt.fft(dt.from_numpy(x))
    assert s._layout is not None
    natural = dt.from_numpy(s.numpy())
    got = ttf.fft(s).numpy()
    np.testing.assert_array_equal(got, ttf.fft(natural).numpy())
    assert _rel(got, sft.fft(sft.fft(_c(x)))) < SCIPY_BOUND


def test_plan_cache_bounded():
    for n in range(20, 60):
        _dft.dft_plan(n, torch.device('cpu'))
    assert len(_dft._plans) <= plan.MAX_FFT_PLANS == 16


@pytest.mark.parametrize('call', [
    lambda: ttf.fft(dt.from_numpy(Z[15]), n=1000),
    lambda: ttf.rfft(dt.from_numpy(X[16]), n=4096),
    lambda: ttf.irfft(dt.from_numpy(H[1000]), n=1000),
], ids=['fft Bluestein', 'rfft pow2', 'irfft Bluestein'])
def test_cached_plan_uploads_nothing(call, monkeypatch):
    """A second call of a cached plan builds no core plan and uploads no
    table, also after the core's own LRU has dropped the plan."""
    first = call().numpy()
    built = []
    for module, name in ((_dft, 'upload'), (plan, '_build_plan')):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, fn=fn, name=name, **k: built.append(name) or fn(*a, **k))
    np.testing.assert_array_equal(call().numpy(), first)
    plan.clear_plans()
    np.testing.assert_array_equal(call().numpy(), first)
    assert built == []


def test_plan_missing_during_a_capture_raises(monkeypatch):
    """A CUDA graph cannot capture a table upload: a transforms plan
    missing while a dsc.compile program captures raises (as the core's
    plan.get_plan does); a cached one is served."""
    cpu = torch.device('cpu')
    cached = _dft.dft_plan(999, cpu)
    monkeypatch.setattr(_dft, 'capturing', lambda: True)
    assert _dft.dft_plan(999, cpu) is cached
    with pytest.raises(RuntimeError, match='DSC_MAX_FFT_PLANS'):
        _dft.dft_plan(997, cpu)


def test_plans_are_keyed_on_the_device():
    """A plan for another device is an entry of its own whose tables live
    there ('meta' stands in for a card here), so a CPU plan never serves a
    CUDA call."""
    cpu, meta = torch.device('cpu'), torch.device('meta')
    static, tabs = _dft.dft_plan(1000, cpu)
    mstatic, mtabs = _dft.dft_plan(1000, meta)
    assert ('c2c', 1000, 'cpu') in _dft._plans and ('c2c', 1000, 'meta') in _dft._plans
    assert static == mstatic
    assert {t.device.type for t in tabs[1:]} == {'cpu'}
    assert {t.device.type for t in mtabs[1:]} == {'meta'}
    assert tabs[0].device.type == 'cpu' and mtabs[0].device.type == 'meta'


ERRORS = {
    'bogus norm': lambda tf, d: tf.fft(d.from_numpy(X[16]), norm='bogus'),
    'axis out of range': lambda tf, d: tf.fft(d.from_numpy(X[16]), axis=2),
    'rfft of complex input': lambda tf, d: tf.rfft(d.from_numpy(Z[16])),
    's and axes lengths': lambda tf, d: tf.fftn(d.from_numpy(X[16]), s=(4, 4), axes=(0,)),
    'next_fast_len(0)': lambda tf, d: tf.next_fast_len(0),
    'prev_fast_len(0)': lambda tf, d: tf.prev_fast_len(0),
    'irfft of one bin, no n': lambda tf, d: tf.irfft(d.from_numpy(Z[1])),
    'irfft n=0': lambda tf, d: tf.irfft(d.from_numpy(Z[16]), n=0),
    'fft n=0': lambda tf, d: tf.fft(d.from_numpy(Z[16]), n=0),
    'repeated axes': lambda tf, d: tf.fftn(d.from_numpy(A), axes=(0, 0)),
    'set_workers(0)': lambda tf, d: tf.set_workers(0).__enter__(),
}


@pytest.mark.parametrize('name', list(ERRORS))
def test_errors(name):
    for tf, d in ((jtf, dsc_tpu), (ttf, dt)):
        with pytest.raises(RuntimeError):
            ERRORS[name](tf, d)


def test_helpers_match_jax():
    for n, d in ((10, 0.25), (9, 2.0), (1, 1.0)):
        np.testing.assert_array_equal(ttf.fftfreq(n, d).numpy(), jtf.fftfreq(n, d).numpy())
        np.testing.assert_array_equal(ttf.rfftfreq(n, d).numpy(), jtf.rfftfreq(n, d).numpy())
        assert np.allclose(ttf.fftfreq(n, d).numpy(), sft.fftfreq(n, d), atol=1e-6)
    for target in (1, 2, 1000, 1024, 1025):
        assert ttf.next_fast_len(target) == jtf.next_fast_len(target)
        assert ttf.prev_fast_len(target) == jtf.prev_fast_len(target)
    assert ttf.get_workers() == 1
    with ttf.set_workers(4):
        assert ttf.get_workers() == 4
        with ttf.set_workers(-1):
            assert ttf.get_workers() == -1
    assert ttf.get_workers() == 1


def test_exports_match_jax():
    assert ttf.__all__ == jtf.__all__ and len(ttf.__all__) == 37
    assert all(callable(getattr(ttf, name)) for name in ttf.__all__)


def test_sources_use_no_library_fft_and_no_jax():
    """No torch.fft call and no import of jax or dsc_tpu in the
    subpackage."""
    root = pathlib.Path(ttf.__file__).parent
    sources = sorted(root.glob('*.py'))
    assert [p.name for p in sources] == ['__init__.py', '_dft.py', 'exact.py', 'fftlog.py',
                                         'trig.py']
    library = re.compile(r'(?<![\w.])torch\.fft\b|^\s*from\s+torch\s+import\s.*\bfft\b', re.M)
    banned = re.compile(r'^\s*(import|from)\s+(jax|dsc_tpu)\b', re.M)
    for path in sources:
        text = path.read_text()
        assert not library.search(text), path
        assert not banned.search(text), path
    # the patterns find what they look for
    assert library.search('y = torch.fft.fft(x)') and banned.search('import jax.numpy as jnp')
    assert not library.search('dsc_tpu_torch.fft(x)')
