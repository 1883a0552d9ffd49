"""The DCT/DST family (transforms/trig.py) and the FFTLog Hankel transform
(transforms/fftlog.py) of dsc_tpu_torch against dsc_tpu.transforms and
scipy.fft on the same inputs, on the CPU: types I-IV of both kinds over
pow2, even, odd and prime lengths, every norm, orthogonalize, n and axis,
the n-D forms, complex and float64 inputs, a type-IV DST whose inner 2^17
DFT streams (the JAX package's K6/K7 in interpret mode), fht/ifht with and
without bias, fhtoffset, the host design math (log-gamma, poch) and the
errors. Port results are held to dsc_tpu within 1e-5 of the largest value
where a case is in JAX_HELD, and every result to scipy.fft in float64
within the JAX package's bound (tests/test_transforms.py ``_close``)."""

import gc

import numpy as np
import pytest
import scipy.fft as sft
import scipy.special as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.transforms as jtf  # noqa: E402
from dsc_tpu.fourier import config as jconfig  # noqa: E402
from dsc_tpu.transforms import fftlog as jfftlog  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.transforms as ttf  # noqa: E402
from dsc_tpu_torch.fourier import config, stream  # noqa: E402
from dsc_tpu_torch.transforms import fftlog  # noqa: E402

PORT_BOUND = 1e-5   # against dsc_tpu, relative to the largest value
SCIPY_BOUND = 2e-4  # against scipy.fft in float64 (tests/test_transforms.py _close)


def _sig(shape, seed, cplx=False, dtype=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype or (np.complex64 if cplx else np.float32))


X = {n: _sig(n, 300 + n) for n in (16, 12, 11, 7, 17, 32, 1)}
B3 = _sig((4, 6, 5), 8)
Z12 = _sig(12, 7, cplx=True)
F64 = _sig(12, 9, dtype=np.float64)
R4 = _sig((2, 2**16), 10)  # DST-IV: an inner 2^17 DFT over 2 rows, which streams
A16 = _sig(16, 11)
A15 = _sig(15, 12)
AB = _sig((3, 16), 13)
DLN, MU, BIAS = 0.08, 0.5, 0.4


def _f(a):
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def _trig(kind, x, **kw):
    """(port-or-JAX call, scipy reference) of scipy.fft.<kind> on x."""
    return (lambda tf, d: getattr(tf, kind)(d.from_numpy(x), **kw),
            lambda: getattr(sft, kind)(_f(x), **kw))


_OFF = jfftlog.fhtoffset(DLN, MU, initial=0.2, bias=BIAS)

CASES = {
    'dct I 12': _trig('dct', X[12], type=1),
    'dct II 12': _trig('dct', X[12], type=2),
    'dct III 12': _trig('dct', X[12], type=3),
    'dct IV 12': _trig('dct', X[12], type=4),
    'idct II 11 forward': _trig('idct', X[11], type=2, norm='forward'),
    'dst III 11 ortho': _trig('dst', X[11], type=3, norm='ortho'),
    'idst I 7 ortho': _trig('idst', X[7], type=1, norm='ortho'),
    'dctn III s=(5, 4) axes (0, 2) ortho': _trig('dctn', B3, type=3, s=(5, 4), axes=(0, 2),
                                                 norm='ortho'),
    'idstn IV forward': _trig('idstn', B3, type=4, norm='forward'),
    'dct II 12 complex ortho': _trig('dct', Z12, type=2, norm='ortho'),
    'dst II 12 float64 input': _trig('dst', F64, type=2),
    'dst IV (2, 2^16)': _trig('dst', R4, type=4),
    'fht 16 mu 0': (lambda tf, d: tf.fht(d.from_numpy(A16), 0.1, 0.0),
                    lambda: sft.fht(_f(A16), 0.1, 0.0)),
    'ifht 15 mu 0.5': (lambda tf, d: tf.ifht(d.from_numpy(A15), 0.1, 0.5),
                       lambda: sft.ifht(_f(A15), 0.1, 0.5)),
    'fht (3, 16) offset bias': (
        lambda tf, d: tf.fht(d.from_numpy(AB), DLN, MU, offset=_OFF, bias=BIAS),
        lambda: sft.fht(_f(AB), DLN, MU, offset=_OFF, bias=BIAS)),
    'ifht (3, 16) offset bias': (
        lambda tf, d: tf.ifht(d.from_numpy(AB), DLN, MU, offset=_OFF, bias=BIAS),
        lambda: sft.ifht(_f(AB), DLN, MU, offset=_OFF, bias=BIAS)),
    # the rest: scipy.fft alone
    'dct I 7 ortho': _trig('dct', X[7], type=1, norm='ortho'),
    'dct II 1': _trig('dct', X[1], type=2),
    'dst I 1': _trig('dst', X[1], type=1),
    'dct II 12 n=9 axis 1 orthogonalize': _trig('dct', B3, type=2, n=9, axis=1,
                                                orthogonalize=True),
    'dst III n=4 axis 0 ortho, not orthogonalized': _trig('dst', B3, type=3, n=4, axis=0,
                                                          norm='ortho', orthogonalize=False),
    'dst III 12 complex': _trig('dst', Z12, type=3),
    'idctn II': _trig('idctn', B3, type=2),
    'dstn II axes (1,)': _trig('dstn', B3, type=2, axes=(1,)),
    'dctn I ortho': _trig('dctn', B3, type=1, norm='ortho'),
    'fht 32 dln 0.05 mu 1 low-ringing offset': (
        lambda tf, d: tf.fht(d.from_numpy(X[32]), 0.05, 1.0, offset=tf.fhtoffset(0.05, 1.0)),
        lambda: sft.fht(_f(X[32]), 0.05, 1.0, offset=sft.fhtoffset(0.05, 1.0))),
    'fht 15 mu 2': (lambda tf, d: tf.fht(d.from_numpy(A15), 0.1, 2.0),
                    lambda: sft.fht(_f(A15), 0.1, 2.0)),
    'ifht 16 mu 2 bias -0.3': (lambda tf, d: tf.ifht(d.from_numpy(A16), 0.1, 2.0, bias=-0.3),
                               lambda: sft.ifht(_f(A16), 0.1, 2.0, bias=-0.3)),
}
# every kind, type, norm and length of the JAX package's sweep, against scipy
for _kind in ('dct', 'dst', 'idct', 'idst'):
    for _type in (1, 2, 3, 4):
        for _n in (16, 12, 11, 17):
            for _norm in (None, 'ortho', 'forward'):
                CASES[f'{_kind} {_type} {_n} {_norm}'] = _trig(_kind, X[_n], type=_type,
                                                               norm=_norm)
# the cases held to dsc_tpu (each a 1-7 s JAX compile)
JAX_HELD = list(CASES)[:16]
STREAMING = 'dst IV (2, 2^16)'


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
def test_trig_fftlog_match_scipy_and_jax(name, jax_results):
    call, ref = CASES[name]
    out = call(ttf, dt).numpy()
    want = ref()
    assert out.dtype == (np.complex64 if np.iscomplexobj(want) else np.float32)
    assert _rel(out, want) < SCIPY_BOUND
    if name in jax_results:
        assert out.dtype == jax_results[name].dtype
        assert _rel(out, jax_results[name]) < PORT_BOUND


def test_dst4_inner_transform_streams(monkeypatch):
    """DST-IV of (2, 2^16): one inverse complex 2^17 DFT over the 2 rows,
    which the core streams (K6 + K7)."""
    assert config.core_streams(2, 2**17)
    calls = []
    fourstep = stream.fourstep_stream

    def spy(x, n1, n2, inverse, real_output=False):
        calls.append((tuple(x.shape), x.dtype, inverse))
        return fourstep(x, n1, n2, inverse, real_output=real_output)

    monkeypatch.setattr(stream, 'fourstep_stream', spy)
    ttf.dst(dt.from_numpy(R4), type=4)
    assert calls == [((2, 2**17), torch.complex64, True)]


@pytest.mark.parametrize('type_', [1, 2, 3, 4])
def test_roundtrips(type_):
    x = _sig(24, 5)
    for fwd, inv in ((ttf.dct, ttf.idct), (ttf.dst, ttf.idst)):
        got = inv(fwd(dt.from_numpy(x), type=type_), type=type_).numpy()
        assert _rel(got, x.astype(np.float64)) < SCIPY_BOUND
    a = _sig(32, 11)
    off = ttf.fhtoffset(0.05, 1.0)
    got = ttf.ifht(ttf.fht(dt.from_numpy(a), 0.05, 1.0, offset=off), 0.05, 1.0, offset=off)
    assert _rel(got.numpy(), a.astype(np.float64)) < SCIPY_BOUND


@pytest.mark.parametrize('dln,mu,initial,bias', [(0.08, 0.5, 0.2, 0.4), (0.05, 1.0, 0.0, 0.0),
                                                 (0.1, 2.0, -0.5, -0.3)])
def test_fhtoffset(dln, mu, initial, bias):
    got = ttf.fhtoffset(dln, mu, initial=initial, bias=bias)
    assert got == jtf.fhtoffset(dln, mu, initial=initial, bias=bias)
    assert abs(got - sft.fhtoffset(dln, mu, initial=initial, bias=bias)) < 1e-12


def test_host_design_math_is_the_references():
    """The port's copies of the host math give the JAX package's values
    exactly, and log-gamma / poch agree with scipy.special."""
    z = np.array([0.3 + 2j, 2.5 - 1j, -1.7 + 0.4j, 10 + 30j])
    np.testing.assert_array_equal(fftlog._loggamma(z), jfftlog._loggamma(z))
    assert np.allclose(np.exp(fftlog._loggamma(z)), np.exp(sps.loggamma(z)), rtol=1e-12)
    for a, d in ((0.75, 0.5), (-2.0, 1.0), (-2.0, 3.0), (1.5, -2.5), (-1.0, -1.0)):
        assert fftlog._poch(a, d) == jfftlog._poch(a, d)
    assert abs(fftlog._poch(0.75, 0.5) - sps.poch(0.75, 0.5)) < 1e-12
    for n, inverse in ((16, False), (15, True)):
        np.testing.assert_array_equal(fftlog._fht_coeff(n, 0.1, 0.5, 0.2, 0.4, inverse),
                                      jfftlog._fht_coeff(n, 0.1, 0.5, 0.2, 0.4, inverse))


ERRORS = {
    'dct type 5': lambda tf, d: tf.dct(d.from_numpy(X[16]), type=5),
    'dct I of one point': lambda tf, d: tf.dct(X[1], type=1),
    'dst bogus norm': lambda tf, d: tf.dst(d.from_numpy(X[16]), norm='bogus'),
    'dct n=0': lambda tf, d: tf.dct(d.from_numpy(X[16]), n=0),
    'dctn repeated axes': lambda tf, d: tf.dctn(d.from_numpy(B3), axes=(1, 1)),
    'fht dln 0': lambda tf, d: tf.fht(d.from_numpy(A16), 0.0, 0.5),
    'fht of complex input': lambda tf, d: tf.fht(d.from_numpy(Z12), 0.1, 0.5),
}


@pytest.mark.parametrize('name', list(ERRORS))
def test_errors(name):
    for tf, d in ((jtf, dsc_tpu), (ttf, dt)):
        with pytest.raises(RuntimeError):
            ERRORS[name](tf, d)
