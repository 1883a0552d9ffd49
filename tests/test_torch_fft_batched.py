"""The streaming slice of dsc_tpu_torch on CPU tensors: batched and
non-last-axis transforms, the fft2 family, the single-vector ifft and
irfft of dense spectra, and their ``out=`` variants, through the public
API of both packages on the same inputs.

The JAX package runs with ``fft_config.STREAM_MODE = 'on'``, as
tests/test_planar.py runs it, so its streaming kernels K6/K7 (and K11)
run in interpret mode; its results are computed once per module. The port
runs the plain versions of K6/K7/K11. Also: the routing table of
fourier/config.py case by case (the same on every device), which engine each
public call reaches, and the complex128 irfft that the JAX package's K11
refuses."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
from dsc_tpu.fourier import config as jconfig  # noqa: E402
from dsc_tpu.fourier import pallas_stream as jps  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch.dtype import Dtype  # noqa: E402
from dsc_tpu_torch.fourier import config, packed_fused, reconstruct, stream  # noqa: E402

JAX_BOUND = 3e-5    # the JAX kernels' bf16x3 stages are good to ~1e-5
NUMPY_BOUND = 1e-5  # relative to max, against np.fft in float64


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**33, device='cpu')
    yield
    dt.shutdown()


def _c(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _spectrum(rng, shape):
    """rfft of a real signal of ``shape`` over its last axis: a dense
    complex64 spectrum with real DC and Nyquist bins."""
    return np.fft.rfft(rng.standard_normal(shape)).astype(np.complex64)


RNG = np.random.default_rng(31)
C6, R6 = _c(RNG, (6, 2**16)), RNG.standard_normal((6, 2**16)).astype(np.float32)
C2, R2 = _c(RNG, (2, 2**18)), RNG.standard_normal((2, 2**18)).astype(np.float32)
RA = RNG.standard_normal((2**16, 6)).astype(np.float32)
S6, S2 = _spectrum(RNG, (6, 2**16)), _spectrum(RNG, (2, 2**18))
SA = np.ascontiguousarray(_spectrum(RNG, (6, 2**16)).T)
C16, R16 = _c(RNG, (16, 32)), RNG.standard_normal((16, 32)).astype(np.float32)
# the rfft2 of R6 and R16 (R6's first axis padded to 8): valid 2-D spectra
S8 = np.fft.rfft2(R6, s=(8, 2**16)).astype(np.complex64)
S16 = np.fft.rfft2(R16).astype(np.complex64)
V, W = _c(RNG, 2**18), RNG.standard_normal(2**18).astype(np.float32)
SP = _spectrum(RNG, 2**18)


def _out(d, shape, dtype):
    return d.from_numpy(np.zeros(shape, dtype))


# name -> (call on a package, np.fft in float64, stream pairs, K11 launches)
CASES = {
    'fft 6x2^16': (lambda d: d.fft(d.from_numpy(C6)), lambda: np.fft.fft(C6), 1, 0),
    'ifft 6x2^16': (lambda d: d.ifft(d.from_numpy(C6)), lambda: np.fft.ifft(C6), 1, 0),
    'rfft 6x2^16': (lambda d: d.rfft(d.from_numpy(R6)), lambda: np.fft.rfft(R6), 1, 0),
    'irfft 6x2^16': (lambda d: d.irfft(d.from_numpy(S6)), lambda: np.fft.irfft(S6), 1, 0),
    'fft 2x2^18': (lambda d: d.fft(d.from_numpy(C2)), lambda: np.fft.fft(C2), 1, 0),
    'ifft 2x2^18': (lambda d: d.ifft(d.from_numpy(C2)), lambda: np.fft.ifft(C2), 1, 0),
    'rfft 2x2^18': (lambda d: d.rfft(d.from_numpy(R2)), lambda: np.fft.rfft(R2), 1, 0),
    'irfft 2x2^18': (lambda d: d.irfft(d.from_numpy(S2)), lambda: np.fft.irfft(S2), 1, 0),
    'rfft axis 0 (2^16, 6)': (lambda d: d.rfft(d.from_numpy(RA), axis=0),
                              lambda: np.fft.rfft(RA, axis=0), 1, 0),
    'irfft axis 0 (2^15+1, 6)': (lambda d: d.irfft(d.from_numpy(SA), axis=0),
                                 lambda: np.fft.irfft(SA, axis=0), 1, 0),
    'fft2 (6, 2^16)': (lambda d: d.fft2(d.from_numpy(C6)),
                       lambda: np.fft.fft2(C6, s=(8, 2**16)), 1, 0),
    'ifft2 (6, 2^16)': (lambda d: d.ifft2(d.from_numpy(C6)),
                        lambda: np.fft.ifft2(C6, s=(8, 2**16)), 1, 0),
    'rfft2 (6, 2^16)': (lambda d: d.rfft2(d.from_numpy(R6)),
                        lambda: np.fft.rfft2(R6, s=(8, 2**16)), 1, 0),
    'irfft2 (8, 2^15+1)': (lambda d: d.irfft2(d.from_numpy(S8)),
                           lambda: np.fft.irfft2(S8), 1, 0),
    'fft2 (16, 32)': (lambda d: d.fft2(d.from_numpy(C16)), lambda: np.fft.fft2(C16), 0, 0),
    'ifft2 (16, 32)': (lambda d: d.ifft2(d.from_numpy(C16)), lambda: np.fft.ifft2(C16), 0, 0),
    'rfft2 (16, 32)': (lambda d: d.rfft2(d.from_numpy(R16)), lambda: np.fft.rfft2(R16), 0, 0),
    'irfft2 (16, 17)': (lambda d: d.irfft2(d.from_numpy(S16)),
                        lambda: np.fft.irfft2(S16), 0, 0),
    'irfft single 2^18 dense': (lambda d: d.irfft(d.from_numpy(SP)),
                                lambda: np.fft.irfft(SP), 1, 1),
    'fft out= single 2^18': (lambda d: d.fft(d.from_numpy(V), out=_out(d, 2**18, np.complex64)),
                             lambda: np.fft.fft(V), 1, 0),
    'rfft out= single 2^18': (lambda d: d.rfft(d.from_numpy(W),
                                               out=_out(d, 2**17 + 1, np.complex64)),
                              lambda: np.fft.rfft(W), 1, 0),
    'irfft out= single 2^18': (lambda d: d.irfft(d.from_numpy(SP),
                                                 out=_out(d, 2**18, np.float32)),
                               lambda: np.fft.irfft(SP), 1, 1),
    'fft out= 2x2^18': (lambda d: d.fft(d.from_numpy(C2), out=_out(d, C2.shape, np.complex64)),
                        lambda: np.fft.fft(C2), 1, 0),
}
# cases held to another case's JAX result (the same function of the same
# input), which saves an interpret-mode compile
SAME_AS = {'fft out= 2x2^18': 'fft 2x2^18'}


@pytest.fixture(scope='module')
def jax_results():
    """Every case through dsc_tpu with its streaming kernels on (interpret
    mode), computed once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, 'STREAM_MODE', 'on')
        res = {name: call(dsc_tpu).numpy() for name, (call, *_) in CASES.items()
               if name not in SAME_AS}
    res.update({name: res[same] for name, same in SAME_AS.items()})
    # the compiles leave a large heap that the gc.collect() after every test
    # (tests/conftest.py) would otherwise rescan each time
    gc.freeze()
    yield res
    gc.unfreeze()


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('name', list(CASES))
def test_public_api_matches_jax_and_numpy(name, jax_results, monkeypatch):
    call, exact, pairs, k11 = CASES[name]
    seen = {'phase_a': 0, 'phase_b': 0, 'k11': 0}

    def spy(key, fn, counts_k11=False):
        def wrapped(*args, **kw):
            seen[key] += reconstruct.kernel_takes(*args) if counts_k11 else 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(stream, 'phase_a', spy('phase_a', stream.phase_a))
    monkeypatch.setattr(stream, 'phase_b', spy('phase_b', stream.phase_b))
    monkeypatch.setattr(reconstruct, 'reconstruct_spectrum',
                        spy('k11', reconstruct.reconstruct_spectrum, counts_k11=True))
    got = call(dt).numpy()
    ref = jax_results[name]
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype
    assert _rel(got, ref) < JAX_BOUND
    assert _rel(got, exact()) < NUMPY_BOUND
    # the engines this call reaches: K6+K7 pairs and K11 (plain versions here)
    assert (seen['phase_a'], seen['phase_b'], seen['k11']) == (pairs, pairs, k11)


def test_complex128_irfft_returns_what_the_jax_kernel_refuses():
    """K11 stores float32 into the float64 buffers of a complex128 row
    (pallas_reconstruct.py:62-72, :175-182): the JAX package raises, the
    port returns np.fft's value (ROADMAP.md §3)."""
    x = np.fft.rfft(np.random.default_rng(9).standard_normal(2**18))
    got = dt.irfft(dt.from_numpy(x)).numpy()
    ref = np.fft.irfft(x)
    assert got.shape == ref.shape and got.dtype == np.float64
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-10
    with pytest.raises(ValueError, match='dtype'):
        dsc_tpu.irfft(dsc_tpu.from_numpy(x)).numpy()


def test_out_variants_write_through():
    o = dt.from_numpy(np.zeros(2**18, np.float32))
    res = dt.irfft(dt.from_numpy(SP), out=o)
    assert np.array_equal(o.numpy(), res.numpy())
    assert _rel(o.numpy(), np.fft.irfft(SP)) < NUMPY_BOUND


F32, C32, C64 = Dtype.F32, Dtype.C32, Dtype.C64

# (route function, dtype, batch, n, extra arguments, route); the route does
# not depend on the device
ROUTES = [
    # batched, last axis or not: the batch alone enters the rule
    ('fft', C32, 6, 2**16, (False,), {}, 'stream'),
    ('fft', C32, 256, 2**16, (True,), {}, 'stream'),
    ('fft', F32, 16, 2**20, (False,), {}, 'stream'),
    ('rfft', F32, 64, 2**18, (), {}, 'stream'),
    ('rfft', F32, 6, 2**16, (), {}, 'stream'),
    ('irfft', C32, 16, 2**20, (), {}, 'stream'),
    ('irfft', C32, 6, 2**16, (), {}, 'stream'),
    # single-vector ifft of a natural-order input
    ('fft', C32, 1, 2**18, (True,), {}, 'stream'),
    ('fft', C32, 1, 2**26, (True,), {}, 'stream'),
    # single-vector irfft of a dense spectrum where the packed engine does not apply
    ('irfft', C32, 1, 2**18, (), {}, 'reconstruct+stream'),
    ('irfft', C32, 1, 2**19, (), {}, 'reconstruct+stream'),
    # the packed engine, unchanged
    ('rfft', F32, 1, 2**20, (), {}, 'packed'),
    ('irfft', C32, 1, 2**26, (), {}, 'packed'),
    # out=: the core streams by size, a single vector too
    ('fft', C32, 1, 2**21, (False,), {'out': True}, 'stream'),
    ('fft', C32, 6, 2**16, (False,), {'out': True}, 'stream'),
    ('rfft', F32, 1, 2**21, (), {'out': True}, 'stream'),
    ('rfft', F32, 6, 2**16, (), {'out': True}, 'core'),
    ('irfft', C32, 1, 2**21, (), {'out': True}, 'reconstruct+stream'),
    ('irfft', C32, 1, 2**18, (), {'out': True}, 'reconstruct+stream'),
    ('irfft', C32, 4, 2**18, (), {'out': True}, 'stream'),
    ('irfft', C32, 6, 2**16, (), {'out': True}, 'core'),
    # complex128 takes the plain reconstruction and core (K11 raises in the JAX package)
    ('irfft', C64, 1, 2**18, (), {}, 'core'),
    ('fft', C64, 6, 2**16, (False,), {}, 'core'),
    # the fft2 family's short axis: 256-point columns of a (256, 2^16) array
    ('fft', C32, 2**16, 256, (False,), {}, 'core'),
    # a single vector into the T layout: K6+K8
    ('fft', C32, 1, 2**18, (False,), {}, 'stream_t'),
    ('fft', F32, 1, 2**24, (False,), {}, 'stream_t'),
    ('rfft', F32, 1, 2**18, (), {}, 'stream_t'),
    ('rfft', F32, 1, 2**19, (), {}, 'stream_t'),
    # out of the T layout: K9+K10 for the ifft of a full-T spectrum and the
    # irfft of a half-T one of this n; any other layout, or out=, reads
    # natural order
    ('fft', C32, 1, 2**18, (True,), {'layout': (512, 512, False)}, 'stream_t'),
    ('irfft', C32, 1, 2**19, (), {'layout': (1024, 512, True)}, 'stream_t'),
    ('fft', C32, 1, 2**18, (False,), {'layout': (512, 512, False)}, 'stream'),
    ('fft', C32, 1, 2**18, (True,), {'layout': (512, 512, True)}, 'stream'),
    ('fft', C32, 1, 2**19, (True,), {'layout': (512, 512, False)}, 'stream'),
    ('fft', C32, 1, 2**18, (True,), {'layout': (512, 512, False), 'out': True}, 'stream'),
    ('irfft', C32, 1, 2**18, (), {'layout': (512, 512, False)}, 'reconstruct+stream'),
    ('irfft', C32, 1, 2**18, (), {'layout': (512, 512, True), 'out': True},
     'reconstruct+stream'),
    # the edges of `supported`: batch 1 and 37 at 256 x 256 do not stream,
    # 6 and 32 do; B*n = 2^27 streams, 2^28 does not
    ('fft', C32, 1, 2**16, (True,), {}, 'core'),
    ('fft', C32, 37, 2**16, (False,), {}, 'core'),
    ('fft', C32, 32, 2**16, (False,), {}, 'stream'),
    ('fft', C32, 2**9, 2**18, (False,), {}, 'stream'),
    ('fft', C32, 2**10, 2**18, (False,), {}, 'core'),
    ('rfft', F32, 2**10, 2**18, (), {}, 'core'),
    ('irfft', C32, 37, 2**16, (), {}, 'core'),
]
ROUTE_FNS = {'fft': config.fft_route, 'rfft': config.rfft_route, 'irfft': config.irfft_route}


@pytest.mark.parametrize('row', ROUTES, ids=lambda r: f'{r[0]}-{r[1].name}-{r[2]}x{r[3]}'
                         f'{"-inv" if r[4] == (True,) else ""}{"-out" if r[5].get("out") else ""}'
                         f'{"-T%s" % (r[5]["layout"],) if r[5].get("layout") else ""}')
def test_route_table(row):
    fn, dtype, batch, n, extra, kw, route = row
    assert ROUTE_FNS[fn](dtype, batch, n, *extra, **kw) == route


@pytest.mark.parametrize('batch,n', [(1, 2**16), (37, 2**16), (6, 2**16), (32, 2**16),
                                     (1, 2**17), (2, 2**17), (1, 2**18), (2**9, 2**18),
                                     (2**10, 2**18), (1, 2**26), (2, 2**26), (1, 2**27)])
def test_use_stream_matches_reference(batch, n, monkeypatch):
    monkeypatch.setattr(jconfig, 'STREAM_MODE', 'on')
    assert config.use_stream(batch, n) == jconfig.use_stream(np.complex64, batch, n)
    n1, n2 = stream.factors(n)
    assert (n1, n2) == jps.factors(n)
    assert stream._group(batch, n1) == jps._group(batch, n1)
    assert stream.supported(n1, n2, np.complex64, batch) == \
        jps.supported(n1, n2, np.complex64, batch)


def test_packed_route_is_taken_without_out(monkeypatch):
    calls = []
    monkeypatch.setattr(packed_fused, 'rfft_packed',
                        lambda x, t: calls.append('rfft') or packed_fused.rfft_packed_plain(x, t))
    x = np.random.default_rng(2).standard_normal(2**20).astype(np.float32)
    dt.rfft(dt.from_numpy(x))
    assert calls == ['rfft']
    dt.rfft(dt.from_numpy(x), out=_out(dt, 2**19 + 1, np.complex64))
    assert calls == ['rfft']  # with out= the core streams the full-size transform
