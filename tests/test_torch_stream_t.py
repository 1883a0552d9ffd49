"""Plain versions of K8, K9 and K10 (dsc_tpu_torch/fourier/stream_t.py), with
K6 before K8, against the JAX package's ``fourstep_to_t_p`` and
``fourstep_from_t_p`` (dsc_tpu/fourier/pallas_stream_t.py) on the same
inputs, run in interpret mode on the CPU as tests/test_stream_t.py runs
them, at its shapes: the square 512 x 512 split (n = 2^18) and the
1024 x 512 one (2^19). The JAX results are computed once per module; the
inverse of each takes the very spectrum the JAX forward stored, carried
across by ``interop.from_t``.

Bounds, relative to max |reference|: 3e-5 against the JAX kernels, whose
bf16x3 DFT stages are good to about 1e-5, and 1e-5 against np.fft in
float64."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu.fourier import pallas_stream_t as jpst  # noqa: E402
from dsc_tpu_torch.fourier import plan, stream, stream_t  # noqa: E402

JAX_BOUND = 3e-5
NUMPY_BOUND = 1e-5
SHAPES = [(512, 512), (1024, 512)]
# forward variants: name -> (half layout, real input)
FORWARD = {'full complex': (False, False), 'full real': (False, True), 'half': (True, True)}


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


def _inputs(n1, n2):
    rng = np.random.default_rng(n1 + 3 * n2)
    re, im = (rng.standard_normal(n1 * n2).astype(np.float32) for _ in range(2))
    return re, im


def _input(variant, n1, n2):
    re, im = _inputs(n1, n2)
    return re if FORWARD[variant][1] else (re + 1j * im).astype(np.complex64)


def _t_of(x, n1, n2, half):
    """np.fft's spectrum of x in float64, in the (half-)T layout."""
    s = np.fft.fft(x.astype(np.complex128)).reshape(n2, n1).T
    return s[:, :stream_t.width(n2, half)]


@pytest.fixture(scope='module')
def jax_results():
    """For each shape: the JAX planes of every forward variant, and the
    JAX inverse of the full complex and the half spectra (interpret mode)."""
    out = {}
    for n1, n2 in SHAPES:
        re, im = _inputs(n1, n2)

        def run(r, i, n1=n1, n2=n2):
            full = jpst.fourstep_to_t_p(r, i, n1, n2, half=False)
            full_real = jpst.fourstep_to_t_p(r, None, n1, n2, half=False)
            half = jpst.fourstep_to_t_p(r, None, n1, n2, half=True)
            inv_full = jpst.fourstep_from_t_p(*full, n1, n2, half=False, real_output=False)
            inv_half, _ = jpst.fourstep_from_t_p(*half, n1, n2, half=True, real_output=True)
            return full, full_real, half, inv_full, inv_half

        full, full_real, half, inv_full, inv_half = jax.jit(run)(re, im)
        planes = {'full complex': full, 'full real': full_real, 'half': half}
        for variant, (hr, hi) in planes.items():
            out[(n1, n2, variant)] = (np.asarray(hr), np.asarray(hi))
        out[(n1, n2, 'inverse full')] = np.asarray(inv_full[0]) + 1j * np.asarray(inv_full[1])
        out[(n1, n2, 'inverse half')] = np.asarray(inv_half)
    # the compiles leave a large heap that the gc.collect() after every test
    # (tests/conftest.py) would otherwise rescan each time
    gc.freeze()
    yield out
    gc.unfreeze()


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('variant', list(FORWARD))
@pytest.mark.parametrize('n1,n2', SHAPES)
def test_fourstep_to_t_matches_jax_and_numpy(n1, n2, variant, jax_results):
    half = FORWARD[variant][0]
    x = _input(variant, n1, n2)
    got = stream_t.fourstep_to_t(torch.from_numpy(x), n1, n2, half).numpy()
    cols = stream_t.width(n2, half)
    assert got.shape == (n1, cols) and got.dtype == np.complex64
    hr, hi = jax_results[(n1, n2, variant)]
    ref = hr[:n1, :cols] + 1j * hi[:n1, :cols]
    assert _rel(got, ref) < JAX_BOUND
    assert _rel(got, _t_of(x, n1, n2, half)) < NUMPY_BOUND


@pytest.mark.parametrize('half', [False, True], ids=['full', 'half'])
@pytest.mark.parametrize('n1,n2', SHAPES)
def test_fourstep_from_t_matches_jax_and_numpy(n1, n2, half, jax_results):
    """The inverse of the spectrum the JAX forward stored (pad rows and lane
    padding dropped by interop.from_t)."""
    hr, hi = jax_results[(n1, n2, 'half' if half else 'full complex')]
    spec = dt.from_t(hr, hi, n1, n2, half)
    assert spec._layout == (n1, n2, half)
    got = stream_t.fourstep_from_t(spec._stored, n1, n2, half, real_output=half).numpy()
    ref = jax_results[(n1, n2, 'inverse half' if half else 'inverse full')]
    assert got.shape == ref.shape == (n1 * n2,)
    assert got.dtype == (np.float32 if half else np.complex64)
    assert _rel(got, ref) < JAX_BOUND
    nat = spec.numpy().astype(np.complex128)
    exact = np.fft.irfft(nat, n1 * n2) if half else np.fft.ifft(nat)
    assert _rel(got, exact) < NUMPY_BOUND


@pytest.mark.parametrize('n1,n2', SHAPES)
def test_inverse_half_from_exact_spectrum(n1, n2):
    """An exact (np.fft) half-T spectrum in the JAX package's planes, whose
    pad rows and padding lanes are NaN: they must not reach the output
    (tests/test_stream_t.py:82-97), through the public irfft."""
    sig = np.random.default_rng(17).standard_normal(n1 * n2).astype(np.float32)
    ref = _t_of(sig, n1, n2, True)
    shape = (n1 + jpst.PAD_ROWS, jpst.nc_for(n2, True))
    hr, hi = np.full(shape, np.nan, np.float32), np.full(shape, np.nan, np.float32)
    hr[:n1, :n2 // 2 + 1] = ref.real
    hi[:n1, :n2 // 2 + 1] = ref.imag
    got = dt.irfft(dt.from_t(hr, hi, n1, n2, True)).numpy()
    assert got.shape == sig.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - sig).max() < 2e-4


@pytest.mark.parametrize('n1,n2', SHAPES)
def test_phases_layout_contract(n1, n2):
    """Each phase's output against np.fft in float64, and the CPU wrappers
    run the plain versions exactly:
    S[k1, k2] = sum_j2 Z[j2, k1] W_n2^(j2*k2) (K8),
    Y[k1, j2] = W_n^(-k1*j2) sum_k2 S[k1, k2] W_n2^(-k2*j2) (K9),
    x[n2*j1 + j2] = (1/n) sum_k1 Y[k1, j2] W_n1^(-k1*j1) (K10)."""
    n = n1 * n2
    t = plan.get_plan(n, 'stream', torch.complex64)[1]
    re, im = _inputs(n1, n2)
    x = torch.from_numpy((re + 1j * im).astype(np.complex64))
    z = stream.phase_a(x.reshape(1, n), t, False)
    for half in (False, True):
        s = stream_t.phase_b_t(z, t, half)
        assert torch.equal(s, stream_t.phase_b_t_plain(z, t, half))
        ref = np.fft.fft(z.numpy().astype(np.complex128), axis=0).T
        assert _rel(s.numpy(), ref[:, :stream_t.width(n2, half)]) < NUMPY_BOUND
    s = stream_t.phase_b_t(z, t, False)
    y = stream_t.inv_phase_a_t(s, t, False)
    assert torch.equal(y, stream_t.inv_phase_a_t_plain(s, t, False))
    k1, j2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    ref = np.fft.ifft(s.numpy().astype(np.complex128), axis=1) * n2 \
        * np.exp(2j * np.pi * k1 * j2 / n)
    assert _rel(y.numpy(), ref) < NUMPY_BOUND
    for real_output in (False, True):
        back = stream_t.inv_phase_b_t(y, t, real_output)
        assert torch.equal(back, stream_t.inv_phase_b_t_plain(y, t, real_output))
        ref = (np.fft.ifft(y.numpy().astype(np.complex128), axis=0) / n2).reshape(-1)
        assert _rel(back.numpy(), ref.real if real_output else ref) < NUMPY_BOUND


@pytest.mark.parametrize('n1,n2', SHAPES)
def test_unhalf_rebuilds_the_mirror_exactly(n1, n2):
    sig = np.random.default_rng(n1).standard_normal(n1 * n2)
    full = _t_of(sig, n1, n2, False)
    got = stream_t.unhalf(torch.from_numpy(full[:, :n2 // 2 + 1].copy()), n1, n2).numpy()
    assert got.shape == full.shape
    # conj and flips only: equal to the exact spectrum's own upper half to
    # float64 rounding of the forward transform
    assert _rel(got, full) < 1e-12


def test_t_layout_takes_only_the_plan_split_and_real_half():
    with pytest.raises(ValueError, match='factors'):
        stream_t.fourstep_to_t(torch.zeros(2**18), 1024, 256, False)
    with pytest.raises(ValueError, match='real'):
        stream_t.fourstep_to_t(torch.zeros(2**18, dtype=torch.complex64), 512, 512, True)
    with pytest.raises(RuntimeError, match='T layout'):
        dt.Tensor._from_t(torch.zeros((512, 512), dtype=torch.complex64), 512, 512, True)


@pytest.mark.parametrize('e', range(18, 27))
def test_k9_block_rows(e):
    """R, the rows a block of K9 in the T layout, at every single-vector
    split, against what the kernel takes (csrc/fourstep_stream_t.cu
    dsc_stream_inv_phase_a_t: R dividing n1, R*n2/16 <= 1024 threads, R
    padded rows within a block's 227 KB of shared memory)."""
    n1, n2 = stream.factors(2**e)
    r = stream_t.block_rows(n2)
    assert r >= 1 and r & (r - 1) == 0 and n1 % r == 0
    assert r * n2 // 16 <= 1024 and r * (n2 + n2 // 16) * 8 <= 227 * 1024


def test_k9_block_rows_refuses_lengths_off_the_kernel():
    with pytest.raises(ValueError, match='stream_inv_phase_a_t'):
        stream_t.block_rows(256)
