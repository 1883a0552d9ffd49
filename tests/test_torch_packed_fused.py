"""Plain versions of K1-K4 (dsc_tpu_torch/fourier/packed_fused.py) against
the JAX package's fused packed engine run in interpret mode on the CPU
(dsc_tpu/fourier/packed_fused.py), at (n1, n2) = (512, 1024), the smallest
split the engine takes (tests/test_packed_fused.py)."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu.fourier import packed_fused as jpf  # noqa: E402
from dsc_tpu_torch import interop  # noqa: E402
from dsc_tpu_torch.fourier import packed_fused as pf  # noqa: E402
from dsc_tpu_torch.fourier import plan, stream  # noqa: E402

N1, N2 = 512, 1024
N = N1 * N2
NH = N // 2


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


@pytest.fixture(scope='module')
def sig():
    return np.random.default_rng(41).standard_normal(N).astype(np.float32)


@pytest.fixture(scope='module')
def tables():
    return plan.packed_tables(N1, N2, torch.complex64, 'cpu')


@pytest.fixture(scope='module')
def jax_forward(sig):
    """The JAX engine's half-T planes (interpret mode, computed once)."""
    hr, hi = jax.jit(lambda v: jpf.rfft_half_t_packed_fused(v, N1, N2))(sig)
    return np.asarray(hr), np.asarray(hi)


@pytest.fixture(scope='module')
def jax_inverse(jax_forward):
    hr, hi = jax_forward
    y = jax.jit(lambda r, i: jpf.irfft_from_half_t_packed_fused(r, i, N1, N2))(hr, hi)
    return np.asarray(y)


@pytest.fixture(scope='module')
def port_forward(sig, tables):
    return pf.rfft_packed_plain(torch.from_numpy(sig), tables)


def _rel(got, ref):
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_forward_matches_jax_engine(port_forward, jax_forward):
    ref = interop.from_half_t(*jax_forward, N1, N2).numpy()
    assert ref.shape == (NH + 1,)
    assert _rel(port_forward.numpy(), ref) < 3e-5


def test_forward_matches_numpy(port_forward, sig):
    ref = np.fft.rfft(sig.astype(np.float64)).astype(np.complex64)
    assert _rel(port_forward.numpy(), ref) < 3e-5


def test_inverse_matches_jax_engine(port_forward, jax_inverse, jax_forward, tables):
    # the port's inverse of the JAX engine's spectrum (cross-consumption
    # through from_half_t) and of its own spectrum
    x_jax = interop.from_half_t(*jax_forward, N1, N2).torch
    got = pf.irfft_packed_plain(x_jax, tables).numpy()
    assert got.shape == jax_inverse.shape and got.dtype == jax_inverse.dtype
    assert np.abs(got - jax_inverse).max() < 2e-4
    own = pf.irfft_packed_plain(port_forward, tables).numpy()
    assert np.abs(own - jax_inverse).max() < 2e-4


def test_round_trip(port_forward, sig, tables):
    back = pf.irfft_packed_plain(port_forward, tables).numpy()
    assert back.shape == sig.shape and back.dtype == sig.dtype
    assert np.abs(back - sig).max() < 2e-4


def test_port_forward_numpy_inverse(port_forward, sig):
    back = np.fft.irfft(port_forward.numpy().astype(np.complex128))
    assert back.shape == sig.shape
    assert np.abs(back - sig).max() < 2e-4


def test_phases_compose(sig, tables, port_forward):
    """The single-phase plain versions chain into the two-phase ones and
    the CPU wrappers run exactly the plain versions."""
    x = torch.from_numpy(sig)
    at = pf.rfft_phase_a(x, tables)
    assert at.shape == (N1, N2 // 2) and at.dtype == torch.complex64
    spec = pf.rfft_phase_b(at, tables)
    assert torch.equal(spec, port_forward)
    y = pf.irfft_phase_a(spec, tables)
    assert y.shape == (N1, N2 // 2) and y.dtype == torch.complex64
    assert torch.equal(pf.irfft_phase_b(y, tables),
                       pf.irfft_packed_plain(port_forward, tables))


SPLITS = [stream.factors(2**e) for e in range(16, 28)] + [(256, 1024), (512, 256)]


@pytest.mark.parametrize('n1,n2', SPLITS)
def test_supported_matches_reference(n1, n2):
    assert pf.supported(n1, n2) == jpf.supported(n1, n2)
