"""Plain versions of K1-K4 (dsc_tpu_torch/fourier/packed_fused.py) against
the JAX package's fused packed engine run in interpret mode on the CPU
(dsc_tpu/fourier/packed_fused.py), at (n1, n2) = (512, 1024), the smallest
split the engine takes (tests/test_packed_fused.py)."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

import dsc_tpu  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu.fourier import packed_fused as jpf  # noqa: E402
from dsc_tpu_torch import interop  # noqa: E402
from dsc_tpu_torch.fourier import packed_fused as pf  # noqa: E402
from dsc_tpu_torch.dtype import Dtype  # noqa: E402
from dsc_tpu_torch.fourier import config, plan, stream  # noqa: E402

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


def _wild_spectrum(nh, seed):
    """A standard normal complex64 spectrum: X[0] and X[nh] are not real."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(nh + 1) + 1j * rng.standard_normal(nh + 1)).astype(np.complex64)


def test_inverse_reads_real_parts_of_dc_and_nyquist(tables):
    """K3's plain version takes only the real parts of X[0] and X[nh], as
    np.fft.irfft does: a non-Hermitian spectrum at (512, 1024)."""
    x = _wild_spectrum(NH, 7)
    got = pf.irfft_packed_plain(torch.from_numpy(x), tables).numpy()
    ref = np.fft.irfft(x.astype(np.complex128))
    assert got.shape == ref.shape == (N,)
    assert _rel(got.astype(np.float64), ref) < 1e-4


def test_public_irfft_of_a_non_hermitian_spectrum():
    """The same at n = 2^20 through the public API of both packages: the
    port's 'packed' route against np.fft.irfft and dsc_tpu.irfft."""
    n = 2**20
    assert config.irfft_route(Dtype.C32, 1, n) == 'packed'
    x = _wild_spectrum(n // 2, 8)
    got = dt.irfft(dt.from_numpy(x)).numpy()
    ref = np.fft.irfft(x.astype(np.complex128))
    jax_ref = dsc_tpu.irfft(dsc_tpu.from_numpy(x)).numpy()
    assert got.shape == ref.shape == jax_ref.shape == (n,)
    assert _rel(got.astype(np.float64), ref) < 1e-4
    assert _rel(got, jax_ref) < 1e-4


def _packed_splits():
    """(n1, m2) of every packed route, n = 2^20 ... 2^26."""
    return [(n1, n2 // 2) for n1, n2 in (stream.factors(2**e) for e in range(20, 27))]


@pytest.mark.parametrize('n1,m2', _packed_splits())
def test_block_pairs(n1, m2):
    """P, the row pairs a block of K2, at every split of the packed route,
    against what the kernel needs of it (csrc/packed_rfft.cu
    dsc_rfft_phase_b: 2P*m2/16 <= 1024 threads, 2P padded rows within a
    block's 227 KB of shared memory, 2P dividing n1), the 32-byte runs of
    its stores wherever 1024 threads allow them, and a grid of at least
    128 blocks (132 SMs); the row-to-block map (slot_row, duplicate_slot)
    covers each row once."""
    p = pf.block_pairs(m2)
    assert p >= 1 and p & (p - 1) == 0 and n1 % (2 * p) == 0
    assert 2 * p * m2 // 16 <= 1024
    assert 2 * p * (m2 + m2 // 16 + (1 if p >= 16 else 16 // p)) * 8 <= 227 * 1024
    if m2 <= 2048:
        assert p * 8 >= 32
    npairs = n1 // (2 * p)
    assert npairs + 1 >= 128
    k = (np.arange(npairs)[:, None] * p + 1 + np.arange(p)[None, :]).ravel()
    mirrors = n1 - k
    rows = np.concatenate([[0], k, mirrors[2 * mirrors != n1]])
    np.testing.assert_array_equal(np.sort(rows), np.arange(n1))


def test_block_pairs_refuses_lengths_off_the_kernel():
    with pytest.raises(ValueError, match='rfft_phase_b'):
        pf.block_pairs(8192)
