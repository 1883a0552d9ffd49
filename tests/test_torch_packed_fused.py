"""Plain versions of K1-K4 (dsc_tpu_torch/fourier/packed_fused.py) against
the JAX package's fused packed engine run in interpret mode on the CPU
(dsc_tpu/fourier/packed_fused.py), at (n1, n2) = (512, 1024), the smallest
split the engine takes (tests/test_packed_fused.py)."""

import functools
import gc

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


@pytest.mark.parametrize('n1,m2', _packed_splits())
def test_inv_block_pairs(n1, m2):
    """P, the row pairs a block of K3, at every split of the packed route,
    against what the kernel needs of it (csrc/packed_rfft.cu
    dsc_irfft_phase_a: 2P*m2/16 <= 1024 threads, 2P padded rows within a
    block's 227 KB of shared memory, 2P dividing n1) and one of the
    candidates chip_smoke.py --profile times (2-16)."""
    p = pf.block_pairs(m2, inverse=True)
    assert p in (2, 4, 8, 16) and n1 % (2 * p) == 0
    assert 2 * p * m2 // 16 <= 1024
    assert 2 * p * (m2 + m2 // 16 + (1 if p >= 16 else 16 // p)) * 8 <= 227 * 1024


def test_inv_block_pairs_refuses_lengths_off_the_kernel():
    with pytest.raises(ValueError, match='irfft_phase_a'):
        pf.block_pairs(256, inverse=True)


# ---------------------------------------------------------------------------
# K1's pad fold and the column pass of K1 and K4 (csrc/stream_columns.cuh)
# at n = 2^20, the smallest split of the packed route
# ---------------------------------------------------------------------------

N20 = 2**20
SPLIT20 = (1024, 1024)
# a single sample, an odd count (one half pair), an even count, no padding
LENGTHS = [1, 2**19 + 1, 3 * 2**17, N20]


@pytest.fixture(scope='module')
def tables20():
    return plan.packed_tables(*SPLIT20, torch.complex64, 'cpu')


@pytest.fixture(scope='module')
def long_sig():
    return np.random.default_rng(43).standard_normal(N20).astype(np.float32)


@pytest.mark.parametrize('length', LENGTHS)
def test_phase_a_plain_reads_an_unpadded_signal(length, long_sig, tables20):
    """K1's plain version on the first ``length`` samples equals it on
    those samples zero-padded to n, exactly; the CPU wrapper runs it."""
    x = torch.from_numpy(long_sig[:length])
    got = pf.rfft_phase_a_plain(x, tables20)
    ref = pf.rfft_phase_a_plain(torch.nn.functional.pad(x, (0, N20 - length)), tables20)
    assert got.shape == (1024, 512) and got.dtype == torch.complex64
    assert torch.equal(got, ref)
    assert torch.equal(pf.rfft_phase_a(x, tables20), got)


def test_phase_a_refuses_signals_off_the_split(tables20):
    for x in (torch.zeros(0), torch.zeros(N20 + 1), torch.zeros(2, 8)):
        with pytest.raises(RuntimeError, match='rfft_phase_a'):
            pf.rfft_phase_a(x, tables20)


@pytest.fixture(scope='module')
def jax_unpadded(long_sig):
    """dsc_tpu.rfft(x, n=2^20) of the odd and even unpadded lengths, and
    dsc_tpu.models.fft_convolve of 2^19 samples with 255 taps."""
    import dsc_tpu.models  # noqa: F401
    out = {length: dsc_tpu.rfft(dsc_tpu.from_numpy(long_sig[:length]), n=N20).numpy()
           for length in LENGTHS[1:3]}
    taps = np.blackman(255).astype(np.float32)
    out['conv'] = dsc_tpu.models.fft_convolve(dsc_tpu.from_numpy(long_sig[:2**19]),
                                              dsc_tpu.from_numpy(taps)).numpy()
    gc.freeze()
    yield out
    gc.unfreeze()


@pytest.mark.parametrize('length', LENGTHS[1:3])
def test_public_rfft_of_an_unpadded_signal(length, long_sig, jax_unpadded, monkeypatch):
    """dt.rfft(x, n=2^20) of an odd and an even number of samples takes the
    packed route with the unpadded signal, against np.fft.rfft in float64
    and dsc_tpu.rfft."""
    assert config.rfft_route(Dtype.F32, 1, N20) == 'packed'
    seen = []
    k1 = pf.rfft_phase_a
    monkeypatch.setattr(pf, 'rfft_phase_a', lambda x, t: seen.append(x.numel()) or k1(x, t))
    got = dt.rfft(dt.from_numpy(long_sig[:length]), n=N20).numpy()
    assert seen == [length]
    ref = np.fft.rfft(long_sig[:length].astype(np.float64), N20)
    assert got.shape == ref.shape == (N20 // 2 + 1,) and got.dtype == np.complex64
    assert _rel(got.astype(np.complex128), ref) < 1e-4
    assert _rel(got, jax_unpadded[length]) < 1e-5


def test_fft_convolve_on_the_packed_route(long_sig, jax_unpadded, monkeypatch):
    """models.fft_convolve of 2^19 samples with 255 taps (n = 2^20, the
    packed route: K1 reads both operands unpadded) against
    dsc_tpu.models.fft_convolve and np.convolve."""
    sig, taps = long_sig[:2**19], np.blackman(255).astype(np.float32)
    seen = []
    k1 = pf.rfft_phase_a
    monkeypatch.setattr(pf, 'rfft_phase_a', lambda x, t: seen.append(x.numel()) or k1(x, t))
    got = dt.models.fft_convolve(dt.from_numpy(sig), dt.from_numpy(taps)).numpy()
    assert seen == [2**19, 255]
    ref = np.convolve(sig.astype(np.float64), taps.astype(np.float64))
    assert got.shape == ref.shape == jax_unpadded['conv'].shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    assert _rel(got, jax_unpadded['conv']) < 1e-5


def emulate_column_pass(src, n1, m2, C, inverse, valid=None, tw=None, scale=1.0):
    """stream_column_kernel (csrc/stream_columns.cuh) at batch 1 over every
    block of C columns of an (L, M) = (n1, m2) matrix, thread by thread:
    block b owns columns m0 = b*C ... m0 + C - 1; thread i of a block takes
    column c = i mod C and index t = i div C of its column (T = L/16
    threads a column), and register u holds value t + u*T of its column,
    on load and, after the passes, of the column's transform. The passes
    are np.fft here. K1 (``valid``): complex value j is pair j of the
    signal ``src`` below its ``valid >> 1`` complete pairs, the odd last
    float (or zero) at j = valid >> 1 and zero past it, loaded as the kernel
    does (a clamped load of pair 0 and a select); it stores value k1 of
    column m times W_nh^(k1*m) (``tw``: the Factored table) back in place.
    K4: the inverse pass over the complex ``src``, stored in place times
    ``scale``. Returns the output and how often each place was written."""
    L, M = n1, m2
    T, log2c = L // 16, C.bit_length() - 1
    i = np.arange(C * T)
    c, t = i & (C - 1), i >> log2c
    u = np.arange(16)
    m0 = np.arange(M // C)[:, None, None] * C
    col = m0 + c[None, :, None]                              # (block, thread, 1)
    k = t[None, :, None] + u[None, None, :] * T              # (1, thread, register)
    idx = k * M + col                                        # the column's value k
    if valid is None:
        v = src.reshape(-1)[idx]
    else:
        pairs = valid >> 1
        odd_last = src[valid - 1] if valid & 1 else 0.0
        safe = np.where(idx < pairs, idx, 0)
        q = src[2 * safe] + 1j * src[2 * safe + 1] if pairs > 0 else np.zeros(idx.shape)
        v = np.where(idx < pairs, q, np.where(idx == pairs, odd_last, 0)).astype(complex)
    cols = np.empty((M // C, C, L), complex)
    blk = np.arange(M // C)[:, None, None]
    cols[blk, c[None, :, None], k] = v
    y = np.fft.ifft(cols, axis=2) * L if inverse else np.fft.fft(cols, axis=2)
    v = y[blk, c[None, :, None], k] * scale
    if tw is not None:
        e = k * col
        v = v * tw.hi.numpy()[e >> tw.bits] * tw.lo.numpy()[e & ((1 << tw.bits) - 1)]
    out = np.zeros(L * M, complex)
    written = np.zeros(L * M, int)
    out[idx.ravel()] = v.ravel()
    np.add.at(written, idx.ravel(), 1)
    return out.reshape(L, M), written


def _column_cases():
    """(n1, m2, C) at the 2^20 and 2^21 splits, every C the launcher
    accepts (C <= m2, C*n1/16 <= 1024 threads)."""
    return [(n1, 512, c) for n1 in (1024, 2048) for c in (1, 2, 4, 8, 16)
            if c * n1 // 16 <= 1024]


@functools.lru_cache(maxsize=None)
def _column_refs(n1, m2):
    """K1's plain version on the full and the odd-length signal, and K4's
    on a seeded Y, at the split (n1, m2)."""
    t = plan.packed_tables(n1, 2 * m2, torch.complex64, 'cpu')
    rng = np.random.default_rng(n1)
    x = rng.standard_normal(2 * n1 * m2).astype(np.float32)
    y = (rng.standard_normal((n1, m2)) + 1j * rng.standard_normal((n1, m2))).astype(np.complex64)
    valid = {'K1': 2 * n1 * m2, 'K1_odd': n1 * m2 + 1, 'K1_one': 1}
    refs = {k: pf.rfft_phase_a_plain(torch.from_numpy(x[:v]), t).numpy()
            for k, v in valid.items()}
    refs['K4'] = pf.irfft_phase_b_plain(torch.from_numpy(y), t).numpy()
    return t, x, y, valid, refs


@pytest.mark.parametrize('kernel', ['K1', 'K1_odd', 'K1_one', 'K4'])
@pytest.mark.parametrize('n1,m2,C', _column_cases())
def test_column_pass_index_maps(n1, m2, C, kernel):
    """K1 and K4's loads (the zeros past an odd ``valid`` and past a single
    sample, which leaves no complete pair, among them), the twiddle exponent
    k1*(m0 + c), the in-place store (each place once) and the 1/nh scale,
    emulated for every C the launcher takes, against the plain versions."""
    t, x, y, valid, refs = _column_refs(n1, m2)
    nh = n1 * m2
    if kernel == 'K4':
        got, written = emulate_column_pass(y.astype(complex), n1, m2, C, True, scale=1.0 / nh)
        got = np.stack([got.real, got.imag], axis=-1).reshape(-1)
    else:
        got, written = emulate_column_pass(x.astype(np.float64), n1, m2, C, False,
                                           valid[kernel], t.twiddle)
    assert (written == 1).all()
    ref = refs[kernel]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
