"""Plain versions of K6/K7 (dsc_tpu_torch/fourier/stream.py) and K11
(fourier/reconstruct.py) against the JAX package's kernels on the same
inputs: ``fourstep_stream_p`` (dsc_tpu/fourier/pallas_stream.py) and
``reconstruct_spectrum`` (pallas_reconstruct.py), run in interpret mode on
the CPU as tests/test_pallas_fft.py runs them (the reconstruction with
CHUNK patched to 1024). The JAX results are computed once per module.

Bounds, relative to max |reference|: 3e-5 against the JAX kernels, whose
bf16x3 DFT stages are good to about 1e-5, and 1e-5 against np.fft in
float64. The reconstruction is a copy: exact."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu.fourier import pallas_reconstruct as jpr  # noqa: E402
from dsc_tpu.fourier import pallas_stream as jps  # noqa: E402
from dsc_tpu_torch.fourier import plan, reconstruct, stream  # noqa: E402

JAX_BOUND = 3e-5
NUMPY_BOUND = 1e-5

# (n1, n2, batch): the square split, odd log2 n (n1 = 2*n2), the grouped
# 256 x 256 case
SHAPES = [(512, 512, 1), (512, 256, 2), (256, 256, 6)]
# complex forward, complex inverse, real-input forward, real-output inverse
VARIANTS = ['forward', 'inverse', 'real_input', 'real_output']


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


def _inputs(n1, n2, batch):
    rng = np.random.default_rng(n1 + n2 + batch)
    re, im = (rng.standard_normal((batch, n1 * n2)).astype(np.float32) for _ in range(2))
    return re, im


def _call(variant, re, im):
    """(input of the port's fourstep_stream, inverse, real_output)."""
    if variant == 'real_input':
        return re, False, False
    z = (re + 1j * im).astype(np.complex64)
    return z, variant != 'forward', variant == 'real_output'


@pytest.fixture(scope='module')
def jax_results():
    """The JAX kernel's output for every shape and variant (interpret mode)."""
    out = {}
    for n1, n2, batch in SHAPES:
        re, im = _inputs(n1, n2, batch)

        def run(r, i, n1=n1, n2=n2):
            fwd = jps.fourstep_stream_p(r, i, n1, n2, False)
            inv = jps.fourstep_stream_p(r, i, n1, n2, True)
            rin = jps.fourstep_stream_p(r, None, n1, n2, False)
            rout, _ = jps.fourstep_stream_p(r, i, n1, n2, True, True)
            return fwd, inv, rin, rout

        fwd, inv, rin, rout = jax.jit(run)(re, im)
        for variant, (yr, yi) in zip(VARIANTS[:3], (fwd, inv, rin)):
            out[(n1, n2, batch, variant)] = np.asarray(yr) + 1j * np.asarray(yi)
        out[(n1, n2, batch, 'real_output')] = np.asarray(rout)
    # the compiles leave a large heap that the gc.collect() after every test
    # (tests/conftest.py) would otherwise rescan each time
    gc.freeze()
    yield out
    gc.unfreeze()


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('n1,n2,batch', SHAPES)
def test_fourstep_stream_matches_jax_and_numpy(n1, n2, batch, variant, jax_results):
    re, im = _inputs(n1, n2, batch)
    x, inverse, real_output = _call(variant, re, im)
    got = stream.fourstep_stream(torch.from_numpy(x), n1, n2, inverse, real_output).numpy()
    ref = jax_results[(n1, n2, batch, variant)].astype(got.dtype)
    assert got.shape == ref.shape == (batch, n1 * n2)
    assert got.dtype == (np.float32 if real_output else np.complex64)
    assert _rel(got, ref) < JAX_BOUND
    x64 = x.astype(np.complex128)
    exact = np.fft.ifft(x64, axis=-1) if inverse else np.fft.fft(x64, axis=-1)
    assert _rel(got, exact.real if real_output else exact) < NUMPY_BOUND


@pytest.mark.parametrize('inverse', [False, True])
@pytest.mark.parametrize('real', [False, True])
@pytest.mark.parametrize('n1,n2,batch', SHAPES)
def test_phase_a_z_layout(n1, n2, batch, real, inverse):
    """Z[b*n2 + j2, k1] = W_n^(s*k1*j2) * sum_j1 x[b, n2*j1 + j2] W_n1^(s*j1*k1),
    the layout contract of K6 and K7; the CPU wrappers run the plain
    versions exactly."""
    n = n1 * n2
    re, im = _inputs(n1, n2, batch)
    x = re if real else (re + 1j * im).astype(np.complex64)
    t = plan.get_plan(n, 'stream', torch.complex64)[1]
    z = stream.phase_a(torch.from_numpy(x), t, inverse)
    assert z.shape == (batch * n2, n1) and z.dtype == torch.complex64
    assert torch.equal(z, stream.phase_a_plain(torch.from_numpy(x), t, inverse))
    s = 1 if inverse else -1
    cols = np.fft.ifft(x.reshape(batch, n1, n2), axis=1) * n1 if inverse else \
        np.fft.fft(x.reshape(batch, n1, n2), axis=1)
    k1, j2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    ref = (cols * np.exp(s * 2j * np.pi * k1 * j2 / n)).transpose(0, 2, 1).reshape(-1, n1)
    assert _rel(z.numpy(), ref) < NUMPY_BOUND
    y = stream.phase_b(z, t, inverse, real_output=real)
    assert torch.equal(y, stream.phase_b_plain(z, t, inverse, real_output=real))


def test_fourstep_stream_takes_only_the_plan_split():
    with pytest.raises(ValueError, match='factors'):
        stream.fourstep_stream(torch.zeros(2**18), 1024, 256, False)


def _column_passes():
    """(L, M, batch) of every column pass the routes launch: K6 (L = n1)
    and K7 (L = n2) of each (batch, n) that ``stream.supported`` admits up
    to 2^26 values, the batched suite's among them, and, at batch 1, the
    single vector's K6 + K8 (L = n1, then n2) and K10 (L = n1)."""
    cases = set()
    for e in range(16, 27):
        n1, n2 = stream.factors(2**e)
        for batch in (1, 2, 3, 4, 5, 6, 16, 64, 256, 1000):
            if batch * 2**e <= 2**26 and stream.supported(n1, n2, np.complex64, batch):
                cases |= {(n1, n2, batch), (n2, n1, batch)}
    return sorted(cases)


def _column_cases():
    """(L, M, batch, output bytes): every pass of ``_column_passes`` with
    complex64 and float32 output, and the packed real FFT's K1 and K4
    (L = n1, M = m2 = n2/2, batch 1, complex64 output) at n = 2^20 ... 2^26
    (fourier/packed_fused.py) where no streaming pass has the same case."""
    cases = [(L, M, batch, out) for out in (8, 4) for L, M, batch in _column_passes()]
    packed = [(n1, n2 // 2, 1, 8) for n1, n2 in (stream.factors(2**e) for e in range(20, 27))]
    return cases + [case for case in packed if case not in cases]


@pytest.mark.parametrize('L,M,batch,out_bytes', _column_cases())
def test_column_schedule(L, M, batch, out_bytes):
    """The block size C of every column pass the routes launch, with
    complex64 output and (K7, K10 real output) float32, K1 and K4 among
    them, against what the kernel needs of it (csrc/stream_columns.cuh
    launch_columns: C a power of two dividing M, C*L/16 <= 1024 threads a
    block, each 16 values of a column in 64 registers at most) and what the
    timed candidates chose."""
    c = stream.block_columns(L, M, batch, out_bytes)
    assert c >= 1 and c & (c - 1) == 0 and M % c == 0
    assert c * L // 16 <= 1024
    # the exchange buffer, at most C*(L + L/16 + 16) float2 (fft_radix.cuh
    # column_stride), fits a block's 227 KB of shared memory
    assert c * (L + L // 16 + 16) * 8 <= 227 * 1024
    # the table's C, halved only as far as a grid of MIN_BLOCKS needs
    table = stream.COLUMNS[out_bytes][L]
    blocks = batch * M // c
    assert c <= table and (c == min(table, M) or batch * M // (2 * c) < stream.MIN_BLOCKS)
    assert blocks >= stream.MIN_BLOCKS or c == 1
    # column runs of a 32-byte sector or more wherever a block of at most
    # 16384 points can hold that many columns and the grid still has
    # MIN_BLOCKS blocks (not at L = 8192, nor at 4096 with float32 output)
    floor = 32 // out_bytes
    if floor * L <= 16384 and batch * M // floor >= stream.MIN_BLOCKS:
        assert c * out_bytes >= 32, c
    # more than one block in flight a SM (one's load and store under
    # another's passes): two blocks' registers, 64 a thread, fit the SM's
    # 65536 wherever the run floor leaves a block of 8192 points or fewer
    if floor * L <= 8192:
        assert 2 * 64 * (c * L // 16) <= 65536, c


def test_column_schedule_refuses_lengths_off_the_pass():
    for L, M in ((128, 512), (16384, 512), (512, 384)):
        with pytest.raises(ValueError, match='column pass'):
            stream.block_columns(L, M, 1)


def _local_passes():
    """(L, M, out_bytes, in_bytes) of every local column pass the sharded
    tier sends: K6 local (n1, n2/d), complex64 and float32 input, and K7
    local (n2, n1/d), complex64 and float32 (real) output, for each split
    of n = 2^18 ... 2^28 that ``stream.dist_supported`` admits over d = 2,
    4, 8."""
    cases = set()
    for e in range(18, 29):
        n1, n2 = stream.factors(2**e)
        for d in (2, 4, 8):
            if stream.dist_supported(n1, n2, d, np.complex64):
                cases |= {(n1, n2 // d, 8, 8), (n1, n2 // d, 8, 4), (n2, n1 // d, 8, 8),
                          (n2, n1 // d, 4, 8)}
    return sorted(cases)


@pytest.mark.parametrize('L,M,out_bytes,in_bytes', _local_passes())
def test_local_geometry(L, M, out_bytes, in_bytes):
    """The cluster column pass's geometry (csrc/cluster_columns.cuh) for
    every block the sharded tier sends: groups of W columns dividing M, runs
    of a 32-byte sector or more on the input (complex64 and K6 local's
    float32) and the output, a cluster of at most 8 CTAs (the portable
    size), P = L/Q rows a CTA in [512, 1024] (16 values a thread, at most
    1024 threads), and the CTA's shared memory, the ring's tile and the
    exchange buffer, within the 232,448 bytes a block can take (a third of
    it at W = 4, where three CTAs share an SM)."""
    geo = stream.local_geometry(L, M, out_bytes, in_bytes)
    assert M % geo.columns == 0
    assert geo.columns * in_bytes >= 32 and geo.columns * out_bytes >= 32
    assert geo.cluster in (1, 2, 4, 8) and L % geo.cluster == 0
    p = L // geo.cluster
    assert 512 <= p <= 1024 and geo.threads == p * geo.columns // 16 <= 1024
    # the tile (P x W) and the exchange (W padded columns, at least P x W)
    # and the 8-byte mbarrier
    slots = (geo.smem - 8) // 8
    assert slots >= 2 * p * geo.columns and geo.smem <= 232448
    if geo.columns == 4:
        assert 3 * geo.smem <= 232448
    assert geo == stream.local_geometry(L, M, out_bytes, in_bytes)
    # the persistent grid: as many rounds of groups as the active clusters
    # need, every cluster with the same number of groups but in the last
    groups = M // geo.columns
    for active in (1, 7, 15, 30, 66, 132, 264):
        n = stream.grid_clusters(M, geo, active)
        rounds = -(-groups // min(groups, active))
        assert 1 <= n <= min(groups, active) and -(-groups // n) == rounds


@pytest.mark.parametrize('L,M,out_bytes,in_bytes', [
    (256, 512, 8, 8), (16384, 512, 8, 8), (3072, 512, 8, 8), (4096, 128, 8, 8),
    (4096, 384, 8, 8), (4096, 512, 2, 8), (4096, 512, 8, 2)])
def test_local_geometry_refuses_shapes_off_the_pass(L, M, out_bytes, in_bytes):
    with pytest.raises(ValueError, match='cluster column pass'):
        stream.local_geometry(L, M, out_bytes, in_bytes)


@pytest.fixture(scope='module')
def spectrum():
    n = 8192
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1, n // 2 + 1))
         + 1j * rng.standard_normal((1, n // 2 + 1))).astype(np.complex64)
    x[0, n // 2] = x[0, n // 2].real  # a valid spectrum's Nyquist bin is real
    return x, n


def test_reconstruct_matches_jax_kernel_exactly(spectrum, monkeypatch):
    x, n = spectrum
    monkeypatch.setattr(jpr, 'CHUNK', 1024)
    ref = np.asarray(jax.jit(lambda v: jpr.reconstruct_spectrum(v, n))(jnp.asarray(x)))
    got = reconstruct.reconstruct_spectrum(torch.from_numpy(x), n).numpy()
    assert got.shape == ref.shape == (1, n) and got.dtype == ref.dtype
    assert np.array_equal(got, ref)


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
@pytest.mark.parametrize('batch,e', [(1, 8), (3, 12), (1, 18)])
def test_reconstruct_plain_matches_the_xla_path(batch, e, dtype):
    """Off the kernel's shapes the JAX package reconstructs in XLA; the
    port's plain version is the same copy."""
    n = 2**e
    rng = np.random.default_rng(e)
    x = (rng.standard_normal((batch, n // 2 + 1))
         + 1j * rng.standard_normal((batch, n // 2 + 1))).astype(dtype)
    ref = np.concatenate([x, np.conj(x[:, 1:n // 2][:, ::-1])], axis=1)
    got = reconstruct.reconstruct_spectrum(torch.from_numpy(x), n).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.array_equal(got, ref)


@pytest.mark.parametrize('batch,e,dtype,takes', [
    (1, 18, torch.complex64, True), (1, 26, torch.complex64, True),
    (1, 17, torch.complex64, False),   # one chunk
    (2, 18, torch.complex64, False),   # a batch
    (1, 18, torch.complex128, False),  # the TPU kernel raises on float64
])
def test_reconstruct_kernel_shapes(batch, e, dtype, takes):
    """K11 takes what the TPU kernel takes (pallas_reconstruct.py:205)."""
    n = 2**e
    x = torch.empty((batch, n // 2 + 1), dtype=dtype)
    assert reconstruct.kernel_takes(x, n) == takes
    nh = n // 2
    ref = not (nh % jpr.CHUNK or nh // jpr.CHUNK < 2 or (nh // jpr.CHUNK) % 2 or batch != 1)
    assert takes == (ref and dtype == torch.complex64)
