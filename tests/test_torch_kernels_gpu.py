"""Each CUDA kernel of dsc_tpu_torch against its plain PyTorch version on the
card (marker ``gpu``; skipped without a CUDA device). Run on a GPU machine
with ``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``
(``--noconftest``: the shared conftest imports the JAX package); the
kernels build with nvcc at first use."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch.fourier import base_fft, plan, reconstruct, stream, stream_t  # noqa: E402
from dsc_tpu_torch.fourier import packed_fused as pf  # noqa: E402
from dsc_tpu_torch.kernels import build  # noqa: E402
from dsc_tpu_torch.ops import stream_map as sm  # noqa: E402

pytestmark = pytest.mark.gpu

REL = 3e-5  # kernel vs plain version, relative to max |plain|
T_REL = 1e-6  # K8, K9, K10 vs plain: float32 FFTs of one length, the same tables and
# twiddle formula, K9's store twiddles within ~4e-7 of the plain version's


@pytest.fixture(scope='module', autouse=True)
def cuda_ctx():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dt.init(2**34, device='cuda')
    yield
    dt.shutdown()


def _rel(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    return float((got - ref).abs().max() / ref.abs().max())


def _cnormal(shape, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(z.astype(np.complex64)).cuda()


@pytest.mark.parametrize('batch', [1, 3, 130])
@pytest.mark.parametrize('n', [256, 512, 1024, 2048, 4096])
def test_base_fft_kernel(n, batch):
    x = _cnormal((batch, n), n + batch)
    w = plan.get_plan(n, 'complex', torch.complex64)[1]
    before = build.launches['base_fft']
    got = base_fft.fft_base(x, w)
    assert build.launches['base_fft'] == before + 1
    assert _rel(got, base_fft.fft_base_plain(x, w)) < REL


@pytest.mark.parametrize('points', [4096, 8192, 16384])
@pytest.mark.parametrize('n', [256, 512, 1024, 2048, 4096])
def test_base_fft_kernel_block_sizes(n, points):
    """K12 with each block size that chip_smoke.py --profile times, on a
    batch that leaves a ragged last block."""
    rows = points // n
    x = _cnormal((3 * rows + 1, n), n + points)
    w = plan.get_plan(n, 'complex', torch.complex64)[1]
    assert _rel(base_fft._launch(x, w, rows), base_fft.fft_base_plain(x, w)) < REL


def test_base_fft_kernel_fft2_axis():
    """K12 at fft2 (256, 2^16)'s axis-0 shape, 65536 rows of 256."""
    x = _cnormal((65536, 256), 256)
    w = plan.get_plan(256, 'complex', torch.complex64)[1]
    assert _rel(base_fft.fft_base(x, w), base_fft.fft_base_plain(x, w)) < REL


# K12r's launch shapes (batch, nh): OverlapSave at fft_n = 8192 (521 and 1048
# rows of nh = 4096), the STFT of 4 x 2^18, 1 x 2^20 and 16 x 2^18 (512 x
# 4084, 4093, 16336), welch 1 x 2^22 and 16 x 2^18, ShortTimeFFT of 2^20 and
# the scipy-style stft of 2^20 (512 x 8191, 8176, 4099, 2049), and the
# spectrogram benchmark cell's 54,912 frames
RFFT_SHAPES = [(521, 4096), (1048, 4096), (4084, 512), (4093, 512), (16336, 512), (8191, 512),
               (8176, 512), (4099, 512), (2049, 512), (54912, 512)]


def _real_rows(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()


@pytest.mark.parametrize('batch,nh', RFFT_SHAPES + [(1, 256), (3, 1024), (130, 2048)])
def test_base_rfft_kernel(batch, nh):
    """K12r against its plain version and np.fft.rfft in float64: one launch
    of K12r and none of K12."""
    x = _real_rows((batch, 2 * nh), batch + nh)
    w, wu = plan.get_plan(2 * nh, 'real', torch.complex64)[1]
    before = dict(build.launches)
    got = base_fft.rfft_base(x, w, wu)
    assert build.launches['base_rfft'] == before['base_rfft'] + 1
    assert build.launches['base_fft'] == before['base_fft']
    assert got.shape == (batch, nh + 1) and got.dtype == torch.complex64
    assert _rel(got, base_fft.rfft_base_plain(x, w, wu)) < REL
    ref = np.fft.rfft(x.cpu().numpy().astype(np.float64), axis=-1)
    assert np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize('points', [4096, 8192, 16384])
@pytest.mark.parametrize('nh', [256, 512, 1024, 2048, 4096])
def test_base_rfft_kernel_block_sizes(nh, points):
    """K12r with each block size of chip_smoke.py --rfft, on a batch that
    leaves a ragged last block."""
    rows = points // nh
    x = _real_rows((3 * rows + 1, 2 * nh), nh + points)
    w, wu = plan.get_plan(2 * nh, 'real', torch.complex64)[1]
    assert _rel(base_fft._launch_rfft(x, w, wu, rows), base_fft.rfft_base_plain(x, w, wu)) < REL


def test_base_rfft_empty_batch_and_misaligned_rows():
    w, wu = plan.get_plan(1024, 'real', torch.complex64)[1]
    before = build.launches['base_rfft']
    got = base_fft.rfft_base(torch.empty((0, 1024), device='cuda'), w, wu)
    assert got.shape == (0, 513) and got.is_cuda
    assert build.launches['base_rfft'] == before
    x = torch.empty(2 * 1024 + 1, device='cuda')[1:].view(2, 1024)  # 4 bytes off
    with pytest.raises(RuntimeError, match='8-byte aligned'):
        base_fft.rfft_base(x, w, wu)


# K12s against its plain version (the STFT's plain passes around K12r): the
# same float32 products, row pass and untangle, so the spectrum and power
# differ only where the compiler orders the row pass's sums differently
STFT_REL = 3e-7
STFT_LOG_ABS = 1e-5


def _stft_launch(x, start, n_frames, hop, frame, mode):
    """K12s and its plain version on the signal rows ``x`` with a periodic
    Hann window of ``frame``; one launch of K12s and none of K12r."""
    fft_n = plan.next_pow2(frame)
    w, wu = plan.get_plan(fft_n, 'real', torch.complex64)[1]
    window = torch.hann_window(frame, device='cuda')
    before = dict(build.launches)
    got = base_fft.stft_base(x, start, n_frames, hop, window, w, wu, mode, 1e-10)
    assert build.launches['base_stft'] == before['base_stft'] + 1
    assert build.launches['base_rfft'] == before['base_rfft']
    want = base_fft.stft_base_plain(x, start, n_frames, hop, window, w, wu, mode, 1e-10)
    assert got.shape == (x.shape[0] * n_frames, fft_n // 2 + 1)
    assert got.dtype == want.dtype
    return got, want


def _held(got, want, mode):
    if mode == 'log':  # the log of a bin near zero power: absolute error
        assert float((got - want).abs().max()) < STFT_LOG_ABS
    else:
        assert _rel(got, want) < STFT_REL


@pytest.mark.parametrize('mode', ['complex', 'power', 'log'])
@pytest.mark.parametrize('cell', ['spectrogram', 'griffinlim'])
def test_base_stft_kernel_cells(cell, mode):
    """K12s at the benchmark cells' launches: 64 clips of 220,500 samples,
    54,912 frames of 1024 every 256; Griffin-Lim's 55,168 frames of the
    inverse's output cropped by a view, from sample -512."""
    wide = _real_rows((64, 221440), 29)
    if cell == 'spectrogram':
        x, start, n_frames = wide[:, :220500].contiguous(), 0, 858
    else:
        x, start, n_frames = wide[:, 512:512 + 220500], -512, 862
    _held(*_stft_launch(x, start, n_frames, 256, 1024, mode), mode)


@pytest.mark.parametrize('mode', ['complex', 'power', 'log'])
@pytest.mark.parametrize('frame', [512, 1000, 1024, 2048, 4096, 8192])
def test_base_stft_kernel_sizes(frame, mode):
    """K12s at every K12 half size, frames a quarter apart from sample
    -frame/2 of 3 rows, a ragged last block; 1000 points padded to 1024."""
    hop = frame // 4
    x = _real_rows((3, 8 * frame + 6), frame)
    n_frames = 1 + (8 * frame + 6) // hop
    _held(*_stft_launch(x, -(frame // 2), n_frames, hop, frame, mode), mode)


@pytest.mark.parametrize('mode', ['complex', 'log'])
def test_base_stft_kernel_odd_geometry(mode):
    """The scalar path: an odd start, hop, row stride and valid length on a
    view 4 bytes off, frames past the row's end, a ragged last block."""
    wide = _real_rows((3 * 5011 + 1,), 31)
    x = wide[1:].view(3, 5011)[:, :4999]
    _held(*_stft_launch(x, -3, 41, 125, 1000, mode), mode)


def test_base_stft_empty_batch_launches_nothing():
    w, wu = plan.get_plan(1024, 'real', torch.complex64)[1]
    window = torch.hann_window(1024, device='cuda')
    before = build.launches['base_stft']
    for x, n_frames in ((torch.empty((0, 4096), device='cuda'), 13),
                        (torch.empty((2, 4096), device='cuda'), 0)):
        got = base_fft.stft_base(x, 0, n_frames, 256, window, w, wu, 'log', 1e-10)
        assert got.shape == (0, 513) and got.is_cuda and got.dtype == torch.float32
    assert build.launches['base_stft'] == before


# K12ir's launch shapes (batch, nh): the griffinlim cell's 55,168 frames,
# OverlapSave at fft_n = 8192 (521 and 1048 rows of nh = 4096), the ISTFT of
# 4 x 2^18 (512 x 4084), istft of the scipy-style stft of 2^20 (512 x 2049)
# and the n = 4096 irfft of one row
IRFFT_SHAPES = [(55168, 512), (521, 4096), (1048, 4096), (4084, 512), (2049, 512), (1, 2048)]


def _half_spectra(batch, nh, seed):
    """The rfft spectra (batch, nh + 1) of float32 rows, in float64 and in
    complex64 on the card."""
    rng = np.random.default_rng(seed)
    spec = np.fft.rfft(rng.standard_normal((batch, 2 * nh)).astype(np.float32), axis=-1)
    return spec, torch.from_numpy(spec.astype(np.complex64)).cuda()


@pytest.mark.parametrize('batch,nh', IRFFT_SHAPES + [(3, 256), (130, 1024), (7, 4096)])
def test_base_irfft_kernel(batch, nh):
    """K12ir against its plain version and np.fft.irfft in float64: one
    launch of K12ir and none of K12."""
    spec, x = _half_spectra(batch, nh, batch + nh)
    w, wu = plan.get_plan(2 * nh, 'real', torch.complex64)[1]
    before = dict(build.launches)
    got = base_fft.irfft_base(x, w, wu)
    assert build.launches['base_irfft'] == before['base_irfft'] + 1
    assert build.launches['base_fft'] == before['base_fft']
    assert got.shape == (batch, 2 * nh) and got.dtype == torch.float32
    assert _rel(got, base_fft.irfft_base_plain(x, w, wu)) < REL
    ref = np.fft.irfft(x.cpu().numpy().astype(np.complex128), 2 * nh, axis=-1)
    assert np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize('points', [4096, 8192, 16384])
@pytest.mark.parametrize('nh', [256, 512, 1024, 2048, 4096])
def test_base_irfft_kernel_block_sizes(nh, points):
    """K12ir with each block size K12 takes, on a batch that leaves a ragged
    last block, on half spectra whose X[0] and X[nh] are not real."""
    rows = points // nh
    x = _cnormal((3 * rows + 1, nh + 1), nh + points + 1)
    w, wu = plan.get_plan(2 * nh, 'real', torch.complex64)[1]
    assert _rel(base_fft._launch_irfft(x, w, wu, rows), base_fft.irfft_base_plain(x, w, wu)) < REL


def test_base_irfft_views_and_empty_batch():
    """A strided view, a lazily conjugated tensor and rows 8 bytes off a
    16-byte boundary give what the same values in a fresh contiguous tensor
    give; an empty batch launches nothing."""
    w, wu = plan.get_plan(1024, 'real', torch.complex64)[1]
    x = _cnormal((64, 513), 5)
    want = base_fft.irfft_base(x, w, wu)
    wide = torch.zeros((64, 600), dtype=torch.complex64, device='cuda')
    wide[:, :513] = x
    assert torch.equal(base_fft.irfft_base(wide[:, :513], w, wu), want)
    lazy = x.conj_physical().conj()
    assert lazy.is_conj()
    assert torch.equal(base_fft.irfft_base(lazy, w, wu), want)
    off = torch.empty(64 * 513 + 1, dtype=torch.complex64, device='cuda')[1:].view(64, 513)
    off.copy_(x)
    assert off.data_ptr() % 16 == 8
    assert torch.equal(base_fft.irfft_base(off, w, wu), want)
    before = build.launches['base_irfft']
    got = base_fft.irfft_base(torch.empty((0, 513), dtype=torch.complex64, device='cuda'), w, wu)
    assert got.shape == (0, 1024) and got.is_cuda
    assert build.launches['base_irfft'] == before


@pytest.mark.parametrize('n,kernels', [(1024, {'base_irfft': 1}), (8192, {'base_irfft': 1}),
                                       (256, {}), (16384, {})])
def test_public_irfft_rows_ride_k12ir(n, kernels):
    """The public irfft over rows: 512..8192 points take K12ir alone; 256
    points keep Stockham and the plain entangle, and so do 16384; each
    within 1e-5 of np.fft in float64."""
    spec, x = _half_spectra(6, n // 2, n)
    build.reset_launches()
    got = dt.irfft(dt.Tensor(x))  # n/2 + 1 bins: n points
    torch.cuda.synchronize()
    assert {k: c for k, c in build.launches.items() if c} == kernels
    ref = np.fft.irfft(x.cpu().numpy().astype(np.complex128), n, axis=-1)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize('shape,kernels', [((64, 1024), {'base_rfft': 1}),
                                           ((3, 8192), {'base_rfft': 1}),
                                           ((5, 256), {}),
                                           ((4, 16384), {})])
def test_public_rfft_rows_ride_k12r(shape, kernels):
    """The public rfft over rows: 512..8192 points take K12r alone; 256
    points keep Stockham and the plain untangle, and so do 16384, whose
    half-size four-step splits into 128 x 64 Stockham base cases; each
    within 1e-5 of np.fft in float64."""
    x = np.random.default_rng(shape[-1]).standard_normal(shape).astype(np.float32)
    build.reset_launches()
    got = dt.rfft(dt.from_numpy(x))
    torch.cuda.synchronize()
    assert {k: c for k, c in build.launches.items() if c} == kernels
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-5


def test_stft_spans_on_the_card():
    """On the card the STFT's span tree is api/stft over wrapper/base_stft:
    one K12s launch, no plain pass."""
    from dsc_tpu_torch import tracing

    stft = dt.models.STFT(frame=1024, hop=256, window='hann', mode='log')
    x = dt.from_numpy(np.random.default_rng(4).standard_normal((2, 8192)).astype(np.float32))
    stft(x)  # its plan built and the kernels loaded
    tracing.clear_traces()
    tracing.set_recording(True)
    try:
        stft(x)
    finally:
        tracing.set_recording(False)
    tree, depth = [], 0
    for e in tracing._events:
        if e['ph'] == 'B':
            tree.append((tracing.layer_of(e['cat']), e['name'], depth))
            depth += 1
        elif e['ph'] == 'E':
            depth -= 1
    tracing.clear_traces()
    assert tree == [('api', 'stft', 0), ('wrapper', 'base_stft', 1)]


def test_base_fft_empty_batch_launches_nothing():
    w = plan.get_plan(512, 'complex', torch.complex64)[1]
    before = build.launches['base_fft']
    empty = torch.empty((0, 512), dtype=torch.complex64, device='cuda')
    got = base_fft.fft_base(empty, w)
    assert got.shape == (0, 512) and got.is_cuda
    assert build.launches['base_fft'] == before


@pytest.mark.parametrize('e', range(20, 27))
def test_packed_kernels_phase_by_phase(e):
    n = 2**e
    t = plan.get_plan(n, 'packed', torch.complex64)[1]
    sig = np.random.default_rng(e).standard_normal(n).astype(np.float32)
    x = torch.from_numpy(sig).cuda()
    at = pf.rfft_phase_a(x, t)
    assert _rel(at, pf.rfft_phase_a_plain(x, t)) < REL
    spec = pf.rfft_phase_b(at, t)
    assert _rel(spec, pf.rfft_phase_b_plain(at, t)) < REL
    y = pf.irfft_phase_a(spec, t)
    assert _rel(y, pf.irfft_phase_a_plain(spec, t)) < REL
    back = pf.irfft_phase_b(y, t)
    assert _rel(back, pf.irfft_phase_b_plain(y, t)) < REL
    assert float((back - x).abs().max()) < 2e-4


def _launchable_columns(n1, m2):
    """Every C the column pass's launcher takes for K1 and K4 at (n1, m2):
    a power of two, C <= m2, C*n1/16 <= 1024 threads."""
    return [c for c in (1, 2, 4, 8, 16) if c <= m2 and c * n1 // 16 <= 1024]


@pytest.mark.parametrize('e', range(20, 27))
def test_packed_column_pass_block_sizes(e):
    """K1 and K4 with every C the launcher takes, the C of
    stream.block_columns among them, against their plain versions; each
    grid of m2/C blocks leaves a ragged last wave on 132 SMs. A C off the
    launcher (not a power of two, or over 1024 threads) is refused."""
    n = 2**e
    t = plan.get_plan(n, 'packed', torch.complex64)[1]
    n1, n2 = stream.factors(n)
    m2 = n2 // 2
    x = torch.from_numpy(np.random.default_rng(e).standard_normal(n).astype(np.float32)).cuda()
    y = _cnormal((n1, m2), e)
    ref_a, ref_b = pf.rfft_phase_a_plain(x, t), pf.irfft_phase_b_plain(y, t)
    cols = _launchable_columns(n1, m2)
    assert stream.block_columns(n1, m2, 1, 8) in cols
    for c in cols:
        assert _rel(pf._launch_phase_a(x, t, c), ref_a) < REL, c
        assert _rel(pf._launch_inv_phase_b(y, t, c), ref_b) < REL, c
    for c in (3, 2 * cols[-1]):
        with pytest.raises(RuntimeError, match='dsc_rfft_phase_a'):
            pf._launch_phase_a(x, t, c)
        with pytest.raises(RuntimeError, match='dsc_irfft_phase_b'):
            pf._launch_inv_phase_b(y, t, c)
    del x, y, ref_a, ref_b
    plan.clear_plans()


@pytest.mark.parametrize('e', [21, 24])
def test_rfft_phase_a_unpadded_signal(e):
    """K1 on signals shorter than n (one sample, the filterFFT's taps and
    signals, odd counts with one half pair) against its plain version on
    the zero-padded signal, and on sliced views 4 and 8 bytes past an
    aligned start, which the wrapper copies to aligned memory."""
    n = 2**e
    t = plan.get_plan(n, 'packed', torch.complex64)[1]
    big = torch.from_numpy(np.random.default_rng(e).standard_normal(n + 2)
                           .astype(np.float32)).cuda()
    for length in (1, 255, 4097, n // 2 - 3, n // 2, n // 2 + 1, n - 1, n):
        x = big[:length]
        ref = pf.rfft_phase_a_plain(torch.nn.functional.pad(x, (0, n - length)), t)
        before = build.launches['rfft_phase_a']
        assert _rel(pf.rfft_phase_a(x, t), ref) < REL, length
        assert build.launches['rfft_phase_a'] == before + 1
    for offset in (1, 2):
        x = big[offset:offset + n // 2 + 1]
        assert x.data_ptr() % 16
        ref = pf.rfft_phase_a_plain(torch.nn.functional.pad(x, (0, n - x.numel())), t)
        assert _rel(pf.rfft_phase_a(x, t), ref) < REL, offset


def test_filter_fft_2_24_against_float64():
    """The filterFFT at n = 2^24 (2^23 samples, 4097 taps) through the
    public API: K1 reads both operands unpadded; against a float64 FFT
    convolution."""
    n = 2**24
    rng = np.random.default_rng(24)
    sig = rng.standard_normal(n // 2).astype(np.float32)
    taps = np.blackman(4097).astype(np.float32)
    build.reset_launches()
    spec = dt.rfft(dt.from_numpy(sig), n=n) * dt.rfft(dt.from_numpy(taps), n=n)
    got = dt.irfft(spec)[: n // 2 + 4096].numpy()
    torch.cuda.synchronize()
    assert {k: build.launches[k] for k in ('rfft_phase_a', 'rfft_phase_b', 'irfft_phase_a',
                                           'irfft_phase_b')} == {
        'rfft_phase_a': 2, 'rfft_phase_b': 2, 'irfft_phase_a': 1, 'irfft_phase_b': 1}
    spec64 = np.fft.rfft(sig.astype(np.float64), n) * np.fft.rfft(taps.astype(np.float64), n)
    ref = np.fft.irfft(spec64, n)[: n // 2 + 4096]
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize('e', range(20, 27))
def test_rfft_phase_b_block_shapes(e):
    """K2 with every number of row pairs a block that 1024 threads allow,
    against its plain version."""
    n = 2**e
    t = plan.get_plan(n, 'packed', torch.complex64)[1]
    n1, n2 = stream.factors(n)
    m2 = n2 // 2
    at = _cnormal((n1, m2), e)
    ref = pf.rfft_phase_b_plain(at, t)
    for pairs in (1, 2, 4, 8, 16):
        if 2 * pairs * m2 // 16 <= 1024:
            assert _rel(pf._launch_phase_b(at, t, pairs), ref) < REL, pairs
    plan.clear_plans()


@pytest.mark.parametrize('e', range(20, 27))
def test_irfft_phase_a_block_shapes(e):
    """K3 with every number of row pairs a block of chip_smoke.py
    --profile's candidates (2-16) that 1024 threads allow, and P = 1,
    against its plain version; the wrapper's P among them. A P off the
    launcher (not a power of two, or over 1024 threads) is refused."""
    n = 2**e
    t = plan.get_plan(n, 'packed', torch.complex64)[1]
    n1, n2 = stream.factors(n)
    m2 = n2 // 2
    spec = _cnormal(n // 2 + 1, e)
    ref = pf.irfft_phase_a_plain(spec, t)
    pairs = [p for p in (1, 2, 4, 8, 16) if 2 * p * m2 // 16 <= 1024]
    assert pf.block_pairs(m2, inverse=True) in pairs
    for p in pairs:
        assert _rel(pf._launch_inv_phase_a(spec, t, p), ref) < REL, p
    for p in (3, 2 * pairs[-1]):
        with pytest.raises(RuntimeError, match='dsc_irfft_phase_a'):
            pf._launch_inv_phase_a(spec, t, p)
    plan.clear_plans()


@pytest.mark.parametrize('e', [21, 24])
def test_irfft_phase_a_non_hermitian_spectrum(e):
    """K3 on a spectrum whose X[0] and X[n/2] are not real: it reads their
    real parts, as its plain version and np.fft.irfft do."""
    n = 2**e
    t = plan.get_plan(n, 'packed', torch.complex64)[1]
    spec = _cnormal(n // 2 + 1, e)
    assert _rel(pf.irfft_phase_a(spec, t), pf.irfft_phase_a_plain(spec, t)) < REL
    got = dt.irfft(dt.from_numpy(spec.cpu().numpy())).numpy()
    ref = np.fft.irfft(spec.cpu().numpy().astype(np.complex128))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_public_path_launches_every_kernel():
    sig = np.random.default_rng(1).standard_normal(2**20).astype(np.float32)
    taps = np.blackman(255).astype(np.float32)
    build.reset_launches()
    spec = dt.rfft(dt.from_numpy(sig), n=2**21) * dt.rfft(dt.from_numpy(taps), n=2**21)
    y = dt.irfft(spec)[: 2**20 + 254].numpy()
    small = dt.irfft(dt.rfft(dt.from_numpy(sig[:4096]))).numpy()
    fft_kernels = ('base_irfft', 'base_rfft', 'rfft_phase_a', 'rfft_phase_b', 'irfft_phase_a',
                   'irfft_phase_b')
    assert all(build.launches[k] > 0 for k in fft_kernels), build.launches
    assert build.launches['stream_map'] == 0  # the 2^20+1 spectra multiply in plain torch
    ref = np.convolve(sig.astype(np.float64), taps.astype(np.float64))
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-4
    assert np.abs(small - sig[:4096]).max() < 1e-5


# (n1, n2, batch): the column pass's L = n1 (K6) and n2 (K7) from 256 to
# 4096, with 1 to 8 columns and 32 to 1024 threads a block
# (stream.block_columns; (2048, 2048, 2) takes 8 columns of 2048 for the
# float32 output); (1024, 512, 5) leaves a ragged last wave of blocks
STREAM_CASES = [(512, 512, 1), (512, 256, 2), (256, 256, 6), (1024, 1024, 3), (2048, 2048, 1),
                (2048, 2048, 2), (4096, 2048, 1), (1024, 512, 5)]


def _stream_input(n, batch, real, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    if not real:
        x = (x + 1j * rng.standard_normal((batch, n))).astype(np.complex64)
    return torch.from_numpy(x).cuda()


def _check_stream_kernels(x, t, inverse):
    z = stream.phase_a(x, t, inverse)
    assert _rel(z, stream.phase_a_plain(x, t, inverse)) < REL
    for real_output in (False, True):
        y = stream.phase_b(z, t, inverse, real_output)
        assert _rel(y, stream.phase_b_plain(z, t, inverse, real_output)) < REL


@pytest.mark.parametrize('inverse', [False, True])
@pytest.mark.parametrize('real', [False, True])
@pytest.mark.parametrize('n1,n2,batch', STREAM_CASES)
def test_stream_kernels(n1, n2, batch, real, inverse):
    t = plan.get_plan(n1 * n2, 'stream', torch.complex64)[1]
    x = _stream_input(n1 * n2, batch, real, n1 + n2 + batch)
    before = dict(build.launches)
    _check_stream_kernels(x, t, inverse)
    assert build.launches['stream_phase_a'] == before['stream_phase_a'] + 1
    assert build.launches['stream_phase_b'] == before['stream_phase_b'] + 2


def test_stream_kernels_single_2_26_inverse():
    n = 2**26
    t = plan.get_plan(n, 'stream', torch.complex64)[1]
    _check_stream_kernels(_stream_input(n, 1, False, 26), t, True)
    plan.clear_plans()


@pytest.mark.parametrize('e', [18, 19, 24])
def test_reconstruct_kernel(e):
    n = 2**e
    x = _stream_input(n // 2 + 1, 1, False, e)
    x.imag[0, -1] = 0  # a valid spectrum's Nyquist bin is real
    before = build.launches['reconstruct']
    got = reconstruct.reconstruct_spectrum(x, n)
    assert build.launches['reconstruct'] == before + 1
    assert torch.equal(got, reconstruct.reconstruct_plain(x, n))


def test_public_stream_routes_launch_one_pair_per_transform():
    rng = np.random.default_rng(4)
    c = (rng.standard_normal((6, 2**16)) + 1j * rng.standard_normal((6, 2**16))).astype(
        np.complex64)
    r = rng.standard_normal((4, 2**18)).astype(np.float32)
    spec = np.fft.rfft(rng.standard_normal(2**18)).astype(np.complex64)
    cases = [  # call, reference, reconstruct launches
        (lambda: dt.fft(dt.from_numpy(c)), np.fft.fft(c), 0),
        (lambda: dt.ifft(dt.from_numpy(c.reshape(-1)[:2**18])),
         np.fft.ifft(c.reshape(-1)[:2**18]), 0),
        (lambda: dt.rfft(dt.from_numpy(r)), np.fft.rfft(r), 0),
        (lambda: dt.irfft(dt.from_numpy(np.fft.rfft(r).astype(np.complex64))),
         np.fft.irfft(np.fft.rfft(r)), 0),
        (lambda: dt.rfft(dt.from_numpy(r.T.copy()), axis=0), np.fft.rfft(r.T, axis=0), 0),
        (lambda: dt.irfft(dt.from_numpy(spec)), np.fft.irfft(spec), 1),
    ]
    for call, ref, n_rec in cases:
        build.reset_launches()
        got = call().numpy()
        torch.cuda.synchronize()
        assert (build.launches['stream_phase_a'], build.launches['stream_phase_b'],
                build.launches['reconstruct']) == (1, 1, n_rec), build.launches
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_single_vector_routes_run_k8_on_cuda():
    """Single-vector rfft at 2^18 and fft at 2^18 return values on the card,
    through K6 + K8."""
    build.reset_launches()
    spec = dt.rfft(dt.from_numpy(np.ones(2**18, np.float32)))
    assert spec._layout == (512, 512, True)
    ref = np.zeros(2**17 + 1, np.complex64)
    ref[0] = 2**18
    np.testing.assert_allclose(spec.numpy(), ref, atol=0.5)
    c = np.exp(2j * np.pi * 5 * np.arange(2**18) / 2**18).astype(np.complex64)
    x = dt.fft(dt.from_numpy(c))
    assert x._layout == (512, 512, False)
    ref = np.fft.fft(c.astype(np.complex128))
    assert np.abs(x.numpy() - ref).max() / np.abs(ref).max() < 1e-4
    torch.cuda.synchronize()
    assert (build.launches['stream_phase_a'], build.launches['stream_phase_b_t'],
            build.launches['stream_phase_b']) == (2, 2, 0)
    # an elementwise op of 2^21 elements now launches K5
    x = np.random.default_rng(2).standard_normal(2**21).astype(np.float32)
    big = dt.from_numpy(x)
    before = build.launches['stream_map']
    got = (big * big).torch
    assert build.launches['stream_map'] == before + 1
    assert _rel(got, sm.stream_map_plain('mul', big.torch, big.torch)) < REL
    before = build.launches['stream_map']
    wide = dt.from_numpy(x.astype(np.float64))
    np.testing.assert_allclose((wide + wide).numpy(), 2 * x.astype(np.float64))
    outer = dt.from_numpy(x[:2048].reshape(2048, 1)) * dt.from_numpy(x[:2048].reshape(1, 2048))
    assert outer.shape == (2048, 2048)
    assert build.launches['stream_map'] == before   # plain PyTorch, as XLA there


# (n1, n2): the 2^18, 2^19, 2^21, 2^24 and 2^26 splits
T_CASES = [(512, 512), (1024, 512), (2048, 1024), (4096, 4096), (8192, 8192)]


@pytest.mark.parametrize('half', [False, True])
@pytest.mark.parametrize('n1,n2', T_CASES)
def test_stream_t_kernels(n1, n2, half):
    """K8, K9 and K10 each against its plain version on the same input, and
    the round trip K6 + K8 + K9 + K10 back to the input."""
    n = n1 * n2
    t = plan.get_plan(n, 'stream', torch.complex64)[1]
    x = _stream_input(n, 1, half, n1 + n2)
    z = stream.phase_a(x, t, False)
    before = dict(build.launches)
    s = stream_t.phase_b_t(z, t, half)
    assert _rel(s, stream_t.phase_b_t_plain(z, t, half)) < T_REL
    y = stream_t.inv_phase_a_t(s, t, half)
    assert _rel(y, stream_t.inv_phase_a_t_plain(s, t, half)) < T_REL
    for real_output in (False, True):
        back = stream_t.inv_phase_b_t(y, t, real_output)
        assert _rel(back, stream_t.inv_phase_b_t_plain(y, t, real_output)) < T_REL
    torch.cuda.synchronize()
    assert [build.launches[k] - before[k] for k in
            ('stream_phase_b_t', 'stream_inv_phase_a_t', 'stream_inv_phase_b_t')] == [1, 1, 2]
    want = x.reshape(-1) if half else x.reshape(-1).real
    assert float((back - want).abs().max() / want.abs().max()) < 1e-5
    del x, z, s, y, back
    plan.clear_plans()


@pytest.mark.parametrize('n1,n2', T_CASES)
def test_inv_phase_a_t_block_sizes(n1, n2):
    """K9 in the T layout with every R of chip_smoke.py --profile's block
    sizes (4096, 8192 and 16384 points) within 1024 threads, the
    wrapper's R among them, and in the half-T layout (one row pair a
    block), against its plain version. An R off the launcher (not dividing
    n1, or over 1024 threads) is refused."""
    n = n1 * n2
    t = plan.get_plan(n, 'stream', torch.complex64)[1]
    s = _cnormal((n1, n2), n1 + n2)
    ref = stream_t.inv_phase_a_t_plain(s, t, False)
    rows = [r for r in sorted({max(1, p // n2) for p in (4096, 8192, 16384)})
            if r * n2 // 16 <= 1024]
    for r in sorted({*rows, stream_t.block_rows(n2)}):
        assert _rel(stream_t._launch_inv_phase_a_t(s, t, False, r), ref) < T_REL, r
    for r in (3, 2 * rows[-1]):
        with pytest.raises(RuntimeError, match='dsc_stream_inv_phase_a_t'):
            stream_t._launch_inv_phase_a_t(s, t, False, r)
    half = s[:, :stream_t.width(n2, True)].contiguous()
    assert _rel(stream_t.inv_phase_a_t(half, t, True),
                stream_t.inv_phase_a_t_plain(half, t, True)) < T_REL
    del s, ref, half
    plan.clear_plans()


def test_public_single_vector_routes_launch_k8_k9_k10():
    rng = np.random.default_rng(6)
    for e in (18, 21):
        c = (rng.standard_normal(2**e) + 1j * rng.standard_normal(2**e)).astype(np.complex64)
        build.reset_launches()
        spec = dt.fft(dt.from_numpy(c))
        torch.cuda.synchronize()
        assert (build.launches['stream_phase_a'], build.launches['stream_phase_b_t'],
                build.launches['stream_phase_b']) == (1, 1, 0)
        ref = np.fft.fft(c.astype(np.complex128))
        assert np.abs(spec.numpy() - ref).max() / np.abs(ref).max() < 1e-4
        build.reset_launches()
        back = dt.ifft(spec).numpy()
        torch.cuda.synchronize()
        assert (build.launches['stream_inv_phase_a_t'], build.launches['stream_inv_phase_b_t'],
                build.launches['stream_phase_a']) == (1, 1, 0)
        assert np.abs(back - c).max() / np.abs(c).max() < 1e-5
    for e in (18, 19):
        r = rng.standard_normal(2**e).astype(np.float32)
        spec = dt.rfft(dt.from_numpy(r))
        assert spec._layout == (*stream.factors(2**e), True)
        ref = np.fft.rfft(r.astype(np.float64))
        assert np.abs(spec.numpy() - ref).max() / np.abs(ref).max() < 1e-4
        build.reset_launches()
        back = dt.irfft(spec)
        torch.cuda.synchronize()
        assert (build.launches['stream_inv_phase_a_t'], build.launches['stream_inv_phase_b_t'],
                build.launches['reconstruct']) == (1, 1, 0)
        assert back.shape == r.shape and back.dtype == dt.Dtype.F32
        assert np.abs(back.numpy() - r).max() / np.abs(r).max() < 1e-5


def _k5_operands(body, ne, seed):
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal(ne).astype(np.float32)).cuda()
          for _ in range(sm.REAL_BODIES[body])]
    if body in ('logn', 'log2', 'log10', 'sqrt'):
        xs = [x.abs() + 1e-3 for x in xs]
    if body == 'clip':
        xs[1:] = [-0.5, 0.75]
    return xs


@pytest.mark.parametrize('ne', [2**21, 2**21 + 4 * 1000 + 3, 5])
@pytest.mark.parametrize('body', list(sm.REAL_BODIES))
def test_stream_map_real_bodies(body, ne):
    xs = _k5_operands(body, ne, ne)
    before = build.launches['stream_map']
    got = sm.stream_map(body, *xs)
    assert build.launches['stream_map'] == before + 1
    assert _rel(got, sm.stream_map_plain(body, *xs)) < REL


@pytest.mark.parametrize('body', ['add', 'sub', 'mul', 'div'])
def test_stream_map_scalars_and_rows(body):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((512, 4096)).astype(np.float32)).cuda()
    row = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).cuda()
    one = torch.tensor([1.75], device='cuda')
    for ops in ((x, 2.5), (2.5, x), (x, one), (one, x), (x, row), (row, x)):
        assert _rel(sm.stream_map(body, *ops), sm.stream_map_plain(body, *ops)) < REL


@pytest.mark.parametrize('ne', [2**23 + 1, 2**21, 3])
@pytest.mark.parametrize('body', sm.COMPLEX_BODIES)
def test_stream_map_complex_bodies(body, ne):
    rng = np.random.default_rng(ne)
    a, b = (torch.from_numpy((rng.standard_normal(ne) + 1j * rng.standard_normal(ne))
                             .astype(np.complex64)).cuda() for _ in range(2))
    for ops in ((a, b), (a, 0.5 - 2j), (1.5 + 1j, b), (a, 3.0)):
        assert _rel(sm.stream_map(body, *ops), sm.stream_map_plain(body, *ops)) < REL


def test_stream_map_refuses_misaligned_data():
    x = torch.zeros(2**21 + 1, device='cuda')[1:]
    with pytest.raises(RuntimeError, match='aligned'):
        sm.stream_map('sin', x)


# K5, every instantiation (stream_map.INSTANTIATIONS): 2^21 elements, one
# 16-byte group past a block's chunk (512 float4 groups an operand), a
# chunk and a group on; complex also an odd count
K5_CHUNK = 4 * 512  # floats a block takes per operand
K5_COUNTS = (2**21, 2**21 + 4, 2**21 + K5_CHUNK + 4)


def _brow_split(n):
    """(rows, M) of n elements with the longest row the kernel takes (M % 4
    == 0) of at most 2^14 elements."""
    m = max(m for m in range(4, 2**14 + 1, 4) if n % m == 0 and n // m >= 2)
    return n // m, m


def _k5_kind_operands(dtype, body, kinds, n, seed):
    rng = np.random.default_rng(seed)
    shape = _brow_split(n) if 'brow' in kinds else (n,)
    ops = []
    for i, kind in enumerate(kinds):
        if kind == 'scalar':
            v = (0.25, -0.5, 0.75)[i] if dtype == torch.float32 else (0.5 - 1.25j, 2.0 - 0.5j)[i]
            # a Python value and a 1-element tensor in turn
            ops.append(v if (i + n) % 2 else torch.tensor([v], dtype=dtype, device='cuda'))
            continue
        sub = shape if kind == 'full' else shape[-1:]
        x = rng.standard_normal(sub).astype(np.float32)
        if dtype == torch.complex64:
            x = (x + 1j * rng.standard_normal(sub)).astype(np.complex64)
        elif body in ('logn', 'log2', 'log10', 'sqrt'):
            x = np.abs(x) + np.float32(1e-3)
        ops.append(torch.from_numpy(x).cuda())
    return ops


@pytest.mark.parametrize('n', K5_COUNTS)
@pytest.mark.parametrize('key', list(sm.INSTANTIATIONS), ids=lambda k: '-'.join(
    [str(k[0]).split('.')[-1], k[1], *k[2]]))
def test_stream_map_every_instantiation(key, n):
    dtype, body, kinds = key
    ops = _k5_kind_operands(dtype, body, kinds, n, n + len(kinds))
    before = build.launches['stream_map']
    got = sm.stream_map(body, *ops)
    assert build.launches['stream_map'] == before + 1
    assert _rel(got, sm.stream_map_plain(body, *ops)) < REL


@pytest.mark.parametrize('kinds', [('full', 'full'), ('full', 'scalar'), ('scalar', 'full')])
@pytest.mark.parametrize('body', sm.COMPLEX_BODIES)
def test_stream_map_complex_odd_count(body, kinds):
    ops = _k5_kind_operands(torch.complex64, body, kinds, 2**21 + 1, 7)
    assert _rel(sm.stream_map(body, *ops), sm.stream_map_plain(body, *ops)) < REL


def test_stream_map_refuses_combinations_outside_the_dispatch():
    """The C entry point returns cudaErrorInvalidValue for a body or a
    combination of kinds it has no instantiation for, and build.launch
    raises on it."""
    x = torch.ones(2**21, device='cuda')
    out = torch.empty_like(x)
    full = [x.data_ptr(), 0.0, 0.0, sm._FULL, 0]
    value = [None, 1.0, 0.0, sm._VALUE, 0]
    brow = [x.data_ptr(), 0.0, 0.0, sm._BROW, 1024]
    code = sm._CODES
    for args in ((code[torch.float32, 'sin'], *value, *value, *value),           # a scalar sine
                 (code[torch.float32, 'add'], *brow, *brow, *value),             # no full operand
                 (code[torch.complex64, 'mul'], *full, *brow, *value),           # a complex row
                 (code[torch.float32, 'add'], *full, 0, 0.0, 0.0, 7, 0, *value),  # no such kind
                 (len(code), *full, *full, *value)):                              # no such body
        before = build.launches['stream_map']
        with pytest.raises(RuntimeError, match='dsc_stream_map failed'):
            build.launch('stream_map', *args, out.data_ptr(), x.numel())
        assert build.launches['stream_map'] == before


# K5g: dsc.map bodies generated on K5's skeleton, each against the plain
# interpreter of its recorded op list, at a count past a block's chunk


MAP_BODIES = {
    'clip chain': (lambda x, y: dt.clip(x * y + 0.5, -1.0, 1.0), ('full', 'full')),
    'row and scalar': (lambda t, r, k: t * r + k, ('full', 'brow', 'scalar')),
    'two outputs': (lambda x, y: (x + y, x * y), ('full', 'full')),
    'sin cos exp': (lambda x, y: dt.sin(x) * dt.cos(y) + dt.exp(x * 0.25), ('full', 'full')),
    'sqrt log pow': (lambda x, y: dt.sqrt(dt.absolute(x)) + dt.logn(dt.absolute(y) + 1.0)
                     - x ** 2.0, ('full', 'full')),
    'row unaries': (lambda t, r: t * dt.cos(r) + dt.sinc(r) - dt.clip(r, -0.5, 0.5),
                    ('full', 'brow')),
}


def _map_operands(kinds, seed):
    rows, m = 2**21 // 4096 + 2, 4096  # 2^21 + 8192 elements
    gen = torch.Generator(device='cuda').manual_seed(seed)
    ops = []
    for kind in kinds:
        shape = {'full': (rows, m), 'brow': (m,), 'scalar': (1,)}[kind]
        ops.append(dt.Tensor(torch.randn(shape, device='cuda', generator=gen)))
    return ops


@pytest.mark.parametrize('case', list(MAP_BODIES))
def test_map_generated_kernel(case):
    fn, kinds = MAP_BODIES[case]
    args = _map_operands(kinds, len(case))
    mapped = dt.map(fn)
    before = build.launches['stream_map_gen']
    got = mapped(*args)
    assert build.launches['stream_map_gen'] == before + 1
    route, kernel, _ = next(iter(mapped._programs.values()))
    assert route == 'stream' and kernel.kinds == kinds
    got = got if isinstance(got, tuple) else (got,)
    for g, ref in zip(got, kernel.plain([a.torch for a in args])):
        assert _rel(g.torch, ref) < REL
    eager = fn(*args)
    for g, e in zip(got, eager if isinstance(eager, tuple) else (eager,)):
        assert _rel(g.torch, e.torch) < REL


@pytest.mark.parametrize('fn', [lambda x, y: torch.clamp_min(x, -0.5),
                                lambda x, y: torch.clamp_max(x, 0.5), torch.minimum,
                                torch.maximum], ids=['clamp_min', 'clamp_max', 'minimum',
                                                     'maximum'])
def test_map_generated_min_max_forms(fn):
    # forms no port op records, lowered from torch's own record on meta
    from dsc_tpu_torch.ops import map_gen

    shape = (2**21 + 8192,)
    metas = [torch.empty(shape, device='meta') for _ in range(2)]
    ops, out = map_gen.trace(lambda: fn(*metas))
    lines = map_gen.lower(ops, metas, [out], shape, ('full', 'full'))
    kernel = map_gen.MapKernel(ops, metas, [out], shape, ('full', 'full'),
                               map_gen.generate(lines, ('full', 'full'), 1))
    x, y = (t.torch.reshape(shape) for t in _map_operands(('full', 'full'), 7))
    x[::1000] = float('nan')
    got, = kernel([x, y])
    ref, = kernel.plain([x, y])
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


def test_map_outside_the_table_builds_nothing(monkeypatch):
    built = []
    monkeypatch.setattr(build, 'build_generated', lambda src: built.append(src))
    x = _map_operands(('full',), 3)[0]
    mapped = dt.map(lambda a: dt.angle(a))
    got = mapped(x)
    assert next(iter(mapped._programs.values()))[0] == 'compile' and built == []
    assert _rel(got.torch, dt.angle(x).torch) < REL


def test_compiled_filter_fft_against_eager():
    from dsc_tpu_torch.models import FilterFFT

    rng = np.random.default_rng(21)
    taps = rng.standard_normal(129).astype(np.float32)
    ff = FilterFFT(taps, 2**20)
    for seed in range(3):  # the trace and capture, then replays on new values
        blk = dt.from_numpy(np.random.default_rng(seed).standard_normal(2**20).astype(np.float32))
        before = dict(build.launches)
        got = ff(blk)
        if seed:  # a replay launches from the graph, not from Python
            assert build.launches == before
        eager = dt.irfft(dt.mul(dt.rfft(blk, n=ff.fft_n), ff.kernel_spec))[:ff.out_len]
        assert _rel(got.torch, eager.torch) < 1e-6
    assert ff._step.n_programs == 1 and ff._step._programs[next(iter(ff._step._programs))].graph


def test_compile_graph_is_functional_and_fresh():
    f = dt.compile(lambda x, k: dt.add(dt.mul(x, k), dt.randn(8)))
    a = dt.from_numpy(np.ones(8, np.float32))
    r1, r2 = f(a, 2.0), f(a, 2.0)
    assert r1._buf.data.data_ptr() != r2._buf.data.data_ptr()  # fresh outputs
    np.testing.assert_array_equal(r1.numpy(), r2.numpy())  # the same constant
    b = dt.from_numpy(np.full(8, 3.0, np.float32))
    np.testing.assert_allclose(f(b, 2.0).numpy() - r1.numpy(), np.full(8, 4.0), atol=1e-6)
    m0 = dt.used_mem()
    r3 = f(a, 2.0)
    assert dt.used_mem() == m0 + 32
    del r3


def test_map_under_compile_is_captured():
    fused = dt.map(lambda x, y: dt.clip(x * y + 0.5, -1.0, 1.0))
    pipe = dt.compile(lambda x, y: fused(x, y) * 2.0)
    x, y = _map_operands(('full', 'full'), 5)
    pipe(x, y)
    before = build.launches['stream_map_gen']
    got = pipe(x, y)  # a replay: the K5g launch is inside the graph
    assert build.launches['stream_map_gen'] == before
    assert _rel(got.torch, (dt.clip(x * y + 0.5, -1.0, 1.0) * 2.0).torch) < REL


# -- the model tier: each function on the card against the same call on
# the CPU (the kernels' plain versions), with the kernels it must launch

@pytest.mark.parametrize('batch', [8191, 8176])
def test_base_fft_kernel_at_welch_shapes(batch):
    """K12 at welch's launch shapes: nperseg 1024 at 1 x 2^22 and 16 x 2^18."""
    x = _cnormal((batch, 512), batch)
    w = plan.get_plan(512, 'complex', torch.complex64)[1]
    assert _rel(base_fft.fft_base(x, w), base_fft.fft_base_plain(x, w)) < REL


def _on_cpu(fn):
    """``fn()`` with the port's context on the CPU (every kernel wrapper runs
    its plain version there), the card's context restored after."""
    dt.shutdown()
    dt.init(2**34, device='cpu')
    try:
        return fn()
    finally:
        dt.shutdown()
        dt.init(2**34, device='cuda')


def _model_cases():
    import scipy.signal as sps

    from dsc_tpu_torch import models as M

    rng = np.random.default_rng(31)
    x20 = rng.standard_normal(2**20).astype(np.float32)
    x18 = rng.standard_normal((2, 2**18)).astype(np.float32)
    y18 = (0.5 * x18 + rng.standard_normal((2, 2**18))).astype(np.float32)
    t = np.sort(rng.uniform(0, 50, 1024))
    hann = sps.get_window('hann', 1024)

    def T(a):
        return dt.from_numpy(a)

    # (what, fn of nothing returning a Tensor, kernels it must launch)
    return {
        'welch': (lambda: M.welch(T(x20), nperseg=1024)[1], {'base_rfft'}),
        'welch median': (lambda: M.welch(T(x18), nperseg=1024, average='median')[1],
                         {'base_rfft'}),
        'csd': (lambda: M.csd(T(x18), T(y18), nperseg=1024)[1], {'base_rfft'}),
        'coherence': (lambda: M.coherence(T(x18), T(y18), nperseg=1024)[1], {'base_rfft'}),
        'psd_spectrogram': (lambda: M.psd_spectrogram(T(x18), nperseg=1024)[2],
                            {'base_rfft'}),
        'periodogram': (lambda: M.periodogram(T(x20))[1], {'stream_phase_a'}),
        'stft': (lambda: M.stft(T(x20), nperseg=1024)[2], {'base_rfft'}),
        'istft': (lambda: M.istft(M.stft(T(x20), nperseg=1024)[2], nperseg=1024)[1],
                  {'base_rfft', 'base_irfft'}),
        'ShortTimeFFT': (lambda: M.ShortTimeFFT(hann, 256, 1.0).stft(T(x20)), {'base_rfft'}),
        'ShortTimeFFT istft': (lambda: M.ShortTimeFFT(hann, 256, 1.0).istft(
            M.ShortTimeFFT(hann, 256, 1.0).stft(T(x20))), {'base_rfft', 'base_irfft'}),
        'cwt': (lambda: M.cwt(T(x20[:2**16]), M.ricker, np.arange(1, 9)),
                {'base_fft', 'stream_phase_a', 'stream_phase_b'}),
        'multitaper': (lambda: M.multitaper(T(x18[0]))[1], {'stream_phase_a'}),
        'lombscargle': (lambda: M.lombscargle(T(t), T(np.cos(t)), T(np.linspace(0.1, 5, 1024))),
                        set()),
        'hilbert': (lambda: M.hilbert(T(x20)), {'stream_phase_a', 'reconstruct'}),
        'resample': (lambda: M.resample(T(x20), 2**19), {'stream_phase_a', 'reconstruct'}),
        'resample_poly': (lambda: M.resample_poly(T(x18[0]), 3, 2), {'stream_phase_a'}),
        'savgol_filter': (lambda: M.savgol_filter(T(x20), 31, 3),
                          {'rfft_phase_a', 'irfft_phase_b'}),
        'envelope': (lambda: M.envelope(T(x18[0])), set()),
    }


@pytest.mark.parametrize('case', ['welch', 'welch median', 'csd', 'coherence',
                                  'psd_spectrogram', 'periodogram', 'stft', 'istft',
                                  'ShortTimeFFT', 'ShortTimeFFT istft', 'cwt', 'multitaper',
                                  'lombscargle', 'hilbert', 'resample', 'resample_poly',
                                  'savgol_filter', 'envelope'])
def test_model_on_the_card_against_the_cpu(case):
    fn, kernels = _model_cases()[case]
    build.reset_launches()
    got = fn()
    torch.cuda.synchronize()
    assert got.device.type == 'cuda'
    launched = {name for name, count in build.launches.items() if count}
    assert kernels <= launched, (case, launched)
    ref = _on_cpu(lambda: fn().numpy())
    out = got.numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= REL * np.abs(ref).max()


def _transforms_cases():
    import scipy.fft as sft

    import dsc_tpu_torch.transforms as tf

    rng = np.random.default_rng(41)
    z = (rng.standard_normal(10**6) + 1j * rng.standard_normal(10**6)).astype(np.complex64)
    x = rng.standard_normal((64, 1000)).astype(np.float32)
    # (call of nothing returning a Tensor, scipy.fft float64 reference, kernels it launches)
    return {
        'fft 1 x 10^6 (Bluestein m = 2^21)': (
            lambda: tf.fft(dt.from_numpy(z)), lambda: sft.fft(z.astype(np.complex128)),
            {'stream_phase_a': 2, 'stream_phase_b': 2}),
        'dct II ortho (64, 1000) (Bluestein m = 4096)': (
            lambda: tf.dct(dt.from_numpy(x), type=2, norm='ortho'),
            lambda: sft.dct(x.astype(np.float64), type=2, norm='ortho'), {'base_fft': 2}),
    }


@pytest.mark.parametrize('case', ['fft 1 x 10^6 (Bluestein m = 2^21)',
                                  'dct II ortho (64, 1000) (Bluestein m = 4096)'])
def test_transforms_on_the_card(case):
    """The transforms tier's Bluestein rows on the card: the kernels the
    core's rule gives them, within 2e-4 of scipy.fft in float64 and within
    REL of the same call on the CPU."""
    fn, ref, kernels = _transforms_cases()[case]
    build.reset_launches()
    got = fn()
    torch.cuda.synchronize()
    assert got.device.type == 'cuda'
    assert {name: count for name, count in build.launches.items() if count} == kernels
    out, want = got.numpy(), ref()
    assert np.isfinite(out).all()
    assert np.abs(out - want).max() <= 2e-4 * np.abs(want).max()
    cpu = _on_cpu(lambda: fn().numpy())
    assert out.dtype == cpu.dtype
    assert np.abs(out - cpu).max() <= REL * np.abs(cpu).max()


@pytest.mark.parametrize('fn', ['sosfilt', 'lfilter'])
def test_recurrence_on_the_card_against_scipy(fn):
    """sosfilt(butter(4, 0.25)) and lfilter of the same filter in 'ba' form
    at 2^20 on the card (the Toeplitz ladder with its middle level): within
    1e-4 of scipy.signal in float64 (tests/test_iir.py), with no kernel
    launched and the caller's TF32 setting as it was."""
    import scipy.signal as sps

    from dsc_tpu_torch import models as M

    x = np.random.default_rng(42).standard_normal(2**20).astype(np.float32)
    sos = M.butter(4, 0.25)
    args = (sos,) if fn == 'sosfilt' else M.butter(4, 0.25, output='ba')
    allow = torch.backends.cuda.matmul.allow_tf32
    build.reset_launches()
    got = getattr(M, fn)(*args, dt.from_numpy(x))
    torch.cuda.synchronize()
    assert got.device.type == 'cuda' and not any(build.launches.values())
    assert torch.backends.cuda.matmul.allow_tf32 == allow
    ref = sps.sosfilt(sos, x.astype(np.float64))
    out = got.numpy()
    assert np.isfinite(out).all() and np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_sosfilt_welch_captured_against_eager():
    """sosfilt -> welch(nperseg 256) of 4 x 4096 as one captured CUDA graph
    (tests/test_iir.py::test_iir_psd_compose_under_compile): the replay
    within 1e-6 of the eager chain and within 2e-4 of scipy float64."""
    import scipy.signal as sps

    from dsc_tpu_torch import models as M

    x = np.random.default_rng(43).standard_normal((4, 4096)).astype(np.float32)
    sos = M.butter(4, 0.3)

    def pipe(s):
        return M.welch(M.sosfilt(sos, s), nperseg=256)[1]

    compiled = dt.compile(pipe)
    t = dt.from_numpy(x)
    compiled(t)
    got = compiled(t).numpy()  # a replay
    eager = pipe(t).numpy()
    assert compiled.n_programs == 1
    assert np.abs(got - eager).max() <= 1e-6 * np.abs(eager).max()
    ref = sps.welch(sps.sosfilt(sos, x.astype(np.float64), axis=-1), nperseg=256, axis=-1)[1]
    assert np.abs(got - ref).max() < 2e-4 * ref.max()


def test_dlsim_on_the_card_against_scipy():
    """dlsim of the zoh discretization (dt = 1e-3) of the analog
    butter(4, 2 pi 50) over 2^20 steps on the Tensor path: float64 on the
    card, float32 results there, within 1e-5 of scipy.signal.lfilter of the
    same discrete system in float64 (tests/test_statespace.py's bound), with
    no kernel launched."""
    import scipy.signal as sps

    from dsc_tpu_torch import models as M

    sysd = M.cont2discrete(M.tf2ss(*sps.butter(4, 2 * np.pi * 50, analog=True)), 1e-3)
    num, den = sps.ss2tf(*sysd[:4])
    u = np.random.default_rng(44).standard_normal(2**20).astype(np.float32)
    build.reset_launches()
    _, y, x = M.dlsim(sysd, dt.from_numpy(u))
    torch.cuda.synchronize()
    assert not any(build.launches.values())
    assert y.device.type == 'cuda' and y.dtype == dt.Dtype.F32 and x.shape == (2**20, 4)
    ref = sps.lfilter(num[0], den, u.astype(np.float64))
    out = y.numpy()[:, 0]
    assert np.isfinite(out).all() and np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize('lamb', [0.0, 1.0])
def test_cspline1d_on_the_card_against_scipy(lamb):
    """cspline1d of 2^20 samples on the card (lamb 0: the first-order scans;
    lamb 1: the smoothing second-order cascade), within 1e-6 of
    scipy.signal.cspline1d in float64 (tests/test_splines.py's bound)."""
    import scipy.signal as sps

    from dsc_tpu_torch import models as M

    x = np.random.default_rng(45).standard_normal(2**20).astype(np.float32)
    build.reset_launches()
    got = M.cspline1d(dt.from_numpy(x), lamb)
    torch.cuda.synchronize()
    assert not any(build.launches.values()) and got.device.type == 'cuda'
    ref = sps.cspline1d(x.astype(np.float64), lamb)
    out = got.numpy()
    assert np.isfinite(out).all() and np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


# the sharded four-step's local blocks: (n, d) -> K6 local (n1, n2/d), K7
# local (n2, n1/d); 2^24 over 8 gives the narrowest grid, (4096, 512)
LOCAL_CASES = [(2**24, 4), (2**24, 8), (2**26, 4), (2**20, 4)]


@pytest.mark.parametrize('inverse', [False, True])
@pytest.mark.parametrize('n,d,p', [(n, d, p) for n, d in LOCAL_CASES for p in range(d)])
def test_stream_local_kernels(n, d, p, inverse):
    """K6 local (col0 = p * n2/d, complex64 and float32 input) and K7 local
    (n1/d columns, 1/n on the inverse, complex64 and the real output) of the
    d-way sharded n-point four-step against their plain versions, each
    launch counted under its own name (the cluster column pass, not K6's or
    K7's entry point)."""
    n1, n2 = stream.factors(n)
    t = plan.get_plan(n, 'stream', torch.complex64, torch.device('cuda', 0))[1]
    x = _cnormal((n1, n2 // d), 60 + p + d)
    before = dict(build.launches)
    for blk in (x, x.real.contiguous()):
        z = stream.phase_a_local(blk, t, p * n2 // d, inverse)
        assert _rel(z, stream.phase_a_local_plain(blk, t, p * n2 // d, inverse)) < REL
    zx = _cnormal((n2, n1 // d), 70 + p + d)
    for real_output in (False, True):
        got = stream.phase_b_local(zx, t, n1 // d, inverse, real_output)
        assert _rel(got, stream.phase_b_local_plain(zx, t, n1 // d, inverse, real_output)) < REL
    assert build.launches['stream_phase_a_local'] == before['stream_phase_a_local'] + 2
    assert build.launches['stream_phase_b_local'] == before['stream_phase_b_local'] + 2
    assert build.launches['stream_phase_a'] == before['stream_phase_a']
    assert build.launches['stream_phase_b'] == before['stream_phase_b']


def test_stream_local_kernels_refuse_a_misaligned_block():
    """A block that is not 16-byte aligned raises (TMA reads from a 16-byte
    aligned base); nothing is launched and no plain version runs."""
    n, d = 2**24, 4
    n1, n2 = stream.factors(n)
    t = plan.get_plan(n, 'stream', torch.complex64, torch.device('cuda', 0))[1]
    flat = torch.zeros(n1 * n2 // d + 1, dtype=torch.complex64, device='cuda')
    before = build.launches['stream_phase_a_local']
    with pytest.raises(RuntimeError, match='aligned'):
        stream.phase_a_local(flat[1:].view(n1, n2 // d), t, 0, False)
    assert build.launches['stream_phase_a_local'] == before


def test_distributed_fft_stream_on_a_virtual_mesh():
    """The 2^24 sharded streaming fft -> ifft over 4 entries of cuda:0: 4
    launches of each local kernel a call, within 1e-4 of np.fft."""
    from dsc_tpu_torch.parallel import distributed_fft_stream, make_mesh

    mesh = make_mesh((1, 4), devices=[torch.device('cuda', 0)] * 4)
    v = _cnormal(2**24, 80)
    build.reset_launches()
    got = distributed_fft_stream(v, mesh)
    torch.cuda.synchronize()
    assert {k: c for k, c in build.launches.items() if c} == {
        'stream_phase_a_local': 4, 'stream_phase_b_local': 4}
    ref = np.fft.fft(v.cpu().numpy().astype(np.complex128))
    assert np.abs(np.asarray(got) - ref).max() / np.abs(ref).max() < 1e-4
    back = distributed_fft_stream(got, mesh, inverse=True)
    assert float((back.full() - v).abs().max()) < 1e-4


def test_compile_mesh_filter_fft_on_a_virtual_mesh():
    """The batch-sharded filterFFT of 16 x 2^20 with 4097 Blackman taps as a
    mesh program over 4 entries of cuda:0 (one captured graph, replayed a
    shard) equals the single-device compiled call within 1e-5, on its first
    call and on a replay; its shards' runs launch K6/K7."""
    from dsc_tpu_torch.parallel import P, Sharded, make_mesh

    def filt(sig, taps):
        return dt.irfft(dt.mul(dt.rfft(sig), dt.rfft(taps, n=2**20)))

    mesh = make_mesh((4, 1), devices=[torch.device('cuda', 0)] * 4)
    rng = np.random.default_rng(90)
    sig = dt.from_numpy(rng.standard_normal((16, 2**20)).astype(np.float32))
    taps = dt.from_numpy(np.blackman(4097).astype(np.float32))
    mp = dt.compile(filt, mesh=mesh, in_specs=(P('data'), P()), out_specs=P('data'))
    build.reset_launches()
    got = mp(sig, taps)
    torch.cuda.synchronize()
    assert build.launches['stream_phase_a'] > 0 and build.launches['stream_phase_b'] > 0
    assert isinstance(got, Sharded) and [tuple(s.shape) for s in got.shards] == [(4, 2**20)] * 4
    single = dt.compile(filt)(sig, taps).torch
    assert _rel(got.full(), single) < 1e-5
    assert _rel(mp(sig, taps).full(), single) < 1e-5
    assert mp.n_programs == 1


def test_compile_mesh_on_a_mesh_of_two_devices():
    """A mesh of two distinct devices, cuda:0 and the CPU, twice each: one
    program a device (a captured graph on the card, ``fn`` re-run on the
    CPU), the replicated taps copied to both, the STFT's windows and
    1/sum(w^2) placed on each, the shards joined across the two. The
    filterFFT against float64 NumPy, the STFT -> mask -> ISTFT pipeline
    against its eager call on the card, each within 1e-4; the card's
    shards launch K6/K7."""
    from dsc_tpu_torch.models import ISTFT, STFT
    from dsc_tpu_torch.parallel import P, Sharded, make_mesh

    cuda, cpu = torch.device('cuda', 0), torch.device('cpu')
    mesh = make_mesh((4, 1), devices=[cuda, cpu] * 2)
    rng = np.random.default_rng(91)
    sig_np = rng.standard_normal((16, 2**20)).astype(np.float32)
    taps_np = np.blackman(4097).astype(np.float32)

    def filt(sig, taps):
        return dt.irfft(dt.mul(dt.rfft(sig), dt.rfft(taps, n=2**20)))

    mp = dt.compile(filt, mesh=mesh, in_specs=(P('data'), P()), out_specs=P('data'))
    taps = dt.from_numpy(taps_np)
    build.reset_launches()
    got = mp(sig_np, taps)
    torch.cuda.synchronize()
    assert build.launches['stream_phase_a'] > 0 and build.launches['stream_phase_b'] > 0
    assert isinstance(got, Sharded) and [s.device for s in got.shards] == mesh.device_list
    prog, = mp._programs.values()
    assert set(prog.programs) == {cuda, cpu}
    assert prog.programs[cuda].graph is not None and prog.programs[cpu].graph is None
    assert {dev for dev in mp._replicas[taps._buf][2]} == {cuda, cpu}
    ref = torch.from_numpy(np.fft.irfft(np.fft.rfft(sig_np.astype(np.float64), axis=-1)
                                        * np.fft.rfft(taps_np.astype(np.float64), n=2**20),
                                        n=2**20, axis=-1))
    assert _rel(got.full().cpu().double(), ref) < 1e-4
    assert _rel(mp(sig_np, taps).full().cpu().double(), ref) < 1e-4

    stc, ist = STFT(1024, 256, 'hann', mode='complex'), ISTFT(1024, 256, 'hann')

    def pipe(x):
        z = stc(x)
        mag = dt.absolute(z)
        gate = dt.clip(dt.sub(dt.true_div(mag, dt.mean(mag, axis=2, keepdims=True)), 2.0),
                       0.0, 1.0)
        return ist(dt.mul(z, gate), length=2**16)

    x_np = rng.standard_normal((8, 2**16)).astype(np.float32)
    sp = dt.compile(pipe, mesh=mesh, in_specs=(P('data'),))
    got = sp(x_np)
    assert isinstance(got, Sharded) and [s.device for s in got.shards] == mesh.device_list
    assert {dev for _, dev in ist._inv_wsq_cache} >= {cuda, cpu}
    eager = pipe(dt.from_numpy(x_np)).torch
    assert _rel(got.full(), eager) < 1e-4
    assert _rel(sp(x_np).full(), eager) < 1e-4
