"""K12's plain version (dsc_tpu_torch/fourier/base_fft.py) against the JAX
package's Pallas base-case kernel, run in interpret mode on the CPU
(dsc_tpu/fourier/pallas_kernels.py fft_base_planar)."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu.fourier import pallas_kernels  # noqa: E402
from dsc_tpu_torch.fourier import base_fft, config, core, plan  # noqa: E402


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


@pytest.mark.parametrize('batch', [3, 130])
@pytest.mark.parametrize('n', [256, 1024, 4096])
def test_plain_matches_pallas_interpret(n, batch):
    rng = np.random.default_rng(n + batch)
    xr = rng.standard_normal((batch, n)).astype(np.float32)
    xi = rng.standard_normal((batch, n)).astype(np.float32)
    yr, yi = jax.jit(lambda a, b: pallas_kernels.fft_base_planar(a, b, n))(xr, xi)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    w = plan.get_plan(n, 'complex', torch.complex64)[1]
    x = torch.from_numpy((xr + 1j * xi).astype(np.complex64))
    got = base_fft.fft_base_plain(x, w).numpy()
    assert got.shape == ref.shape == (batch, n)
    assert got.dtype == np.complex64
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-5, err
    # the wrapper runs the plain version for a CPU tensor
    np.testing.assert_array_equal(base_fft.fft_base(x, w).numpy(), got)


@pytest.mark.parametrize('n,match', [(256, 'CUDA'), (8192, 'power of two')])
def test_wrapper_refuses_what_the_kernel_does_not_take(n, match):
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    the meta device, or a row longer than the kernel takes, is refused
    before any build."""
    w = plan.get_plan(n, 'complex', torch.complex64)[1]
    x = torch.empty((2, n), dtype=torch.complex64, device='meta')
    with pytest.raises(RuntimeError, match=match):
        base_fft.fft_base(x, w)


def test_k12_takes_every_leaf_of_the_plan():
    """K12's largest size is the plan's leaf size, one constant: no leaf of
    a plan is longer than K12 takes, and every complex64 leaf of 256
    points or more runs K12."""
    assert config.BASE_KERNEL_MAX_N is plan.BASE_MAX

    def leaves(spec):
        return [spec[1]] if spec[0] == 'base' else leaves(spec[3]) + leaves(spec[4])

    assert plan.build_spec(2 * plan.BASE_MAX)[0] == 'split'
    for log2n in range(25):
        for leaf in leaves(plan.build_spec(1 << log2n)):
            assert leaf <= config.BASE_KERNEL_MAX_N
            assert config.use_base_kernel(np.complex64, leaf) == (leaf >= 256)


@pytest.mark.parametrize('batch', [1, 3, 130, 1000, 65536])
@pytest.mark.parametrize('n', [256, 512, 1024, 2048, 4096])
def test_block_rows(n, batch):
    """R, the rows a block of K12, for every n the routes give it and the
    batches they give it, against what the kernel needs of it
    (csrc/base_fft.cu dsc_base_fft: R*n/16 <= 1024 threads, R padded rows
    within a block's 227 KB of shared memory) and what the timed
    candidates chose; the blocks cover each row once."""
    r = base_fft.block_rows(n, batch)
    assert r >= 1 and r & (r - 1) == 0
    assert r * n // 16 <= 1024
    assert r * (n + n // 16) * 8 <= 227 * 1024
    # the table's R, halved only as far as a grid of MIN_BLOCKS needs
    table = base_fft.ROWS[n]
    blocks = -(-batch // r)
    assert r <= table and (r == table or -(-batch // (2 * r)) < base_fft.MIN_BLOCKS)
    assert blocks >= base_fft.MIN_BLOCKS or r == 1
    rows = (np.arange(blocks)[:, None] * r + np.arange(r)[None, :]).ravel()
    np.testing.assert_array_equal(rows[rows < batch], np.arange(batch))


@pytest.mark.parametrize('n', [128, 8192, 768])
def test_block_rows_refuses_lengths_off_the_kernel(n):
    with pytest.raises(ValueError, match='base_fft'):
        base_fft.block_rows(n, 1000)


# -- K12r: the batched real FFT with the untangle in K12's store ----------

def _real_plan(n, cdtype):
    spec, (w, wu) = plan.get_plan(n, 'real', cdtype, 'cpu')
    return spec, w, wu


def _np_rows(batch, n, seed, dtype):
    return np.random.default_rng(seed).standard_normal((batch, n)).astype(dtype)


@pytest.mark.parametrize('batch', [1, 7, 64])
@pytest.mark.parametrize('nh', [256, 512, 1024, 2048, 4096])
def test_rfft_plain_matches_jax_and_numpy_in_float64(nh, batch):
    """K12r's plain version in float64 against the JAX package's
    ``rfft_batched`` on the same rows and against np.fft.rfft; the wrapper
    runs it for a CPU tensor."""
    from dsc_tpu.fourier import core as jcore
    from dsc_tpu.fourier import plan as jplan

    n = 2 * nh
    x = _np_rows(batch, n, nh + batch, np.float64)
    spec, w, wu = _real_plan(n, torch.complex128)
    assert spec == ('base', nh)
    got = base_fft.rfft_base_plain(torch.from_numpy(x), w, wu)
    assert got.dtype == torch.complex128 and got.shape == (batch, nh + 1)
    jspec, jtables = jplan.get_plan(n, 'real', np.complex128)
    ref = np.asarray(jax.jit(lambda a: jcore.rfft_batched(a, jspec, jtables, n))(x))
    want = np.fft.rfft(x, axis=-1)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - ref).max() / scale < 1e-13
    assert np.abs(got.numpy() - want).max() / scale < 1e-13
    np.testing.assert_array_equal(base_fft.rfft_base(torch.from_numpy(x), w, wu).numpy(),
                                  got.numpy())


@pytest.mark.parametrize('batch,nh', [(0, 512), (1, 256), (1001, 4096), (54912, 256)])
def test_rfft_plain_float32_batches(batch, nh):
    """K12r's plain version in float32 on an empty batch, one row, a ragged
    count and the spectrogram cell's 54,912 frames, against np.fft.rfft in
    float64."""
    n = 2 * nh
    x = _np_rows(batch, n, batch + nh, np.float32)
    _, w, wu = _real_plan(n, torch.complex64)
    got = base_fft.rfft_base(torch.from_numpy(x), w, wu).numpy()
    assert got.dtype == np.complex64 and got.shape == (batch, nh + 1)
    if batch:
        want = np.fft.rfft(x.astype(np.float64), axis=-1)
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-6


@pytest.mark.parametrize('dtype,device,n,takes', [
    (torch.float32, 'cuda', 512, True),
    (torch.float32, 'cuda', 1024, True),
    (torch.float32, 'cuda', 2048, True),
    (torch.float32, 'cuda', 4096, True),
    (torch.float32, 'cuda', 8192, True),
    (torch.float32, 'cuda', 256, False),       # a half of 128 points: Stockham
    (torch.float32, 'cuda', 16384, False),     # a half of 8192: the four-step
    (torch.float32, 'cuda', 2**17, False),     # no packed half-size plan
    (torch.float64, 'cuda', 1024, False),
    (torch.float32, 'cpu', 1024, True),
    (torch.float64, 'cpu', 1024, False),
    (torch.float32, 'meta', 1024, True),
])
def test_which_rows_ride_k12r(dtype, device, n, takes):
    """The engine of a batched rfft's rows that do not stream
    (config.batched_engine): float32 rows of 512..8192 points take K12r,
    whose wrapper launches it on a CUDA tensor, runs its plain version on a
    CPU one and refuses any other; every other row keeps the core's plain
    path (K12 or Stockham, and the untangle). The rule reads no device: the
    rows' device does not change the answer."""
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    spec, (_, wu) = plan.get_plan(n, 'real', cdt, 'cpu')
    engine = config.batched_engine('r2c', dtype, 4, n, streams=False)
    assert engine == ('base' if takes else 'plain'), device
    if takes:  # the kernel's tables: the packed half-size base-case plan
        assert spec == ('base', n // 2) and wu.shape == (n // 2 + 1,)


def test_rfft_batched_sends_riding_rows_to_k12r(monkeypatch):
    """rfft_batched hands rows that ride K12r to ``rfft_base`` with the
    plan's tables, on a CPU tensor too, and keeps its own half-size
    transform and untangle for the rows the rule sends to 'plain': on a CPU
    tensor both give the same numbers, bit for bit."""
    from dsc_tpu_torch import tracing

    n = 1024
    spec, tables = plan.get_plan(n, 'real', torch.complex64, 'cpu')
    x = torch.from_numpy(_np_rows(5, n, 3, np.float32))
    calls = []
    rfft_base = base_fft.rfft_base
    monkeypatch.setattr(base_fft, 'rfft_base',
                        lambda a, w, wu: calls.append((a.shape, w, wu)) or rfft_base(a, w, wu))
    tracing.clear_traces()
    tracing.set_recording(True)
    try:
        got = core.rfft_batched(x, spec, tables, n)
        assert len(calls) == 1
        monkeypatch.setattr(config, 'batched_engine', lambda *a: 'plain')
        plain = core.rfft_batched(x, spec, tables, n)
        assert tracing.totals()[('plain', 'untangle')]['count'] == 2
    finally:
        tracing.set_recording(False)
        tracing.clear_traces()
    assert len(calls) == 1 and calls[0][0] == (5, n)
    assert calls[0][1] is tables[0] and calls[0][2] is tables[1]
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize('n,match', [(1024, 'CUDA'), (16384, 'twice a power of two'),
                                     (1000, 'twice a power of two')])
def test_rfft_wrapper_refuses_what_the_kernel_does_not_take(n, match):
    _, w, wu = _real_plan(1024, torch.complex64)
    x = torch.empty((2, n), dtype=torch.float32, device='meta')
    with pytest.raises(RuntimeError, match=match):
        base_fft.rfft_base(x, w, wu)


# -- K12ir: the batched inverse real FFT with the entangle in K12's load ----

def _half_spectra(batch, nh, seed, cdtype):
    """Half spectra (batch, nh + 1) whose X[0] and X[nh] have nonzero
    imaginary parts, as a spectrum a model rebuilds can have."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, nh + 1)) + 1j * rng.standard_normal((batch, nh + 1))
    assert (x[:, [0, nh]].imag != 0).all()
    return torch.from_numpy(x.astype(cdtype))


@pytest.mark.parametrize('batch', [1, 7, 64])
@pytest.mark.parametrize('nh', [256, 512, 1024, 2048, 4096])
def test_irfft_plain_matches_the_batched_route(nh, batch, monkeypatch):
    """K12ir's plain version gives what irfft_batched's own plain route
    gives, bit for bit, on half spectra with nonzero Im X[0] and Im X[nh]:
    the entangle's k = 0 pairs X[0] with X[nh] and folds both imaginary
    parts in, as the JAX package does; the wrapper runs it for a CPU
    tensor."""
    n = 2 * nh
    spec, tables = plan.get_plan(n, 'real', torch.complex64, 'cpu')
    w, wu = tables
    x = _half_spectra(batch, nh, nh + batch, np.complex64)
    got = base_fft.irfft_base_plain(x, w, wu)
    assert got.dtype == torch.float32 and got.shape == (batch, n)
    np.testing.assert_array_equal(base_fft.irfft_base(x, w, wu).numpy(), got.numpy())
    np.testing.assert_array_equal(core.irfft_batched(x, spec, tables, n).numpy(), got.numpy())
    monkeypatch.setattr(config, 'batched_engine', lambda *a: 'plain')
    np.testing.assert_array_equal(core.irfft_batched(x, spec, tables, n).numpy(), got.numpy())
    # the imaginary parts of X[0] and X[nh] move the result: the route
    # does not drop them as np.fft.irfft does
    x0 = x.clone()
    x0[:, 0] = x0[:, 0].real.to(x0.dtype)
    x0[:, nh] = x0[:, nh].real.to(x0.dtype)
    assert not torch.equal(base_fft.irfft_base_plain(x0, w, wu), got)


@pytest.mark.parametrize('batch', [0, 1, 5, 1001])
@pytest.mark.parametrize('nh', [256, 512, 1024, 2048, 4096])
def test_irfft_plain_against_numpy_in_float64(nh, batch):
    """K12ir's plain version on the rfft spectra of float64 rows gives the
    rows back, in float64 within rounding and in float32 within 2e-6 of
    np.fft.irfft in float64; an empty batch gives no rows."""
    n = 2 * nh
    rows = _np_rows(batch, n, 3 * nh + batch, np.float64)
    spec64 = np.fft.rfft(rows, axis=-1)
    for cdt, bound in ((torch.complex128, 1e-13), (torch.complex64, 2e-6)):
        _, w, wu = _real_plan(n, cdt)
        x = torch.from_numpy(spec64.astype(np.complex64 if cdt == torch.complex64 else
                                           np.complex128))
        got = base_fft.irfft_base_plain(x, w, wu).numpy()
        assert got.shape == (batch, n)
        if batch:
            want = np.fft.irfft(x.numpy().astype(np.complex128), n, axis=-1)
            assert np.abs(got - want).max() / np.abs(want).max() < bound
            assert np.abs(want - rows).max() / np.abs(rows).max() < 1e-6


@pytest.mark.parametrize('dtype,device,n,takes', [
    (torch.complex64, 'cuda', 512, True),
    (torch.complex64, 'cuda', 1024, True),
    (torch.complex64, 'cuda', 2048, True),
    (torch.complex64, 'cuda', 4096, True),
    (torch.complex64, 'cuda', 8192, True),
    (torch.complex64, 'cuda', 256, False),      # a half of 128 points: Stockham
    (torch.complex64, 'cuda', 16384, False),    # a half of 8192: the four-step
    (torch.complex64, 'cuda', 2**17, False),    # no packed half-size plan
    (torch.complex128, 'cuda', 1024, False),
    (torch.float32, 'cuda', 1024, False),
    (torch.complex64, 'cpu', 1024, True),
    (torch.complex128, 'cpu', 1024, False),
    (torch.complex64, 'meta', 1024, True),
])
def test_which_rows_ride_k12ir(dtype, device, n, takes):
    """The engine of a batched irfft's rows that do not stream
    (config.batched_engine): complex64 half spectra of 512..8192-point rows
    take K12ir, whose wrapper launches it on a CUDA tensor, runs its plain
    version on a CPU one and refuses any other; every other row keeps the
    core's plain path (the entangle, and K12 or Stockham). The rule reads
    no device: the rows' device does not change the answer."""
    cdt = torch.complex128 if dtype == torch.complex128 else torch.complex64
    spec, (_, wu) = plan.get_plan(n, 'real', cdt, 'cpu')
    engine = config.batched_engine('c2r', dtype, 4, n, streams=False)
    assert engine == ('base' if takes else 'plain'), device
    if takes:  # the kernel's tables: the packed half-size base-case plan
        assert spec == ('base', n // 2) and wu.shape == (n // 2 + 1,)


def test_irfft_batched_sends_riding_rows_to_k12ir(monkeypatch):
    """irfft_batched hands rows that ride K12ir to ``irfft_base`` with the
    plan's tables, on a CPU tensor too, and keeps its own entangle and
    half-size inverse for the rows the rule sends to 'plain': on a CPU
    tensor both give the same numbers, bit for bit."""
    from dsc_tpu_torch import tracing

    n = 1024
    spec, tables = plan.get_plan(n, 'real', torch.complex64, 'cpu')
    x = _half_spectra(5, n // 2, 4, np.complex64)
    calls = []
    irfft_base = base_fft.irfft_base
    monkeypatch.setattr(base_fft, 'irfft_base',
                        lambda a, w, wu: calls.append((a.shape, w, wu)) or irfft_base(a, w, wu))
    tracing.clear_traces()
    tracing.set_recording(True)
    try:
        got = core.irfft_batched(x, spec, tables, n)
        assert len(calls) == 1
        monkeypatch.setattr(config, 'batched_engine', lambda *a: 'plain')
        plain = core.irfft_batched(x, spec, tables, n)
        assert tracing.totals()[('plain', 'entangle')]['count'] == 2
    finally:
        tracing.set_recording(False)
        tracing.clear_traces()
    assert len(calls) == 1 and calls[0][0] == (5, n // 2 + 1)
    assert calls[0][1] is tables[0] and calls[0][2] is tables[1]
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize('bins,match', [(513, 'CUDA'), (8193, 'one more than a power of two'),
                                        (129, 'one more than a power of two'),
                                        (512, 'one more than a power of two')])
def test_irfft_wrapper_refuses_what_the_kernel_does_not_take(bins, match):
    """Off the CPU the wrapper launches K12ir or raises: a tensor on the
    meta device, or a half spectrum whose half size the kernel does not
    take, is refused before any build."""
    _, w, wu = _real_plan(1024, torch.complex64)
    x = torch.empty((2, bins), dtype=torch.complex64, device='meta')
    with pytest.raises(RuntimeError, match=match):
        base_fft.irfft_base(x, w, wu)


def test_irfft_launcher_refuses_a_lazy_conjugate():
    """The private launcher takes the rows as the kernel reads them: a
    lazily conjugated tensor, whose data holds the unconjugated values, is
    refused before the tensor checks."""
    _, w, wu = _real_plan(1024, torch.complex64)
    x = torch.empty((2, 513), dtype=torch.complex64, device='meta').conj()
    with pytest.raises(RuntimeError, match='lazy conjugate'):
        base_fft._launch_irfft(x, w, wu, 1)


# -- K12s: the forward STFT in one launch ---------------------------------

def _signal(batch, valid, seed, stride=None, offset=0):
    """(batch, valid) float32 rows, ``stride`` floats apart and ``offset``
    floats into a wider tensor where given: a strided view."""
    stride = valid if stride is None else stride
    wide = torch.from_numpy(
        np.random.default_rng(seed).standard_normal(batch * stride + offset).astype(np.float32))
    return wide[offset:offset + batch * stride].view(batch, stride)[:, :valid]


def _stft_before(x, start, n_frames, hop, window, fft_n, mode, eps):
    """The forward STFT as models/stft.py and griffin_lim.py composed it
    before K12s: the centre's zeros padded at both ends (a negative start),
    the strided frames with their zero tail, the window, the pad to fft_n,
    the batched rfft, the power and the log."""
    frame = window.shape[0]
    pad = torch.nn.functional.pad
    x = pad(x, (-start, -start)) if start < 0 else x[:, start:]
    need = (n_frames - 1) * hop + frame
    if x.shape[-1] < need:
        x = pad(x, (0, need - x.shape[-1]))
    frames = x.unfold(-1, frame, hop)[:, :n_frames]
    fx = pad((frames * window).reshape(-1, frame), (0, fft_n - frame))
    spec, tables = plan.get_plan(fft_n, 'real', torch.complex64, 'cpu')
    z = core.rfft_batched(fx, spec, tables, fft_n)
    if mode == 'complex':
        return z
    out = z.real * z.real + z.imag * z.imag
    return out if mode == 'power' else torch.log(out + eps)


# (batch, valid, row stride, offset, start, frames, hop, frame): the
# spectrogram's framing; Griffin-Lim's centre (start -frame/2) on its cropped
# view; frames that run past the signal's end; a frame shorter than fft_n;
# an odd hop and start on a misaligned view
STFT_CASES = {
    'spectrogram': (3, 8192, None, 0, 0, 29, 256, 1024),
    'centre_view': (2, 4000, 4512, 256, -512, 16, 256, 1024),
    'past_the_end': (2, 3000, None, 0, 0, 11, 256, 1024),
    'short_frame': (2, 5000, None, 0, 0, 17, 256, 1000),
    'odd_hop_start': (3, 3001, 3010, 1, -3, 20, 125, 1000),
}


def _stft_case(name, seed=0):
    batch, valid, stride, offset, start, n_frames, hop, frame = STFT_CASES[name]
    x = _signal(batch, valid, seed + valid, stride, offset)
    window = torch.from_numpy(np.hanning(frame).astype(np.float32))
    return x, start, n_frames, hop, window


@pytest.mark.parametrize('mode', ['complex', 'power', 'log'])
@pytest.mark.parametrize('case', list(STFT_CASES))
def test_stft_plain_is_the_composition_before_k12s(case, mode):
    """K12s's plain version gives what the STFT's passes gave before K12s,
    bit for bit, in every mode, on a negative start, frames past the
    signal's end, a frame shorter than fft_n, an odd hop and start and a
    strided view; the wrapper runs it for a CPU tensor."""
    x, start, n_frames, hop, window = _stft_case(case)
    fft_n = 1024
    _, w, wu = _real_plan(fft_n, torch.complex64)
    got = base_fft.stft_base_plain(x, start, n_frames, hop, window, w, wu, mode, 1e-10)
    assert got.shape == (x.shape[0] * n_frames, fft_n // 2 + 1)
    assert got.dtype == (torch.complex64 if mode == 'complex' else torch.float32)
    want = _stft_before(x, start, n_frames, hop, window, fft_n, mode, 1e-10)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        base_fft.stft_base(x, start, n_frames, hop, window, w, wu, mode, 1e-10).numpy(),
        got.numpy())


def _np_stft64(x, start, n_frames, hop, window, fft_n):
    """The STFT in float64 by np.fft: frame i of a row from sample start +
    i*hop, zeros outside the row."""
    x = x.numpy().astype(np.float64)
    frame = window.shape[0]
    idx = start + hop * np.arange(n_frames)[:, None] + np.arange(frame)[None, :]
    inside = (idx >= 0) & (idx < x.shape[-1])
    frames = np.where(inside, x[:, np.clip(idx, 0, x.shape[-1] - 1)], 0.0)
    spec = np.fft.rfft(frames * window.numpy().astype(np.float64), fft_n, axis=-1)
    return spec.reshape(-1, fft_n // 2 + 1)


@pytest.mark.parametrize('case', list(STFT_CASES))
def test_stft_plain_against_numpy_in_float64(case):
    """K12s's plain version in float32 against np.fft in float64: the
    spectrum within 2e-6 of its largest value, the log power within 1e-3
    where the power is above 1e-6 of its largest."""
    x, start, n_frames, hop, window = _stft_case(case, seed=1)
    _, w, wu = _real_plan(1024, torch.complex64)
    want = _np_stft64(x, start, n_frames, hop, window, 1024)
    got = base_fft.stft_base_plain(x, start, n_frames, hop, window, w, wu).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6
    power = np.abs(want) ** 2
    log = base_fft.stft_base_plain(x, start, n_frames, hop, window, w, wu, 'log', 1e-10).numpy()
    loud = power > 1e-6 * power.max()
    assert np.abs(log - np.log(power + 1e-10))[loud].max() < 1e-3


@pytest.mark.parametrize('dtype,frame,takes', [
    (torch.float32, 1024, True),       # the spectrogram and Griffin-Lim cells
    (torch.float32, 1000, True),       # padded to 1024
    (torch.float32, 512, True),
    (torch.float32, 8192, True),
    (torch.float32, 256, False),       # a half of 128 points: Stockham
    (torch.float32, 250, False),
    (torch.float32, 8193, False),      # fft_n 16384: the four-step
    (torch.float64, 1024, False),
    (torch.float16, 1024, False),
])
def test_which_stfts_ride_k12s(dtype, frame, takes):
    """An STFT takes K12s where its frames' batched rfft rides K12r
    (config.batched_engine 'r2c' says 'base': float32 frames whose fft_n is
    512..8192); every other keeps the plain passes."""
    fft_n = plan.next_pow2(frame)
    engine = config.batched_engine('r2c', dtype, 64 * 858, fft_n)
    assert (engine == 'base') == takes


@pytest.mark.parametrize('kw,match', [
    ({}, 'CUDA'),
    ({'mode': 'abs'}, 'unknown mode'),
    ({'hop': 0}, 'hop'),
    ({'frame': 1025}, 'frame 1025'),
    ({'fft_n': 16384}, 'one more than a power of two'),
    ({'fft_n': 256}, 'one more than a power of two'),
])
def test_stft_wrapper_refuses_what_the_kernel_does_not_take(kw, match):
    """Off the CPU the wrapper launches K12s or raises: a tensor on the meta
    device, an unknown mode, a hop of 0, a frame longer than the transform
    or a transform the kernel does not take is refused before any build."""
    fft_n = kw.get('fft_n', 1024)
    _, w, wu = _real_plan(fft_n, torch.complex64)
    x = torch.empty((2, 4096), dtype=torch.float32, device='meta')
    window = torch.ones(kw.get('frame', 1024))
    with pytest.raises(RuntimeError, match=match):
        base_fft.stft_base(x, 0, 13, kw.get('hop', 256), window, w, wu, kw.get('mode', 'log'))
