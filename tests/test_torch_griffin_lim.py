"""dsc_tpu_torch.models.GriffinLim held to the plain float64 reference of the benchmark's
Griffin-Lim configuration (portbench/reference/griffinlim.py: torch.stft / torch.istft with
center=True and zero padding) on the CPU, at 2 clips of 16,384 samples with frame 256 and
hop 64, 1-D and batched; the STFT and ISTFT it is built from unchanged; its spans.

Tolerances, relative to the reference's largest sample: one inverse STFT in float32 is
round-off, 1.8e-7 here; fast Griffin-Lim carries each iteration's round-off into the next
phase estimate, so the gap grows with the iterations (4.2e-7 after 1; 9.3e-5 after 32 plain
and 3.1e-4 with momentum 0.99). The bounds are 2e-6 up to one iteration and 2e-3 at 32, the
mean 1e-4; the bfloat16 control reads 4.1e-3 and more at the largest, 4.3e-4 and more on
the mean, four times each bound and more (test_bfloat16_control_fails).
"""

import importlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import scipy.signal
import torch

import dsc_tpu_torch as dt
import dsc_tpu_torch.models as tm
from dsc_tpu_torch import tracing
from dsc_tpu_torch.fourier import core as fft_core
from dsc_tpu_torch.fourier import plan as fft_plan

# the package's name ``stft`` is scipy's function (stft_scipy.py)
stft_mod = importlib.import_module('dsc_tpu_torch.models.stft')
ROOT = Path(__file__).resolve().parents[1]
FRAME, HOP, N = 256, 64, 16384
BOUND = {0: 2e-6, 1: 2e-6, 32: 2e-3}
MEAN_BOUND = 1e-4


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        'griffinlim_reference', ROOT / 'portbench' / 'reference' / 'griffinlim.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


def _config(n_iter=32, momentum=0.99):
    return {'n_fft': FRAME, 'hop': HOP, 'win_length': FRAME, 'n_iter': n_iter,
            'momentum': momentum, 'eps': 1e-16}


def _window():
    return scipy.signal.get_window('hann', FRAME)


def _clips(n=N, seed=0):
    """Two clips of noise and tones, the second holding signal for half its length."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    x = 0.3 * rng.standard_normal((2, n))
    for hz in (440.0, 1234.5, 3000.0):
        x += rng.uniform(0.2, 1) * np.sin(2 * np.pi * hz * t + rng.uniform(0, 2 * np.pi))
    x[1, n // 2:] = 0
    return torch.from_numpy(x)


def _inputs(n=N, seed=0):
    """The raw input of the reference: float32 magnitudes of the clips (float64 STFT) and
    complex64 unit phasors of a random phase."""
    x = _clips(n, seed)
    w = torch.from_numpy(_window())
    z = torch.stft(x, FRAME, HOP, FRAME, w, center=True, pad_mode='constant',
                   return_complex=True)
    mags = z.abs().to(torch.float32).transpose(-1, -2).contiguous()
    gen = torch.Generator().manual_seed(seed + 1)
    phase = 2 * math.pi * torch.rand(mags.shape, generator=gen, dtype=torch.float64)
    angles = torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
    return {'magnitudes': mags, 'angles': angles, 'length': n}


def _port(raw, batched, length=None, **kw):
    gl = tm.GriffinLim(FRAME, HOP, _window(), **kw)
    if batched:
        return gl(dt.Tensor(raw['magnitudes']), length=length,
                  angles=dt.Tensor(raw['angles'])).torch
    return torch.stack([gl(dt.Tensor(raw['magnitudes'][i]), length=length,
                           angles=dt.Tensor(raw['angles'][i])).torch for i in range(2)])


def _gaps(got, want):
    err = (got.double() - want).abs()
    scale = float(want.abs().max())
    return float(err.max()) / scale, float(err.mean()) / scale


@pytest.mark.parametrize('batched', [True, False], ids=['batched', '1d'])
@pytest.mark.parametrize('momentum', [0.0, 0.99])
@pytest.mark.parametrize('n_iter', [0, 1, 32])
def test_matches_reference(n_iter, momentum, batched):
    raw = _inputs()
    got = _port(raw, batched, length=N, n_iter=n_iter, momentum=momentum)
    want = REF.run(_config(n_iter, momentum), raw)
    assert got.dtype == torch.float32 and got.shape == (2, N)
    worst, mean = _gaps(got, want)
    assert worst < BOUND[n_iter], worst
    assert mean < MEAN_BOUND, mean


@pytest.mark.parametrize('n_iter', [1, 32])
def test_bfloat16_control_fails(n_iter):
    """The tolerances tell float32 from bfloat16: the control exceeds both."""
    raw = _inputs()
    want = REF.run(_config(n_iter), raw)
    worst, mean = _gaps(REF.control(_config(n_iter), raw), want)
    assert worst > 5 * BOUND[n_iter] and mean > 5 * MEAN_BOUND, (worst, mean)


@pytest.mark.parametrize('length', [None, 16010, 16063])
def test_length_shorter_than_the_span(length):
    """A clip of 16,010 samples: 251 frames, whose span less the centre padding holds
    16,128 samples; by default the answer keeps (frames - 1) * hop = 16,000 of them, and
    any length of 16,000 to 16,063 samples frames into the same 251."""
    raw = _inputs(16010)
    got = _port(raw, True, length=length, n_iter=8)
    want = REF.run(_config(8), {**raw, 'length': 16000 if length is None else length})
    assert got.shape == want.shape
    worst, mean = _gaps(got, want)
    assert worst < BOUND[32] and mean < MEAN_BOUND, (worst, mean)


@pytest.mark.parametrize('length', [15999, 16064])
def test_length_that_fits_no_frames_is_refused(length):
    raw = _inputs(16010)
    with pytest.raises(RuntimeError, match='does not fit'):
        _port(raw, True, length=length, n_iter=1)


@pytest.mark.parametrize('given', [True, False], ids=['angles', 'random'])
@pytest.mark.parametrize('momentum', [0.0, 0.99])
def test_zero_magnitudes_give_zeros(momentum, given):
    raw = _inputs()
    gl = tm.GriffinLim(FRAME, HOP, _window(), n_iter=4, momentum=momentum)
    S = dt.Tensor(torch.zeros_like(raw['magnitudes']))
    out = gl(S, length=N, angles=dt.Tensor(raw['angles']) if given else None).torch
    assert not torch.isnan(out).any()
    assert torch.count_nonzero(out) == 0


def test_given_angles_are_used():
    raw = _inputs()
    gl = tm.GriffinLim(FRAME, HOP, _window(), n_iter=2)
    S = dt.Tensor(raw['magnitudes'])
    a = gl(S, length=N, angles=dt.Tensor(raw['angles'])).torch
    again = gl(S, length=N, angles=dt.Tensor(raw['angles'])).torch
    other = gl(S, length=N, angles=dt.Tensor(raw['angles'].conj().contiguous())).torch
    assert torch.equal(a, again)
    assert float((a - other).abs().max()) > 1e-2 * float(a.abs().max())
    # no angles: a phase drawn from torch's generator on the magnitudes' device
    torch.manual_seed(5)
    r1 = gl(S, length=N).torch
    torch.manual_seed(5)
    r2 = gl(S, length=N).torch
    assert torch.equal(r1, r2)
    assert float((r1 - a).abs().max()) > 1e-2 * float(a.abs().max())


@pytest.mark.parametrize('momentum', [0.0, 0.99])
def test_without_centre_padding_is_the_stft_istft_loop(momentum):
    """center=False: the loop written with the public STFT(mode='complex') and ISTFT on the
    unpadded signal, a Hamming window, a frame of 250 points padded to 256."""
    frame, hop, n_frames = 250, 60, 200
    gen = torch.Generator().manual_seed(7)
    S = torch.rand(2, n_frames, 129, generator=gen)
    angles = torch.polar(torch.ones_like(S), 2 * math.pi * torch.rand(S.shape, generator=gen))
    angles[..., 0] = angles[..., -1] = 1  # bins the inverse reads as real
    length = (n_frames - 1) * hop + frame
    got = tm.GriffinLim(frame, hop, 'hamming', n_iter=3, momentum=momentum, center=False)(
        dt.Tensor(S), angles=dt.Tensor(angles)).torch
    st = tm.STFT(frame, hop, 'hamming', mode='complex')
    ist = tm.ISTFT(frame, hop, 'hamming')
    z, prev, c = S * angles, None, momentum / (1 + momentum)
    for _ in range(3):
        rebuilt = st(ist(dt.Tensor(z), length=length)).torch
        a = rebuilt if prev is None else rebuilt - c * prev
        z, prev = S * (a / (a.abs() + 1e-16)), rebuilt
    want = ist(dt.Tensor(z), length=length).torch
    assert got.shape == (2, length)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())


@pytest.mark.parametrize('frame,hop,window', [(256, 64, 'hann'), (250, 60, 'hamming'),
                                              (256, 128, 'periodic')])
def test_stft_istft_unchanged(frame, hop, window):
    """STFT(mode='complex') and ISTFT compute what the framing, the window and the batched
    transforms give, bit for bit, and agree with float64 NumPy."""
    win = scipy.signal.get_window('hann', frame) if window == 'periodic' else window
    x = _clips(4096)[:, :4000].to(torch.float32)
    z = tm.STFT(frame, hop, win, mode='complex')(dt.Tensor(x)).torch
    w = torch.from_numpy(stft_mod._make_window(win, frame))
    fft_n = fft_plan.next_pow2(frame)
    spec, tables = fft_plan.get_plan(fft_n, 'real', torch.complex64)
    n_frames = 1 + (4000 - frame) // hop
    fx = torch.nn.functional.pad(
        (x.unfold(-1, frame, hop) * w).reshape(-1, frame), (0, fft_n - frame))
    assert torch.equal(z, fft_core.rfft_batched(fx, spec, tables, fft_n).reshape(2, n_frames, -1))
    frames = np.lib.stride_tricks.sliding_window_view(x.double().numpy(), frame, -1)[:, ::hop]
    ref = np.fft.rfft(frames * w.double().numpy(), n=fft_n)
    assert np.abs(z.numpy() - ref).max() < 1e-5 * np.abs(ref).max()
    span = (n_frames - 1) * hop + frame
    y = tm.ISTFT(frame, hop, win)(dt.Tensor(z), length=span).torch
    inv_wsq = tm.ISTFT(frame, hop, win)._inv_wsq(n_frames, span, z)
    want = stft_mod._istft_program(z, w, inv_wsq, tables, frame, hop, n_frames, spec, fft_n,
                                   span)
    assert torch.equal(y, want)
    inner = slice(frame, (n_frames - 1) * hop)
    assert float((y[:, inner] - x[:, inner]).abs().max()) < 1e-5


def test_window_array_is_accepted():
    """A window given as a numpy array (scipy.signal.get_window's periodic Hann) is used as
    given."""
    win = scipy.signal.get_window('hann', FRAME)
    x = dt.Tensor(_clips(2048)[0].to(torch.float32))
    got = tm.STFT(FRAME, HOP, win, mode='power')(x).torch
    want = tm.STFT(FRAME, HOP, dt.Tensor(torch.from_numpy(win.astype(np.float32))),
                   mode='power')(x).torch
    assert torch.equal(got, want)


def test_spans_count_the_iterations():
    """One default call: one api span, and one project span and one forward transform an
    iteration, one inverse an iteration and one more. On the CPU the transforms run their
    plain versions, under the untangle and entangle spans; on the card K12r and K12 under
    their wrapper spans (test_spans_on_the_card)."""
    raw = _inputs()
    gl = tm.GriffinLim(FRAME, HOP, _window())
    tracing.set_recording(True)
    tracing.clear_traces()
    try:
        gl(dt.Tensor(raw['magnitudes']), length=N, angles=dt.Tensor(raw['angles']))
        counts = {k: v['count'] for k, v in tracing.totals().items()}
    finally:
        tracing.set_recording(False)
        tracing.clear_traces()
    assert counts[('api', 'griffin_lim')] == 1
    assert counts[('plain', 'init')] == 1
    assert counts[('plain', 'project')] == 32
    assert counts[('plain', 'momentum')] == 31
    assert counts[('plain', 'center')] == 32 + 33
    assert counts[('plain', 'untangle')] == 32
    assert counts[('plain', 'entangle')] == 33


@pytest.mark.parametrize('bad,match', [
    ({'S': torch.zeros(10, 100)}, 'bins'),
    ({'S': torch.zeros(10)}, '2-D or 3-D'),
    ({'angles': torch.ones(2, 10, 129, dtype=torch.complex64)}, 'angles have shape'),
])
def test_bad_arguments_are_refused(bad, match):
    S = bad.get('S', torch.zeros(2, 257, 129))
    angles = bad.get('angles')
    gl = tm.GriffinLim(FRAME, HOP, _window(), n_iter=1)
    with pytest.raises(RuntimeError, match=match):
        gl(dt.Tensor(S), angles=None if angles is None else dt.Tensor(angles))


@pytest.mark.parametrize('kw', [{'n_iter': -1}, {'momentum': -0.5}, {'eps': 0.0}])
def test_bad_settings_are_refused(kw):
    with pytest.raises(RuntimeError):
        tm.GriffinLim(FRAME, HOP, **kw)


@pytest.mark.gpu
def test_spans_on_the_card():
    """On the card one default call at the benchmark's STFT (frame 1024, hop 256) launches
    K12s once an iteration and K12ir once an inverse: 32 base_stft and 33 base_irfft, with
    no plain entangle, untangle or window, and the centre span only on the inverses'
    crops."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from dsc_tpu_torch.kernels import build

    dt.shutdown()
    dt.init(2**32, device='cuda')
    try:
        gen = torch.Generator(device='cuda').manual_seed(3)
        S = torch.rand(4, 100, 513, generator=gen, device='cuda')
        gl = tm.GriffinLim(1024, 256, scipy.signal.get_window('hann', 1024))
        gl(dt.Tensor(S))
        torch.cuda.synchronize()
        build.reset_launches()
        tracing.set_recording(True)
        tracing.clear_traces()
        try:
            gl(dt.Tensor(S))
            torch.cuda.synchronize()
            counts = {k: v['count'] for k, v in tracing.totals().items()}
        finally:
            tracing.set_recording(False)
            tracing.clear_traces()
        assert counts[('api', 'griffin_lim')] == 1
        assert counts[('plain', 'project')] == 32
        assert counts[('wrapper', 'base_stft')] == 32
        assert counts[('wrapper', 'base_irfft')] == 33
        assert counts[('plain', 'center')] == 33
        assert ('plain', 'entangle') not in counts
        assert ('plain', 'untangle') not in counts
        assert ('plain', 'window') not in counts
        assert {k: v for k, v in build.launches.items() if v} == {'base_stft': 32,
                                                                   'base_irfft': 33}
    finally:
        dt.shutdown()
        dt.init(2**32, device='cpu')
