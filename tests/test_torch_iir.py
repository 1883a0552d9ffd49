"""The IIR tier of dsc_tpu_torch (models/iir.py) against dsc_tpu.models and
scipy.signal in float64 on the same inputs, on the CPU.

- ``_linrec_plan``: the port's ladder equals the JAX package's level by
  level, exactly, as float32;
- ``lfilter`` and ``sosfilt`` on each route of the recurrence: the flat
  scan (n = 2048), the Toeplitz ladder with no tail (n = 4096) and with the
  middle level and the tail state (n = 2^18 + 3), with and without ``zi``,
  1-D and batched, 'parallel' and 'sequential' (the exact step has no
  size-dependent branch and takes ~13 s at 2^18 + 3 here, so it runs at
  2048 and 4096); a ladder of two middle levels with the chunk length cut to
  16 on both sides;
- ``sosfiltfilt`` and ``filtfilt`` over the four padtypes, with ``padlen``
  given and left to its default, on the flat and the Toeplitz route;
- ``decimate`` with ``ftype`` 'iir' and 'fir', ``zero_phase`` on and off;
- the design and conversion functions against the JAX package (equal:
  the same float64 host code) and scipy; the error texts against the JAX
  package's;
- the precision guard: full float32 inside a call whatever the caller's
  TF32 setting, and the setting as it was after it;
- the constant cache (FIFO of 32, keyed on the device) and the capture
  rules: a cached entry serves a capture, a missing one raises, a host
  ``zi`` raises and a Tensor ``zi`` serves; sosfilt -> welch under
  dsc.compile against the JAX package's compiled pipeline.

Port against dsc_tpu: within 1e-5 of the largest value (PORT_BOUND), or the
JAX test's bound where that is looser; against scipy: the JAX package's
bounds (tests/test_iir.py).
"""

import gc

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu.models.iir as jiir  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402
from dsc_tpu_torch import tracing  # noqa: E402
from dsc_tpu_torch.models import iir as tiir  # noqa: E402

PORT_BOUND = 1e-5  # against dsc_tpu, relative to the largest value
SOS = jm.butter(4, 0.25)  # the sosfilt rows of benchmarks/results_models.json
BA = jm.butter(4, 0.25, output='ba')  # the same filter, order 4 in one section
N_ROUTES = {'flat scan': 2048, 'Toeplitz': 4096, 'middle level + tail': 2**18 + 3}


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _sig(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(v):
    return v.numpy() if hasattr(v, 'numpy') else np.asarray(v)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------- the ladder

@pytest.mark.parametrize('system,n,levels', [
    ('sos', 4096, 2), ('sos', 2**18 + 3, 3), ('ba', 2**17 + 1, 3), ('sos', 2**26, 4)])
def test_linrec_plan_equals_jax_level_by_level(system, n, levels):
    if system == 'sos':
        A, c = tiir._tdf2_matrices(SOS[0, :3], SOS[0, 3:])
    else:
        bb, aa, _ = tiir._norm_ba(*BA, 'lfilter')
        A, c = tiir._tdf2_matrices(bb, aa)
    got = tiir._linrec_plan(A, c, n, 'cpu')
    ref = jiir._linrec_plan(A, c, n)
    assert len(got) == len(ref) == levels
    for lg, lr in zip(got, ref):
        assert len(lg) == len(lr)
        for g, r in zip(lg, lr):
            assert g.dtype == torch.float32 and g.device.type == 'cpu'
            assert np.array_equal(g.numpy(), np.asarray(r))


def test_plan_cache_is_a_fifo_of_32_keyed_on_the_device(monkeypatch):
    monkeypatch.setattr(tiir, '_PLAN_CACHE', {})
    A, c = tiir._tdf2_matrices(SOS[0, :3], SOS[0, 3:])
    first = tiir._linrec_plan_cached(A, c, 4096, torch.device('cpu'))
    assert tiir._linrec_plan_cached(A, c, 4096, torch.device('cpu')) is first
    key = next(iter(tiir._PLAN_CACHE))
    assert key[-1] == 'cpu' and key[2] == 4096
    for n in range(4097, 4097 + 32):
        tiir._linrec_plan_cached(A, c, n, torch.device('cpu'))
    assert len(tiir._PLAN_CACHE) == 32 and key not in tiir._PLAN_CACHE


# ------------------------------------------------------ lfilter / sosfilt

def _route_calls(monkeypatch):
    """Counts of the solver's routes during a call: the Toeplitz section
    solve, the middle levels and the tail state."""
    calls = {'toeplitz': 0, 'middle': 0, 'tail': 0, 'scan': 0}
    scalar, vec, scan = tiir._linrec_scalar, tiir._linrec_apply_vec, tiir._scan

    def spy_scalar(x, plan, b0, zi):
        calls['toeplitz'] += 1
        calls['tail'] += int(x.shape[1] % tiir._LINREC_M != 0)
        return scalar(x, plan, b0, zi)

    def spy_vec(f, levels, u0):
        calls['middle'] += int(len(levels) > 1)
        return vec(f, levels, u0)

    def spy_scan(A, f):
        calls['scan'] += 1
        return scan(A, f)

    monkeypatch.setattr(tiir, '_linrec_scalar', spy_scalar)
    monkeypatch.setattr(tiir, '_linrec_apply_vec', spy_vec)
    monkeypatch.setattr(tiir, '_scan', spy_scan)
    return calls


ROUTE_CALLS = {'flat scan': {'toeplitz': 0, 'middle': 0, 'tail': 0, 'scan': 1},
               'Toeplitz': {'toeplitz': 1, 'middle': 0, 'tail': 0, 'scan': 1},
               'middle level + tail': {'toeplitz': 1, 'middle': 1, 'tail': 1, 'scan': 1}}


@pytest.mark.parametrize('with_zi', [False, True], ids=['no zi', 'zi'])
@pytest.mark.parametrize('batch', [None, 3], ids=['1-D', 'batched'])
@pytest.mark.parametrize('route', list(N_ROUTES))
def test_sosfilt_routes_match_jax_and_scipy(route, batch, with_zi, monkeypatch):
    n = N_ROUTES[route]
    x = _sig(n if batch is None else (batch, n), n)
    zi = (np.random.default_rng(1).standard_normal((2, 2) if batch is None else (batch, 2, 2))
          if with_zi else None)
    calls = _route_calls(monkeypatch)
    got = tm.sosfilt(SOS, dt.from_numpy(x), zi=zi)
    ref = jm.sosfilt(SOS, dsc_tpu.from_numpy(x), zi=zi)
    want = {k: v * 2 for k, v in ROUTE_CALLS[route].items()}  # two sections
    assert calls == want
    x64 = x.astype(np.float64)
    if with_zi:
        (y, zf), (jy, jzf) = tuple(map(_np, got)), tuple(map(_np, ref))
        z64 = zi if batch is None else np.moveaxis(zi, 1, 0)
        ry, rzf = sps.sosfilt(SOS, x64, zi=z64, axis=-1)
        rzf = rzf if batch is None else np.moveaxis(rzf, 0, 1)
        assert y.dtype == zf.dtype == np.float32
        assert _rel(zf, jzf) < PORT_BOUND
        assert np.abs(zf - rzf).max() < 1e-3 * max(np.abs(rzf).max(), 1.0)
    else:
        y, jy = _np(got), _np(ref)
        ry = sps.sosfilt(SOS, x64, axis=-1)
    assert y.dtype == np.float32
    assert _rel(y, jy) < PORT_BOUND
    assert _rel(y, ry) < 1e-4


@pytest.mark.parametrize('case', [('flat scan', None, True), ('Toeplitz', 2, False),
                                  ('Toeplitz', None, True),
                                  ('middle level + tail', None, True),
                                  ('middle level + tail', 2, False)],
                         ids=lambda c: f'{c[0]}-{"batched" if c[1] else "1-D"}-'
                                       f'{"zi" if c[2] else "no zi"}')
def test_lfilter_routes_match_jax_and_scipy(case, monkeypatch):
    route, batch, with_zi = case
    n = N_ROUTES[route]
    b, a = BA
    x = _sig(n if batch is None else (batch, n), n + 1)
    zi = np.random.default_rng(2).standard_normal(4) if with_zi else None
    calls = _route_calls(monkeypatch)
    got = tm.lfilter(b, a, dt.from_numpy(x), zi=zi)
    ref = jm.lfilter(b, a, dsc_tpu.from_numpy(x), zi=zi)
    assert calls == ROUTE_CALLS[route]
    x64 = x.astype(np.float64)
    if with_zi:
        (y, zf), (jy, jzf) = tuple(map(_np, got)), tuple(map(_np, ref))
        ry, rzf = sps.lfilter(b, a, x64, zi=zi)
        assert zf.shape == (4,) and _rel(zf, jzf) < PORT_BOUND
        assert np.abs(zf - rzf).max() < 1e-3 * max(np.abs(rzf).max(), 1.0)
    else:
        y, jy = _np(got), _np(ref)
        ry = sps.lfilter(b, a, x64, axis=-1)
    assert _rel(y, jy) < PORT_BOUND
    assert _rel(y, ry) < 1e-4


@pytest.mark.parametrize('fn', ['sosfilt', 'lfilter'])
@pytest.mark.parametrize('n,batch', [(2048, None), (4096, 2)])
def test_sequential_matches_jax_and_parallel(fn, n, batch):
    x = _sig(n if batch is None else (batch, n), 3 * n)
    args = (SOS,) if fn == 'sosfilt' else BA
    zi = np.full((2, 2) if fn == 'sosfilt' else 4, 0.5)
    port, jax_fn = getattr(tm, fn), getattr(jm, fn)
    y, zf = port(*args, dt.from_numpy(x), zi=zi, method='sequential')
    jy, jzf = jax_fn(*args, dsc_tpu.from_numpy(x), zi=zi, method='sequential')
    py, pzf = port(*args, dt.from_numpy(x), zi=zi)
    assert _rel(y, jy.numpy()) < PORT_BOUND and _rel(zf, jzf.numpy()) < PORT_BOUND
    # tests/test_iir.py::test_sosfilt_parallel_equals_sequential
    assert _rel(y, py) < 1e-4 and _rel(zf, pzf) < 1e-4


def test_two_middle_levels_match_jax_and_scipy(monkeypatch):
    """The ladder with chunks of 16 and a base of 4 chunks on both sides:
    4101 samples take two middle levels (257 and 17 chunks) and a tail."""
    for mod in (tiir, jiir):
        monkeypatch.setattr(mod, '_LINREC_M', 16)
        monkeypatch.setattr(mod, '_LINREC_BASE', 4)
        monkeypatch.setattr(mod, '_PLAN_CACHE', {})
    x = _sig((2, 4101), 5)
    zi = np.random.default_rng(3).standard_normal((2, 2))
    A, c = tiir._tdf2_matrices(SOS[0, :3], SOS[0, 3:])
    assert len(tiir._linrec_plan(A, c, 4101, 'cpu')) == 4
    y, zf = tm.sosfilt(SOS, dt.from_numpy(x), zi=zi)
    jy, jzf = jm.sosfilt(SOS, dsc_tpu.from_numpy(x), zi=zi)
    ry, rzf = sps.sosfilt(SOS, x.astype(np.float64), zi=np.broadcast_to(zi[:, None], (2, 2, 2)),
                          axis=-1)
    assert _rel(y, jy.numpy()) < PORT_BOUND and _rel(zf, jzf.numpy()) < PORT_BOUND
    assert _rel(y, ry) < 1e-4 and _rel(zf, np.moveaxis(rzf, 0, 1)) < 1e-4


def test_float64_input_gives_float32_and_streaming_state():
    # tests/test_iir.py::test_sosfilt_streaming_state, with zf handed back as a Tensor
    x = _sig(6000, 6).astype(np.float64)
    whole = tm.sosfilt(SOS, dt.from_numpy(x))
    assert whole.dtype == dt.Dtype.F32
    y1, zf = tm.sosfilt(SOS, dt.from_numpy(x[:4500]), zi=np.zeros((2, 2)))
    y2, _ = tm.sosfilt(SOS, dt.from_numpy(x[4500:]), zi=zf)
    cat = np.concatenate([y1.numpy(), y2.numpy()])
    assert np.abs(cat - whole.numpy()).max() < 1e-5


# ---------------------------------------------------- sosfiltfilt / filtfilt

TREND = (np.cumsum(np.random.default_rng(0).standard_normal(256)) * 0.3).astype(np.float32)


@pytest.mark.parametrize('padlen', [None, 40], ids=['default padlen', 'padlen 40'])
@pytest.mark.parametrize('padtype', ['odd', 'even', 'constant', None])
def test_sosfiltfilt_padtypes_match_jax_and_scipy(padtype, padlen):
    sos = jm.butter(4, 0.1)
    got = tm.sosfiltfilt(sos, dt.from_numpy(TREND), padtype=padtype, padlen=padlen).numpy()
    ref = jm.sosfiltfilt(sos, dsc_tpu.from_numpy(TREND), padtype=padtype, padlen=padlen).numpy()
    sp = sps.sosfiltfilt(sos, TREND.astype(np.float64), padtype=padtype, padlen=padlen)
    assert _rel(got, ref) < PORT_BOUND
    # tests/test_iir.py::test_filtfilt_padtypes_match_scipy
    assert np.abs(got - sp).max() < 2e-5 * max(np.abs(sp).max(), 1.0)


@pytest.mark.parametrize('padlen', [None, 100])
def test_sosfiltfilt_toeplitz_batched_matches_jax_and_scipy(padlen):
    # 4096 + 2 * 15 = 4126 extended samples: the ladder with a tail
    x = _sig((2, 4096), 11)
    got = tm.sosfiltfilt(SOS, dt.from_numpy(x), padlen=padlen).numpy()
    ref = jm.sosfiltfilt(SOS, dsc_tpu.from_numpy(x), padlen=padlen).numpy()
    sp = sps.sosfiltfilt(SOS, x.astype(np.float64), padlen=padlen, axis=-1)
    assert _rel(got, ref) < PORT_BOUND
    assert _rel(got, sp) < 2e-4  # tests/test_iir.py::test_sosfiltfilt_matches_scipy


@pytest.mark.parametrize('padtype', ['odd', 'even', 'constant', None])
def test_filtfilt_matches_jax_and_scipy(padtype):
    b, a = jm.butter(4, 0.1, output='ba')
    got = tm.filtfilt(b, a, dt.from_numpy(TREND), padtype=padtype).numpy()
    ref = jm.filtfilt(b, a, dsc_tpu.from_numpy(TREND), padtype=padtype).numpy()
    sp = sps.filtfilt(b, a, TREND.astype(np.float64), padtype=padtype)
    assert _rel(got, ref) < PORT_BOUND
    assert np.abs(got - sp).max() < 2e-5 * max(np.abs(sp).max(), 1.0)


def test_sosfiltfilt_edge_padlen_is_the_signal_less_one():
    # padlen = n - 1: the extensions reach the far end of the signal
    x = _sig(64, 12)
    got = tm.sosfiltfilt(SOS, dt.from_numpy(x), padlen=63).numpy()
    ref = jm.sosfiltfilt(SOS, dsc_tpu.from_numpy(x), padlen=63).numpy()
    assert _rel(got, ref) < PORT_BOUND
    assert _rel(got, sps.sosfiltfilt(SOS, x.astype(np.float64), padlen=63)) < 2e-4


# ---------------------------------------------------------------- decimate

X_DEC = _sig(1000, 0)


@pytest.mark.parametrize('zero_phase', [True, False])
@pytest.mark.parametrize('ftype', ['iir', 'fir'])
def test_decimate_matches_jax_and_scipy(ftype, zero_phase):
    got = tm.decimate(dt.from_numpy(X_DEC), 4, ftype=ftype, zero_phase=zero_phase).numpy()
    ref = jm.decimate(dsc_tpu.from_numpy(X_DEC), 4, ftype=ftype,
                      zero_phase=zero_phase).numpy()
    sp = sps.decimate(X_DEC.astype(np.float64), 4, ftype=ftype, zero_phase=zero_phase)
    assert got.shape == ref.shape == sp.shape
    assert _rel(got, ref) < PORT_BOUND
    # tests/test_iir.py: 1e-3 (iir), 2e-6 (fir) of the largest value
    assert _rel(got, sp) < (1e-3 if ftype == 'iir' else 2e-6)


def test_decimate_batched_and_identity():
    x = np.stack([X_DEC, _sig(1000, 1)])
    got = tm.decimate(dt.from_numpy(x), 3).numpy()
    sp = sps.decimate(x.astype(np.float64), 3, axis=-1)
    assert got.shape == sp.shape and _rel(got, sp) < 1e-3
    t = dt.from_numpy(X_DEC)
    assert tm.decimate(t, 1) is t


# ------------------------------------------------ design and conversions

@pytest.mark.parametrize('design', [
    ('butter', (4, 0.25), {}), ('butter', (5, [0.2, 0.5], 'bandpass'), {}),
    ('butter', (3, 100.0, 'high'), {'fs': 1000.0}), ('butter', (2, [0.1, 0.4], 'stop'), {}),
    ('cheby1', (8, 0.05, 0.2), {}), ('cheby1', (5, 1.0, [0.2, 0.6], 'bandpass'), {}),
    ('cheby2', (6, 40.0, 0.3), {}), ('cheby2', (5, 30.0, 0.3, 'high'), {}),
    ('cheby2', (4, 40.0, [0.2, 0.5], 'bandstop'), {})], ids=lambda d: f'{d[0]}{d[1]}')
@pytest.mark.parametrize('output', ['sos', 'ba', 'zpk'])
def test_design_equals_jax_and_realizes_scipy(design, output):
    name, args, kw = design
    got = getattr(tm, name)(*args, output=output, **kw)
    ref = getattr(jm, name)(*args, output=output, **kw)
    for g, r in zip(got if output != 'sos' else [got], ref if output != 'sos' else [ref]):
        assert np.array_equal(np.asarray(g), np.asarray(r))
    sp = getattr(sps, name)(*args, output='ba', **kw)
    b, a = tm.sos2tf(got) if output == 'sos' else (
        got if output == 'ba' else tm.zpk2tf(*got))
    w = np.linspace(0.01, np.pi - 0.01, 64)
    h = sps.freqz(b, a, worN=w)[1]
    h_sp = sps.freqz(*sp, worN=w)[1]
    assert np.abs(h - h_sp).max() < 1e-8 * max(1.0, np.abs(h_sp).max())


def test_host_helpers_equal_jax_and_match_scipy():
    b, a = BA
    for fn, args in (('sosfreqz', (SOS,)), ('freqz', (b, a)), ('group_delay', ((b, a),))):
        gw, gh = getattr(tm, fn)(*args, worN=128)
        jw, jh = getattr(jm, fn)(*args, worN=128)
        assert np.array_equal(gw, jw) and np.array_equal(gh, jh)
    w, h = tm.sosfreqz(SOS, worN=128)
    assert np.abs(h - sps.sosfreqz(SOS, worN=w)[1]).max() < 1e-12
    w, gd = tm.group_delay((b, a), worN=128)
    assert np.abs(gd - sps.group_delay((b, a), w=w)[1]).max() < 1e-8
    assert np.array_equal(tm.tf2sos(b, a), jm.tf2sos(b, a))
    for g, r in zip(tm.sos2tf(SOS), jm.sos2tf(SOS)):
        assert np.array_equal(g, r)
    assert np.abs(tm.lfilter_zi(b, a) - sps.lfilter_zi(b, a)).max() < 1e-12
    assert np.abs(tm.sosfilt_zi(SOS) - sps.sosfilt_zi(SOS)).max() < 1e-12
    assert np.array_equal(tm.sosfilt_zi(SOS), jm.sosfilt_zi(SOS))


# ---------------------------------------------------------- error texts

def _x3(mod):
    return mod.from_numpy(np.zeros((2, 2, 8), np.float32))


def _cplx(mod):
    return mod.from_numpy(np.ones(8, np.complex64))


def _x(mod, n=8):
    return mod.from_numpy(np.ones(n, np.float32))


ERRORS = {
    'lfilter method': lambda M, D: M.lfilter(*BA, _x(D), method='scan'),
    'lfilter a0': lambda M, D: M.lfilter([1.0], [0.0, 1.0], _x(D)),
    'lfilter order': lambda M, D: M.lfilter([2.0], [1.0], _x(D)),
    'lfilter 3-D': lambda M, D: M.lfilter(*BA, _x3(D)),
    'lfilter complex': lambda M, D: M.lfilter(*BA, _cplx(D)),
    'lfilter zi shape': lambda M, D: M.lfilter(*BA, _x(D), zi=np.zeros((2, 4))),
    'sosfilt method': lambda M, D: M.sosfilt(SOS, _x(D), method='scan'),
    'sosfilt sos shape': lambda M, D: M.sosfilt(np.ones((2, 5)), _x(D)),
    'sosfilt a0': lambda M, D: M.sosfilt([[1, 0, 0, 0, 1, 0]], _x(D)),
    'sosfilt 3-D': lambda M, D: M.sosfilt(SOS, _x3(D)),
    'sosfilt complex': lambda M, D: M.sosfilt(SOS, _cplx(D)),
    'sosfilt zi shape': lambda M, D: M.sosfilt(SOS, _x(D), zi=np.zeros((2, 2, 2))),
    'sosfiltfilt padtype': lambda M, D: M.sosfiltfilt(SOS, _x(D, 64), padtype='bogus'),
    'sosfiltfilt short': lambda M, D: M.sosfiltfilt(SOS, _x(D)),
    'sosfiltfilt complex': lambda M, D: M.sosfiltfilt(SOS, _cplx(D), padtype=None),
    'decimate q': lambda M, D: M.decimate(_x(D), 0),
    'decimate ftype': lambda M, D: M.decimate(_x(D), 2, ftype='bogus'),
    'butter order': lambda M, D: M.butter(0, 0.2),
    'butter Wn': lambda M, D: M.butter(2, 1.5),
    'butter btype': lambda M, D: M.butter(2, 0.2, 'comb'),
    'butter low with two edges': lambda M, D: M.butter(2, [0.1, 0.2]),
    'butter band with one edge': lambda M, D: M.butter(2, 0.2, 'bandpass'),
    'butter output': lambda M, D: M.butter(2, 0.2, output='ss'),
    'cheby1 rp': lambda M, D: M.cheby1(2, 0.0, 0.2),
    'cheby2 rs': lambda M, D: M.cheby2(2, -1.0, 0.2),
    'tf2sos a0': lambda M, D: M.tf2sos([1.0], [0.0, 1.0]),
    'lfilter_zi a0': lambda M, D: M.lfilter_zi([1.0], [0.0, 1.0]),
    'sosfilt_zi shape': lambda M, D: M.sosfilt_zi(np.ones((1, 4))),
    'normalize a0': lambda M, D: M.normalize([1.0], [0.0]),
    'normalize improper': lambda M, D: M.normalize([1.0, 2.0, 3.0], [1.0, 2.0]),
    'bilinear zero': lambda M, D: M.bilinear([1.0], [0.0]),
    'deconvolve divisor': lambda M, D: M.deconvolve([1.0, 2.0], [0.0, 1.0]),
}


@pytest.mark.parametrize('case', list(ERRORS))
def test_error_texts_match_jax(case):
    with pytest.raises(RuntimeError) as port:
        ERRORS[case](tm, dt)
    with pytest.raises(RuntimeError) as ref:
        ERRORS[case](jm, dsc_tpu)
    assert str(port.value) == str(ref.value)


# ----------------------------------------------------- the precision guard

def _precision_state():
    m = torch.backends.cuda.matmul
    return m.fp32_precision, torch.get_float32_matmul_precision(), m.allow_tf32


@pytest.mark.parametrize('setting', ['allow_tf32', 'medium', 'default'])
def test_a_call_runs_full_float32_and_leaves_the_setting(setting, monkeypatch):
    m = torch.backends.cuda.matmul
    saved = m.fp32_precision, torch.get_float32_matmul_precision()
    seen = []
    scalar = tiir._linrec_scalar

    def spy(*args):
        seen.append((m.allow_tf32, torch.get_float32_matmul_precision()))
        return scalar(*args)

    monkeypatch.setattr(tiir, '_linrec_scalar', spy)
    try:
        if setting == 'allow_tf32':
            m.allow_tf32 = True
        elif setting == 'medium':
            torch.set_float32_matmul_precision('medium')
        before = _precision_state()
        x = dt.from_numpy(_sig(4096, 7))
        tm.sosfilt(SOS, x)
        tm.lfilter(*BA, x)
        tm.sosfiltfilt(SOS, x)
        assert _precision_state() == before
        assert seen and all(s == (False, 'highest') for s in seen)
    finally:
        torch.set_float32_matmul_precision(saved[1])
        m.fp32_precision = saved[0]


def test_full_f32_under_the_new_interface_only():
    m = torch.backends.cuda.matmul
    saved = m.fp32_precision, torch.get_float32_matmul_precision()
    try:
        m.fp32_precision = 'tf32'
        with tiir._full_f32():
            assert m.allow_tf32 is False and m.fp32_precision == 'ieee'
        assert m.fp32_precision == 'tf32'
    finally:
        torch.set_float32_matmul_precision(saved[1])
        m.fp32_precision = saved[0]


# ------------------------------------------- tracing, capture and compile

def test_trace_events_name_each_entry_point():
    tracing.clear_traces()
    tracing.set_recording(True)
    try:
        x = dt.from_numpy(_sig(512, 8))
        tm.lfilter(*BA, x)
        tm.sosfilt(SOS, x)
        tm.sosfiltfilt(SOS, x)
        events = [e for e in tracing._events if e['ph'] == 'B']
    finally:
        tracing.set_recording(False)
        tracing.clear_traces()
    named = [(e['name'], e['cat']) for e in events if e['name'] in
             ('lfilter', 'sosfilt', 'sosfiltfilt')]
    assert named == [('lfilter', 'op;pipeline'), ('sosfilt', 'op;pipeline'),
                     ('sosfiltfilt', 'op;pipeline')]
    assert next(e for e in events if e['name'] == 'sosfilt')['args']['n_sections'] == 2


def test_capture_uses_the_cache_and_refuses_uploads(monkeypatch):
    monkeypatch.setattr(tiir, '_PLAN_CACHE', {})
    x = dt.from_numpy(_sig((2, 4096), 9))
    zi = dt.from_numpy(np.full((2, 2), 0.25, np.float32))
    eager, zf = tm.sosfilt(SOS, x, zi=zi)
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing', lambda: True)
    # the trace run filled the cache: a capture uploads nothing
    again, zf2 = tm.sosfilt(SOS, x, zi=zi)
    assert np.array_equal(again.numpy(), eager.numpy())
    assert np.array_equal(zf2.numpy(), zf.numpy())
    with pytest.raises(RuntimeError, match='sosfilt: zi was given as a host array'):
        tm.sosfilt(SOS, x, zi=np.zeros((2, 2)))
    with pytest.raises(RuntimeError, match='lfilter: zi was given as a host array'):
        tm.lfilter(*BA, x, zi=np.zeros(4))
    with pytest.raises(RuntimeError, match='evicted from the plan cache'):
        tm.sosfilt(SOS, dt.from_numpy(_sig(5000, 9)))  # a ladder never built
    with pytest.raises(RuntimeError, match="IIR constants 'ba'"):
        tm.lfilter(*BA, x)


def test_sosfilt_welch_compose_under_compile():
    # tests/test_iir.py::test_iir_psd_compose_under_compile, both packages
    x = _sig((4, 4096), 12)
    sos = jm.butter(4, 0.3)

    def pipe(port):
        M = tm if port else jm

        def fn(s):
            return M.welch(M.sosfilt(sos, s), nperseg=256)[1]
        return fn

    compiled = dt.compile(pipe(True))
    got = compiled(dt.from_numpy(x)).numpy()
    again = compiled(dt.from_numpy(x)).numpy()
    try:
        ref = dsc_tpu.compile(pipe(False))(dsc_tpu.from_numpy(x)).numpy()
    finally:
        # the JAX package's sosfilt keeps its constants in a process-wide
        # cache, here made inside its compile's trace: drop them, or a later
        # sosfilt of the same sections in this process (tests/test_iir.py)
        # meets the leaked tracers
        jiir._PLAN_CACHE.clear()
    sp = sps.welch(sps.sosfilt(sos, x.astype(np.float64), axis=-1), nperseg=256, axis=-1)[1]
    assert compiled.n_programs == 1 and np.array_equal(got, again)
    assert _rel(got, ref) < PORT_BOUND
    assert np.abs(got - sp).max() < 2e-4 * sp.max()
