"""The host design tier of dsc_tpu_torch (models/iirdesign.py, response.py,
pfe.py) against dsc_tpu.models and scipy.signal on the same inputs, on the
CPU, and the facade of the port's models.

- The port keeps the JAX package's NumPy code, so every design, order,
  response and partial-fraction expansion equals the reference's bit for
  bit (``_same``), and is held to scipy.signal with the JAX tests' bounds
  (tests/test_iirdesign.py, test_response.py, test_pfe.py): responses of
  the designs within 1e-9, the bandstop orders' edges within 2e-4,
  notch/peak/comb coefficients within 1e-14, residues within 1e-8.
- ``ellip`` and ``bessel`` sections filter a seeded signal through the
  port's ``sosfilt`` as through the JAX package's (1e-6 of the largest
  value: float32 results of two recurrences) and as scipy's (2e-4).
- The reference's ``freqs`` grid (two decades either side of the largest
  root) is not scipy's ``findfreqs``: both packages give the same grid, it
  differs from scipy's, and the response on it equals scipy's there.
- Tensor arguments (the NumPy protocol of the port's Tensor) give the
  NumPy arguments' results; the JAX package raises on them.
- ``czt_points`` has one definition, in models/czt.py.
- Every RuntimeError text equals the JAX package's.
"""

import gc
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
W = np.linspace(1e-3, np.pi - 1e-3, 2048)


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    # the conftest collects after every test: freeze what the imports left
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _same(got, ref):
    """Equal bit for bit: arrays (dtype and shape too), scalars, nested
    tuples."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
        return
    g, r = np.asarray(got), np.asarray(ref)
    assert g.dtype == r.dtype and g.shape == r.shape, (g.dtype, r.dtype, g.shape, r.shape)
    assert np.array_equal(g, r, equal_nan=True), (g, r)


def _both(name, *args, **kw):
    """The port's ``name`` and the JAX package's on the same arguments,
    equal bit for bit; returns the port's."""
    got = getattr(tm, name)(*args, **kw)
    _same(got, getattr(jm, name)(*args, **kw))
    return got


def _sos_response(sos, w):
    z = np.exp(1j * w)
    h = np.ones_like(z, complex)
    for s in np.atleast_2d(sos):
        h *= (s[0] + s[1] / z + s[2] / z ** 2) / (s[3] + s[4] / z + s[5] / z ** 2)
    return h


def _resp_err(sos, ref):
    return float(np.abs(np.abs(_sos_response(sos, W)) - np.abs(_sos_response(ref, W))).max())


def _error_text(fn, *args, **kw):
    with pytest.raises(RuntimeError) as info:
        fn(*args, **kw)
    return str(info.value)


# ------------------------------------------------------------ iirdesign.py

@pytest.mark.parametrize('n,btype,wn', [
    (1, 'low', 0.3), (2, 'low', 0.2), (4, 'low', 0.3), (7, 'low', 0.55),
    (5, 'high', 0.4), (4, 'bandpass', [0.2, 0.5]), (3, 'bandstop', [0.3, 0.6])])
def test_ellip(n, btype, wn):
    sos = _both('ellip', n, 0.5, 50.0, wn, btype=btype)
    assert _resp_err(sos, sps.ellip(n, 0.5, 50.0, wn, btype=btype, output='sos')) < 1e-9


@pytest.mark.parametrize('n', [1, 2, 3, 5, 8, 12])
def test_bessel(n):
    sos = _both('bessel', n, 0.3)
    assert _resp_err(sos, sps.bessel(n, 0.3, output='sos')) < 1e-9


def test_bessel_bandpass_and_fs_units():
    sos = _both('bessel', 4, [0.2, 0.5], btype='bandpass')
    assert _resp_err(sos, sps.bessel(4, [0.2, 0.5], btype='bandpass', output='sos')) < 1e-9
    sos = _both('ellip', 4, 0.5, 40.0, 100.0, fs=1000.0)
    assert _resp_err(sos, sps.ellip(4, 0.5, 40.0, 100.0, fs=1000.0, output='sos')) < 1e-9


@pytest.mark.parametrize('ftype,kw', [('butter', {}), ('cheby1', {'rp': 1.0}),
                                      ('cheby2', {'rs': 40.0}),
                                      ('ellip', {'rp': 1.0, 'rs': 40.0}), ('bessel', {})])
def test_iirfilter(ftype, kw):
    sos = _both('iirfilter', 4, 0.3, btype='low', ftype=ftype, **kw)
    ref = sps.iirfilter(4, 0.3, btype='low', ftype=ftype, output='sos', **kw)
    assert _resp_err(sos, ref) < 1e-9


@pytest.mark.parametrize('output', ['ba', 'zpk'])
@pytest.mark.parametrize('name,args', [('ellip', (4, 1.0, 40.0, 0.3)), ('bessel', (4, 0.3))])
def test_output_forms(name, args, output):
    got = _both(name, *args, output=output)
    want = getattr(sps, name)(*args, output=output)
    if output == 'ba':
        assert np.allclose(got[0], want[0], atol=1e-12)
        assert np.allclose(got[1], want[1], atol=1e-12)
    else:
        assert np.allclose(np.sort_complex(got[0]), np.sort_complex(want[0]), atol=1e-10)
        assert np.allclose(np.sort_complex(got[1]), np.sort_complex(want[1]), atol=1e-10)
        assert abs(got[2] - want[2]) < 1e-10


ORD_CASES = [(0.2, 0.3), (0.4, 0.25), ([0.2, 0.5], [0.1, 0.6]), ([0.1, 0.6], [0.2, 0.5]),
             (0.11, 0.13), ([0.3, 0.4], [0.25, 0.5])]


@pytest.mark.parametrize('name', ['buttord', 'cheb1ord', 'cheb2ord', 'ellipord'])
@pytest.mark.parametrize('wp,ws', ORD_CASES, ids=str)
def test_order_selection(name, wp, ws):
    n, wn = _both(name, wp, ws, 3, 40)
    n_ref, wn_ref = getattr(sps, name)(wp, ws, 3, 40)
    assert n == n_ref
    # bandstop edges come from a bounded scalar optimization on both sides
    assert np.abs(np.atleast_1d(wn) - np.atleast_1d(wn_ref)).max() < 2e-4


def test_order_selection_fs_units_and_spec_loop():
    n, wn = _both('buttord', 200, 300, 3, 40, fs=2000)
    n_ref, wn_ref = sps.buttord(200, 300, 3, 40, fs=2000)
    assert n == n_ref and abs(wn - wn_ref) < 1e-9
    n, wn = _both('ellipord', 0.2, 0.3, 1.0, 50.0)
    h = np.abs(_sos_response(_both('ellip', n, 1.0, 50.0, wn), W))
    assert h[W <= 0.2 * np.pi].min() > 10 ** (-1.01 / 20)
    assert h[W >= 0.3 * np.pi].max() < 10 ** (-49.9 / 20)


def test_notch_peak_comb():
    for name, args, kw in [('iirnotch', (0.3, 30.0), {}),
                           ('iirpeak', (60.0, 25.0), {'fs': 1000.0}),
                           *[('iircomb', (100.0, 30.0), {'ftype': ft, 'fs': 1000.0,
                                                         'pass_zero': pz})
                             for ft in ('notch', 'peak') for pz in (False, True)]]:
        b, a = _both(name, *args, **kw)
        br, ar = getattr(sps, name)(*args, **kw)
        assert np.abs(b - br).max() < 1e-14 and np.abs(a - ar).max() < 1e-14, (name, kw)


def test_band_stop_obj():
    passb, stopb = np.array([0.3, 2.0]), np.array([0.5, 1.2])
    for typ, wp, ind, gp, gs in [('butter', 0.3, 0, 1.0, 40.0), ('cheby', 1.8, 1, 2.0, 30.0),
                                 ('ellip', 0.28, 0, 1.0, 40.0)]:
        got = _both('band_stop_obj', wp, ind, passb, stopb, gp, gs, typ)
        want = sps.band_stop_obj(wp, ind, passb, stopb, gp, gs, typ)
        assert abs(got - want) < 1e-10 * max(1.0, abs(want))


def test_private_prototypes_kept_for_filter_extras():
    # the modules, not the facade's iirdesign function of the same name
    jd = importlib.import_module('dsc_tpu.models.iirdesign')
    td = importlib.import_module('dsc_tpu_torch.models.iirdesign')

    for n in (1, 4, 7):
        _same(td._ellipap(n, 0.5, 40.0), jd._ellipap(n, 0.5, 40.0))
        _same(td._besselap(n), jd._besselap(n))


def test_ellip_and_bessel_sections_filter_through_sosfilt():
    """Designed on the host, the sections filter on the port's sosfilt as
    on the JAX package's (one compiled shape: three sections, 4096)."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    for sos in (tm.ellip(5, 0.5, 45.0, 0.25), tm.bessel(5, 0.3)):
        got = tm.sosfilt(sos, dt.from_numpy(x)).numpy().astype(np.float64)
        ref = jm.sosfilt(sos, dsc_tpu.from_numpy(x)).numpy().astype(np.float64)
        want = sps.sosfilt(sos, x.astype(np.float64))
        assert np.abs(got - ref).max() < 1e-6 * np.abs(ref).max()
        assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()


# ------------------------------------------------------------- response.py

@pytest.mark.parametrize('ftype', ['ellip', 'cheby1', 'cheby2', 'butter'])
@pytest.mark.parametrize('wp,ws', [(0.2, 0.3), (0.5, 0.35), ([0.2, 0.5], [0.1, 0.6])], ids=str)
def test_iirdesign(ftype, wp, ws):
    sos = _both('iirdesign', wp, ws, 1.0, 40.0, ftype=ftype)
    assert _resp_err(sos, sps.iirdesign(wp, ws, 1.0, 40.0, ftype=ftype, output='sos')) < 1e-9


def test_iirdesign_ba():
    got = _both('iirdesign', 0.2, 0.3, 1.0, 40.0, output='ba')
    assert np.allclose(got[0], sps.iirdesign(0.2, 0.3, 1.0, 40.0, output='ba')[0], atol=1e-10)


def test_analog_responses_on_a_given_grid():
    b, a = [1.0, 2.0], [1.0, 1.4, 1.0]
    w = np.logspace(-2, 2, 200)
    assert np.allclose(_both('freqs', b, a, worN=w)[1], sps.freqs(b, a, worN=w)[1])
    z, p, k = sps.butter(4, 3.0, analog=True, output='zpk')
    assert np.allclose(_both('freqs_zpk', z, p, k, worN=w)[1], sps.freqs_zpk(z, p, k, worN=w)[1])


@pytest.mark.parametrize('name', ['freqs', 'freqs_zpk'])
def test_default_grid_is_the_reference_not_findfreqs(name):
    """The JAX package's grid: 200 points over two decades either side of
    the largest root's magnitude (3 here), on both sides; scipy's
    findfreqs grid differs; the response on the reference's grid is
    scipy's response there."""
    if name == 'freqs':
        args = ([1.0, 2.0], [1.0, 1.4, 1.0])
        limit = float(np.abs(np.concatenate([np.roots(args[1]), np.roots(args[0])])).max())
    else:
        args = sps.butter(4, 3.0, analog=True, output='zpk')
        limit = 3.0
    w, h = _both(name, *args)
    assert np.allclose(w, np.logspace(np.log10(limit) - 2, np.log10(limit) + 2, 200),
                       rtol=1e-14, atol=0)
    w_scipy, _ = getattr(sps, name)(*args)
    assert w.shape == w_scipy.shape and not np.allclose(w, w_scipy)
    assert np.allclose(h, getattr(sps, name)(*args, worN=w)[1])


def test_freqz_zpk():
    z, p, k = sps.butter(4, 0.3, output='zpk')
    for kw in [{}, {'worN': 256, 'fs': 1000.0}]:
        w, h = _both('freqz_zpk', z, p, k, **kw)
        w_ref, h_ref = sps.freqz_zpk(z, p, k, **kw)
        assert np.allclose(w, w_ref) and np.allclose(h, h_ref)


def test_freqresp_and_bode():
    system = sps.tf2ss([1.0, 3.0, 3.0], [1.0, 2.0, 1.0])
    w = np.logspace(-2, 2, 100)
    assert np.allclose(_both('freqresp', system, w=w)[1], sps.freqresp(system, w=w)[1])
    _, mag, phase = _both('bode', system, w=w)
    _, mag_ref, phase_ref = sps.bode(system, w=w)
    assert np.allclose(mag, mag_ref) and np.allclose(phase, phase_ref)
    _both('freqresp', system)
    _both('bode', (np.array([1.0]), np.array([1.0, 1.0])))


@pytest.mark.parametrize('mode', ['full', 'same', 'valid'])
def test_correlation_lags(mode):
    for n1, n2 in [(10, 4), (4, 10), (7, 7), (10, 10), (9, 4), (5, 3), (3, 5)]:
        assert np.array_equal(_both('correlation_lags', n1, n2, mode),
                              sps.correlation_lags(n1, n2, mode)), (n1, n2)


def test_czt_points_has_one_definition():
    jr = importlib.import_module('dsc_tpu.models.response')
    czt = importlib.import_module('dsc_tpu_torch.models.czt')
    response = importlib.import_module('dsc_tpu_torch.models.response')
    assert response.czt_points is czt.czt_points is tm.czt_points
    w0, a0 = np.exp(-2j * np.pi / 32), 0.5
    for args, kw in [((16,), {}), ((16,), {'w': w0, 'a': a0})]:
        got = tm.czt_points(*args, **kw)
        _same(got, jr.czt_points(*args, **kw))
        assert np.allclose(got, sps.czt_points(*args, **kw))


# ------------------------------------------------------------------ pfe.py

def _canon(r, p):
    r, p = np.asarray(r), np.asarray(p)
    o = np.lexsort((r.round(8).imag, r.round(8).real, p.round(6).imag, p.round(6).real))
    return r[o], p[o]


S_CASES = [
    ([1.0, 2.0], np.poly([-1.0, -2.0, -3.0])),
    ([1.0, 0.5, 2.0], np.poly([-1.0, -1.0, -2.0])),   # double pole
    ([3.0, 1.0], np.poly([-1.0, -1.0, -1.0])),        # triple pole
    ([1.0, 1.0, 1.0, 1.0], [1.0, 2.0, 1.0]),          # improper
    (np.poly([-0.5 + 1j, -0.5 - 1j]), np.poly([-1 + 2j, -1 - 2j, -3.0])),  # complex pairs
]
Z_CASES = [
    ([1.0, -0.5], np.poly([0.5, -0.3])[::-1]),
    ([1.0, 0.2, 0.1], [1.0, -1.0, 0.25]),    # double pole at z = 0.5
    ([2.0, 1.0, 0.0, 0.5], [1.0, -0.8]),     # improper: direct z^-i terms
]


@pytest.mark.parametrize('kind,b,a', [('s', b, a) for b, a in S_CASES]
                         + [('z', b, a) for b, a in Z_CASES],
                         ids=[f's{i}' for i in range(len(S_CASES))]
                         + [f'z{i}' for i in range(len(Z_CASES))])
def test_partial_fractions_and_inverse(kind, b, a):
    fwd, inv = ('residue', 'invres') if kind == 's' else ('residuez', 'invresz')
    b, a = np.asarray(b, float if kind == 'z' else None), np.asarray(a)
    r, p, k = _both(fwd, b, a)
    r_ref, p_ref, k_ref = getattr(sps, fwd)(b, a)
    (r, p), (r_ref, p_ref) = _canon(r, p), _canon(r_ref, p_ref)
    assert np.allclose(r, r_ref, atol=1e-8) and np.allclose(p, p_ref, atol=1e-8)
    assert np.asarray(k).size == np.asarray(k_ref).size
    if np.asarray(k).size:
        assert np.allclose(np.atleast_1d(k), np.atleast_1d(k_ref))
    b1, a1 = _both(inv, r_ref, p_ref, k_ref)
    b2, a2 = getattr(sps, inv)(r_ref, p_ref, k_ref)
    assert np.allclose(np.trim_zeros(np.atleast_1d(b1), 'f'),
                       np.trim_zeros(np.atleast_1d(b2), 'f'), atol=1e-8)
    assert np.allclose(a1, a2, atol=1e-8)


def test_group_poles_kept_for_filter_extras():
    jp = importlib.import_module('dsc_tpu.models.pfe')
    tp = importlib.import_module('dsc_tpu_torch.models.pfe')

    p = [0.5, 0.5 + 1e-5, -1.0, 2.0j, -2.0j, -1.0 + 1e-4]
    for rtype in ('avg', 'min', 'max'):
        assert tp._group_poles(p, 1e-3, rtype) == jp._group_poles(p, 1e-3, rtype)


# ---------------------------------------------------- errors and arguments

ERRORS = [
    ('ellip', (4, 0.0, 40.0, 0.3), {}), ('ellip', (4, 2.0, 1.0, 0.3), {}),
    ('ellip', (0, 1.0, 40.0, 0.3), {}), ('bessel', (30, 0.3), {}),
    ('iirfilter', (4, 0.3), {'ftype': 'nope'}), ('iirfilter', (4, 0.3), {'ftype': 'ellip'}),
    ('iirfilter', (4, 0.3), {'ftype': 'cheby1'}), ('buttord', (0.2, 0.3, 3, 2), {}),
    ('cheb1ord', (0.2, 1.3, 3, 40), {}), ('ellipord', ([0.2, 0.5], [0.3, 0.6], 3, 40), {}),
    ('cheb2ord', (0.2, 0.3, -1, 40), {}), ('iircomb', (101.0, 30.0), {'fs': 1000.0}),
    ('iirnotch', (1.5, 30.0), {}), ('iircomb', (100.0, 30.0), {'ftype': 'x', 'fs': 1000.0}),
    ('band_stop_obj', (0.3, 0, [0.3, 2.0], [0.5, 1.2], 1.0, 40.0, 'bogus'), {}),
    ('iirdesign', (0.2, 0.3, 1.0, 40.0), {'ftype': 'bessel'}),
    ('correlation_lags', (4, 3, 'nope'), {}), ('czt_points', (0,), {}),
    ('residue', ([1.0], [0.0]), {}), ('residue', ([1.0], [1.0, 1.0]), {'rtype': 'bogus'}),
    ('invres', ([1.0, 2.0], [0.5], 0.0), {}), ('invresz', ([1.0, 2.0], [0.5], 0.0), {})]


@pytest.mark.parametrize('name,args,kw', ERRORS, ids=[f'{e[0]}-{i}' for i, e in enumerate(ERRORS)])
def test_error_text_equals_the_reference(name, args, kw):
    assert _error_text(getattr(tm, name), *args, **kw) == \
        _error_text(getattr(jm, name), *args, **kw)


def test_tensor_arguments():
    """Array-like Tensor arguments give the NumPy arguments' results; the
    JAX package's Tensor iterates into its out-of-bounds RuntimeError."""
    b, a = np.array([1.0, 0.5, 2.0]), np.poly([-1.0, -1.0, -2.0])
    bt, at = dt.from_numpy(b), dt.from_numpy(a)
    _same(tm.residue(bt, at), tm.residue(b, a))
    _same(tm.residuez(bt, at), tm.residuez(b, a))
    w = np.logspace(-2, 2, 50)
    _same(tm.freqs(bt, at, worN=dt.from_numpy(w)), tm.freqs(b, a, worN=w))
    _same(tm.freqs(bt, at), tm.freqs(b, a))
    _same(tm.buttord(dt.from_numpy(np.array([0.2, 0.5])), dt.from_numpy(np.array([0.1, 0.6])),
                     3, 40), tm.buttord([0.2, 0.5], [0.1, 0.6], 3, 40))
    with pytest.raises(RuntimeError, match='out of bounds'):
        jm.residue(dsc_tpu.from_numpy(b), dsc_tpu.from_numpy(a))


# ------------------------------------------------------------------ facade

NEW_NAMES = {
    'pfe': ['residue', 'residuez', 'invres', 'invresz'],
    'iirdesign': ['ellip', 'bessel', 'iirfilter', 'buttord', 'cheb1ord', 'cheb2ord',
                  'ellipord', 'band_stop_obj', 'iirnotch', 'iirpeak', 'iircomb'],
    'response': ['iirdesign', 'freqs', 'freqs_zpk', 'freqz_zpk', 'freqresp', 'bode',
                 'correlation_lags'],
    'waveforms': ['chirp', 'square', 'sawtooth', 'gausspulse', 'sweep_poly', 'max_len_seq',
                  'vectorstrength'],
    'nonlinear': ['medfilt', 'medfilt2d', 'order_filter', 'wiener']}
# the five modules that completed the facade, each checked in its own file
# (test_torch_filter_extras.py, test_torch_ltisys.py, test_torch_design_peaks.py)
SYSTEM_TIER = {
    'filter_extras': ['abcd_normalize', 'besselap', 'bilinear_zpk', 'buttap', 'cheb1ap',
                      'cheb2ap', 'choose_conv_method', 'dbode', 'dfreqresp', 'ellipap',
                      'fftconvolve', 'findfreqs', 'freqz_sos', 'lfiltic', 'lp2bp', 'lp2bp_zpk',
                      'lp2bs', 'lp2bs_zpk', 'lp2hp', 'lp2hp_zpk', 'lp2lp', 'lp2lp_zpk',
                      'unique_roots'],
    'ltisys': ['StateSpace', 'TransferFunction', 'ZerosPolesGain', 'dlti', 'lti'],
    'placepoles': ['place_poles'],
    'remez': ['remez'],
    'peaks': ['argrelextrema', 'argrelmax', 'argrelmin', 'find_peaks', 'peak_prominences',
              'peak_widths']}
# the reference's names the port has yet to take
STILL_MISSING = set()
# public names the port has and the JAX package has not
PORT_ONLY = {'GriffinLim'}


def test_facade():
    names = [n for module in NEW_NAMES.values() for n in module]
    assert len(names) == len(set(names)) == 33
    assert set(names) <= set(tm.__all__)
    system_names = [n for module in SYSTEM_TIER.values() for n in module]
    assert len(system_names) == len(set(system_names)) == 36
    assert set(system_names) <= set(tm.__all__)
    assert len(tm.__all__) == len(set(tm.__all__)) == 169 + len(PORT_ONLY)
    assert set(jm.__all__) - set(tm.__all__) == STILL_MISSING
    assert set(tm.__all__) - set(jm.__all__) == PORT_ONLY
    assert set(tm.__all__) - PORT_ONLY == set(jm.__all__)
    for module, module_names in {**NEW_NAMES, **SYSTEM_TIER}.items():
        for n in module_names:
            assert getattr(tm, n).__module__ == f'dsc_tpu_torch.models.{module}', n
    # the package's ``lti`` is the factory, as the JAX package's is
    assert tm.lti is importlib.import_module('dsc_tpu_torch.models.ltisys').lti
    assert isinstance(tm.lti([1.0], [1.0, 1.0]), tm.TransferFunction)


def test_new_modules_import_neither_jax_nor_the_reference():
    for module in [*NEW_NAMES, *SYSTEM_TIER]:
        src = (REPO / 'dsc_tpu_torch' / 'models' / f'{module}.py').read_text()
        assert 'import jax' not in src and 'from jax' not in src
        assert 'import dsc_tpu\n' not in src and 'from dsc_tpu.' not in src
    code = ('import sys, dsc_tpu_torch.models; '
            'print(any(m == "jax" or m.startswith(("jax.", "dsc_tpu.")) or m == "dsc_tpu" '
            'for m in sys.modules))')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == 'False'
