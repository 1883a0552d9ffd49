"""The state-space tier of dsc_tpu_torch (models/statespace.py and the scan
of models/_affine_scan.py) against dsc_tpu.models and scipy.signal on the
same inputs, on the CPU.

- the scan helper alone against a float64 loop over time (1e-12 of the
  largest state), T = 1, 2, 3 and 2^12 + 3, for 1, 2 and 4 states, and its
  maps of a tensor A (iir.py's sections) equal to a host A's in float64 and
  within float32's compounded rounding in float32;
- every conversion and every ``cont2discrete`` method, in tf, zpk and ss
  form: the port's host code is a copy of the JAX package's, so each result
  equals the JAX package's within 1e-12;
- ``dlsim`` on the NumPy path (float64, 1e-12 of the largest value against
  the JAX package) and the Tensor path (float32, 1e-6), with and without
  ``x0``, for a 0-, a 1- and a 4-state system, at 1, 2, 300 and 2^12 + 3
  steps;
- ``lsim`` (``interp`` True and False), ``step``, ``impulse``, ``dstep`` and
  ``dimpulse`` at 1e-12 against the JAX package and scipy;
- the caller's input unchanged after each call, the trace event, and every
  RuntimeError text equal to the JAX package's.
"""

import gc

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jm  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
import dsc_tpu_torch.models as tm  # noqa: E402
from dsc_tpu_torch import tracing  # noqa: E402
from dsc_tpu_torch.models._affine_scan import affine_scan_, scan_maps  # noqa: E402

EXACT = 1e-12  # the float64 paths: relative to the largest value
TENSOR = 1e-6  # the Tensor path's float32 results, relative to the largest value
B_A = ([1.0, 3.0, 3.0], [1.0, 2.0, 1.0])  # tests/test_statespace.py's system (D = 1)
PROPER = ([0.5, 2.0], [1.0, 1.5, 0.8])  # strictly proper (D = 0): 'impulse' takes it
BUTTER = sps.butter(4, 2 * np.pi * 50, analog=True)  # chip_smoke.py phase 10's system


def _discrete(system, dt_):
    return tuple(np.asarray(m, np.float64) for m in jm.cont2discrete(
        tuple(np.asarray(m, np.float64) for m in jm.tf2ss(*system)), dt_)[:4]) + (dt_,)


SYSTEMS = {  # (A, B, C, D, dt) with 0, 1 and 4 states
    0: (np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)), np.asarray([[1.5]]), 0.1),
    1: _discrete(([0.5], [1.0, 0.9]), 0.05),
    4: _discrete(BUTTER, 1e-3),
}
STEPS = (1, 2, 300, 2**12 + 3)


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _close(got, ref, bound=EXACT):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max(initial=0.0) <= bound * max(np.abs(ref).max(initial=0.0), 1.0)


def _all_close(got, ref, bound=EXACT):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g, r, bound)


def _error_text(fn, *args, **kw):
    with pytest.raises(RuntimeError) as info:
        fn(*args, **kw)
    return str(info.value)


# -------------------------------------------------------------- the scan

@pytest.mark.parametrize('m', [1, 2, 4])
@pytest.mark.parametrize('steps', [1, 2, 3, 2**12 + 3])
def test_affine_scan_against_a_loop(steps, m):
    rng = np.random.default_rng(steps + m)
    A = rng.standard_normal((m, m))
    A *= 0.95 / max(np.abs(np.linalg.eigvals(A)).max(), 1e-3)
    v = rng.standard_normal((3, steps, m))
    want = v.copy()
    for k in range(1, steps):
        want[:, k] += want[:, k - 1] @ A.T
    w = torch.from_numpy(v.copy())
    maps = scan_maps(A, steps, w.device)
    assert maps.shape == (int(np.ceil(np.log2(steps))), m, m) and maps.dtype == torch.float64
    assert affine_scan_(w, maps) is w
    _close(w.numpy(), want)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('m', [1, 2, 4])
@pytest.mark.parametrize('steps', [1, 3, 2**12 + 3])
def test_scan_maps_of_a_tensor(steps, m, dtype):
    """A tensor A (iir.py's sections) is squared where it lies, in its
    dtype: the same maps as a host A's, rounded once to that dtype."""
    A = np.random.default_rng(steps * m).standard_normal((m, m))
    A *= 0.95 / max(np.abs(np.linalg.eigvals(A)).max(), 1e-3)
    host = scan_maps(A, steps, 'cpu')
    maps = scan_maps(torch.from_numpy(A).to(dtype), steps)
    assert maps.dtype == dtype and maps.shape == host.shape
    if dtype == torch.float64:
        np.testing.assert_array_equal(maps.numpy(), host.numpy())
    else:
        # float32 rounding doubles with each squaring: A^(2^i) within 2^i 1e-6
        # of its largest entry; A^(2^11) and past underflow
        err = np.abs(maps.double().numpy() - host.numpy()).max(axis=(1, 2), initial=0.0)
        scale = np.abs(host.numpy()).max(axis=(1, 2), initial=0.0)
        assert (err <= 2.0 ** np.arange(len(err)) * 1e-6 * scale + 1e-30).all()


# ---------------------------------------------------------- conversions

@pytest.mark.parametrize('system', [B_A, PROPER, BUTTER], ids=['b_a', 'proper', 'butter'])
def test_conversions_equal_jax(system):
    ss = tm.tf2ss(*system)
    _all_close(ss, jm.tf2ss(*system))
    _all_close(tm.ss2tf(*ss), jm.ss2tf(*ss))
    z, p, k = sps.tf2zpk(*system)
    _all_close(tm.zpk2ss(z, p, k), jm.zpk2ss(z, p, k))
    _all_close(tm.ss2zpk(*ss), jm.ss2zpk(*ss))
    n2, d2 = sps.ss2tf(*sps.tf2ss(*system))
    num, den = tm.ss2tf(*ss)
    assert np.allclose(num, n2) and np.allclose(den, d2)


METHODS = [('zoh', None), ('foh', None), ('impulse', None), ('bilinear', None),
           ('tustin', None), ('euler', None), ('forward_diff', None),
           ('backward_diff', None), ('gbt', 0.3)]


@pytest.mark.parametrize('form', ['tf', 'zpk', 'ss'])
@pytest.mark.parametrize('method,alpha', METHODS)
def test_cont2discrete_equals_jax(method, alpha, form):
    system = PROPER if method == 'impulse' else B_A
    spec = {'tf': system, 'zpk': sps.tf2zpk(*system), 'ss': sps.tf2ss(*system)}[form]
    kw = {} if alpha is None else {'alpha': alpha}
    got = tm.cont2discrete(spec, 0.1, method=method, **kw)
    ref = jm.cont2discrete(spec, 0.1, method=method, **kw)
    assert len(got) == len(ref) and got[-1] == ref[-1] == 0.1
    _all_close(got[:-1], ref[:-1])
    if form == 'ss':
        want = sps.cont2discrete(spec, 0.1, method=method, **kw)
        _all_close(got[:-1], want[:-1])


# ---------------------------------------------------------------- dlsim

_JAX = {}


def _jax_dlsim(n, steps, with_x0, tensor):
    """The JAX package's dlsim on the case's inputs, once a case."""
    key = (n, steps, with_x0, tensor)
    if key not in _JAX:
        u, x0 = _dlsim_inputs(n, steps, with_x0)
        if tensor:
            out = jm.dlsim(SYSTEMS[n], dsc_tpu.from_numpy(u.astype(np.float32)), x0=x0)
            out = (out[0], out[1].numpy(), out[2].numpy())
        else:
            out = jm.dlsim(SYSTEMS[n], u, x0=x0)
        _JAX[key] = out
    return _JAX[key]


def _dlsim_inputs(n, steps, with_x0):
    rng = np.random.default_rng(10 * n + steps)
    u = rng.standard_normal(steps)
    x0 = rng.standard_normal(n) if with_x0 else None
    return u, x0


@pytest.mark.parametrize('with_x0', [False, True], ids=['x0 0', 'x0'])
@pytest.mark.parametrize('steps', STEPS)
@pytest.mark.parametrize('n', sorted(SYSTEMS))
def test_dlsim_numpy_path_equals_jax(n, steps, with_x0):
    u, x0 = _dlsim_inputs(n, steps, with_x0)
    u_in = u.copy()
    t, y, x = tm.dlsim(SYSTEMS[n], u, x0=x0)
    rt, ry, rx = _jax_dlsim(n, steps, with_x0, False)
    assert y.dtype == x.dtype == np.float64 and x.shape == (steps, n)
    assert np.array_equal(u, u_in)
    _close(t, rt)
    _close(y, ry)
    _close(x, rx)
    if n and steps > 1:
        _, sy, sx = sps.dlsim(SYSTEMS[n], u, x0=x0)
        _close(y, sy, 1e-10)
        _close(x, sx, 1e-10)


@pytest.mark.parametrize('with_x0', [False, True], ids=['x0 0', 'x0'])
@pytest.mark.parametrize('steps', STEPS)
@pytest.mark.parametrize('n', sorted(SYSTEMS))
def test_dlsim_tensor_path_equals_jax(n, steps, with_x0):
    u, x0 = _dlsim_inputs(n, steps, with_x0)
    ut = dt.from_numpy(u.astype(np.float32))
    before = ut.numpy().copy()
    t, y, x = tm.dlsim(SYSTEMS[n], ut, x0=x0)
    rt, ry, rx = _jax_dlsim(n, steps, with_x0, True)
    assert isinstance(y, dt.Tensor) and isinstance(x, dt.Tensor)
    assert y.dtype == x.dtype == dt.Dtype.F32 and y.device == ut.device
    assert np.array_equal(ut.numpy(), before)
    _close(t, rt)
    _close(y.numpy(), ry, TENSOR)
    _close(x.numpy(), rx, TENSOR)


def test_dlsim_float64_tensor_input_unchanged_and_tf_zpk_forms():
    """A float64 Tensor ``u`` (which the float64 cast does not copy) is left
    as it was; (num, den, dt) and (z, p, k, dt) systems convert as the JAX
    package converts them (tests/test_statespace.py's system at dt = 0.05:
    the canonical form of the 4-state system, whose poles lie within 0.3 of
    1, spreads float64 rounding over its states)."""
    u = np.random.default_rng(3).standard_normal(300)
    ut = dt.from_numpy(u)
    _, y, _ = tm.dlsim(SYSTEMS[4], ut, x0=np.ones(4))
    assert np.array_equal(ut.numpy(), u)
    _close(y.numpy(), jm.dlsim(SYSTEMS[4], u, x0=np.ones(4))[1], TENSOR)
    num = (*sps.cont2discrete(B_A, 0.05)[:2], 0.05)
    num = (num[0][0], num[1], 0.05)
    _all_close(tm.dlsim(num, u)[1:], jm.dlsim(num, u)[1:])
    zpk = (*sps.tf2zpk(num[0], num[1]), 0.05)
    _all_close(tm.dlsim(zpk, u)[1:], jm.dlsim(zpk, u)[1:])


def test_dlsim_multi_input_multi_output():
    rng = np.random.default_rng(5)
    A = np.diag([0.9, -0.5, 0.3])
    B, C, D = rng.standard_normal((3, 2)), rng.standard_normal((2, 3)), rng.standard_normal((2, 2))
    u = rng.standard_normal((300, 2))
    got = tm.dlsim((A, B, C, D, 0.1), u, x0=[1.0, 2.0, 3.0])
    _all_close(got, jm.dlsim((A, B, C, D, 0.1), u, x0=[1.0, 2.0, 3.0]))
    _all_close(got[1:], sps.dlsim((A, B, C, D, 0.1), u, x0=[1.0, 2.0, 3.0])[1:], 1e-10)


def test_dlsim_trace_event():
    tracing.clear_traces()
    tracing.set_recording(True)
    try:
        tm.dlsim(SYSTEMS[4], np.ones(300))
        events = [e for e in tracing._events if e['ph'] == 'B' and e['name'] == 'dlsim']
    finally:
        tracing.set_recording(False)
        tracing.clear_traces()
    # every Begin also carries args.root, the id its public call's spans share
    assert [(e['cat'], e['args']) for e in events] == [
        ('op;pipeline', {'steps': 300, 'n': 4, 'root': events[0]['args']['root']})]


# ------------------------------------------- continuous-time simulators

A_B_C_D = sps.tf2ss(*B_A)
T200 = np.arange(200) * 0.05


@pytest.mark.parametrize('interp', [True, False])
def test_lsim_equals_jax_and_scipy(interp):
    U = np.sin(T200 * 2.0)  # U[0] = 0: the JAX package's first-order hold starts right (F4)
    for system, x0 in ((A_B_C_D, None), (B_A, [0.5, -1.0])):
        got = tm.lsim(system, U, T200, X0=x0, interp=interp)
        ref = jm.lsim(system, U, T200, X0=x0, interp=interp)
        # with the first-order hold the JAX package returns x - Gamma2/dt u (F4)
        _all_close(got if not interp else got[:2], ref if not interp else ref[:2])
        _all_close(got, sps.lsim(system, U, T200, X0=x0, interp=interp))


def test_lsim_first_order_hold_from_a_nonzero_first_input():
    """ROADMAP F4: scipy's hold steps x[k+1] = Ad x[k] + Bd0 u[k] + Bd1 u[k+1]
    from x[0] = X0. The JAX package simulates cont2discrete's 'foh' system,
    whose state is x - Gamma2/dt u, from X0 where X0 - Gamma2/dt u[0] is due:
    its y differs from scipy's by a decaying transient when u[0] != 0. The
    port steps scipy's hold."""
    U = np.random.default_rng(7).standard_normal(T200.size)
    x0 = [0.5, -1.0]
    got = tm.lsim(A_B_C_D, U, T200, X0=x0)
    want = sps.lsim(A_B_C_D, U, T200, X0=x0)
    _all_close(got, want)
    jax_y = jm.lsim(A_B_C_D, U, T200, X0=x0)[1]
    assert np.abs(jax_y - want[1]).max() > 1e-6 * np.abs(want[1]).max()


@pytest.mark.parametrize('dt_', [1e-3, 1e-4])
def test_expm_of_a_badly_scaled_canonical_form(dt_):
    """ROADMAP F5: the controller-canonical A of the analog butter(4, 2 pi
    50) has entries to 1e10. Counting the squarings from ||A^8||^(1/8) and
    ||A^10||^(1/10) keeps its exponential within 1e-15 of the largest entry
    of scipy.linalg.expm's; the JAX package counts them from ||A dt||_1 and
    is off by more than 1e-12."""
    import scipy.linalg as sl

    from dsc_tpu.models.statespace import _expm as jax_expm
    from dsc_tpu_torch.models.statespace import _expm

    A = tm.tf2ss(*BUTTER)[0] * dt_
    want = sl.expm(A)
    scale = np.abs(want).max()
    assert np.abs(_expm(A) - want).max() <= 1e-15 * scale
    assert np.abs(jax_expm(A) - want).max() > 1e-12 * scale
    got = tm.cont2discrete(tm.tf2ss(*BUTTER), dt_)
    _all_close(got[:4], sps.cont2discrete(tm.tf2ss(*BUTTER), dt_)[:4], 1e-15)


@pytest.mark.parametrize('fn', ['step', 'impulse'])
@pytest.mark.parametrize('horizon', ['T', 'default', 'default N 64 with X0'])
def test_step_impulse_equal_jax_and_scipy(fn, horizon):
    kw = {'T': T200} if horizon == 'T' else {}
    if horizon.startswith('default N'):
        kw = {'N': 64, 'X0': [0.2, 0.1]}
    got = getattr(tm, fn)(A_B_C_D, **kw)
    _all_close(got, getattr(jm, fn)(A_B_C_D, **kw))
    if fn == 'step' or 'X0' not in kw:  # scipy's impulse cannot add X0 to a (2, 1) B
        _all_close(got, getattr(sps, fn)(A_B_C_D, **kw))


@pytest.mark.parametrize('fn', ['dstep', 'dimpulse'])
@pytest.mark.parametrize('form', ['ss', 'tf', 'zpk'])
def test_dstep_dimpulse_equal_jax_and_scipy(fn, form):
    sysd = _discrete(B_A, 0.05)
    num, den = sps.ss2tf(*sysd[:4])
    spec = {'ss': sysd, 'tf': (num[0], den, sysd[-1]),
            'zpk': (*sps.tf2zpk(num[0], den), sysd[-1])}[form]
    got = getattr(tm, fn)(spec, n=64)
    _all_close(got, getattr(jm, fn)(spec, n=64))
    _close(got[1], np.asarray(getattr(sps, fn)(sysd, n=64)[1][0])[:, 0])
    x0 = np.asarray([0.5, -1.0])
    if form == 'ss':
        _all_close(getattr(tm, fn)(spec, x0=x0, n=64), getattr(jm, fn)(spec, x0=x0, n=64))


# ---------------------------------------------------------------- errors

SS = A_B_C_D
SSD = sps.cont2discrete(SS, 0.1)
ERRORS = {
    'cont2discrete unknown method': lambda m: m.cont2discrete(SS, 0.1, method='bogus'),
    'cont2discrete gbt without alpha': lambda m: m.cont2discrete(SS, 0.1, method='gbt'),
    'cont2discrete gbt alpha 1.5': lambda m: m.cont2discrete(SS, 0.1, method='gbt', alpha=1.5),
    'cont2discrete impulse with D': lambda m: m.cont2discrete(SS, 0.1, method='impulse'),
    'cont2discrete not a system': lambda m: m.cont2discrete(np.ones(3), 0.1),
    'ss2tf two inputs': lambda m: m.ss2tf(np.eye(2), np.ones((2, 2)), np.ones((1, 2)),
                                          np.ones((1, 2))),
    'dlsim no dt': lambda m: m.dlsim(SS[:2], np.ones(5)),
    'dlsim not a tuple': lambda m: m.dlsim(np.ones(3), np.ones(5)),
    'dlsim u of 2 inputs': lambda m: m.dlsim(SSD, np.ones((5, 2))),
    'dlsim x0 of 3': lambda m: m.dlsim(SSD, np.ones(5), x0=np.ones(3)),
    'dstep not a tuple': lambda m: m.dstep(np.ones(3)),
    'dimpulse 6-tuple': lambda m: m.dimpulse((1, 2, 3, 4, 5, 6)),
    'lsim T of 1 point': lambda m: m.lsim(SS, np.ones(1), np.zeros(1)),
    'lsim 2-D T': lambda m: m.lsim(SS, np.ones(4), np.zeros((2, 2))),
    'lsim uneven T': lambda m: m.lsim(SS, np.ones(5), np.array([0.0, 0.1, 0.3, 0.4, 0.5])),
    'lsim U and T lengths': lambda m: m.lsim(SS, np.ones(4), np.arange(5) * 0.1),
    'step 6-tuple': lambda m: m.step((1, 2, 3, 4, 5, 6)),
}


@pytest.mark.parametrize('case', list(ERRORS))
def test_error_texts_equal_jax(case):
    assert _error_text(ERRORS[case], tm) == _error_text(ERRORS[case], jm)
