"""The LTI system classes of dsc_tpu_torch (models/ltisys.py: ``lti``,
``dlti``, ``TransferFunction``, ``ZerosPolesGain``, ``StateSpace``) against
dsc_tpu.models and scipy.signal on the same inputs, on the CPU.

- Representations and conversions are the JAX package's NumPy code: every
  array a class holds or converts to equals the reference's bit for bit.
- Responses ride the port's functions: ``step`` / ``impulse`` (continuous
  and discrete), ``output`` on the NumPy path and ``bode`` / ``freqresp``
  of a continuous system equal the reference's within 1e-12 of the largest
  value (tests/test_statespace.py's float64 bound) and scipy's within the
  bounds of tests/test_ltisys.py (1e-12 for the simulations); a discrete
  ``output`` of a float32 Tensor stays on its device and returns float32
  Tensors within 1e-6 of the reference's.
- A continuous ``output`` whose first input is not 0 takes scipy's
  first-order hold, where the reference's differs (ROADMAP F4).
- A discrete system's ``freqresp`` / ``bode`` are scipy's also for a
  strictly proper system (ROADMAP F9), where the reference's phase is off.
- The factories' errors and ``to_discrete``'s equal the reference's.
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

EXACT = 1e-12   # float64 results: relative to the largest value
TENSOR = 1e-6   # float32 Tensor results: relative to the largest value
B_A = ([1.0, 3.0, 3.0], [1.0, 2.0, 1.0])  # tests/test_ltisys.py's system
PROPER = ([0.5, 2.0], [1.0, 1.5, 0.8])    # strictly proper
ZPK = ([-1.0], [-2.0, -0.5 + 1j, -0.5 - 1j], 3.0)
T = np.arange(100) * 0.05


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _close(got, want, bound=EXACT):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    top = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    assert np.abs(got - want).max(initial=0.0) <= bound * top


def _all_close(got, want, bound=EXACT):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, bound)


def _error_text(fn, *args, **kw):
    with pytest.raises(RuntimeError) as info:
        fn(*args, **kw)
    return str(info.value)


SYSTEMS = {  # form -> the continuous system's arguments to lti, in each package and scipy
    'tf': B_A,
    'tf strictly proper': PROPER,
    'zpk': ZPK,
    'ss': sps.tf2ss(*PROPER),
}


def _three(form):
    """The port's, the JAX package's and scipy's lti of ``form``."""
    return tm.lti(*SYSTEMS[form]), jm.lti(*SYSTEMS[form]), sps.lti(*SYSTEMS[form])


# ----------------------------------------------------- classes and conversions

@pytest.mark.parametrize('form', sorted(SYSTEMS))
def test_representations_equal_jax(form):
    mine, ref, sref = _three(form)
    assert type(mine).__name__ == type(ref).__name__
    assert type(mine).__module__ == 'dsc_tpu_torch.models.ltisys'
    assert repr(mine) == repr(ref)
    for conv in ('to_tf', 'to_zpk', 'to_ss'):
        a, b = getattr(mine, conv)(), getattr(ref, conv)()
        assert type(a).__name__ == type(b).__name__ and a.dt == b.dt is None
        for attr in ('num', 'den', 'z', 'p', 'k', 'A', 'B', 'C', 'D'):
            if hasattr(b, attr):
                assert np.array_equal(getattr(a, attr), getattr(b, attr)), (conv, attr)
    assert np.array_equal(mine.poles, ref.poles) and np.array_equal(mine.zeros, ref.zeros)
    assert np.allclose(np.sort_complex(mine.poles), np.sort_complex(sref.poles), atol=1e-12)
    assert np.allclose(np.sort_complex(mine.zeros), np.sort_complex(sref.zeros), atol=1e-12)


def test_factories_and_to_discrete():
    assert isinstance(tm.lti(*B_A), tm.TransferFunction)
    assert isinstance(tm.lti(*ZPK), tm.ZerosPolesGain)
    assert isinstance(tm.dlti(*sps.tf2ss(*B_A), dt=0.1), tm.StateSpace)
    d = tm.dlti(*B_A)
    assert d.dt is True and d.is_discrete and d._dt_tuple() == (1.0,)
    ss = tm.lti(*B_A).to_ss()
    for method, kw in (('zoh', {}), ('foh', {}), ('bilinear', {}), ('gbt', {'alpha': 0.3})):
        got = ss.to_discrete(0.1, method=method, **kw)
        ref = jm.lti(*B_A).to_ss().to_discrete(0.1, method=method, **kw)
        assert got.dt == ref.dt == 0.1
        for attr in 'ABCD':
            assert np.array_equal(getattr(got, attr), getattr(ref, attr)), (method, attr)
    want = sps.StateSpace(*sps.tf2ss(*B_A)).to_discrete(0.1)
    got = ss.to_discrete(0.1)
    for attr in 'ABCD':
        assert np.allclose(getattr(got, attr), getattr(want, attr), atol=1e-12)
    assert _error_text(got.to_discrete, 0.1) == \
        _error_text(jm.lti(*B_A).to_ss().to_discrete(0.1).to_discrete, 0.1)
    assert _error_text(tm.lti, [1.0]) == _error_text(jm.lti, [1.0])
    assert _error_text(tm.dlti, 1, 2, 3, 4, 5) == _error_text(jm.dlti, 1, 2, 3, 4, 5)


# ------------------------------------------------------ continuous responses

@pytest.mark.parametrize('form', sorted(SYSTEMS))
@pytest.mark.parametrize('meth', ['step', 'impulse'])
def test_continuous_step_impulse(form, meth):
    mine, ref, sref = _three(form)
    for kw in ({'T': T}, {'N': 64}, {'T': T, 'X0': [0.3, -0.2, 0.1][:mine.to_ss().A.shape[0]]}):
        got = getattr(mine, meth)(**kw)
        _all_close(got, getattr(ref, meth)(**kw))
    _all_close(getattr(mine, meth)(T=T), getattr(sref, meth)(T=T))


@pytest.mark.parametrize('form', sorted(SYSTEMS))
def test_continuous_bode_and_freqresp(form):
    mine, ref, sref = _three(form)
    w = np.logspace(-1, 2, 60)
    _all_close(mine.bode(w=w), ref.bode(w=w))
    _all_close(mine.freqresp(w=w), ref.freqresp(w=w))
    # without w: the reference's own grid (response.py), not scipy's findfreqs
    _all_close(mine.bode(n=50), ref.bode(n=50))
    _all_close(mine.freqresp(n=80), ref.freqresp(n=80))
    got, want = mine.bode(w=w), sref.bode(w=w)
    assert np.allclose(got[0], want[0]) and np.allclose(got[1], want[1], atol=1e-9)
    assert np.allclose(got[2], want[2], atol=1e-9)
    assert np.allclose(mine.freqresp(w=w)[1], sref.freqresp(w=w)[1], atol=1e-12)


@pytest.mark.parametrize('form', sorted(SYSTEMS))
def test_continuous_output(form):
    mine, ref, sref = _three(form)
    U = np.sin(T * 2.0)  # U[0] = 0: the reference's first-order hold starts right (F4)
    got = mine.output(U, T)
    _all_close(got[:2], ref.output(U, T)[:2])
    _all_close(got, sref.output(U, T))


def test_continuous_output_from_a_nonzero_first_input():
    """ROADMAP F4 through the class API: scipy's first-order hold."""
    U = np.random.default_rng(4).standard_normal(T.size)
    X0 = [0.5, -1.0]
    got = tm.lti(*B_A).output(U, T, X0=X0)
    want = sps.lti(*B_A).output(U, T, X0=X0)
    _all_close(got, want)
    jax_y = jm.lti(*B_A).output(U, T, X0=X0)[1]
    assert np.abs(jax_y - want[1]).max() > 1e-6 * np.abs(want[1]).max()


# -------------------------------------------------------- discrete responses

DISCRETE = sps.cont2discrete(sps.tf2ss(*B_A), 0.1)[:4]


@pytest.mark.parametrize('meth', ['step', 'impulse'])
def test_discrete_step_impulse(meth):
    mine, ref = tm.dlti(*DISCRETE, dt=0.1), jm.dlti(*DISCRETE, dt=0.1)
    for kw in ({'N': 50}, {'N': 300, 'X0': [0.2, -0.4]}):
        _all_close(getattr(mine, meth)(**kw), getattr(ref, meth)(**kw))
    t, y = getattr(mine, meth)(N=50)
    ts, ys = getattr(sps.dlti(*DISCRETE, dt=0.1), meth)(n=50)
    _close(t, ts)
    _close(y, np.asarray(ys[0]).ravel())


def test_discrete_output_numpy_and_tensor_paths():
    mine, ref = tm.dlti(*DISCRETE, dt=0.1), jm.dlti(*DISCRETE, dt=0.1)
    u = np.random.default_rng(2).standard_normal(2**12 + 3)
    got = mine.output(u, X0=[1.0, -0.5])
    _all_close(got, ref.output(u, X0=[1.0, -0.5]))
    _all_close(got, sps.dlsim((*DISCRETE, 0.1), u, x0=[1.0, -0.5]), 1e-10)
    ut = dt.from_numpy(u.astype(np.float32))
    t, y, x = mine.output(ut)
    assert isinstance(y, dt.Tensor) and isinstance(x, dt.Tensor)
    assert y.dtype == x.dtype == dt.Dtype.F32 and y.device == ut.device
    rt, ry, rx = ref.output(dsc_tpu.from_numpy(u.astype(np.float32)))
    _close(t, rt)
    _close(y.numpy(), ry.numpy(), TENSOR)
    _close(x.numpy(), rx.numpy(), TENSOR)


@pytest.mark.parametrize('system', ['ss', 'tf biproper', 'zpk biproper'])
def test_discrete_bode_and_freqresp_biproper(system):
    args = {'ss': DISCRETE, 'tf biproper': ([1.0, -0.2], [1.0, 0.5]),
            'zpk biproper': ([0.2], [-0.5], 1.0)}[system]
    mine, ref = tm.dlti(*args, dt=0.1), jm.dlti(*args, dt=0.1)
    _all_close(mine.bode(n=60), ref.bode(n=60))
    _all_close(mine.freqresp(n=60), ref.freqresp(n=60))
    sref = sps.dlti(*args, dt=0.1)
    got, want = mine.bode(n=60), sref.bode(n=60)
    assert np.allclose(got[0], want[0]) and np.allclose(got[1], want[1], atol=1e-9)
    assert np.allclose(got[2], want[2], atol=1e-9)


@pytest.mark.parametrize('system', ['tf', 'zpk', 'ss'])
def test_f9_discrete_strictly_proper(system):
    """ROADMAP F9 through the class API: dlti([1], [1, -0.5], dt=0.1) in each
    form. The port's bode phase equals scipy's within 1e-9 degrees; the
    reference's is off by more than 90 degrees."""
    tf = ([1.0], [1.0, -0.5])
    args = {'tf': tf, 'zpk': sps.tf2zpk(*tf), 'ss': sps.tf2ss(*tf)}[system]
    mine, sref = tm.dlti(*args, dt=0.1), sps.dlti(*args, dt=0.1)
    w, mag, phase = mine.bode(n=4096)
    ws, mags, phases = sref.bode(n=4096)
    assert np.allclose(w, ws, rtol=1e-14)
    assert np.abs(mag - mags).max() <= 1e-9
    assert np.abs(phase - phases).max() <= 1e-9
    _, h = mine.freqresp(n=4096)
    _, hs = sref.freqresp(n=4096)
    assert np.abs(h - hs).max() <= 1e-12 * np.abs(hs).max()
    # every form reaches dfreqresp as to_tf's (num, den), whose normalize
    # strips the numerator's leading zeros
    _, _, phasej = jm.dlti(*args, dt=0.1).bode(n=4096)
    assert np.abs(phasej - phases).max() > 90.0
