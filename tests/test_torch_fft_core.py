"""The port's plain FFT core (Stockham / four-step, dsc_tpu_torch/fourier/core.py)
through its public functions on CPU tensors, against dsc_tpu's public
functions on the CPU (its XLA path), n = 2 .. 2^17."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch.fourier import plan as fft_plan  # noqa: E402

# relative to max |X|: float32 / float64 working precision
TOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-9, np.complex128: 1e-9}


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


def _rand(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if np.dtype(dtype).kind == 'c':
        x = x + 1j * rng.standard_normal(n)
    return x.astype(dtype)


def _check(got, ref, dtype):
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err < TOL[dtype], err


# (input length, transform n): pow2 sizes over the range plus pad/crop cases
RFFT_CASES = [(2, -1), (16, -1), (256, -1), (1000, -1), (4096, -1),
              (5000, 8192), (2**16, -1), (2**17, -1)]


@pytest.mark.parametrize('m,n', RFFT_CASES)
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_rfft_irfft_match_reference(m, n, dtype):
    x = _rand(m, dtype, m)
    spec = dt.rfft(dt.from_numpy(x), n=n)
    ref = dsc_tpu.rfft(dsc_tpu.from_numpy(x), n=n)
    _check(spec.numpy(), ref.numpy(), dtype)
    back = dt.irfft(spec).numpy()
    _check(back, dsc_tpu.irfft(ref).numpy(), dtype)


FFT_CASES = [(4, np.complex64), (512, np.complex64), (8192, np.complex64),
             (2**17, np.complex64), (64, np.complex128), (2**17, np.complex128),
             (1024, np.float32), (300, np.float64)]


@pytest.mark.parametrize('m,dtype', FFT_CASES)
def test_fft_ifft_match_reference(m, dtype):
    x = _rand(m, dtype, m + 1)
    ctype = np.complex64 if dtype in (np.float32, np.complex64) else np.complex128
    for name in ('fft', 'ifft'):
        got = getattr(dt, name)(dt.from_numpy(x)).numpy()
        ref = getattr(dsc_tpu, name)(dsc_tpu.from_numpy(x)).numpy()
        _check(got, ref, ctype)


@pytest.mark.parametrize('axis', [0, 1])
def test_axis_and_batch(axis):
    x = _rand(48 * 40, np.float32, 3).reshape(48, 40)
    got = dt.rfft(dt.from_numpy(x), axis=axis)
    ref = dsc_tpu.rfft(dsc_tpu.from_numpy(x), axis=axis)
    _check(got.numpy(), ref.numpy(), np.float32)
    _check(dt.irfft(got, axis=axis).numpy(),
           dsc_tpu.irfft(ref, axis=axis).numpy(), np.float32)
    c = (x + 1j).astype(np.complex64)
    _check(dt.fft(dt.from_numpy(c), axis=axis).numpy(),
           dsc_tpu.fft(dsc_tpu.from_numpy(c), axis=axis).numpy(), np.complex64)


@pytest.mark.parametrize('m,n', [(1000, -1), (1024, 300), (7, -1), (513, -1), (300, -1)])
def test_shape_rules(m, n):
    """rfft out n/2+1 of the pow2 size; irfft out 2*next_pow2(len-1)."""
    x = _rand(m, np.float32, 4)
    assert dt.rfft(dt.from_numpy(x), n=n).shape == \
        dsc_tpu.rfft(dsc_tpu.from_numpy(x), n=n).shape
    c = _rand(m, np.complex64, 5)
    got = dt.irfft(dt.from_numpy(c), n=n)
    assert got.shape == dsc_tpu.irfft(dsc_tpu.from_numpy(c), n=n).shape
    nn = n if n > 0 else m
    assert got.shape == (2 * fft_plan.next_pow2(nn - 1),)
    assert got.dtype == dt.Dtype.F32


def test_freqs_match_reference():
    for n in (1, 8, 9):
        for name in ('fftfreq', 'rfftfreq'):
            got = getattr(dt, name)(n, 0.5).numpy()
            ref = getattr(dsc_tpu, name)(n, 0.5).numpy()
            assert got.shape == ref.shape and got.dtype == ref.dtype
            np.testing.assert_allclose(got, ref, rtol=1e-7)


def test_plan_cache_is_a_bounded_lru():
    dt.clear()
    made = []
    for e in range(1, 13):
        for kind in ('complex', 'real'):
            dt.plan_fft(2**e, dt.Dtype.F32, kind)
            made.append((2**e, kind))
    assert len(made) > fft_plan.MAX_FFT_PLANS
    assert fft_plan.num_plans() == fft_plan.MAX_FFT_PLANS
    # the oldest plans went first
    assert [k[:2] for k in fft_plan._plans] == made[-fft_plan.MAX_FFT_PLANS:]
    # a hit moves a plan to the newest end
    dt.plan_fft(made[-fft_plan.MAX_FFT_PLANS][0], dt.Dtype.F32,
                made[-fft_plan.MAX_FFT_PLANS][1])
    assert list(fft_plan._plans)[-1][:2] == made[-fft_plan.MAX_FFT_PLANS]
    dt.clear()
    assert fft_plan.num_plans() == 0
