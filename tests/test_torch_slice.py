"""The filterFFT slice of dsc_tpu_torch end to end on CPU tensors: the README
quick start at reduced length through the public API (the packed route's
plain versions at n = 2^20), fft_convolve, the profiler, the routing
decisions (the same for CUDA and CPU tensors), and the import boundary (no
jax)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.models  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch.dtype import Dtype  # noqa: E402
from dsc_tpu_torch.fourier import config  # noqa: E402
from dsc_tpu_torch.ops import kernels as ops_kernels  # noqa: E402
from dsc_tpu_torch.ops import stream_map  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIG_LEN, TAPS, FFT_N = 2**19 - 254, 255, 2**20


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


@pytest.fixture(scope='module')
def inputs():
    sig = np.random.default_rng(7).standard_normal(SIG_LEN).astype(np.float32)
    return sig, np.blackman(TAPS).astype(np.float32)


def _rel(got, ref):
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _quick_start(lib, sig, taps):
    spec = lib.rfft(lib.from_numpy(sig), n=FFT_N) * lib.rfft(lib.from_numpy(taps), n=FFT_N)
    return spec, lib.irfft(spec)[: SIG_LEN + TAPS - 1]


def test_quick_start_matches_reference_and_numpy(inputs):
    sig, taps = inputs
    assert config.rfft_route(Dtype.F32, 1, FFT_N) == 'packed'
    spec, y = _quick_start(dt, sig, taps)
    jspec, jy = _quick_start(dsc_tpu, sig, taps)
    assert spec.shape == jspec.shape == (FFT_N // 2 + 1,)
    assert spec.dtype.name == jspec.dtype.name == 'C32'
    assert _rel(spec.numpy(), jspec.numpy()) < 1e-4
    got = y.numpy()
    assert got.dtype == np.float32 == jy.numpy().dtype
    assert _rel(got, jy.numpy()) < 1e-4
    ref = np.convolve(sig.astype(np.float64), taps.astype(np.float64))
    assert _rel(got, ref) < 1e-4


@pytest.mark.parametrize('mode', ['full', 'same', 'valid'])
def test_fft_convolve_modes(inputs, mode):
    sig, taps = inputs
    got = dt.models.fft_convolve(dt.from_numpy(sig), dt.from_numpy(taps), mode=mode)
    ref = np.convolve(sig.astype(np.float64), taps.astype(np.float64), mode=mode)
    assert got.dtype == Dtype.F32
    assert _rel(got.numpy(), ref) < 1e-4


def test_fft_convolve_batched():
    x = np.random.default_rng(8).standard_normal((3, 500)).astype(np.float32)
    k = np.hanning(31).astype(np.float32)
    got = dt.models.fft_convolve(dt.from_numpy(x), dt.from_numpy(k), mode='same')
    ref = dsc_tpu.models.fft_convolve(dsc_tpu.from_numpy(x), dsc_tpu.from_numpy(k),
                                      mode='same')
    assert got.shape == ref.shape == (3, 500)
    assert _rel(got.numpy(), ref.numpy()) < 1e-5


def test_profile_writes_trace(inputs, tmp_path):
    sig, taps = inputs
    path = tmp_path / 'traces.json'
    with dt.profile(str(path), serve=False):
        _quick_start(dt, sig[:1000], taps)
    events = json.loads(path.read_text())['traceEvents']
    names = [ev['name'] for ev in events]
    for name in ('rfft', 'mul', 'irfft', 'get'):
        assert names.count(name) >= 2  # a begin and an end event each
    begin = next(ev for ev in events if ev['name'] == 'rfft' and ev['ph'] == 'B')
    assert begin['args']['x_backend'] == 'cpu'
    assert begin['args']['x_shape'] == [1000]


@pytest.mark.parametrize('e', range(20, 27))
def test_route_packed_on_cuda(e):
    assert config.rfft_route(Dtype.F32, 1, 2**e) == 'packed'
    assert config.irfft_route(Dtype.C32, 1, 2**e) == 'packed'


def test_route_base_kernel_sizes():
    for e in range(1, 14):
        n = 2**e
        assert config.use_base_kernel(np.complex64, n) == (256 <= n <= 4096)
        assert not config.use_base_kernel(np.complex128, n)
    # rfft n = 4096 packs to a 2048-point base case; n = 2^17 splits 512 x 256
    assert config.rfft_route(Dtype.F32, 1, 4096) == 'core'
    assert dt.fourier.plan.build_spec(2**17)[:3] == ('split', 512, 256)


@pytest.mark.parametrize('e', [18, 19])
def test_route_single_rfft_half_t(e):
    """The single rfft off the packed range lands in the half-T layout
    (K6 + K8), on any device; its inverse reads it (K9 + K10), and a dense
    spectrum's takes K11 + K6/K7, as in the JAX package."""
    assert config.rfft_route(Dtype.F32, 1, 2**e) == 'stream_t'
    half = (*dt.fourier.stream.factors(2**e), True)
    assert config.irfft_route(Dtype.C32, 1, 2**e, layout=half) == 'stream_t'
    assert config.irfft_route(Dtype.C32, 1, 2**e) == 'reconstruct+stream'
    x = np.random.default_rng(e).standard_normal(2**e).astype(np.float32)
    spec = dt.rfft(dt.from_numpy(x))
    assert spec._layout == half and spec.shape == (2**(e - 1) + 1,)
    assert _rel(dt.irfft(spec).numpy(), x) < 1e-5


def test_route_engines_named_on_any_device():
    """Every other route names its engine on any device."""
    assert config.rfft_route(Dtype.F32, 8, 2**20) == 'stream'
    assert config.fft_route(Dtype.C32, 1, 2**21, inverse=False) == 'stream_t'
    assert config.fft_route(Dtype.C32, 1, 2**21, inverse=True) == 'stream'
    assert config.fft_route(Dtype.C32, 1, 2**21, inverse=True,
                            layout=(2048, 1024, False)) == 'stream_t'
    # complex128: the plain reconstruction (K11 is complex64 only) and core
    assert config.irfft_route(Dtype.C64, 1, 2**18) == 'core'
    # elementwise routes are device-independent: K5 where the JAX package
    # streams, plain PyTorch (never a raise) where it runs XLA
    f32 = torch.empty(2**21)
    c64 = torch.empty(2**20 + 1, dtype=torch.complex64)  # the 2^21 spectra
    assert ops_kernels.streams('mul', f32, f32)
    assert not ops_kernels.streams('add', f32.double(), f32.double())
    assert not ops_kernels.streams('mul', c64, c64)
    assert ops_kernels.streams('mul', torch.empty(2**23 + 1, dtype=torch.complex64), 2.0)
    assert not stream_map.eligible([(2048, 1), (1, 2048)], [torch.float32] * 2)
    assert config.fft_route(Dtype.C64, 1, 2**21, inverse=False) == 'core'
    assert config.irfft_route(Dtype.C32, 1, 2**16) == 'core'


def test_import_loads_no_jax():
    code = 'import sys, dsc_tpu_torch; print("jax" in sys.modules)'
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == 'False'
