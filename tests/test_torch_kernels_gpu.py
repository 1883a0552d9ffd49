"""Each CUDA kernel of dsc_tpu_torch against its plain PyTorch version on the
card (marker ``gpu``; skipped without a CUDA device). Run on a GPU machine
with ``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``
(``--noconftest``: the shared conftest imports the JAX package); the
kernels build with nvcc at first use."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch.fourier import base_fft, plan  # noqa: E402
from dsc_tpu_torch.fourier import packed_fused as pf  # noqa: E402
from dsc_tpu_torch.kernels import build  # noqa: E402

pytestmark = pytest.mark.gpu

REL = 3e-5  # kernel vs plain version, relative to max |plain|


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


@pytest.mark.parametrize('batch', [1, 3, 130])
@pytest.mark.parametrize('n', [256, 1024, 4096])
def test_base_fft_kernel(n, batch):
    rng = np.random.default_rng(n + batch)
    z = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    x = torch.from_numpy(z.astype(np.complex64)).cuda()
    w = plan.get_plan(n, 'complex', torch.complex64)[1]
    before = build.launches['base_fft']
    got = base_fft.fft_base(x, w)
    assert build.launches['base_fft'] == before + 1
    assert _rel(got, base_fft.fft_base_plain(x, w)) < REL


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


def test_public_path_launches_every_kernel():
    sig = np.random.default_rng(1).standard_normal(2**20).astype(np.float32)
    taps = np.blackman(255).astype(np.float32)
    build.reset_launches()
    spec = dt.rfft(dt.from_numpy(sig), n=2**21) * dt.rfft(dt.from_numpy(taps), n=2**21)
    y = dt.irfft(spec)[: 2**20 + 254].numpy()
    small = dt.irfft(dt.rfft(dt.from_numpy(sig[:4096]))).numpy()
    assert all(v > 0 for v in build.launches.values()), build.launches
    ref = np.convolve(sig.astype(np.float64), taps.astype(np.float64))
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-4
    assert np.abs(small - sig[:4096]).max() < 1e-5


def test_unported_routes_raise():
    with pytest.raises(NotImplementedError, match='K6/K8'):
        dt.rfft(dt.from_numpy(np.ones(2**18, np.float32)))
    big = dt.from_numpy(np.ones(2**21, np.float32))
    with pytest.raises(NotImplementedError, match='K5'):
        big * big
