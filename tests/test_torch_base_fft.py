"""K12's plain version (dsc_tpu_torch/fourier/base_fft.py) against the JAX
package's Pallas base-case kernel, run in interpret mode on the CPU
(dsc_tpu/fourier/pallas_kernels.py fft_base_planar)."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu.fourier import pallas_kernels  # noqa: E402
from dsc_tpu_torch.fourier import base_fft, plan  # noqa: E402


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
