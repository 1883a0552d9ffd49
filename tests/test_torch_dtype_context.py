"""dsc_tpu_torch dtypes and context against the JAX package's contract
(dsc_tpu/dtype.py, tests/test_context.py)."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch import context as ctx_mod  # noqa: E402
from dsc_tpu_torch.fourier import plan as fft_plan  # noqa: E402

PAIRS = [(a, b) for a in dt.Dtype for b in dt.Dtype]


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    yield
    dt.shutdown()


@pytest.mark.parametrize('a,b', PAIRS, ids=[f'{a}-{b}' for a, b in PAIRS])
def test_promotion_table_matches_reference(a, b):
    ref = dsc_tpu.dtype.promote(dsc_tpu.Dtype[a.name], dsc_tpu.Dtype[b.name])
    assert dt.dtype.promote(a, b).name == ref.name


def test_double_init_raises():
    with pytest.raises(RuntimeError):
        dt.init(2**20, device='cpu')


def test_used_mem_tracks_buffers():
    before = dt.used_mem()
    t = dt.from_numpy(np.zeros((256, 256), np.float32))  # 256 KiB
    assert dt.used_mem() - before == 256 * 256 * 4
    del t
    gc.collect()
    assert dt.used_mem() == before


def test_views_share_accounting():
    before = dt.used_mem()
    t = dt.from_numpy(np.zeros((64, 64), np.float32))
    v = t.reshape(4096)
    assert v.shape == (4096,)
    assert dt.used_mem() - before == 64 * 64 * 4
    del t, v
    gc.collect()
    assert dt.used_mem() == before


def test_clear_contract_live_tensors_survive():
    before = dt.used_mem()
    t = dt.from_numpy(np.ones((64, 64), dtype=np.float32))
    dt.plan_fft(1024)
    assert fft_plan.num_plans() > 0
    dt.clear()
    assert fft_plan.num_plans() == 0
    assert dt.used_mem() - before == 64 * 64 * 4
    assert float(t.numpy().sum()) == 64 * 64
    del t


def test_alloc_cap_fails_fast():
    ctx = ctx_mod._get_ctx()
    with pytest.raises(MemoryError):
        ctx.alloc(ctx.main_mem + 1)
    before = dt.used_mem()
    with pytest.raises(MemoryError):
        dt.from_numpy(np.zeros(ctx.main_mem // 4 + 1, np.float32))
    assert dt.used_mem() == before


def test_print_mem_usage(capsys):
    dt.print_mem_usage()
    out = capsys.readouterr().out
    assert 'bytes' in out and 'cpu' in out


def test_manual_seed_reproducible():
    dt.manual_seed(1234)
    a = dt.randn(32).numpy()
    dt.manual_seed(1234)
    b = dt.randn(32).numpy()
    assert a.shape == (32,) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_cuda_device_is_not_replaced_by_cpu():
    """init(device='cuda') keeps the CUDA device; without a card the first
    allocation raises instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the allocation would succeed')
    dt.shutdown()
    try:
        dt.init(2**20, device='cuda')
        assert ctx_mod.device().type == 'cuda'
        with pytest.raises((RuntimeError, AssertionError)):
            dt.from_numpy(np.zeros(4, np.float32))
    finally:
        dt.shutdown()
        dt.init(2**32, device='cpu')
