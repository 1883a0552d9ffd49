"""The sharded tier of dsc_tpu_torch (parallel/) against the JAX package's
(dsc_tpu/parallel) on the same numpy inputs, and the two per-shard kernel
sites it runs, K6 local and K7 local (fourier/stream.py phase_a_local /
phase_b_local), against ``pallas_stream.phase_a_local_p`` /
``phase_b_local_p`` called directly in interpret mode.

The port's meshes here are eight entries of the CPU beside the JAX
package's 8-device host mesh (tests/conftest.py), in the layouts of
tests/test_sharding.py. The JAX results are computed once per module.

Bounds, relative to max |reference|: 3e-5 against the JAX package (its
streaming kernels' bf16x3 DFT stages are good to about 1e-5; as
tests/test_torch_fourstep_stream.py), 1e-5 for the local kernels and
1e-4 for the public functions against np.fft in float64.
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu import parallel as jpar  # noqa: E402
from dsc_tpu.fourier import config as jcfg  # noqa: E402
from dsc_tpu.fourier import pallas_stream as jps  # noqa: E402
from dsc_tpu_torch import parallel as tpar  # noqa: E402
from dsc_tpu_torch.entry import dryrun_multichip  # noqa: E402
from dsc_tpu_torch.fourier import plan, stream  # noqa: E402
from dsc_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dsc_tpu_torch.parallel import sharded_fft  # noqa: E402

JAX_BOUND = 3e-5
LOCAL_NUMPY_BOUND = 1e-5
NUMPY_BOUND = 1e-4

# the local sites: n_total = 2^18 split 512 x 512 over d = 2
N_TOTAL, N1, N2, D = 2**18, 512, 512, 2
COL0S = (0, N2 // D)
CPU8 = [torch.device('cpu')] * 8

def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _local_inputs():
    rng = np.random.default_rng(18)
    x = rng.standard_normal((N1, N2)) + 1j * rng.standard_normal((N1, N2))
    z = rng.standard_normal((N2, N1 // D)) + 1j * rng.standard_normal((N2, N1 // D))
    return x.astype(np.complex64), z.astype(np.complex64)


def _cvec(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


# the public cases: name -> (JAX mesh shape, axis names, input, call of a
# parallel package with (x, mesh), float64 reference)
def _public_cases():
    rng = np.random.default_rng(8)
    b16 = (rng.standard_normal((16, 256)) + 1j * rng.standard_normal((16, 256))).astype(
        np.complex64)
    b2 = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))).astype(
        np.complex64)
    b4 = (rng.standard_normal((4, 1024)) + 1j * rng.standard_normal((4, 1024))).astype(
        np.complex64)
    v = _cvec(7, 2**20)
    r = rng.standard_normal(2**20).astype(np.float32)
    rows = rng.standard_normal((8, 2**18)).astype(np.float32)
    v64, r64 = v.astype(np.complex128), r.astype(np.float64)
    spec = np.fft.rfft(r64)
    return {
        'sharded_batched_fft': ((8, 1), b16, lambda p, x, m: p.sharded_batched_fft(
            p.shard_batch(x, m), m), np.fft.fft(b16.astype(np.complex128))),
        'sharded_batched_fft inverse': ((8, 1), b16, lambda p, x, m: p.sharded_batched_fft(
            x, m, inverse=True), np.fft.ifft(b16.astype(np.complex128))),
        'distributed_fft (1, 8)': ((1, 8), b2, lambda p, x, m: p.distributed_fft(x, m),
                                   np.fft.fft(b2.astype(np.complex128))),
        'distributed_fft (1, 8) inverse': (
            (1, 8), np.fft.fft(b2.astype(np.complex128)).astype(np.complex64),
            lambda p, x, m: p.distributed_fft(x, m, inverse=True), b2.astype(np.complex128)),
        'distributed_fft (2, 4)': ((2, 4), b4, lambda p, x, m: p.distributed_fft(x, m),
                                   np.fft.fft(b4.astype(np.complex128))),
        'distributed_fft_stream (2, 4)': ((2, 4), v, lambda p, x, m: p.distributed_fft_stream(
            x, m), np.fft.fft(v64)),
        'distributed_fft_stream (2, 4) inverse': (
            (2, 4), np.fft.fft(v64).astype(np.complex64),
            lambda p, x, m: p.distributed_fft_stream(x, m, inverse=True), v64),
        'distributed_rfft_stream (4, 2)': ((4, 2), r, lambda p, x, m: p.distributed_rfft_stream(
            x, m), spec),
        'distributed_irfft_stream (4, 2)': (
            (4, 2), spec.astype(np.complex64),
            lambda p, x, m: p.distributed_irfft_stream(x, m), r64),
        'sharded_batched_rfft (8, 1)': ((8, 1), rows, lambda p, x, m: p.sharded_batched_rfft(
            x, m), np.fft.rfft(rows.astype(np.float64))),
    }


PUBLIC = _public_cases()


@pytest.fixture(scope='module')
def jax_results():
    """The JAX package's local kernels (interpret mode) and public
    functions on the 8-device host mesh, once."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')
    out = {}
    x, z = _local_inputs()
    n2d = N2 // D

    for inverse in (False, True):
        def pa(xr, xi, col0, inverse=inverse):
            return jps.phase_a_local_p(xr, xi, N1, N_TOTAL, col0, inverse)

        fa = jax.jit(pa)
        for col0 in COL0S:
            blk = x[:, col0:col0 + n2d]
            zr, zi = fa(blk.real.copy(), blk.imag.copy(), jnp.int32(col0))
            out['a', col0, inverse] = np.asarray(zr) + 1j * np.asarray(zi)
        for real_output in (False, True):
            yr, yi = jax.jit(lambda zr, zi, inverse=inverse, ro=real_output: jps.phase_b_local_p(
                zr, zi, N2, N_TOTAL, inverse, real_output=ro))(z.real.copy(), z.imag.copy())
            out['b', inverse, real_output] = (np.asarray(yr) if real_output
                                              else np.asarray(yr) + 1j * np.asarray(yi))
    old = jcfg.STREAM_MODE
    try:
        for name, (shape, x_in, call, _) in PUBLIC.items():
            # the JAX package's streaming rows run interpret-mode kernels
            jcfg.STREAM_MODE = 'on' if 'batched_rfft' in name else old
            out[name] = np.asarray(call(jpar, jnp.asarray(x_in), jpar.make_mesh(shape)))
    finally:
        jcfg.STREAM_MODE = old
    # the compiles leave a large heap that the gc.collect() after every test
    # (tests/conftest.py) would otherwise rescan each time
    gc.freeze()
    yield out
    gc.unfreeze()


def _tables():
    return plan.get_plan(N_TOTAL, 'stream', torch.complex64, torch.device('cpu'))[1]


# ---------------------------------------------------------------------------
# the two local kernel sites
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('inverse', [False, True])
@pytest.mark.parametrize('col0', COL0S)
def test_phase_a_local_matches_jax_and_numpy(col0, inverse, jax_results):
    x, _ = _local_inputs()
    n2d = N2 // D
    blk = torch.from_numpy(np.ascontiguousarray(x[:, col0:col0 + n2d]))
    t = _tables()
    got = stream.phase_a_local_plain(blk, t, col0, inverse)
    assert got.shape == (n2d, N1) and got.dtype == torch.complex64
    # the wrapper takes the plain version on a CPU tensor
    assert torch.equal(stream.phase_a_local(blk, t, col0, inverse), got)
    assert _rel(got.numpy(), jax_results['a', col0, inverse]) < JAX_BOUND
    # Z[j, k1] = W_n^(s*k1*(col0 + j)) * DFT_n1 of column col0 + j
    s = 1 if inverse else -1
    b64 = x[:, col0:col0 + n2d].astype(np.complex128)
    cols = np.fft.ifft(b64, axis=0) * N1 if inverse else np.fft.fft(b64, axis=0)
    k1, j = np.arange(N1)[:, None], (col0 + np.arange(n2d))[None, :]
    ref = (cols * np.exp(s * 2j * np.pi * k1 * j / N_TOTAL)).T
    assert _rel(got.numpy(), ref) < LOCAL_NUMPY_BOUND


def test_phase_a_local_offset_is_global():
    """col0 moves the twiddle: the block at col0 != 0 differs from the same
    block taken as column 0, by exactly the twiddle ratio."""
    x, _ = _local_inputs()
    t = _tables()
    blk = torch.from_numpy(np.ascontiguousarray(x[:, 256:384]))
    at0 = stream.phase_a_local_plain(blk, t, 0, False).numpy().astype(np.complex128)
    at = stream.phase_a_local_plain(blk, t, 256, False).numpy().astype(np.complex128)
    ratio = np.exp(-2j * np.pi * np.arange(N1)[None, :] * 256 / N_TOTAL)
    assert np.abs(at0 - at).max() > 1.0
    assert np.abs(at - at0 * ratio).max() / np.abs(at).max() < 1e-5


def test_phase_a_local_real_input_and_bounds():
    x, _ = _local_inputs()
    t = _tables()
    re = torch.from_numpy(np.ascontiguousarray(x.real[:, :256]))
    got = stream.phase_a_local(re, t, 256, False)
    assert torch.equal(got, stream.phase_a_local_plain(re.to(torch.complex64), t, 256, False))
    with pytest.raises(ValueError, match='column'):
        stream.phase_a_local_plain(re, t, 300, False)


@pytest.mark.parametrize('real_output', [False, True])
@pytest.mark.parametrize('inverse', [False, True])
def test_phase_b_local_matches_jax_and_numpy(inverse, real_output, jax_results):
    _, z = _local_inputs()
    t = _tables()
    zt = torch.from_numpy(z)
    got = stream.phase_b_local_plain(zt, t, N1 // D, inverse, real_output)
    assert got.shape == (N2, N1 // D)
    assert got.dtype == (torch.float32 if real_output else torch.complex64)
    assert torch.equal(stream.phase_b_local(zt, t, N1 // D, inverse, real_output), got)
    assert _rel(got.numpy(), jax_results['b', inverse, real_output]) < JAX_BOUND
    z64 = z.astype(np.complex128)
    # the inverse is scaled by 1/n_total, not by 1 over the block's length
    ref = np.fft.ifft(z64, axis=0) * N2 / N_TOTAL if inverse else np.fft.fft(z64, axis=0)
    assert _rel(got.numpy(), ref.real if real_output else ref) < LOCAL_NUMPY_BOUND


@pytest.mark.parametrize('n1,n2,d,ok', [
    (1024, 1024, 4, True), (1024, 1024, 2, True), (512, 512, 2, True),
    (512, 512, 4, False),       # 128-wide local blocks: one tile
    (1024, 1024, 8, False),     # one tile
    (4096, 2048, 4, True), (4096, 4096, 8, True), (8192, 8192, 16, True),
    (1024, 512, 3, False),      # not divisible
    (1024, 768, 2, False),      # not a power of two
    (256, 256, 1, False),       # below the single-device FACTOR_MIN rows
    (1024, 512, 1, True),
])
def test_dist_supported_is_the_jax_rule(n1, n2, d, ok):
    assert stream.dist_supported(n1, n2, d, np.complex64) is ok
    assert stream.dist_supported(n1, n2, d, torch.complex64) is ok
    assert jps.dist_supported(n1, n2, d, np.complex64) is ok
    assert not stream.dist_supported(n1, n2, d, np.complex128)
    assert not stream.dist_supported(n1, n2, d, torch.float32)


# ---------------------------------------------------------------------------
# the public functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('name', list(PUBLIC))
def test_public_matches_jax_and_numpy(name, jax_results):
    shape, x_in, call, ref = PUBLIC[name]
    mesh = tpar.make_mesh(shape, devices=CPU8)
    got = call(tpar, torch.from_numpy(x_in), mesh)
    assert isinstance(got, tmesh.Sharded)
    g = np.asarray(got)
    assert g.shape == ref.shape
    assert _rel(g, jax_results[name]) < JAX_BOUND
    assert _rel(g, ref) < NUMPY_BOUND


def test_public_names():
    import dsc_tpu.parallel as jp

    assert tpar.__all__ == jp.__all__
    assert all(callable(getattr(tpar, name)) for name in tpar.__all__)
    assert dt.make_mesh is tpar.make_mesh and 'make_mesh' in dt.__all__


def _entangle_ifft(spec: np.ndarray) -> np.ndarray:
    """The irfft of the JAX package's distributed_irfft_stream in float64:
    Z[k] = E[k] + i conj(w_k) D[k] with the mirror X[h-k] (X[h] at k = 0),
    z = IFFT_h(Z), x[2t] = Re z[t], x[2t+1] = Im z[t]. Unlike np.fft.irfft
    it keeps the imaginary parts of X[0] and X[h]."""
    h = spec.shape[0] - 1
    x = spec.astype(np.complex128)
    m = x[::-1]
    w = np.exp(-2j * np.pi * np.arange(h + 1) / (2 * h))
    z = 0.5 * (x + m.conj()) + 1j * (w.conj() * 0.5 * (x - m.conj()))
    y = np.fft.ifft(z[:h])
    return np.stack([y.real, y.imag], axis=-1).reshape(2 * h)


@pytest.mark.parametrize('n,d', [(2**21, 4), (2**20, 2), (2**19, 2)])
def test_rfft_stream_mirror_across_shards(n, d):
    """The untangle's mirror straddles shards (partner block d-1-j and a
    column of block d-j) and folds k = 0 onto k = h: rfft -> irfft against
    np.fft on a (1, d) mesh, the irfft also of a spectrum whose bins 0 and
    n/2 are not real, which the entangle takes as they are."""
    mesh = tpar.make_mesh((1, d), devices=[torch.device('cpu')] * d)
    x = np.random.default_rng(n + d).standard_normal(n).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64))
    got = tpar.distributed_rfft_stream(x, mesh)
    assert _rel(got, ref) < NUMPY_BOUND
    back = np.asarray(tpar.distributed_irfft_stream(got, mesh))
    assert back.shape == (n,) and np.abs(back - x).max() < NUMPY_BOUND
    wild = ref.astype(np.complex64).copy()
    wild[0] += 0.5j * np.abs(ref).max()
    wild[-1] -= 0.25j * np.abs(ref).max()
    assert _rel(tpar.distributed_irfft_stream(wild, mesh), _entangle_ifft(wild)) < NUMPY_BOUND


@pytest.mark.parametrize('d', [1, 2, 4])
def test_fft_stream_each_mesh_width(d):
    mesh = tpar.make_mesh((1, d), devices=[torch.device('cpu')] * d)
    v = _cvec(d, 2**20)
    got = tpar.distributed_fft_stream(v, mesh)
    assert _rel(got, np.fft.fft(v.astype(np.complex128))) < NUMPY_BOUND


def test_local_calls_at_d4(monkeypatch):
    """distributed_fft_stream over 4 devices: 4 local K6 calls at col0 = 0,
    n2/4, 2*n2/4, 3*n2/4 and 4 local K7 calls of n1/4 columns."""
    calls_a, calls_b = [], []
    real_a, real_b = stream.phase_a_local, stream.phase_b_local

    def spy_a(x, t, col0, inverse):
        calls_a.append((tuple(x.shape), col0, inverse))
        return real_a(x, t, col0, inverse)

    def spy_b(z, t, n1_local, inverse, real_output=False):
        calls_b.append((tuple(z.shape), n1_local, inverse, real_output))
        return real_b(z, t, n1_local, inverse, real_output)

    monkeypatch.setattr(stream, 'phase_a_local', spy_a)
    monkeypatch.setattr(stream, 'phase_b_local', spy_b)
    n1, n2 = stream.factors(2**20)
    mesh = tpar.make_mesh((1, 4), devices=[torch.device('cpu')] * 4)
    tpar.distributed_fft_stream(_cvec(3, 2**20), mesh)
    assert calls_a == [((n1, n2 // 4), i * n2 // 4, False) for i in range(4)]
    assert calls_b == [((n2, n1 // 4), n1 // 4, False, False)] * 4
    # a (2, 4) mesh runs each 'model' group: every offset twice
    calls_a.clear(), calls_b.clear()
    tpar.distributed_fft_stream(_cvec(3, 2**20), tpar.make_mesh((2, 4), devices=CPU8),
                                inverse=True)
    assert sorted(c[1] for c in calls_a) == sorted([i * n2 // 4 for i in range(4)] * 2)
    assert len(calls_b) == 8 and all(c[2] for c in calls_a + calls_b)


def test_sharded_input_is_not_moved():
    """A Sharded value laid out as the function needs is used where it
    lies; another is gathered and placed again."""
    n = 2**20
    n1, n2 = stream.factors(n)
    assert n1 == n2
    mesh = tpar.make_mesh((1, 4), devices=[torch.device('cpu')] * 4)
    v = _cvec(5, n)
    spec = tpar.distributed_fft_stream(v, mesh)
    assert sharded_fft._place(spec, mesh, 'model', 1, (n1, n2), (n,)) is spec
    back = tpar.distributed_fft_stream(spec, mesh, inverse=True)
    assert np.abs(np.asarray(back) - v).max() < NUMPY_BOUND
    # another mesh of the same devices: placed anew
    other = tpar.make_mesh((1, 4), devices=[torch.device('cpu')] * 4)
    assert sharded_fft._place(spec, other, 'model', 1, (n1, n2), (n,)) is not spec
    rows = tpar.shard_batch(np.ones((8, 4), np.float32), tpar.make_mesh((4, 2), devices=CPU8))
    assert [tuple(s.shape) for s in rows.shards] == [(2, 4)] * 8
    assert np.array_equal(np.asarray(rows), np.ones((8, 4), np.float32))


def test_mesh_layout():
    mesh = tpar.make_mesh((2, 4), devices=CPU8)
    assert mesh.shape['data'] == 2 and mesh.shape['model'] == 4
    assert dict(mesh.shape) == {'data': 2, 'model': 4} and mesh.size == 8
    assert mesh.groups('model') == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups('data') == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert tpar.make_mesh(devices=CPU8).shape['data'] == 8


def test_make_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tpar.make_mesh()


@pytest.mark.parametrize('shape', [(3, 1), (2, 2), (8, 2)])
def test_make_mesh_shape_must_match(shape):
    with pytest.raises(RuntimeError, match='mesh shape'):
        tpar.make_mesh(shape, devices=CPU8)


@pytest.mark.parametrize('case', ['not streamable', 'complex128', 'not 1-D', 'odd n',
                                  'rfft not 1-D', 'irfft not 1-D', 'rfft not streamable',
                                  'split', 'batch'])
def test_error_paths(case):
    mesh = tpar.make_mesh((2, 4), devices=CPU8)
    calls = {
        'not streamable': (lambda: tpar.distributed_fft_stream(_cvec(0, 2**16), mesh),
                           'not streamable over 4 devices'),
        'complex128': (lambda: tpar.distributed_fft_stream(
            _cvec(0, 2**20).astype(np.complex128), mesh), 'need complex64'),
        'not 1-D': (lambda: tpar.distributed_fft_stream(np.zeros((2, 2**19), np.complex64),
                                                        mesh), 'expects a single'),
        'odd n': (lambda: tpar.distributed_rfft_stream(np.zeros(2**20 + 1, np.float32), mesh),
                  'n must be even'),
        'rfft not 1-D': (lambda: tpar.distributed_rfft_stream(np.zeros((2, 4), np.float32),
                                                              mesh), 'expects a single'),
        'irfft not 1-D': (lambda: tpar.distributed_irfft_stream(
            np.zeros((2, 4), np.complex64), mesh), 'expects a single'),
        'rfft not streamable': (lambda: tpar.distributed_rfft_stream(
            np.zeros(2**16, np.float32), mesh), 'is not streamable'),
        'split': (lambda: tpar.distributed_fft(np.zeros((1, 8), np.complex64), mesh),
                  'divisible by the mesh axis size'),
        'batch': (lambda: tpar.sharded_batched_fft(np.zeros((3, 64), np.complex64), mesh),
                  'not divisible by the mesh axis'),
    }
    fn, msg = calls[case]
    with pytest.raises(RuntimeError, match=msg):
        fn()


def test_dryrun_multichip_on_the_cpu(capsys):
    dryrun_multichip(8, device='cpu')
    assert 'dryrun_multichip OK' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the batch cut over a tuple of mesh axes
# ---------------------------------------------------------------------------

AXIS_TUPLES = [('data', 'model'), ('model', 'data')]
TUPLE_MESHES = [(4, 2), (2, 4)]


def _tuple_inputs():
    rng = np.random.default_rng(21)
    rows = (rng.standard_normal((16, 256)) + 1j * rng.standard_normal((16, 256))).astype(
        np.complex64)
    return {'shard_batch': rng.standard_normal((16, 8, 3)).astype(np.float32),
            'sharded_batched_fft': rows,
            'sharded_batched_rfft': rng.standard_normal((16, 512)).astype(np.float32)}


TUPLE_INPUTS = _tuple_inputs()
TUPLE_REFS = {'shard_batch': TUPLE_INPUTS['shard_batch'].astype(np.float64),
              'sharded_batched_fft': np.fft.fft(
                  TUPLE_INPUTS['sharded_batched_fft'].astype(np.complex128)),
              'sharded_batched_rfft': np.fft.rfft(
                  TUPLE_INPUTS['sharded_batched_rfft'].astype(np.float64))}


@pytest.fixture(scope='module')
def jax_tuple_results():
    """The JAX package's three batch functions with an axis tuple: the
    global value and each device's block, by mesh position."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')
    out = {}
    for shape in TUPLE_MESHES:
        jmesh = jpar.make_mesh(shape)
        jdevices = list(jmesh.devices.flat)
        for axis in AXIS_TUPLES:
            for name, x in TUPLE_INPUTS.items():
                arr = getattr(jpar, name)(jnp.asarray(x), jmesh, axis=axis)
                blocks = [None] * len(jdevices)
                for shard in arr.addressable_shards:
                    blocks[jdevices.index(shard.device)] = np.asarray(shard.data)
                out[name, shape, axis] = (np.asarray(arr), blocks, arr.sharding.spec)
    return out


@pytest.mark.parametrize('axis', AXIS_TUPLES, ids='-'.join)
@pytest.mark.parametrize('shape', TUPLE_MESHES)
@pytest.mark.parametrize('name', list(TUPLE_INPUTS))
def test_batch_cut_over_an_axis_tuple(name, shape, axis, jax_tuple_results):
    """The block on port device i is the JAX array's block on JAX device
    i: block c_a * |b| + c_b at coordinates (c_a, c_b) of the tuple (a, b)."""
    mesh = tpar.make_mesh(shape, devices=CPU8)
    x = TUPLE_INPUTS[name]
    got = getattr(tpar, name)(torch.from_numpy(x), mesh, axis=axis)
    ref, blocks, spec = jax_tuple_results[name, shape, axis]
    assert spec[0] == axis
    assert isinstance(got, tmesh.Sharded) and got.axis == axis and got.dim == 0
    rows = x.shape[0] // 8
    for i, (mine, theirs) in enumerate(zip(got.shards, blocks)):
        c = dict(zip(mesh.axis_names, np.unravel_index(i, shape)))
        block = c[axis[0]] * mesh.shape[axis[1]] + c[axis[1]]
        assert tuple(mine.shape) == theirs.shape and mine.shape[0] == rows
        assert _rel(mine.numpy(), theirs) < JAX_BOUND
        assert _rel(mine.numpy(), TUPLE_REFS[name][rows * block:rows * (block + 1)]) < NUMPY_BOUND
    g = np.asarray(got)
    assert _rel(g, ref) < JAX_BOUND and _rel(g, TUPLE_REFS[name]) < NUMPY_BOUND


def test_tuple_sharded_input_is_not_moved(monkeypatch):
    """A Sharded value cut over the tuple the function asks for is used
    where it lies; over the other order it is gathered and placed anew."""
    mesh = tpar.make_mesh((4, 2), devices=CPU8)
    x = TUPLE_INPUTS['sharded_batched_fft']
    placed = tpar.shard_batch(x, mesh, axis=('data', 'model'))
    assert sharded_fft._place(placed, mesh, ('data', 'model'), 0, x.shape, x.shape) is placed
    assert sharded_fft._place(placed, mesh, ('model', 'data'), 0, x.shape, x.shape) is not placed
    gathers = []
    full = tmesh.Sharded.full
    monkeypatch.setattr(tmesh.Sharded, 'full', lambda self: gathers.append(self) or full(self))
    got = tpar.sharded_batched_fft(placed, mesh, axis=('data', 'model'))
    back = tpar.sharded_batched_fft(got, mesh, inverse=True, axis=('data', 'model'))
    assert gathers == []
    monkeypatch.setattr(tmesh.Sharded, 'full', full)
    assert _rel(np.asarray(back), x) < NUMPY_BOUND


@pytest.mark.parametrize('name', ['distributed_fft', 'distributed_fft_stream',
                                  'distributed_rfft_stream', 'distributed_irfft_stream'])
def test_transform_sharding_over_an_axis_tuple_raises(name):
    """The transform-sharded calls split over one mesh axis: a tuple raises
    in both packages (KeyError from mesh.shape in the JAX package)."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')
    x = {'distributed_fft': np.zeros((2, 4096), np.complex64),
         'distributed_fft_stream': np.zeros(2**20, np.complex64),
         'distributed_rfft_stream': np.zeros(2**20, np.float32),
         'distributed_irfft_stream': np.zeros(2**19 + 1, np.complex64)}[name]
    for axis in AXIS_TUPLES:
        with pytest.raises(KeyError):
            getattr(jpar, name)(jnp.asarray(x), jpar.make_mesh((4, 2)), axis=axis)
        with pytest.raises(RuntimeError, match='split over one mesh axis'):
            getattr(tpar, name)(x, tpar.make_mesh((4, 2), devices=CPU8), axis=axis)


def test_mesh_groups_and_axis_size_of_a_tuple():
    mesh = tpar.make_mesh((4, 2), devices=CPU8)
    assert mesh.axis_size(('data', 'model')) == mesh.axis_size(('model', 'data')) == 8
    assert mesh.axis_size('model') == 2 and mesh.axis_size(('data',)) == 4
    assert mesh.groups(('data', 'model')) == [list(range(8))]
    # flat index p = c_model * 4 + c_data holds the device at (c_data, c_model)
    assert mesh.groups(('model', 'data')) == [[0, 2, 4, 6, 1, 3, 5, 7]]
    assert mesh.groups(('data',)) == mesh.groups('data') == [[0, 2, 4, 6], [1, 3, 5, 7]]
    three = tmesh.Mesh(np.array(CPU8, dtype=object).reshape(2, 2, 2), ('a', 'b', 'c'))
    assert three.groups(('c', 'a')) == [[0, 4, 1, 5], [2, 6, 3, 7]]
    s = tmesh.Sharded(mesh, ['model', 'data'], 0, [torch.zeros(1)] * 8, (8,))
    assert s.axis == ('model', 'data') and "axis=('model', 'data')" in repr(s)
    assert tmesh.Sharded(mesh, ('data',), 0, [torch.zeros(2)] * 8, (8,)).axis == 'data'


@pytest.mark.parametrize('axis', [('data', 'data'), ('data', 'batch'), 'batch'])
def test_mesh_axis_tuple_errors(axis):
    mesh = tpar.make_mesh((4, 2), devices=CPU8)
    for call in (lambda: mesh.groups(axis), lambda: mesh.axis_size(axis),
                 lambda: tmesh.Sharded(mesh, axis, 0, [torch.zeros(1)] * 8, (8,)),
                 lambda: tpar.shard_batch(np.zeros((16, 2), np.float32), mesh, axis=axis)):
        with pytest.raises(RuntimeError, match='twice|not in'):
            call()
