"""Kernel K5 of dsc_tpu_torch (ops/stream_map.py) against the JAX package's
streaming map (dsc_tpu/ops/pallas_map.py) on the same inputs.

The JAX kernel runs in interpret mode with small chunks, as
tests/test_pallas_map.py runs it; the port's wrapper runs its plain
version on CPU tensors. Also: the routing rule case by case against
``pallas_map.eligible``, and the README filterFFT at n = 2^21 with the
spectrum multiply on K5's complex body."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

import dsc_tpu  # noqa: E402
import dsc_tpu.ops.kernels as JK  # noqa: E402
import dsc_tpu.ops.pallas_map as pm  # noqa: E402
from dsc_tpu import planar  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch.ops import kernels as K  # noqa: E402
from dsc_tpu_torch.ops import stream_map as sm  # noqa: E402

EXACT = 1e-6   # IEEE arithmetic, clip and the polynomial sin/cos
LIBM = 1e-5    # exp/log/sqrt/sinc: XLA's and torch's ulps differ

NE = 64 * 128 * 2 + 1024  # two full chunks and a remainder tile

JAX_BODIES = {
    'add': jnp.add, 'sub': jnp.subtract, 'mul': jnp.multiply, 'div': jnp.true_divide,
    'sin': JK._fast_sin_f32, 'cos': JK._fast_cos_f32, 'exp': jnp.exp,
    'logn': jnp.log, 'log2': jnp.log2, 'log10': jnp.log10, 'sqrt': jnp.sqrt,
    'sinc': jnp.sinc, 'clip': lambda v, lo, hi: jnp.clip(v, lo, hi),
}
TOL = {'exp': LIBM, 'logn': LIBM, 'log2': LIBM, 'log10': LIBM, 'sqrt': LIBM,
       'sinc': LIBM}


@pytest.fixture
def jax_kernel(monkeypatch):
    """The JAX kernel in interpret mode on small chunks."""
    monkeypatch.setattr(pm, 'MODE', 'on')
    monkeypatch.setattr(pm, 'CHUNK_ROWS', 64)
    monkeypatch.setattr(pm, 'MIN_ELEMS', 1024)


def _rand(shape, seed, positive=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) + np.float32(1e-3) if positive else x


def _same(got: torch.Tensor, ref, eps):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, atol=eps, rtol=eps)


def _operands(body, ne, seed):
    positive = body in ('logn', 'log2', 'log10', 'sqrt')
    xs = [_rand(ne, seed + i, positive) for i in range(sm.REAL_BODIES[body])]
    if body == 'clip':
        xs[1:] = [np.float32(-0.5), np.float32(0.75)]
    return xs


def _port_args(xs):
    return [torch.from_numpy(x) if isinstance(x, np.ndarray) else float(x) for x in xs]


@pytest.mark.parametrize('body', list(sm.REAL_BODIES))
def test_real_body_matches_jax_kernel(jax_kernel, body):
    xs = _operands(body, NE, 10)
    assert pm.eligible([np.shape(x) for x in xs], [np.float32] * len(xs))
    ref = pm.stream_map(JAX_BODIES[body], *xs)
    _same(sm.stream_map(body, *_port_args(xs)), ref, TOL.get(body, EXACT))


@pytest.mark.parametrize('ne', [64 * 128 * 3, 64 * 128 * 5 + 2048, 1024])
def test_chunk_counts_and_remainder_tiles(jax_kernel, ne):
    a, b = _rand(ne, 1), _rand(ne, 2)
    ref = pm.stream_map(jnp.multiply, a, b)
    _same(sm.stream_map('mul', torch.from_numpy(a), torch.from_numpy(b)), ref, EXACT)


@pytest.mark.parametrize('body', ['sub', 'div', 'sin'])
def test_ragged_count_takes_the_tail(body):
    # a count no route would pick: the wrapper takes any
    xs = _operands(body, 2**12 + 4 * 10 + 3, 3)
    got = sm.stream_map(body, *_port_args(xs))
    ref = {'sub': lambda a, b: a - b, 'div': lambda a, b: a / b, 'sin': np.sin}[body](*xs)
    _same(got, ref.astype(np.float32), EXACT)


@pytest.mark.parametrize('body', ['sub', 'div'])
@pytest.mark.parametrize('side', ['left', 'right'])
@pytest.mark.parametrize('kind', ['python', 'tensor'])
def test_scalar_operands(jax_kernel, body, side, kind):
    a, s = _rand(NE, 4), np.float32(2.5)
    js = (s, a) if side == 'left' else (a, s)
    ref = pm.stream_map(JAX_BODIES[body], *js)
    ps = 2.5 if kind == 'python' else torch.tensor([2.5])
    ta = torch.from_numpy(a)
    got = sm.stream_map(body, *((ps, ta) if side == 'left' else (ta, ps)))
    _same(got, ref, EXACT)


@pytest.mark.parametrize('shape,rshape', [
    ((16, 1024), (1024,)),
    ((16, 1024), (1, 1024)),
    ((17, 1024), (1, 1024)),
    ((6, 2048), (1, 2048)),
])
def test_broadcast_row(jax_kernel, shape, rshape):
    a, r = _rand(shape, 5), _rand(rshape, 6)
    assert pm.eligible((a.shape, r.shape), (a.dtype, r.dtype))
    assert sm.classify((a.shape, r.shape))[1] == ['full', 'brow']
    ta, tr = torch.from_numpy(a), torch.from_numpy(r)
    _same(sm.stream_map('add', ta, tr), pm.stream_map(jnp.add, a, r), EXACT)
    _same(sm.stream_map('sub', tr, ta), pm.stream_map(jnp.subtract, r, a), EXACT)


def _complex(ne, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(ne) + 1j * rng.standard_normal(ne)).astype(np.complex64)


def _planes(z):
    return np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)


@pytest.mark.parametrize('body', sm.COMPLEX_BODIES)
@pytest.mark.parametrize('rhs', ['tensor', 'scalar'])
def test_complex_body_matches_jax_planar_kernel(jax_kernel, body, rhs):
    a = _complex(NE, 7)
    b = _complex(NE, 8) if rhs == 'tensor' else np.complex64(0.5 - 1.25j)
    br, bi = _planes(b) if rhs == 'tensor' else (np.float32(b.real), np.float32(b.imag))
    yr, yi = pm.stream_map_multi(
        lambda w, x, y, z: planar._complex_math(w, x, y, z, body),
        (*_planes(a), br, bi), (np.float32, np.float32))
    ref = (np.asarray(yr) + 1j * np.asarray(yi)).astype(np.complex64)
    pb = torch.from_numpy(b) if rhs == 'tensor' else complex(b)
    _same(sm.stream_map(body, torch.from_numpy(a), pb), ref, EXACT)


def test_complex_scalar_on_the_left(jax_kernel):
    a, s = _complex(NE, 9), complex(2.0, -0.5)
    yr, yi = pm.stream_map_multi(
        lambda w, x, y, z: planar._complex_math(w, x, y, z, 'div'),
        (np.float32(s.real), np.float32(s.imag), *_planes(a)), (np.float32, np.float32))
    ref = (np.asarray(yr) + 1j * np.asarray(yi)).astype(np.complex64)
    _same(sm.stream_map('div', s, torch.from_numpy(a)), ref, EXACT)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.ones(8)
    with pytest.raises(ValueError):
        sm.stream_map('add', x, torch.ones(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        sm.stream_map('sin', x, x)
    with pytest.raises(ValueError):
        sm.stream_map('sin', torch.ones(8, dtype=torch.complex64))
    with pytest.raises(ValueError):
        sm.stream_map('add', torch.ones(8, 1), torch.ones(1, 8))
    with pytest.raises(ValueError):
        sm.stream_map('add', x, 1j)


# -- the routing rule: the port's eligible() is pallas_map.eligible ---------

BIG = 2**21
ROUTES = [
    (((BIG,), (BIG,)), 'f32'),
    (((BIG,), (BIG,)), 'f64'),
    (((BIG,), (BIG,)), 'c64'),
    (((BIG,), ()), 'f32'),
    (((), (BIG,)), 'f32'),
    (((1,), (BIG,)), 'f32'),
    (((1,), (1,)), 'f32'),
    (((BIG,), (BIG // 2,)), 'f32'),
    (((BIG // 2,), (BIG // 2,)), 'f32'),
    (((BIG + 100,), (BIG + 100,)), 'f32'),
    (((BIG + 128,), (BIG + 128,)), 'f32'),
    (((2048, 1024), (1024,)), 'f32'),
    (((2048, 1024), (1, 1024)), 'f32'),
    (((1, 1024), (2048, 1024)), 'f32'),
    (((2048, 1024), (1024,)), 'f64'),
    (((4096, 1000), (1000,)), 'f32'),
    (((8, 16385 * 128), (1, 16385 * 128)), 'f32'),
    (((8, 16384 * 128), (1, 16384 * 128)), 'f32'),
    (((2048, 1024), (2048, 1)), 'f32'),
    (((2048, 1), (1, 2048)), 'f32'),
    (((2, 1024, 1024), (1, 1, 1024)), 'f32'),
    (((2, 1024, 1024), (1024, 1024)), 'f32'),
    (((BIG,), (), ()), 'f32'),
    (((BIG,),), 'f32'),
    (((BIG + 64,),), 'f32'),
    (((BIG,),), 'c64'),
]
NP_DT = {'f32': np.float32, 'f64': np.float64, 'c64': np.complex64}


@pytest.mark.parametrize('shapes,dt', ROUTES)
def test_eligible_is_the_jax_rule(monkeypatch, shapes, dt):
    monkeypatch.setattr(pm, 'MODE', 'on')
    torch_dt = {'f32': torch.float32, 'f64': torch.float64, 'c64': torch.complex64}[dt]
    assert sm.eligible(shapes, [torch_dt] * len(shapes)) == pm.eligible(
        shapes, [NP_DT[dt]] * len(shapes))


def test_complex_route():
    assert sm.eligible_complex((BIG,), (BIG,))
    assert sm.eligible_complex((BIG,), None) and sm.eligible_complex(None, (BIG,))
    assert sm.eligible_complex((2**23 + 1,), (2**23 + 1,))     # the 2^24 spectrum
    assert not sm.eligible_complex((2**20 + 1,), (2**20 + 1,))  # the 2^21 spectrum
    assert not sm.eligible_complex((BIG,), (1,))
    assert not sm.eligible_complex((2, BIG), (BIG,))
    c = torch.empty(BIG, dtype=torch.complex64)
    assert K.streams('mul', c, c) and K.streams('div', 2.0, c)
    assert not K.streams('pow', c, c)
    assert not K.streams('mul', c.to(torch.complex128), c.to(torch.complex128))


# -- the slice: the README filterFFT with its multiply on K5 ----------------


def test_filter_fft_spectrum_multiply_on_k5(monkeypatch):
    sig = np.random.default_rng(11).standard_normal(2**20).astype(np.float32)
    taps = np.blackman(255).astype(np.float32)
    monkeypatch.setattr(sm, 'MIN_ELEMS', 2**20)
    calls = []
    plain = sm.stream_map_plain

    def spy(body, *ops):
        calls.append((body, tuple(o.dtype for o in ops)))
        return plain(body, *ops)

    monkeypatch.setattr(sm, 'stream_map_plain', spy)
    dt.init(2**32, device='cpu')
    try:
        spec = dt.rfft(dt.from_numpy(sig), n=2**21) * dt.rfft(dt.from_numpy(taps), n=2**21)
        got = dt.irfft(spec)[: 2**20 + 254].numpy()
    finally:
        dt.shutdown()
    assert calls == [('mul', (torch.complex64, torch.complex64))]
    jspec = dsc_tpu.rfft(dsc_tpu.from_numpy(sig), n=2**21) * dsc_tpu.rfft(
        dsc_tpu.from_numpy(taps), n=2**21)
    ref = dsc_tpu.irfft(jspec)[: 2**20 + 254].numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


# -- every instantiation of the kernel (csrc/stream_map.cu) -----------------

ROWS_M = (17, 1024)  # NE elements: two full JAX chunks and a remainder tile
SCALARS = {torch.float32: (0.25, -0.5, 0.75), torch.complex64: (0.5 - 1.25j, 2.0 - 0.5j)}
K5_CASES = [(key, form) for key in sm.INSTANTIATIONS
            for form in (('value', 'tensor') if 'scalar' in key[2] else ('',))]


def _case_id(case):
    (dtype, body, kinds), form = case
    return '-'.join([str(dtype).split('.')[-1], body, *kinds] + ([form] if form else []))


def _kind_operands(dtype, body, kinds, form, seed):
    """(JAX operands, port operands) of ``kinds`` for ``body``: full
    operands of shape ROWS_M, broadcast rows of (M,), scalars as Python
    values or 1-element tensors (``form``)."""
    rng = np.random.default_rng(seed)
    positive = body in ('logn', 'log2', 'log10', 'sqrt')
    jax_ops, port_ops = [], []
    for i, kind in enumerate(kinds):
        if kind == 'scalar':
            v = SCALARS[dtype][i]
            jax_ops.append(np.complex64(v) if dtype == torch.complex64 else np.float32(v))
            port_ops.append(v if form == 'value' else torch.tensor([v], dtype=dtype))
            continue
        shape = ROWS_M if kind == 'full' else ROWS_M[-1:]
        x = rng.standard_normal(shape).astype(np.float32)
        if dtype == torch.complex64:
            x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
        elif positive:
            x = np.abs(x) + np.float32(1e-3)
        jax_ops.append(x)
        port_ops.append(torch.from_numpy(x))
    return jax_ops, port_ops


@pytest.mark.parametrize('case', K5_CASES, ids=_case_id)
def test_every_instantiation_matches_jax_kernel(jax_kernel, case):
    """Each (body, kinds) the kernel is instantiated for: its plain version
    against the JAX kernel on the same operands, scalars both by value and
    as 1-element tensors."""
    (dtype, body, kinds), form = case
    jax_ops, port_ops = _kind_operands(dtype, body, kinds, form, len(kinds) + 20)
    if dtype == torch.complex64:
        planes = []
        for x in jax_ops:
            planes += (_planes(x) if x.ndim else (np.float32(x.real), np.float32(x.imag)))
        yr, yi = pm.stream_map_multi(
            lambda w, x, y, z: planar._complex_math(w, x, y, z, body), planes,
            (np.float32, np.float32))
        ref = (np.asarray(yr) + 1j * np.asarray(yi)).astype(np.complex64)
    else:
        assert pm.eligible([np.shape(x) for x in jax_ops], [np.float32] * len(jax_ops))
        ref = pm.stream_map(JAX_BODIES[body], *jax_ops)
    assert sm._layout(body, port_ops)[1] == list(kinds)
    _same(sm.stream_map(body, *port_ops), ref, TOL.get(body, EXACT))


def test_instantiations_are_what_the_wrapper_admits():
    """The dispatch table holds exactly the kind combinations _layout
    admits: 8 unary, 20 binary, 19 clip, 12 complex instantiations."""
    counts = {}
    for dtype, bodies in ((torch.float32, sm.REAL_BODIES),
                          (torch.complex64, dict.fromkeys(sm.COMPLEX_BODIES, 2))):
        for body, arity in bodies.items():
            for kinds in itertools.product(('full', 'brow', 'scalar'), repeat=arity):
                if 'full' not in kinds:
                    continue
                ops = [torch.ones((2, 8) if k == 'full' else (8,) if k == 'brow' else (1,),
                              dtype=dtype) for k in kinds]
                assert sm.classify([tuple(x.shape) for x in ops])[1] == list(kinds)
                known = (dtype, body, kinds) in sm.INSTANTIATIONS
                if known:
                    assert sm._layout(body, ops)[1] == list(kinds)
                    counts[dtype, arity] = counts.get((dtype, arity), 0) + 1
                else:
                    with pytest.raises(ValueError, match='no .* kernel for kinds'):
                        sm._layout(body, ops)
    assert counts == {(torch.float32, 1): 8, (torch.float32, 2): 20, (torch.float32, 3): 19,
                      (torch.complex64, 2): 12}
    assert len(sm.INSTANTIATIONS) == 59


@pytest.mark.parametrize('dtype,body,kinds,kernel', [
    (torch.float32, 'sin', ('full',), 'map_kernel<RealBody<kSin>, 1, kF>'),
    (torch.float32, 'add', ('full', 'full'), 'map_kernel<RealBody<kAdd>, 1, kF, kF>'),
    (torch.float32, 'mul', ('full', 'scalar'), 'map_kernel<RealBody<kMul>, 1, kF, kS>'),
    (torch.float32, 'sub', ('brow', 'full'), 'map_kernel<RealBody<kSub>, 1, kB, kF>'),
    (torch.float32, 'clip', ('full', 'scalar', 'scalar'), 'map_kernel<RealBody<kClip>, 1, kF, kS, kS>'),
    (torch.float32, 'clip', ('scalar', 'brow', 'full'), 'map_kernel<RealBody<kClip>, 1, kS, kB, kF>'),
    (torch.complex64, 'mul', ('full', 'full'), 'cmap_kernel<kCMul, kF, kF>'),
    (torch.complex64, 'div', ('scalar', 'full'), 'cmap_kernel<kCDiv, kS, kF>'),
])
def test_instantiation_names(dtype, body, kinds, kernel):
    assert sm.instantiation(body, dtype, kinds) == kernel


@pytest.mark.parametrize('dtype,body,kinds', [
    (torch.float32, 'sin', ('scalar',)),
    (torch.float32, 'sin', ('full', 'full')),
    (torch.float32, 'add', ('brow', 'brow')),
    (torch.float32, 'add', ('scalar', 'scalar')),
    (torch.float32, 'clip', ('brow', 'scalar', 'brow')),
    (torch.complex64, 'mul', ('full', 'brow')),
    (torch.complex64, 'sin', ('full',)),
    (torch.float64, 'add', ('full', 'full')),
    (torch.float32, 'pow', ('full', 'full')),
])
def test_instantiation_refuses_unknown_combinations(dtype, body, kinds):
    with pytest.raises(ValueError, match='no .* kernel for kinds'):
        sm.instantiation(body, dtype, kinds)


# -- the op layer classifies its operands once -------------------------------


@pytest.mark.parametrize('op,classified', [
    ('add', 1), ('mul by a scalar', 1), ('clip', 1), ('sin', 1), ('complex mul', 0)])
def test_op_layer_classifies_once(monkeypatch, op, classified):
    """The op layer routes with ``route`` / ``route_complex`` and hands the
    classification down, so the wrapper does not classify again."""
    monkeypatch.setattr(sm, 'MIN_ELEMS', 1024)
    calls = {'classify': 0, 'plain': 0}
    classify, plain = sm.classify, sm.stream_map_plain

    def count_classify(shapes):
        calls['classify'] += 1
        return classify(shapes)

    def count_plain(body, *ops):
        # the plain version classifies for itself; on the card the wrapper
        # launches the kernel in its place
        calls['plain'] += 1
        before = calls['classify']
        out = plain(body, *ops)
        calls['classify'] = before
        return out

    monkeypatch.setattr(sm, 'classify', count_classify)
    monkeypatch.setattr(sm, 'stream_map_plain', count_plain)
    x, y = (torch.from_numpy(_rand((4, 512), s)) for s in (1, 2))
    c = torch.from_numpy(_complex(2048, 3))
    run, ref = {
        'add': (lambda: K.binary('add', x, y), lambda: x + y),
        'mul by a scalar': (lambda: K.binary('mul', x, 2.5), lambda: x * 2.5),
        'clip': (lambda: K.clip(x, -0.5, 0.75), lambda: torch.clamp(x, -0.5, 0.75)),
        'sin': (lambda: K.unary('sin', x), lambda: sm.fast_sin_f32(x)),
        'complex mul': (lambda: K.binary('mul', c, 2.0 - 1j), lambda: c * (2.0 - 1j)),
    }[op]
    got = run()
    assert calls == {'classify': classified, 'plain': 1}
    assert torch.equal(got, ref())


def test_route_is_eligible_with_the_classification():
    for shapes, dt in ROUTES:
        torch_dt = {'f32': torch.float32, 'f64': torch.float64, 'c64': torch.complex64}[dt]
        layout = sm.route(shapes, [torch_dt] * len(shapes))
        assert (layout is not None) == sm.eligible(shapes, [torch_dt] * len(shapes))
        if layout is not None:
            assert layout == sm.classify(shapes)
    assert sm.route_complex((BIG,), None) == ((BIG,), ['full', 'scalar'])
    assert sm.route_complex(None, (BIG,)) == ((BIG,), ['scalar', 'full'])
    assert sm.route_complex((BIG,), (BIG,)) == ((BIG,), ['full', 'full'])
    assert sm.route_complex((BIG,), (1,)) is None


# -- the broadcast row's offsets, thread by thread ---------------------------

# K5's skeleton, which K5g shares: the block shape and Real<kB>::seek
K5_SOURCE = (Path(sm.__file__).resolve().parents[1] / 'csrc' / 'stream_map.cuh').read_text()
K5_THREADS = int(re.search(r'constexpr int kThreads = (\d+);', K5_SOURCE).group(1))
K5_VEC = int(re.search(r'constexpr int kVec = (\d+);', K5_SOURCE).group(1))
K5_CHUNK = K5_THREADS * K5_VEC  # float4 groups a block


def emulate_brow_offsets(m, groups):
    """csrc/stream_map.cuh ``Real<kB>::seek`` for every thread of a grid of
    one block a chunk: one 64-bit division for the thread's first group g0,
    then its kVec groups g0 + k * kThreads by 32-bit arithmetic. Returns
    each float4 group's row offset in elements (-1 where no thread took
    it)."""
    got = np.full(groups, -1, np.int64)
    t = np.arange(K5_THREADS)
    for block in range(-(-groups // K5_CHUNK)):
        g0 = block * K5_CHUNK + t
        base = (4 * g0) % m
        for k in range(K5_VEC):
            off = base + 4 * K5_THREADS * k
            assert off.max() < 2**32
            g = g0 + k * K5_THREADS
            took = g < groups
            assert (got[g[took]] == -1).all()
            got[g[took]] = (off % m)[took]
    return got


@pytest.mark.parametrize('m', [4, 12, 128, 1004, 4096, 16384, 3 * 2**19, 2**21])
@pytest.mark.parametrize('groups', [K5_CHUNK * 5, K5_CHUNK * 5 + 1, 7])
def test_brow_offsets_of_each_thread(m, groups):
    got = emulate_brow_offsets(m, groups)
    np.testing.assert_array_equal(got, (4 * np.arange(groups)) % m)
