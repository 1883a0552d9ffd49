"""The fusion tier of dsc_tpu_torch (fuse.py, capture.py, ops/map_gen.py)
against dsc_tpu's (dsc_tpu/fuse.py) on the same inputs, on the CPU:

- ``dsc.compile``: the non-mesh cases of tests/test_compile.py (the mesh
  cases are tests/test_torch_compile_mesh.py), program constants, and the
  repairs that make a CUDA graph capture possible (no synchronize while
  capturing, concrete reads refused inside a program, a plan missing during
  a capture refused);
- ``dsc.map``: the cases of tests/test_pallas_map.py with K5's thresholds
  set small on both sides (the JAX kernel in interpret mode), each with the
  same stream-or-compile decision as dsc_tpu, the lowering table case by
  case, and the generated CUDA source of two bodies as text;
- ``profile(xprof_dir=)`` and ``utils.debug.nan_guard``.
"""

import gc
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import dsc_tpu  # noqa: E402
import dsc_tpu.ops.pallas_map as pm  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch import capture, fuse, tracing  # noqa: E402
from dsc_tpu_torch.fourier import plan  # noqa: E402
from dsc_tpu_torch.kernels import build  # noqa: E402
from dsc_tpu_torch.ops import map_gen  # noqa: E402
from dsc_tpu_torch.ops import stream_map as sm  # noqa: E402
from dsc_tpu_torch.utils import debug  # noqa: E402

BOTH = [dt, dsc_tpu]


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    # one intra-op thread: torch's CPU elementwise kernels split 16384
    # values into 2048-value chunks over threads, and a first parallel
    # torch.sqrt after the JAX compiles has returned one chunk off by up to
    # 4e-4 (about one run of this file in four); these tensors are small
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dt.init(2**32, device='cpu')
    # the heap the imports and compiles leave: the gc.collect() after every
    # test (tests/conftest.py) would otherwise rescan it each time
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()
    torch.set_num_threads(threads)


def _rand(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _same(got, ref, eps=1e-5):
    got = got.numpy() if hasattr(got, 'numpy') else np.asarray(got)
    ref = ref.numpy() if hasattr(ref, 'numpy') else np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, atol=eps, rtol=eps)


# ---------------------------------------------------------------------------
# dsc.compile (tests/test_compile.py)
# ---------------------------------------------------------------------------


def test_compile_elementwise_chain():
    an, bn, cn = (_rand((8, 256), s) for s in range(3))
    small = _rand((4, 128), 3)
    res = []
    for pkg in BOTH:
        fma = pkg.compile(lambda a, b, c, pkg=pkg: pkg.add(pkg.mul(a, b), c))
        got = fma(*(pkg.from_numpy(x) for x in (an, bn, cn)))
        assert isinstance(got, pkg.Tensor) and got.shape == (8, 256)
        fma(*(pkg.from_numpy(x) for x in (an, bn, cn)))
        assert fma.n_programs == 1  # same signature, same program
        fma(*(pkg.from_numpy(small) for _ in range(3)))
        assert fma.n_programs == 2
        res.append(got)
    _same(res[0], res[1])
    _same(res[0], an * bn + cn)


def test_compile_filterfft_pipeline():
    n = 4096
    s, f = _rand(n, 1), _rand(n, 2)
    res = []
    for pkg in BOTH:
        filt = pkg.compile(lambda sig, flt, pkg=pkg: pkg.irfft(pkg.mul(pkg.rfft(sig),
                                                                         pkg.rfft(flt))))
        res.append(filt(pkg.from_numpy(s), pkg.from_numpy(f)).numpy())
    want = np.fft.irfft(np.fft.rfft(s.astype(np.float64)) * np.fft.rfft(f.astype(np.float64)))
    assert np.abs(res[0] - want).max() / np.abs(want).max() < 1e-4
    _same(res[0], res[1], eps=1e-4)


def test_compile_complex_output_and_tuple_return():
    s = _rand(2048, 4)
    res = []
    for pkg in BOTH:
        spec = pkg.compile(lambda sig, pkg=pkg: (pkg.rfft(sig), pkg.absolute(pkg.rfft(sig))))
        X, mag = spec(pkg.from_numpy(s))
        assert X.shape == (1025,) and mag.shape == (1025,)
        res.append((X.numpy(), mag.numpy()))
    assert str(X.dtype) == str(dt.Dtype.C32)
    for a, b in zip(*res):
        _same(a, b, eps=1e-3)
    _same(res[0][0], np.fft.rfft(s).astype(np.complex64), eps=1e-3)


def test_compile_t_layout_input():
    """An eager spectrum stored in the half-T layout (rfft at 2^18) crosses
    the compile boundary in its layout, which is part of the signature."""
    inv = dt.compile(lambda X: dt.irfft(X))
    for n in (2**18, 2**11):
        s = _rand(n, n)
        Xe = dt.rfft(dt.from_numpy(s))
        assert (Xe._layout is not None) == (n == 2**18)
        got = inv(Xe).numpy()
        want = np.fft.irfft(np.fft.rfft(s.astype(np.float64)))
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
        assert Xe._layout is None or Xe._buf.layout is not None  # the argument kept its layout
    assert inv.n_programs == 2
    keys = [slots[0][2] for slots in inv._programs]
    assert keys[0][3] == (512, 512, True) and keys[1][3] is None


def test_compile_static_scalars_and_kwargs():
    an = _rand(16, 5)
    res = []
    for pkg in BOTH:
        scale = pkg.compile(lambda x, k, bias=0.0, pkg=pkg: pkg.add(pkg.mul(x, k), bias))
        a = pkg.from_numpy(an)
        r1, r2 = scale(a, 2.5).numpy(), scale(a, 2.5, bias=1.0).numpy()
        n0 = scale.n_programs
        scale(a, 3.0)
        assert scale.n_programs == n0 + 1  # each scalar value is its own program
        res.append((r1, r2))
    _same(res[0][0], res[1][0])
    _same(res[0][1], res[1][1])
    _same(res[0][1], an * 2.5 + 1.0)


def test_compile_lru_bound(monkeypatch):
    monkeypatch.setenv('DSC_MAX_PROGRAMS', '2')
    for pkg in BOTH:
        ident = pkg.compile(lambda x, k, pkg=pkg: pkg.mul(x, k))
        a = pkg.from_numpy(np.ones(8, np.float32))
        for k in (1.0, 2.0, 3.0, 4.0):
            ident(a, k)
        assert ident.n_programs == 2


def test_compile_clear_cache():
    f = dt.compile(lambda x: dt.mul(x, 2.0))
    f(dt.from_numpy(np.ones(8, np.float32)))
    assert f.n_programs == 1
    f.clear_cache()
    assert f.n_programs == 0


@pytest.mark.parametrize('pkg', BOTH, ids=['port', 'jax'])
def test_compile_mem_accounting_balanced(pkg):
    f = pkg.compile(lambda x: pkg.mul(x, x))
    a = pkg.from_numpy(_rand(64, 6))
    f(a)  # trace outside the measured window
    m0 = pkg.used_mem()
    r = f(a)
    assert pkg.used_mem() == m0 + r.ne * 4  # the output, and nothing else
    del r
    gc.collect()
    assert pkg.used_mem() == m0


def test_compile_is_functional():
    def writes(x, pkg):
        x[0] = 99.0
        return pkg.add(x, 0.0)

    def with_out(x, pkg):
        tmp = pkg.empty(4, dtype=pkg.Dtype.F32)
        pkg.mul(x, 2.0, out=tmp)
        return tmp

    for pkg in BOTH:
        w = pkg.compile(lambda x, pkg=pkg: writes(x, pkg))
        a = pkg.from_numpy(np.zeros(4, np.float32))
        for _ in range(2):
            out = w(a)
            assert out.numpy()[0] == pytest.approx(99.0)  # in the result
            assert a.numpy()[0] == pytest.approx(0.0)  # the caller's Tensor untouched
        o = pkg.compile(lambda x, pkg=pkg: with_out(x, pkg))
        _same(o(pkg.from_numpy(np.ones(4, np.float32))), np.full(4, 2.0, np.float32))
        _same(o(pkg.from_numpy(np.full(4, 3.0, np.float32))), np.full(4, 6.0, np.float32))


def test_compile_view_argument():
    for pkg in BOTH:
        double = pkg.compile(lambda x, pkg=pkg: pkg.add(x, x))
        v = pkg.from_numpy(np.arange(12, dtype=np.float32)).reshape(3, 4)
        got = double(v)
        assert got.shape == (3, 4)
        _same(got, np.arange(12, dtype=np.float32).reshape(3, 4) * 2)


def test_compile_reductions_and_slicing():
    an = _rand((8, 256), 7)
    res = []
    for pkg in BOTH:
        def stats(x, pkg=pkg):
            d = pkg.sub(x, pkg.mean(x, axis=-1, keepdims=True))
            return pkg.sum(pkg.mul(d, d), axis=-1)[1:5]

        res.append(pkg.compile(stats)(pkg.from_numpy(an)).numpy())
    want = ((an - an.mean(-1, keepdims=True)) ** 2).sum(-1, keepdims=True)[1:5]
    _same(res[0], res[1], eps=1e-3)
    _same(res[0], want, eps=1e-3)


def test_compile_errors():
    for pkg in BOTH:
        bad = pkg.compile(lambda x: 42)
        with pytest.raises(RuntimeError, match='must return a Tensor'):
            bad(pkg.from_numpy(np.ones(4, np.float32)))
        ok = pkg.compile(lambda x: x)
        with pytest.raises(RuntimeError, match='arguments must be'):
            ok(object())
        peeks = pkg.compile(lambda x: (float(np.asarray(x.numpy()).sum()), x)[1])
        with pytest.raises(Exception, match='[Cc]oncret|[Tt]racer'):
            peeks(pkg.from_numpy(np.ones(4, np.float32)))


@pytest.mark.parametrize('read', ['numpy', 'unwrap', 'str'])
def test_compile_concrete_reads_raise(read):
    fns = {'numpy': lambda x: (x.numpy(), x)[1],
           'unwrap': lambda x: (x[0], x)[1],
           'str': lambda x: (str(x), x)[1]}
    f = dt.compile(fns[read])
    with pytest.raises(RuntimeError, match='[Cc]oncret'):
        f(dt.from_numpy(np.ones(4, np.float32)))
    assert f.n_programs == 0  # a failed trace leaves no program
    assert capture.current() is None


def test_compile_plan_cache_stays_concrete():
    plan.clear_plans()
    s = _rand(512, 8)
    first = dt.compile(lambda x: dt.rfft(x))
    first(dt.from_numpy(s))
    assert plan.num_plans() >= 1  # the trace run filled the cache
    got = dt.rfft(dt.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, np.fft.rfft(s), atol=1e-3, rtol=1e-4)


def test_compile_numpy_array_args():
    an = _rand(16, 9)
    for pkg in BOTH:
        addn = pkg.compile(lambda x, y, pkg=pkg: pkg.add(x, y))
        _same(addn(an, np.float32(0) + an), an + an)


def test_compile_decorator_forms():
    def f(x):
        return dt.mul(x, 2.0)

    c1, c2 = dt.compile(f), dt.compile()(f)
    a = dt.from_numpy(np.ones(4, np.float32))
    _same(c1(a), c2(a))
    assert isinstance(c1, fuse._Compiled) and c1.__name__ == 'f'


def test_compile_constants_same_values_every_call():
    """randn inside fn is a program constant, as it is in dsc_tpu."""
    z = np.zeros(4, np.float32)
    # dsc_tpu's next_key splits the context key inside the jit trace, which
    # leaves a tracer as the context's key and breaks every later eager
    # dsc_tpu.randn in this process; keep the key this test found
    jax_ctx = dsc_tpu.context._get_ctx()
    jax_key = jax_ctx._key
    try:
        for pkg in BOTH:
            f = pkg.compile(lambda x, pkg=pkg: pkg.add(x, pkg.randn(4)))
            r1, r2 = f(pkg.from_numpy(z)).numpy(), f(pkg.from_numpy(z)).numpy()
            np.testing.assert_array_equal(r1, r2)
            assert np.abs(r1).max() > 0
    finally:
        jax_ctx._key = jax_key
    # an eager randn after the program draws anew
    assert not np.array_equal(dt.randn(4).numpy(), r1)
    eager = dsc_tpu.randn(4).numpy()
    assert eager.shape == (4,) and np.isfinite(eager).all()


def test_compile_constant_written_in_place_is_fresh_each_call():
    def fn(x):
        acc = dt.zeros(4)
        acc[0] = 1.0
        return dt.add(acc, x)

    f = dt.compile(fn)
    for _ in range(3):
        _same(f(dt.from_numpy(np.ones(4, np.float32))), np.array([2, 1, 1, 1], np.float32))


def test_compile_nested_inlines():
    inner = dt.compile(lambda x: dt.mul(x, 3.0))
    outer = dt.compile(lambda x: dt.add(inner(x), 1.0))
    _same(outer(dt.from_numpy(np.ones(4, np.float32))), np.full(4, 4.0, np.float32))
    assert inner.n_programs == 0  # ran inside outer's program


def test_compile_tracing_events():
    f = dt.compile(lambda x: dt.add(dt.mul(x, 2.0), 1.0))
    a = dt.from_numpy(np.ones(4, np.float32))
    names = []
    for _ in range(2):
        tracing.clear_traces()
        tracing.set_recording(True)
        f(a)
        tracing.set_recording(False)
        names.append([e['name'] for e in tracing._events if e['ph'] == 'B'])
    tracing.clear_traces()
    assert names[0][0] == 'compile:<lambda>' and {'mul', 'add'} <= set(names[0])
    assert names[1] == ['compile:<lambda>']  # op events in the trace run only


def test_trace_op_does_not_synchronize_while_capturing(monkeypatch):
    """A span is an enqueue span: it never waits for the device, capturing or not."""
    calls = []
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: calls.append('sync'))
    tracing.clear_traces()
    tracing.set_recording(True)
    try:
        for capturing in (False, True):
            monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing', lambda: capturing)
            with tracing.trace_op('op', 'op;test'):
                pass
        assert calls == []
        assert [e['ph'] for e in tracing._events] == ['B', 'E', 'B', 'E']
    finally:
        tracing.set_recording(False)
        tracing.clear_traces()


def test_plan_missing_during_capture_raises(monkeypatch):
    plan.get_plan(1024, 'real', torch.complex64)
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing', lambda: True)
    plan.get_plan(1024, 'real', torch.complex64)  # cached: fine while capturing
    plan.clear_plans()
    with pytest.raises(RuntimeError, match='evicted .* DSC_MAX_FFT_PLANS'):
        plan.get_plan(1024, 'real', torch.complex64)


# ---------------------------------------------------------------------------
# dsc.map (tests/test_pallas_map.py), K5's thresholds small on both sides
# ---------------------------------------------------------------------------


@pytest.fixture
def small_map(monkeypatch):
    monkeypatch.setattr(pm, 'MODE', 'on')
    monkeypatch.setattr(pm, 'CHUNK_ROWS', 64)
    monkeypatch.setattr(pm, 'MIN_ELEMS', 1024)
    monkeypatch.setattr(sm, 'CHUNK_ROWS', 64)
    monkeypatch.setattr(sm, 'MIN_ELEMS', 1024)


def _route(wrapper) -> str:
    kind = next(iter(wrapper._programs.values()))[0]
    return 'compile' if kind == 'xla' else kind


def _both_map(fn_of, *arrays):
    """(port result, JAX result, port route, JAX route) of the map
    ``fn_of(pkg)`` applied to ``arrays``."""
    out = []
    for pkg in BOTH:
        w = pkg.map(fn_of(pkg))
        out.append((w(*(pkg.from_numpy(a) for a in arrays)), _route(w), w))
    return out


def test_dsc_map_chain(small_map):
    ne = 64 * 128 * 3 + 2048
    a, b = _rand(ne, 1), _rand(ne, 2)
    (got, route, w), (ref, jroute, _) = _both_map(
        lambda p: lambda x, y: p.clip(x * y + 0.5, -1.0, 1.0), a, b)
    assert route == jroute == 'stream'
    _same(got, ref)
    _same(got, np.clip(a * b + 0.5, -1.0, 1.0))
    _same(w(dt.from_numpy(a), dt.from_numpy(b)), ref)  # the cached program
    assert w.n_programs == 1


def test_dsc_map_scalar_and_brow_operands(small_map):
    x, row, s = _rand((48, 1024), 3), _rand(1024, 4), np.array([0.25], np.float32)
    (got, route, w), (ref, jroute, _) = _both_map(lambda p: lambda t, r, k: t * r + k, x, row, s)
    assert route == jroute == 'stream'
    assert next(iter(w._programs.values()))[1].kinds == ('full', 'brow', 'scalar')
    _same(got, ref)


def test_dsc_map_multi_output(small_map):
    ne = 64 * 128 * 2
    a, b = _rand(ne, 5), _rand(ne, 6)
    ((g1, g2), route, _), ((r1, r2), jroute, _) = _both_map(
        lambda p: lambda x, y: (x + y, x * y), a, b)
    assert route == jroute == 'stream'
    _same(g1, r1)
    _same(g2, r2)


def test_dsc_map_fallback(small_map):
    a = np.random.default_rng(1).standard_normal(4096)  # float64
    (got, route, _), (ref, jroute, _) = _both_map(lambda p: lambda x: x * 2.0 + 1.0, a)
    assert route == jroute == 'compile'
    _same(got, ref)
    af = _rand(64 * 128 * 2, 7)
    (got, route, _), (ref, jroute, _) = _both_map(
        lambda p: lambda x: p.sum(x, axis=-1, keepdims=True), af)
    assert route == jroute == 'compile'
    _same(got, ref, eps=1e-3)


def test_dsc_map_immediate_form(small_map):
    a = _rand(64 * 128 * 2, 8)
    got = dt.map(lambda x: dt.sqrt(dt.absolute(x)), dt.from_numpy(a))
    ref = dsc_tpu.map(lambda x: dsc_tpu.sqrt(dsc_tpu.absolute(x)), dsc_tpu.from_numpy(a))
    _same(got, ref)


def test_dsc_map_under_compile(small_map):
    ne = 64 * 128 * 2
    a, b = _rand(ne, 9), _rand(ne, 10)
    res = []
    for pkg in BOTH:
        fused = pkg.map(lambda x, y, pkg=pkg: pkg.clip(x * y + 0.5, -1.0, 1.0))
        pipe = pkg.compile(lambda x, y, fused=fused: fused(x, y) * 2.0)
        res.append(pipe(pkg.from_numpy(a), pkg.from_numpy(b)).numpy())
        pipe(pkg.from_numpy(a), pkg.from_numpy(b))
        assert _route(fused) == 'stream'
    _same(res[0], res[1])
    _same(res[0], np.clip(a * b + 0.5, -1.0, 1.0) * 2.0)


def test_dsc_map_small_operands_take_compile():
    a = _rand(1000, 11)  # under K5's MIN_ELEMS
    w = dt.map(lambda x: x * 2.0)
    _same(w(dt.from_numpy(a)), a * 2.0)
    assert _route(w) == 'compile'


# each body: (function of the port's module, numpy reference, K5g takes it)
TABLE = {
    'add_sub': (lambda p: lambda x, y: x + y - 1.5, lambda x, y: x + y - 1.5, True),
    'mul_div': (lambda p: lambda x, y: x * y / 4.0, lambda x, y: x * y / 4.0, True),
    'rsub_rdiv': (lambda p: lambda x, y: 2.0 - 3.0 / (p.absolute(y) + 1.0),
                  lambda x, y: 2.0 - 3.0 / (np.abs(y) + 1.0), True),
    'abs': (lambda p: lambda x, y: p.absolute(x) * -1.0, lambda x, y: -np.abs(x), True),
    'exp_log': (lambda p: lambda x, y: p.exp(x) + p.logn(p.absolute(y) + 1.0),
                lambda x, y: np.exp(x) + np.log(np.abs(y) + 1.0), True),
    'log2_log10': (lambda p: lambda x, y: p.log2(p.absolute(x) + 1.0) * p.log10(p.absolute(y) + 2.0),
                   lambda x, y: np.log2(np.abs(x) + 1) * np.log10(np.abs(y) + 2), True),
    'sqrt': (lambda p: lambda x, y: p.sqrt(p.absolute(x)), lambda x, y: np.sqrt(np.abs(x)), True),
    'sin_cos': (lambda p: lambda x, y: p.sin(x) * p.cos(y), lambda x, y: np.sin(x) * np.cos(y),
                True),
    'sinc': (lambda p: lambda x, y: p.sinc(x), lambda x, y: np.sinc(x), True),
    'clip_both': (lambda p: lambda x, y: p.clip(x, -0.5, 0.5), lambda x, y: np.clip(x, -0.5, 0.5),
                  True),
    'clip_lo': (lambda p: lambda x, y: p.clip(x, x_min=0.0), lambda x, y: np.maximum(x, 0.0),
                True),
    'clip_hi': (lambda p: lambda x, y: p.clip(x, x_max=0.25), lambda x, y: np.minimum(x, 0.25),
                True),
    'pow_scalar': (lambda p: lambda x, y: x ** 2.0 + p.absolute(y) ** 0.5,
                   lambda x, y: x ** 2 + np.abs(y) ** 0.5, True),
    'pow_powf': (lambda p: lambda x, y: p.absolute(x) ** 1.5, lambda x, y: np.abs(x) ** 1.5, True),
    'views': (lambda p: lambda x, y: p.real(p.conj(x)) + p.imag(y),
              lambda x, y: x + 0.0, True),
    'cast_f32': (lambda p: lambda x, y: p.cast(x, p.Dtype.F32) * y, lambda x, y: x * y, True),
    'angle': (lambda p: lambda x, y: p.angle(x), lambda x, y: np.angle(x), False),
    'i0': (lambda p: lambda x, y: p.i0(x), lambda x, y: np.i0(x), False),
    'cast_f64': (lambda p: lambda x, y: p.cast(p.cast(x, p.Dtype.F64), p.Dtype.F32),
                 lambda x, y: x, False),
    'slice': (lambda p: lambda x, y: x[1:], lambda x, y: x[1:], False),
    'reduce': (lambda p: lambda x, y: p.max(x, axis=-1, keepdims=True),
               lambda x, y: x.max(-1, keepdims=True), False),
}


@pytest.mark.parametrize('case', list(TABLE))
def test_lowering_table(case, small_map, monkeypatch):
    """An op in the lowering table takes K5g (a generated source, the plain
    interpreter here); any other sends the signature to compile before any
    source is generated or built."""
    made, built = [], []
    generate = map_gen.generate
    monkeypatch.setattr(map_gen, 'generate', lambda *a: made.append(a) or generate(*a))
    monkeypatch.setattr(build, 'build_generated', lambda src: built.append(src))
    fn_of, ref_fn, lowered = TABLE[case]
    a, b = _rand(64 * 128, 12), _rand(64 * 128, 13)
    w = dt.map(fn_of(dt))
    got = w(dt.from_numpy(a), dt.from_numpy(b))
    assert _route(w) == ('stream' if lowered else 'compile')
    assert len(made) == int(lowered)
    assert built == []  # nothing is built for a CPU tensor
    _same(got, fn_of(dt)(dt.from_numpy(a), dt.from_numpy(b)))  # the eager port
    np.testing.assert_allclose(got.numpy(), ref_fn(a.astype(np.float64), b.astype(np.float64)),
                               atol=2e-5, rtol=2e-5)


# ops on a broadcast row's values, under K5's size: the port's eager op is
# then torch's own, recorded as cos, sinc, clamp
ROW_TABLE = {
    'cos': (lambda p: lambda x, r: x * p.cos(r), lambda x, r: x * np.cos(r)),
    'sinc': (lambda p: lambda x, r: x + p.sinc(r), lambda x, r: x + np.sinc(r)),
    'clip': (lambda p: lambda x, r: x - p.clip(r, -0.5, 0.5), lambda x, r: x - np.clip(r, -0.5, 0.5)),
}


@pytest.mark.parametrize('case', list(ROW_TABLE))
def test_lowering_row_values(case, small_map, monkeypatch):
    made = []
    generate = map_gen.generate
    monkeypatch.setattr(map_gen, 'generate', lambda *a: made.append(a) or generate(*a))
    fn_of, ref_fn = ROW_TABLE[case]
    x, r = _rand((64, 128), 16), _rand(128, 17)
    w = dt.map(fn_of(dt))
    got = w(dt.from_numpy(x), dt.from_numpy(r))
    _, kernel, _ = next(iter(w._programs.values()))
    assert _route(w) == 'stream' and kernel.kinds == ('full', 'brow') and len(made) == 1
    assert {'cos': 'cosf(', 'sinc': 'dsc_sinc(', 'clip': 'dsc_clamp('}[case] in kernel.source
    np.testing.assert_allclose(got.numpy(), ref_fn(x.astype(np.float64), r.astype(np.float64)),
                               atol=2e-5, rtol=2e-5)


# the min/max forms no port op records (its clip records clamp): each torch
# op lowered from its record on meta, and the record replayed
MIN_MAX = {
    'clamp_min': (lambda x, y: torch.clamp_min(x, -0.5), 'dsc_clamp(in[0], (-0.5f), INFINITY)',
                  lambda x, y: np.maximum(x, -0.5)),
    'clamp_max': (lambda x, y: torch.clamp_max(x, 0.5), 'dsc_clamp(in[0], (-INFINITY), 0.5f)',
                  lambda x, y: np.minimum(x, 0.5)),
    'minimum': (torch.minimum, 'dsc_minimum(in[0], in[1])', np.minimum),
    'maximum': (torch.maximum, 'dsc_maximum(in[0], in[1])', np.maximum),
}


@pytest.mark.parametrize('case', list(MIN_MAX))
def test_lowering_min_max_forms(case):
    fn, line, ref_fn = MIN_MAX[case]
    metas = [torch.empty(4096, device='meta') for _ in range(2)]
    ops, out = map_gen.trace(lambda: fn(*metas))
    lines = map_gen.lower(ops, metas, [out], (4096,), ('full', 'full'))
    assert lines == [f'const float v0 = {line};', 'out[0] = v0;']
    a, b = _rand(4096, 18), _rand(4096, 19)
    a[7] = np.nan  # NaN propagates, as torch's op and the helper keep it
    got = map_gen.interpret(ops, metas, [out], [torch.from_numpy(a), torch.from_numpy(b)])[0]
    np.testing.assert_array_equal(got.numpy(), ref_fn(a, b))


GOLDEN_CLIP = '''// K5g: a dsc.map body generated by dsc_tpu_torch/ops/map_gen.py on the
// streaming skeleton of K5 (stream_map.cuh).
#include "stream_map.cuh"

namespace {

struct Body {
  __device__ __forceinline__ void operator()(const float (&in)[2], float (&out)[1]) const {
    const float v0 = (in[0] * in[1]);
    const float v1 = (v0 + 0.5f);
    const bool v2 = (v1 < (-1.0f));
    const float v3 = (v2 ? (-1.0f) : v1);
    const bool v4 = (v3 > 1.0f);
    const float v5 = (v4 ? 1.0f : v3);
    out[0] = v5;
  }
};

}  // namespace

extern "C" int dsc_map_gen(const void* const* in, const int* rows, void* const* out,
                           long long n, void* stream) {
  return launch_generated<Body, 1, kF, kF>(in, rows, out, n, stream);
}
'''

GOLDEN_TWO_OUTPUTS = '''// K5g: a dsc.map body generated by dsc_tpu_torch/ops/map_gen.py on the
// streaming skeleton of K5 (stream_map.cuh).
#include "stream_map.cuh"

namespace {

struct Body {
  __device__ __forceinline__ void operator()(const float (&in)[3], float (&out)[2]) const {
    const float v0 = (in[0] * in[1]);
    const float v1 = (v0 + in[2]);
    const float v2 = (in[0] - in[1]);
    out[0] = v1;
    out[1] = v2;
  }
};

}  // namespace

extern "C" int dsc_map_gen(const void* const* in, const int* rows, void* const* out,
                           long long n, void* stream) {
  return launch_generated<Body, 2, kF, kB, kS>(in, rows, out, n, stream);
}
'''


def test_generated_sources(small_map):
    a, b = _rand((16, 1024), 14), _rand((16, 1024), 15)
    w = dt.map(lambda x, y: dt.clip(x * y + 0.5, -1.0, 1.0))
    w(dt.from_numpy(a), dt.from_numpy(b))
    assert next(iter(w._programs.values()))[1].source == GOLDEN_CLIP
    two = dt.map(lambda x, r, k: (x * r + k, x - r))
    g1, g2 = two(dt.from_numpy(a), dt.from_numpy(b[0]), dt.from_numpy(np.array([2.0], np.float32)))
    assert next(iter(two._programs.values()))[1].source == GOLDEN_TWO_OUTPUTS
    _same(g1, a * b[0] + 2.0)
    _same(g2, a - b[0])


# ---------------------------------------------------------------------------
# profile(xprof_dir=) and nan_guard
# ---------------------------------------------------------------------------


def test_profile_xprof_dir_merges_profiler_events(tmp_path):
    x = dt.from_numpy(_rand(4096, 16))
    trace = tmp_path / 'traces.json'
    with dt.profile(str(trace), serve=False, xprof_dir=str(tmp_path / 'xprof')):
        dt.irfft(dt.rfft(x))
    events = json.loads(trace.read_text())['traceEvents']
    ops = [e for e in events if e.get('cat', '').startswith('op;')]
    prof = [e for e in events if e.get('pid', 0) >= 1 << 22]
    assert {'rfft', 'irfft'} <= {e['name'] for e in ops}
    assert any(e.get('name', '').startswith('aten::') for e in prof)
    assert list((tmp_path / 'xprof').glob('*.trace.json'))
    # one clock: the profiler's ops lie within the dsc region
    begin = min(e['ts'] for e in ops)
    end = max(e['ts'] for e in ops)
    aten = [e['ts'] for e in prof if e.get('name', '').startswith('aten::')]
    assert begin - 5e3 <= min(aten) and max(aten) <= end + 5e3


def test_nan_guard_flags_a_nan():
    x = dt.from_numpy(np.array([1.0, -1.0], np.float32))
    with debug.nan_guard():
        dt.sqrt(dt.absolute(x))
        with pytest.raises(FloatingPointError, match='NaN'):
            dt.sqrt(x)
    assert np.isnan(dt.sqrt(x).numpy()[1])  # off outside the block


def test_nan_guard_interpret_kernels(monkeypatch):
    with debug.nan_guard(interpret_kernels=True):  # the CPU runs plain versions anyway
        pass
    import dsc_tpu_torch.context as context

    monkeypatch.setattr(context, 'device', lambda: torch.device('cuda'))
    with pytest.raises(RuntimeError, match='no switch swaps a kernel for its plain version'):
        with debug.nan_guard(interpret_kernels=True):
            pass


def test_debug_logging(capsys):
    debug.enable_debug_logging(True)
    debug.log_debug('hello')
    debug.enable_debug_logging(False)
    debug.log_debug('quiet')
    assert capsys.readouterr().err == '[DSC DEBUG] hello\n'
