"""Differential fuzz: dsc_tpu_torch held to dsc_tpu on the same seeded
random chains of public calls, on the CPU.

The samplers are tests/test_fuzz.py's (copied, with the same seeds and
draws): each chain runs through both packages in lockstep and through
NumPy, and each compiled program and ``dsc.map`` body through both
packages' ``compile`` / ``map``. A mesh-spec fuzz adds what that file has
no counterpart of: seeded meshes and one PartitionSpec per argument,
axis tuples among them, through both packages' ``compile(mesh=...)``.
Bounds: the JAX tests' ``eps``, against dsc_tpu and against NumPy.
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from jax.sharding import PartitionSpec as JP  # noqa: E402

import dsc_tpu  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch.parallel import P, Sharded, make_mesh  # noqa: E402

PKGS = (dsc_tpu, dt)


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


@pytest.fixture(autouse=True)
def young_heap():
    """Collect what a test left and freeze the rest, before the
    per-test gc.collect() of tests/conftest.py: that full collection then
    scans nothing, where it would rescan every JAX compile's objects so
    far (about 0.1 s a test by the end of this file)."""
    yield
    gc.collect(1)
    gc.freeze()


def _close(actual, target, eps):
    """tests/conftest.py's all_close: |a - t| <= eps + eps |t| elementwise."""
    return not np.any(~np.isclose(actual, target, atol=eps, rtol=eps, equal_nan=True))


def _numpy(t):
    return np.asarray(t.numpy()) if isinstance(t, (dsc_tpu.Tensor, dt.Tensor)) else np.asarray(t)


# (name, public function name, numpy function)
_BINARY = [
    ('add', 'add', np.add),
    ('sub', 'sub', np.subtract),
    ('mul', 'mul', np.multiply),
    ('div', 'true_div', np.true_divide),
]
_UNARY = [
    ('cos', 'cos', np.cos),
    ('sin', 'sin', np.sin),
    ('exp', 'exp', np.exp),
    ('sqrt', 'sqrt', np.sqrt),
    ('conj', 'conj', np.conj),
    ('absolute', 'absolute', np.absolute),
]
_REDUCE = [
    ('sum', 'sum', np.sum),
    ('mean', 'mean', np.mean),
    ('max', 'max', np.max),
    ('min', 'min', np.min),
]


def _rand_operand(rng, shape, complex_: bool):
    # magnitudes O(1), as tests/test_fuzz.py keeps them
    x = rng.uniform(-1.5, 1.5, shape)
    if complex_:
        x = (x + 1j * rng.uniform(-1.5, 1.5, shape)).astype(np.complex64)
    else:
        x = x.astype(np.float32)
    return x


# ---------------------------------------------------------------------------
# random chains (tests/test_fuzz.py::test_fuzz_chain)
# ---------------------------------------------------------------------------


def _chain_case(seed: int):
    """One random chain: creation -> 3-6 ops, through both packages and
    NumPy with the draws of tests/test_fuzz.py's sampler."""
    rng = np.random.default_rng(seed)
    rank = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(2, 7)) for _ in range(rank))
    complex_ = bool(rng.integers(0, 2))
    xn = _rand_operand(rng, shape, complex_)
    xs = [pkg.from_numpy(xn) for pkg in PKGS]

    def each(fn):
        return [fn(pkg, x) for pkg, x in zip(PKGS, xs)]

    n_ops = int(rng.integers(3, 7))
    ops_log = []
    for _ in range(n_ops):
        kind = rng.choice(['binary', 'unary', 'reduce', 'slice', 'fft',
                           'layout', 'pow', 'clip'])
        ops_log.append(str(kind))
        if kind == 'binary':
            name, attr, nfn = _BINARY[int(rng.integers(0, len(_BINARY)))]
            if rng.integers(0, 2):  # tensor RHS, same shape
                yn = _rand_operand(rng, xn.shape, bool(np.iscomplexobj(xn)))
                if name == 'div':
                    yn = yn + np.where(np.abs(yn) < 0.25, 0.5, 0.0).astype(yn.dtype)
                xs = each(lambda pkg, x: getattr(pkg, attr)(x, pkg.from_numpy(yn)))
                xn = nfn(xn, yn)
            else:  # scalar RHS
                s = float(rng.uniform(0.5, 2.0))
                xs = each(lambda pkg, x: getattr(pkg, attr)(x, s))
                xn = nfn(xn, np.asarray(s, dtype=np.float32 if not np.iscomplexobj(xn)
                                        else np.complex64))
        elif kind == 'unary':
            name, attr, nfn = _UNARY[int(rng.integers(0, len(_UNARY)))]
            if name == 'sqrt':
                # off the branch cut: the rfft bins' signed-zero imaginary
                # parts (tests/test_fuzz.py)
                xs, xn = each(lambda pkg, x: pkg.absolute(x)), np.absolute(xn)
            xs, xn = each(lambda pkg, x: getattr(pkg, attr)(x)), nfn(xn)
        elif kind == 'reduce' and xn.ndim >= 1 and xn.size > 1:
            name, attr, nfn = _REDUCE[int(rng.integers(0, len(_REDUCE)))]
            ax = int(rng.integers(-xn.ndim, xn.ndim))
            xs = each(lambda pkg, x: getattr(pkg, attr)(x, axis=ax, keepdims=True))
            xn = nfn(xn, axis=ax, keepdims=True)
        elif kind == 'slice' and xn.ndim >= 1 and xn.shape[0] > 1:
            step = int(rng.choice([1, 2, -1]))
            if xn[::step].size > 1:  # 1-element results unwrap to scalars
                xs, xn = [x[::step] for x in xs], xn[::step]
        elif kind == 'fft' and xn.shape[-1] >= 2:
            nfft = 1 << (int(xn.shape[-1] - 1).bit_length())
            if np.iscomplexobj(xn):
                xs = each(lambda pkg, x: pkg.ifft(pkg.fft(x)))
                xn = np.fft.ifft(np.fft.fft(xn.astype(np.complex64), n=nfft, axis=-1),
                                 axis=-1).astype(np.complex64)
            else:
                xs = each(lambda pkg, x: pkg.rfft(x))
                xn = np.fft.rfft(xn, n=nfft, axis=-1).astype(np.complex64)
        elif kind == 'layout':
            which = rng.choice(['transpose', 'reshape', 'concat'])
            if which == 'transpose' and xn.ndim >= 2:
                axes = tuple(rng.permutation(xn.ndim).tolist())
                xs, xn = each(lambda pkg, x: pkg.transpose(x, axes)), np.transpose(xn, axes)
            elif which == 'reshape':
                xs, xn = each(lambda pkg, x: pkg.reshape(x, -1)), xn.reshape(-1)
            elif xn.ndim <= 3:  # concat with self (rank cap is 4)
                ax = int(rng.integers(0, xn.ndim))
                xs = each(lambda pkg, x: pkg.concat([x, x], axis=ax))
                xn = np.concatenate([xn, xn], axis=ax)
        elif kind == 'pow':
            if np.iscomplexobj(xn):
                xs = each(lambda pkg, x: pkg.power(x, 2.0))
                xn = (xn ** np.complex64(2.0)).astype(np.complex64)
            else:  # real bases positive, exponents fractional
                e = float(rng.uniform(0.5, 1.5))
                xs = each(lambda pkg, x: pkg.power(pkg.add(pkg.absolute(x), 0.5), e))
                xn = (np.absolute(xn) + np.float32(0.5)) ** np.float32(e)
        elif kind == 'clip' and not np.iscomplexobj(xn):
            lo, hi = sorted(rng.uniform(-1.0, 1.0, 2).tolist())
            xs = each(lambda pkg, x: pkg.clip(x, lo, hi))
            xn = np.clip(xn, np.float32(lo), np.float32(hi))
        if isinstance(xn, np.generic):
            xn = np.asarray(xn)
    ref, got = (_numpy(x) for x in xs)
    return ops_log, xn, ref, got


@pytest.mark.parametrize('seed', range(60))
def test_fuzz_chain(seed):
    ops_log, xn, ref, got = _chain_case(seed)
    assert got.shape == ref.shape == xn.shape, (seed, ops_log, got.shape, ref.shape, xn.shape)
    assert got.dtype == ref.dtype, (seed, ops_log, got.dtype, ref.dtype)
    assert _close(got, ref, 1e-3), (
        f'seed {seed} ops {ops_log}: port vs dsc_tpu max |diff| = {np.abs(got - ref).max()}')
    assert _close(got, xn.astype(got.dtype), 1e-3), (
        f'seed {seed} ops {ops_log}: port vs NumPy max |diff| = '
        f'{np.abs(got - xn.astype(got.dtype)).max()}')


# ---------------------------------------------------------------------------
# dsc.compile equivalence (tests/test_fuzz.py::test_fuzz_compile_equivalence)
# ---------------------------------------------------------------------------


def _apply_program(pkg, instrs, t):
    """Replay an instruction list on a Tensor of ``pkg``: the same public
    calls eagerly and inside ``pkg.compile``'s trace. A closure operand is
    a NumPy array, made a Tensor of ``pkg`` (a program constant)."""
    for ins in instrs:
        kind = ins[0]
        if kind == 'binary':
            _, attr, rhs = ins
            t = getattr(pkg, attr)(t, pkg.from_numpy(rhs) if isinstance(rhs, np.ndarray) else rhs)
        elif kind == 'unary':
            t = getattr(pkg, ins[1])(t)
        elif kind == 'reduce':
            _, attr, ax = ins
            t = getattr(pkg, attr)(t, axis=ax, keepdims=True)
        elif kind == 'slice':
            t = t[:: ins[1]]
        elif kind == 'rfft':
            t = pkg.rfft(t)
        elif kind == 'fftpair':
            t = pkg.ifft(pkg.fft(t))
        elif kind == 'transpose':
            t = pkg.transpose(t, ins[1])
        elif kind == 'flatten':
            t = pkg.reshape(t, -1)
        elif kind == 'concat':
            t = pkg.concat([t, t], axis=ins[1])
        elif kind == 'clip':
            t = pkg.clip(t, ins[1], ins[2])
        elif kind == 'pow':
            t = pkg.power(pkg.add(pkg.absolute(t), 0.5), ins[1])
    return t


def _sample_program(seed):
    """tests/test_fuzz.py's trace-safe instruction sampler, drawing on the
    reference's eager intermediate for the shape and dtype checks."""
    dsc = dsc_tpu
    rng = np.random.default_rng(10_000 + seed)
    rank = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(2, 7)) for _ in range(rank))
    complex_ = bool(rng.integers(0, 2))
    xn = _rand_operand(rng, shape, complex_)
    t = dsc.from_numpy(xn)
    instrs = []
    for _ in range(int(rng.integers(3, 7))):
        kind = rng.choice(['binary', 'unary', 'reduce', 'slice', 'fft',
                           'layout', 'clip', 'pow'])
        cplx = t.dtype in (dsc.Dtype.C32, dsc.Dtype.C64)
        if kind == 'binary':
            name, attr, _ = _BINARY[int(rng.integers(0, len(_BINARY)))]
            if rng.integers(0, 2):
                yn = _rand_operand(rng, t.shape, cplx)
                if name == 'div':
                    yn = yn + np.where(np.abs(yn) < 0.25, 0.5, 0.0).astype(yn.dtype)
                ins = ('binary', attr, yn)
            else:
                ins = ('binary', attr, float(rng.uniform(0.5, 2.0)))
        elif kind == 'unary':
            name, attr, _ = _UNARY[int(rng.integers(0, len(_UNARY)))]
            if name == 'sqrt':  # off the branch cut (see the chain sampler)
                attr = 'absolute'
            ins = ('unary', attr)
        elif kind == 'reduce' and t.ne > 1:
            _, attr, _ = _REDUCE[int(rng.integers(0, len(_REDUCE)))]
            ins = ('reduce', attr, int(rng.integers(-t.n_dim, t.n_dim)))
        elif kind == 'slice' and t.n_dim >= 1 and t.shape[0] > 2:
            # more than one element: a 1-element result unwraps eagerly but
            # raises under the trace
            ins = ('slice', int(rng.choice([2, -1])))
        elif kind == 'fft' and t.shape[-1] >= 2:
            ins = ('fftpair',) if cplx else ('rfft',)
        elif kind == 'layout':
            which = rng.choice(['transpose', 'flatten', 'concat'])
            if which == 'transpose' and t.n_dim >= 2:
                ins = ('transpose', tuple(rng.permutation(t.n_dim).tolist()))
            elif which == 'flatten':
                ins = ('flatten',)
            elif t.n_dim <= 3:
                ins = ('concat', int(rng.integers(0, t.n_dim)))
            else:
                continue
        elif kind == 'clip' and not cplx:
            lo, hi = sorted(rng.uniform(-1.0, 1.0, 2).tolist())
            ins = ('clip', lo, hi)
        elif kind == 'pow' and not cplx:
            ins = ('pow', float(rng.uniform(0.5, 1.5)))
        else:
            continue
        t = _apply_program(dsc, [ins], t)
        if isinstance(t, (int, float, complex)):
            raise AssertionError('sampler produced a scalar unwrap')
        instrs.append(ins)
    return xn, instrs


@pytest.mark.parametrize('seed', range(16))
def test_fuzz_compile_equivalence(seed):
    """The same program compiled in both packages and run eagerly in the
    port: shapes and dtypes equal, values within the JAX test's eps."""
    xn, instrs = _sample_program(seed)
    ref = dsc_tpu.compile(lambda v: _apply_program(dsc_tpu, instrs, v))(dsc_tpu.from_numpy(xn))
    got = dt.compile(lambda v: _apply_program(dt, instrs, v))(dt.from_numpy(xn))
    eager = _apply_program(dt, instrs, dt.from_numpy(xn))
    assert got.shape == ref.shape == eager.shape, (seed, instrs)
    assert got.dtype.name == ref.dtype.name and got.dtype == eager.dtype, (seed, instrs)
    got, ref, eager = got.numpy(), ref.numpy(), eager.numpy()
    assert _close(got, ref, 1e-4), (
        f'seed {seed}: port compiled vs dsc_tpu compiled max |diff| = '
        f'{np.abs(got - ref).max()} over {instrs}')
    assert _close(got, eager, 1e-4), (
        f'seed {seed}: port compiled vs eager max |diff| = {np.abs(got - eager).max()}')


# ---------------------------------------------------------------------------
# dsc.map equivalence (tests/test_fuzz.py::test_fuzz_dsc_map_equivalence)
# ---------------------------------------------------------------------------

# (name, body step of a package, numpy step)
_MAP_UNARY = [
    ('cos', lambda pkg, t: pkg.cos(t), np.cos),
    ('sin', lambda pkg, t: pkg.sin(t), np.sin),
    ('exp', lambda pkg, t: pkg.exp(t * 0.25), lambda x: np.exp(x * 0.25)),
    ('sqrt', lambda pkg, t: pkg.sqrt(pkg.absolute(t)), lambda x: np.sqrt(np.abs(x))),
    ('sinc', lambda pkg, t: pkg.sinc(t), np.sinc),
    ('clip', lambda pkg, t: pkg.clip(t, -0.5, 0.75), lambda x: np.clip(x, -0.5, 0.75)),
    ('log', lambda pkg, t: pkg.logn(pkg.absolute(t) + 1.0), lambda x: np.log(np.abs(x) + 1.0)),
]


@pytest.mark.parametrize('seed', range(8))
def test_fuzz_dsc_map_equivalence(seed, monkeypatch):
    """Random elementwise bodies through both packages' dsc.map on their
    streaming kernels' route (K5's thresholds made small on both sides, as
    tests/test_fuzz.py makes the JAX package's), against each other, the
    port's eager chain and NumPy."""
    import dsc_tpu.ops.pallas_map as pm
    from dsc_tpu_torch.ops import stream_map as sm

    rng = np.random.default_rng(4200 + seed)
    for module in (pm, sm):
        monkeypatch.setattr(module, 'CHUNK_ROWS', 64)
        monkeypatch.setattr(module, 'MIN_ELEMS', 1024)
    monkeypatch.setattr(pm, 'MODE', 'on')
    ne = int(rng.choice([64 * 128 * 2, 64 * 128 * 3 + 1024]))
    a = rng.uniform(-1.5, 1.5, ne).astype(np.float32)
    b = rng.uniform(-1.5, 1.5, ne).astype(np.float32)
    sc = float(rng.uniform(-1.0, 1.0))
    steps = [_MAP_UNARY[int(rng.integers(0, len(_MAP_UNARY)))]
             for _ in range(int(rng.integers(1, 4)))]

    def body_of(pkg):
        def body(x, y):
            t = x * y + sc
            for _, step, _nfn in steps:
                t = step(pkg, t)
            return t
        return body

    def np_body(x, y):
        t = x * y + np.float32(sc)
        for _, _step, nfn in steps:
            t = nfn(t)
        return t

    names = [s[0] for s in steps]
    outs = []
    for pkg in PKGS:
        fused = pkg.map(body_of(pkg))
        outs.append(fused(pkg.from_numpy(a), pkg.from_numpy(b)).numpy())
        assert next(iter(fused._programs.values()))[0] == 'stream', (
            f'{pkg.__name__}: the case must take the streaming route, {names}')
    ref, got = outs
    eager = body_of(dt)(dt.from_numpy(a), dt.from_numpy(b)).numpy()
    assert _close(got, ref, 1e-5), (names, np.abs(got - ref).max())
    assert _close(got, eager, 1e-5), (names, np.abs(got - eager).max())
    assert _close(got, np_body(a, b), 1e-4), names


# ---------------------------------------------------------------------------
# mesh specs: seeded meshes and one spec per argument, axis tuples among them
# ---------------------------------------------------------------------------

MESH_SHAPES = [(8, 1), (4, 2), (2, 4)]
SPEC_CHOICES = [None, ('data',), ('model',), (('data', 'model'),), (('model', 'data'),)]
CPU8 = [torch.device('cpu')] * 8


def _mesh_programs(pkg):
    return {
        'elementwise': lambda x, y: pkg.add(pkg.mul(x, y), 1.0),
        'batched rfft': lambda x, h: pkg.irfft(pkg.mul(pkg.rfft(x), pkg.rfft(h))),
    }


def _mesh_numpy(program, x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    if program == 'elementwise':
        return x * y + 1.0
    return np.fft.irfft(np.fft.rfft(x, axis=-1) * np.fft.rfft(y, axis=-1), axis=-1)


def _mesh_case(seed):
    rng = np.random.default_rng(40_000 + seed)
    shape = MESH_SHAPES[int(rng.integers(0, len(MESH_SHAPES)))]
    specs = {program: [SPEC_CHOICES[int(rng.integers(0, len(SPEC_CHOICES)))] for _ in range(2)]
             for program in ('elementwise', 'batched rfft')}
    args = {'elementwise': [rng.standard_normal((16, 64)).astype(np.float32) for _ in range(2)],
            'batched rfft': [rng.standard_normal((16, 256)).astype(np.float32)
                             for _ in range(2)]}
    return shape, specs, args


@pytest.mark.parametrize('seed', range(16))
def test_fuzz_mesh_specs(seed):
    """Each program through both packages' compile(mesh=...) with the
    seed's specs, in and (for the cut result) out: the values within the
    JAX test's eps of dsc_tpu's and of NumPy's. Where the specs cut the
    arguments differently, the port places them as one of them is
    (fuse.py), as GSPMD reshards them."""
    shape, specs, args = _mesh_case(seed)
    jmesh, mesh = dsc_tpu.make_mesh(shape), make_mesh(shape, devices=CPU8)
    jprograms, programs = _mesh_programs(dsc_tpu), _mesh_programs(dt)
    for program, parts in specs.items():
        jf = dsc_tpu.compile(jprograms[program], mesh=jmesh,
                             in_specs=tuple(None if p is None else JP(*p) for p in parts))
        f = dt.compile(programs[program], mesh=mesh,
                       in_specs=tuple(None if p is None else P(*p) for p in parts))
        ref = jf(*[dsc_tpu.from_numpy(a) for a in args[program]]).numpy()
        for _ in range(2):  # the first call, then the program's replay
            out = f(*[dt.from_numpy(a) for a in args[program]])
            assert isinstance(out, (Sharded, dt.Tensor)), (seed, program, parts)
            got = np.asarray(out)
            assert got.shape == ref.shape, (seed, shape, program, parts)
            assert _close(got, ref, 1e-4), (
                f'seed {seed} mesh {shape} {program} specs {parts}: max |diff| '
                f'{np.abs(got - ref).max()}')
            assert _close(got, _mesh_numpy(program, *args[program]), 1e-4), (seed, program)
        assert f.n_programs == 1
