"""``dsc.compile(fn, mesh=, in_specs=, out_specs=)`` of dsc_tpu_torch
(fuse.py, parallel/mesh.py ``PartitionSpec``) and ``flags.py``, against
the JAX package's mesh programs (dsc_tpu/fuse.py) on the same seeded
inputs, on the CPU.

The port's mesh is eight entries of ``torch.device('cpu')`` beside the JAX
package's 8-device host mesh (tests/conftest.py); the cases are those of
tests/test_compile.py's mesh section and tests/test_iir.py's batch-sharded
sosfilt, at their shapes. A program that mixes values across a cut
dimension is refused (NotImplementedError) where the JAX package inserts
a collective, whatever values the first call passes. Bound: 1e-4 of
max(1, |reference|), against the JAX package and against NumPy/scipy in
float64.
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import scipy.signal as sps  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import dsc_tpu  # noqa: E402
import dsc_tpu.models as jmodels  # noqa: E402
import dsc_tpu_torch as dt  # noqa: E402
from dsc_tpu_torch import flags, tracing  # noqa: E402
from dsc_tpu_torch.fourier import config  # noqa: E402
from dsc_tpu_torch.ops import stream_map as sm  # noqa: E402
from dsc_tpu_torch.parallel import P, Sharded, make_mesh  # noqa: E402

BOUND = 1e-4
CPU8 = [torch.device('cpu')] * 8


@pytest.fixture(scope='module', autouse=True)
def port_ctx():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')
    dt.init(2**32, device='cpu')
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    dt.shutdown()


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, ref, bound=BOUND):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))
    assert err <= bound, err


def _mesh(shape=(8, 1)):
    return make_mesh(shape, devices=CPU8)


def _jax_mesh(shape=(8, 1)):
    return dsc_tpu.make_mesh(shape)


# ---------------------------------------------------------------------------
# the JAX package's mesh cases (tests/test_compile.py, tests/test_iir.py)
# ---------------------------------------------------------------------------


def test_compile_mesh_filterfft_batch_sharded():
    sn, fn_ = _rand((16, 512), 1), _rand(512, 2)

    def pipeline(pkg):
        return lambda sig, flt: pkg.irfft(pkg.mul(pkg.rfft(sig), pkg.rfft(flt)))

    jpipe = dsc_tpu.compile(pipeline(dsc_tpu), mesh=_jax_mesh(),
                            in_specs=(JP('data'), JP()), out_specs=JP('data'))
    ref = jpipe(dsc_tpu.from_numpy(sn), dsc_tpu.from_numpy(fn_)).numpy()
    mesh = _mesh()
    pipe = dt.compile(pipeline(dt), mesh=mesh, in_specs=(P('data'), P()), out_specs=P('data'))
    got = pipe(dt.from_numpy(sn), dt.from_numpy(fn_))
    # the result lies cut over the 8 'data' devices, 2 rows each
    assert isinstance(got, Sharded) and got.shape == (16, 512) and got.dtype == torch.float32
    assert got.mesh is mesh and (got.axis, got.dim) == ('data', 0)
    assert [tuple(s.shape) for s in got.shards] == [(2, 512)] * 8
    want = np.fft.irfft(np.fft.rfft(sn.astype(np.float64), axis=-1)
                        * np.fft.rfft(fn_.astype(np.float64)), axis=-1)
    _close(got.numpy(), ref)
    _close(got.numpy(), want)
    # NumPy arguments place as Tensors do, and take the same program
    _close(pipe(sn, fn_).full().numpy(), want)
    assert pipe.n_programs == 1


@pytest.mark.parametrize('cut', ['data-model', 'data'])
def test_compile_mesh_elementwise_and_reduction(cut):
    """The (4, 2) mesh case: with P('data', 'model') the sum runs over the
    'model'-cut dimension, which needs a collective: refused. With
    P('data') it is separable and equals the JAX package."""
    xn, yn = _rand((8, 1024), 3), _rand((8, 1024), 4)

    def stats(pkg):
        def f(x, y):
            d = pkg.sub(x, y)
            return pkg.sum(pkg.mul(d, d), axis=-1)
        return f

    spec = ('data', 'model') if cut == 'data-model' else ('data',)
    f = dt.compile(stats(dt), mesh=_mesh((4, 2)), in_specs=(P(*spec),) * 2)
    if cut == 'data-model':
        with pytest.raises(NotImplementedError, match='collective'):
            f(dt.from_numpy(xn), dt.from_numpy(yn))
        assert f.n_programs == 0  # nothing cached
        return
    jf = dsc_tpu.compile(stats(dsc_tpu), mesh=_jax_mesh((4, 2)), in_specs=(JP(*spec),) * 2)
    ref = jf(dsc_tpu.from_numpy(xn), dsc_tpu.from_numpy(yn)).numpy()
    got = f(dt.from_numpy(xn), dt.from_numpy(yn))
    assert isinstance(got, Sharded) and got.shape == (8, 1)
    # cut over 'data', each block on both 'model' coordinates
    assert [tuple(s.shape) for s in got.shards] == [(2, 1)] * 8
    _close(got.numpy(), ref)
    _close(got.numpy(), ((xn.astype(np.float64) - yn) ** 2).sum(-1, keepdims=True))


def test_compile_mesh_complex_args():
    zn, wn = _crand((8, 64), 5), _crand((8, 64), 6)
    jg = dsc_tpu.compile(lambda z, w: dsc_tpu.mul(z, dsc_tpu.conj(w)), mesh=_jax_mesh(),
                         in_specs=(JP('data'), JP('data')))
    ref = jg(dsc_tpu.from_numpy(zn), dsc_tpu.from_numpy(wn)).numpy()
    g = dt.compile(lambda z, w: dt.mul(z, dt.conj(w)), mesh=_mesh(),
                   in_specs=(P('data'), P('data')))
    got = g(dt.from_numpy(zn), dt.from_numpy(wn))
    assert isinstance(got, Sharded) and got.dtype == torch.complex64
    _close(got.numpy(), ref)
    _close(got.numpy(), zn.astype(np.complex128) * np.conj(wn))


@pytest.mark.parametrize('case', ['need mesh', 'in_specs', 'out_specs', 'divisible', 'axis'])
def test_compile_mesh_validation(case):
    x = dt.from_numpy(_rand((6, 8), 7))
    if case == 'need mesh':
        for kw in ({'in_specs': (P('data'),)}, {'out_specs': P('data')}):
            with pytest.raises(RuntimeError, match='need mesh'):
                dt.compile(lambda v: v, **kw)
        with pytest.raises(RuntimeError, match='need mesh'):
            dsc_tpu.compile(lambda v: v, in_specs=(JP('data'),))
    elif case == 'in_specs':
        f = dt.compile(lambda v: v, mesh=_mesh(), in_specs=(P(), P()))
        with pytest.raises(RuntimeError, match='in_specs'):
            f(dt.from_numpy(np.ones(4, np.float32)))
    elif case == 'out_specs':
        f = dt.compile(lambda v: (v, v), mesh=_mesh(), in_specs=(P(),),
                       out_specs=(P(), P(), P()))
        with pytest.raises(RuntimeError, match='out_specs has 3 entries for 2'):
            f(x)
        assert f.n_programs == 0
    elif case == 'divisible':
        f = dt.compile(lambda v: v, mesh=_mesh(), in_specs=(P('data'),))
        with pytest.raises(RuntimeError, match='not divisible'):
            f(x)
    else:
        f = dt.compile(lambda v: v, mesh=_mesh(), in_specs=(P('batch'),))
        with pytest.raises(RuntimeError, match="axis 'batch'"):
            f(x)


def test_compile_mesh_shards_batched_model_pipeline():
    """STFT -> mask -> ISTFT cut over 'data', against the JAX package's mesh
    program and the port's eager pipeline."""
    b, n, frame, hop = 8, 2048, 128, 32
    xs = _rand((b, n), 8)

    def pipe_of(pkg, models):
        stft = models.STFT(frame=frame, hop=hop, mode='complex')
        istft = models.ISTFT(frame=frame, hop=hop)

        def pipe(v):
            Z = stft(v)
            mag = pkg.absolute(Z)
            floor = pkg.mean(mag, axis=2, keepdims=True)
            gate = pkg.clip(pkg.sub(pkg.true_div(mag, floor), 2.0), 0.0, 1.0)
            return istft(pkg.mul(Z, gate), length=n)
        return pipe

    ref = dsc_tpu.compile(pipe_of(dsc_tpu, jmodels), mesh=_jax_mesh(),
                          in_specs=(JP('data'),))(dsc_tpu.from_numpy(xs)).numpy()
    pipe = pipe_of(dt, dt.models)
    f = dt.compile(pipe, mesh=_mesh(), in_specs=(P('data'),))
    got = f(dt.from_numpy(xs))
    assert isinstance(got, Sharded) and got.shape == (b, n)
    _close(got.numpy(), pipe(dt.from_numpy(xs)).numpy())
    _close(got.numpy(), ref)
    _close(f(xs).numpy(), ref)  # a second call: each shard replays its program


def test_compile_mesh_hermitian_arg_rejected():
    """A Tensor in the half-T layout (the JAX package's hermitian-half
    planes) cannot carry a PartitionSpec: refused at once."""
    n1 = n2 = 16
    h = _crand((n1, n2 // 2 + 1), 9)
    t = dt.from_t(h.real, h.imag, n1, n2, True)
    assert t._buf.layout == (n1, n2, True)
    for spec in (P('data'), P()):
        f = dt.compile(lambda z: z, mesh=_mesh(), in_specs=(spec,))
        with pytest.raises(RuntimeError, match='T or half-T layout.*hermitian'):
            f(t)


def test_compile_mesh_chained_sharded_resident(monkeypatch):
    """The Sharded result of one call feeds the next where it lies: no
    gather (a spy on Sharded.full) and the same program. The first call of
    a new signature gathers once, for its check."""
    xn, gn = _rand((16, 256), 10), _rand(1, 11)

    def step(pkg):
        return lambda x, g: pkg.mul(pkg.add(x, x), g)

    jf = dsc_tpu.compile(step(dsc_tpu), mesh=_jax_mesh(), in_specs=(JP('data'), JP()),
                         out_specs=JP('data'))
    jgt = dsc_tpu.from_numpy(gn)
    jy = jf(dsc_tpu.from_numpy(xn), jgt)
    mesh = _mesh()
    f = dt.compile(step(dt), mesh=mesh, in_specs=(P('data'), P()), out_specs=P('data'))
    gt = dt.from_numpy(gn)
    y = f(dt.from_numpy(xn), gt)
    assert isinstance(y, Sharded)
    gathers = []
    full = Sharded.full
    monkeypatch.setattr(Sharded, 'full', lambda self: gathers.append(self) or full(self))
    for _ in range(3):
        y = f(y, gt)
        jy = jf(jy, jgt)
    assert gathers == [] and f.n_programs == 1
    assert isinstance(y, Sharded) and y.mesh is mesh
    want = xn.astype(np.float64)
    for _ in range(4):
        want = (want + want) * gn[0]
    monkeypatch.setattr(Sharded, 'full', full)
    _close(y.numpy(), want)
    _close(y.numpy(), jy.numpy())

    # no in_specs: a Sharded argument keeps its placement
    f2 = dt.compile(lambda x: dt.add(x, 1.0), mesh=mesh)
    z = f2(y)
    assert isinstance(z, Sharded) and (z.axis, z.dim) == ('data', 0)
    monkeypatch.setattr(Sharded, 'full', lambda self: gathers.append(self) or full(self))
    z = f2(z)
    assert gathers == [] and f2.n_programs == 1
    monkeypatch.setattr(Sharded, 'full', full)
    _close(z.numpy(), want + 2.0)


def test_compile_mesh_shards_batched_sosfilt(monkeypatch):
    """tests/test_iir.py: the batch-sharded sosfilt. The JAX package's
    sosfilt caches constants made inside a compile's trace, and
    tests/test_iir.py's own case, run earlier in the same process, leaves
    this filter's there: the reference compiles over an empty cache of its
    own."""
    from dsc_tpu.models import iir as jiir

    monkeypatch.setattr(jiir, '_PLAN_CACHE', {})
    xs = _rand((8, 1024), 13)
    sos = jmodels.butter(3, 0.25)
    ref = dsc_tpu.compile(lambda v: jmodels.sosfilt(sos, v), mesh=_jax_mesh(),
                          in_specs=(JP('data'),))(dsc_tpu.from_numpy(xs)).numpy()
    f = dt.compile(lambda v: dt.models.sosfilt(sos, v), mesh=_mesh(), in_specs=(P('data'),))
    got = f(dt.from_numpy(xs))
    assert isinstance(got, Sharded) and got.shape == (8, 1024)
    want = sps.sosfilt(sos, xs.astype(np.float64), axis=-1)
    assert np.abs(got.numpy() - want).max() < BOUND * np.abs(want).max()
    _close(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the port's own cases: refusals, placement, results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('case', ['fft over the batch', 'sum over the batch',
                                  'transpose', 'row of the batch'])
def test_compile_mesh_refuses_programs_that_mix_shards(case):
    """Each of these needs a collective over 'data': refused, and no
    program is cached."""
    x = _crand((16, 64), 14)
    fn = {'fft over the batch': lambda v: dt.fft(v, axis=0),
          'sum over the batch': lambda v: dt.sum(v, axis=0),
          'transpose': lambda v: dt.transpose(v),
          'row of the batch': lambda v: v[0]}[case]
    f = dt.compile(fn, mesh=_mesh(), in_specs=(P('data'),))
    with pytest.raises(NotImplementedError, match='argument 0 with P'):
        f(dt.from_numpy(x))
    assert f.n_programs == 0


@pytest.mark.parametrize('first', ['scaled by 1e-5', 'zeros', 'equal rows',
                                   'replicated weight of zeros'])
def test_compile_mesh_check_is_not_fooled_by_the_first_call(first):
    """The rows less the batch mean mix the shards. A first call whose
    shards happen to agree with the global run (values far below 1, zeros,
    equal rows, a replicated factor of zeros) must not certify the program:
    the check holds the shards to max |global| with no floor, and on seeded
    probe arguments too. A later call at normal scale would otherwise
    return the per-shard mean."""
    xn = _rand((16, 64), 24)
    wn = np.ones(64, np.float32)
    if first == 'scaled by 1e-5':
        xn = xn * np.float32(1e-5)
    elif first == 'zeros':
        xn = np.zeros_like(xn)
    elif first == 'equal rows':
        xn = np.broadcast_to(xn[:1], xn.shape).copy()
    else:
        wn = np.zeros_like(wn)
    f = dt.compile(lambda x, w: dt.sub(x, dt.mul(w, dt.mean(x, axis=0, keepdims=True))),
                   mesh=_mesh(), in_specs=(P('data'), P()))
    with pytest.raises(NotImplementedError, match='argument 0 with P'):
        f(xn, wn)
    assert f.n_programs == 0
    with pytest.raises(NotImplementedError, match='argument 0 with P'):
        f(_rand((16, 64), 25), np.ones(64, np.float32))


@pytest.mark.parametrize('scale', [1e-5, 0.0])
def test_compile_mesh_separable_program_on_small_values(scale):
    """Without the floor a separable program still passes on small and on
    zero first calls, and a later call at normal scale is right."""
    xn = _rand((16, 512), 26)
    f = dt.compile(lambda x: dt.irfft(dt.mul(dt.rfft(x), 2.0)), mesh=_mesh(),
                   in_specs=(P('data'),))
    _close(f(xn * np.float32(scale)).numpy(), 2.0 * scale * xn.astype(np.float64))
    _close(f(xn).numpy(), 2.0 * xn.astype(np.float64))
    assert f.n_programs == 1


@pytest.mark.parametrize('scale', [1e-5, 1.0, 1e5])
def test_mesh_agree_is_relative_to_the_largest_value(scale):
    """The check's bound is MESH_BOUND of max |global| at any scale."""
    from dsc_tpu_torch.fuse import MESH_BOUND, _agree
    want = torch.from_numpy(_rand((4, 64), 27)) * scale
    err = float(want.abs().max()) * MESH_BOUND
    assert _agree(want + 0.5 * err, want)
    assert not _agree(want + 2.0 * err, want)
    assert _agree(torch.zeros(4, 64), torch.zeros(4, 64))
    assert not _agree(torch.full((4, 64), 1e-30), torch.zeros(4, 64))


def test_compile_mesh_sticky_replicated_argument():
    """A replicated Tensor is placed once (its copies kept by buffer) and
    placed again after a write into it."""
    mesh = _mesh()
    f = dt.compile(lambda x, g: dt.mul(x, g), mesh=mesh, in_specs=(P('data'), P()),
                   out_specs=P('data'))
    xn = _rand((16, 64), 15)
    g = dt.from_numpy(_rand(64, 16))
    f(xn, g)
    first = f._replicas[g._buf]
    # on its own device the copy is the buffer itself
    assert all(c.data_ptr() == g._buf.data.data_ptr() for c in first[2].values())
    f(xn, g)
    assert f._replicas[g._buf] is first
    g[0] = 5.0
    got = f(xn, g)
    assert f._replicas[g._buf] is not first
    _close(got.numpy(), xn * g.numpy())


def test_compile_mesh_results_replicated_joined_and_nested():
    """A result equal on every shard comes back as one Tensor; with P() a
    result whose blocks tile is gathered into one; nested structure is
    kept; a Sharded argument on another spec is gathered and placed."""
    mesh = _mesh()
    xn, wn = _rand((16, 32), 17), _rand(32, 18)
    f = dt.compile(lambda x, w: ([dt.mul(x, w)], (dt.add(w, 1.0),)), mesh=mesh,
                   in_specs=(P('data'), P()))
    (a,), (b,) = f(xn, wn)
    assert isinstance(a, Sharded) and isinstance(b, dt.Tensor) and b.shape == (32,)
    _close(a.numpy(), xn * wn)
    _close(b.numpy(), wn + 1.0)
    g = dt.compile(lambda x: dt.mul(x, 2.0), mesh=mesh, in_specs=(P('data'),),
                   out_specs=P())
    got = g(xn)
    assert isinstance(got, dt.Tensor) and got.shape == (16, 32)
    _close(got.numpy(), 2.0 * xn)
    # a Sharded argument with P(): gathered, replicated, the result equal
    h = dt.compile(lambda x: dt.mul(x, 3.0), mesh=mesh, in_specs=(P(),))
    got = h(a)
    assert isinstance(got, dt.Tensor)
    _close(got.numpy(), 3.0 * xn * wn)


def test_compile_mesh_cut_over_two_axes_joined():
    """P('data', 'model') on an elementwise program: separable, the result
    cut over both axes comes back joined into one Tensor."""
    xn, yn = _rand((8, 1024), 19), _rand((8, 1024), 20)
    f = dt.compile(lambda x, y: dt.add(x, y), mesh=_mesh((4, 2)),
                   in_specs=(P('data', 'model'),) * 2)
    got = f(xn, yn)
    assert isinstance(got, dt.Tensor) and got.shape == (8, 1024)
    _close(got.numpy(), xn.astype(np.float64) + yn)


def test_compile_mesh_lru_trace_event_and_kwargs(monkeypatch):
    """DSC_MAX_PROGRAMS bounds the programs; one compile:<name> event a
    call; keyword Tensors are replicated."""
    monkeypatch.setenv('DSC_MAX_PROGRAMS', '2')
    mesh = _mesh()

    def scaled(x, k=None):
        return dt.mul(x, k)

    f = dt.compile(scaled, mesh=mesh, in_specs=(P('data'),))
    k = _rand(8, 21)
    for rows in (8, 16, 24):
        _close(f(_rand((rows, 8), rows), k=k).numpy(), _rand((rows, 8), rows) * k)
    assert f.n_programs == 2
    tracing.clear_traces()
    tracing.set_recording(True)
    f(_rand((24, 8), 24), k=k)
    tracing.set_recording(False)
    names = [e['name'] for e in tracing._events if e['ph'] == 'B']
    tracing.clear_traces()
    assert names == ['compile:scaled']
    f.clear_cache()
    assert f.n_programs == 0


# ---------------------------------------------------------------------------
# flags.py
# ---------------------------------------------------------------------------


def _routes():
    """fourier/config.py's routes and batched engines, and K5's routes, over
    a spread of shapes."""
    out = []
    for batch, n in ((1, 2**18), (1, 2**20), (4, 2**20), (16, 512), (1, 4096)):
        out.append((config.fft_route(dt.Dtype.C32, batch, n, False),
                    config.rfft_route(dt.Dtype.F32, batch, n),
                    config.irfft_route(dt.Dtype.C32, batch, n),
                    config.use_base_kernel(np.complex64, n), config.use_stream(batch, n),
                    config.use_packed(n),
                    config.batched_engine('c2c', torch.complex64, batch, n),
                    config.batched_engine('r2c', torch.float32, batch, n),
                    config.batched_engine('c2r', torch.complex64, batch, n)))
    out.append(sm.route([(4096, 4096)], [torch.float32]))
    return out


@pytest.mark.parametrize('flag', ['xla_only', 'kernel_trace'])
def test_flags_nest_unwind_and_gate_no_route(flag):
    enter, active = getattr(flags, flag), getattr(flags, f'{flag}_active')
    outside = _routes()
    assert not active()
    with enter():
        assert active()
        with enter():
            assert active()
        assert active()
        assert _routes() == outside  # a CUDA tensor keeps its kernels inside
    assert not active()
    with pytest.raises(ValueError):
        with enter():
            raise ValueError
    assert not active()


def test_mesh_program_runs_its_shards_under_xla_only():
    seen = []

    def fn(x):
        seen.append(flags.xla_only_active())
        return dt.add(x, 1.0)

    f = dt.compile(fn, mesh=_mesh(), in_specs=(P('data'),))
    f(_rand((8, 4), 22))
    assert seen and all(seen)  # the check run and each shard's
    assert not flags.xla_only_active()
    seen.clear()
    dt.compile(fn)(dt.from_numpy(_rand((8, 4), 22)))
    assert seen == [False]  # a single-device program does not


def test_map_records_its_body_under_kernel_trace():
    seen = []

    def body(x, y):
        seen.append(flags.kernel_trace_active())
        return dt.add(dt.mul(x, y), 1.0)

    xs = dt.from_numpy(_rand(2**21, 23))
    out = dt.map(body)(xs, xs)
    assert seen[0] is True and not flags.kernel_trace_active()
    _close(out.numpy(), xs.numpy() ** 2 + 1.0)


# ---------------------------------------------------------------------------
# a dimension cut over a tuple of mesh axes (NamedSharding's order: the
# device at (c_data, c_model) holds block c_data * |model| + c_model under
# P(('data', 'model')), block c_model * |data| + c_data under
# P(('model', 'data')))
# ---------------------------------------------------------------------------

TUPLE_SPECS = {'(data, model)': (('data', 'model'),), '(model, data)': (('model', 'data'),),
               '(data, model), None': (('data', 'model'), None)}


def _tuple_program(pkg, program):
    if program == '2x + 1':
        return lambda x: pkg.add(pkg.mul(x, 2.0), 1.0)
    return lambda sig, flt: pkg.irfft(pkg.mul(pkg.rfft(sig), pkg.rfft(flt)))


def _held_to_jax_shards(got, ref, jmesh):
    """Each port shard equals the block the JAX array holds on the device
    at the same mesh position."""
    jdevices = list(jmesh.devices.flat)
    arr = ref.jax
    assert len(arr.addressable_shards) == len(got.shards)
    for shard in arr.addressable_shards:
        _close(got.shards[jdevices.index(shard.device)].numpy(), np.asarray(shard.data))


@pytest.mark.parametrize('program', ['2x + 1', 'filterFFT'])
@pytest.mark.parametrize('spec', list(TUPLE_SPECS))
@pytest.mark.parametrize('shape', [(4, 2), (2, 4)])
def test_compile_mesh_tuple_cut_matches_jax(shape, spec, program):
    parts = TUPLE_SPECS[spec]
    axes = parts[0]
    sn, fn_ = _rand((16, 512), 28), _rand(512, 29)
    args_np = (sn,) if program == '2x + 1' else (sn, fn_)
    jmesh = _jax_mesh(shape)
    jin = (JP(*parts),) + (JP(),) * (len(args_np) - 1)
    jf = dsc_tpu.compile(_tuple_program(dsc_tpu, program), mesh=jmesh, in_specs=jin,
                         out_specs=JP(*parts))
    ref = jf(*[dsc_tpu.from_numpy(a) for a in args_np])
    mesh = _mesh(shape)
    f = dt.compile(_tuple_program(dt, program), mesh=mesh,
                   in_specs=(P(*parts),) + (P(),) * (len(args_np) - 1), out_specs=P(*parts))
    got = f(*[dt.from_numpy(a) for a in args_np])
    assert isinstance(got, Sharded) and got.mesh is mesh and got.shape == (16, 512)
    assert (got.axis, got.dim) == (axes, 0)
    assert [tuple(s.shape) for s in got.shards] == [(2, 512)] * 8
    # the block rule: the device at (c0, c1) holds block c_a * |b| + c_b
    size = dict(mesh.shape)
    x64 = sn.astype(np.float64)
    want = (2.0 * x64 + 1.0 if program == '2x + 1' else np.fft.irfft(
        np.fft.rfft(x64, axis=-1) * np.fft.rfft(fn_.astype(np.float64)), axis=-1))
    for i, s in enumerate(got.shards):
        coords = dict(zip(mesh.axis_names, np.unravel_index(i, mesh.devices.shape)))
        block = coords[axes[0]] * size[axes[1]] + coords[axes[1]]
        _close(s.numpy(), want[2 * block:2 * block + 2])
    _held_to_jax_shards(got, ref, jmesh)
    _close(got.numpy(), ref.numpy())
    _close(got.numpy(), want)


def test_compile_mesh_tuple_cut_chains_without_a_gather(monkeypatch):
    """A result cut over an axis tuple feeds the next call where it lies,
    with the spec and with none; the value against the JAX package's chain."""
    xn = _rand((16, 64), 30)
    step = _tuple_program(dt, '2x + 1')
    jstep = _tuple_program(dsc_tpu, '2x + 1')
    spec = ('model', 'data')
    jf = dsc_tpu.compile(jstep, mesh=_jax_mesh((4, 2)), in_specs=(JP(spec),),
                         out_specs=JP(spec))
    mesh = _mesh((4, 2))
    f = dt.compile(step, mesh=mesh, in_specs=(P(spec),), out_specs=P(spec))
    y, jy = f(xn), jf(dsc_tpu.from_numpy(xn))
    assert isinstance(y, Sharded) and y.axis == spec
    gathers = []
    full = Sharded.full
    monkeypatch.setattr(Sharded, 'full', lambda self: gathers.append(self) or full(self))
    for _ in range(2):
        y, jy = f(y), jf(jy)
    assert gathers == [] and f.n_programs == 1
    f2 = dt.compile(step, mesh=mesh)  # no spec: the Sharded argument keeps its placement
    z = f2(y)
    assert isinstance(z, Sharded) and (z.axis, z.dim) == (spec, 0)
    assert gathers == [y]  # the first call of a signature gathers once, for its check
    gathers.clear()
    z = f2(z)
    assert gathers == [] and f2.n_programs == 1
    monkeypatch.setattr(Sharded, 'full', full)
    want = xn.astype(np.float64)
    for _ in range(5):
        want = 2.0 * want + 1.0
    _close(z.numpy(), want)
    _close(y.numpy(), jy.numpy())


@pytest.mark.parametrize('spec', [('data', 'model'), ('model', 'data')])
def test_compile_mesh_tuple_cut_refuses_a_sum_over_it(spec):
    x = _rand((16, 64), 31)
    f = dt.compile(lambda v: dt.sum(v, axis=0, keepdims=True), mesh=_mesh((2, 4)),
                   in_specs=(P(spec),))
    with pytest.raises(NotImplementedError, match=r"argument 0 with P\(\(" + repr(spec[0])):
        f(x)
    assert f.n_programs == 0


def test_compile_mesh_tuple_cut_must_divide_by_the_product():
    x = _rand((12, 64), 32)  # 12 rows over 4 x 2 = 8 blocks
    spec = ('data', 'model')
    jf = dsc_tpu.compile(lambda v: dsc_tpu.add(v, 1.0), mesh=_jax_mesh((4, 2)),
                         in_specs=(JP(spec),))
    with pytest.raises(ValueError, match='divisible'):
        jf(dsc_tpu.from_numpy(x))
    f = dt.compile(lambda v: dt.add(v, 1.0), mesh=_mesh((4, 2)), in_specs=(P(spec),))
    with pytest.raises(RuntimeError, match=r"not divisible by the mesh axes \('data', 'model'\) "
                                           r'\(8\)'):
        f(x)
    # 16 rows divide by 8 and by each axis alone
    _close(f(_rand((16, 64), 32)).numpy(), _rand((16, 64), 32) + 1.0)


@pytest.mark.parametrize('spec', [P(('data', 'data')), P('data', ('model', 'data')),
                                  P(('data', 'batch'))])
def test_compile_mesh_tuple_names_checked(spec):
    f = dt.compile(lambda v: v, mesh=_mesh((4, 2)), in_specs=(spec,))
    with pytest.raises(RuntimeError, match='twice|not in'):
        f(_rand((16, 64), 33))


def test_compile_mesh_arguments_cut_differently_are_placed_anew():
    """x cut over 'data', y replicated, z over ('model', 'data'), all of
    one shape: the specs' own shards cannot run (blocks of other sizes),
    so y and z are placed as x is, as GSPMD reshards them; the value is
    the JAX package's, and later calls place them so again."""
    xn, yn, zn = _rand((16, 64), 34), _rand((16, 64), 35), _rand((16, 64), 36)

    def fma(pkg):
        return lambda x, y, z: pkg.add(pkg.mul(x, y), z)

    specs = ('data', None, ('model', 'data'))
    jf = dsc_tpu.compile(fma(dsc_tpu), mesh=_jax_mesh((4, 2)),
                         in_specs=tuple(JP(s) if s else None for s in specs))
    ref = jf(*[dsc_tpu.from_numpy(a) for a in (xn, yn, zn)]).numpy()
    f = dt.compile(fma(dt), mesh=_mesh((4, 2)),
                   in_specs=tuple(P(s) if s else None for s in specs))
    for _ in range(2):
        got = f(xn, yn, zn)
        assert isinstance(got, Sharded) and (got.axis, got.dim) == ('data', 0)
        _close(got.numpy(), ref)
        _close(got.numpy(), xn.astype(np.float64) * yn + zn)
    prog = next(iter(f._programs.values()))
    assert prog.layouts == [{0: ('data',)}] * 3 and f.n_programs == 1
