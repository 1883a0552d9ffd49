"""IIR filtering and design (dsc_tpu/models/iir.py): ``lfilter``,
``sosfilt``, ``sosfiltfilt``, ``filtfilt``, ``decimate``, ``butter``,
``cheby1``, ``cheby2`` and the host conversions around them.

An IIR filter is a linear recurrence. The transposed direct-form II state
update ``s[n] = A s[n-1] + c x[n]`` is an affine map, and affine maps
compose associatively, so a section runs without a loop over time:

- at n >= 4096, as block-Toeplitz matrix products against a host-built
  ladder of weights (``_linrec_plan``): the signal in chunks of
  ``_LINREC_M`` = 256 samples is one (n/256, 256) x (256, 256 + m) product,
  and the chunk-boundary states solve the same recurrence one level up
  (a middle level of (256 m, 257 m) weights while more than
  ``_LINREC_BASE`` = 512 chunks remain), down to a flat scan;
- below 4096 samples, and at the bottom of the ladder, as a log-depth scan:
  ceil(log2 T) doubling steps, each one batched (m x m) composition over all
  positions (``_scan``);
- ``method='sequential'`` keeps the exact step in a loop over time, for
  reference and streaming use.

The products are ``torch.matmul`` / ``einsum`` (the JAX package computes
them with ``jnp.matmul`` outside any Pallas kernel); no TPU kernel is on
this path. They run in full float32 whatever the caller's TF32 setting
(``_full_f32``): TF32 compounds its rounding over the ladder's levels, as
bf16 did on the TPU (7.8e-3 relative error at 2^16 there).

The ladders and the per-filter constants live on the device in a FIFO of
32 entries keyed on the filter bytes and the device (``_PLAN_CACHE``), so a
call uploads nothing once its filter has been seen; a ``dsc.compile``
trace run fills it, and an entry missing while a CUDA graph is captured
raises. scipy.signal is the executable spec; the design math runs on the
host in float64.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..capture import capturing
from ..tensor import Tensor

# --------------------------------------------------------------------------
# device half: affine recurrence
# --------------------------------------------------------------------------


def _tdf2_matrices(b, a):
    """Transposed direct-form II state-space for a0=1 coefficient rows:
    y[n]   = b0 x[n] + s1[n-1]
    si[n]  = b_i x[n] - a_i y[n] + s_{i+1}[n-1]
    =>  s[n] = A s[n-1] + c x[n],  y[n] = b0 x[n] + s1[n-1]
    with A[i,0] = -a_{i+1}, A[i,i+1] = 1, c_i = b_{i+1} - a_{i+1} b0.
    """
    m = b.shape[0] - 1
    A = np.zeros((m, m), np.float64)
    A[:, 0] = -a[1:]
    A[: m - 1, 1:] += np.eye(m - 1)
    c = b[1:] - a[1:] * b[0]
    return A, c


_LINREC_M = 256  # chunk length of the Toeplitz ladder
_LINREC_BASE = 512  # chunk counts up to this take the flat scan
_TOEPLITZ_MIN = 4096  # 'parallel' sections of this many samples take the ladder

# Device-resident constants: the ladders of _linrec_plan and each filter's
# (A, c, b0) tensors, keyed on the exact filter bytes, the length where it
# matters, and the device; FIFO eviction at 32 entries ('ba', 'sos' and
# 'sosff' entries and ladders share it).
_PLAN_CACHE: dict = {}
_MAX_PLANS = 32
_cache_lock = threading.Lock()


def _cached(key, make):
    """The cache entry of ``key``, built by ``make()`` on a miss. A miss
    while a CUDA graph is being captured raises: the upload cannot be
    captured."""
    with _cache_lock:
        hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    if capturing():
        raise RuntimeError(
            f'dsc.compile: the IIR constants {key[0] if isinstance(key[0], str) else "ladder"!r}'
            f' on {key[-1]} were evicted from the plan cache (FIFO of {_MAX_PLANS}) between '
            'the compiled function\'s trace run and its CUDA graph capture: the function '
            f'uses more than {_MAX_PLANS} filters and lengths')
    hit = make()
    with _cache_lock:
        if len(_PLAN_CACHE) >= _MAX_PLANS:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[key] = hit
    return hit


def _upload(a, device) -> torch.Tensor:
    """A host array rounded once to float32 and copied onto ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _linrec_plan_cached(A, c, n, device):
    key = (np.asarray(A, np.float64).tobytes(), np.asarray(c, np.float64).tobytes(), int(n),
           str(device))
    return _cached(key, lambda: _linrec_plan(A, c, n, device))


def _linrec_plan(A, c, n, device):
    """The weight ladder of the block-Toeplitz recurrence solver, built on
    the host in float64, rounded to float32 once and copied to ``device``
    (the JAX package's _linrec_plan, level by level the same float32
    arrays).

    Returns a tuple of per-level tuples of tensors:
      level 0 (scalar input): (Wmat (M, M+m), C (M, m), Wr (M, m),
                               Pr (m, m))
      middle levels (vector input): (Wmat (M*m, (M+1)*m), Cv (M, m, m))
      last level: (Abase (m, m),) for the flat base-case scan.
    """
    A = np.asarray(A, np.float64)
    c = np.asarray(c, np.float64)
    m = A.shape[0]
    M = _LINREC_M

    def powers(B):
        P = np.empty((M + 1, m, m))
        P[0] = np.eye(m)
        for p in range(1, M + 1):
            P[p] = B @ P[p - 1]
        return P

    def f32(a):
        return _upload(a, device)

    P = powers(A)
    v = P @ c                                        # (M+1, m): A^p c
    ii = np.arange(M)
    expo = ii[None, :] - ii[:, None] - 1             # (i, j) -> j-1-i
    W0 = np.where(expo >= 0, v[np.clip(expo, 0, M), 0], 0.0)
    WL = v[M - 1 - ii]                               # (i, m): chunk ends
    r = n % M
    Wr = np.where((ii < r)[:, None], v[np.clip(r - 1 - ii, 0, M)], 0.0)
    levels = [(f32(np.concatenate([W0, WL], axis=1)), f32(P[:M, 0, :]),
               f32(Wr), f32(P[r]))]
    T = -(-n // M)
    B = P[M]                                         # A^M
    while T > _LINREC_BASE:
        P = powers(B)
        Wl = np.where((expo >= 0)[:, :, None, None],
                      P[np.clip(expo, 0, M)], 0.0)   # (i, j, d, e)
        WLv = P[M - 1 - ii][:, None]                 # (i, 1, d, e): j = M
        W = np.concatenate([Wl, WLv], axis=1)
        Wmat = W.transpose(0, 3, 1, 2).reshape(M * m, (M + 1) * m)
        levels.append((f32(Wmat), f32(P[:M])))
        T = -(-T // M)
        B = P[M]
    levels.append((f32(B),))
    return tuple(levels)


@contextmanager
def _full_f32():
    """float32 matrix products in full precision inside the block, the
    caller's settings restored after it: TF32 (``allow_tf32``, float32
    matmul precision 'high'/'medium', or ``fp32_precision = 'tf32'``)
    would round the ladder's products to 10 mantissa bits. Both of
    PyTorch's interfaces are set, since cuBLAS refuses a mix of the two."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        legacy = None  # the caller set only the new interface
    if legacy is not None:
        torch.set_float32_matmul_precision('highest')
    matmul.fp32_precision = 'ieee'
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        matmul.fp32_precision = prev


def _scan(A: torch.Tensor, f: torch.Tensor):
    """Inclusive scan of the affine maps s -> A s + f[:, t]: (M (T, m, m),
    w (b, T, m)) with M[t] = A^(t+1) and w[t] = sum_{u <= t} A^(t-u) f[:, u],
    in ceil(log2 T) doubling steps, each one batched (m x m) composition
    (Ar, br) o (Al, bl) = (Ar Al, Ar bl + br) over all positions. The
    matrices are the same in every batch row, so they are composed once."""
    T = f.shape[1]
    Ms = A.expand(T, *A.shape)
    w = f
    d = 1
    while d < T:
        w = torch.cat([w[:, :d], torch.matmul(Ms[d:], w[:, :-d, :, None])[..., 0] + w[:, d:]],
                      dim=1)
        Ms = torch.cat([Ms[:d], torch.matmul(Ms[d:], Ms[:-d])])
        d *= 2
    return Ms, w


def _linrec_apply_vec(f, levels, u0):
    """Vector-input recurrence s_{t+1} = A s_t + f_t via the plan's
    weight ladder. f: (b, T, m); returns (s_pre[:, t] = s_t, s_T)."""
    bsz, T, m = f.shape
    if len(levels) == 1:
        (Ab,) = levels[0]
        Mk, wk = _scan(Ab, f)
        s_all = torch.einsum('kmn,bn->bkm', Mk, u0) + wk
        s_pre = torch.cat([u0[:, None], s_all[:, :-1]], dim=1)
        return s_pre, s_all[:, -1]
    Wmat, Cv = levels[0]
    M = Wmat.shape[0] // m
    K = -(-T // M)
    fp = F.pad(f, (0, 0, 0, K * M - T))
    out = torch.matmul(fp.reshape(bsz * K, M * m), Wmat)
    out = out.reshape(bsz, K, M + 1, m)
    s_loc, L = out[:, :, :M], out[:, :, M]
    e_pre, e_T = _linrec_apply_vec(L, levels[1:], u0)
    corr = torch.einsum('jde,bke->bkjd', Cv, e_pre)
    s_pre = (s_loc + corr).reshape(bsz, K * M, m)
    if T == K * M:
        return s_pre, e_T
    return s_pre[:, :T], s_pre[:, T]


def _linrec_scalar(x, plan, b0, zi):
    """One linear section y = b0 x + s[..0], s' = A s + c x, solved by
    matrix products against the host-built plan. Only state component 0
    is materialized (all y needs); the final state zf is reconstructed
    from the tail chunk. x: (b, n)."""
    Wmat, C, Wr, Pr = plan[0]
    bsz, n = x.shape
    m = C.shape[1]
    M = Wmat.shape[0]
    K = -(-n // M)
    xp = F.pad(x, (0, K * M - n))
    xc = xp.reshape(bsz, K, M)
    out = torch.matmul(xp.reshape(bsz * K, M), Wmat)
    out = out.reshape(bsz, K, M + m)
    s0_loc, L = out[..., :M], out[..., M:]
    e_pre, e_T = _linrec_apply_vec(L, plan[1:], zi)
    corr0 = torch.einsum('je,bke->bkj', C, e_pre)
    y = (b0 * xc + s0_loc + corr0).reshape(bsz, K * M)[:, :n]
    if n == K * M:
        return y, e_T
    q = n // M
    zf = torch.matmul(xc[:, q], Wr) + torch.einsum('de,be->bd', Pr, e_pre[:, q])
    return y, zf


def _affine_filter(x, A, c, b0, zi, method='parallel', plan=None):
    """(batch, n) signal through one linear section. A: (m, m), c: (m,),
    zi: (batch, m) initial state, ``plan``: the weight ladder
    (_linrec_plan) of the Toeplitz route, given at n >= 4096 with
    'parallel'. Returns (y, zf)."""
    if method == 'sequential':
        at = A.T
        s = zi
        ys = []
        for t in range(x.shape[1]):
            xn = x[:, t]
            ys.append(b0 * xn + s[:, 0])
            s = torch.matmul(s, at) + xn[:, None] * c[None, :]
        return torch.stack(ys, dim=1), s
    if plan is not None:
        return _linrec_scalar(x, plan, b0, zi)
    # the flat scan of the affine maps (A, c x[n])
    cb = x[..., None] * c[None, None, :]  # (b, n, m)
    cb = torch.cat([cb[:, :1] + torch.matmul(zi, A.T)[:, None], cb[:, 1:]], dim=1)
    _, s_all = _scan(A, cb)
    s_prev = torch.cat([zi[:, None, :], s_all[:, :-1]], dim=1)
    y = b0 * x + s_prev[..., 0]
    return y, s_all[:, -1]


def _norm_ba(b, a, who: str):
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0.0:
        raise RuntimeError(f'{who}: a[0] must be nonzero')
    b, a = b / a[0], a / a[0]
    m = max(b.shape[0], a.shape[0]) - 1
    if m < 1:
        raise RuntimeError(f'{who}: filter order must be >= 1')
    b = np.pad(b, (0, m + 1 - b.shape[0]))
    a = np.pad(a, (0, m + 1 - a.shape[0]))
    return b, a, m


def _as_batched(x: Tensor, who: str):
    """(float32 (b, n) rows of a real 1-D or 2-D signal, whether it was 2-D)."""
    if x.n_dim > 2:
        raise RuntimeError(f'{who}: expected a 1-D or 2-D signal, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError(f'{who} expects a real signal')
    xj = x.torch.to(torch.float32)
    return (xj if x.n_dim == 2 else xj[None, :]), x.n_dim == 2


def _initial_state(zi, who: str, shape: tuple, device) -> torch.Tensor:
    """``zi`` as a float32 tensor of ``shape`` on ``device``: a Tensor as it
    is, an array-like uploaded (not while a CUDA graph is captured, which
    cannot hold the upload); one dimension fewer broadcasts over the batch."""
    if isinstance(zi, Tensor):
        z0 = zi.torch.to(device=device, dtype=torch.float32)
    else:
        if capturing():
            raise RuntimeError(
                f'{who}: zi was given as a host array inside dsc.compile, whose CUDA graph '
                'cannot capture its upload; pass zi as a Tensor')
        z0 = torch.from_numpy(np.array(zi, np.float32))
    if z0.dim() == len(shape) - 1:
        z0 = z0[None].expand((shape[0],) + tuple(z0.shape))
    if tuple(z0.shape) != shape:
        raise RuntimeError(f'{who}: zi has shape {tuple(z0.shape)}, expected {shape}')
    return z0.to(device)


def _ba_constants(bb, aa, device):
    """(A, c) in float64 and A, c, b0 on ``device`` of a normalized (b, a)."""
    def make():
        A, c = _tdf2_matrices(bb, aa)
        return A, c, _upload(A, device), _upload(c, device), _upload(bb[0], device)

    return _cached(('ba', bb.tobytes(), aa.tobytes(), str(device)), make)


def _sos_constants(sos, device, steady: bool):
    """The sections' (A, c) in float64 and stacked A, c, b0 on ``device``;
    with ``steady`` also the unit-step steady states (sosfiltfilt's
    'sosff' entry)."""
    def make():
        secs = [_tdf2_matrices(sos[s, :3], sos[s, 3:]) for s in range(sos.shape[0])]
        out = (secs, _upload(np.stack([A for A, _ in secs]), device),
               _upload(np.stack([c for _, c in secs]), device), _upload(sos[:, 0], device))
        return out + (_upload(_sos_zi_unit(sos), device),) if steady else out

    return _cached(('sosff' if steady else 'sos', sos.tobytes(), str(device)), make)


def lfilter(b, a, x: Tensor, zi=None, method: str = 'parallel'):
    """Filter ``x`` with the rational transfer function ``b/a``
    (scipy.signal.lfilter semantics, transposed direct-form II).
    x: (n,) or (batch, n) real. ``zi``: optional (m,) or (batch, m)
    initial state (an array-like or a Tensor) — when given, returns
    ``(y, zf)``. ``method``: 'parallel' (log-depth scan, block-Toeplitz
    products from 4096 samples) or 'sequential' (the exact step in a loop
    over time). float32 output."""
    if method not in ('parallel', 'sequential'):
        raise RuntimeError(f'lfilter: unknown method {method!r}')
    bb, aa, m = _norm_ba(b, a, 'lfilter')
    xb, batched = _as_batched(x, 'lfilter')
    bsz, n = xb.shape
    device = xb.device
    z0 = None if zi is None else _initial_state(zi, 'lfilter', (bsz, m), device)
    A, c, Ad, cd, b0d = _ba_constants(bb, aa, device)
    plan = (_linrec_plan_cached(A, c, n, device)
            if method == 'parallel' and n >= _TOEPLITZ_MIN else None)
    with tracing.trace_op('lfilter', 'op;pipeline', tracing.tensor_args(x=x)):
        y, zf = _lfilter_program(xb, Ad, cd, b0d, z0, method, plan, batched)
        yt = Tensor._from_torch(y)
    if zi is not None:
        return yt, Tensor._from_torch(zf)
    return yt


def _check_sos(sos) -> np.ndarray:
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise RuntimeError(
            f'sosfilt: sos must be (n_sections, 6), got {sos.shape}'
        )
    if np.any(sos[:, 3] == 0.0):
        raise RuntimeError('sosfilt: each section needs a0 != 0')
    return sos / sos[:, 3:4]


def sosfilt(sos, x: Tensor, zi=None, method: str = 'parallel'):
    """Filter ``x`` through a cascade of second-order sections
    (scipy.signal.sosfilt semantics). ``sos``: (n_sections, 6) rows
    [b0 b1 b2 a0 a1 a2]. ``zi``: optional (n_sections, 2) (or with a
    leading batch dim) initial state, an array-like or a Tensor — when
    given, returns ``(y, zf)``. Each section runs as one recurrence solve
    (see lfilter's ``method``). float32 output."""
    if method not in ('parallel', 'sequential'):
        raise RuntimeError(f'sosfilt: unknown method {method!r}')
    sos = _check_sos(sos)
    ns = sos.shape[0]
    xb, batched = _as_batched(x, 'sosfilt')
    b, n = xb.shape
    device = xb.device
    z0 = None if zi is None else _initial_state(zi, 'sosfilt', (b, ns, 2), device)
    secs, As, cs, b0s = _sos_constants(sos, device, steady=False)
    plans = None
    if method == 'parallel' and n >= _TOEPLITZ_MIN:
        plans = tuple(_linrec_plan_cached(A, c, n, device) for A, c in secs)
    targs = tracing.tensor_args(x=x)
    targs['n_sections'] = ns
    with tracing.trace_op('sosfilt', 'op;pipeline', targs):
        y, zf_all = _sosfilt_program(xb, As, cs, b0s, z0, method, plans, batched)
        yt = Tensor._from_torch(y)
    if zi is not None:
        return yt, Tensor._from_torch(zf_all)
    return yt


def _lfilter_program(xb, A, c, b0, z0, method, plan, batched):
    """One linear section over (b, n) rows, the default zero state made
    on the device; (y, zf) unbatched unless ``batched``."""
    if z0 is None:
        z0 = torch.zeros((xb.shape[0], A.shape[0]), dtype=torch.float32, device=xb.device)
    with _full_f32():
        y, zf = _affine_filter(xb, A, c, b0, z0, method=method, plan=plan)
    return (y, zf) if batched else (y[0], zf[0])


def _sosfilt_program(xb, As, cs, b0s, z0, method, plans, batched):
    """The second-order-section cascade over (b, n) rows. Returns (y,
    zf (b|-, ns, 2))."""
    ns = As.shape[0]
    if z0 is None:
        z0 = torch.zeros((xb.shape[0], ns, 2), dtype=torch.float32, device=xb.device)
    y = xb
    zfs = []
    with _full_f32():
        for s in range(ns):
            y, zf = _affine_filter(y, As[s], cs[s], b0s[s], z0[:, s], method=method,
                                   plan=None if plans is None else plans[s])
            zfs.append(zf)
    zf_all = torch.stack(zfs, dim=1)
    return (y, zf_all) if batched else (y[0], zf_all[0])


def _sos_zi_unit(sos: np.ndarray) -> np.ndarray:
    """Per-section steady-state for a UNIT step input (scipy's
    sosfilt_zi): s* = (I - A)^-1 c, scaled by the cumulative DC gain of
    the preceding sections."""
    ns = sos.shape[0]
    zi = np.zeros((ns, 2), np.float64)
    gain = 1.0
    for s in range(ns):
        A, c = _tdf2_matrices(sos[s, :3], sos[s, 3:])
        zi[s] = np.linalg.solve(np.eye(2) - A, c) * gain
        gain *= np.sum(sos[s, :3]) / np.sum(sos[s, 3:])
    return zi


def lfilter_zi(b, a) -> np.ndarray:
    """Initial state for a step-response steady start
    (scipy.signal.lfilter_zi semantics): the transposed direct-form II
    state fixed point s* = (I - A)^-1 c. Host f64."""
    bb, aa, _ = _norm_ba(b, a, 'lfilter_zi')
    A, c = _tdf2_matrices(bb, aa)
    return np.linalg.solve(np.eye(A.shape[0]) - A, c)


def sosfilt_zi(sos) -> np.ndarray:
    """Per-section steady-start state (scipy.signal.sosfilt_zi
    semantics): each section's fixed point scaled by the cumulative DC
    gain of the sections before it. Host f64, shape (n_sections, 2)."""
    return _sos_zi_unit(_check_sos(sos))


def sosfiltfilt(sos, x: Tensor, padlen: Optional[int] = None,
                padtype: str = 'odd', method: str = 'parallel') -> Tensor:
    """Zero-phase forward-backward filtering
    (scipy.signal.sosfiltfilt semantics: ``padtype`` extension in
    {'odd' (default), 'even', 'constant', None}, steady-state initial
    conditions scaled by the edge samples). x: (n,) or (batch, n) real;
    float32 output."""
    sos = _check_sos(sos)
    ns = sos.shape[0]
    if padtype not in ('odd', 'even', 'constant', None):
        raise RuntimeError(f'sosfiltfilt: unknown padtype {padtype!r}')
    if padtype is None:
        padlen = 0
    elif padlen is None:
        n_fir = int(np.sum(sos[:, 2] == 0.0))
        n_iir = int(np.sum(sos[:, 5] == 0.0))
        padlen = 3 * (2 * ns + 1 - min(n_fir, n_iir))
    xb, batched = _as_batched(x, 'sosfiltfilt')
    if padlen >= xb.shape[1]:
        raise RuntimeError(
            f'sosfiltfilt: signal length ({xb.shape[1]}) must exceed '
            f'padlen ({padlen})'
        )
    device = xb.device
    secs, As, cs, b0s, zi_unit = _sos_constants(sos, device, steady=True)
    n_ext = xb.shape[1] + 2 * int(padlen)
    plans = None
    if method == 'parallel' and n_ext >= _TOEPLITZ_MIN:
        plans = tuple(_linrec_plan_cached(A, c, n_ext, device) for A, c in secs)
    with tracing.trace_op('sosfiltfilt', 'op;pipeline', tracing.tensor_args(x=x)):
        out = _sosfiltfilt_program(xb, As, cs, b0s, zi_unit, int(padlen), padtype or 'odd',
                                   method, plans)
        res = Tensor._from_torch(out if batched else out[0])
    return res


def _sosfiltfilt_program(xb, As, cs, b0s, zi_unit, pl, padtype, method, plans):
    """Extend -> forward cascade -> reverse -> backward cascade ->
    reverse -> crop. Every section's initial state is the unit-step
    steady state scaled by the extension's edge sample (scipy's
    x0 * sosfilt_zi(sos))."""
    ns = As.shape[0]

    def cascade(sig):
        edge = sig[:, 0]
        for s in range(ns):
            z0 = edge[:, None] * zi_unit[s][None, :]
            sig, _ = _affine_filter(sig, As[s], cs[s], b0s[s], z0, method=method,
                                    plan=None if plans is None else plans[s])
        return sig

    if pl == 0:
        ext = xb
    elif padtype == 'odd':
        # x[pl:0:-1] and x[-2:-pl-2:-1] of the JAX package, as flips
        head = 2.0 * xb[:, :1] - xb[:, 1:pl + 1].flip(-1)
        tail = 2.0 * xb[:, -1:] - xb[:, -pl - 1:-1].flip(-1)
        ext = torch.cat([head, xb, tail], dim=1)
    elif padtype == 'even':
        ext = torch.cat([xb[:, 1:pl + 1].flip(-1), xb, xb[:, -pl - 1:-1].flip(-1)], dim=1)
    else:  # constant
        ext = torch.cat([xb[:, :1].expand(-1, pl), xb, xb[:, -1:].expand(-1, pl)], dim=1)
    with _full_f32():
        y = cascade(ext).flip(-1)
        y = cascade(y).flip(-1)
    return y[:, pl:pl + xb.shape[1]]


def sosfreqz(sos, worN: int = 512, fs: float = 2.0 * np.pi):
    """Frequency response of a second-order-section cascade
    (scipy.signal.sosfreqz semantics): returns ``(w, h)`` numpy arrays
    over ``worN`` points on [0, fs/2). Design-time helper, host f64."""
    sos = _check_sos(sos)
    w = np.arange(int(worN)) * (fs / 2.0) / int(worN)
    zinv = np.exp(-1j * (2.0 * np.pi * w / fs))
    h = np.ones_like(zinv)
    for b0, b1, b2, _, a1, a2 in sos:
        h *= (b0 + b1 * zinv + b2 * zinv**2) / (1.0 + a1 * zinv + a2 * zinv**2)
    return w, h


def tf2sos(b, a) -> np.ndarray:
    """Transfer-function -> second-order sections via root factoring
    (np.roots + the conjugate-pairing of zpk2sos). The realized transfer
    function equals ``b/a``; section pairing may differ from scipy's
    (behavior-identical)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a.size == 0 or a[0] == 0.0:
        raise RuntimeError('tf2sos: a[0] must be nonzero')
    bn, an = b / a[0], a / a[0]
    # strip leading numerator zeros (scipy normalize()); an all-zero b
    # is the zero system
    nz = np.nonzero(bn)[0]
    if nz.size == 0:
        return np.array([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0]])
    bn = bn[nz[0]:]
    k = bn[0]
    z = np.roots(bn / k) if bn.size > 1 else np.array([], complex)
    p = np.roots(an) if an.size > 1 else np.array([], complex)
    # balance degrees: the shorter side pads roots at the origin
    if len(z) < len(p):
        z = np.concatenate([z, np.zeros(len(p) - len(z))])
    elif len(z) > len(p):
        p = np.concatenate([p, np.zeros(len(z) - len(p))])
    return _zpk2sos(z, p, k)


def sos2tf(sos) -> tuple:
    """Second-order sections -> (b, a) polynomial form
    (scipy.signal.sos2tf semantics)."""
    sos = _check_sos(sos)
    b, a = np.ones(1), np.ones(1)
    for row in sos:
        b = np.convolve(b, row[:3])
        a = np.convolve(a, row[3:])
    return b, a


def filtfilt(b, a, x: Tensor, padlen: Optional[int] = None,
             padtype: str = 'odd', method: str = 'parallel') -> Tensor:
    """Zero-phase forward-backward filtering in (b, a) form
    (scipy.signal.filtfilt semantics: ``padtype`` extension, default
    ``padlen = 3 * max(len(a), len(b))``), executed through the sos
    cascade of the factored transfer function."""
    bb = np.atleast_1d(np.asarray(b, np.float64))
    aa = np.atleast_1d(np.asarray(a, np.float64))
    if padlen is None and padtype is not None:
        padlen = 3 * max(len(aa), len(bb))
    return sosfiltfilt(tf2sos(bb, aa), x, padlen=padlen, padtype=padtype,
                       method=method)


def group_delay(system, worN: int = 512, fs: float = 2.0 * np.pi):
    """Group delay -d(phase)/d(omega) of a rational filter ``(b, a)``
    in samples (scipy.signal.group_delay semantics), via the exact
    Smith ramp identity on the combined numerator b*conj(a reversed)
    rather than a finite difference."""
    b, a = system
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    w = np.arange(int(worN)) * (fs / 2.0) / int(worN)
    omega = 2.0 * np.pi * w / fs
    c = np.convolve(b, a[::-1])
    cr = c * np.arange(len(c))
    z = np.exp(-1j * omega)
    num = np.polyval(cr[::-1], z)
    den = np.polyval(c[::-1], z)
    singular = np.abs(den) < 10 * np.finfo(np.float64).eps
    gd = np.zeros_like(w)
    good = ~singular
    gd[good] = np.real(num[good] / den[good]) - (len(a) - 1)
    return w, gd


def freqz(b, a=1.0, worN: int = 512, fs: float = 2.0 * np.pi):
    """Frequency response of a rational filter (scipy.signal.freqz
    semantics): returns ``(w, h)`` over ``worN`` points on [0, fs/2)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    w = np.arange(int(worN)) * (fs / 2.0) / int(worN)
    zinv = np.exp(-1j * (2.0 * np.pi * w / fs))
    h = np.polyval(b[::-1], zinv) / np.polyval(a[::-1], zinv)
    return w, h


# --------------------------------------------------------------------------
# host half: IIR design (from-scratch zpk pipeline, f64)
# --------------------------------------------------------------------------


def _bilinear_zpk(z, p, k, fs: float):
    fs2 = 2.0 * fs
    zd = (fs2 + z) / (fs2 - z)
    pd = (fs2 + p) / (fs2 - p)
    # zeros at infinity map to z = -1
    zd = np.append(zd, -np.ones(len(p) - len(z)))
    kd = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return zd, pd, kd


def _pair_conj(roots: np.ndarray, who: str):
    """Group roots into conjugate pairs (plus one real leftover for odd
    counts). Returns (pairs[(r1, r2)], real_leftover_or_None)."""
    roots = np.sort_complex(roots)
    cplx = [r for r in roots if abs(r.imag) > 1e-12]
    real = [r.real for r in roots if abs(r.imag) <= 1e-12]
    cplx_pos = [r for r in cplx if r.imag > 0]
    if 2 * len(cplx_pos) != len(cplx):
        raise RuntimeError(f'{who}: roots are not conjugate-symmetric')
    pairs = [(r, np.conj(r)) for r in cplx_pos]
    real.sort()
    while len(real) >= 2:
        pairs.append((real.pop(), real.pop()))
    return pairs, (real[0] if real else None)


def _zpk2sos(z, p, k) -> np.ndarray:
    """Pair poles/zeros into biquad rows [b0 b1 b2 1 a1 a2]. Sections are
    ordered low-Q-first (|p| ascending) with the overall gain in the last
    (highest-Q) section; each pole pair takes the zero pair nearest in
    angle (a numerics heuristic — any pairing realizes the same transfer
    function, which is what the tests pin). An odd order's leftover real
    pole forms a first-order section with the leftover real zero."""
    p_pairs, p_real = _pair_conj(np.asarray(p, complex), 'zpk2sos poles')
    z_pairs, z_real = _pair_conj(np.asarray(z, complex), 'zpk2sos zeros')
    sections = []
    p_sorted = sorted(p_pairs, key=lambda pr: abs(pr[0]))
    z_avail = list(z_pairs)
    for pp in p_sorted:
        a1 = -(pp[0] + pp[1]).real
        a2 = (pp[0] * pp[1]).real
        if z_avail:
            ang = np.angle(pp[0])
            ix = int(np.argmin([abs(abs(np.angle(zz[0])) - abs(ang))
                                for zz in z_avail]))
            zz = z_avail.pop(ix)
            b1 = -(zz[0] + zz[1]).real
            b2 = (zz[0] * zz[1]).real
            sections.append([1.0, b1, b2, 1.0, float(np.real(a1)),
                             float(np.real(a2))])
        else:
            sections.append([1.0, 0.0, 0.0, 1.0, float(np.real(a1)),
                             float(np.real(a2))])
    if p_real is not None:
        if z_real is not None:
            sections.append([1.0, -float(z_real), 0.0, 1.0, -float(p_real),
                             0.0])
        else:
            sections.append([1.0, 0.0, 0.0, 1.0, -float(p_real), 0.0])
    elif z_real is not None:
        raise RuntimeError('zpk2sos: more real zeros than real poles')
    sos = np.asarray(sections, np.float64)
    sos[-1, :3] *= k  # gain in the last (highest-Q) section
    return sos


# zpk frequency transforms (scipy.signal lp2*_zpk semantics, general in
# the zeros so the Chebyshev-II prototype works too)

def _lp2lp_zpk(z, p, k, wo):
    return z * wo, p * wo, k * wo ** (len(p) - len(z))


def _lp2hp_zpk(z, p, k, wo):
    degree = len(p) - len(z)
    zh = np.append(wo / z if len(z) else z, np.zeros(degree))
    return zh, wo / p, k * np.real(np.prod(-z) / np.prod(-p))


def _lp2bp_zpk(z, p, k, wo, bw):
    degree = len(p) - len(z)
    zlp, plp = z * (bw / 2.0), p * (bw / 2.0)
    zbp = np.concatenate([zlp + np.sqrt(zlp**2 - wo**2 + 0j),
                          zlp - np.sqrt(zlp**2 - wo**2 + 0j)])
    pbp = np.concatenate([plp + np.sqrt(plp**2 - wo**2 + 0j),
                          plp - np.sqrt(plp**2 - wo**2 + 0j)])
    return np.append(zbp, np.zeros(degree)), pbp, k * bw**degree


def _lp2bs_zpk(z, p, k, wo, bw):
    degree = len(p) - len(z)
    zhp = (bw / 2.0) / z if len(z) else z
    php = (bw / 2.0) / p
    zbs = np.concatenate([zhp + np.sqrt(zhp**2 - wo**2 + 0j),
                          zhp - np.sqrt(zhp**2 - wo**2 + 0j)])
    pbs = np.concatenate([php + np.sqrt(php**2 - wo**2 + 0j),
                          php - np.sqrt(php**2 - wo**2 + 0j)])
    zbs = np.append(zbs, 1j * wo * np.ones(degree))
    zbs = np.append(zbs, -1j * wo * np.ones(degree))
    return zbs, pbs, k * np.real(np.prod(-z) / np.prod(-p))


def _iirdesign_sos(z, p, k, N, Wn, btype, fs, who: str, output: str = 'sos'):
    """Shared digital-design pipeline: normalize Wn, prewarp, apply the
    band transform, bilinear-transform, emit ``output`` ('sos' biquads
    — the numerically safe default this package consumes — or scipy's
    'ba' / 'zpk' forms). ``N``, the order, is the JAX package's argument
    (its iirdesign.py passes it); the roots carry it."""
    if output not in ('sos', 'ba', 'zpk'):
        raise RuntimeError(f"{who}: unknown output {output!r}")
    wn = np.atleast_1d(np.asarray(Wn, np.float64))
    if fs is not None:
        wn = wn / (fs / 2.0)
    if np.any(wn <= 0) or np.any(wn >= 1):
        raise RuntimeError(f'{who}: Wn must lie strictly inside (0, Nyquist)')
    btype_in = btype
    btype = {'low': 'low', 'lowpass': 'low', 'high': 'high',
             'highpass': 'high', 'band': 'bandpass', 'bandpass': 'bandpass',
             'stop': 'bandstop', 'bandstop': 'bandstop'}.get(btype)
    if btype is None:
        raise RuntimeError(f'{who}: unknown btype {btype_in!r}')
    if btype in ('low', 'high') and wn.size != 1:
        raise RuntimeError(f'{who}: low/high need a scalar Wn')
    if btype in ('bandpass', 'bandstop') and wn.size != 2:
        raise RuntimeError(f'{who}: bandpass/bandstop need Wn = [low, high]')
    fs_d = 2.0  # internal digital rate for the bilinear transform
    warped = 2.0 * fs_d * np.tan(np.pi * wn / fs_d)
    if btype == 'low':
        z, p, k = _lp2lp_zpk(z, p, k, warped[0])
    elif btype == 'high':
        z, p, k = _lp2hp_zpk(z, p, k, warped[0])
    else:
        bw, wo = warped[1] - warped[0], np.sqrt(warped[0] * warped[1])
        tf = _lp2bp_zpk if btype == 'bandpass' else _lp2bs_zpk
        z, p, k = tf(z, p, k, wo, bw)
    zd, pd, kd = _bilinear_zpk(z, p, k, fs_d)
    if output == 'zpk':
        return zd, pd, kd
    if output == 'ba':
        from .lti import zpk2tf

        return zpk2tf(zd, pd, kd)
    return _zpk2sos(zd, pd, kd)


def _check_order(N: int, who: str) -> None:
    if N < 1:
        raise RuntimeError(f'{who}: order ({N}) must be >= 1')


def butter(N: int, Wn, btype: str = 'low', fs: Optional[float] = None,
           output: str = 'sos'):
    """Butterworth digital filter design in second-order sections
    (scipy.signal.butter(..., output='sos') semantics). ``Wn``: critical
    frequency/ies — normalized to Nyquist when ``fs`` is None, else in
    the same units as ``fs``. ``btype``: 'low' | 'high' | 'bandpass' |
    'bandstop'. Returns an (n_sections, 6) float64 array ready for
    :func:`sosfilt`."""
    _check_order(N, 'butter')
    # analog Butterworth prototype: N poles on the unit circle, no zeros
    theta = np.pi * np.arange(-N + 1, N, 2) / (2.0 * N)
    p = -np.exp(1j * theta)
    return _iirdesign_sos(np.array([], complex), p, 1.0, N, Wn, btype, fs, 'butter',
                          output=output)


def cheby1(N: int, rp: float, Wn, btype: str = 'low',
           fs: Optional[float] = None, output: str = 'sos'):
    """Chebyshev type-I design (``rp`` dB passband ripple;
    scipy.signal.cheby1(..., output='sos') semantics)."""
    _check_order(N, 'cheby1')
    if rp <= 0:
        raise RuntimeError(f'cheby1: rp ({rp}) must be > 0 dB')
    eps = np.sqrt(10.0 ** (0.1 * rp) - 1.0)
    mu = np.arcsinh(1.0 / eps) / N
    theta = np.pi * np.arange(-N + 1, N, 2) / (2.0 * N)
    p = -np.sinh(mu + 1j * theta)
    k = np.real(np.prod(-p))
    if N % 2 == 0:
        k /= np.sqrt(1.0 + eps * eps)
    return _iirdesign_sos(np.array([], complex), p, k, N, Wn, btype, fs, 'cheby1',
                          output=output)


def cheby2(N: int, rs: float, Wn, btype: str = 'low',
           fs: Optional[float] = None, output: str = 'sos'):
    """Chebyshev type-II design (``rs`` dB stopband attenuation;
    scipy.signal.cheby2(..., output='sos') semantics)."""
    _check_order(N, 'cheby2')
    if rs <= 0:
        raise RuntimeError(f'cheby2: rs ({rs}) must be > 0 dB')
    de = 1.0 / np.sqrt(10.0 ** (0.1 * rs) - 1.0)
    mu = np.arcsinh(1.0 / de) / N
    if N % 2:
        m = np.concatenate([np.arange(-N + 1, 0, 2), np.arange(2, N, 2)])
    else:
        m = np.arange(-N + 1, N, 2)
    z = -np.conj(1j / np.sin(m * np.pi / (2.0 * N)))
    p = -np.exp(1j * np.pi * np.arange(-N + 1, N, 2) / (2.0 * N))
    p = np.sinh(mu) * p.real + 1j * np.cosh(mu) * p.imag
    p = 1.0 / p
    k = np.real(np.prod(-p) / np.prod(-z))
    return _iirdesign_sos(z, p, k, N, Wn, btype, fs, 'cheby2', output=output)


def decimate(x: Tensor, q: int, n: Optional[int] = None,
             ftype: str = 'iir', zero_phase: bool = True) -> Tensor:
    """Downsample after an anti-aliasing lowpass (scipy.signal.decimate
    semantics): ``ftype='iir'`` (default) filters with ``cheby1(n or 8,
    0.05, 0.8/q)`` (``sosfiltfilt`` when ``zero_phase`` else
    ``sosfilt``); ``'fir'`` uses a hamming-window FIR of ``n or 20*q``
    taps through the FFT convolution of ``resample_poly`` / ``upfirdn``.
    Then take every q-th sample."""
    if q < 1:
        raise RuntimeError(f'decimate: q ({q}) must be >= 1')
    if ftype not in ('iir', 'fir'):
        raise RuntimeError(f'decimate: unknown ftype {ftype!r}')
    if q == 1:
        return x
    if ftype == 'fir':
        from .fir import firwin
        from .spectral import resample_poly, upfirdn

        n_taps = (20 * q if n is None else n) + 1
        b = firwin(n_taps, 1.0 / q, window='hamming').numpy()
        if zero_phase:
            return resample_poly(x, 1, q, window=b)
        n_in = x.shape[-1]
        n_out = n_in // q + bool(n_in % q)
        y = upfirdn(b, x, up=1, down=q)
        return y[:, :n_out] if y.n_dim == 2 else y[:n_out]
    sos = cheby1(8 if n is None else n, 0.05, 0.8 / q)
    y = sosfiltfilt(sos, x) if zero_phase else sosfilt(sos, x)
    return y[:, ::q] if y.n_dim == 2 else y[::q]
