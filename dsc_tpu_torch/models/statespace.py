"""State-space systems (dsc_tpu/models/statespace.py): tf2ss / ss2tf /
cont2discrete and the lsim / dlsim / step / impulse simulators.

scipy.signal semantics throughout. The representation conversions and the
discretization are host float64 numpy, copied from the JAX package
(including its Pade scaling-and-squaring matrix exponential for the
zoh/foh/impulse maps), with two repairs where it departs from scipy: the
exponential counts its squarings from the growth of the matrix's powers
(``_expm``, ROADMAP F5), and ``lsim``'s first-order hold starts from X0 and
returns the system's own state (ROADMAP F4). The simulation recurrence x[k+1] = A x[k] + B u[k]
runs on the device in float64 as the log-depth scan of ``_affine_scan``:
ceil(log2 n) doubling steps of small products over all positions, never a
loop over time. No TPU kernel is on this path (the JAX package runs it as a
``lax.associative_scan``).

``dlsim`` takes a NumPy array or a Tensor for ``u``: a Tensor stays on its
device and y, x come back as float32 Tensors; a NumPy array runs on
``context.device()`` and y, x come back as float64 NumPy arrays.
``lsim``/``step``/``impulse`` discretize (zoh/foh) on the host, then ride
the same scan.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import context, tracing
from ..tensor import Tensor
from ._affine_scan import affine_scan_, scan_maps
from .lti import normalize, tf2zpk, zpk2tf


def _expm(m: np.ndarray) -> np.ndarray:
    """Matrix exponential via Pade(13) scaling-and-squaring (f64 host).
    The squarings are counted from max(||m^8||^(1/8), ||m^10||^(1/10))
    (Al-Mohy and Higham 2009) where the JAX package counts them from
    ||m||_1: a controller-canonical A (entries to 1e10 for an analog
    butter(4, 2 pi 50)) has a 1-norm far above its powers' growth, and the
    squarings it would take spread the Pade's rounding over the result
    (ROADMAP F5)."""
    m = np.asarray(m, np.float64)
    m2 = m @ m
    m8 = np.linalg.matrix_power(m2 @ m2, 2)
    eta = max(np.linalg.norm(m8, 1) ** (1 / 8),
              np.linalg.norm(m8 @ m2, 1) ** (1 / 10))
    s = int(np.ceil(np.log2(eta / 5.4))) if eta > 5.4 else 0
    a = m / (2.0 ** s)
    b = (64764752532480000., 32382376266240000., 7771770303897600.,
         1187353796428800., 129060195264000., 10559470521600.,
         670442572800., 33522128640., 1323241920., 40840800., 960960.,
         16380., 182., 1.)
    ident = np.eye(a.shape[0])
    a2 = a @ a
    a4 = a2 @ a2
    a6 = a4 @ a2
    u = a @ (a6 @ (b[13] * a6 + b[11] * a4 + b[9] * a2)
             + b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * ident)
    v = a6 @ (b[12] * a6 + b[10] * a4 + b[8] * a2) \
        + b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * ident
    r = np.linalg.solve(v - u, v + u)
    for _ in range(s):
        r = r @ r
    return r


def tf2ss(b, a):
    """Transfer function -> controller-canonical state space
    (scipy.signal.tf2ss): A (n,n), B (n,1), C (1,n), D (1,1)."""
    b, a = normalize(b, a)
    n = a.size - 1
    if n == 0:
        return (np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)),
                np.asarray([[b[0]]]))
    bf = np.zeros(n + 1)
    bf[n + 1 - b.size:] = b
    d = bf[0]
    A = np.zeros((n, n))
    A[0, :] = -a[1:]
    A[1:, :-1] = np.eye(n - 1)
    B = np.zeros((n, 1))
    B[0, 0] = 1.0
    C = (bf[1:] - d * a[1:])[None, :]
    D = np.asarray([[d]])
    return A, B, C, D


def ss2tf(A, B, C, D):
    """State space -> transfer function (scipy.signal.ss2tf for the
    first input): num (n_out, n+1), den (n+1,), via the
    det-identity num_k = poly(A - B C_k) + (D_k - 1) poly(A)."""
    A = np.atleast_2d(np.asarray(A, np.float64))
    B = np.atleast_2d(np.asarray(B, np.float64))
    C = np.atleast_2d(np.asarray(C, np.float64))
    D = np.atleast_2d(np.asarray(D, np.float64))
    if B.shape[1] != 1:
        raise RuntimeError('ss2tf: single-input systems only (B is (n, 1))')
    den = np.poly(A) if A.size else np.ones(1)
    nout = C.shape[0]
    num = np.empty((nout, den.size))
    for k in range(nout):
        ck = C[k:k + 1, :]
        dk = D[k, 0]
        if A.size:
            num[k] = np.poly(A - B @ ck) + (dk - 1.0) * den
        else:
            num[k] = np.asarray([dk])
    return num, den


def zpk2ss(z, p, k):
    """(z, p, k) -> state space (scipy.signal.zpk2ss)."""
    return tf2ss(*zpk2tf(z, p, k))


def ss2zpk(A, B, C, D):
    """State space -> (z, p, k) (scipy.signal.ss2zpk, first output)."""
    num, den = ss2tf(A, B, C, D)
    return tf2zpk(num[0], den)


def _as_ss(system):
    """Normalize a scipy-style system spec to (A, B, C, D [, dt])."""
    if isinstance(system, (tuple, list)):
        if len(system) == 2:
            return tf2ss(*system)
        if len(system) == 3:
            return zpk2ss(*system)
        if len(system) in (4, 5):
            out = tuple(np.atleast_2d(np.asarray(m, np.float64))
                        for m in system[:4])
            return out + tuple(system[4:])
    raise RuntimeError(
        'expected a (b, a), (z, p, k), (A, B, C, D) or (A, B, C, D, dt) '
        'system tuple')


def cont2discrete(system, dt: float, method: str = 'zoh',
                  alpha: Optional[float] = None):
    """Continuous -> discrete state space (scipy.signal.cont2discrete):
    methods 'zoh' (default), 'foh', 'impulse', 'euler'/'forward_diff',
    'backward_diff', 'bilinear'/'tustin', 'gbt' (with ``alpha``).
    Accepts (b, a) / (z, p, k) / (A, B, C, D); returns the discretized
    system in the SAME representation with dt appended (tf and zpk
    inputs convert through state space, like scipy)."""
    kind = len(system) if isinstance(system, (tuple, list)) else 0
    A, B, C, D = _as_ss(system)[:4]
    n = A.shape[0]
    if method in ('bilinear', 'tustin'):
        method, alpha = 'gbt', 0.5
    elif method in ('euler', 'forward_diff'):
        method, alpha = 'gbt', 0.0
    elif method == 'backward_diff':
        method, alpha = 'gbt', 1.0
    if method == 'gbt':
        if alpha is None or not 0 <= alpha <= 1:
            raise RuntimeError('cont2discrete: gbt needs alpha in [0, 1]')
        ima = np.eye(n) - alpha * dt * A
        ad = np.linalg.solve(ima, np.eye(n) + (1.0 - alpha) * dt * A)
        bd = np.linalg.solve(ima, dt * B)
        cd = np.linalg.solve(ima.T, C.T).T
        dd = D + alpha * (C @ bd)
    elif method == 'zoh':
        blk = np.zeros((n + B.shape[1], n + B.shape[1]))
        blk[:n, :n] = A * dt
        blk[:n, n:] = B * dt
        em = _expm(blk)
        ad, bd = em[:n, :n], em[:n, n:]
        cd, dd = C, D
    elif method == 'foh':
        ad, g1, g2 = _foh(A, B, dt)
        bd = g1 + ad @ g2 - g2
        cd = C
        dd = D + C @ g2
    elif method == 'impulse':
        if not np.allclose(D, 0.0):
            raise RuntimeError('cont2discrete: impulse needs D == 0')
        ad = _expm(A * dt)
        bd = ad @ B * dt
        cd, dd = C, C @ B * dt
    else:
        raise RuntimeError(f'cont2discrete: unknown method {method!r}')
    if kind == 2:
        num, den = ss2tf(ad, bd, cd, dd)
        return num, den, dt
    if kind == 3:
        z, p, k = ss2zpk(ad, bd, cd, dd)
        return z, p, k, dt
    return ad, bd, cd, dd, dt


def _foh(A, B, dt):
    """(Ad, Gamma1, Gamma2 / dt) of the first-order hold over one step:
    for u linear between samples, x[k+1] = Ad x[k] + (Gamma1 - Gamma2/dt)
    u[k] + Gamma2/dt u[k+1]."""
    n, nb = A.shape[0], B.shape[1]
    blk = np.zeros((n + 2 * nb, n + 2 * nb))
    blk[:n, :n] = A * dt
    blk[:n, n:n + nb] = B * dt
    blk[n:n + nb, n + nb:] = np.eye(nb)
    em = _expm(blk)
    return em[:n, :n], em[:n, n:n + nb], em[:n, n + nb:]


def _simulate(A, B, C, D, x0, u):
    """(y, x) of x[k+1] = A x[k] + B u[k], y[k] = C x[k] + D u[k] from
    x[0] = x0, in float64 on ``u``'s device (u: (steps, inputs)): the states
    x[1..steps-1] are one affine scan over B u[0..steps-2] with A x0 folded
    into its first step."""
    steps, n = u.shape[0], A.shape[0]
    dev = u.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(dev)

    # every upload before the first launch: a copy from host memory waits
    # for the work queued before it
    b_t, c_t, d_t, x0d, ax0 = put(B.T), put(C.T), put(D.T), put(x0), put(A @ x0)
    maps = scan_maps(A, steps - 1, dev)
    u = u.to(torch.float64)
    xs = torch.empty((steps, n), dtype=torch.float64, device=dev)
    if n:
        xs[0] = x0d
        if steps > 1:
            torch.matmul(u[:-1], b_t, out=xs[1:])
            xs[1] += ax0
            affine_scan_(xs[None, 1:], maps)
    ys = torch.matmul(xs, c_t) + torch.matmul(u, d_t)
    return ys, xs


def dlsim(system, u, t=None, x0=None):
    """Simulate a discrete-time system (scipy.signal.dlsim semantics):
    ``system`` is (A, B, C, D, dt) (or (num, den, dt) / (z, p, k, dt),
    converted). ``u`` is (steps,) or (steps, n_inputs), NumPy or Tensor.
    Returns (tout, yout, xout) as float64 NumPy arrays, the recurrence run
    on ``context.device()``; when ``u`` is a Tensor, yout and xout come
    back as float32 Tensors on its device. The recurrence is the log-depth
    affine scan, in float64."""
    if not isinstance(system, (tuple, list)) or len(system) not in (3, 4, 5):
        raise RuntimeError('dlsim: expected a system tuple ending in dt')
    dt = float(system[-1])
    if len(system) == 3:
        A, B, C, D = tf2ss(system[0], system[1])
    elif len(system) == 4:
        A, B, C, D = zpk2ss(system[0], system[1], system[2])
    else:
        A, B, C, D = (np.atleast_2d(np.asarray(m, np.float64))
                      for m in system[:4])
    device_io = isinstance(u, Tensor)
    uj = u.torch if device_io else torch.from_numpy(
        np.asarray(u, np.float64)).to(context.device())
    if uj.ndim == 1:
        uj = uj[:, None]
    steps = uj.shape[0]
    if uj.shape[1] != B.shape[1]:
        raise RuntimeError(
            f'dlsim: u has {uj.shape[1]} inputs, B expects {B.shape[1]}')
    n = A.shape[0]
    x0v = np.zeros(n) if x0 is None else np.asarray(x0, np.float64).ravel()
    if x0v.size != n:
        raise RuntimeError(f'dlsim: x0 must have {n} entries')
    with tracing.trace_op('dlsim', 'op;pipeline', {'steps': steps, 'n': n}):
        ys, xs = _simulate(A, B, C, D, x0v, uj)
    tout = np.arange(steps) * dt if t is None else np.asarray(t)[:steps]
    if device_io:
        return tout, Tensor._from_torch(ys.to(torch.float32)), \
            Tensor._from_torch(xs.to(torch.float32))
    return tout, ys.cpu().numpy(), xs.cpu().numpy()


def dstep(system, x0=None, n: int = 100):
    """Discrete step response (scipy.signal.dstep): returns (t, y)
    with y a 1-D array (single-output systems)."""
    u = np.ones((n, 1))
    tout, y, _ = dlsim(_dl_tuple(system), u, x0=x0)
    return tout, y[:, 0]


def _dl_tuple(system):
    if not isinstance(system, (tuple, list)):
        raise RuntimeError('expected a discrete system tuple ending in dt')
    if len(system) == 3:
        A, B, C, D = tf2ss(system[0], system[1])
    elif len(system) == 4:
        A, B, C, D = zpk2ss(system[0], system[1], system[2])
    elif len(system) == 5:
        return system
    else:
        raise RuntimeError('expected a discrete system tuple ending in dt')
    return (A, B, C, D, float(system[-1]))


def dimpulse(system, x0=None, n: int = 100):
    """Discrete impulse response (scipy.signal.dimpulse): (t, y)."""
    u = np.zeros((n, 1))
    u[0, 0] = 1.0
    tout, y, _ = dlsim(_dl_tuple(system), u, x0=x0)
    return tout, y[:, 0]


def lsim(system, U, T, X0=None, interp: bool = True):
    """Simulate a continuous-time LTI system over uniformly spaced times
    (scipy.signal.lsim semantics): first-order-hold input interpolation
    by default (``interp=True``), zero-order hold otherwise. Returns
    (T, yout, xout); the recurrence runs through the device scan."""
    A, B, C, D = _as_ss(system)[:4]
    T = np.asarray(T, np.float64)
    if T.ndim != 1 or T.size < 2:
        raise RuntimeError('lsim: T must be 1-D with >= 2 points')
    dts = np.diff(T)
    if not np.allclose(dts, dts[0], rtol=1e-6):
        raise RuntimeError('lsim: T must be uniformly spaced')
    dt = float(dts[0])
    U = np.asarray(U, np.float64)
    if U.ndim == 1:
        U = U[:, None]
    if U.shape[0] != T.size:
        raise RuntimeError('lsim: U and T lengths differ')
    if interp:
        # scipy.signal.lsim's hold: the step reads u[k] and u[k+1], so x
        # starts at X0 and is the system's own state. cont2discrete's 'foh'
        # system (the JAX package's lsim) has the state x - Gamma2/dt u
        # instead, which it starts at X0 where X0 - Gamma2/dt u[0] is due
        # (ROADMAP F4)
        ad, g1, g2 = _foh(A, B, dt)
        system = (ad, np.hstack([g1 - g2, g2]), C, np.hstack([D, np.zeros_like(D)]), dt)
        U = np.hstack([U, np.vstack([U[1:], U[-1:]])])
    else:
        system = cont2discrete((A, B, C, D), dt, method='zoh')
    tout, y, x = dlsim(system, U, x0=X0)
    return T, y[:, 0] if y.shape[1] == 1 else y, x


def step(system, X0=None, T=None, N: int = 100):
    """Continuous step response (scipy.signal.step): (T, yout).
    Uses zero-order hold like scipy (its step calls lsim with
    interp=False)."""
    A, B, C, D = _as_ss(system)[:4]
    if T is None:
        T = _default_T(A, N)
    T = np.asarray(T, np.float64)
    _, y, _ = lsim((A, B, C, D), np.ones((T.size, B.shape[1])), T, X0=X0,
                   interp=False)
    return T, y


def impulse(system, X0=None, T=None, N: int = 100):
    """Continuous impulse response (scipy.signal.impulse): simulated as
    the zero-input response from x0 + B (the delta loads the state)."""
    A, B, C, D = _as_ss(system)[:4]
    if T is None:
        T = _default_T(A, N)
    T = np.asarray(T, np.float64)
    x0 = B[:, 0] if X0 is None else np.asarray(X0, np.float64) + B[:, 0]
    _, y, _ = lsim((A, B, C, D), np.zeros((T.size, B.shape[1])), T, X0=x0)
    return T, y


def _default_T(A: np.ndarray, n: int) -> np.ndarray:
    """scipy's heuristic horizon: 7 time constants of the slowest stable
    mode."""
    if A.size == 0:
        return np.linspace(0, 1, n)
    ev = np.linalg.eigvals(A)
    r = np.min(np.abs(ev.real[ev.real != 0])) if np.any(ev.real != 0) \
        else 1.0
    tc = 1.0 / max(r, 1e-12)
    return np.linspace(0.0, 7.0 * tc, n)
