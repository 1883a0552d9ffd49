"""LTI system classes: ``lti`` / ``dlti`` factories and the
``TransferFunction`` / ``ZerosPolesGain`` / ``StateSpace``
representations (scipy.signal object API; dsc_tpu/models/ltisys.py).

Thin, immutable wrappers over the functional tier (models/lti.py,
models/statespace.py, models/response.py, models/filter_extras.py):
each class holds one representation, converts losslessly to the others
(``to_tf`` / ``to_zpk`` / ``to_ss``), and exposes the response methods
(``bode`` / ``freqresp``, ``step`` / ``impulse`` / ``output`` for
continuous systems and their d* counterparts for discrete ones, all
riding the float64 affine scan of models/statespace.py on
``context.device()``). ``dt=None`` marks a continuous system; any
numeric ``dt`` (or ``True`` for unspecified spacing, like scipy) marks a
discrete one. A discrete system's ``output`` of a Tensor input keeps it
on its device and returns Tensors, as ``dlsim`` does; a discrete
system's ``freqresp`` / ``bode`` take scipy's responses, not the JAX
package's (ROADMAP F9, in filter_extras.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .filter_extras import dbode, dfreqresp
from .lti import normalize, tf2zpk, zpk2tf
from .response import bode as _bode, freqs_zpk
from .statespace import (
    cont2discrete,
    dimpulse as _dimpulse,
    dlsim as _dlsim,
    dstep as _dstep,
    impulse as _impulse,
    lsim as _lsim,
    ss2tf,
    ss2zpk,
    step as _step,
    tf2ss,
    zpk2ss,
)


class _LTIBase:
    """Shared plumbing: dt bookkeeping and response dispatch."""

    dt: Optional[float]

    @property
    def is_discrete(self) -> bool:
        return self.dt is not None

    def _dt_tuple(self):
        dt = 1.0 if self.dt is True else self.dt
        return (dt,) if self.is_discrete else ()

    # ---- representations (implemented per subclass) ----
    def to_tf(self) -> 'TransferFunction':
        raise NotImplementedError

    def to_zpk(self) -> 'ZerosPolesGain':
        raise NotImplementedError

    def to_ss(self) -> 'StateSpace':
        raise NotImplementedError

    @property
    def poles(self):
        return self.to_zpk().p

    @property
    def zeros(self):
        return self.to_zpk().z

    # ---- responses ----
    def freqresp(self, w=None, n: int = 10000):
        tf = self.to_tf()
        if self.is_discrete:
            return dfreqresp((tf.num, tf.den) + self._dt_tuple(), w=w, n=n)
        z, p, k = tf2zpk(tf.num, tf.den)
        return freqs_zpk(z, p, k, worN=np.asarray(w, np.float64)
                         if w is not None else int(n))

    def bode(self, w=None, n: int = 100):
        tf = self.to_tf()
        if self.is_discrete:
            return dbode((tf.num, tf.den) + self._dt_tuple(), w=w, n=n)
        ssm = self.to_ss()
        return _bode((ssm.A, ssm.B, ssm.C, ssm.D), w=w, n=n)

    def step(self, X0=None, T=None, N: int = 100):
        ssm = self.to_ss()
        if self.is_discrete:
            return _dstep((ssm.A, ssm.B, ssm.C, ssm.D) + self._dt_tuple(),
                          x0=X0, n=N)
        return _step((ssm.A, ssm.B, ssm.C, ssm.D), X0=X0, T=T, N=N)

    def impulse(self, X0=None, T=None, N: int = 100):
        ssm = self.to_ss()
        if self.is_discrete:
            return _dimpulse(
                (ssm.A, ssm.B, ssm.C, ssm.D) + self._dt_tuple(),
                x0=X0, n=N)
        return _impulse((ssm.A, ssm.B, ssm.C, ssm.D), X0=X0, T=T, N=N)

    def output(self, U, T=None, X0=None):
        """lsim/dlsim through the device scan: returns (t, y[, x])."""
        ssm = self.to_ss()
        if self.is_discrete:
            return _dlsim((ssm.A, ssm.B, ssm.C, ssm.D) + self._dt_tuple(),
                          U, t=T, x0=X0)
        return _lsim((ssm.A, ssm.B, ssm.C, ssm.D), U, T, X0=X0)


class TransferFunction(_LTIBase):
    """b(s)/a(s) (or b(z)/a(z) with ``dt``) rational system
    (scipy.signal.TransferFunction analog)."""

    def __init__(self, num, den, dt: Optional[float] = None):
        self.num, self.den = normalize(num, den)
        self.dt = dt

    def __repr__(self):
        kind = f'dt={self.dt}' if self.is_discrete else 'continuous'
        return (f'TransferFunction({np.array2string(self.num)}, '
                f'{np.array2string(self.den)}, {kind})')

    def to_tf(self):
        return self

    def to_zpk(self):
        return ZerosPolesGain(*tf2zpk(self.num, self.den), dt=self.dt)

    def to_ss(self):
        return StateSpace(*tf2ss(self.num, self.den), dt=self.dt)


class ZerosPolesGain(_LTIBase):
    """(z, p, k) factored system (scipy.signal.ZerosPolesGain analog)."""

    def __init__(self, z, p, k, dt: Optional[float] = None):
        self.z = np.atleast_1d(np.asarray(z, complex))
        self.p = np.atleast_1d(np.asarray(p, complex))
        self.k = float(k)
        self.dt = dt

    def __repr__(self):
        kind = f'dt={self.dt}' if self.is_discrete else 'continuous'
        return (f'ZerosPolesGain(z={len(self.z)} zeros, '
                f'p={len(self.p)} poles, k={self.k:g}, {kind})')

    def to_tf(self):
        return TransferFunction(*zpk2tf(self.z, self.p, self.k),
                                dt=self.dt)

    def to_zpk(self):
        return self

    def to_ss(self):
        return StateSpace(*zpk2ss(self.z, self.p, self.k), dt=self.dt)


class StateSpace(_LTIBase):
    """(A, B, C, D) state-space system (scipy.signal.StateSpace
    analog; single-input)."""

    def __init__(self, A, B, C, D, dt: Optional[float] = None):
        self.A = np.atleast_2d(np.asarray(A, np.float64))
        self.B = np.atleast_2d(np.asarray(B, np.float64))
        self.C = np.atleast_2d(np.asarray(C, np.float64))
        self.D = np.atleast_2d(np.asarray(D, np.float64))
        self.dt = dt

    def __repr__(self):
        kind = f'dt={self.dt}' if self.is_discrete else 'continuous'
        return f'StateSpace(n={self.A.shape[0]}, {kind})'

    def to_tf(self):
        num, den = ss2tf(self.A, self.B, self.C, self.D)
        return TransferFunction(num[0], den, dt=self.dt)

    def to_zpk(self):
        return ZerosPolesGain(*ss2zpk(self.A, self.B, self.C, self.D),
                              dt=self.dt)

    def to_ss(self):
        return self

    def to_discrete(self, dt: float, method: str = 'zoh',
                    alpha: Optional[float] = None) -> 'StateSpace':
        """cont2discrete through the class API."""
        if self.is_discrete:
            raise RuntimeError('to_discrete: system is already discrete')
        ad, bd, cd, dd, dtv = cont2discrete(
            (self.A, self.B, self.C, self.D), dt, method=method,
            alpha=alpha)
        return StateSpace(ad, bd, cd, dd, dt=dtv)


def _build(system, dt):
    if len(system) == 2:
        return TransferFunction(system[0], system[1], dt=dt)
    if len(system) == 3:
        return ZerosPolesGain(system[0], system[1], system[2], dt=dt)
    if len(system) == 4:
        return StateSpace(*system, dt=dt)
    raise RuntimeError(
        'expected 2 (tf), 3 (zpk) or 4 (state-space) system arguments')


def lti(*system) -> _LTIBase:
    """Continuous-time LTI factory (scipy.signal.lti): 2 args -> tf,
    3 -> zpk, 4 -> state space."""
    return _build(system, None)


def dlti(*system, dt=True) -> _LTIBase:
    """Discrete-time LTI factory (scipy.signal.dlti): like :func:`lti`
    with a sampling interval (``dt=True`` = unspecified unit spacing,
    scipy's default)."""
    return _build(system, dt)
