"""Waveform generators: ``chirp``, ``square``, ``sawtooth``,
``gausspulse``, ``sweep_poly``, and the host-side ``max_len_seq`` and
``vectorstrength`` (dsc_tpu/models/waveforms.py).

scipy.signal semantics. Each wave is float64 torch ops on the time axis,
rounded once to the requested dtype, as the JAX package's jitted programs
are. A Tensor ``t`` stays on its device, and its wave is an op like any
other. A host ``t`` (any array-like) is uploaded to the context's device
and its wave is a creation op: under ``dsc.compile`` it is a constant of
the program (``capture.created``), as a window is (windows.py).
``square`` and ``sawtooth`` take the phase in [0, 2 pi) as ``jnp.mod``
does (``fmod``, then + 2 pi where it is negative), so the jumps fall on
the same samples. As in the JAX package, ``chirp`` has no
``vertex_zero`` and ``gausspulse`` no ``retquad``, ``retenv`` or
``'cutoff'``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import capture, interop, tracing
from ..dtype import Dtype
from ..interop import TORCH_DTYPE
from ..tensor import Tensor

_TWO_PI = 2 * np.pi
_TINY = float(np.finfo(np.float64).tiny)


def _wave(who: str, t, dtype: Dtype, formula) -> Tensor:
    """``formula`` of the float64 time axis ``t``, rounded to ``dtype``."""
    tdt = TORCH_DTYPE[Dtype(dtype)]
    if isinstance(t, Tensor):
        if t.dtype.is_complex:
            raise RuntimeError(f'{who}: t must be real')
        with tracing.trace_op(who, 'op;creation', {'shape': t.shape}):
            return Tensor._from_torch(formula(t.torch.to(torch.float64)).to(tdt))
    host = np.asarray(t, np.float64)

    def make():
        with tracing.trace_op(who, 'op;creation', {'shape': host.shape}):
            return Tensor._from_torch(formula(interop.put(host)).to(tdt))

    return capture.created(make)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once: a 0-d divisor on the device (a fill), since CUDA
    torch computes x / <Python float> as x * (1 / c)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _phase_frac(t: torch.Tensor) -> torch.Tensor:
    """(t mod 2 pi) / (2 pi) in [0, 1): jnp.mod's remainder, sign of the
    divisor, and the quotient rounded once, so the jumps of ``square`` and
    ``sawtooth`` fall on the JAX package's samples on every device."""
    r = torch.fmod(t, _TWO_PI)
    return _div(torch.where(r < 0, r + _TWO_PI, r), _TWO_PI)


def chirp(t, f0: float, t1: float, f1: float, method: str = 'linear',
          phi: float = 0.0, dtype: Dtype = Dtype.F32) -> Tensor:
    """Frequency-swept cosine (scipy.signal.chirp semantics): sweep from
    ``f0`` at t=0 to ``f1`` at ``t1``. ``method``: 'linear' |
    'quadratic' | 'logarithmic' | 'hyperbolic'. ``t`` may be a dsc
    Tensor or array-like."""
    if method not in ('linear', 'quadratic', 'logarithmic', 'hyperbolic'):
        raise RuntimeError(f'chirp: unknown method {method!r}')
    if method in ('logarithmic', 'hyperbolic') and (f0 <= 0 or f1 <= 0):
        raise RuntimeError(f'chirp: {method} sweeps need f0, f1 > 0')
    if f0 == f1 and method in ('logarithmic', 'hyperbolic'):
        method = 'linear'  # constant frequency; avoids the 0/0 forms
    f0, t1, f1 = float(f0), float(t1), float(f1)
    phi = float(np.deg2rad(phi))

    def formula(t):
        if method == 'linear':
            beta = (f1 - f0) / t1
            ph = _TWO_PI * (f0 * t + 0.5 * beta * t * t)
        elif method == 'quadratic':
            beta = (f1 - f0) / (t1 * t1)
            ph = _TWO_PI * (f0 * t + beta * t * t * t / 3.0)
        elif method == 'logarithmic':
            ph = (_TWO_PI * f0 * t1 * (torch.pow(f1 / f0, t / t1) - 1.0)
                  / math.log(f1 / f0))
        else:  # hyperbolic
            sing = -f1 * t1 / (f0 - f1)
            ph = _TWO_PI * (-sing * f0) * torch.log(torch.abs(1.0 - t / sing))
        return torch.cos(ph + phi)

    return _wave('chirp', t, dtype, formula)


def square(t, duty: float = 0.5, dtype: Dtype = Dtype.F32) -> Tensor:
    """Square wave with period 2*pi (scipy.signal.square semantics):
    +1 for the first ``duty`` fraction of each period, -1 after."""
    if not 0 <= duty <= 1:
        raise RuntimeError(f'square: duty ({duty}) must be in [0, 1]')
    duty = float(duty)

    def formula(t):
        return torch.where(_phase_frac(t) < duty, 1.0, -1.0)

    return _wave('square', t, dtype, formula)


def sawtooth(t, width: float = 1.0, dtype: Dtype = Dtype.F32) -> Tensor:
    """Sawtooth wave with period 2*pi (scipy.signal.sawtooth semantics):
    rises -1 -> 1 over the first ``width`` fraction of each period,
    falls back over the rest (``width=0.5`` gives a triangle)."""
    if not 0 <= width <= 1:
        raise RuntimeError(f'sawtooth: width ({width}) must be in [0, 1]')
    width = float(width)

    def formula(t):
        frac = _phase_frac(t)
        rise = _div(2.0 * frac, max(width, _TINY)) - 1.0
        fall = _div(2.0 * (1.0 - frac), max(1.0 - width, _TINY)) - 1.0
        return torch.where(frac < width, rise, fall)

    return _wave('sawtooth', t, dtype, formula)


def gausspulse(t, fc: float = 1000.0, bw: float = 0.5, bwr: float = -6.0,
               dtype: Dtype = Dtype.F32) -> Tensor:
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse semantics):
    carrier ``fc`` with fractional bandwidth ``bw`` measured at ``bwr``
    dB (the envelope's variance follows from solving the spectrum
    magnitude at the band edges, scipy's closed form)."""
    if fc <= 0 or bw <= 0 or bwr >= 0:
        raise RuntimeError('gausspulse: need fc > 0, bw > 0, bwr < 0 dB')
    ref = 10.0 ** (bwr / 20.0)
    a = float(-((np.pi * fc * bw) ** 2) / (4.0 * np.log(ref)))
    fc = float(fc)

    def formula(t):
        return torch.exp(-a * t * t) * torch.cos(_TWO_PI * fc * t)

    return _wave('gausspulse', t, dtype, formula)


def sweep_poly(t, poly, phi: float = 0.0,
               dtype: Dtype = Dtype.F32) -> Tensor:
    """Frequency-swept cosine whose instantaneous frequency follows the
    polynomial ``poly`` (scipy.signal.sweep_poly semantics: ``poly`` is
    highest-power-first coefficients or np.poly1d). The phase is the
    exact polynomial integral, by Horner's rule in float64 on the
    device."""
    p = np.poly1d(np.asarray(poly, np.float64))
    ip = np.polyint(p)  # integral, zero constant term
    # phase(t) = ip(t) = t * q(t) with q = ip without the constant term
    q = [float(c) for c in ip.coeffs[:-1]]
    phi = float(np.deg2rad(phi))

    def formula(t):
        ph = torch.zeros_like(t)
        for c in q:
            ph = ph * t + c
        return torch.cos(_TWO_PI * ph * t + phi)

    return _wave('sweep_poly', t, dtype, formula)


# standard primitive-polynomial tap sets for maximal-length LFSRs
# (Fibonacci form; the classic published table for nbits 2..32)
_MLS_TAPS = {
    2: (1,), 3: (2,), 4: (3,), 5: (3,), 6: (5,), 7: (6,), 8: (7, 6, 1),
    9: (5,), 10: (7,), 11: (9,), 12: (11, 10, 4), 13: (12, 11, 8),
    14: (13, 12, 2), 15: (14,), 16: (15, 13, 4), 17: (14,), 18: (11,),
    19: (18, 17, 14), 20: (17,), 21: (19,), 22: (21,), 23: (18,),
    24: (23, 22, 17), 25: (22,), 26: (25, 24, 20), 27: (26, 25, 22),
    28: (25,), 29: (27,), 30: (29, 28, 7), 31: (28,), 32: (31, 30, 10),
}


def max_len_seq(nbits: int, state=None, length=None, taps=None):
    """Maximal-length (pseudo-random binary) sequence from an nbits-wide
    Fibonacci LFSR (scipy.signal.max_len_seq semantics). Returns
    ``(seq, final_state)`` as host arrays: period 2**nbits - 1, default
    state all ones. Host integer math, as in the JAX package: a
    sequential bit recurrence, the design-time tier."""
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise RuntimeError(
                f'max_len_seq: nbits ({nbits}) needs explicit taps '
                f'(built-in table covers {min(_MLS_TAPS)}..{max(_MLS_TAPS)})')
        taps = np.array(_MLS_TAPS[nbits], np.intp)
    else:
        taps = np.unique(np.asarray(taps, np.intp))[::-1]
        if np.any(taps < 0) or np.any(taps > nbits) or taps.size == 0:
            raise RuntimeError('max_len_seq: taps must be in [0, nbits]')
    n_max = (1 << nbits) - 1
    if length is None:
        length = n_max
    elif length < 0:
        raise RuntimeError('max_len_seq: length must be >= 0')
    if state is None:
        state = np.ones(nbits, np.int8)
    else:
        state = (np.asarray(state) != 0).astype(np.int8)
    if state.size != nbits or not np.any(state):
        raise RuntimeError(
            'max_len_seq: state must be nbits long and not all zero')
    seq = np.empty(int(length), np.int8)
    idx = 0
    for i in range(int(length)):
        fb = state[idx]
        seq[i] = fb
        for t_ in taps:
            fb ^= state[(t_ + idx) % nbits]
        state[idx] = fb
        idx = (idx + 1) % nbits
    return seq, np.roll(state, -idx)


def vectorstrength(events, period):
    """Vector strength (phase locking) of event times to one or more
    periods (scipy.signal.vectorstrength semantics): the length and
    angle of the mean unit phasor, on the host. Returns (strength,
    phase)."""
    events = np.asarray(
        events.numpy() if isinstance(events, Tensor) else events,
        np.float64)
    if events.ndim != 1:
        raise RuntimeError('vectorstrength: events must be 1-D')
    periods = np.asarray(period, np.float64)
    scalar = periods.ndim == 0
    periods = np.atleast_1d(periods)
    if np.any(periods <= 0):
        raise RuntimeError('vectorstrength: periods must be positive')
    ang = 2.0 * np.pi * events[None, :] / periods[:, None]
    vec = np.exp(1j * ang).mean(axis=1)
    strength, phase = np.abs(vec), np.angle(vec)
    if scalar:
        return float(strength[0]), float(phase[0])
    return strength, phase
