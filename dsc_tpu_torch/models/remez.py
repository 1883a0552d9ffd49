"""Parks-McClellan equiripple FIR design (``remez``).

The classic Chebyshev-exchange algorithm (scipy.signal.remez 'bandpass'
semantics), implemented from scratch host-side in f64: dense frequency
grid over the bands, barycentric Lagrange evaluation of the equiripple
interpolant, extremal exchange until the ripple stabilizes, impulse
response recovered by frequency sampling. The optimal Chebyshev
approximation is unique, so converged taps match scipy's to the
convergence tolerance.

Supports symmetric (type I/II) designs — scipy's default
``type='bandpass'`` — for both odd and even ``numtaps`` (even designs
use the ``cos(pi f)`` basis transformation and force zero at Nyquist).
Design-time code, not a hot path (dsc_tpu/models/remez.py, the same
NumPy code): the taps are uploaded once, to ``context.device()``.

The exchange can stop short of the optimum: at some even lengths (128
taps over [0, .1, .2, .4, .45, .5], [0, 1, 0]) its taps are up to 0.108
from scipy's and its ripple about 10% above scipy's, as in the JAX
package (ROADMAP, reference defects).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..dtype import Dtype
from ..tensor import Tensor, from_numpy


def _barycentric_gamma(x: np.ndarray) -> np.ndarray:
    """gamma_i = 1/prod_{j!=i}(x_i - x_j), computed in log-magnitude +
    sign so products of hundreds of factors neither overflow nor
    underflow."""
    d = x[:, None] - x[None, :]
    np.fill_diagonal(d, 1.0)
    logs = np.sum(np.log(np.abs(d)), axis=1)
    signs = np.prod(np.sign(d), axis=1)
    # a common scale factor cancels in every gamma ratio below
    return signs * np.exp(-(logs - logs.mean()))


def _eval_bary(xg, xe, ye, gamma):
    """Barycentric-II evaluation of the interpolant through (xe, ye)
    with weights gamma at points xg; exact at nodes."""
    d = xg[:, None] - xe[None, :]
    hit = np.isclose(d, 0.0, atol=1e-14)
    w = gamma[None, :] / np.where(hit, 1.0, d)
    num = np.sum(w * ye[None, :], axis=1)
    den = np.sum(w, axis=1)
    out = num / den
    rows, cols = np.nonzero(hit)
    out[rows] = ye[cols]
    return out


def remez(numtaps: int, bands: Sequence[float], desired: Sequence[float],
          weight: Optional[Sequence[float]] = None, fs: float = 1.0,
          maxiter: int = 40, grid_density: int = 16,
          dtype: Dtype = Dtype.F32) -> Tensor:
    """Equiripple FIR design (scipy.signal.remez 'bandpass' semantics):
    ``bands`` are 2*n_bands edge frequencies in [0, fs/2], ``desired``
    one target amplitude per band, ``weight`` one ripple weight per
    band. Returns the (numtaps,) taps as a Tensor."""
    if numtaps < 3:
        raise RuntimeError(f'remez: numtaps ({numtaps}) must be >= 3')
    bands = np.asarray(bands, np.float64) / fs
    desired = np.asarray(desired, np.float64)
    if bands.ndim != 1 or bands.size % 2 or bands.size < 2:
        raise RuntimeError('remez: bands must be a flat list of edge pairs')
    nb = bands.size // 2
    if desired.shape != (nb,):
        raise RuntimeError(
            f'remez: need one desired amplitude per band ({nb}), got '
            f'{desired.shape}'
        )
    if np.any(np.diff(bands) < 0) or bands[0] < 0 or bands[-1] > 0.5:
        raise RuntimeError(
            'remez: band edges must be nondecreasing within [0, fs/2]'
        )
    weight = (np.ones(nb) if weight is None
              else np.asarray(weight, np.float64))
    if weight.shape != (nb,):
        raise RuntimeError(f'remez: need one weight per band ({nb})')
    even = numtaps % 2 == 0
    if even and desired[-1] != 0 and bands[-1] == 0.5:
        raise RuntimeError(
            'remez: even numtaps forces zero gain at Nyquist'
        )
    r = (numtaps + 1) // 2 if not even else numtaps // 2

    # dense grid over the bands
    step = 0.5 / (r * grid_density)
    gf, gd, gw = [], [], []
    for i in range(nb):
        lo, hi = bands[2 * i], bands[2 * i + 1]
        npts = max(int(np.ceil((hi - lo) / step)) + 1, 2)
        f = np.linspace(lo, hi, npts)
        gf.append(f)
        gd.append(np.full(npts, desired[i]))
        gw.append(np.full(npts, weight[i]))
    gf = np.concatenate(gf)
    gd = np.concatenate(gd)
    gw = np.concatenate(gw)
    if even:
        # type II: H(f) = cos(pi f) P(f); fold the factor into D and W
        keep = gf < 0.5 - 1e-12
        gf, gd, gw = gf[keep], gd[keep], gw[keep]
        cfac = np.cos(np.pi * gf)
        gd = gd / cfac
        gw = gw * cfac
    if gf.size < r + 1:
        raise RuntimeError('remez: grid too small; lower numtaps')

    xg = np.cos(2.0 * np.pi * gf)

    # initial extremals: evenly spread over the grid
    ext = np.round(np.linspace(0, gf.size - 1, r + 1)).astype(int)
    ext = np.unique(ext)
    while ext.size < r + 1:  # defensive: duplicates collapsed
        cand = np.setdiff1d(np.arange(gf.size), ext)
        ext = np.sort(np.concatenate([ext, cand[: r + 1 - ext.size]]))

    last_delta = None
    for _ in range(maxiter):
        xe, de, we = xg[ext], gd[ext], gw[ext]
        gamma = _barycentric_gamma(xe)
        signs = (-1.0) ** np.arange(r + 1)
        delta = np.sum(gamma * de) / np.sum(gamma * signs / we)
        ye = de - signs * delta / we
        # interpolate through the first r extremals (standard PM choice)
        h_grid = _eval_bary(xg, xe[:r], ye[:r],
                            _barycentric_gamma(xe[:r]))
        err = (gd - h_grid) * gw

        # locate alternating extrema of the weighted error
        cand = [0] if gf.size > 1 else []
        for i in range(1, gf.size - 1):
            if (err[i] - err[i - 1]) * (err[i + 1] - err[i]) <= 0:
                cand.append(i)
        cand.append(gf.size - 1)
        cand = np.array(sorted(set(cand)))
        # enforce sign alternation: among consecutive same-sign
        # candidates keep the largest |err|
        keep = []
        for i in cand:
            if keep and np.sign(err[i]) == np.sign(err[keep[-1]]):
                if abs(err[i]) > abs(err[keep[-1]]):
                    keep[-1] = i
            else:
                keep.append(i)
        keep = np.array(keep)
        if keep.size < r + 1:
            break  # converged as well as this grid allows
        # trim to exactly r+1, dropping the weakest end extremum
        while keep.size > r + 1:
            if abs(err[keep[0]]) < abs(err[keep[-1]]):
                keep = keep[1:]
            else:
                keep = keep[:-1]
        new_ext = keep
        cur = abs(delta)
        if last_delta is not None and abs(cur - last_delta) < 1e-12 + 1e-9 * cur:
            ext = new_ext
            break
        last_delta = cur
        if np.array_equal(new_ext, ext):
            break
        ext = new_ext

    # final interpolant on the numtaps-point frequency-sampling grid
    xe, de, we = xg[ext], gd[ext], gw[ext]
    gamma = _barycentric_gamma(xe)
    signs = (-1.0) ** np.arange(len(ext))
    delta = np.sum(gamma * de) / np.sum(gamma * signs / we)
    ye = de - signs * delta / we
    ks = np.arange(numtaps // 2 + 1)
    fsamp = ks / numtaps
    amp = _eval_bary(np.cos(2.0 * np.pi * fsamp), xe[:r], ye[:r],
                     _barycentric_gamma(xe[:r]))
    if even:
        amp = amp * np.cos(np.pi * fsamp)
        amp[fsamp >= 0.5 - 1e-12] = 0.0
    # linear-phase frequency sampling -> real symmetric taps
    phase = np.exp(-1j * np.pi * ks * (numtaps - 1) / numtaps)
    spec = amp * phase
    taps = np.fft.irfft(spec, numtaps)
    return from_numpy(taps.astype(np.float32) if dtype == Dtype.F32
                      else taps)
