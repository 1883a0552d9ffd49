"""B-spline signal processing (dsc_tpu/models/splines.py): the
``symiirorder1`` / ``symiirorder2`` mirror-symmetric IIR smoothers, the
``cspline1d`` / ``qspline1d`` coefficient transforms (+ ``_eval``),
``gauss_spline`` and the 2-D tier (``cspline2d``, ``qspline2d``,
``sepfir2d``, ``spline_filter``).

scipy.signal semantics. The forward/backward recursions run on the device
in float64 as the log-depth scan of ``_affine_scan`` (first-order scalar
maps, second-order 2x2 companion maps), never a loop over samples; the
result is cast to float32 once, at the end. The mirror-symmetric initial
conditions are truncated power-series dot products (scipy's construction),
their tables built on the host in float64 as the JAX package builds them.
No TPU kernel is on this path (the JAX package runs the scans as
``lax.associative_scan``). Basis evaluation (``cspline1d_eval``)
interpolates at arbitrary points on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..tensor import Tensor, transpose
from ._affine_scan import affine_scan_, scan_maps


def _as_rows(x: Tensor, who: str):
    """(a float64 copy of ``x`` as (b, n) rows on its device, which the
    caller may write over, whether ``x`` was 2-D)."""
    if x.n_dim > 2:
        raise RuntimeError(f'{who}: expected 1-D or 2-D input, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError(f'{who} expects a real signal')
    batched = x.n_dim == 2
    xj = x.torch.to(torch.float64, copy=True)
    return (xj if batched else xj[None, :]), batched


def _result(out: torch.Tensor, batched: bool) -> Tensor:
    out = out.to(torch.float32)
    return Tensor._from_torch(out if batched else out[0])


def _scan1_(v, z1_maps):
    """y[k] = v[k] + z1*y[k-1] with y[0] = v[0], over v (b, n) in place."""
    affine_scan_(v[..., None], z1_maps)
    return v


def _scan2(v, a2, a3, y0, y1, maps):
    """y[k] = v[k] + a2*y[k-1] + a3*y[k-2] with y[0], y[1] given: the
    companion map's affine scan of the states (y[k], y[k-1]) over the
    (b, n-2) steps k = 2..n-1, (y1, y0) folded into the first. Returns (b,
    n)."""
    b, n = v.shape
    s = torch.zeros((b, n - 2, 2), dtype=v.dtype, device=v.device)
    s[:, :, 0] = v[:, 2:]
    s[:, 0, 0] += a2 * y1 + a3 * y0
    s[:, 0, 1] += y1
    affine_scan_(s, maps)
    return torch.cat([y0[:, None], y1[:, None], s[:, :, 0]], dim=1)


def _sym_precision(precision: float) -> float:
    # scipy's C default for double precision inputs (splinemodule
    # lineage): terms below 1e-11 stop the boundary series
    if precision <= 0.0 or precision > 1.0:
        return 1e-11
    return float(precision)


def _series_len(base: float, precision: float, n: int, who: str,
                strict: bool = True) -> int:
    if precision <= 0.0:  # 0 = no truncation (full-signal sums)
        return n
    if base <= 0.0:
        return 1
    k = int(np.ceil(np.log(precision) / np.log(base))) + 1
    if k > n:
        # scipy's symiirorder1 C raises when the series cannot reach
        # its precision within the signal (strict); symiirorder2's IC
        # kernels stop at their first small TERM (a looser,
        # data-dependent rule), so there we truncate at n instead
        if strict:
            raise RuntimeError(
                f'{who}: boundary-condition series did not converge '
                f'within the signal length (|pole|={base:.4f}, n={n})')
        return n
    return max(k, 1)


def _symiir1_program(x, c0, z1, l):
    # mirror WITH the edge sample repeated (x[-1-k] = x[k], scipy's
    # symiirorder1_ic): y0 = x0 + z1 * sum z1^k x[k]
    maps = scan_maps([[z1]], x.shape[1], x.device)
    k = torch.arange(l, dtype=x.dtype, device=x.device)
    x[:, 0] += z1 * torch.matmul(x[:, :l], torch.pow(z1, k))
    y1 = _scan1_(x, maps)
    out_last = -c0 / (z1 - 1.0) * y1[:, -1]
    vr = (c0 * y1).flip(-1)
    vr[:, 0] = out_last
    return _scan1_(vr, maps).flip(-1)


def symiirorder1(signal: Tensor, c0: float, z1: float,
                 precision: float = -1.0) -> Tensor:
    """Mirror-symmetric smoothing IIR, first-order cascade
    H(z) = c0/((1 - z1 z^-1)(1 - z1 z)) (scipy.signal.symiirorder1
    semantics). signal: (n,) or batched (b, n); the two recursions run
    as log-depth scans on its device, in float64."""
    if abs(z1) >= 1.0:
        raise RuntimeError('symiirorder1: |z1| must be < 1')
    xj, batched = _as_rows(signal, 'symiirorder1')
    prec = _sym_precision(precision)
    l = _series_len(abs(z1), prec, xj.shape[1], 'symiirorder1')
    with tracing.trace_op(
        'symiirorder1', 'op;pipeline', tracing.tensor_args(x=signal)
    ):
        out = _symiir1_program(xj, float(c0), float(z1), l)
    return _result(out, batched)


def _hc_vec(k, cs, rho, omega):
    k = np.asarray(k, np.float64)
    if omega == 0.0:
        h = cs * rho ** k * (k + 1.0)
    else:
        h = cs / np.sin(omega) * rho ** k * np.sin(omega * (k + 1.0))
    return np.where(k > -1, h, 0.0)


def _hs_vec(k, cs, rho, omega):
    ak = np.abs(np.asarray(k, np.float64))
    c0 = (cs * cs * (1 + rho * rho) / (1 - rho * rho)
          / (1 - 2 * rho * rho * np.cos(2 * omega) + rho ** 4))
    gamma = (1 - rho * rho) / (1 + rho * rho) / np.tan(omega)
    return c0 * rho ** ak * (np.cos(omega * ak) + gamma * np.sin(omega * ak))


def _symiir2_core(x, cs, a2, a3, hc0, hc1, tables, swap01=True):
    # forward ICs (mirror-symmetric steady state):
    #   y0 = hc(0) x0 + sum hc(k+1) x[k]
    #   y1 = hc(0) x1 + hc(1) x0 + ... (symiirorder2's C convention), or
    #   y1 = hc(0) x0 + hc(1) x1 + ... (the smoothing-spline convention)
    # ``tables``: the (4, n) rows hfwd0, hfwd1, hbwd_last, hbwd_last2
    maps = scan_maps([[a2, a3], [1.0, 0.0]], x.shape[1] - 2, x.device)
    hfwd0, hfwd1, hbwd_last, hbwd_last2 = torch.from_numpy(tables).to(x.device)
    y0 = hc0 * x[:, 0] + x @ hfwd0
    if swap01:
        y1 = hc0 * x[:, 1] + hc1 * x[:, 0] + x @ hfwd1
    else:
        y1 = hc0 * x[:, 0] + hc1 * x[:, 1] + x @ hfwd1
    # backward ICs from the SYMMETRIC response to the input
    xr = x.flip(-1)
    o_last = xr @ hbwd_last
    o_last2 = xr @ hbwd_last2
    yf = _scan2(cs * x, a2, a3, y0, y1, maps)
    yr = _scan2(cs * yf.flip(-1), a2, a3, o_last, o_last2, maps)
    return yr.flip(-1)


def _symiir2_host_tables(r, omega, n, precision, who):
    """cs and the (4, n) float64 boundary tables hfwd0, hfwd1, hbwd_last,
    hbwd_last2, zero past the series length."""
    cs = 1.0 - 2.0 * r * np.cos(omega) + r * r
    l = _series_len(abs(r), precision, n, who, strict=False)
    k = np.arange(n, dtype=np.float64)
    zero = np.zeros(n)
    hfwd0 = np.where(k < l, _hc_vec(k + 1, cs, r, omega), zero)
    hfwd1 = np.where(k < l, _hc_vec(k + 2, cs, r, omega), zero)
    hb0 = np.where(k < l, _hs_vec(k, cs, r, omega)
                   + _hs_vec(k + 1, cs, r, omega), zero)
    hb1 = np.where(k < l, _hs_vec(k - 1, cs, r, omega)
                   + _hs_vec(k + 2, cs, r, omega), zero)
    return cs, np.stack([hfwd0, hfwd1, hb0, hb1])


def _symiir2(signal, xj, batched, r, omega, precision, who, swap01):
    """The second-order cascade of symiirorder2 and the smoothing cspline1d
    over the rows ``xj``, traced as ``who``."""
    cs, tables = _symiir2_host_tables(r, omega, xj.shape[1], precision, who)
    a2, a3 = 2.0 * r * np.cos(omega), -(r * r)
    hc0 = float(_hc_vec(0, cs, r, omega))
    hc1 = float(_hc_vec(1, cs, r, omega))
    with tracing.trace_op(who, 'op;pipeline', tracing.tensor_args(x=signal)):
        out = _symiir2_core(xj, float(cs), float(a2), float(a3), hc0, hc1, tables,
                            swap01=swap01)
    return _result(out, batched)


def symiirorder2(signal: Tensor, r: float, omega: float,
                 precision: float = -1.0) -> Tensor:
    """Mirror-symmetric smoothing IIR, second-order cascade
    H(z) = cs^2 / ((1 - a2 z^-1 - a3 z^-2)(1 - a2 z - a3 z^2)) with
    a2 = 2 r cos(omega), a3 = -r^2 (scipy.signal.symiirorder2
    semantics); log-depth companion scans on its device, in float64."""
    if abs(r) >= 1.0:
        raise RuntimeError('symiirorder2: r must be < 1')
    xj, batched = _as_rows(signal, 'symiirorder2')
    if xj.shape[1] < 4:
        raise RuntimeError('symiirorder2: signal too short')
    return _symiir2(signal, xj, batched, float(r), float(omega),
                    _sym_precision(precision), 'symiirorder2', True)


# ------------------------------------------------------- spline transforms

def _spline_coeff_program(x, zi, scale):
    n = x.shape[1]
    maps = scan_maps([[zi]], n, x.device)
    powers = torch.pow(zi, torch.arange(n, dtype=x.dtype, device=x.device))
    x[:, 0] += zi * torch.matmul(x, powers)
    yplus = _scan1_(x, maps)
    out_last = zi / (zi - 1.0) * yplus[:, -1]
    # output[k] = zi*(output[k+1] - yplus[k]) = -zi*yplus[k] + zi*out[k+1]
    vr = (-zi * yplus).flip(-1)
    vr[:, 0] = out_last
    return _scan1_(vr, maps).flip(-1) * scale


def _coeff_smooth_params(lam: float):
    xi = 1.0 - 96.0 * lam + 24.0 * lam * np.sqrt(3.0 + 144.0 * lam)
    omeg = np.arctan2(np.sqrt(144.0 * lam - 1.0), np.sqrt(xi))
    rho = (24.0 * lam - 1.0 - np.sqrt(xi)) / (24.0 * lam)
    rho = rho * np.sqrt(
        (48.0 * lam + 24.0 * lam * np.sqrt(3.0 + 144.0 * lam)) / xi)
    return float(rho), float(omeg)


def cspline1d(signal: Tensor, lamb: float = 0.0) -> Tensor:
    """Cubic B-spline coefficients with mirror-symmetric boundaries
    (scipy.signal.cspline1d semantics): exact interpolation for
    ``lamb=0``, smoothing spline for ``lamb > 1/144``. Device scans."""
    xj, batched = _as_rows(signal, 'cspline1d')
    if lamb == 0.0:
        with tracing.trace_op(
            'cspline1d', 'op;pipeline', tracing.tensor_args(x=signal)
        ):
            out = _spline_coeff_program(xj, float(-2.0 + np.sqrt(3.0)), 6.0)
        return _result(out, batched)
    if 144.0 * lamb <= 1.0:
        raise RuntimeError(
            f'cspline1d: smoothing needs lamb > 1/144, got {lamb}')
    rho, omeg = _coeff_smooth_params(float(lamb))
    # the smoothing-spline ICs sum over the FULL signal (scipy
    # _cubic_smooth_coeff) and use the unswapped y1 convention
    return _symiir2(signal, xj, batched, rho, omeg, 0.0, 'cspline1d', False)


def qspline1d(signal: Tensor, lamb: float = 0.0) -> Tensor:
    """Quadratic B-spline coefficients (scipy.signal.qspline1d; only
    ``lamb = 0`` is defined, like scipy)."""
    if lamb != 0.0:
        raise RuntimeError('qspline1d: only lamb == 0 is supported')
    xj, batched = _as_rows(signal, 'qspline1d')
    with tracing.trace_op(
        'qspline1d', 'op;pipeline', tracing.tensor_args(x=signal)
    ):
        out = _spline_coeff_program(xj, float(-3.0 + 2.0 * np.sqrt(2.0)), 8.0)
    return _result(out, batched)


# ------------------------------------------------------------ evaluation

def _bspline_cubic(x):
    ax = np.abs(np.asarray(x, np.float64))
    return np.where(ax < 1.0, 2.0 / 3.0 - ax * ax + ax ** 3 / 2.0,
                    np.where(ax < 2.0, (2.0 - ax) ** 3 / 6.0, 0.0))


def _bspline_quad(x):
    ax = np.abs(np.asarray(x, np.float64))
    return np.where(ax < 0.5, 0.75 - ax * ax,
                    np.where(ax < 1.5, (ax - 1.5) ** 2 / 2.0, 0.0))


def _spline_eval(cj, newx, x0, dx, basis, support, who):
    cj = np.asarray(cj.numpy() if isinstance(cj, Tensor) else cj,
                    np.float64)
    if cj.ndim != 1 or cj.size == 0:
        raise RuntimeError(f'{who}: coefficients must be non-empty 1-D')
    t = (np.asarray(newx, np.float64) - x0) / float(dx)
    n = cj.size
    # mirror-symmetric domain folding
    t = np.abs(t)
    period = 2.0 * (n - 1)
    if n > 1:
        t = np.mod(t, period)
        t = np.where(t > n - 1, period - t, t)
    else:
        t = np.zeros_like(t)
    res = np.zeros_like(t)
    jlower = np.floor(t - support / 2.0).astype(int) + 1
    for i in range(support):
        thisj = jlower + i
        indj = np.clip(thisj, 0, n - 1)
        res += cj[indj] * basis(t - thisj)
    return res


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0):
    """Evaluate a cubic-spline signal model at new points
    (scipy.signal.cspline1d_eval semantics, mirror-symmetric
    extension). Host evaluation (data-dependent gathers)."""
    return _spline_eval(cj, newx, x0, dx, _bspline_cubic, 4,
                        'cspline1d_eval')


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0):
    """Evaluate a quadratic-spline signal model at new points
    (scipy.signal.qspline1d_eval semantics)."""
    return _spline_eval(cj, newx, x0, dx, _bspline_quad, 3,
                        'qspline1d_eval')


def gauss_spline(x, n: int):
    """Gaussian approximation of an order-n B-spline
    (scipy.signal.gauss_spline)."""
    x = np.asarray(x.numpy() if isinstance(x, Tensor) else x, np.float64)
    sig2 = (n + 1) / 12.0
    return np.exp(-x * x / (2.0 * sig2)) / np.sqrt(2.0 * np.pi * sig2)


# ------------------------------------------------------------ 2-D splines

def _along_axes(func, x: Tensor, *args, **kw) -> Tensor:
    """Apply a batched-rows 1-D transform along axis -1 then axis 0 of a
    2-D Tensor (scipy's symiirorder_nd composition)."""
    out = func(x, *args, **kw)
    out = func(transpose(out), *args, **kw)
    return transpose(out)


def cspline2d(signal: Tensor, lamb: float = 0.0,
              precision: float = -1.0) -> Tensor:
    """2-D cubic B-spline coefficients (scipy.signal.cspline2d
    semantics): the separable symiirorder1 transform for
    ``lamb <= 1/144`` (c0 = -6r, z1 = r = sqrt(3)-2), the separable
    symiirorder2 smoother above. Both run as device scans along rows,
    then columns. For the smoothing case the boundary values differ
    from scipy's at ~1e-6 absolute: its C stops each boundary series at
    the FIRST term under its precision default, dropping the
    oscillating tail; this implementation sums the decayed series."""
    if signal.n_dim != 2:
        raise RuntimeError(f'cspline2d: expected a 2-D image, got '
                           f'{signal.n_dim}-D')
    if lamb <= 1.0 / 144.0:
        r = -2.0 + np.sqrt(3.0)
        return _along_axes(symiirorder1, signal, -r * 6.0, r,
                           precision=precision)
    r, omega = _coeff_smooth_params(float(lamb))
    return _along_axes(symiirorder2, signal, r, omega,
                       precision=precision)


def qspline2d(signal: Tensor, lamb: float = 0.0,
              precision: float = -1.0) -> Tensor:
    """2-D quadratic B-spline coefficients (scipy.signal.qspline2d;
    ``lamb`` must be 0, like scipy)."""
    if signal.n_dim != 2:
        raise RuntimeError(f'qspline2d: expected a 2-D image, got '
                           f'{signal.n_dim}-D')
    if lamb > 0:
        raise RuntimeError('qspline2d: lamb must be <= 0')
    r = -3.0 + 2.0 * np.sqrt(2.0)
    return _along_axes(symiirorder1, signal, -r * 8.0, r,
                       precision=precision)


def _pad_symmetric(x, p: int, dim: int):
    """``np.pad(mode='symmetric')`` of ``p`` samples on each side along
    ``dim``: the edge sample repeated (torch's 'reflect' drops it). Past
    the signal's length the extension repeats with period 2n, so each
    round reflects at most n samples about an edge that is an axis of it."""
    n = x.shape[dim]
    while p > 0:
        q = min(p, n)
        size = x.shape[dim]
        x = torch.cat([x.narrow(dim, 0, q).flip(dim), x,
                       x.narrow(dim, size - q, q).flip(dim)], dim)
        p -= q
    return x


def _sepfir2d_program(x, hrow, hcol):
    """The rows (along the last axis) convolved with ``hrow``, then the
    columns with ``hcol``, as scipy does; the JAX package applies hcol along
    the rows and hrow along the columns (ROADMAP F6)."""
    m, n = x.shape
    kr, kc = hrow.size, hcol.size
    xp = _pad_symmetric(x, kr // 2, 1)
    rows = torch.zeros_like(x)
    for j in range(kr):
        rows.add_(xp[:, j:j + n], alpha=float(hrow[kr - 1 - j]))
    xp = _pad_symmetric(rows, kc // 2, 0)
    out = torch.zeros_like(x)
    for i in range(kc):
        out.add_(xp[i:i + m, :], alpha=float(hcol[kc - 1 - i]))
    return out


def sepfir2d(input: Tensor, hrow, hcol) -> Tensor:  # noqa: A002
    """Separable 2-D FIR with mirror-symmetric (edge-repeating) boundary
    extension (scipy.signal.sepfir2d semantics): convolve the rows with
    ``hrow`` and the columns with ``hcol``, both odd-length. Shifted-slice
    multiply-adds in float64 on the image's device."""
    if input.n_dim != 2:
        raise RuntimeError(f'sepfir2d: expected a 2-D image, got '
                           f'{input.n_dim}-D')
    hr = np.atleast_1d(np.asarray(hrow, np.float64))
    hc = np.atleast_1d(np.asarray(hcol, np.float64))
    if hr.ndim != 1 or hc.ndim != 1 or hr.size % 2 == 0 \
            or hc.size % 2 == 0:
        raise RuntimeError('sepfir2d: hrow and hcol must be odd-length 1-D')
    with tracing.trace_op(
        'sepfir2d', 'op;pipeline', tracing.tensor_args(x=input)
    ):
        out = _sepfir2d_program(input.torch.to(torch.float64), hr, hc)
    return Tensor._from_torch(out.to(torch.float32))


def spline_filter(Iin: Tensor, lmbda: float = 5.0) -> Tensor:
    """Smoothing-spline filtering of a 2-D image
    (scipy.signal.spline_filter semantics): cubic-spline coefficients at
    fall-off ``lmbda``, then the separable [1, 4, 1]/6 synthesis."""
    ck = cspline2d(Iin, lmbda)
    h = np.asarray([1.0, 4.0, 1.0]) / 6.0
    return sepfir2d(ck, h, h)
