"""Partial-fraction expansion: residue / residuez / invres / invresz
(scipy.signal semantics; dsc_tpu/models/pfe.py, the same NumPy code).

Host f64/complex polynomial math. Repeated poles are handled exactly by
Taylor-series division: for a pole p of multiplicity m, the residues are
the first m series coefficients of (s-p)^m B(s)/A(s) around p, computed
by dividing the Taylor expansions of B and of A deflated by (s-p)^m —
no numerical differentiation. residuez works in the v = z^-1 domain and
converts each (v - v0)^-j term to scipy's (1 - p z^-1)^-j basis."""

from __future__ import annotations

import numpy as np


def _group_poles(p, tol: float, rtype: str):
    if rtype not in ('avg', 'min', 'max'):
        raise RuntimeError(f'unknown rtype {rtype!r}')
    p = np.sort_complex(np.asarray(p, complex))
    groups = []
    for x in p:
        if groups and abs(x - groups[-1][0]) <= tol:
            vals = groups[-1][1]
            vals.append(x)
            if rtype == 'avg':
                groups[-1][0] = np.mean(vals)
            elif rtype == 'min':
                groups[-1][0] = vals[int(np.argmin(np.abs(vals)))]
            else:
                groups[-1][0] = vals[int(np.argmax(np.abs(vals)))]
        else:
            groups.append([x, [x]])
    return [(g[0], len(g[1])) for g in groups]


def _taylor(c, p, m: int):
    """First m Taylor coefficients of polynomial c (highest-first) at p."""
    out = np.empty(m, complex)
    cur = np.asarray(c, complex)
    fact = 1.0
    for j in range(m):
        out[j] = np.polyval(cur, p) / fact
        cur = np.polyder(cur) if cur.size > 1 else np.zeros(1)
        fact *= (j + 1)
    return out


def _pfe_core(b, a, tol: float, rtype: str):
    """Shared engine: returns (groups [(pole, mult)], residues-per-group
    [c_0..c_{m-1}] (c_i multiplies (x-p)^(i-m)), direct polynomial)."""
    b = np.trim_zeros(np.atleast_1d(np.asarray(b, complex)), 'f')
    a = np.trim_zeros(np.atleast_1d(np.asarray(a, complex)), 'f')
    if a.size == 0:
        raise RuntimeError('denominator is zero')
    if b.size >= a.size:
        k, b = np.polydiv(b, a)
    else:
        k = np.zeros(0)
    groups = _group_poles(np.roots(a), tol, rtype)
    coeffs = []
    for p0, m in groups:
        q = np.asarray(a, complex)
        for _ in range(m):
            q, _ = np.polydiv(q, np.asarray([1.0, -p0]))
        bt = _taylor(b, p0, m) if b.size else np.zeros(m, complex)
        qt = _taylor(q, p0, m)
        g = np.empty(m, complex)
        for i in range(m):
            acc = bt[i]
            for j in range(i):
                acc -= g[j] * qt[i - j]
            g[i] = acc / qt[0]
        coeffs.append(g)
    return groups, coeffs, k


def _realify(x):
    x = np.asarray(x)
    if np.iscomplexobj(x) and np.allclose(x.imag, 0.0, atol=1e-12 * max(
            1.0, float(np.abs(x).max() if x.size else 1.0))):
        return x.real
    return x


def residue(b, a, tol: float = 1e-3, rtype: str = 'avg'):
    """Continuous-time partial fractions of B(s)/A(s)
    (scipy.signal.residue): returns (r, p, k) with, for a pole of
    multiplicity m, residues ordered r/(s-p), r/(s-p)^2, ..."""
    groups, coeffs, k = _pfe_core(b, a, tol, rtype)
    r, pout = [], []
    for (p0, m), g in zip(groups, coeffs):
        for j in range(m):  # power j+1 <- series coefficient m-1-j
            r.append(g[m - 1 - j])
            pout.append(p0)
    return (np.asarray(r), np.asarray(pout, complex), _realify(k))


def residuez(b, a, tol: float = 1e-3, rtype: str = 'avg'):
    """Discrete-time partial fractions of
    (b[0] + b[1] z^-1 + ...)/(a[0] + a[1] z^-1 + ...)
    (scipy.signal.residuez): returns (r, p, k) with terms
    r/(1 - p z^-1)^j and k[i] z^-i direct terms."""
    bv = np.atleast_1d(np.asarray(b, complex))[::-1]  # poly in v = z^-1
    av = np.atleast_1d(np.asarray(a, complex))[::-1]
    groups, coeffs, kv = _pfe_core(bv, av, tol, rtype)
    r, pout = [], []
    for (v0, m), g in zip(groups, coeffs):
        if v0 == 0:
            raise RuntimeError('residuez: pole at z = infinity (a has a '
                               'trailing zero)')
        p0 = 1.0 / v0
        # c/(v - v0)^j = c * (-p0)^j / (1 - p0 v)^j
        for j in range(1, m + 1):
            r.append(g[m - j] * (-p0) ** j)
            pout.append(p0)
    k = _realify(kv[::-1]) if np.asarray(kv).size else np.zeros(0)
    return np.asarray(r), np.asarray(pout, complex), k


def invres(r, p, k, tol: float = 1e-3, rtype: str = 'avg'):
    """Inverse of :func:`residue`: rebuild (b, a) from (r, p, k)
    (scipy.signal.invres semantics)."""
    r = np.atleast_1d(np.asarray(r, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    k = np.atleast_1d(np.asarray(k, complex)) if np.asarray(k).size \
        else np.zeros(0)
    if r.size != p.size:
        raise RuntimeError('invres: r and p sizes differ')
    groups = _group_poles(p, tol, rtype)
    a = np.ones(1, complex)
    for p0, m in groups:
        for _ in range(m):
            a = np.polymul(a, np.asarray([1.0, -p0]))
    b = np.zeros(1, complex)
    idx = 0
    # r is ordered group-major (matching _group_poles' sorted order),
    # powers ascending within each group — scipy's residue layout
    order = np.argsort(p)
    r_sorted = r[order]
    for p0, m in groups:
        q = np.asarray(a)
        for _ in range(m):
            q, _ = np.polydiv(q, np.asarray([1.0, -p0]))
        # power j+1 term: r * a/(s-p0)^(j+1) = r * q * (s-p0)^(m-1-j)
        for j in range(m):
            term = q
            for _ in range(m - 1 - j):
                term = np.polymul(term, np.asarray([1.0, -p0]))
            b = np.polyadd(b, r_sorted[idx] * term)
            idx += 1
    if k.size:
        b = np.polyadd(b, np.polymul(k, a))
    return _realify(b), _realify(a)


def invresz(r, p, k, tol: float = 1e-3, rtype: str = 'avg'):
    """Inverse of :func:`residuez`: rebuild ascending-z^-1 (b, a)
    (scipy.signal.invresz semantics)."""
    r = np.atleast_1d(np.asarray(r, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    if r.size != p.size:
        raise RuntimeError('invresz: r and p sizes differ')
    groups = _group_poles(p, tol, rtype)
    # denominator in v: prod (1 - p0 v)^m
    av = np.ones(1, complex)
    for p0, m in groups:
        for _ in range(m):
            av = np.polymul(av, np.asarray([-p0, 1.0]))  # (1 - p0 v)
    bv = np.zeros(1, complex)
    order = np.argsort(p)
    r_sorted = r[order]
    idx = 0
    for p0, m in groups:
        # av deflated by (1 - p0 v)^m
        q = np.asarray(av)
        for _ in range(m):
            q, _ = np.polydiv(q, np.asarray([-p0, 1.0]))
        for j in range(m):  # term r/(1 - p0 v)^(j+1)
            term = q
            for _ in range(m - 1 - j):
                term = np.polymul(term, np.asarray([-p0, 1.0]))
            bv = np.polyadd(bv, r_sorted[idx] * term)
            idx += 1
    kk = np.atleast_1d(np.asarray(k, complex)) if np.asarray(k).size \
        else np.zeros(0)
    if kk.size:
        bv = np.polyadd(bv, np.polymul(kk[::-1], av))
    return _realify(bv[::-1]), _realify(av[::-1])
