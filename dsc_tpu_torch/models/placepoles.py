"""Full-state-feedback pole placement (scipy.signal.place_poles
contract): find K so that eig(A - B K) equals the requested poles.

Single-input systems use Ackermann's formula — there K is unique, so
the result coincides with scipy's. Multi-input systems use classic
eigenstructure assignment (choose each closed-loop eigenvector inside
the null space of [A - p_i I | B]) with KNV0-style projection sweeps to
improve the eigenvector conditioning; K is NOT unique for MIMO, so the
gain may differ from scipy's YT iterate while placing the same poles —
the returned Bunch reports the achieved `computed_poles` and the
conditioning proxy exactly as scipy's does.

Host f64 linear algebra (design-time tier; dsc_tpu/models/placepoles.py,
the same NumPy code).
"""

from __future__ import annotations

import numpy as np


class _Bunch:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __repr__(self):
        keys = ', '.join(sorted(self.__dict__))
        return f'Bunch({keys})'


def _ackermann(a, b, poles):
    """Unique SISO gain via Ackermann's formula."""
    n = a.shape[0]
    # controllability matrix
    ctrb = np.hstack([np.linalg.matrix_power(a, i) @ b for i in range(n)])
    if np.linalg.matrix_rank(ctrb) < n:
        raise RuntimeError('place_poles: the system is not controllable')
    # phi(A) with phi the desired characteristic polynomial
    coeffs = np.real(np.poly(poles))
    phi = np.zeros_like(a)
    for c in coeffs:
        phi = phi @ a + c * np.eye(n)
    sel = np.zeros((1, n))
    sel[0, -1] = 1.0
    return sel @ np.linalg.solve(ctrb, phi)


def _pair_structure(poles):
    """Group requested poles: list of (pole, is_complex) keeping one of
    each conjugate pair."""
    poles = np.asarray(poles, complex)
    used = np.zeros(len(poles), bool)
    groups = []
    for i, p in enumerate(poles):
        if used[i]:
            continue
        used[i] = True
        if abs(p.imag) > 0:
            # find its conjugate
            for j in range(i + 1, len(poles)):
                if not used[j] and abs(poles[j] - np.conj(p)) < 1e-12:
                    used[j] = True
                    break
            else:
                raise RuntimeError(
                    'place_poles: complex poles must come in conjugate '
                    'pairs')
            groups.append((p, True))
        else:
            groups.append((p, False))
    return groups


def place_poles(A, B, poles, method: str = 'YT', rtol: float = 1e-3,
                maxiter: int = 30) -> _Bunch:
    """Closed-loop pole placement (scipy.signal.place_poles semantics
    for the returned fields): computes ``K`` with
    eig(A - B K) = ``poles``. Returns a Bunch with ``gain_matrix``,
    ``computed_poles``, ``requested_poles``, ``X`` (the closed-loop
    eigenvectors), ``rtol`` and ``nb_iter``. ``method`` accepted for
    API compatibility ('YT' | 'KNV0'); multi-input gains are
    conditioned by projection sweeps but may differ from scipy's
    (K is not unique — the placed poles are the contract)."""
    a = np.atleast_2d(np.asarray(A, np.float64))
    b = np.atleast_2d(np.asarray(B, np.float64))
    n = a.shape[0]
    if a.shape != (n, n) or b.shape[0] != n:
        raise RuntimeError('place_poles: A must be (n, n), B (n, m)')
    poles = np.sort_complex(np.asarray(poles, complex))
    if poles.size != n:
        raise RuntimeError(f'place_poles: need exactly {n} poles')
    if method not in ('YT', 'KNV0'):
        raise RuntimeError(f'place_poles: unknown method {method!r}')
    m = b.shape[1]

    if m == 1:
        k = _ackermann(a, b, poles)
        nb_iter = 0
        x = None
    else:
        groups = _pair_structure(poles)
        # null-space bases of [A - p I | B]: states x with (A - pI)x in
        # range(B) -> closed-loop eigenvector candidates
        bases = []
        for p, _ in groups:
            mat = np.hstack([a - p * np.eye(n), b.astype(complex)])
            _, s, vh = np.linalg.svd(mat)
            null = vh.conj().T[:, mat.shape[0]:]
            if null.shape[1] == 0:
                raise RuntimeError(
                    f'place_poles: no eigenvector freedom at pole {p}')
            bases.append(null[:n, :])  # state part of the null space
        # initial choice + KNV0-style sweeps: repeatedly re-pick each
        # eigenvector as the basis vector best conditioned against the
        # span of the others
        def expand(cols):
            full = []
            for (p, cplx), v in zip(groups, cols):
                if cplx:
                    full.append(v)
                    full.append(np.conj(v))
                else:
                    full.append(v.real + 0j)
            return np.stack(full, axis=1)

        cols = [bs[:, 0] for bs in bases]
        nb_iter = 0
        for _ in range(maxiter):
            nb_iter += 1
            changed = False
            for i, bs in enumerate(bases):
                others = expand([c for j, c in enumerate(cols) if j != i])
                q, _ = np.linalg.qr(others, mode='reduced')
                # component of each basis direction orthogonal to the
                # other eigenvectors: pick the direction maximizing it
                proj = bs - q @ (q.conj().T @ bs)
                norms = np.linalg.norm(proj, axis=0) \
                    / np.maximum(np.linalg.norm(bs, axis=0), 1e-300)
                best = int(np.argmax(norms))
                cand = bs[:, best]
                if np.linalg.norm(cand - cols[i]) > 1e-12:
                    cols[i] = cand
                    changed = True
            if not changed:
                break
        x = expand(cols)
        if np.linalg.cond(x) > 1e12:
            raise RuntimeError(
                'place_poles: could not find independent eigenvectors '
                '(poles too constrained for this B)')
        lam = []
        for (p, cplx) in groups:
            lam.append(p)
            if cplx:
                lam.append(np.conj(p))
        lam = np.asarray(lam)
        # (A - B K) X = X L  ->  K X = B^+ (A X - X L)
        rhs = a @ x - x * lam[None, :]
        u = np.linalg.lstsq(b, rhs, rcond=None)[0]
        k = np.real(u @ np.linalg.inv(x))

    computed = np.sort_complex(np.linalg.eigvals(a - b @ k))
    return _Bunch(
        gain_matrix=np.real(k),
        computed_poles=computed,
        requested_poles=poles,
        X=x,
        rtol=rtol,
        nb_iter=nb_iter,
    )
