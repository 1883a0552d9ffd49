"""Peak detection: find_peaks / peak_prominences / peak_widths /
argrelextrema (scipy.signal semantics).

Peak lists are variable-length INDEX sets — data-dependent output shapes
that a captured CUDA graph cannot hold and that callers consume
host-side anyway (annotations, event lists). So unlike the
spectral estimators, this family runs on the host over downloaded data:
one device->host transfer of the (already reduced) signal, then exact
scipy-semantics selection in f64 numpy. Tensor inputs download
automatically; array-likes pass straight through.

scipy.signal is the executable spec: condition evaluation order
(plateau -> height -> threshold -> distance -> prominence -> width),
the highest-priority-first distance pruning, prominence base
conventions, and interpolated width crossings all follow scipy's
documented behavior and are oracle-tested against it
(dsc_tpu/models/peaks.py, the same NumPy code). Inside ``dsc.compile``
the download raises, as every ``Tensor.numpy()`` there does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..tensor import Tensor


def _as_host_1d(x, who: str) -> np.ndarray:
    if isinstance(x, Tensor):
        if x.n_dim != 1:
            raise RuntimeError(f'{who}: expected a 1-D signal, got {x.n_dim}-D')
        if x.dtype.is_complex:
            raise RuntimeError(f'{who}: expected a real signal')
        return np.asarray(x.numpy(), np.float64)
    arr = np.asarray(x, np.float64)
    if arr.ndim != 1:
        raise RuntimeError(f'{who}: expected a 1-D signal, got {arr.ndim}-D')
    return arr


def _local_maxima(x: np.ndarray):
    """(midpoints, left_edges, right_edges) of all strict local maxima,
    plateaus collapsing to their midpoint (scipy _local_maxima_1d)."""
    d = np.diff(x)
    nz = np.flatnonzero(d != 0.0)
    if nz.size < 2:
        e = np.array([], np.intp)
        return e, e.copy(), e.copy()
    sign = np.sign(d[nz])
    peak_at = np.flatnonzero((sign[:-1] > 0) & (sign[1:] < 0))
    left = nz[peak_at] + 1
    right = nz[peak_at + 1]
    mid = (left + right) // 2
    return mid.astype(np.intp), left.astype(np.intp), right.astype(np.intp)


def peak_prominences(x, peaks, wlen: Optional[int] = None):
    """Prominence of each peak (scipy.signal.peak_prominences): height
    above the higher of the two key saddles, bases at the interval
    minima. Returns (prominences, left_bases, right_bases)."""
    x = _as_host_1d(x, 'peak_prominences')
    peaks = np.asarray(peaks, np.intp)
    if peaks.ndim != 1:
        raise RuntimeError('peak_prominences: peaks must be 1-D indices')
    if peaks.size and (peaks.min() < 0 or peaks.max() >= x.size):
        raise RuntimeError('peak_prominences: peak index out of range')
    if wlen is not None and wlen < 3:
        raise RuntimeError(f'peak_prominences: wlen ({wlen}) must be >= 3')
    n = x.size
    prom = np.empty(peaks.size)
    lbase = np.empty(peaks.size, np.intp)
    rbase = np.empty(peaks.size, np.intp)
    half = None if wlen is None else wlen // 2
    for j, p in enumerate(peaks):
        i_min = 0 if half is None else max(0, p - half)
        i_max = n - 1 if half is None else min(n - 1, p + half)
        # walk left while below the peak height, tracking the minimum
        lb, lmin = p, x[p]
        i = p
        while i > i_min and x[i - 1] <= x[p]:
            i -= 1
            if x[i] < lmin:
                lmin, lb = x[i], i
        rb, rmin = p, x[p]
        i = p
        while i < i_max and x[i + 1] <= x[p]:
            i += 1
            if x[i] < rmin:
                rmin, rb = x[i], i
        prom[j] = x[p] - max(lmin, rmin)
        lbase[j] = lb
        rbase[j] = rb
    return prom, lbase, rbase


def peak_widths(x, peaks, rel_height: float = 0.5,
                prominence_data=None, wlen: Optional[int] = None):
    """Width of each peak at ``rel_height`` of its prominence
    (scipy.signal.peak_widths): linear-interpolated crossings bounded by
    the prominence bases. Returns (widths, width_heights, left_ips,
    right_ips)."""
    x = _as_host_1d(x, 'peak_widths')
    peaks = np.asarray(peaks, np.intp)
    if rel_height < 0:
        raise RuntimeError('peak_widths: rel_height must be >= 0')
    if prominence_data is None:
        prominence_data = peak_prominences(x, peaks, wlen)
    prom, lbase, rbase = prominence_data
    widths = np.empty(peaks.size)
    heights = np.empty(peaks.size)
    lips = np.empty(peaks.size)
    rips = np.empty(peaks.size)
    for j, p in enumerate(peaks):
        h = x[p] - prom[j] * rel_height
        heights[j] = h
        # walk left from the peak to the first sample below h
        i = p
        while i > lbase[j] and x[i] > h:
            i -= 1
        lip = float(i)
        if x[i] < h:
            lip = i + (h - x[i]) / (x[i + 1] - x[i])
        # walk right
        i = p
        while i < rbase[j] and x[i] > h:
            i += 1
        rip = float(i)
        if x[i] < h:
            rip = i - (h - x[i]) / (x[i - 1] - x[i])
        widths[j] = rip - lip
        lips[j] = lip
        rips[j] = rip
    return widths, heights, lips, rips


def _interval(value, n_peaks: int, who: str):
    """Normalize a scipy interval spec: scalar/None -> (min, max) arrays
    broadcast per peak."""
    if value is None:
        return None, None
    if isinstance(value, (tuple, list)) and len(value) == 2:
        lo, hi = value
    else:
        lo, hi = value, None
    lo = None if lo is None else np.broadcast_to(
        np.asarray(lo, np.float64), (n_peaks,))
    hi = None if hi is None else np.broadcast_to(
        np.asarray(hi, np.float64), (n_peaks,))
    return lo, hi


def _select_interval(values, lo, hi):
    keep = np.ones(values.size, bool)
    if lo is not None:
        keep &= lo <= values
    if hi is not None:
        keep &= values <= hi
    return keep


def _select_by_distance(peaks, priority, distance):
    """Greedy highest-priority-first pruning: remove peaks closer than
    ``distance`` to an already-kept higher-priority peak
    (scipy _select_by_peak_distance)."""
    keep = np.ones(peaks.size, bool)
    order = np.argsort(priority)  # ascending; iterate from highest
    for j in order[::-1]:
        if not keep[j]:
            continue
        k = j - 1
        while k >= 0 and peaks[j] - peaks[k] < distance:
            keep[k] = False
            k -= 1
        k = j + 1
        while k < peaks.size and peaks[k] - peaks[j] < distance:
            keep[k] = False
            k += 1
    return keep


def find_peaks(x, height=None, threshold=None, distance=None,
               prominence=None, width=None, wlen: Optional[int] = None,
               rel_height: float = 0.5, plateau_size=None):
    """Local maxima subject to the scipy.signal.find_peaks conditions.
    ``x``: Tensor or 1-D array-like. Returns ``(peaks, properties)``
    with scipy's property keys for every requested condition; condition
    evaluation order (plateau -> height -> threshold -> distance ->
    prominence -> width) matches scipy, which matters because distance
    pruning sees only the peaks that survived the cheaper checks."""
    x = _as_host_1d(x, 'find_peaks')
    if distance is not None and distance < 1:
        raise RuntimeError('find_peaks: distance must be >= 1')
    peaks, ledges, redges = _local_maxima(x)
    props = {}

    if plateau_size is not None:
        lo, hi = _interval(plateau_size, peaks.size, 'plateau_size')
        sizes = (redges - ledges + 1).astype(np.float64)
        keep = _select_interval(sizes, lo, hi)
        peaks, ledges, redges = peaks[keep], ledges[keep], redges[keep]
        props['plateau_sizes'] = (redges - ledges + 1).astype(np.intp)
        props['left_edges'] = ledges
        props['right_edges'] = redges

    if height is not None:
        lo, hi = _interval(height, peaks.size, 'height')
        keep = _select_interval(x[peaks], lo, hi)
        peaks = peaks[keep]
        for k in ('plateau_sizes', 'left_edges', 'right_edges'):
            if k in props:
                props[k] = props[k][keep]
        props['peak_heights'] = x[peaks]

    if threshold is not None:
        lo, hi = _interval(threshold, peaks.size, 'threshold')
        lt = x[peaks] - x[peaks - 1]
        rt = x[peaks] - x[peaks + 1]
        keep = np.ones(peaks.size, bool)
        if lo is not None:
            keep &= (lo <= lt) & (lo <= rt)
        if hi is not None:
            keep &= (lt <= hi) & (rt <= hi)
        for k in list(props):
            props[k] = props[k][keep]
        peaks, lt, rt = peaks[keep], lt[keep], rt[keep]
        props['left_thresholds'] = lt
        props['right_thresholds'] = rt

    if distance is not None:
        keep = _select_by_distance(peaks, x[peaks], distance)
        peaks = peaks[keep]
        for k in list(props):
            props[k] = props[k][keep]

    if prominence is not None or width is not None:
        wdata = peak_prominences(x, peaks, wlen)
        props['prominences'], props['left_bases'], props['right_bases'] \
            = wdata
    if prominence is not None:
        lo, hi = _interval(prominence, peaks.size, 'prominence')
        keep = _select_interval(props['prominences'], lo, hi)
        peaks = peaks[keep]
        for k in list(props):
            props[k] = props[k][keep]
    if width is not None:
        wdata = (props['prominences'], props['left_bases'],
                 props['right_bases'])
        widths, wh, lips, rips = peak_widths(x, peaks, rel_height, wdata)
        lo, hi = _interval(width, peaks.size, 'width')
        keep = _select_interval(widths, lo, hi)
        peaks = peaks[keep]
        for k in list(props):
            props[k] = props[k][keep]
        props['widths'] = widths[keep]
        props['width_heights'] = wh[keep]
        props['left_ips'] = lips[keep]
        props['right_ips'] = rips[keep]

    return peaks, props


def argrelextrema(x, comparator, order: int = 1, mode: str = 'clip'):
    """Indices of relative extrema under ``comparator`` over +-order
    neighbors (scipy.signal.argrelextrema for 1-D)."""
    x = _as_host_1d(x, 'argrelextrema')
    if order < 1:
        raise RuntimeError('argrelextrema: order must be >= 1')
    if mode not in ('clip', 'wrap'):
        raise RuntimeError(f'argrelextrema: unknown mode {mode!r}')
    n = x.size
    idx = np.arange(n)
    keep = np.ones(n, bool)
    for shift in range(1, order + 1):
        if mode == 'clip':
            plus = np.clip(idx + shift, 0, n - 1)
            minus = np.clip(idx - shift, 0, n - 1)
        else:
            plus = (idx + shift) % n
            minus = (idx - shift) % n
        keep &= comparator(x, x[plus])
        keep &= comparator(x, x[minus])
    return (np.flatnonzero(keep),)


def argrelmax(x, order: int = 1, mode: str = 'clip'):
    """Indices of relative maxima (scipy.signal.argrelmax, 1-D)."""
    return argrelextrema(x, np.greater, order, mode)


def argrelmin(x, order: int = 1, mode: str = 'clip'):
    """Indices of relative minima (scipy.signal.argrelmin, 1-D)."""
    return argrelextrema(x, np.less, order, mode)
