"""The traced window's record, and the reductions the per-layer readers share.

``collect`` turns a torch.profiler run into plain tuples:

- ``device``: (name, start_ns, end_ns, correlation id, linked correlation id) of every
  kernel, copy and set on the card; the card-side copies of the harness's own spans are left
  out;
- ``host``: (name, start_ns, end_ns, correlation id, runtime) of every host event: the
  harness's spans (``portbench.<op>``), PyTorch's operators and the CUDA runtime's and
  driver's calls (``runtime`` true: a name ``cuda...`` or ``cu<Upper>...``).

A device event's correlation id is the CUDA runtime call's that launched it; its linked id is
the PyTorch operator's, where one launched it.

Timestamps of both sides are on the profiler's one clock.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SPAN = 'portbench.'
# the device work of PyTorch's own operators: ATen's kernels, cuBLAS / cuBLASLt (and the
# CUTLASS kernels they run), copies and sets
TORCH_MARKS = ('at::native', 'at_cuda_detail', 'cublas', 'cutlass', 'gemm', 'gemv')
TORCH_PREFIXES = ('Memcpy', 'Memset')
RUNTIME = re.compile(r'cuda|cu[A-Z]')


def collect(prof) -> Dict[str, list]:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(SPAN):
                continue
            device.append((name, start, end, e.correlation_id(), e.linked_correlation_id()))
        elif not e.is_async():
            host.append((name, start, end, e.correlation_id(), bool(RUNTIME.match(name))))
    device.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return {'device': device, 'host': host}


def is_torch_op(name: str) -> bool:
    return name.startswith(TORCH_PREFIXES) or any(m in name for m in TORCH_MARKS)


def window(tr) -> Optional[Tuple[int, int]]:
    """From the first call's issue to the end of the last device or host event of a call;
    where no span was recorded, from the first device event's start to the last's end."""
    calls = [h for h in tr['host'] if h[0] == SPAN + 'call']
    if not calls:
        if not tr['device']:
            return None
        return tr['device'][0][1], max(d[2] for d in tr['device'])
    lo = calls[0][1]
    hi = max([calls[-1][2]] + [h[2] for h in tr['host'] if h[0] == SPAN + 'wait']
             + [d[2] for d in tr['device']])
    return lo, hi


def busy(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of ``intervals`` inside [lo, hi], as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(tr) -> Optional[Tuple[int, int]]:
    """(ns in which some operation ran on the device, ns of the window)."""
    win = window(tr)
    if win is None or not tr['device']:
        return None
    union = busy([(d[1], d[2]) for d in tr['device']], *win)
    return sum(e - s for s, e in union), win[1] - win[0]


def device_ns(tr, pred=lambda name: True) -> int:
    return sum(d[2] - d[1] for d in tr['device'] if pred(d[0]))


class _Open:
    """Which host event is open at a time: of properly nested events sorted by start, the
    one that started last among those still open (looked for among the last ``depth``
    that started)."""

    def __init__(self, events, depth: int = 256):
        self.events = events
        self.starts = [h[1] for h in events]
        self.depth = depth

    def innermost(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t)
        for h in reversed(self.events[max(0, i - self.depth):i]):
            if h[2] >= t:
                return h[0]
        return None


def by_span(tr) -> Dict[str, int]:
    """Device ns by the harness's innermost span open at the launch of each operation: the
    CUDA runtime call with the device event's correlation id, else the PyTorch operator with
    its linked id."""
    spans = [h for h in tr['host'] if h[0].startswith(SPAN) and h[0] != SPAN + 'call']
    runtime_at = {h[3]: h[1] for h in tr['host'] if h[4]}
    op_at = {h[3]: h[1] for h in tr['host'] if not h[4]}
    open_span = _Open(spans)
    out: Dict[str, int] = defaultdict(int)
    for name, s, e, corr, linked in tr['device']:
        t = runtime_at.get(corr, op_at.get(linked))
        span = None if t is None else open_span.innermost(t)
        out[span[len(SPAN):] if span else 'unattributed'] += e - s
    return dict(out)


def top(pairs: Dict[str, float], k: int = 10) -> List[list]:
    return [[name, v] for name, v in sorted(pairs.items(), key=lambda p: -p[1])[:k]]


def breakdown(tr, spans, width: int = 160) -> Optional[dict]:
    """The device operations that took most time in the window ``tr``, and the device's idle
    gaps in the window ``spans``, which recorded the host too, by what the host was doing at
    each gap's middle (its innermost span and its innermost event there); in seconds."""
    if window(tr) is None or not tr['device']:
        return None
    ops: Dict[str, float] = defaultdict(float)
    for d in tr['device']:
        ops[d[0][:width]] += (d[2] - d[1]) / 1e9
    out = {'device_ops': top(ops)}
    win = window(spans)
    if win is None or not spans['device']:
        return out
    union = busy([(d[1], d[2]) for d in spans['device']], *win)
    edges = [win[0]] + [x for iv in union for x in iv] + [win[1]]
    open_span = _Open([h for h in spans['host'] if h[0].startswith(SPAN)])
    host = _Open(spans['host'])
    gaps: Dict[str, float] = defaultdict(float)
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        span = open_span.innermost(mid) or 'outside the loop'
        event = host.innermost(mid) or 'python'
        gaps[f'{span} / {event}'[:width]] += (e - s) / 1e9
    out['idle_gaps'] = top(gaps)
    return out
