"""idle_pct: the share of the traced window in which no kernel, copy or set ran on the card,
in %, from the union of the profiler's device intervals."""

from portbench import trace


def read(record):
    tr = record['trace']
    got = None if tr is None else trace.busy_ns(tr)
    if not got or not got[1]:
        return None
    return 100 * (1 - got[0] / got[1])
