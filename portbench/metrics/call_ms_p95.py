"""call_ms_p95: the 95th percentile of the latency of every call in the window, in ms (from
the start of a call's issue to the moment the host sees its event complete). It needs ten
calls beyond the percentile, 200 in all."""

import statistics


def read(record):
    lat = record['latency_s']
    if len(lat) < 200:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[-1]
