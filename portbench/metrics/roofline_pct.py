"""roofline_pct: the call's bytes (each public op's arguments read once and results written
once) at the card's peak bandwidth, over all the device time a call in the traced window,
in %. It cannot pass 100: a reading above it counts the bytes too high or the time short."""

from portbench import trace


def read(record):
    tr = record['trace']
    peak = record.get('peak_bytes_per_s')
    if tr is None or not tr['device'] or not tr['calls'] or not peak:
        return None
    per_call_s = trace.device_ns(tr) / 1e9 / tr['calls']
    return 100 * record['bytes_needed'] / peak / per_call_s
