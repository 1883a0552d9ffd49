"""host_ms: the host's time in a call, from its entry to its return (the enqueue), in ms,
the mean over every call of the untraced window: the public API and its routing."""


def read(record):
    h = record['host_s']
    return 1e3 * sum(h) / len(h) if h else None
