"""samples_per_s: input samples of every call in the window over the window's seconds, in
millions (the window closes when its last call completes)."""


def read(record):
    if not record['calls']:
        return None
    return record['calls'] * record['samples_per_call'] / record['window_s'] / 1e6
