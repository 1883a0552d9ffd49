"""device_ops: the operations a call ran on the card in the traced window (every kernel, copy
and set the profiler recorded, over the calls): the passes a call makes, which set its
device time more than its bytes do."""


def read(record):
    tr = record['trace']
    if tr is None or not tr['device'] or not tr['calls']:
        return None
    return len(tr['device']) / tr['calls']
