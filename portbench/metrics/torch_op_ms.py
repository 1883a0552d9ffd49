"""torch_op_ms: device time a call of PyTorch's own operators (ATen's kernels, cuBLAS,
copies and sets) in the traced window, in ms: the plain compute around the port's kernels."""

from portbench import trace


def read(record):
    tr = record['trace']
    if tr is None or not tr['device'] or not tr['calls']:
        return None
    return trace.device_ns(tr, trace.is_torch_op) / 1e6 / tr['calls']
