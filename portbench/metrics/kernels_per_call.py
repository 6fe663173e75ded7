"""kernels_per_call: the kernels, copies and memsets of the traced
window over its calls: the launch path's load."""
SPANS = {}


def read(t):
    return t.device_ops / t.calls if t.device_ops else None
