"""step_mfu: the operations a call needs in gas optics, the layer optics
and the sweeps (counted at their call boundary in the traced calls,
roofline.py) over what the card's float32 peak does in the wall time of
an untraced call, in %: the whole call's share of the peak, which bounds
what removing any one kernel can gain."""
from portbench.roofline import F32_OPS_PER_S
from portbench.spans import pick

SPANS = pick("gas_optics", "layer_optics", "sweeps")


def read(t):
    ops = [t.operations(k) for k in SPANS]
    call_s = t.host_call_s()
    if any(x is None for x in ops) or not t.device_ops or not call_s:
        return None
    return 100.0 * sum(ops) / t.calls / (F32_OPS_PER_S * call_s)
