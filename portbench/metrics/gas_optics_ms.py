"""gas_optics_ms: device ms per call of the work launched inside the spans
of gas optics (optics/rrtmg/, kernels B1 and B2)."""
from portbench.spans import per_call_ms, pick

SPANS = pick("gas_optics")


def read(t):
    if not t.has("gas_optics"):
        return None
    return per_call_ms(t.device_s("gas_optics"), t)
