"""regions_ms: device ms per call of the work launched inside the spans
of the Tripleclouds region fractions and overlap matrices."""
from portbench.spans import per_call_ms, pick

SPANS = pick("regions")


def read(t):
    if not t.has("regions"):
        return None
    return per_call_ms(t.device_s("regions"), t)
