"""sweeps_ms: device ms per call of the work launched inside the spans
of the adding sweeps (kernels B3, B3', and B5 for Tripleclouds)."""
from portbench.spans import per_call_ms, pick

SPANS = pick("sweeps")


def read(t):
    if not t.has("sweeps"):
        return None
    return per_call_ms(t.device_s("sweeps"), t)
