"""aerosol_ms: device ms per call of the work launched inside the spans
of the aerosol stage (optics/aerosol.py)."""
from portbench.spans import per_call_ms, pick

SPANS = pick("aerosol")


def read(t):
    if not t.has("aerosol"):
        return None
    return per_call_ms(t.device_s("aerosol"), t)
