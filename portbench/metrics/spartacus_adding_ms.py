"""spartacus_adding_ms: device ms per call of the work launched inside the
spans of SPARTACUS's adding sweeps (kernels B8 and B9,
ops/spartacus_adding.py)."""
from portbench.spans import per_call_ms, pick

SPANS = pick("spartacus_adding")


def read(t):
    if not t.has("spartacus_adding"):
        return None
    return per_call_ms(t.device_s("spartacus_adding"), t)
