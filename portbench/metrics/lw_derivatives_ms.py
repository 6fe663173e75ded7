"""lw_derivatives_ms: device ms per call of the work launched inside the spans
of the LW derivatives (solvers/lw_derivatives.py)."""
from portbench.spans import per_call_ms, pick

SPANS = pick("lw_derivatives")


def read(t):
    if not t.has("lw_derivatives"):
        return None
    return per_call_ms(t.device_s("lw_derivatives"), t)
