"""spartacus_reftrans_ms: device ms per call of the work launched inside
the spans of SPARTACUS's per-layer reflectance and transmittance
matrices (kernels B6 and B7, ops/spartacus_reftrans.py)."""
from portbench.spans import per_call_ms, pick

SPANS = pick("spartacus_reftrans")


def read(t):
    if not t.has("spartacus_reftrans"):
        return None
    return per_call_ms(t.device_s("spartacus_reftrans"), t)
