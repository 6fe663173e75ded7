"""entry_other_ms: device ms per call launched inside the call but outside
gas optics, the aerosol stage, the cloud stage and the solvers: the
entry's casts, albedos and flux assembly (interface.py)."""
from portbench.spans import ENTRY, per_call_ms

SPANS = ENTRY


def read(t):
    whole = t.device_s("call")
    if whole <= 0:
        return None
    return per_call_ms(whole - sum(t.device_s(k) for k in SPANS), t)
