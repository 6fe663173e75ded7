"""cloud_optics_ms: device ms per call of the work launched inside the spans
of the cloud stage (overlap parameter, cropping, optics/cloud.py)."""
from portbench.spans import per_call_ms, pick

SPANS = pick("cloud_optics")


def read(t):
    if not t.has("cloud_optics"):
        return None
    return per_call_ms(t.device_s("cloud_optics"), t)
