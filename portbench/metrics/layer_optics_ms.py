"""layer_optics_ms: device ms per call of the work launched inside the spans
of the layer optics (solvers/two_stream.py, McICA's kernel B4, the Tripleclouds SW region mix)."""
from portbench.spans import per_call_ms, pick

SPANS = pick("layer_optics")


def read(t):
    if not t.has("layer_optics"):
        return None
    return per_call_ms(t.device_s("layer_optics"), t)
