"""layer_optics_roofline: the least time of the layer_optics spans' work,
counted at their call boundary (roofline.py), over its device time, in
%."""
from portbench.spans import pick

SPANS = pick("layer_optics")


def read(t):
    least, device = t.least_s("layer_optics"), t.device_s("layer_optics")
    if least is None or device <= 0:
        return None
    return 100.0 * least / device
