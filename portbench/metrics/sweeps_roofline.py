"""sweeps_roofline: the least time of the sweeps spans' work,
counted at their call boundary (roofline.py), over its device time, in
%."""
from portbench.spans import pick

SPANS = pick("sweeps")


def read(t):
    least, device = t.least_s("sweeps"), t.device_s("sweeps")
    if least is None or device <= 0:
        return None
    return 100.0 * least / device
