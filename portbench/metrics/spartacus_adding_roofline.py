"""spartacus_adding_roofline: the least time of the spartacus_adding
spans' work (kernels B8 and B9), counted at their call boundary
(roofline.py), over its device time, in %."""
from portbench.spans import pick

SPANS = pick("spartacus_adding")


def read(t):
    least = t.least_s("spartacus_adding")
    device = t.device_s("spartacus_adding")
    if least is None or device <= 0:
        return None
    return 100.0 * least / device
