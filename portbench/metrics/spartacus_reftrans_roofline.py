"""spartacus_reftrans_roofline: the least time of the spartacus_reftrans
spans' work (kernels B6 and B7), counted at their call boundary
(roofline.py), over its device time, in %. The operations leave out the
3D cells' doubling steps, so the least time is a floor."""
from portbench.spans import pick

SPANS = pick("spartacus_reftrans")


def read(t):
    least = t.least_s("spartacus_reftrans")
    device = t.device_s("spartacus_reftrans")
    if least is None or device <= 0:
        return None
    return 100.0 * least / device
