"""f64_spartacus_reftrans_roofline: the least time of the
spartacus_reftrans spans' work (the double forms of kernels B6 and B7),
max(bytes / 3.35 TB/s, operations / 34 TFLOP/s), counted at their call
boundary (roofline.py, roofline_f64.py), over its device time, in %: the
float64 cell's share. The operations leave out the doubling steps and
the least time is a floor of the float64 one, so the share is one too."""
from portbench.roofline_f64 import share
from portbench.spans import pick

SPANS = pick("spartacus_reftrans")


def read(t):
    return share(t, "spartacus_reftrans")
