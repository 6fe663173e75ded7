"""f64_gas_optics_roofline: the least time of the gas_optics spans'
work at the H100's FP64 rate, max(bytes / 3.35 TB/s, operations / 34
TFLOP/s), counted at their call boundary (roofline.py, roofline_f64.py),
over its device time, in %: the float64 cell's gas optics share. The least
time is a floor of the float64 one (roofline_f64.py), so the share is
one too."""
from portbench.roofline_f64 import share
from portbench.spans import pick

SPANS = pick("gas_optics")


def read(t):
    return share(t, "gas_optics")
