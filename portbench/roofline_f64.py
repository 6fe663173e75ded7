"""The float64 cell's least times: roofline.py's, with the H100's FP64
rate in place of its float32 one.

A layer's least time in float64 is at least max(bytes / peak bandwidth,
operations / peak FP64 rate): roofline.py counts the bytes from the
call's tensors by their element size, so double operands count twice a
float's, and its operations per value, which do not change with the
precision. Its per-call least time takes the float32 rate; the FP64 rate
outside the tensor cores is half of it, so the float64 least time of a
label is max(that least time, its operations / F64_OPS_PER_S). A floor:
the maximum is taken over the window's sums and not call by call, and
exp, sqrt and division count one operation each though in double they
run as several on the FP64 pipe.
"""
from __future__ import annotations

from typing import Optional

#: NVIDIA H100 SXM, published: the FP64 rate outside the tensor cores
F64_OPS_PER_S = 34e12


def least_s(t, label: str) -> Optional[float]:
    """The label's float64 least time over the window, or None where a
    call's operations are not counted."""
    least, ops = t.least_s(label), t.operations(label)
    if least is None or ops is None:
        return None
    return max(least, ops / F64_OPS_PER_S)


def share(t, label: str) -> Optional[float]:
    """The label's float64 least time over its device time, in %; None
    where either is missing."""
    least, device = least_s(t, label), t.device_s(label)
    if least is None or device <= 0:
        return None
    return 100.0 * least / device
