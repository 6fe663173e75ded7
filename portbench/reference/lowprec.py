"""The reference computed in bfloat16: the comparison's control.

The configurations state float32, and no stage of the path is a matrix
product (so TF32 never applies): the nearest precision below is
bfloat16. `bfloat16_rounding()` runs the float32 reference with the
float32 result of every PyTorch operation rounded to bfloat16, which is
bfloat16 arithmetic with each operation's own accumulation in float32,
as the hardware's bfloat16 units do it. Rounding operation by operation
keeps every operation of the path available (some have no bfloat16
kernel) and every index and mask in its own integer or boolean type.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if type(x) in (tuple, list):
        return type(x)(_round(y) for y in x)
    return x


class bfloat16_rounding(TorchFunctionMode):
    """Within this context every float32 result is rounded to bfloat16."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return _round(func(*args, **(kwargs or {})))
