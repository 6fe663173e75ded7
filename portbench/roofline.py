"""The chip's peaks and the work of a layer, counted at its call boundary.

A layer's least time is max(bytes / peak bandwidth, operations / peak
float32 rate): each input tensor it is handed (the device tables it
reads included) read once, each output tensor written once, and the
operations its algorithm needs per output value. Counting at the call
boundary, from the call's own tensors, gives the same work whatever
implements the layer: a CUDA kernel, plain PyTorch passes or a future
fused kernel. The arithmetic is chip_smoke.py's `least_time`; the
operations per value are its OPS_PER_VALUE for the kernels' work
(exp, sqrt and division count one each) and counts of the plain
formulas of solvers/two_stream.py for the rest.
"""
from __future__ import annotations

import dataclasses

import torch

#: NVIDIA H100 SXM, published: HBM3 bandwidth and the float32 rate
#: outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def tensors(obj):
    """The tensors in obj: a tensor, or tuples, lists, dicts and
    dataclasses of them, each storage once. Walked with a stack and not a
    recursive closure, whose reference cycle would keep every tensor it
    saw alive until the garbage collector's next pass."""
    seen, out, stack = set(), [], [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            key = (x.data_ptr(), x.numel(), x.dtype)
            if key not in seen:
                seen.add(key)
                out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name)
                         for f in reversed(dataclasses.fields(x)))
    return out


def boundary_bytes(args, kwargs, out) -> int:
    """Bytes of every tensor handed in or returned, each once."""
    return sum(t.numel() * t.element_size()
               for t in tensors((args, kwargs, out)))


def least_time_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def _numel(out) -> int:
    return sum(t.numel() for t in tensors(out))


def _per_output(n):
    return lambda args, out: n * _numel(out)


def _per_cell(n):
    """n per element of the first argument: (level, g, column) for the
    adding sweeps, (level, region, g, column) for the region sweeps."""
    return lambda args, out: n * args[0].numel()


def _gas_optics(args, out):
    """60 per LW (cell, g) and 30 per SW (cell, g): taumol's kernels;
    od_lw and od_sw are the first two outputs."""
    return 60 * out[0].numel() + 30 * out[1].numel()


#: operations of one call, by the "module:attribute" a span wraps
OPS = {
    "ecrad_tpu_torch.interface:gas_optics": _gas_optics,
    # layer optics: the Meador-Weaver forms of solvers/two_stream.py
    # (sw_reftrans 72 operations a cell over 5 outputs, lw_reftrans 56
    # over 4, the no-scattering form 23 over 3, the gammas 8 over 3 and
    # 6 over 2), B4 (120 a (cell, g) over 10 outputs, the LW form 40 over
    # 6) and the Tripleclouds region mix (21 a cloudy region over 3
    # outputs of 3 regions)
    "ecrad_tpu_torch.solvers.two_stream:sw_reftrans": _per_output(14),
    "ecrad_tpu_torch.solvers.two_stream:lw_reftrans": _per_output(14),
    "ecrad_tpu_torch.solvers.two_stream:lw_no_scattering_transmittance":
        _per_output(7),
    "ecrad_tpu_torch.solvers.two_stream:sw_gammas": _per_output(2),
    "ecrad_tpu_torch.solvers.two_stream:lw_gammas": _per_output(3),
    "ecrad_tpu_torch.solvers.mcica:sw_clear_total_reftrans": _per_output(12),
    "ecrad_tpu_torch.solvers.mcica:lw_clear_total_noscat": _per_output(6),
    "ecrad_tpu_torch.solvers.tripleclouds:_region_props_sw_g":
        _per_output(4),
    # sweeps: B3 sw_adding 40, lw_adding 25, lw_noscat 6 a (level, g,
    # column); B5 60 (SW) and 45 (LW) a (level, region, g, column)
    "ecrad_tpu_torch.solvers.mcica:adding_sw": _per_cell(40),
    "ecrad_tpu_torch.solvers.mcica:adding_lw": _per_cell(25),
    "ecrad_tpu_torch.solvers.mcica:lw_no_scattering_fluxes": _per_cell(6),
    "ecrad_tpu_torch.solvers.tripleclouds:adding_sw": _per_cell(40),
    "ecrad_tpu_torch.solvers.tripleclouds:adding_lw": _per_cell(25),
    "ecrad_tpu_torch.solvers.tripleclouds:lw_no_scattering_fluxes":
        _per_cell(6),
    "ecrad_tpu_torch.solvers.tripleclouds:tc_sw_sweeps": _per_cell(60),
    "ecrad_tpu_torch.solvers.tripleclouds:tc_lw_sweeps": _per_cell(45),
}


def call_work(target: str, args, kwargs, out):
    """(bytes, operations) of one call of `target`; operations None where
    the table has no count for it."""
    count = OPS.get(target)
    return (boundary_bytes(args, kwargs, out),
            None if count is None else float(count(args, out)))
