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
formulas of solvers/two_stream.py for the rest. SPARTACUS's kernels do
work that depends on the data (SPARTACUS_OPS): their counts are read
from the call's own masks after the window (a count returns a function
that Spans calls then), so that counting launches nothing inside it and
waits for nothing.
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


#: chip_smoke.py's SPARTACUS_OPS, for 3 regions: B6/B7 per fallback cell
#: and per 3D cell before its doubling steps (the steps are left out, so
#: the count is a floor); B8/B9 per (level, g, column) and per mixed
#: interface (the layer or the one above it cloudy)
SPARTACUS_OPS = {"sw_reftrans": (180, 3900), "lw_reftrans": (120, 2200),
                 "sw_adding": (600, 1200), "lw_adding": (420, 45)}


def _spartacus_reftrans(kind, od_at, use3d_at):
    """B6/B7's operations from the call's 3D mask use3d (level, g,
    column); None for other than 3 regions."""
    per_fallback, per_3d = SPARTACUS_OPS[kind]

    def count(args, out):
        if args[od_at].shape[1] != 3:
            return None
        use3d = args[use3d_at]
        return lambda: (use3d.numel() * per_fallback
                        + int(use3d.sum()) * (per_3d - per_fallback))
    return count


def _spartacus_sweeps(kind, hist_at, cols_at, clear_rows, rows3):
    """B8/B9's operations from the call's per-column rows: the rows of a
    layer's and of the layer above's clearness, `clear_rows`; None unless
    the history has the `rows3` rows of 3 regions."""
    per_cell, per_mix = SPARTACUS_OPS[kind]

    def count(args, out):
        hist, cols = args[hist_at], args[cols_at]
        if hist.shape[1] != rows3:
            return None
        ng = hist.shape[2]
        nlev, _, ncol = cols.shape

        def later():
            mixed = ~((cols[:, clear_rows[0]] > 0.5)
                      & (cols[:, clear_rows[1]] > 0.5))
            return ng * (nlev * ncol * per_cell + int(mixed.sum()) * per_mix)
        return later
    return count


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
    # SPARTACUS: B6 and B7 (their 3D mask the 8th and 11th argument), the
    # clear sky's B3 and B3', B8 and B9 (their column rows the 3rd and
    # 4th, SW rows 42/43 and LW rows 27/28 the layer's and the layer
    # above's clearness; 3 regions' histories 5 x 9 and 2 x 3 x 4 rows)
    "ecrad_tpu_torch.solvers.spartacus_sw:sw_reftrans_levels":
        _spartacus_reftrans("sw_reftrans", 1, 7),
    "ecrad_tpu_torch.solvers.spartacus_lw:lw_reftrans_levels":
        _spartacus_reftrans("lw_reftrans", 2, 10),
    "ecrad_tpu_torch.solvers.spartacus_sw:adding_sw": _per_cell(40),
    "ecrad_tpu_torch.solvers.spartacus_lw:adding_lw": _per_cell(25),
    "ecrad_tpu_torch.solvers.spartacus_lw:lw_no_scattering_fluxes":
        _per_cell(6),
    "ecrad_tpu_torch.solvers.spartacus_sw:sw_adding_sweeps":
        _spartacus_sweeps("sw_adding", 1, 2, (42, 43), 45),
    "ecrad_tpu_torch.solvers.spartacus_lw:lw_adding_sweeps":
        _spartacus_sweeps("lw_adding", 2, 3, (27, 28), 24),
}


def call_work(target: str, args, kwargs, out):
    """(bytes, operations) of one call of `target`; operations None where
    the table has no count for it, and a function that returns them where
    they are read from the call's tensors once the window has closed."""
    count = OPS.get(target)
    ops = None if count is None else count(args, out)
    return (boundary_bytes(args, kwargs, out),
            ops if ops is None or callable(ops) else float(ops))
