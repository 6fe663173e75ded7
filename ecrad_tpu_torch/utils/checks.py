"""Physical-bounds checking of inputs and outputs.

Port of ecrad_tpu/utils/checks.py:17-111 (radiation_config.F90:1799-1977
out_of_physical_bounds, and the driver-level checks of
driver/ecrad_driver.F90:245-254, :337): the same bounds and the same
messages, word for word. The checks return findings rather than abort;
`clamp_inputs` is the driver's do_correct_unphysical_inputs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

# (min, max) per physical field
INPUT_BOUNDS = {
    "cos_sza": (-1.0, 1.0),
    "skin_temperature": (100.0, 400.0),
    "sw_albedo": (0.0, 1.0),
    "sw_albedo_direct": (0.0, 1.0),
    "lw_emissivity": (0.0, 1.0),
    "pressure_hl": (0.0, 120000.0),
    "temperature_hl": (100.0, 400.0),
    "mixing_ratio": (0.0, 1.0),        # gas MMR
    "q_liq": (0.0, 0.1),
    "q_ice": (0.0, 0.1),
    "re_liq": (1.0e-7, 1.0e-3),
    "re_ice": (1.0e-7, 1.0e-3),
    "fraction": (0.0, 1.0),
    "overlap_param": (-0.5, 1.0),
    "fractional_std": (0.0, 10.0),
    "inv_cloud_effective_size": (0.0, 1.0),
    "inv_inhom_effective_size": (0.0, 1.0),
    "aerosol mixing_ratio": (0.0, 0.01),
}

FLUX_BOUNDS = {
    "lw_up": (0.0, 900.0),
    "lw_dn": (0.0, 800.0),
    "sw_up": (0.0, 1600.0),
    "sw_dn": (0.0, 1600.0),
    "sw_dn_direct": (0.0, 1600.0),
    "cloud_cover_lw": (-1.0, 1.0),
    "cloud_cover_sw": (-1.0, 1.0),
}


def check_field(name: str, data, bounds=None) -> Optional[str]:
    """A description of the violation, or None."""
    if data is None:
        return None
    bounds = bounds or INPUT_BOUNDS.get(name)
    if bounds is None:
        return None
    arr = (data.detach().cpu().numpy() if isinstance(data, torch.Tensor)
           else np.asarray(data))
    if not np.isfinite(arr).all():
        return f"{name}: contains non-finite values"
    lo, hi = bounds
    amin, amax = arr.min(), arr.max()
    if amin < lo or amax > hi:
        return (f"{name}: range [{amin:.4g}, {amax:.4g}] outside "
                f"bounds [{lo:.4g}, {hi:.4g}]")
    return None


def validate_inputs(single_level, thermodynamics, gas, cloud=None,
                    aerosol=None) -> List[str]:
    """Every field of the inputs checked against INPUT_BOUNDS: the
    findings, in field order."""
    findings = []
    for obj in (single_level, thermodynamics, gas, cloud, aerosol):
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            msg = check_field(f.name, getattr(obj, f.name))
            if msg:
                findings.append(msg)
    return findings


def clamp_inputs(single_level, thermodynamics, gas, cloud=None,
                 aerosol=None):
    """The inputs with every bounded field clamped into its bounds
    (do_correct_unphysical_inputs)."""
    def clamp(obj):
        if obj is None:
            return None
        updates = {}
        for f in dataclasses.fields(obj):
            val, bounds = getattr(obj, f.name), INPUT_BOUNDS.get(f.name)
            if isinstance(val, torch.Tensor) and bounds is not None:
                updates[f.name] = torch.clamp(val, bounds[0], bounds[1])
        return obj.replace(**updates) if updates else obj

    return tuple(clamp(x) for x in (single_level, thermodynamics, gas,
                                    cloud, aerosol))


def validate_fluxes(flux) -> List[str]:
    """Post-run flux sanity (driver/ecrad_driver.F90:337)."""
    findings = []
    for fname, bounds in FLUX_BOUNDS.items():
        msg = check_field(fname, getattr(flux, fname, None), bounds)
        if msg:
            findings.append(msg)
    return findings
