"""The comparison that decides `correct`.

Every output field of a checked call is held to the plain reference's
field for the same batch, computed in float64:

- flux_max: the widest gap over every flux value, W m-2 (the broadband
  profiles, clear and total sky, SW direct, the surface fluxes per g and
  per band);
- flux_mean: the mean gap over the broadband profile values, W m-2;
- column_lw, column_sw: the widest mean gap of one column's LW (SW)
  broadband profile, over its half-levels, W m-2: at many columns a
  call, flux_mean dilutes one wrong column, and flux_max has to leave
  room for the SW resonance guard's rare gaps (PERF.md, section 7),
  which the LW does not have;
- cover_max: the widest gap of the total cloud covers (LW and SW);
- deriv_max: the widest gap of the LW derivatives, where the
  configuration asks for them.

- nonfinite: the count of output values that are not finite (limit 0).

The gaps are taken over the finite values, so that a run whose output
holds a NaN or an infinity still reads its other numbers. Each number
has a limit of its own, in limits/<cell>.json. A field the reference has
and the program lacks, or the other way round, fails the call.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

PROFILES = ("lw_up", "lw_dn", "lw_up_clear", "lw_dn_clear", "sw_up", "sw_dn",
            "sw_dn_direct", "sw_up_clear", "sw_dn_clear", "sw_dn_direct_clear")
COVERS = ("cloud_cover_lw", "cloud_cover_sw")
DERIVATIVES = ("lw_derivatives",)
#: what a number reads where it is not finite
NOT_FINITE = 1e300


def numbers(program: Dict[str, torch.Tensor],
            reference: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The compared numbers of one call; a missing or extra field reads as
    NOT_FINITE in every number."""
    if set(program) != set(reference):
        keys = ["flux_max", "flux_mean", "column_lw", "column_sw",
                "cover_max"]
        if "lw_derivatives" in reference:
            keys.append("deriv_max")
        return dict.fromkeys(keys + ["nonfinite"], NOT_FINITE)
    gap = {k: (program[k].to(reference[k]) - reference[k]).abs()
           for k in reference}
    finite = {k: torch.isfinite(g) for k, g in gap.items()}

    def values(keys: Iterable[str]) -> torch.Tensor:
        return torch.cat([gap[k][finite[k]] for k in keys])

    def widest(keys: Iterable[str]) -> float:
        v = values(keys)
        return _finite(v.max()) if v.numel() else NOT_FINITE

    fluxes = [k for k in gap if k not in COVERS + DERIVATIVES]
    profiles = values(PROFILES)
    out = {"flux_max": widest(fluxes),
           "flux_mean": (_finite(profiles.mean()) if profiles.numel()
                         else NOT_FINITE),
           "column_lw": _column_max([k for k in PROFILES
                                     if k.startswith("lw")], gap, finite),
           "column_sw": _column_max([k for k in PROFILES
                                     if k.startswith("sw")], gap, finite),
           "cover_max": widest(COVERS)}
    if "lw_derivatives" in gap:
        out["deriv_max"] = widest(DERIVATIVES)
    out["nonfinite"] = float(sum(int((~f).sum()) for f in finite.values()))
    return out


def _column_max(keys, gap, finite) -> float:
    """The widest of each column's mean gap over its finite half-levels
    (columns on the first axis), over the profile fields `keys`."""
    best = 0.0
    for k in keys:
        if k not in gap:
            return NOT_FINITE
        n = finite[k].sum(1)
        total = torch.where(finite[k], gap[k], 0).sum(1)
        mean = total[n > 0] / n[n > 0]
        if mean.numel():
            best = max(best, _finite(mean.max()))
    return best


def widest_gap(program: Dict[str, torch.Tensor],
               reference: Dict[str, torch.Tensor]) -> str:
    """Where the widest flux gap lies: field, column and level (or
    g-point or band), with both values; a note for the run's log."""
    best = None
    for k in reference:
        if k in COVERS + DERIVATIVES or k not in program:
            continue
        gap = (program[k].to(reference[k]) - reference[k]).abs()
        i = int(torch.nan_to_num(gap, nan=float("inf")).argmax())
        if best is None or not gap.flatten()[i] <= best[0]:
            best = (float(gap.flatten()[i]), k, i)
    if best is None:
        return "no flux field"
    _, k, i = best
    idx = tuple(int(x) for x in torch.unravel_index(
        torch.tensor(i), reference[k].shape))
    return (f"{k}{list(idx)}: program {float(program[k].flatten()[i])!r}, "
            f"reference {float(reference[k].flatten()[i])!r}")


def _finite(x: torch.Tensor) -> float:
    v = float(x)
    return v if math.isfinite(v) else NOT_FINITE


def worst(per_call: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over the checked calls."""
    out: Dict[str, float] = {}
    for nums in per_call:
        for k, v in nums.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def failures(nums: Dict[str, float], limits: Dict[str, float]) -> list:
    """The numbers above their limits; a number without a limit is an
    error of the benchmark."""
    missing = set(nums) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return [k for k, v in nums.items() if not v <= limits[k]]
