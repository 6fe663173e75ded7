"""Cloudless (clear-sky) solvers.

Port of ecrad_tpu/solvers/cloudless.py:43-90 (radiation_cloudless_sw.F90:
27, radiation_cloudless_lw.F90:24): gas and aerosol optics only. LW takes
the adding method with scattering when aerosols scatter (kernel B3' on
the GPU) and the no-scattering path otherwise (B3); SW the two-stream
reflectance/transmittance and one adding pass (B3), with columns whose sun
is below the horizon set to zero. Inputs arrive (ncol, nlev, ng) and are
transposed once to the g-first (nlev, ng, ncol) layout; fluxes are
returned g-first, (nlev+1, ng, ncol).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import two_stream as ts
from .adding import adding_lw, adding_sw, lw_no_scattering_fluxes


class LwFluxes(NamedTuple):
    up: torch.Tensor          # (nlev+1, ng, ncol)
    dn: torch.Tensor


class SwFluxes(NamedTuple):
    up: torch.Tensor          # (nlev+1, ng, ncol)
    dn_diffuse: torch.Tensor
    dn_direct: torch.Tensor


def _gf(x):
    """(ncol, nlev, ng) -> contiguous (nlev, ng, ncol)."""
    return x.permute(1, 2, 0).contiguous()


def solver_cloudless_lw(od, ssa, g, planck_hl, emission, albedo,
                        do_scattering: bool, want_trans: bool = False):
    """od/ssa/g (ncol, nlev, ng); planck_hl (ncol, nlev+1, ng); emission
    and albedo (ncol, ng). With want_trans also returns the layer
    transmittance, g-first (for the ICA LW derivatives,
    radiation_cloudless_lw.F90:169)."""
    planck_g = _gf(planck_hl)
    planck_top, planck_bot = planck_g[:-1], planck_g[1:]
    emis_g, alb_g = emission.T.contiguous(), albedo.T.contiguous()
    if do_scattering:
        ref, trans, src_up, src_dn = ts.lw_reftrans(
            _gf(od), *ts.lw_gammas(_gf(ssa), _gf(g)), planck_top,
            planck_bot)
        up, dn = adding_lw(ref, trans, src_up, src_dn, emis_g, alb_g)
    else:
        trans, src_up, src_dn = ts.lw_no_scattering_transmittance(
            _gf(od), planck_top, planck_bot)
        up, dn = lw_no_scattering_fluxes(trans, src_up, src_dn, emis_g,
                                         alb_g)
    if want_trans:
        return LwFluxes(up=up, dn=dn), trans
    return LwFluxes(up=up, dn=dn)


def solver_cloudless_sw(od, ssa, g, incoming_toa, cos_sza, albedo_diffuse,
                        albedo_direct) -> SwFluxes:
    """od/ssa/g (ncol, nlev, ng); incoming_toa and albedos (ncol, ng);
    cos_sza (ncol,)."""
    mu0_col = torch.clamp(cos_sza, min=1e-10)
    mu0 = mu0_col[None, :]
    od_g, ssa_g = _gf(od), _gf(ssa)
    gamma1, gamma2, gamma3 = ts.sw_gammas(mu0, ssa_g, _gf(g))
    ref, trans, ref_dir, trans_dir_diff, trans_dir_dir = ts.sw_reftrans(
        mu0, od_g, ssa_g, gamma1, gamma2, gamma3)
    up, dn_diff, dn_dir = adding_sw(
        ref, trans, ref_dir, trans_dir_diff, trans_dir_dir,
        incoming_toa.T.contiguous(), albedo_diffuse.T.contiguous(),
        albedo_direct.T.contiguous(), mu0_col.contiguous())
    return daylight(cos_sza, SwFluxes(up, dn_diff, dn_dir))


def daylight(cos_sza, fluxes: SwFluxes) -> SwFluxes:
    """Zero the columns with the sun below the horizon."""
    day = (cos_sza > 0.0)[None, None, :]
    zero = torch.zeros((), dtype=fluxes.up.dtype, device=fluxes.up.device)
    return SwFluxes(*(torch.where(day, f, zero) for f in fluxes))
