"""Adding method for independent-column radiative transfer, g-first.

Port of the sequential forms of ecrad_tpu/solvers/adding.py:165-387
(radiation_adding_ica_sw.F90:24-147, radiation_adding_ica_lw.F90:32-131,
:272-324) as Python loops over levels. Layer quantities are (nlev, ng,
ncol), boundary values (ng, ncol), fluxes (nlev+1, ng, ncol), TOA first.
`adding_sw`, `lw_no_scattering_fluxes` and `adding_lw` run the plain
loops on CPU tensors and kernels B3/B3' (ops/adding_fused.py) on CUDA
tensors, float32 or float64.
"""
from __future__ import annotations

import torch

from ..ops import adding_fused
from ..utils import hooks


def adding_sw_plain(ref, trans, ref_dir, trans_dir_diff, trans_dir_dir,
                    incoming_toa, albedo_diffuse, albedo_direct, cos_sza):
    """The reference's three level loops. The direct flux is carried
    perpendicular to the sun and multiplied by cos_sza at the end.
    Returns (flux_up, flux_dn_diffuse, flux_dn_direct)."""
    nlev = ref.shape[0]
    cs = cos_sza[None, :]
    # 1) direct beam descent
    fdir = [incoming_toa]
    for l in range(nlev):
        fdir.append(trans_dir_dir[l] * fdir[l])
    # 2) albedo and source ascent
    albedo = [None] * nlev + [albedo_diffuse]
    source = [None] * nlev + [albedo_direct * fdir[nlev] * cs]
    inv_denom = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        r, t, alb_below = ref[l], trans[l], albedo[l + 1]
        inv_denom[l] = 1.0 / (1.0 - alb_below * r)
        albedo[l] = r + t * t * alb_below * inv_denom[l]
        source[l] = (ref_dir[l] * fdir[l]
                     + t * (source[l + 1]
                            + alb_below * trans_dir_diff[l] * fdir[l])
                     * inv_denom[l])
    # 3) diffuse descent
    fd = [torch.zeros_like(incoming_toa)]
    for l in range(nlev):
        fd.append((trans[l] * fd[l] + ref[l] * source[l + 1]
                   + trans_dir_diff[l] * fdir[l]) * inv_denom[l])
    flux_dn_diffuse = torch.stack(fd)
    flux_up = torch.stack(albedo) * flux_dn_diffuse + torch.stack(source)
    return flux_up, flux_dn_diffuse, torch.stack(fdir) * cs


def lw_no_scattering_fluxes_plain(trans, source_up, source_dn,
                                  emission_surf, albedo_surf):
    """Down sweep fd[l+1] = T fd[l] + Sd, surface fu = emission +
    albedo fd, up sweep fu[l] = T fu[l+1] + Su. Returns (flux_up,
    flux_dn)."""
    nlev = trans.shape[0]
    fd = [torch.zeros_like(emission_surf)]
    for l in range(nlev):
        fd.append(trans[l] * fd[l] + source_dn[l])
    fu = [None] * nlev + [emission_surf + albedo_surf * fd[nlev]]
    for l in range(nlev - 1, -1, -1):
        fu[l] = trans[l] * fu[l + 1] + source_up[l]
    return torch.stack(fu), torch.stack(fd)


def adding_lw_plain(ref, trans, source_up, source_dn, emission_surf,
                    albedo_surf):
    """LW adding with scattering: albedo/source ascent from the surface,
    then the flux descent. Returns (flux_up, flux_dn)."""
    nlev = ref.shape[0]
    albedo = [None] * nlev + [albedo_surf]
    source = [None] * nlev + [emission_surf]
    inv_denom = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        r, t, alb_below = ref[l], trans[l], albedo[l + 1]
        inv_denom[l] = 1.0 / (1.0 - alb_below * r)
        albedo[l] = r + t * t * alb_below * inv_denom[l]
        source[l] = (source_up[l] + t * (source[l + 1]
                                         + alb_below * source_dn[l])
                     * inv_denom[l])
    fd = [torch.zeros_like(emission_surf)]
    for l in range(nlev):
        fd.append((trans[l] * fd[l] + ref[l] * source[l + 1] + source_dn[l])
                  * inv_denom[l])
    flux_dn = torch.stack(fd)
    return torch.stack(albedo) * flux_dn + torch.stack(source), flux_dn


@hooks.hooked("ecrad.sweeps")
def adding_sw(*args):
    """SW adding: the plain loops on CPU tensors, kernel B3 on any
    other (CUDA float32 or float64; any other dtype raises)."""
    if args[0].device.type == "cpu":
        return adding_sw_plain(*args)
    return adding_fused.adding_sw_fused(*args)


@hooks.hooked("ecrad.sweeps")
def lw_no_scattering_fluxes(*args):
    """LW no-scattering fluxes: the plain loops on CPU tensors, kernel
    B3 on any other (CUDA float32 or float64; any other dtype raises)."""
    if args[0].device.type == "cpu":
        return lw_no_scattering_fluxes_plain(*args)
    return adding_fused.lw_noscat_fused(*args)


@hooks.hooked("ecrad.sweeps")
def adding_lw(*args):
    """LW adding with scattering: the plain loops on CPU tensors, kernel
    B3' on any other (CUDA float32 or float64; any other dtype
    raises)."""
    if args[0].device.type == "cpu":
        return adding_lw_plain(*args)
    return adding_fused.adding_lw_fused(*args)
