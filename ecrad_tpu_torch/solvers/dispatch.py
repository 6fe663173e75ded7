"""Solver dispatch (radiation_interface.F90:384-455).

Port of ecrad_tpu/solvers/dispatch.py: the McICA, Homogeneous,
Tripleclouds and SPARTACUS branches, with the thermodynamics passed
through (SPARTACUS takes its layer depths from them). Every band map is
the spec's reordered one (the identity order unless the solver is
SPARTACUS). Returns (total_fluxes, clear_fluxes, extras) with extras the
diagnostics (cloud cover, LW derivatives).
"""
from __future__ import annotations

from ..config import Solver
from ..utils import hooks
from .homogeneous import solver_homogeneous_lw, solver_homogeneous_sw
from .mcica import solver_mcica_lw, solver_mcica_sw
from .spartacus_lw import solver_spartacus_lw
from .spartacus_sw import solver_spartacus_sw
from .tripleclouds import solver_tripleclouds_lw, solver_tripleclouds_sw


def _any_cloud(config, cloud, dtype):
    """Homogeneous cloud cover: 1 where any layer holds cloud."""
    return (cloud.fraction >= config.cloud_fraction_threshold).any(1).to(
        dtype)


@hooks.hooked("ecrad.solver_lw")
def solve_lw(setup, single_level, thermodynamics, cloud, cloud_props, od,
             ssa, g, planck_hl, emission, albedo):
    cfg = setup.config
    band = setup.spec.band_from_reordered_g_lw
    args = (cloud, od, ssa, g, *cloud_props[:3], planck_hl, emission,
            albedo)
    if cfg.i_solver_lw == Solver.MCICA:
        total, clear, tcc, extras = solver_mcica_lw(
            cfg, setup.pdf_sampler, band, single_level.iseed, *args,
            cheb=setup.pdf_cheb)
    elif cfg.i_solver_lw == Solver.HOMOGENEOUS:
        total, clear, extras = solver_homogeneous_lw(cfg, band, *args)
        tcc = _any_cloud(cfg, cloud, od.dtype)
    elif cfg.i_solver_lw == Solver.TRIPLECLOUDS:
        total, clear, tcc, extras = solver_tripleclouds_lw(cfg, band, *args)
    elif cfg.i_solver_lw == Solver.SPARTACUS:
        total, clear, tcc, extras = solver_spartacus_lw(
            cfg, band, thermodynamics, *args)
    else:
        raise ValueError(f"no cloudy LW solver {cfg.i_solver_lw!r}")
    return total, clear, {"cloud_cover_lw": tcc, **extras}


@hooks.hooked("ecrad.solver_sw")
def solve_sw(setup, single_level, thermodynamics, cloud, cloud_props, od,
             ssa, g, incoming_sw, albedo_diffuse, albedo_direct):
    cfg = setup.config
    band = setup.spec.band_from_reordered_g_sw
    props = (od, ssa, g, *cloud_props[3:], incoming_sw)
    albedos = (albedo_diffuse, albedo_direct)
    cos_sza = single_level.cos_sza
    extras = {}
    if cfg.i_solver_sw == Solver.MCICA:
        total, clear, tcc = solver_mcica_sw(
            cfg, setup.pdf_sampler, band, single_level.iseed, cos_sza, cloud,
            *props, *albedos, cheb=setup.pdf_cheb)
    elif cfg.i_solver_sw == Solver.HOMOGENEOUS:
        total, clear = solver_homogeneous_sw(cfg, band, cloud, *props,
                                             cos_sza, *albedos)
        tcc = _any_cloud(cfg, cloud, od.dtype)
    elif cfg.i_solver_sw == Solver.TRIPLECLOUDS:
        total, clear, tcc = solver_tripleclouds_sw(cfg, band, cloud, cos_sza,
                                                   *props, *albedos)
    elif cfg.i_solver_sw == Solver.SPARTACUS:
        total, clear, tcc, extras = solver_spartacus_sw(
            cfg, band, cos_sza, thermodynamics, cloud, *props, *albedos)
    else:
        raise ValueError(f"no cloudy SW solver {cfg.i_solver_sw!r}")
    return total, clear, {"cloud_cover_sw": tcc, **extras}
