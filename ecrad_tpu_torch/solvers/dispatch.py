"""Solver dispatch (radiation_interface.F90:384-455).

Port of the McICA branches of ecrad_tpu/solvers/dispatch.py; the other
cloudy solvers raise NotImplementedError naming their ROADMAP slice
(config.check_supported already refuses them at setup). Returns
(total_fluxes, clear_fluxes, extras) with extras the diagnostics
(cloud cover, LW derivatives).
"""
from __future__ import annotations

from ..config import SOLVER_SLICE, Solver
from .mcica import solver_mcica_lw, solver_mcica_sw


def _refuse(solver):
    raise NotImplementedError(
        f"the {solver.name} solver is not ported yet (ROADMAP.md Queue A, "
        f"slice {SOLVER_SLICE.get(solver, '?')})")


def solve_lw(setup, single_level, cloud, cloud_props, od, ssa, g,
             planck_hl, emission, albedo):
    cfg = setup.config
    if cfg.i_solver_lw != Solver.MCICA:
        _refuse(cfg.i_solver_lw)
    total, clear, tcc, extras = solver_mcica_lw(
        cfg, setup.pdf_sampler, setup.spec.band_from_g_lw,
        single_level.iseed, cloud, od, ssa, g, *cloud_props[:3],
        planck_hl, emission, albedo, cheb=setup.pdf_cheb)
    return total, clear, {"cloud_cover_lw": tcc, **extras}


def solve_sw(setup, single_level, cloud, cloud_props, od, ssa, g,
             incoming_sw, albedo_diffuse, albedo_direct):
    cfg = setup.config
    if cfg.i_solver_sw != Solver.MCICA:
        _refuse(cfg.i_solver_sw)
    total, clear, tcc = solver_mcica_sw(
        cfg, setup.pdf_sampler, setup.spec.band_from_g_sw,
        single_level.iseed, single_level.cos_sza, cloud, od, ssa, g,
        *cloud_props[3:], incoming_sw, albedo_diffuse, albedo_direct,
        cheb=setup.pdf_cheb)
    return total, clear, {"cloud_cover_sw": tcc}
