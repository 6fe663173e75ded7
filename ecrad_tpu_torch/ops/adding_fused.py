"""Kernels B3 and B3': the adding level sweeps as CUDA kernels
(csrc/level_sweep.cu); kernel B5: the Tripleclouds region sweeps
(csrc/tc_sweeps.cu, at the end of this module).

Replaces ecrad_tpu/ops/adding_fused.py::level_sweep (:38, pallas_call
:125) in its three uses: `adding_sw_fused` (:144, three sweeps),
`affine_fused` (:247) as the down and up sweeps of the LW no-scattering
fluxes (solvers/adding.py:240-261) and, as B3', `adding_lw_fused` (:210,
LW adding with scattering). The plain versions are solvers/adding.py
`adding_sw_plain`, `lw_no_scattering_fluxes_plain` and
`adding_lw_plain`.

On the H100 each sweep is a recurrence over ~137 levels that is
independent per (g, column): one thread owns one (g, column) pair and
keeps its carry in registers, so the TPU's split into one pallas_call
per sweep with a VMEM-resident carry is not carried over. Operands are
g-first (nlev, ng, ncol), so a warp reads 32 neighbouring columns of
one level: every load and store is coalesced. The adding kernels keep,
per level, the albedo and source below it on chip for the descent: SW
moves 12 profiles (from 18), LW 9 (from 13). Up to SW_ONCHIP_LEVELS /
LW_ONCHIP_LEVELS levels' values sit in shared memory; the levels above
them go to the scratch the wrappers allocate here.

B3 and B3' take float32 or float64 operands, each call in one dtype: a
float64 call launches the kernels' double forms (csrc/level_sweep.cu
*_f64), whose windows are F64_ONCHIP_LEVELS. Any other dtype, a CPU
tensor, a strided one or operands of mixed dtypes raise.
"""
from __future__ import annotations

import torch

from . import _cuda

#: launches of each CUDA kernel (incremented only where it is launched)
launches = {"sw_adding": 0, "lw_noscat": 0, "lw_adding": 0,
            "tc_sw_sweeps": 0, "tc_lw_sweeps": 0}
#: levels whose adding-sweep values the SW and LW kernels keep in shared
#: memory (csrc/level_sweep.cu SW_ONCHIP_LEVELS, LW_ONCHIP_LEVELS); the
#: values of the levels above them go to a device-memory scratch of (2,
#: nlev - onchip, ng, ncol) floats
SW_ONCHIP_LEVELS, LW_ONCHIP_LEVELS = 256, 160
#: the double forms' windows (csrc/level_sweep.cu F64_SW_ONCHIP_LEVELS,
#: F64_LW_ONCHIP_LEVELS), (SW, LW): a double level takes twice a float
#: one's shared memory; SW keeps every level up to 256 on chip, LW 96 (at
#: 137 levels the top 41 go to the scratch)
F64_ONCHIP_LEVELS = (256, 96)


def _spill(nlev, ng, ncol, onchip, device, dtype=torch.float32):
    """An adding kernel's scratch for the levels it keeps off chip."""
    return torch.empty((2, max(nlev - onchip, 0), ng, ncol),
                       dtype=dtype, device=device)


def _window(dtype, lw: bool) -> int:
    """The on-chip window of the adding kernel of dtype."""
    if dtype == torch.float64:
        return F64_ONCHIP_LEVELS[int(lw)]
    return LW_ONCHIP_LEVELS if lw else SW_ONCHIP_LEVELS


def adding_sw_fused(ref, trans, ref_dir, trans_dir_diff, trans_dir_dir,
                    incoming_toa, albedo_diffuse, albedo_direct, cos_sza):
    """SW adding (radiation_adding_ica_sw.F90:85-143) in one kernel:
    direct descent, albedo/source ascent, diffuse descent. Layer inputs
    (nlev, ng, ncol), incoming/albedos (ng, ncol), cos_sza (ncol,).
    Returns (flux_up, flux_dn_diffuse, flux_dn_direct), (nlev+1, ng,
    ncol), in the operands' dtype, float32 or float64."""
    nlev, ng, ncol = ref.shape
    dt = _cuda.scalar(ref, "ref")
    for name, x in (("ref", ref), ("trans", trans), ("ref_dir", ref_dir),
                    ("trans_dir_diff", trans_dir_diff),
                    ("trans_dir_dir", trans_dir_dir)):
        _cuda.check(x, dt, (nlev, ng, ncol), name)
    for name, x in (("incoming_toa", incoming_toa),
                    ("albedo_diffuse", albedo_diffuse),
                    ("albedo_direct", albedo_direct)):
        _cuda.check(x, dt, (ng, ncol), name)
    _cuda.check(cos_sza, dt, (ncol,), "cos_sza")
    out = torch.empty((3, nlev + 1, ng, ncol), dtype=dt, device=ref.device)
    _cuda.launch("sw_adding", ref, trans, ref_dir, trans_dir_diff,
                 trans_dir_dir, incoming_toa, albedo_diffuse, albedo_direct,
                 cos_sza, nlev, ng, ncol,
                 _spill(nlev, ng, ncol, _window(dt, False), ref.device, dt),
                 out[0], out[1], out[2], dtype=dt)
    launches["sw_adding"] += 1
    return out[0], out[1], out[2]


def lw_noscat_fused(trans, source_up, source_dn, emission_surf,
                    albedo_surf):
    """LW no-scattering fluxes (radiation_adding_ica_lw.F90:272-324) in
    one kernel: fd[l+1] = T fd[l] + Sd, fu[nlev] = emission + albedo
    fd[nlev], fu[l] = T fu[l+1] + Su. Returns (flux_up, flux_dn),
    (nlev+1, ng, ncol), in the operands' dtype, float32 or float64."""
    nlev, ng, ncol = trans.shape
    dt = _cuda.scalar(trans, "trans")
    for name, x in (("trans", trans), ("source_up", source_up),
                    ("source_dn", source_dn)):
        _cuda.check(x, dt, (nlev, ng, ncol), name)
    _cuda.check(emission_surf, dt, (ng, ncol), "emission_surf")
    _cuda.check(albedo_surf, dt, (ng, ncol), "albedo_surf")
    out = torch.empty((2, nlev + 1, ng, ncol), dtype=dt,
                      device=trans.device)
    _cuda.launch("lw_noscat", trans, source_up, source_dn, emission_surf,
                 albedo_surf, nlev, ng, ncol, out[0], out[1], dtype=dt)
    launches["lw_noscat"] += 1
    return out[0], out[1]


def adding_lw_fused(ref, trans, source_up, source_dn, emission_surf,
                    albedo_surf):
    """Kernel B3': LW adding with scattering
    (radiation_adding_ica_lw.F90:32-131) in one kernel: albedo/source
    ascent, kept on chip for the flux descent. Layer
    inputs (nlev, ng, ncol), emission/albedo (ng, ncol). Returns
    (flux_up, flux_dn), (nlev+1, ng, ncol), in the operands' dtype,
    float32 or float64."""
    nlev, ng, ncol = ref.shape
    dt = _cuda.scalar(ref, "ref")
    for name, x in (("ref", ref), ("trans", trans),
                    ("source_up", source_up), ("source_dn", source_dn)):
        _cuda.check(x, dt, (nlev, ng, ncol), name)
    _cuda.check(emission_surf, dt, (ng, ncol), "emission_surf")
    _cuda.check(albedo_surf, dt, (ng, ncol), "albedo_surf")
    out = torch.empty((2, nlev + 1, ng, ncol), dtype=dt, device=ref.device)
    _cuda.launch("lw_adding", ref, trans, source_up, source_dn,
                 emission_surf, albedo_surf, nlev, ng, ncol,
                 _spill(nlev, ng, ncol, _window(dt, True), ref.device, dt),
                 out[0], out[1], dtype=dt)
    launches["lw_adding"] += 1
    return out[0], out[1]


# ---- kernel B5: the Tripleclouds region sweeps ----
#
# Replaces ecrad_tpu/ops/adding_fused.py::tc_sw_sweeps (:290) and
# ::tc_lw_sweeps (:361). One thread per (g, column) runs the upward sweep
# into scratch and the downward sweep from it; only the region-summed
# profiles are written. In a clear layer the cloudy regions are neither
# loaded nor kept in the scratch (the plain versions zero them), and a
# block's four g-points share one copy of each level's overlap matrices.
# Bound by device-memory bandwidth on what it moves, the history in the
# scratch and then the overlap matrices its largest costs
# (csrc/tc_sweeps.cu). The plain versions are solvers/tripleclouds.py
# tc_sw_sweeps_plain and tc_lw_sweeps_plain.

def tc_sw_sweeps_fused(ref, trans, ref_dir, tdd, tdir, v_mat, clear,
                       albedo_diffuse, albedo_direct, mu0, incoming,
                       frac_top):
    """Kernel B5, SW: layer optics (nlev, nreg, ng, ncol) with nreg 2 or
    3; v_mat (nlev+1, nreg, nreg, ncol); clear (nlev, ncol) bool; albedos
    and incoming (ng, ncol); mu0 (ncol,); frac_top (nreg, ncol). Returns
    (up, dn_diffuse, dn_direct), each (nlev+1, ng, ncol)."""
    nlev, nreg, ng, ncol = ref.shape
    if nreg not in (2, 3):
        raise ValueError(f"the Tripleclouds sweeps take 2 or 3 regions, "
                         f"not {nreg}")
    for name, x in (("ref", ref), ("trans", trans), ("ref_dir", ref_dir),
                    ("tdd", tdd), ("tdir", tdir)):
        _cuda.check(x, torch.float32, (nlev, nreg, ng, ncol), name)
    _cuda.check(v_mat, torch.float32, (nlev + 1, nreg, nreg, ncol), "v_mat")
    _cuda.check(clear, torch.bool, (nlev, ncol), "clear")
    for name, x in (("albedo_diffuse", albedo_diffuse),
                    ("albedo_direct", albedo_direct),
                    ("incoming", incoming)):
        _cuda.check(x, torch.float32, (ng, ncol), name)
    _cuda.check(mu0, torch.float32, (ncol,), "mu0")
    _cuda.check(frac_top, torch.float32, (nreg, ncol), "frac_top")
    out = torch.empty((3, nlev + 1, ng, ncol), dtype=torch.float32,
                      device=ref.device)
    scratch = torch.empty((nlev, 2, nreg, ng, ncol), dtype=torch.float32,
                          device=ref.device)
    _cuda.launch("tc_sw_sweeps", ref, trans, ref_dir, tdd, tdir, v_mat,
                 clear, albedo_diffuse, albedo_direct, mu0, incoming,
                 frac_top, nreg, nlev, ng, ncol, scratch, out[0], out[1],
                 out[2])
    launches["tc_sw_sweeps"] += 1
    return out[0], out[1], out[2]


def tc_lw_sweeps_fused(ref, trans, src_up, src_dn, v_mat, u_mat, clear,
                       emission, albedo, frac_bot):
    """Kernel B5, LW: layer optics and sources (nlev, nreg, ng, ncol);
    v_mat (nlev+1, nreg, nreg, ncol); u_mat (nlev, nreg, nreg, ncol);
    clear (nlev, ncol) bool; emission and albedo (ng, ncol); frac_bot
    (nreg, ncol). Returns (up, dn), each (nlev+1, ng, ncol)."""
    nlev, nreg, ng, ncol = ref.shape
    if nreg not in (2, 3):
        raise ValueError(f"the Tripleclouds sweeps take 2 or 3 regions, "
                         f"not {nreg}")
    for name, x in (("ref", ref), ("trans", trans), ("src_up", src_up),
                    ("src_dn", src_dn)):
        _cuda.check(x, torch.float32, (nlev, nreg, ng, ncol), name)
    _cuda.check(v_mat, torch.float32, (nlev + 1, nreg, nreg, ncol), "v_mat")
    _cuda.check(u_mat, torch.float32, (nlev, nreg, nreg, ncol), "u_mat")
    _cuda.check(clear, torch.bool, (nlev, ncol), "clear")
    _cuda.check(emission, torch.float32, (ng, ncol), "emission")
    _cuda.check(albedo, torch.float32, (ng, ncol), "albedo")
    _cuda.check(frac_bot, torch.float32, (nreg, ncol), "frac_bot")
    out = torch.empty((2, nlev + 1, ng, ncol), dtype=torch.float32,
                      device=ref.device)
    scratch = torch.empty((nlev, 2, nreg, ng, ncol), dtype=torch.float32,
                          device=ref.device)
    _cuda.launch("tc_lw_sweeps", ref, trans, src_up, src_dn, v_mat, u_mat,
                 clear, emission, albedo, frac_bot, nreg, nlev, ng, ncol,
                 scratch, out[0], out[1])
    launches["tc_lw_sweeps"] += 1
    return out[0], out[1]
