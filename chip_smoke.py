#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100).

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. device and build: versions, the card's name and power limit, the
     CUDA kernels built from ecrad_tpu_torch/csrc for sm_90a (the
     compiler's register/shared-memory/spill report is printed, and for
     B1, B2, B3 sw_adding and B3' lw_adding at 137 and 300 levels, B3
     lw_noscat, B5's SW and LW kernels with 3 and 2 regions at 137 and 300
     levels, B6's and B7's two passes, B8, B9 with multilayer effects
     off and on, B4's SW form, B11, the McICA generator's random-fields kernel
     for float32 and float64, the cloud generator kernel's float and
     double forms at 112 and 140 g-points, and the double forms of B1, B2,
     B3 sw_adding
     and lw_noscat, B3' lw_adding at 137 levels and B4's SW form the
     registers, spills, shared memory and the warps per SM their launches
     get; a spill in the double forms of B1-B3 fails);
  2. every kernel of the paths (B1 taumol_lw, B2 taumol_sw, B3 sw_adding
     and lw_noscat, B3' lw_adding, B4 mcica_sw_optics and
     mcica_lw_optics, B5 tc_sw_sweeps and tc_lw_sweeps, B11 tc_sw_optics
     (both families bit for bit), B6
     spartacus_sw_reftrans, B7 spartacus_lw_reftrans, B8
     spartacus_sw_adding, B9 spartacus_lw_adding, B10 gather_sections,
     and threefry_fields, the McICA generator's random fields, bit for
     bit in float32 and float64 at the SW and LW generator calls' 2048 x
     137 x 112 and 140 with iseed and iseed + 997; mcica_generator, the
     cloud generator, on those uniforms and the McICA path's cloud under
     GEN_CONTRACT)
     against its plain PyTorch version on the card, at the shapes the
     paths give it (B5-B9 on the operands the Tripleclouds and SPARTACUS
     paths hand them; B6 and B7 also on a random case built like
     tools/check_kernel_equivalence.py's, at 3 and 2 regions; B8 under all
     five entrapment treatments on 256 columns of the path's operands;
     B6 also with no 3D cell, with every cell 3D, with the path's 3D
     share, and with an odd ng x ncol (its two passes' doubling counts
     and a second call bit for bit); B8 also with 1, 2 and 7 levels,
     fewer than or about its stage ring, 15 g-points and 133 columns,
     under every treatment at 3 and 2 regions; B7 likewise at 3D shares
     0, 1 and 0.14, with cloud scattering on and off; B9 with 1, 2 and 7
     levels, 15 g-points and 133 columns, a full random surface albedo
     matrix, under (use_matrix, multilayer) (T, F), (T, T) and (F, F), at
     3 and 2 regions; B10 on the 30 calls of
     one per-band gas-optics call of the 2048 x 137 columns, with no
     operand copied by its wrapper, its registers, spills, shared memory
     and blocks per SM for each call, and on that tool's random cases,
     with rows past both ends, with zero-padded halves, an all-zero table
     and weights of both signs);
     B1 also on 1, 137 and 4,099 cells and on the tropospheric and the
     stratospheric cells apart; B2 on 1, 31, 33 and 4,099 cells and on
     those two cell sets, taur at 0 difference; B3 sw_adding and B3'
     lw_adding equal to their plain versions bit for bit at the paths'
     shapes, on 1, 2, 137 and 300 levels x 15 g-points x 133 columns, and
     at 300 levels at the path's width (past their on-chip window: the
     device-memory branch); B5 likewise at the path's shapes, with 3 and 2
     regions on 1, 2, 7, 137 and 300 levels x 15 g-points x 133 and 132
     columns (its 4-byte and 16-byte copies), all clear, all cloudy and
     alternating, and with 2 regions on the path's operands cut to two;
     the per-band gas optics against B1/B2's; the SPARTACUS path's share
     of cells with the 3D treatment and the histogram of their doubling
     counts; the float64 McICA path (the benchmark's float64 cell's
     configuration: LW aerosol scattering on, cloud scattering off, 12
     aerosol types, LW derivatives) on the 2048 x 137 columns with clouds
     and aerosols, the hooks' counters reset just before the call and read
     just after: every launch in its double form (F64_LAUNCHES, the
     launch.<kernel>.f64 counters and no other launch or plain_on_device
     counter), every output float64; and on that call's operands each
     double form against its plain version in float64, B1 and B2 within
     F64_TAUMOL_REL of each output's largest value, B3 sw_adding (both
     calls), lw_noscat, B3' lw_adding and B4's SW form bit for bit, the
     cloud generator (both calls) under GEN_CONTRACT;
  3. the paths, each run once with the launch counts set to 0 just
     before it and read just after, through setup_radiation + radiation:
     a. Cloudless on 2048 x 137 columns of ecrad_tpu_torch.inputs (seed
        0): physical checks, the first 32 columns against
        tests/goldens/torch_port_cloudless.npz;
     b. McICA (mcica_slice_config: Exp-Exp, LW cloud scattering) on the
        same columns with make_clouds' clouds and the SYNTHETIC LUTs of
        write_synthetic_luts (seed 0, written into the git-ignored
        ecrad_tpu_torch/_build/): the first 32 columns' subcolumn masks,
        cloud covers and fluxes against tests/goldens/torch_port_mcica.npz
        (a parity check on synthetic tables, not an ecRad LUT result);
     c. McICA on 256 columns without LW cloud or aerosol scattering and
        with Exp-Ran overlap, the path of B4's LW kernel;
     d. Tripleclouds (tripleclouds_slice_config: 3 regions, gamma PDF,
        Exp-Ran, Fu ice, 12 aerosol types, LW derivatives) on the
        2048 x 137 columns with make_clouds' clouds, make_aerosols'
        aerosols and the synthetic LUTs (Fu ice, synthetic aerosol table):
        the first 32 columns' fluxes, cloud covers and LW derivatives
        against tests/goldens/torch_port_tripleclouds.npz, JAX float32
        and float64;
     e. Tripleclouds on 256 columns with 2 regions, lognormal PDF, beta
        overlap, LW cloud scattering and no aerosols (B5 at NREG=2, B3
        lw_noscat);
     f. Homogeneous on 256 columns with aerosols;
     g. SPARTACUS (spartacus_slice_config: 3D effects, Explicit
        entrapment, 3 regions, the Tripleclouds path's other settings) on
        the 2048 x 137 columns with the effective sizes of
        inputs.add_effective_sizes: the first 32 columns against
        tests/goldens/torch_port_spartacus.npz (bench.py's
        SPARTACUS_F64_BOUNDS against JAX float64);
     h. SPARTACUS on 256 columns with Maximum entrapment, and with 2
        regions, lognormal PDF, Zero entrapment, LW cloud scattering and
        no aerosols (B6-B9 at NREG=2, B3 lw_noscat);
     i. the offline driver (ecrad_tpu_torch.driver.main) with
        ECRAD_FUSED_TAUMOL=0, the per-band gas optics, on the 2048 x 137
        columns written to a NetCDF file by save_inputs: 30 B10 launches
        and no B1/B2, the written fluxes' first 32 columns against
        tests/goldens/torch_port_cloudless.npz;
     j. the driver with McICA (all-band gas optics) on 256 columns of
        make_clouds and the synthetic LUTs: its file equal, field by
        field, to what radiation() gives for the same file's inputs;
     k. the IFS entry point, coupling.radiation_scheme, on the 2048 x 137
        columns with make_clouds' clouds (McICA, the surface band fluxes,
        the band profiles, the clear sky, a spectral solar scaling of
        0.8-1.2, the canopy fluxes), then unpack_host_outputs: the
        profiles summed over bands against the broadband fluxes, a
        scaling of ones against none bit for bit, UV and PAR finite and
        below the surface sw_dn; its ms beside radiation() on McICA;
     l. SPARTACUS with the g-point profiles on the 2048 x 137 columns:
        summed, the broadband fluxes; summed over each band's g-points by
        the un-reordered band map, the band profiles of the same call
        with do_save_spectral_flux alone;
     m. the monochromatic model on the 2048 x 137 columns under
        Homogeneous (LW cloud scattering on) and McICA (off): B3, B3' and
        B4 at one g-point, each against its plain version on the
        operands those paths hand it;
     n. SPARTACUS with the entrapment dump on 256 columns: every flux
        field equal to the call without it, B8 launched, the internals
        finite and (137, 3, 256), the driver's fort.101/102 files;
     o. the driver on a tiled surface: the 2048 x 137 columns with
        make_clouds' clouds and inputs.make_surface(2048, (1, 2, 3), 0)
        (mls_london1's flat, vegetation and urban tiles) in one NetCDF
        file under ecrad_tpu_torch/_build/driver/. Cloudless with
        full-spectrum LW canopies and their gas absorption
        (do_canopy_gases_lw): B1 and B2 launched twice (the lowest
        level's gas optics), sw_adding and lw_noscat once; the first 32
        columns' fluxes and facet and canopy fields against
        tests/goldens/torch_port_surface.npz (BOUNDS, each facet field
        its region's downwelling bound, plus the JAX package's own
        float32 error), the four boundary fields from the driver's steps
        on the file's inputs within 1e-5 of their largest values. McICA
        with full-spectrum SW and LW canopies on the synthetic LUTs: the
        flux and surface-flux files equal, field by field, to
        calc_boundary_conditions + radiation() + partition_fluxes called
        on the file's inputs. Both: facet fields finite, the flat ground
        facet's sw_dn and lw_dn the surface fluxes (rtol 1e-5), no facet
        reflecting more SW than it receives. The ms of
        calc_boundary_conditions and partition_fluxes at 2048 columns;
     p. analysis.compare (numpy only: no jax, no matplotlib) on the
        McICA driver file and the radiation() file, in process and
        through `python -m ecrad_tpu_torch.analysis.compare`: 0 in every
        one of its 16 fields;
     q. parallel on one card: init_distributed's single-process dict,
        the McICA surface driver with do_parallel = true writing the
        files of do_parallel = false bit for bit (one card: no split),
        and parallel.scaling.scaling_benchmark at 2048 x 137 McICA
        (columns/s on one device, information only);
     r. the profiler and the general matrix exponentials: the native host
        cores (ecrad_tpu_torch/csrc/host, built with g++ into
        ecrad_tpu_torch/_build/; a missing library fails) and a record
        read back through FortranFile's native reader; McICA at 2048 x
        137 with the hooks on (hooks.enable), the program's own `ecrad.*`
        spans inside an outer span that synchronises: 3 calls accounted
        (each layer's and generator stage's calls, the generator's random
        fields and kernel and none of its plain stages, self at most total,
        `ecrad.radiation`'s total at least its children's, the hook
        stack empty after), dump_profile read back by
        tools/merge_hook_profiles.py, one call traced with
        start_trace/stop_trace (B1 and B2 inside `ecrad.gas_optics`);
        McICA's ms with the hooks off and on in turns and
        without the spans (information only); expm_g (3 x 3) and
        expm_sw_g (6 x 6 + 3 x 3) on 112 x 2048 SW generators in float32
        on the card against float64 and float32 on the CPU (2e-5 of each
        output's largest value);
  4. times (information only): each kernel and its plain version with
     CUDA events (threefry_fields over both generator calls of a McICA
     call, against its integer-operation bound; mcica_generator and its
     double form likewise over both, against their bytes; B10 per
     gas-optics call,
     its 30 launches issued from Python, beside the same launches replayed
     from a CUDA graph, the wrapper with its packing and one embedding_bag
     call per launch on the same flattened operands; B1's
     and B2's rate on their least bytes, B2's beside its table gathers;
     B3 sw_adding and B3' lw_adding at 137 and 300 levels with the rate
     on the bytes each design moves; B5 with 3 and 2 regions with the
     rate on the bytes its design moves on this run's clear sectors; B6's
     and B7's two passes apart, with the number of 3D cells the first
     pass found; B8's rate on the bytes its design moves, and B9's
     with multilayer effects off and on; the double forms on the first of
     their float64 path calls, `<kernel>_f64` in the summary, against a
     least time at the FP64 rate), and
     each 2048-column path's columns/s and peak memory over 10
     back-to-back calls, best of 2, Cloudless also with the per-band gas
     optics.
The line before last is the card's name and power limit, the one before
that a JSON summary of the kernels (with each kernel's least time on the
card, bound_ms, from this run's operand bytes and operation count, at
the float32 rate, or the FP64 rate for a double form); the
last line is {"ok": true, "device": {...}}. There is no CPU fallback:
without a GPU the script exits 1.
"""
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

NCOL, NLEV, SEED = 2048, 137, 0
GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_port_cloudless.npz")
GOLDEN_MCICA = os.path.join(REPO, "tests", "goldens", "torch_port_mcica.npz")
GOLDEN_TC = os.path.join(REPO, "tests", "goldens",
                         "torch_port_tripleclouds.npz")
GOLDEN_SP = os.path.join(REPO, "tests", "goldens", "torch_port_spartacus.npz")
LUT_DIR = os.path.join(REPO, "ecrad_tpu_torch", "_build", "synthetic_luts")
# golden bounds (W/m2): the clear-sky float32-vs-float64 contract of
# tests/test_f64_validation.py, and the total-sky one of the
# deterministic solvers (lw 0.02, sw 0.30) for McICA's total sky on the
# columns whose subcolumns match the golden's (float32 only: float64
# draws other random numbers)
BOUNDS = {"lw_up": 0.01, "lw_dn": 0.01, "sw_up": 0.2, "sw_dn": 0.2,
          "sw_dn_direct": 0.02}
TOTAL_BOUNDS = {"lw_up": 0.02, "lw_dn": 0.02, "sw_up": 0.3, "sw_dn": 0.3,
                "sw_dn_direct": 0.3}
MAX_MASK_FLIPS, COVER_ATOL = 2, 1e-5
# Tripleclouds golden: deterministic, so total and clear sky against JAX
# float32 and float64
TC_BOUNDS = {**{k + "_clear": v for k, v in BOUNDS.items()},
             **TOTAL_BOUNDS, "cloud_cover_sw": COVER_ATOL,
             "cloud_cover_lw": COVER_ATOL, "lw_derivatives": 1e-4}
# SPARTACUS golden: bench.py's SPARTACUS_F64_BOUNDS (W/m2), the JAX
# package's float32-vs-float64 gate for this solver
SP_BOUNDS = {"lw_up": 0.01, "lw_dn": 0.01, "sw_up": 0.20, "sw_dn": 0.20,
             "sw_dn_direct": 0.01, "lw_up_clear": 0.01, "lw_dn_clear": 0.01,
             "sw_up_clear": 0.20, "sw_dn_clear": 0.20,
             "cloud_cover_sw": COVER_ATOL, "cloud_cover_lw": COVER_ATOL,
             "lw_derivatives": 1e-4}
# kernel vs plain tolerances: the JAX package's own bounds for the fused
# taumol (tests/test_taumol_fused.py), the adding sweeps
# (tests/test_adding_fused.py) and the McICA optics
# (tests/test_mcica_optics.py: SW 2e-3, LW 1e-4 of the range)
TAU_REL, PF_ATOL, SWEEP_REL = 1e-5, 1e-6, 2e-6
# SPARTACUS kernels: the JAX package's kernel-vs-fallback bound
# (tools/check_kernel_equivalence.py:209,221); beyond it B6 and B7 must
# be no farther from the float64 plain version than twice the float32
# plain version is (:186-196)
SPARTACUS_REL = 2e-5
OPTICS_REL = {"mcica_sw_optics": 2e-3, "mcica_lw_optics": 1e-4}
# the adding kernels (B3 sw_adding, B3' lw_adding) and the Tripleclouds
# sweeps (B5) keep their plain versions' operation order: 0 difference
ADDING = ("sw_adding", "lw_adding", "tc_sw_sweeps", "tc_lw_sweeps")
# B5's clear-layer patterns (all clear, all cloudy, alternating in level
# and column) on random operands of 15 g-points x 133 columns
TC_PATTERNS = ("all_clear", "all_cloudy", "alternating")
# the kernels each path must launch
PATH_KERNELS = {
    "cloudless": ("taumol_lw", "taumol_sw", "sw_adding", "lw_noscat"),
    "mcica": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
              "mcica_sw_optics", "threefry_fields",
              "mcica_generator"),
    "mcica_noscat": ("taumol_lw", "taumol_sw", "sw_adding", "lw_noscat",
                     "mcica_sw_optics", "mcica_lw_optics",
                     "threefry_fields", "mcica_generator"),
    "tripleclouds": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
                     "tc_sw_optics", "tc_sw_sweeps", "tc_lw_sweeps",
                     "aerosol_optics"),
    "tripleclouds_2reg": ("taumol_lw", "taumol_sw", "sw_adding",
                          "lw_noscat", "tc_sw_optics", "tc_sw_sweeps",
                          "tc_lw_sweeps"),
    "homogeneous": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
                    "aerosol_optics"),
    "spartacus": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
                  "spartacus_sw_reftrans", "spartacus_lw_reftrans",
                  "spartacus_sw_adding", "spartacus_lw_adding",
                  "aerosol_optics"),
    "spartacus_maxentr": ("taumol_lw", "taumol_sw", "sw_adding",
                          "lw_adding", "spartacus_sw_reftrans",
                          "spartacus_lw_reftrans", "spartacus_sw_adding",
                          "spartacus_lw_adding"),
    "spartacus_2reg": ("taumol_lw", "taumol_sw", "sw_adding", "lw_noscat",
                       "spartacus_sw_reftrans", "spartacus_lw_reftrans",
                       "spartacus_sw_adding", "spartacus_lw_adding"),
    "driver_per_band": ("gather_sections", "sw_adding", "lw_noscat"),
    "driver_mcica": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
                     "mcica_sw_optics", "threefry_fields",
                     "mcica_generator"),
    "ifs_entry": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
                  "mcica_sw_optics", "threefry_fields",
                  "mcica_generator"),
    "spartacus_gpoint": ("taumol_lw", "taumol_sw", "sw_adding",
                         "lw_adding", "spartacus_sw_reftrans",
                         "spartacus_lw_reftrans", "spartacus_sw_adding",
                         "spartacus_lw_adding"),
    "spartacus_bands": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
                        "spartacus_sw_reftrans", "spartacus_lw_reftrans",
                        "spartacus_sw_adding", "spartacus_lw_adding"),
    "mono_homogeneous": ("sw_adding", "lw_adding", "lw_noscat"),
    "mono_mcica": ("sw_adding", "lw_noscat", "mcica_sw_optics",
                   "mcica_lw_optics", "threefry_fields",
                   "mcica_generator"),
    "spartacus_dump": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
                       "spartacus_sw_reftrans", "spartacus_lw_reftrans",
                       "spartacus_sw_adding", "spartacus_lw_adding"),
    "surface_cloudless": ("taumol_lw", "taumol_sw", "sw_adding",
                          "lw_noscat"),
    "surface_mcica": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
                      "mcica_sw_optics", "threefry_fields",
                      "mcica_generator"),
    "hooks_mcica": ("taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
                    "mcica_sw_optics", "threefry_fields",
                    "mcica_generator"),
}
# the band and g-point profiles, each summed over its last axis, against
# the broadband profile: of each field's largest value
PROFILE_REL = 1e-5
PROFILES = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct")
# the monochromatic model's optical depths (the toy model's totals)
MONO = dict(mono_lw_total_od=2.0, mono_sw_total_od=0.5, use_aerosols=False)
NCOL_DUMP = 256
# B10 launches per gas-optics call of the per-band path: 16 LW bands, 13
# SW bands with gas absorption and band 24's Rayleigh term
B10_PER_CALL = 30
# B10 against its plain version: the JAX package's gather-interp bound
# (tools/check_kernel_equivalence.py:59-62), of the output's largest value
B10_REL = 5e-6
# the adding sweeps' level count past their on-chip windows
# (ops/adding_fused.py SW_ONCHIP_LEVELS, LW_ONCHIP_LEVELS): the top levels'
# values go to the device-memory scratch
ADD_SPILL_NLEV = 300
DRIVER_DIR = os.path.join(REPO, "ecrad_tpu_torch", "_build", "driver")
GOLDEN_SURF = os.path.join(REPO, "tests", "goldens",
                           "torch_port_surface.npz")
# the tiled surface of phase o: mls_london1's flat, vegetation and urban
# tiles; its namelist lines (Cloudless: full-spectrum LW canopies with
# their gas absorption; McICA: full-spectrum SW and LW canopies)
SURFACE_REPRESENTATION = (1, 2, 3)
SURFACE_OPTIONS = {
    "Cloudless": " use_canopy_full_spectrum_lw = true,\n"
                 " do_canopy_gases_lw = true,\n",
    "McICA": " use_canopy_full_spectrum_sw = true,\n"
             " use_canopy_full_spectrum_lw = true,\n"}
# the surface-flux file's variables and their golden names; each facet
# and canopy field takes the bound of its region's downwelling flux
SURFACE_FILE = {"lw_dn_facet": "flux_dn_lw_facet",
                "lw_up_facet": "flux_up_lw_facet",
                "lw_abs_canopy": "absorption_lw_canopy",
                "sw_dn_facet": "flux_dn_sw_facet",
                "sw_dn_direct_facet": "flux_dn_direct_sw_facet",
                "sw_up_facet": "flux_up_sw_facet",
                "sw_abs_canopy": "absorption_sw_canopy"}
SURFACE_BOUNDS = {k: BOUNDS["lw_dn"] if k.startswith("lw") else
                  BOUNDS["sw_dn"] for k in SURFACE_FILE}
# the boundary fields against the golden: of each field's largest value
BC_REL = 1e-5
# the driver's namelist: the port's slice options (config.SLICE_OPTIONS)
NAMELIST = """&radiation
 sw_solver_name = "{solver}",
 lw_solver_name = "{solver}",
 overlap_scheme_name = "Exp-Exp",
 use_aerosols = false,
 do_nearest_spectral_sw_albedo = false,
 sw_albedo_wavelength_bound(1:5) = 0.25e-6, 0.44e-6, 0.69e-6, 1.19e-6, 2.38e-6,
 i_sw_albedo_index(1:6) = 1, 2, 3, 4, 5, 6,
 do_nearest_spectral_lw_emiss = true,
 lw_emiss_wavelength_bound(1:2) = 8.0e-6, 13.0e-6,
 i_lw_emiss_index(1:3) = 1, 2, 1,
{luts}/
&radiation_driver
 iverbose = 1,
 do_parallel = false,
 solar_irradiance_override = {solar},
/
"""
# the flux variables of the driver's output file
FILE_FLUXES = {"lw_up": "flux_up_lw", "lw_dn": "flux_dn_lw",
               "sw_up": "flux_up_sw", "sw_dn": "flux_dn_sw",
               "sw_dn_direct": "flux_dn_direct_sw"}
NCOL_NOSCAT = 256
# B8's and B9's block heights in g-points (csrc/spartacus_adding.cu
# G_TILE, LW_G_TILE)
B8_G_TILE, B9_G_TILE = 8, 4
# phase r: the program's spans a McICA radiation() call enters (the cloud
# generator's, its random fields' and its kernel's once for SW and once
# for LW; on the card no plain stage) inside the outer HOOK_OUTER,
# and those directly inside `ecrad.radiation`
HOOK_OUTER = "smoke_call"
HOOK_CALLS = {HOOK_OUTER: 1, "ecrad.radiation": 1, "ecrad.gas_optics": 1,
              "ecrad.cloud_optics": 1, "ecrad.solver_lw": 1,
              "ecrad.solver_sw": 1, "ecrad.cloud_generator": 2,
              **{f"ecrad.cloud_generator.{stage}": 2 for stage in (
                  "random", "kernel")}}
# the generator's plain stages, which the card never enters
PLAIN_STAGES = tuple(f"ecrad.cloud_generator.{stage}"
                     for stage in ("cover", "walk", "sample"))
HOOK_CHILDREN = ("ecrad.gas_optics", "ecrad.cloud_optics", "ecrad.solver_lw",
                 "ecrad.solver_sw")
HOOK_REPS = 3
# the matrix exponentials on the card in float32 against the CPU: the
# float32 bound of tests/test_torch_matrix.py, of each output's largest
# value; the generators' g-points (the SW path's 112)
MATRIX_REL, MATRIX_G = 2e-5, 112
# the least time of a kernel: its operand bytes (each input read once,
# each output written once) over the H100 SXM's device-memory rate, or
# its operations over the float32 rate outside the tensor cores, the
# larger (published H100 SXM peak rates)
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# the double forms' least time takes the FP64 rate outside the tensor
# cores (published H100 SXM peak)
F64_OPS_PER_S = 34e12
# B12's operations per (row, g) output value: the merge's ~7 (SW) and ~4
# (LW) a value, and the rows' type sums, ~2 x 12 types x 90 band values,
# shared among 252 g-points (~9 a value)
AEROSOL_OPS = 15
# floating-point operations per output value, counted from each kernel's
# source (exp, sqrt and division count one each): per (cell, g) for the
# taumol and McICA-optics kernels, per (level, g, column) for the adding
# sweeps, per (level, region, g, column) for the Tripleclouds sweeps
OPS_PER_VALUE = {"taumol_lw": 60, "taumol_sw": 30, "sw_adding": 40,
                 "lw_noscat": 6, "lw_adding": 25, "mcica_sw_optics": 120,
                 "mcica_lw_optics": 40, "tc_sw_sweeps": 60,
                 "tc_lw_sweeps": 45, "tc_sw_optics": 60,
                 "aerosol_optics": AEROSOL_OPS}
# the SPARTACUS kernels' work depends on the data; operations counted
# from csrc/spartacus_reftrans.cu and spartacus_adding.cu for 3 regions
# (a matrix product M x K x N counts M N (2K - 1)): B6/B7 per fallback
# cell, per 3D cell before the doubling, per doubling step (the run's
# own counts); B8/B9 per (level, g, column) and per mixed interface
# (where the layer or its neighbour is cloudy)
SPARTACUS_OPS = {"spartacus_sw_reftrans": (180, 3900, 650),
                 "spartacus_lw_reftrans": (120, 2200, 240),
                 "spartacus_sw_adding": (600, 1200),
                 "spartacus_lw_adding": (420, 45)}
# the McICA generator's random fields (csrc/threefry.cu) are integer work:
# 32-bit integer operations a uniform (a Threefry-2x32 hash: 20 rounds of
# add, rotate and xor, 5 key injections of two adds, 2 initial adds; 3
# more to make the float), over the integer pipe's 64 lanes a clock on
# each of the 132 SMs at the 1.98 GHz boost clock; and the generator
# calls of a McICA radiation call, (g-points, seed shift): SW and LW
THREEFRY_INT_OPS, INT32_OPS_PER_S = 75, 132 * 64 * 1.98e9
GENERATOR_CALLS = ((112, 0), (140, 997))
# the cloud generator kernel (csrc/mcica_generator.cu) against its plain
# version on one generator call, by dtype: od_scaling relative on the
# cells cloudy in both, the total cover absolute; a cloudy mask may
# differ in at most GEN_MASK_SHARE of the cells (the two covers'
# cumulative sums run in another order); its floating-point operations:
# the walk's per (level, g, column) and the sample's per cloudy cell
# (ndtri, two degree-16 Clenshaw sums, two exps, the blend)
GEN_CONTRACT = {torch.float32: (1e-5, 2e-6), torch.float64: (1e-12, 1e-13)}
GEN_MASK_SHARE = 1e-6
GEN_OPS_CELL, GEN_OPS_CLOUDY = 15, 170
# phase 2's float64 path: the launches of each kernel in one float64
# McICA call, all in their double forms (the hooks' launch.<kernel>.f64
# counters): B3 sw_adding for the clear and the total sky, B3' lw_adding
# for the clear sky (LW aerosol scattering), B3 lw_noscat for the total
# sky (no LW cloud scattering), the generator's fields and the generator
# for SW and LW, and B12 (the aerosol optics, held to its plain version
# bit for bit)
F64_LAUNCHES = {"taumol_lw": 1, "taumol_sw": 1, "sw_adding": 2,
                "lw_noscat": 1, "lw_adding": 1, "mcica_sw_optics": 1,
                "threefry_fields": 2, "mcica_generator": 2,
                "aerosol_optics": 1}
# the double forms against their plain versions in float64: B1 and B2
# within F64_TAUMOL_REL of each output's largest value (their sums run in
# slot order, the plain versions' in PyTorch's: up to 21 double terms
# reassociated, some 1e-16 apart), B3, B3' and B4's SW form bit for bit
# (the same operations in the same order, CUDA's double exp, sqrt and
# division on both sides)
F64_TAUMOL_REL = 1e-13
# the launches of one float64 SPARTACUS call, all in their double forms:
# B1, B2, B3 sw_adding and B3' lw_adding for the clear sky (LW aerosol
# scattering), both passes of B6 and B7, B8 and B9, and B12; each double
# form of B6-B9 within F64_TAUMOL_REL of each output's largest value of
# its plain version (the same operations in the same order; CUDA's double
# exp, sqrt, pow and division on both sides)
SPARTACUS_F64_LAUNCHES = {
    "taumol_lw": 1, "taumol_sw": 1, "sw_adding": 1, "lw_adding": 1,
    "spartacus_sw_reftrans_3d": 1, "spartacus_sw_reftrans_fallback": 1,
    "spartacus_lw_reftrans_3d": 1, "spartacus_lw_reftrans_fallback": 1,
    "spartacus_sw_adding": 1, "spartacus_lw_adding": 1,
    "aerosol_optics": 1}


def log(msg=""):
    print(msg, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps):
    """Mean time per call of fn() on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def tensors(obj):
    """The tensors in obj: a tensor, or tuples, lists and dataclasses of
    them (each storage once)."""
    seen, out = set(), []

    def walk(x):
        if isinstance(x, torch.Tensor):
            key = (x.data_ptr(), x.numel())
            if key not in seen:
                seen.add(key)
                out.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(obj)
    return out


def least_time(name, args, outs, values=None, ops=None,
               ops_per_s=F32_OPS_PER_S):
    """(bound_ms, bound_by, bytes, operations) of one launch: `values`
    output values of OPS_PER_VALUE[name] operations each, or `ops`, at
    ops_per_s (the float32 rate; F64_OPS_PER_S for a double form)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors((args, outs)))
    ops = values * OPS_PER_VALUE[name] if ops is None else ops
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def write_namelist(path, solver, luts, solar, extra="", parallel=False):
    """The driver's namelist for `solver` with the LUT overrides `luts`,
    `extra` &radiation lines, and do_parallel as given."""
    text = NAMELIST.format(
        solver=solver, solar=solar,
        luts="".join(f' {k} = "{v}",\n' for k, v in luts.items()) + extra)
    if parallel:
        text = text.replace("do_parallel = false", "do_parallel = true")
    with open(path, "w") as f:
        f.write(text)
    return path


def read_nc(path):
    from ecrad_tpu_torch.io.netcdf import NetcdfFile
    with NetcdfFile(path) as f:
        return {v: f.read(v) for v in f.variables()}


def random_sections(dev, name, n, seed=0):
    """B10's random cases, built like tools/check_kernel_equivalence.py:
    48-55 (plain, the two LW eta shapes, mixed), plain and flattened eta
    rows past both ends of their tables, the LW bands' tau and pfrac
    tables side by side with each zero on the other half (ev2 in
    optics/rrtmg/taumol_lw_sections.py; 10 columns each, so one group of
    the kernel's 4 columns holds both), and an all-zero table between two
    others, one of them with a zero column inside its live range; the
    last two with weights of both signs and one weight a view 4 bytes
    into its storage (read with 4-byte copies)."""
    from ecrad_tpu_torch.ops import gather_interp as gi
    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(x, device=dev)            # noqa: E731

    def weight(signed):
        if not signed:
            return t(rng.rand(n).astype(np.float32))
        return t((rng.rand(n) - 0.5).astype(np.float32))

    def plain(r, k, g, lo=0, hi=None, signed=False):
        return gi.Section(
            rng.rand(r, g).astype(np.float32),
            [t(rng.randint(lo, r if hi is None else hi, n).astype(np.int32))
             for _ in range(k)],
            [weight(signed) for _ in range(k)])

    def eta(r1, r2, g, gos, eos, grid=(0, None), etas=(1, None),
            signed=False):
        return gi.EtaSection(
            rng.rand(r1, r2, g).astype(np.float32),
            [t(rng.randint(grid[0], grid[1] or r1 - 1, n).astype(np.int32))
             for _ in range(2)],
            [[(o, weight(signed)) for o in gos] for _ in range(2)],
            [t(rng.randint(etas[0], etas[1] or r2 - 2, n).astype(np.int32))
             for _ in range(2)],
            [[(o, weight(signed)) for o in eos] for _ in range(2)])

    def half(sec, tau):
        """sec with the pfrac (tau) or tau (not tau) half of g zeroed"""
        tab = sec.table.copy()
        h = tab.shape[-1] // 2
        tab[..., h:] = 0.0
        return sec._replace(table=tab if tau else np.roll(tab, h, -1))

    def ev2_halves():
        secs = [half(eta(65, 9, 20, (0, 1), (-1, 0, 1, 2), signed=True),
                     True),
                half(eta(235, 5, 20, (0, 1), (0, 1), signed=True), True),
                half(plain(10, 2, 20, signed=True), True),
                half(plain(9, 2, 20, signed=True), False),
                half(plain(5, 2, 20, signed=True), False)]
        w = t(np.zeros(n + 1, np.float32))
        w[1:] = secs[2].weights[0]
        secs[2].weights[0] = w[1:]
        return secs

    def zero_section():
        first = plain(20, 3, 12, lo=-7, hi=26, signed=True)
        first.table[:, 5] = 0.0
        zero = plain(7, 2, 12, signed=True)
        return [first, zero._replace(table=np.zeros_like(zero.table)),
                eta(13, 9, 12, (0, 1), (0, 1), signed=True)]

    return {
        "plain": lambda: [plain(65, 4, 12)],
        "eta_lw_absa": lambda: [eta(65, 9, 12, (0, 1), (-1, 0, 1, 2))],
        "eta_lw_absb": lambda: [eta(235, 5, 12, (0, 1), (0, 1))],
        "mixed": lambda: [plain(10, 2, 12), eta(19, 9, 12, (0, 1), (0, 1)),
                          plain(300, 4, 12)],
        "out_of_range": lambda: [plain(20, 3, 12, lo=-7, hi=26),
                                 eta(13, 9, 12, (-1, 0, 1), (-3, 0, 1, 4),
                                     grid=(-2, 15), etas=(-4, 12))],
        "ev2_halves": ev2_halves,
        "zero_section": zero_section,
    }[name]()


def flat_terms(secs, dev):
    """A section list as the operands of one embedding_bag call: (N, K)
    global rows into the stacked tables (clipped, EtaSections flattened),
    the (R, G) tables, (N, K) weights."""
    from ecrad_tpu_torch.ops import gather_interp as gi
    rows, ws, tabs, off = [], [], [], 0
    for sec in secs:
        if isinstance(sec, gi.EtaSection):
            sec = gi.eta_to_plain(sec, torch.float32, dev)
        tab = gi.table_tensor(sec.table, torch.float32, dev)
        rows += [off + r.clamp(0, tab.shape[0] - 1).long() for r in sec.rows]
        ws += list(sec.weights)
        tabs.append(tab)
        off += tab.shape[0]
    return (torch.stack(rows, 1).contiguous(), torch.cat(tabs),
            torch.stack(ws, 1).contiguous())


def b10_least(secs, n, g):
    """(bytes, operations) of one B10 launch at its least: each distinct
    row and weight tensor the section list names (an eta family's grid
    and eta rows and its weights) read once, however often it is named,
    each table whole, the (G, N) output written; 2 operations per term,
    g and cell."""
    from ecrad_tpu_torch.ops import gather_interp as gi
    vecs, ntab, nterms = set(), 0, 0
    for sec in secs:
        ntab += int(np.prod(sec.table.shape))
        if isinstance(sec, gi.EtaSection):
            for fam, (gts, ets) in enumerate(zip(sec.grid_terms,
                                                 sec.eta_terms)):
                vecs |= {id(sec.grids[fam]), id(sec.etas[fam])}
                vecs |= {id(w) for _, w in gts + ets}
                nterms += len(gts) * len(ets)
        else:
            vecs |= {id(t) for t in list(sec.rows) + list(sec.weights)}
            nterms += len(sec.rows)
    return 4 * (len(vecs) * n + ntab + g * n), 2 * nterms * g * n


def rel_to_max(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def reset_counts(counters):
    for m in counters[:4]:
        m.launches = 0
    for d in counters[4:]:
        for k in d:
            d[k] = 0


def read_counts(counters):
    """Launches by kernel: counters are the taumol_lw, taumol_sw,
    random_fields and mcica_generator modules, then the other wrappers'
    dicts."""
    out = {"taumol_lw": counters[0].launches,
           "taumol_sw": counters[1].launches,
           "threefry_fields": counters[2].launches,
           "mcica_generator": counters[3].launches}
    for d in counters[4:]:
        out.update(d)
    return out


def check_generator(calls, ops_per_s):
    """The cloud generator kernel against its plain version on each
    call's arguments (GEN_CONTRACT): the worst |od_scaling difference|
    on cells cloudy in both and least_time of all the calls."""
    from ecrad_tpu_torch.ops import mcica_generator as mg
    from ecrad_tpu_torch.solvers.cloud_generator import cloud_generator_plain
    worst, ops, outs = 0.0, 0, []
    for args in calls:
        od, tcc = got = mg.generator_kernel(*args)
        torch.cuda.synchronize()
        od_ref, tcc_ref = cloud_generator_plain(*args)
        rel_bound, tcc_bound = GEN_CONTRACT[od.dtype]
        differ = int(((od > 0) != (od_ref > 0)).sum())
        both = (od > 0) & (od_ref > 0)
        diff = (od - od_ref).abs()[both]
        rel = float((diff / od_ref[both].abs()).max())
        tcc_err = float((tcc - tcc_ref).abs().max())
        log(f"mcica_generator, {od.dtype}: {tuple(od.shape)} cloudy masks "
            f"differ in {differ} cells (bound {GEN_MASK_SHARE} of "
            f"{od.numel()}), od_scaling worst rel {rel:.3e} (bound "
            f"{rel_bound}) on {int(both.sum())} cells cloudy in both, total "
            f"cover worst abs {tcc_err:.3e} (bound {tcc_bound})")
        if not (differ <= GEN_MASK_SHARE * od.numel() and rel <= rel_bound
                and tcc_err <= tcc_bound):
            raise AssertionError("mcica_generator disagrees with its plain "
                                 "version")
        worst = max(worst, float(diff.max()))
        ops += od.numel() * GEN_OPS_CELL + int((od > 0).sum()) * GEN_OPS_CLOUDY
        outs.append(got)
    return worst, least_time("mcica_generator", calls, outs, ops=ops,
                             ops_per_s=ops_per_s)


def doubling_ops(name, counts):
    """Operations of a B6/B7 launch from its per-cell doubling counts."""
    per_fallback, per_3d, per_step = SPARTACUS_OPS[name]
    c = counts.long()
    n3 = int((c >= 0).sum())
    return ((c.numel() - n3) * per_fallback + n3 * per_3d
            + int(c.clamp(min=0).sum()) * per_step)


def sweep_ops(name, cols, ng, clear_rows):
    """Operations of a B8/B9 launch: per (level, g, column), and per
    interface that mixes (the layer or the one above is cloudy)."""
    per_cell, per_mix = SPARTACUS_OPS[name]
    nlev, _, ncol = cols.shape
    mixed = ~((cols[:, clear_rows[0]] > 0.5) & (cols[:, clear_rows[1]] > 0.5))
    return ng * (nlev * ncol * per_cell + int(mixed.sum()) * per_mix)


def tc_optics_ops(args):
    """B11's operations on its arguments: OPS_PER_VALUE's 60 a cell of
    each family (the clear sky and every region: B4's 120 over its two)
    and 12 more a cloudy region cell (the mix with the cloud)."""
    od, od_scaling, cloudy = args[0], args[7], args[8]
    cells, nreg = od.numel(), od_scaling.shape[-1]
    cloudy_cells = int(cloudy.sum()) * od.shape[-1] * (nreg - 1)
    return (OPS_PER_VALUE["tc_sw_optics"] * cells * (nreg + 1)
            + 12 * cloudy_cells)


def check_aerosol(args, errs, bounds, name, ops_per_s=F32_OPS_PER_S):
    """B12 (add_aerosol_optics on CUDA operands) against its plain version
    on one call's arguments: every output bit for bit; its errs and bounds
    entries under name (output values: the (row, g) values of both
    spectra)."""
    from ecrad_tpu_torch.optics import aerosol as aerosol_module
    got = aerosol_module.add_aerosol_optics(*args)
    torch.cuda.synchronize()
    want = aerosol_module.add_aerosol_optics_plain(*args)
    differ = sum(int((a != b).sum()) for a, b in zip(got, want))
    errs[name] = max(float((a - b).abs().max()) for a, b in zip(got, want))
    bounds[name] = least_time("aerosol_optics", args, got,
                              got[0].numel() + got[3].numel(),
                              ops_per_s=ops_per_s)
    log(f"{name}: shapes {tuple(got[3].shape)} and {tuple(got[0].shape)}, "
        f"{got[0].dtype}, worst abs {errs[name]:.3e}, values differing "
        f"{differ}")
    if differ:
        raise AssertionError(f"{name} differs from its plain version")


def tc_moved_bytes(kind, args):
    """Bytes B5's design moves on this run's clear pattern, in 32-byte
    sectors of 8 columns: per level and g-point, each layer operand and
    history value of region 0 in every sector and of the cloudy regions
    only in the sectors with a cloudy column (LW: the source history also
    below a clear layer on a cloudy one or on the surface), the profiles
    written, and the per-column inputs once. Returns (bytes, the bytes of
    every region in every sector, share of the (level, sector) pairs clear
    in all 8 columns)."""
    nlev, nreg, ng, ncol = args[0].shape
    n_ops = 5 if kind == "sw" else 4
    clear = args[6]
    sect = torch.nn.functional.pad(clear, (0, (-ncol) % 8), value=True)
    sect = sect.view(nlev, -1, 8).all(2)                # (nlev, sectors)
    nsec = sect.shape[1]
    cloudy = (~sect).sum(1).double()
    every = nsec + (nreg - 1) * cloudy                  # sectors a level
    if kind == "sw":
        # 5 operands up, 4 down, 2 history values written and read
        per = 13 * every
    else:
        # 4 up, 3 down, the albedo history written and read, and the
        # source history where it is kept
        keep = ~sect
        keep[-1] = True
        keep[:-1] |= ~sect[1:]
        per = 9 * every + 2 * (nsec + (nreg - 1) * keep.sum(1).double())
    n_out = 3 if kind == "sw" else 2
    small = sum(t.numel() * t.element_size()
                for t in tensors(args[n_ops:]))
    out = 32 * ng * n_out * (nlev + 1) * nsec
    full = 32 * ng * nlev * (13 if kind == "sw" else 11) * nreg * nsec
    return (32 * ng * float(per.sum()) + out + small, full + out + small,
            float(sect.double().mean()))


def tc_random_args(kind, nreg, nlev, pattern, dev, ng=15, ncol=133,
                   seed=0):
    """Random B5 operands (tests/test_torch_kernels_gpu.py's ranges) on a
    clear pattern of TC_PATTERNS."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(  # noqa
        *s, generator=gen, device=dev)
    lev = torch.arange(nlev, device=dev)[:, None]
    col = torch.arange(ncol, device=dev)[None, :]
    clear = {"all_clear": lev + col >= 0, "all_cloudy": lev + col < 0,
             "alternating": (lev + col) % 2 == 0}[pattern]
    lay = (nlev, nreg, ng, ncol)
    v, u = r(nlev + 1, nreg, nreg, ncol), r(nlev, nreg, nreg, ncol)
    frac = r(nreg, ncol, lo=0.05, hi=0.6)
    if kind == "sw":
        return (r(*lay, hi=0.4), r(*lay, lo=0.3, hi=0.6), r(*lay, hi=0.3),
                r(*lay, hi=0.4), r(*lay, lo=0.2, hi=0.9), v, clear,
                r(ng, ncol, hi=0.8), r(ng, ncol, hi=0.8), r(ncol, lo=0.05),
                r(ng, ncol, hi=1300.0), frac)
    return (r(*lay, hi=0.3), r(*lay, lo=0.3, hi=0.6), r(*lay, hi=20.0),
            r(*lay, hi=20.0), v, u, clear, r(ng, ncol, hi=400.0),
            r(ng, ncol, hi=0.2), frac)


def tc_two_regions(kind, args):
    """B5's arguments cut to their first two regions: the layer operands,
    the overlap matrices' leading 2 x 2 and the region fractions."""
    n_ops, n_mat = (5, 1) if kind == "sw" else (4, 2)
    return (tuple(x[:, :2].contiguous() for x in args[:n_ops])
            + tuple(x[:, :2, :2].contiguous()
                    for x in args[n_ops:n_ops + n_mat])
            + args[n_ops + n_mat:-1] + (args[-1][:2].contiguous(),))


def histogram(counts):
    """'share of 3D cells; doubling count: cells' of an int8 count
    tensor (-1 where the cell took the 1D fallback)."""
    c = counts.long().flatten()
    hist = torch.bincount(c + 1).tolist()
    share = float((c >= 0).float().mean())
    return share, {k - 1: n for k, n in enumerate(hist) if n}


def check_fluxes(f, cols, ncol):
    """Finite, right shapes, and physical: TOA downwelling SW = S0 mu0,
    no SW at night, sw_dn_direct never grows downwards."""
    for k, v in f.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{k} has non-finite values")
        if v.shape[0] != ncol:
            raise AssertionError(f"{k} has shape {v.shape}")
    if f["lw_up"].shape != (ncol, NLEV + 1):
        raise AssertionError(f"lw_up shape {f['lw_up'].shape}")
    mu0 = cols["cos_sza"]
    toa_err = np.abs(f["sw_dn"][:, 0] - cols["solar_irradiance"]
                     * np.maximum(mu0, 0.0)).max()
    night = mu0 <= 0.0
    night_max = max(np.abs(f[k][night]).max() for k in ("sw_up", "sw_dn",
                                                          "sw_dn_direct"))
    rise = np.diff(f["sw_dn_direct"][~night], axis=1).max()
    log(f"physical: TOA sw_dn - S0 cos_sza max abs {toa_err:.3e} W/m2; "
        f"{night.sum()} night columns, max |SW| there {night_max}; max "
        f"downward step of sw_dn_direct {rise:.3e} W/m2")
    if not (toa_err <= 1e-5 * cols["solar_irradiance"]
            and night_max == 0.0 and rise <= 1e-3):
        raise AssertionError("fluxes are not physical")


def host_arrays(cols):
    """coupling.radiation_scheme's arguments from columns with clouds:
    water vapour and ozone from the columns, latitudes from pole to pole,
    land and sea in turn."""
    from ecrad_tpu_torch.constants import GAS_INDEX
    ncol = cols["cos_sza"].shape[0]
    return dict(
        pressure_hl=cols["pressure_hl"], temperature_hl=cols["temperature_hl"],
        cos_sza=cols["cos_sza"], skin_temperature=cols["skin_temperature"],
        sw_albedo=cols["sw_albedo"], lw_emissivity=cols["lw_emissivity"],
        q=cols["mixing_ratio"][:, :, GAS_INDEX["h2o"]],
        o3_mmr=cols["mixing_ratio"][:, :, GAS_INDEX["o3"]],
        q_liq=cols["q_liq"], q_ice=cols["q_ice"], cloud_frac=cols["fraction"],
        sin_latitude=np.linspace(-0.99, 0.99, ncol),
        land_frac=np.arange(ncol) % 2 * 1.0,
        solar_irradiance=float(cols["solar_irradiance"]))


def path_ms(fn, reps=3):
    """Host milliseconds per call of fn(), best of 2 x reps back-to-back
    calls ending in a synchronise."""
    best = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        best.append((time.perf_counter() - t0) / reps)
    return min(best) * 1e3


def check_profiles(f, what):
    """Every band or g-point profile, total and clear sky, summed over its
    last axis: the broadband profile, within PROFILE_REL of its largest
    value."""
    worst = 0.0
    for k in PROFILES + tuple(p + "_clear" for p in PROFILES):
        band = k.replace("_clear", "_band_clear") if "clear" in k \
            else k + "_band"
        err = np.abs(f[band].sum(-1) - f[k]).max() / np.abs(f[k]).max()
        worst = max(worst, err)
        if not err <= PROFILE_REL:
            raise AssertionError(f"{what}: {band} summed is {err:.3e} of "
                                 f"{k}'s largest value from it")
    log(f"{what}: the 10 profiles of {f['lw_up_band'].shape[-1]} (LW) and "
        f"{f['sw_up_band'].shape[-1]} (SW) summed: worst {worst:.3e} of "
        f"the broadband's largest value (bound {PROFILE_REL})")


def check_golden(f, golden, fields, bounds, rows=slice(None), f64=True,
                 what="", jax_slack=False):
    """Each field's first 32 columns within its bound of the golden's JAX
    float32 and float64 values. With jax_slack the float32 bound also
    holds the JAX package's own float32 error on those columns (its
    distance from its float64 value): the bound is a float32-vs-float64
    contract, and a float32 program can only be held to another one
    within the sum of their errors."""
    for k in fields:
        bound = bounds.get(k, bounds.get(k.replace("_clear", "")))
        slack = (float(np.abs(golden[k] - golden[k + "_f64"])[rows].max())
                 if jax_slack else 0.0)
        e32 = float(np.abs(f[k][:32][rows] - golden[k][rows]).max())
        e64 = (float(np.abs(f[k][:32][rows] - golden[k + "_f64"][rows])
                     .max()) if f64 else None)
        log(f"golden{what} {k}: vs JAX float32 {e32:.3e}"
            + (f" (JAX float32 vs float64 {slack:.3e})" if jax_slack else "")
            + (f", vs JAX float64 {e64:.3e}" if f64 else "")
            + f" (bound {bound}, {max(e32 - slack, e64 or 0.0) / bound:.1%}"
            f" used)")
        if not (e32 <= bound + slack and (e64 is None or e64 <= bound)):
            raise AssertionError(f"{k} outside its golden bound")


def check_golden_rel(f, golden, fields, rel, what=""):
    """Each field's first 32 columns within rel of the golden's largest
    JAX float64 value, against JAX float64, and against JAX float32 with
    the JAX package's own float32 error added (check_golden's rule)."""
    for k in fields:
        bound = rel * float(np.abs(golden[k + "_f64"]).max())
        slack = float(np.abs(golden[k] - golden[k + "_f64"]).max())
        e32 = float(np.abs(f[k][:32] - golden[k]).max())
        e64 = float(np.abs(f[k][:32] - golden[k + "_f64"]).max())
        log(f"golden{what} {k}: vs JAX float32 {e32:.3e} (JAX float32 vs "
            f"float64 {slack:.3e}), vs JAX float64 {e64:.3e} (bound "
            f"{bound:.3e}: {rel} of the largest value)")
        if not (e32 <= bound + slack and e64 <= bound):
            raise AssertionError(f"{k} outside its golden bound")


def check_surface_file(sf, ff, what):
    """The facet fields finite; the flat tile's ground facet (facet 0)
    sees the atmosphere's surface fluxes (tests/test_surface.py:164-171);
    no facet reflects more SW than it receives."""
    for k, v in sf.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{what}: {k} has non-finite values")
    flat = max(float(np.abs(sf[f"flux_dn_{r}_facet"][:, 0]
                            / np.maximum(np.abs(ff[f"flux_dn_{r}"][:, -1]),
                                         1e-30) - 1.0)
                     [np.abs(ff[f"flux_dn_{r}"][:, -1]) > 0].max())
               for r in ("sw", "lw"))
    excess = float((sf["flux_up_sw_facet"] - sf["flux_dn_sw_facet"]).max())
    log(f"{what}: {len(sf)} surface variables {sorted(sf)}, shapes "
        f"{sorted({v.shape for v in sf.values()})}; flat facet against the "
        f"surface sw_dn/lw_dn: worst relative {flat:.3e} (bound 1e-5); "
        f"largest sw_up - sw_dn of a facet {excess:.3e} W/m2 (bound 1e-3)")
    if not (flat <= 1e-5 and excess <= 1e-3):
        raise AssertionError(f"{what}: the facet fluxes are not physical")


def cloud_effect(f, name):
    cloudy = (f["cloud_cover_lw"] > 0.5).sum()
    log(f"{name}: {cloudy} of {len(f['lw_up'])} columns with LW cloud "
        f"cover > 0.5; TOA sw_up total - clear mean "
        f"{(f['sw_up'][:, 0] - f['sw_up_clear'][:, 0]).mean():.3f} W/m2, "
        f"lw_up {(f['lw_up'][:, 0] - f['lw_up_clear'][:, 0]).mean():.3f}")


def random_reftrans_case(nreg, dev, nlev=7, ng=16, ncol=133, seed=7,
                         share3d=None):
    """B6 and B7's arguments on random inputs built like
    tools/check_kernel_equivalence.py:143-163: mu0 at the 1e-10 clamp in
    every 17th column, clear layers, and a level with no 3D cell, or else
    each cell 3D with probability share3d; and B8's per-column rows and
    boundary values (random), and B9's."""
    from ecrad_tpu_torch.ops import spartacus_adding as sa
    rng = np.random.RandomState(seed)
    r = lambda *s, lo=0.0, hi=1.0: torch.as_tensor(
        (lo + (hi - lo) * rng.rand(*s)).astype(np.float32), device=dev)
    od, ssa = r(nlev, nreg, ng, ncol, hi=6.0), r(nlev, nreg, ng, ncol,
                                                   lo=0.05, hi=0.999)
    g = r(nlev, nreg, ng, ncol, hi=0.8)
    trd, trf = r(nlev, nreg, nreg, ncol, hi=0.5), r(nlev, nreg, nreg, ncol,
                                                    hi=0.5)
    mu0 = (0.05 + 0.95 * rng.rand(ncol)).astype(np.float32)
    mu0[::17] = 1e-10
    u = rng.rand(nlev, ng, ncol)
    if share3d is None:
        use3d = u > 0.4
        use3d[0] = False
    else:
        use3d = u < share3d
    use3d = torch.as_tensor(use3d, device=dev)
    clear = torch.as_tensor(rng.rand(nlev, ncol) > 0.7, device=dev)
    se, pt, pb = (r(nlev, ng, ncol, lo=0.5, hi=1.0), r(nlev, ng, ncol,
                                                       hi=40.0),
                  r(nlev, ng, ncol, hi=40.0))
    fr = r(nlev, nreg, ncol)
    um, vm = r(nlev + 1, nreg, nreg, ncol), r(nlev + 1, nreg, nreg, ncol)
    cols = sa.pack_cols(
        um, vm, r(nlev, ncol), r(nlev, ncol, hi=500), r(nlev, ncol, hi=300),
        r(nlev, ncol, hi=300), r(nlev, 3, ncol, hi=1e-3),
        r(nlev, ncol, hi=1e-3), r(nlev, ncol), r(nlev, nreg, ncol),
        r(nlev, nreg, ncol), clear, torch.roll(clear, 1, 0),
        torch.roll(clear, -1, 0), r(ncol))
    return {"sw": (8.0, od, ssa, g, trd, trf, torch.as_tensor(mu0,
                                                              device=dev),
                   use3d, clear),
            "lw": (8.0, True, od, ssa, g, trd, se, pt, pb, fr, use3d,
                   clear),
            "sweep": (cols, r(2 * nreg * nreg, ng, ncol, hi=0.3),
                      r(nreg, ng, ncol, hi=100.0)),
            # B9's per-column rows and a full random albedo matrix and
            # source at the surface
            "lsweep": (sa.lw_pack_cols(um, vm, clear, torch.roll(clear, 1, 0),
                                       torch.roll(clear, -1, 0)),
                       torch.cat([r(nreg * nreg, ng, ncol, hi=0.2),
                                  r(nreg, ng, ncol, hi=50.0)]))}


def sw_generators(ng, ncol, seed):
    """M (6, 6), C (6, 3) and D (3, 3) blocks, (.., ng, ncol) float64 on
    the CPU, of 3-region SPARTACUS SW layer generators built like
    tests/test_torch_matrix.py's: od gamma1 plus the lateral exchange on
    the diffuse diagonals, od gamma2 across, the direct beam's
    extinction and exchange in D; optical depths from 0.01 to 40, so the
    Pade-7 squaring counts run from 0 to 5."""
    rng = np.random.RandomState(seed)
    n, batch = 3, (ng, ncol)
    u = lambda lo, hi, shape=(n,) + batch: rng.uniform(lo, hi, shape)
    od = np.exp(u(np.log(0.01), np.log(40.0)))
    ssa = u(0.0, 0.9)
    A, B = np.zeros((n, n) + batch), np.zeros((n, n) + batch)
    for r in range(n):
        A[r, r] = od[r] * (1.66 - 0.83 * ssa[r] * 1.8)
        B[r, r] = od[r] * 0.83 * ssa[r] * 0.2
    for r in range(n - 1):
        t1, t2 = u(0, 3, (2,) + batch)
        A[r, r] += t1
        A[r + 1, r] -= t1
        A[r + 1, r + 1] += t2
        A[r, r + 1] -= t2
    M = np.concatenate([np.concatenate([A, -B], 1),
                        np.concatenate([B, -A], 1)], 0)
    od = np.exp(u(np.log(0.01), np.log(20.0)))
    C, D = np.zeros((2 * n, n) + batch), np.zeros((n, n) + batch)
    for r in range(n):
        C[r, r] = -od[r] * 0.3
        C[n + r, r] = od[r] * 0.5
        D[r, r] = -np.minimum(od[r] / u(0.05, 1.0, batch), 60.0)
    for r in range(n - 1):
        t = u(0, 2, batch)
        D[r, r] -= t
        D[r + 1, r] += t
    return tuple(torch.as_tensor(x) for x in (M, C, D))


def trace_kernels_in_span(logdir, span, kernels):
    """Read the one torch.profiler trace under logdir: (the host spans
    named `span`, {kernel name fragment: (launches, of them launched
    inside a host span, of them run inside the span's device range)},
    the events' categories).
    A launch is the runtime or driver call with the kernel's correlation
    id; the device range is the profiler's gpu_user_annotation."""
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{len(files)} trace files under {logdir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    within = lambda a, b, spans: any(s <= a and b <= e for s, e in spans)
    host = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == span and e.get("cat") == "user_annotation"]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == span
              and e.get("cat") == "gpu_user_annotation"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {}
    for frag in kernels:
        ks = [e for e in events if e.get("cat") == "kernel"
              and frag in e.get("name", "")]
        at = [launch.get(k.get("args", {}).get("correlation")) for k in ks]
        out[frag] = (len(ks),
                     sum(t is not None and within(t, t, host) for t in at),
                     sum(within(k["ts"], k["ts"] + k["dur"], device)
                         for k in ks))
    return host, out, sorted({str(e.get("cat")) for e in events})


def main():
    if not torch.cuda.is_available():
        log("no CUDA device: this script runs the port on a GPU only")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the paths take the all-band gas optics unless a run sets this
    os.environ.pop("ECRAD_FUSED_TAUMOL", None)

    from ecrad_tpu_torch import driver
    from ecrad_tpu_torch.config import (Entrapment, Overlap, PdfShape,
                                        Solver, cloudless_slice_config,
                                        load_config_from_namelist,
                                        load_driver_config_from_namelist,
                                        mcica_slice_config,
                                        spartacus_slice_config,
                                        tripleclouds_slice_config)
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                        make_clouds, make_columns,
                                        slice_columns, write_synthetic_luts)
    from ecrad_tpu_torch import interface
    from ecrad_tpu_torch.interface import (_cloud_stage, get_albedos,
                                           radiation, setup_radiation)
    from ecrad_tpu_torch.io.input_reader import read_input
    from ecrad_tpu_torch.io.output import save_fluxes, save_inputs
    from ecrad_tpu_torch.ops import _cuda, adding_fused, mcica_optics
    from ecrad_tpu_torch.ops import gather_interp as gi
    from ecrad_tpu_torch.ops import mcica_generator as mg
    from ecrad_tpu_torch.ops import random_fields as rf
    from ecrad_tpu_torch.ops import spartacus_adding as sa
    from ecrad_tpu_torch.ops import spartacus_reftrans as sr
    from ecrad_tpu_torch.ops import aerosol_optics, tc_optics
    from ecrad_tpu_torch.optics import aerosol as aerosol_module
    from ecrad_tpu_torch.optics.rrtmg import (taumol_lw, taumol_lw_sections,
                                              taumol_sw, taumol_sw_sections)
    from ecrad_tpu_torch.optics.rrtmg.gas_optics import gas_optics
    from ecrad_tpu_torch.optics.rrtmg.setcoef import prepare_gases, setcoef
    from ecrad_tpu_torch.solvers import (adding, cloudless, spartacus_lw,
                                         spartacus_sw, tripleclouds)
    from ecrad_tpu_torch.solvers import two_stream as ts
    from ecrad_tpu_torch.solvers.cloud_generator import (
        cloud_generator, cloud_generator_plain)

    dev = torch.device("cuda", 0)
    gpu = card()
    # ---- 1. device and build ----
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
        f", count {torch.cuda.device_count()}")
    log(f"card: {gpu}")
    t0 = time.perf_counter()
    lib = _cuda.build()
    log(f"built {os.path.relpath(lib, REPO)} from "
        f"{[os.path.relpath(s, REPO) for s in _cuda.sources()]} in "
        f"{time.perf_counter() - t0:.1f} s with nvcc {' '.join(_cuda.NVCC_FLAGS)}")
    for line in _cuda.build_log.splitlines():
        if "spill" in line or ("ptxas info" in line and (
                "Used" in line or "Compiling" in line)):
            log("  " + line.strip())
    report = _cuda.ptxas_report()
    # (what, info query and its arguments before nreg, the kernel's
    # mangled name), the float forms and the double ones (the scalar type
    # the templates' last argument, f or d)
    for what, name, args, kernel in ((what + t, name + q, args, kernel + c)
                                     for t, q, c in (("", "", "fE"),
                                                     (", float64", "_f64",
                                                      "dE"))
                                     for what, name, args, kernel in (
            ("B6 pass 1, 3D cells", "spartacus_sw_reftrans_info", (1,),
             "sw_3d_kernelILi{}E"),
            ("B6 pass 2, every cell", "spartacus_sw_reftrans_info", (0,),
             "sw_fallback_kernelILi{}E"),
            ("B7 pass 1, 3D cells", "spartacus_lw_reftrans_info", (1,),
             "lw_3d_kernelILi{}E"),
            ("B7 pass 2, every cell", "spartacus_lw_reftrans_info", (0,),
             "lw_fallback_kernelILi{}E"),
            ("B8", "spartacus_sw_adding_info", (), "sw_adding_kernelILi{}E"),
            ("B9, multilayer off", "spartacus_lw_adding_info", (0,),
             "lw_adding_kernelILi{}ELb0E"),
            ("B9, multilayer on", "spartacus_lw_adding_info", (1,),
             "lw_adding_kernelILi{}ELb1E"))):
        for nreg in (3, 2):
            k = _cuda.kernel_info(name, *args, nreg)
            rep = [v for f, v in report.items() if kernel.format(nreg) in f]
            rep = rep[0] if len(rep) == 1 else {}
            warps = k["blocks_per_sm"] * k["threads"] // 32
            log(f"  {what}, {nreg} regions: {k['registers']} registers, "
                f"{k['local_bytes']} B local per thread (stack "
                f"{rep.get('stack')} B, spill stores {rep.get('spill_stores')}"
                f" B, loads {rep.get('spill_loads')} B), shared "
                f"{k['static_smem']} B static + {k['dynamic_smem']} B "
                f"dynamic per block; {k['threads']} threads x "
                f"{k['blocks_per_sm']} blocks = {warps} warps per SM of 64"
                + (f"; persistent grid {k['blocks_per_sm'] * k['sms']} "
                   f"blocks" if "3D cells" in what else ""))
            if k["blocks_per_sm"] < 1:
                raise AssertionError(f"{what} cannot be resident on an SM")

    # B1 and B3/B3': (what, info query and its arguments, the kernel's
    # mangled name); the adding sweeps at the path's 137 levels, all on
    # chip, and at ADD_SPILL_NLEV, the top levels in device memory
    for what, name, args, kernel in (
            ("B1 taumol_lw", "taumol_lw_info", (), "taumol_lw_kernelIf"),
            ("B3 sw_adding, 137 levels", "level_sweep_info", (0, NLEV),
             "sw_adding_kernelIfLb0E"),
            (f"B3 sw_adding, {ADD_SPILL_NLEV} levels", "level_sweep_info",
             (0, ADD_SPILL_NLEV), "sw_adding_kernelIfLb1E"),
            ("B3' lw_adding, 137 levels", "level_sweep_info", (1, NLEV),
             "lw_adding_kernelIfLb0E"),
            (f"B3' lw_adding, {ADD_SPILL_NLEV} levels", "level_sweep_info",
             (1, ADD_SPILL_NLEV), "lw_adding_kernelIfLb1E"),
            ("B3 lw_noscat", "level_sweep_info", (2, NLEV),
             "lw_noscat_kernelIf"),
            ("B2 taumol_sw", "taumol_sw_info", (), "taumol_sw_kernelIf"),
            ("B4 mcica_sw_optics", "mcica_optics_info", (0,),
             "mcica_sw_optics_kernelIf"),
            ("B11 tc_sw_optics", "tc_sw_optics_info", (),
             "tc_sw_optics_kernel"),
            ("B12 aerosol_optics", "aerosol_optics_info", (0,),
             "aerosol_optics_kernelIfLi4E"),
            ("B12 aerosol_optics, float64", "aerosol_optics_info", (1,),
             "aerosol_optics_kernelIdLi2E"),
            # the double forms: B3' lw_adding's window is under 137 levels
            ("B1 taumol_lw, float64", "taumol_lw_info_f64", (),
             "taumol_lw_kernelId"),
            ("B2 taumol_sw, float64", "taumol_sw_info_f64", (),
             "taumol_sw_kernelId"),
            ("B3 sw_adding, float64, 137 levels", "level_sweep_info_f64",
             (0, NLEV), "sw_adding_kernelIdLb0E"),
            ("B3' lw_adding, float64, 137 levels", "level_sweep_info_f64",
             (1, NLEV), "lw_adding_kernelIdLb1E"),
            ("B3 lw_noscat, float64", "level_sweep_info_f64", (2, NLEV),
             "lw_noscat_kernelId"),
            ("B4 mcica_sw_optics, float64", "mcica_optics_info", (2,),
             "mcica_sw_optics_kernelId"),
            ("threefry_fields, float32", "threefry_fields_info", (0,),
             "threefry_fields_kernelIfi"),
            ("threefry_fields, float64", "threefry_fields_info", (1,),
             "threefry_fields_kernelIdi"),
            *((f"mcica_generator, {t}, {ng} g-points",
               "mcica_generator_info", (f64, NLEV, ng),
               f"mcica_generator_kernelI{c}E")
              for t, f64, c in (("float32", 0, "f"), ("float64", 1, "d"))
              for ng, _ in GENERATOR_CALLS),
            *((f"B5 tc_{k}_sweeps, {nreg} regions, {nlev} levels",
               "tc_sweeps_info", (int(k == "lw"), nreg, nlev),
               f"tc_{k}_kernelILi{nreg}ELb1E")
              for k in ("sw", "lw") for nreg in (3, 2)
              for nlev in (NLEV, ADD_SPILL_NLEV))):
        k = _cuda.kernel_info(name, *args)
        rep = [v for f, v in report.items() if kernel in f]
        rep = rep[0] if len(rep) == 1 else {}
        warps = k["blocks_per_sm"] * k["threads"] // 32
        log(f"  {what}: {k['registers']} registers, {k['local_bytes']} B "
            f"local per thread (stack {rep.get('stack')} B, spill stores "
            f"{rep.get('spill_stores')} B, loads {rep.get('spill_loads')} B)"
            f", shared {k['static_smem']} B static + {k['dynamic_smem']} B "
            f"dynamic per block; {k['threads']} threads x "
            f"{k['blocks_per_sm']} blocks = {warps} warps per SM of 64")
        if k["blocks_per_sm"] < 1:
            raise AssertionError(f"{what} cannot be resident on an SM")
        # the double forms of B1-B3 and the random fields keep every value
        # in registers
        if ", float64" in what and what.startswith(("B1", "B2", "B3",
                                                     "threefry")) and (
                rep.get("spill_stores") != 0 or rep.get("spill_loads") != 0):
            raise AssertionError(f"{what} spills")

    setup = setup_radiation(cloudless_slice_config(), device=dev)
    cols = make_columns(NCOL, NLEV, SEED)
    sl, th, gas = columns_to_inputs(cols, device=dev)
    luts = write_synthetic_luts(LUT_DIR, SEED)
    setup_m = setup_radiation(mcica_slice_config(**luts), device=dev)
    cols_m = make_clouds(cols, SEED)
    inputs_m = columns_to_inputs(cols_m, device=dev)
    luts_fu = write_synthetic_luts(LUT_DIR, SEED, ice="fu")
    setup_t = setup_radiation(tripleclouds_slice_config(**luts_fu),
                              device=dev)
    cols_t = make_aerosols(cols_m, SEED)
    inputs_t = columns_to_inputs(cols_t, device=dev)
    setup_sp = setup_radiation(spartacus_slice_config(**luts_fu), device=dev)
    cols_sp = add_effective_sizes(cols_t)
    inputs_sp = columns_to_inputs(cols_sp, device=dev)

    # ---- 2. kernels against their plain versions, the paths' shapes ----
    t = setup.tables
    phl, thl = th.pressure_hl, th.temperature_hl
    gc = prepare_gases(phl, 0.5 * (phl[:, :-1] + phl[:, 1:]),
                       0.5 * (thl[:, :-1] + thl[:, 1:]),
                       *[gas.get(n) for n in ("h2o", "co2", "ch4", "n2o",
                                              "cfc11", "cfc12", "hcfc22",
                                              "ccl4", "o3")])
    c_sf = setcoef(gc, setup.gas.preflog, setup.gas.tref, setup.gas.chi_mls)
    c = c_sf.flip_levels()
    fc_lw, ic_lw = taumol_lw.pack_coeffs(c, setup.gas.chi_mls)
    fc_sw, ic_sw = taumol_sw.pack_coeffs(c)
    errs, bounds = {}, {}

    def taumol_check(name, kern, plain, fc, ic, tables, second):
        a1, a2 = kern(fc, ic, tables)
        torch.cuda.synchronize()
        b1, b2 = plain(fc, ic, tables)
        mask = b1.abs() > 1e-6
        rel = float(((a1 - b1).abs() / b1.abs().clamp(min=1e-30))[mask]
                    .max())
        err2 = float((a2 - b2).abs().max())
        ok2 = err2 <= (PF_ATOL if second == "pfrac"
                       else TAU_REL * float(b2.abs().max()))
        log(f"{name}: N={fc.shape[1]} worst rel {rel:.3e} (bound "
            f"{TAU_REL}, |x|>1e-6), {second} worst abs {err2:.3e}, "
            f"worst abs {float((a1 - b1).abs().max()):.3e}")
        if not (rel <= TAU_REL and ok2):
            raise AssertionError(f"{name} disagrees with its plain version")
        errs[name] = max(float((a1 - b1).abs().max()), err2)
        bounds[name] = least_time(name, (fc, ic, tables), (a1, a2),
                                  a1.numel())
        return err2

    taumol_check("taumol_lw", taumol_lw.taumol_lw_kernel,
                 taumol_lw.taumol_lw_plain, fc_lw, ic_lw, setup.gas.lw,
                 "pfrac")
    if taumol_check("taumol_sw", taumol_sw.taumol_sw_kernel,
                    taumol_sw.taumol_sw_plain, fc_sw, ic_sw, setup.gas.sw,
                    "taur") != 0.0:
        raise AssertionError("taumol_sw: taur differs from its plain "
                             "version")
    # B1 on 1, 137 and 4,099 cells (no multiple of its 32-cell tile) and on
    # the path's tropospheric and stratospheric cells apart
    tropo = fc_lw[0] > 0
    for what, sel in (("1 cell", slice(0, 1)), ("137 cells", slice(0, 137)),
                      ("4099 cells", slice(0, 4099)),
                      ("the tropospheric cells", tropo),
                      ("the stratospheric cells", ~tropo)):
        f_, i_ = fc_lw[:, sel].contiguous(), ic_lw[:, sel].contiguous()
        a1, a2 = taumol_lw.taumol_lw_kernel(f_, i_, setup.gas.lw)
        torch.cuda.synchronize()
        b1, b2 = taumol_lw.taumol_lw_plain(f_, i_, setup.gas.lw)
        mask = b1.abs() > 1e-6
        rel = float(((a1 - b1).abs() / b1.abs().clamp(min=1e-30))[mask]
                    .max()) if bool(mask.any()) else 0.0
        err2 = float((a2 - b2).abs().max())
        log(f"taumol_lw on {what} (N={f_.shape[1]}): worst rel {rel:.3e}, "
            f"pfrac worst abs {err2:.3e}")
        if not (rel <= TAU_REL and err2 <= PF_ATOL):
            raise AssertionError(f"taumol_lw disagrees on {what}")
    # B2 likewise on 1, 31, 33 and 4,099 cells and on the tropospheric and
    # stratospheric cells apart; taur at 0 difference
    tropo = fc_sw[0] > 0
    for what, sel in (("1 cell", slice(0, 1)), ("31 cells", slice(0, 31)),
                      ("33 cells", slice(0, 33)),
                      ("4099 cells", slice(0, 4099)),
                      ("the tropospheric cells", tropo),
                      ("the stratospheric cells", ~tropo)):
        f_, i_ = fc_sw[:, sel].contiguous(), ic_sw[:, sel].contiguous()
        a1, a2 = taumol_sw.taumol_sw_kernel(f_, i_, setup.gas.sw)
        torch.cuda.synchronize()
        b1, b2 = taumol_sw.taumol_sw_plain(f_, i_, setup.gas.sw)
        mask = b1.abs() > 1e-6
        rel = float(((a1 - b1).abs() / b1.abs().clamp(min=1e-30))[mask]
                    .max()) if bool(mask.any()) else 0.0
        err2 = float((a2 - b2).abs().max())
        log(f"taumol_sw on {what} (N={f_.shape[1]}): worst rel {rel:.3e}, "
            f"taur worst abs {err2:.3e}")
        if not (rel <= TAU_REL and err2 == 0.0):
            raise AssertionError(f"taumol_sw disagrees on {what}")
    del tropo, f_, i_, a1, a2, b1, b2

    # the operands as the paths make them: gas optics of the columns,
    # and for McICA the cloud stage and the cloud generator
    sw_d, sw_dir, lw_alb = get_albedos(setup, sl)
    go = gas_optics(phl, thl, gas.mixing_ratio, sl.skin_temperature,
                    sl.cos_sza, sl.solar_irradiance, setup.maps, setup.gas,
                    lw_albedo=lw_alb)
    planck = cloudless._gf(go.planck_hl)
    lw_args = ts.lw_no_scattering_transmittance(
        cloudless._gf(go.od_lw), planck[:-1], planck[1:]) + (
        go.lw_emission.T.contiguous(), lw_alb.T.contiguous())
    mu0 = torch.clamp(sl.cos_sza, min=1e-10)
    od_g, ssa_g = cloudless._gf(go.od_sw), cloudless._gf(go.ssa_sw)
    g1, g2, g3 = ts.sw_gammas(mu0[None], ssa_g, torch.zeros_like(od_g))
    sw_args = ts.sw_reftrans(mu0[None], od_g, ssa_g, g1, g2, g3) + (
        go.incoming_sw.T.contiguous(), sw_d.T.contiguous(),
        sw_dir.T.contiguous(), mu0.contiguous())

    cfg_m = setup_m.config
    cast = lambda x: None if x is None else x.to(dev, torch.float32)
    cloud_m, props = _cloud_stage(setup_m, th, inputs_m[3], cast)

    def od_scaling(ng, offset):
        return cloud_generator(
            ng, inputs_m[0].iseed + offset, cfg_m.i_overlap_scheme,
            cfg_m.cloud_fraction_threshold, cloud_m.fraction,
            cloud_m.overlap_param, cfg_m.cloud_inhom_decorr_scaling,
            cloud_m.fractional_std, setup_m.pdf_sampler,
            table=setup_m.pdf_table)[0]

    frac_mask = cloud_m.fraction >= cfg_m.cloud_fraction_threshold
    zeros_sw = torch.zeros_like(go.od_sw)
    b4_sw_args = (go.od_sw.contiguous(), go.ssa_sw.contiguous(), zeros_sw,
                  *props[3:], setup.maps.band_sw32, od_scaling(112, 0),
                  frac_mask, sl.cos_sza, False)
    osc_lw = od_scaling(140, 997)
    b4_lw_args = (go.od_lw.contiguous(), props[0],
                  setup.maps.band_lw32, osc_lw, frac_mask,
                  go.planck_hl.contiguous())
    # B3' on the McICA total sky's layers: clear values outside clouds
    from ecrad_tpu_torch.optics.combine import combine_cloud_gas_lw
    zeros_lw = torch.zeros_like(go.od_lw)
    od_t, ssa_t, g_t = combine_cloud_gas_lw(
        go.od_lw, zeros_lw, zeros_lw, *props[:3], setup.maps.band_lw,
        True, od_scaling=osc_lw, cloud_mask=frac_mask[..., None])
    lwadd_args = ts.lw_reftrans(
        cloudless._gf(od_t), *ts.lw_gammas(cloudless._gf(ssa_t),
                                           cloudless._gf(g_t)),
        planck[:-1], planck[1:]) + lw_args[3:]

    # B5 on the operands the Tripleclouds path hands it: one run with the
    # sweeps' arguments kept (its launches are not counted, see phase 3);
    # B6-B9 below likewise on the SPARTACUS path's
    path_args = {}

    def keep(name, fn):
        def wrapped(*args):
            path_args[name] = args
            return fn(*args)
        return wrapped
    sweeps = (tripleclouds.tc_sw_sweeps, tripleclouds.tc_lw_sweeps,
              tripleclouds._region_props_sw_g)
    tripleclouds.tc_sw_sweeps = keep("tc_sw_sweeps", sweeps[0])
    tripleclouds.tc_lw_sweeps = keep("tc_lw_sweeps", sweeps[1])
    tripleclouds._region_props_sw_g = keep("tc_sw_optics", sweeps[2])
    add_aerosol = interface.add_aerosol_optics
    interface.add_aerosol_optics = keep("aerosol_optics", add_aerosol)
    radiation(setup_t, *inputs_t)
    (tripleclouds.tc_sw_sweeps, tripleclouds.tc_lw_sweeps,
     tripleclouds._region_props_sw_g) = sweeps
    interface.add_aerosol_optics = add_aerosol
    sp_fns = [(mod, name, getattr(mod, name)) for mod, name in (
        (spartacus_sw, "sw_reftrans_levels"),
        (spartacus_sw, "sw_adding_sweeps"),
        (spartacus_lw, "lw_reftrans_levels"),
        (spartacus_lw, "lw_adding_sweeps"))]
    for mod, name, fn in sp_fns:
        setattr(mod, name, keep(name, fn))
    radiation(setup_sp, *inputs_sp)
    for mod, name, fn in sp_fns:
        setattr(mod, name, fn)

    for name, kern, plain, args, bound in (
            ("sw_adding", adding_fused.adding_sw_fused,
             adding.adding_sw_plain, sw_args, SWEEP_REL),
            ("lw_noscat", adding_fused.lw_noscat_fused,
             adding.lw_no_scattering_fluxes_plain, lw_args, SWEEP_REL),
            ("lw_adding", adding_fused.adding_lw_fused,
             adding.adding_lw_plain, lwadd_args, SWEEP_REL),
            ("mcica_sw_optics", mcica_optics.mcica_sw_optics_fused,
             mcica_optics.sw_clear_total_reftrans_plain, b4_sw_args,
             OPTICS_REL["mcica_sw_optics"]),
            ("mcica_lw_optics", mcica_optics.mcica_lw_optics_fused,
             mcica_optics.lw_clear_total_noscat_plain, b4_lw_args,
             OPTICS_REL["mcica_lw_optics"]),
            ("tc_sw_sweeps", adding_fused.tc_sw_sweeps_fused,
             tripleclouds.tc_sw_sweeps_plain, path_args["tc_sw_sweeps"],
             SWEEP_REL),
            ("tc_lw_sweeps", adding_fused.tc_lw_sweeps_fused,
             tripleclouds.tc_lw_sweeps_plain, path_args["tc_lw_sweeps"],
             SWEEP_REL)):
        a = kern(*args)
        torch.cuda.synchronize()
        b = plain(*args)
        rel = max(rel_to_max(x, y) for x, y in zip(a, b))
        errs[name] = max(float((x - y).abs().max()) for x, y in zip(a, b))
        # output values: one per element of the first operand, (cell, g)
        # for B4, (level, [region,] g, column) for the sweeps
        bounds[name] = least_time(name, args, a, args[0].numel())
        log(f"{name}: shape {tuple(args[0].shape)} worst |diff|/max|plain| "
            f"{rel:.3e} (bound {bound}), worst abs {errs[name]:.3e}")
        if not rel <= bound:
            raise AssertionError(f"{name} disagrees with its plain version")
        # the adding sweeps keep their plain versions' operation order
        if name in ADDING and errs[name] != 0.0:
            raise AssertionError(f"{name} differs from its plain version")
    # B11 on the operands the Tripleclouds path hands it: both families
    # (5 region and 5 clear-sky outputs) bit for bit, the resonance
    # window's cells included
    b11_args = path_args["tc_sw_optics"]
    a = tc_optics.tc_sw_optics_fused(*b11_args)
    torch.cuda.synchronize()
    b = tc_optics.tc_sw_optics_plain(*b11_args)
    a, b = (*a[0], *a[1]), (*b[0], *b[1])
    errs["tc_sw_optics"] = max(float((x - y).abs().max())
                               for x, y in zip(a, b))
    bounds["tc_sw_optics"] = least_time(
        "tc_sw_optics", b11_args, a, ops=tc_optics_ops(b11_args))
    log(f"tc_sw_optics: shapes {tuple(a[0].shape)} and {tuple(a[5].shape)},"
        f" worst abs {errs['tc_sw_optics']:.3e}, cells differing "
        f"{sum(int((x != y).sum()) for x, y in zip(a, b))}")
    if errs["tc_sw_optics"] != 0.0:
        raise AssertionError("tc_sw_optics differs from its plain version")
    del a, b
    # B12 on the operands the Tripleclouds path hands add_aerosol_optics
    # (2048 x 137, 12 types, the saturation computed): its six outputs
    # bit for bit
    check_aerosol(path_args["aerosol_optics"], errs, bounds, "aerosol_optics")
    # B3 sw_adding and B3' lw_adding with 1, 2, 137 and ADD_SPILL_NLEV
    # levels on 15 g x 133 columns (no multiple of their 32-thread
    # blocks): equal to their plain versions bit for bit
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s, lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(  # noqa
        *s, generator=gen, device=dev)
    for nlev in (1, 2, NLEV, ADD_SPILL_NLEV):
        for name, kern, plain, args in (
                ("sw_adding", adding_fused.adding_sw_fused,
                 adding.adding_sw_plain,
                 (rnd(nlev, 15, 133, hi=0.4), rnd(nlev, 15, 133, lo=0.3,
                                                  hi=0.6),
                  rnd(nlev, 15, 133, hi=0.3), rnd(nlev, 15, 133, hi=0.4),
                  rnd(nlev, 15, 133, lo=0.2, hi=0.9),
                  rnd(15, 133, hi=1300.0), rnd(15, 133, hi=0.8),
                  rnd(15, 133, hi=0.8), rnd(133, lo=0.05))),
                ("lw_adding", adding_fused.adding_lw_fused,
                 adding.adding_lw_plain,
                 (rnd(nlev, 15, 133, hi=0.3), rnd(nlev, 15, 133, lo=0.2,
                                                  hi=0.7),
                  rnd(nlev, 15, 133, hi=50.0), rnd(nlev, 15, 133, hi=50.0),
                  rnd(15, 133, hi=400.0), rnd(15, 133, hi=0.2)))):
            a = kern(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(a, plain(*args))):
                raise AssertionError(f"{name} differs from its plain version"
                                     f" on {nlev} levels x 15 g x 133 "
                                     f"columns")
    log(f"sw_adding, lw_adding on 1, 2, {NLEV} and {ADD_SPILL_NLEV} levels x "
        f"15 g x 133 columns: equal to their plain versions bit for bit")
    # B5 with 3 and 2 regions on 1, 2, 7, 137 and ADD_SPILL_NLEV levels x
    # 15 g x 133 columns (its 4-byte copies) and 132 columns (its 16-byte
    # copies, a part-filled last block), all clear, all cloudy and
    # alternating: equal to its plain versions bit for bit
    for kind, kern, plain in (
            ("sw", adding_fused.tc_sw_sweeps_fused,
             tripleclouds.tc_sw_sweeps_plain),
            ("lw", adding_fused.tc_lw_sweeps_fused,
             tripleclouds.tc_lw_sweeps_plain)):
        for nreg in (3, 2):
            for nlev in (1, 2, 7, NLEV, ADD_SPILL_NLEV):
                for pattern in TC_PATTERNS:
                    for ncol in (133, 132):
                        args = tc_random_args(kind, nreg, nlev, pattern, dev,
                                              ncol=ncol, seed=nlev)
                        a = kern(*args)
                        torch.cuda.synchronize()
                        if not all(torch.equal(x, y)
                                   for x, y in zip(a, plain(*args))):
                            raise AssertionError(
                                f"tc_{kind}_sweeps differs from its plain "
                                f"version ({nreg} regions, {nlev} levels, "
                                f"{ncol} columns, {pattern})")
    log(f"tc_sw_sweeps, tc_lw_sweeps with 3 and 2 regions on 1, 2, 7, {NLEV}"
        f" and {ADD_SPILL_NLEV} levels x 15 g x 133 and 132 columns, "
        f"{', '.join(TC_PATTERNS)}: equal to their plain versions bit for "
        f"bit")
    # and with 2 regions on the path's operands (its first two regions and
    # their overlap rows)
    for name, kern, plain in (
            ("tc_sw_sweeps", adding_fused.tc_sw_sweeps_fused,
             tripleclouds.tc_sw_sweeps_plain),
            ("tc_lw_sweeps", adding_fused.tc_lw_sweeps_fused,
             tripleclouds.tc_lw_sweeps_plain)):
        args = tc_two_regions(name[3:5], path_args[name])
        a = kern(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, plain(*args))):
            raise AssertionError(f"{name} differs from its plain version "
                                 f"with 2 regions on the path's operands")
        del a, args
    log("tc_sw_sweeps, tc_lw_sweeps with 2 regions on the path's operands: "
        "equal to their plain versions bit for bit")
    # and at the path's width with ADD_SPILL_NLEV levels (the path's layers
    # repeated), against the plain versions bit for bit
    spill_args = {}
    for name, kern, plain, args in (
            ("sw_adding", adding_fused.adding_sw_fused,
             adding.adding_sw_plain, sw_args),
            ("lw_adding", adding_fused.adding_lw_fused,
             adding.adding_lw_plain, lwadd_args)):
        reps = -(-ADD_SPILL_NLEV // NLEV)
        big = tuple(torch.cat([x] * reps)[:ADD_SPILL_NLEV] if x.dim() == 3
                    else x for x in args)
        a = kern(*big)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, plain(*big))):
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"{ADD_SPILL_NLEV} levels")
        spill_args[name] = big
        del a
    log(f"sw_adding, lw_adding on {ADD_SPILL_NLEV} levels x the path's g x "
        f"{NCOL} columns (device-memory branch): equal to their plain "
        f"versions bit for bit")

    # B6 and B7 on the SPARTACUS path's operands, with the doubling counts
    sp_counts = {}
    for name, kern, plain, args, escape in (
            ("spartacus_sw_reftrans", sr.sw_reftrans_levels_fused,
             sr.sw_reftrans_levels_plain, path_args["sw_reftrans_levels"],
             "RD/TD"),
            ("spartacus_lw_reftrans", sr.lw_reftrans_levels_fused,
             sr.lw_reftrans_levels_plain, path_args["lw_reftrans_levels"],
             "SU/SD")):
        use3d = args[7] if name == "spartacus_sw_reftrans" else args[10]
        counts = torch.empty(use3d.shape, dtype=torch.int8, device=dev)
        a = kern(*args, counts=counts)
        torch.cuda.synchronize()
        b = plain(*args)
        rel = rel_to_max(a, b)
        errs[name] = float((a - b).abs().max())
        ok = rel <= SPARTACUS_REL
        if not ok:
            # the float64 escape: no farther from the float64 plain
            # version than twice the float32 plain version is
            t = plain(*(x.double() if isinstance(x, torch.Tensor)
                        and x.is_floating_point() else x for x in args))
            scale = float(t.abs().max())
            k_err = float((a.double() - t).abs().max()) / scale
            p_err = float((b.double() - t).abs().max()) / scale
            ok = k_err <= max(SPARTACUS_REL, 2.0 * p_err)
            log(f"{name}: float64 escape ({escape}): kernel vs float64 "
                f"{k_err:.3e}, plain vs float64 {p_err:.3e}")
            del t
        sp_counts[name] = counts
        bounds[name] = least_time(name, args, (a,),
                                  ops=doubling_ops(name, counts))
        share, hist = histogram(counts)
        log(f"{name}: shape {tuple(a.shape)} worst |diff|/max|plain| "
            f"{rel:.3e} (bound {SPARTACUS_REL}), worst abs {errs[name]:.3e}"
            f"; 3D share {share:.4f} of the (level, g, column) cells; "
            f"doubling counts (-1 = fallback) {hist}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        if share <= 0.0:
            raise AssertionError(f"{name}: no cell took the 3D treatment")
        cap = (sr.sw_fixed_squarings if name == "spartacus_sw_reftrans"
               else sr.lw_fixed_squarings)(setup_sp.config)
        if int(counts.max()) > cap:
            raise AssertionError(f"{name}: a cell doubled {int(counts.max())}"
                                 f" times, beyond the capped bound {cap}")
        del a, b
    # B8 and B9 on the SPARTACUS path's operands
    for name, kern, plain, args, clear_rows in (
            ("spartacus_sw_adding", sa.sw_adding_sweeps_fused,
             sa.sw_adding_sweeps_plain, path_args["sw_adding_sweeps"],
             (sa._CLEAR, sa._CLEARP)),
            ("spartacus_lw_adding", sa.lw_adding_sweeps_fused,
             sa.lw_adding_sweeps_plain, path_args["lw_adding_sweeps"],
             (sa._LCLEAR, sa._LCLEARP))):
        a = kern(*args)
        torch.cuda.synchronize()
        b = plain(*args)
        rel = max(rel_to_max(x, y) for x, y in zip(a, b))
        errs[name] = max(float((x - y).abs().max()) for x, y in zip(a, b))
        hist = args[1] if name == "spartacus_sw_adding" else args[2]
        bounds[name] = least_time(name, args, a, ops=sweep_ops(
            name, args[-3 if name == "spartacus_sw_adding" else -2],
            hist.shape[2], clear_rows))
        log(f"{name}: hist {tuple(hist.shape)} worst |diff|/max|plain| "
            f"{rel:.3e} (bound {SPARTACUS_REL}), worst abs {errs[name]:.3e}")
        if not rel <= SPARTACUS_REL:
            raise AssertionError(f"{name} disagrees with its plain version")
        del a, b
    # B8 under every entrapment treatment on 256 of the path's columns
    cfg_sp, hist, cols_rows, init_up, direct0 = path_args["sw_adding_sweeps"]
    cut = [x[..., :NCOL_NOSCAT].contiguous() for x in (hist, cols_rows,
                                                       init_up, direct0)]
    for entrap in Entrapment:
        for do_3d in (True, False):
            cfg_e = dataclasses.replace(cfg_sp, i_3d_sw_entrapment=entrap,
                                        do_3d_effects=do_3d)
            a = sa.sw_adding_sweeps_fused(cfg_e, *cut)
            torch.cuda.synchronize()
            rel = max(rel_to_max(x, y) for x, y in zip(
                a, sa.sw_adding_sweeps_plain(cfg_e, *cut)))
            log(f"spartacus_sw_adding {entrap.name} do_3d_effects={do_3d}: "
                f"{NCOL_NOSCAT} columns, worst |diff|/max|plain| {rel:.3e}")
            if not rel <= SPARTACUS_REL:
                raise AssertionError(f"spartacus_sw_adding disagrees with "
                                     f"its plain version ({entrap.name})")
    del cut, hist, cols_rows, init_up, direct0
    # B6 and B7 on random cases (check_kernel_equivalence.py's build)
    for nreg in (3, 2):
        rc = random_reftrans_case(nreg, dev)
        for name, kern, plain, args in (
                ("spartacus_sw_reftrans", sr.sw_reftrans_levels_fused,
                 sr.sw_reftrans_levels_plain, rc["sw"]),
                ("spartacus_lw_reftrans", sr.lw_reftrans_levels_fused,
                 sr.lw_reftrans_levels_plain, rc["lw"]),
                ("spartacus_lw_reftrans (no scattering)",
                 sr.lw_reftrans_levels_fused, sr.lw_reftrans_levels_plain,
                 (rc["lw"][0], False) + rc["lw"][2:])):
            a = kern(*args)
            torch.cuda.synchronize()
            rel = rel_to_max(a, plain(*args))
            log(f"{name} random case, {nreg} regions: worst |diff|/max|plain|"
                f" {rel:.3e}")
            if not rel <= SPARTACUS_REL:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on the random case")

    # B6's two passes with no 3D cell (pass 1 stages nothing), with every
    # cell 3D (past the staged share pass 1 writes in place), with the
    # path's share, and with an odd ng x ncol: the doubling counts, and a
    # second call equal bit for bit (the order of the staged cells is free)
    worst = 0.0
    for nreg in (3, 2):
        for share, ng, ncol in ((0.0, 16, 133), (1.0, 16, 133),
                                (0.14, 16, 133), (0.14, 15, 133)):
            args = random_reftrans_case(nreg, dev, ng=ng, ncol=ncol,
                                        share3d=share)["sw"]
            counts = torch.empty(args[7].shape, dtype=torch.int8, device=dev)
            a = sr.sw_reftrans_levels_fused(*args, counts=counts)
            again = sr.sw_reftrans_levels_fused(*args)
            torch.cuda.synchronize()
            b = sr.sw_reftrans_levels_plain(*args)
            rel = rel_to_max(a, b)
            worst = max(worst, float((a - b).abs().max()))
            log(f"spartacus_sw_reftrans {nreg} regions, 3D share {share}, "
                f"ng x ncol {ng} x {ncol}: worst |diff|/max|plain| "
                f"{rel:.3e}, worst abs {float((a - b).abs().max()):.3e}, "
                f"{int((counts >= 0).sum())} 3D cells")
            if not (rel <= SPARTACUS_REL and torch.equal(a, again)
                    and bool(((counts < 0) == ~args[7]).all())):
                raise AssertionError(f"spartacus_sw_reftrans disagrees on "
                                     f"the share {share} case")
    log(f"spartacus_sw_reftrans share cases: worst abs {worst:.3e}")
    # B8 with fewer levels than (or about) its stage ring, ng not a
    # multiple of its g-tile and 133 columns, under every treatment
    worst = 0.0
    for nreg in (3, 2):
        for nlev in (1, 2, 7):
            case = random_reftrans_case(nreg, dev, nlev=nlev, ng=15,
                                        ncol=133)
            hist = sr.sw_reftrans_levels_fused(*case["sw"])
            cols_r, init_r, d0_r = case["sweep"]
            for entrap in Entrapment:
                cfg_e = dataclasses.replace(setup_sp.config,
                                            i_3d_sw_entrapment=entrap)
                a = sa.sw_adding_sweeps_fused(cfg_e, hist, cols_r, init_r,
                                              d0_r)
                torch.cuda.synchronize()
                b = sa.sw_adding_sweeps_plain(cfg_e, hist, cols_r, init_r,
                                              d0_r)
                rel = max(rel_to_max(x, y) for x, y in zip(a, b))
                worst = max([worst] + [float((x - y).abs().max())
                                       for x, y in zip(a, b)])
                if not rel <= SPARTACUS_REL:
                    raise AssertionError(
                        f"spartacus_sw_adding disagrees with its plain "
                        f"version ({nreg} regions, {nlev} levels, "
                        f"{entrap.name}): {rel:.3e}")
    log(f"spartacus_sw_adding 1, 2 and 7 levels x 15 g x 133 columns, every"
        f" treatment, 3 and 2 regions: worst abs {worst:.3e}")
    # B7's two passes likewise, with cloud scattering on and off
    worst = 0.0
    for nreg in (3, 2):
        for share in (0.0, 1.0, 0.14):
            lw = random_reftrans_case(nreg, dev, share3d=share)["lw"]
            for scattering in (True, False):
                args = (lw[0], scattering) + lw[2:]
                counts = torch.empty(args[10].shape, dtype=torch.int8,
                                     device=dev)
                a = sr.lw_reftrans_levels_fused(*args, counts=counts)
                again = sr.lw_reftrans_levels_fused(*args)
                torch.cuda.synchronize()
                b = sr.lw_reftrans_levels_plain(*args)
                rel = rel_to_max(a, b)
                worst = max(worst, float((a - b).abs().max()))
                log(f"spartacus_lw_reftrans {nreg} regions, 3D share {share}"
                    f", cloud scattering {scattering}: worst |diff|/max|plain|"
                    f" {rel:.3e}, worst abs {float((a - b).abs().max()):.3e}, "
                    f"{int((counts >= 0).sum())} 3D cells")
                if not (rel <= SPARTACUS_REL and torch.equal(a, again)
                        and bool(((counts < 0) == ~args[10]).all())):
                    raise AssertionError(f"spartacus_lw_reftrans disagrees on "
                                         f"the share {share} case")
    log(f"spartacus_lw_reftrans share cases: worst abs {worst:.3e}")
    # B9 with 1, 2 and 7 levels, 15 g-points (no multiple of its g-tile)
    # and 133 columns, a full random albedo matrix at the surface, under
    # (use_matrix, multilayer) (T, F), (T, T) and (F, F)
    worst = 0.0
    for nreg in (3, 2):
        for nlev in (1, 2, 7):
            case = random_reftrans_case(nreg, dev, nlev=nlev, ng=15,
                                        ncol=133)
            hist = sr.lw_reftrans_levels_fused(*case["lw"])
            cols_r, init_r = case["lsweep"]
            for use_matrix, multilayer in ((True, False), (True, True),
                                           (False, False)):
                cfg_l = dataclasses.replace(
                    setup_sp.config, do_3d_lw_multilayer_effects=multilayer)
                a = sa.lw_adding_sweeps_fused(cfg_l, use_matrix, hist, cols_r,
                                              init_r)
                torch.cuda.synchronize()
                b = sa.lw_adding_sweeps_plain(cfg_l, use_matrix, hist, cols_r,
                                              init_r)
                rel = max(rel_to_max(x, y) for x, y in zip(a, b))
                worst = max([worst] + [float((x - y).abs().max())
                                       for x, y in zip(a, b)])
                if not rel <= SPARTACUS_REL:
                    raise AssertionError(
                        f"spartacus_lw_adding disagrees with its plain "
                        f"version ({nreg} regions, {nlev} levels, use_matrix "
                        f"{use_matrix}, multilayer {multilayer}): {rel:.3e}")
    log(f"spartacus_lw_adding 1, 2 and 7 levels x 15 g x 133 columns, "
        f"(use_matrix, multilayer) (T, F), (T, T), (F, F), 3 and 2 regions: "
        f"worst abs {worst:.3e}")

    # B10 on the 30 calls of one per-band gas-optics call (the section
    # lists the path builds from the 2048 x 137 columns' coefficients)
    b10_calls = []

    def keep_sections(secs, n):
        b10_calls.append((secs, n))
        return gi.eval_sections(secs, n)
    for mod in (taumol_lw_sections, taumol_sw_sections):
        mod.eval_sections = keep_sections
    pb_lw = taumol_lw_sections.taumol_lw_sections(c_sf, t, toa_first=True)
    pb_sw = taumol_sw_sections.taumol_sw_sections(c_sf, setup.gas,
                                                  toa_first=True)
    for mod in (taumol_lw_sections, taumol_sw_sections):
        mod.eval_sections = gi.eval_sections
    if len(b10_calls) != B10_PER_CALL:
        raise AssertionError(f"the per-band gas optics made "
                             f"{len(b10_calls)} eval_sections calls, not "
                             f"{B10_PER_CALL}")
    b10_rel, errs["gather_sections"], b10_bytes, b10_ops = 0.0, 0.0, 0, 0
    b10_moved, b10_plans = 0, []
    gi.copies["gather_sections"] = 0
    for secs, n in b10_calls:
        a = gi.eval_sections_kernel(secs, n)
        torch.cuda.synchronize()
        b = gi.eval_sections_plain(secs, n)
        b10_rel = max(b10_rel, rel_to_max(a, b))
        errs["gather_sections"] = max(errs["gather_sections"],
                                      float((a - b).abs().max()))
        nbytes, nops = b10_least(secs, n, a.shape[0])
        b10_bytes += nbytes
        b10_ops += nops
        p = gi.pack_sections(secs, n, dev)
        b10_moved += 4 * (len(p.operands) * n + p.tab.numel() + p.g * n)
        tile = gi._plan_on_card(n, p.nterms, p.ptrs.numel(), p.g)
        b10_plans.append((tile, _cuda.kernel_info(
            "gather_sections_info", tile, p.nterms, p.ptrs.numel(), p.g)))
        del a, b, p
    t_b, t_o = b10_bytes / HBM_BYTES_PER_S, b10_ops / F32_OPS_PER_S
    bounds["gather_sections"] = (max(t_b, t_o) * 1e3,
                                 "bytes" if t_b >= t_o else "operations",
                                 b10_bytes, b10_ops)
    log(f"gather_sections: the {B10_PER_CALL} calls of one per-band "
        f"gas-optics call, N={NCOL * NLEV}: worst |diff|/max|plain| "
        f"{b10_rel:.3e} (bound {B10_REL}), worst abs "
        f"{errs['gather_sections']:.3e}; operands the wrapper copied "
        f"{gi.copies['gather_sections']}")
    if not b10_rel <= B10_REL:
        raise AssertionError("gather_sections disagrees with its plain "
                             "version on the path's operands")
    if gi.copies["gather_sections"]:
        raise AssertionError("the B10 wrapper copied operands of the path")
    rep = [v for f, v in report.items() if "gather_sections_kernel" in f]
    rep = rep[0] if len(rep) == 1 else {}
    big = max(b10_plans, key=lambda x: x[1]["dynamic_smem"])
    log(f"  B10: {big[1]['registers']} registers, {big[1]['local_bytes']} B "
        f"local per thread (spill stores {rep.get('spill_stores')} B, loads "
        f"{rep.get('spill_loads')} B), {big[1]['threads']} threads; its "
        f"largest block ({big[0]} cells) {big[1]['dynamic_smem']} B shared, "
        f"{big[1]['blocks_per_sm']} blocks per SM; the 30 calls' (cells a "
        f"block, blocks per SM): "
        f"{[(tl, k['blocks_per_sm']) for tl, k in b10_plans]}")
    if min(k["blocks_per_sm"] for _, k in b10_plans) < 1:
        raise AssertionError("a B10 block cannot be resident on an SM")
    n_rand = 2048 * 9 + 133
    for name in ("plain", "eta_lw_absa", "eta_lw_absb", "mixed",
                 "out_of_range", "ev2_halves", "zero_section"):
        secs = random_sections(dev, name, n_rand)
        a = gi.eval_sections_kernel(secs, n_rand)
        torch.cuda.synchronize()
        b = gi.eval_sections_plain(secs, n_rand)
        rel = rel_to_max(a, b)
        log(f"gather_sections random case {name}, N={n_rand}: worst "
            f"|diff|/max|plain| {rel:.3e} (bound {B10_REL})")
        if not rel <= B10_REL:
            raise AssertionError(f"gather_sections disagrees with its "
                                 f"plain version on the random case {name}")
        errs["gather_sections"] = max(errs["gather_sections"],
                                      float((a - b).abs().max()))
    # the per-band optical depths (B10) against the all-band kernels' (B1,
    # B2), at the JAX package's fused-vs-per-band bound
    fu_lw = taumol_lw.taumol_lw_cells(c_sf, setup.gas.chi_mls, setup.gas.lw)
    fu_sw = taumol_sw.taumol_sw_cells(c_sf, setup.gas)
    for name, x, y in (("tau", pb_lw[0], fu_lw[0]),
                       ("pfrac", pb_lw[1], fu_lw[1]),
                       ("taug", pb_sw[0], fu_sw[0]),
                       ("taur", pb_sw[1], fu_sw[1])):
        if name == "pfrac":
            err = float((x - y).abs().max())
            ok = err <= PF_ATOL
            what = f"worst abs {err:.3e} (bound {PF_ATOL})"
        else:
            mask = y.abs() > 1e-6
            err = float(((x - y).abs() / y.abs().clamp(min=1e-30))[mask]
                        .max())
            ok = err <= TAU_REL
            what = f"worst rel {err:.3e} (bound {TAU_REL}, |x|>1e-6)"
        log(f"per-band {name} (B10) vs all-band (B1/B2): {what}")
        if not ok:
            raise AssertionError(f"per-band {name} disagrees with the "
                                 f"all-band kernels")
    del pb_lw, pb_sw, fu_lw, fu_sw

    # the McICA generator's random fields at the cells' shapes (the SW and
    # LW calls of a radiation call, on the cells' int32 seeds): the kernel
    # against utils/threefry.py's passes on the card, bit for bit
    rf_seeds = [torch.arange(NCOL, dtype=torch.int32, device=dev) + shift
                for _, shift in GENERATOR_CALLS]
    for (ng, shift), iseed in zip(GENERATOR_CALLS, rf_seeds):
        for dtype in (torch.float32, torch.float64):
            rf_out = rf.random_fields_kernel(iseed, ng, NLEV, dtype)
            torch.cuda.synchronize()
            rf_ref = rf.random_fields_plain(iseed, ng, NLEV, dtype)
            same = all(torch.equal(x, y) for x, y in zip(rf_out, rf_ref))
            log(f"threefry_fields: {NCOL} x {NLEV} x {ng}, iseed + {shift},"
                f" {dtype}: rand_top, rand_cloud, u1 and u2 equal to the "
                f"plain path's bit for bit: {same}")
            if not same:
                raise AssertionError("threefry_fields disagrees with the "
                                     "plain path")
            del rf_out, rf_ref
    errs["threefry_fields"] = 0.0
    rf_values = sum(NCOL * (ng + 3 * NLEV * ng) for ng, _ in GENERATOR_CALLS)
    # the float32 uniforms written once and the int32 seeds read once
    rf_bytes = 4 * rf_values + 4 * NCOL * len(GENERATOR_CALLS)
    t_i, t_b = (rf_values * THREEFRY_INT_OPS / INT32_OPS_PER_S,
                rf_bytes / HBM_BYTES_PER_S)
    bounds["threefry_fields"] = (
        max(t_i, t_b) * 1e3, "integer operations" if t_i >= t_b else "bytes",
        rf_bytes, rf_values * THREEFRY_INT_OPS)
    # the cloud generator kernel at the cells' shapes on the McICA path's
    # cloud, the SW and LW calls of a radiation call on the random-fields
    # kernel's uniforms, against its plain version on the card (float32)
    gen_args = [
        (cfg_m.i_overlap_scheme, cfg_m.cloud_fraction_threshold,
         cloud_m.fraction.contiguous(), cloud_m.overlap_param.contiguous(),
         cfg_m.cloud_inhom_decorr_scaling,
         cloud_m.fractional_std.contiguous(), setup_m.pdf_sampler,
         cfg_m.use_beta_overlap, setup_m.pdf_table,
         *rf.random_fields_kernel(iseed, ng, NLEV, torch.float32))
        for (ng, _), iseed in zip(GENERATOR_CALLS, rf_seeds)]
    errs["mcica_generator"], bounds["mcica_generator"] = check_generator(
        gen_args, F32_OPS_PER_S)

    # the double forms on the float64 path's operands: one float64 McICA
    # call (the configuration of the benchmark's float64 cell) on the 2048
    # x 137 columns with clouds and aerosols, the hooks' counters reset
    # just before it and read just after, each double form's operands kept
    from ecrad_tpu_torch.config import TRIPLECLOUDS_AEROSOL_MAP
    from ecrad_tpu_torch.utils import hooks
    setup_f64 = setup_radiation(mcica_slice_config(
        **luts, dtype="float64", do_lw_cloud_scattering=False,
        use_aerosols=True, n_aerosol_types=len(TRIPLECLOUDS_AEROSOL_MAP),
        i_aerosol_type_map=TRIPLECLOUDS_AEROSOL_MAP,
        do_lw_derivatives=True), device=dev)
    # name: (module, wrapper, plain version, bound of each output's
    # largest value, 0 for bit for bit)
    f64_kernels = {
        "taumol_lw": (taumol_lw, "taumol_lw_kernel",
                      taumol_lw.taumol_lw_plain, F64_TAUMOL_REL),
        "taumol_sw": (taumol_sw, "taumol_sw_kernel",
                      taumol_sw.taumol_sw_plain, F64_TAUMOL_REL),
        "sw_adding": (adding_fused, "adding_sw_fused",
                      adding.adding_sw_plain, 0.0),
        "lw_noscat": (adding_fused, "lw_noscat_fused",
                      adding.lw_no_scattering_fluxes_plain, 0.0),
        "lw_adding": (adding_fused, "adding_lw_fused",
                      adding.adding_lw_plain, 0.0),
        "mcica_sw_optics": (mcica_optics, "mcica_sw_optics_fused",
                            mcica_optics.sw_clear_total_reftrans_plain, 0.0),
        "aerosol_optics": (interface, "add_aerosol_optics",
                           aerosol_module.add_aerosol_optics_plain, 0.0)}
    f64_args = {name: [] for name in f64_kernels}

    def kept(name, fn):
        def wrapped(*args):
            f64_args[name].append(args)
            return fn(*args)
        return wrapped
    f64_fns = [(mod, attr, getattr(mod, attr))
               for mod, attr, _, _ in f64_kernels.values()]
    for name, (mod, attr, fn) in zip(f64_kernels, f64_fns):
        setattr(mod, attr, kept(name, fn))
    # and the cloud generator's, held to their own contract below
    f64_args["mcica_generator"] = []
    f64_fns.append((mg, "generator_kernel", mg.generator_kernel))
    mg.generator_kernel = kept("mcica_generator", mg.generator_kernel)
    hooks.enable(True)
    hooks.reset_profile()
    try:
        flux_f64 = radiation(setup_f64, *inputs_t)
        torch.cuda.synchronize()
        counts_f64 = hooks.counters()
    finally:
        for mod, attr, fn in f64_fns:
            setattr(mod, attr, fn)
        hooks.reset_profile()
        hooks.enable(False)
    launched = {k: v for k, v in counts_f64.items()
                if k.startswith(("launch.", "plain_on_device."))}
    not_f64 = [k for k, v in flux_f64.fields() if v.dtype != torch.float64]
    log(f"path mcica_f64: launch and plain-on-device counters {launched}; "
        f"output fields not float64: {not_f64}")
    if launched != {f"launch.{k}.f64": n for k, n in F64_LAUNCHES.items()}:
        raise AssertionError("the float64 McICA call did not launch each "
                             "kernel of its path in its double form alone")
    if not_f64:
        raise AssertionError(f"float64 McICA call: {not_f64} not float64")
    del flux_f64
    for name, (mod, attr, plain, bound) in f64_kernels.items():
        kern, calls = getattr(mod, attr), f64_args[name]
        if len(calls) != F64_LAUNCHES[name]:
            raise AssertionError(f"{name}: {len(calls)} calls on the "
                                 f"float64 path")
        if name == "aerosol_optics":
            check_aerosol(calls[0], errs, bounds, name + "_f64",
                          F64_OPS_PER_S)
            continue
        rel = err = 0.0
        for i, args in enumerate(calls):
            got = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            if any(x.dtype != torch.float64 for x in got) or (
                    bound == 0.0 and not all(torch.equal(x, y)
                                             for x, y in zip(got, want))):
                raise AssertionError(f"{name} in float64 differs from its "
                                     f"plain version")
            rel = max(rel, *(rel_to_max(x, y) for x, y in zip(got, want)))
            err = max(err, *(float((x - y).abs().max())
                             for x, y in zip(got, want)))
            if i == 0:
                outs = got
        errs[name + "_f64"] = err
        # output values as for the float forms: (cell, g) for B1/B2, one
        # per element of the first operand for B3/B3' and B4
        bounds[name + "_f64"] = least_time(
            name, calls[0], outs,
            outs[0].numel() if name.startswith("taumol") else
            calls[0][0].numel(), ops_per_s=F64_OPS_PER_S)
        log(f"{name} float64: {len(calls)} call(s), shape "
            f"{tuple(calls[0][0].shape)} worst |diff|/max|plain| {rel:.3e} "
            f"(bound {bound or 'bit for bit'}), worst abs {err:.3e}")
        if not rel <= bound:
            raise AssertionError(f"{name} in float64 disagrees with its "
                                 f"plain version")
        # phase 4 times the first call
        del calls[1:], got, want, outs
    gen_calls = f64_args.pop("mcica_generator")
    if len(gen_calls) != F64_LAUNCHES["mcica_generator"]:
        raise AssertionError(f"mcica_generator: {len(gen_calls)} calls on "
                             f"the float64 path")
    if any(a[2].dtype != torch.float64 for a in gen_calls):
        raise AssertionError("mcica_generator: not float64 on the float64 "
                             "path")
    errs["mcica_generator_f64"], bounds["mcica_generator_f64"] = \
        check_generator(gen_calls, F64_OPS_PER_S)

    # ---- 3. the paths, counted ----
    counters = (taumol_lw, taumol_sw, rf, mg, adding_fused.launches,
                mcica_optics.launches, sr.launches, sa.launches, gi.launches,
                tc_optics.launches, aerosol_optics.launches)
    launches = {}

    def count(name, fn):
        reset_counts(counters)
        out = fn()
        torch.cuda.synchronize()
        launches[name] = read_counts(counters)
        log(f"path {name}: kernel launches {launches[name]}")
        missing = [k for k in PATH_KERNELS[name] if launches[name][k] < 1]
        if missing:
            raise AssertionError(f"{missing} not launched on path {name}")
        return out

    def counted(name, fn):
        return {k: v.double().cpu().numpy()
                for k, v in count(name, fn).fields()}

    # a. Cloudless
    f = counted("cloudless", lambda: radiation(setup, sl, th, gas))
    check_fluxes(f, cols, NCOL)
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    check_golden(f, golden, BOUNDS, BOUNDS)

    # b. McICA at full width
    f = counted("mcica", lambda: radiation(setup_m, *inputs_m))
    check_fluxes(f, cols_m, NCOL)
    with np.load(GOLDEN_MCICA) as z:
        golden = {k: z[k] for k in z.files}
    flips = np.zeros(32, bool)
    for key, ng, offset in (("mask_sw", 112, 0), ("mask_lw", 140, 997)):
        got = (od_scaling(ng, offset)[:32] > 0).cpu().numpy()
        ref = np.unpackbits(golden[key])[:got.size].reshape(got.shape)
        flips |= (got != ref).any(axis=(1, 2))
    log(f"golden mcica subcolumn masks: {int(flips.sum())} of 32 columns "
        f"differ (at most {MAX_MASK_FLIPS}): {np.flatnonzero(flips)}")
    if flips.sum() > MAX_MASK_FLIPS:
        raise AssertionError("too many subcolumn masks differ")
    for k in ("cloud_cover_sw", "cloud_cover_lw"):
        e = float(np.abs(f[k][:32] - golden[k]).max())
        log(f"golden mcica {k}: vs JAX float32 {e:.3e} (bound {COVER_ATOL})")
        if not e <= COVER_ATOL:
            raise AssertionError(f"{k} outside its golden bound")
    check_golden(f, golden, [k + "_clear" for k in BOUNDS], BOUNDS,
                 what=" mcica clear")
    check_golden(f, golden, list(TOTAL_BOUNDS), TOTAL_BOUNDS, rows=~flips,
                 f64=False, what=" mcica total")
    cloud_effect(f, "mcica")

    # c. McICA without LW scattering (B4's LW kernel)
    setup_n = setup_radiation(mcica_slice_config(
        **luts, do_lw_cloud_scattering=False,
        do_lw_aerosol_scattering=False,
        i_overlap_scheme=Overlap.EXPONENTIAL_RANDOM), device=dev)
    cols_n = slice_columns(cols_m, slice(0, NCOL_NOSCAT))
    f = counted("mcica_noscat", lambda: radiation(
        setup_n, *columns_to_inputs(cols_n, device=dev)))
    check_fluxes(f, cols_n, NCOL_NOSCAT)

    # d. Tripleclouds at full width, against its golden
    f = counted("tripleclouds", lambda: radiation(setup_t, *inputs_t))
    check_fluxes(f, cols_t, NCOL)
    with np.load(GOLDEN_TC) as z:
        golden = {k: z[k] for k in z.files}
    check_golden(f, golden, list(TC_BOUNDS), TC_BOUNDS,
                 what=" tripleclouds", jax_slack=True)
    cloud_effect(f, "tripleclouds")

    # e. Tripleclouds with two regions; f. Homogeneous with aerosols
    cols_s = slice_columns(cols_t, slice(0, NCOL_NOSCAT))
    for name, kw in (
            ("tripleclouds_2reg", dict(
                nregions=2, i_cloud_pdf_shape=PdfShape.LOGNORMAL,
                use_beta_overlap=True, do_lw_cloud_scattering=True,
                do_lw_aerosol_scattering=False, use_aerosols=False)),
            ("homogeneous", dict(i_solver_sw=Solver.HOMOGENEOUS,
                                 i_solver_lw=Solver.HOMOGENEOUS))):
        setup_s = setup_radiation(tripleclouds_slice_config(**luts_fu, **kw),
                                  device=dev)
        f = counted(name, lambda: radiation(
            setup_s, *columns_to_inputs(cols_s, device=dev)))
        check_fluxes(f, cols_s, NCOL_NOSCAT)
        cloud_effect(f, name)

    # g. SPARTACUS at full width, against its golden
    f = counted("spartacus", lambda: radiation(setup_sp, *inputs_sp))
    check_fluxes(f, cols_sp, NCOL)
    with np.load(GOLDEN_SP) as z:
        golden = {k: z[k] for k in z.files}
    check_golden(f, golden, list(SP_BOUNDS), SP_BOUNDS, what=" spartacus",
                 jax_slack=True)
    cloud_effect(f, "spartacus")
    for name, counts in sp_counts.items():
        share, hist = histogram(counts)
        log(f"spartacus {name}: 3D share {share:.4f}, doubling counts "
            f"{hist}")

    # h. SPARTACUS with Maximum entrapment; with two regions
    cols_h = slice_columns(cols_sp, slice(0, NCOL_NOSCAT))
    for name, kw in (
            ("spartacus_maxentr", dict(i_3d_sw_entrapment=Entrapment.MAXIMUM)),
            ("spartacus_2reg", dict(
                nregions=2, i_cloud_pdf_shape=PdfShape.LOGNORMAL,
                i_3d_sw_entrapment=Entrapment.ZERO,
                do_lw_cloud_scattering=True, do_lw_aerosol_scattering=False,
                use_aerosols=False))):
        setup_h = setup_radiation(spartacus_slice_config(**luts_fu, **kw),
                                  device=dev)
        f = counted(name, lambda: radiation(
            setup_h, *columns_to_inputs(cols_h, device=dev)))
        check_fluxes(f, cols_h, NCOL_NOSCAT)
        cloud_effect(f, name)

    # i. the offline driver with the per-band gas optics (B10), from a
    # NetCDF file of the 2048 x 137 columns (save_inputs writes no solar
    # irradiance: the namelist's override gives the columns' own)
    os.makedirs(DRIVER_DIR, exist_ok=True)
    drv_in = os.path.join(DRIVER_DIR, "columns.nc")
    drv_out = os.path.join(DRIVER_DIR, "fluxes_per_band.nc")
    save_inputs(drv_in, sl, th, gas, None, None)
    nam = write_namelist(os.path.join(DRIVER_DIR, "cloudless.nam"),
                         "Cloudless", {}, cols["solar_irradiance"])
    os.environ["ECRAD_FUSED_TAUMOL"] = "0"
    code = count("driver_per_band",
                 lambda: driver.main([nam, drv_in, drv_out]))
    del os.environ["ECRAD_FUSED_TAUMOL"]
    n_b10 = launches["driver_per_band"]
    if code != 0 or n_b10["gather_sections"] != B10_PER_CALL or \
            n_b10["taumol_lw"] or n_b10["taumol_sw"]:
        raise AssertionError(f"the per-band driver run (rc {code}) launched "
                             f"B10 {n_b10['gather_sections']} times (not "
                             f"{B10_PER_CALL}) or B1/B2")
    out = read_nc(drv_out)
    f = {k: out[v].astype(np.float64) for k, v in FILE_FLUXES.items()}
    check_fluxes(f, cols, NCOL)
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    check_golden(f, golden, BOUNDS, BOUNDS, what=" driver per-band")

    # j. the driver with McICA on 256 columns against radiation() on the
    # same file's inputs
    cols_dm = slice_columns(cols_m, slice(0, NCOL_NOSCAT))
    dm_in = os.path.join(DRIVER_DIR, "clouds.nc")
    dm_out = os.path.join(DRIVER_DIR, "fluxes_mcica.nc")
    dm_ref = os.path.join(DRIVER_DIR, "fluxes_mcica_radiation.nc")
    save_inputs(dm_in, *columns_to_inputs(cols_dm, device=dev), None)
    nam = write_namelist(os.path.join(DRIVER_DIR, "mcica.nam"), "McICA",
                         luts, cols["solar_irradiance"])
    code = count("driver_mcica", lambda: driver.main([nam, dm_in, dm_out]))
    ins = read_input(dm_in, load_driver_config_from_namelist(nam),
                     device=dev)
    save_fluxes(dm_ref, radiation(setup_radiation(
        load_config_from_namelist(nam), device=dev), *ins), ins[1])
    got, ref = read_nc(dm_out), read_nc(dm_ref)
    differ = [k for k in ref if k not in got
              or not np.array_equal(got[k], ref[k])]
    log(f"driver mcica: {len(got)} variables of {NCOL_NOSCAT} columns, "
        f"{len(differ)} differ from radiation() on the file's inputs "
        f"{differ}; cloud cover > 0.5 in "
        f"{int((got['cloud_cover_lw'] > 0.5).sum())} columns")
    if code != 0 or differ or set(got) != set(ref):
        raise AssertionError("the McICA driver's file differs from "
                             "radiation() on its inputs")

    # ---- the configuration surface: the IFS entry point, g-point
    # profiles, the monochromatic model, the entrapment dump ----
    from ecrad_tpu_torch import coupling
    from ecrad_tpu_torch.config import GasModel
    # k. coupling.radiation_scheme at full width: McICA with the surface
    # band fluxes, the band profiles, the clear sky, a spectral solar
    # scaling and the canopy fluxes (SW by overlap weights), then
    # unpack_host_outputs
    setup_ifs = setup_radiation(mcica_slice_config(
        **luts, do_surface_sw_spectral_flux=True, do_save_spectral_flux=True,
        do_clear=True, use_spectral_solar_scaling=True,
        do_canopy_fluxes_sw=True, do_canopy_fluxes_lw=True), device=dev)
    host = host_arrays(cols_m)
    scaling = np.linspace(0.8, 1.2, 14)
    ifs = lambda s: coupling.radiation_scheme(  # noqa: E731
        setup_ifs, **host, spectral_solar_scaling=s)
    flux_ifs = count("ifs_entry", lambda: ifs(scaling))
    f = {k: v.double().cpu().numpy() for k, v in flux_ifs.fields()}
    check_fluxes(f, cols_m, NCOL)
    check_profiles(f, "ifs_entry")
    out = coupling.unpack_host_outputs(
        setup_ifs, flux_ifs, cos_sza=host["cos_sza"],
        skin_temperature=host["skin_temperature"],
        lw_emissivity=host["lw_emissivity"])
    for k, sw_surf in (("flux_uv", flux_ifs.sw_dn), ("flux_par",
                                                      flux_ifs.sw_dn),
                       ("flux_par_clear", flux_ifs.sw_dn_clear)):
        v = getattr(out, k)
        if not (bool(torch.isfinite(v).all())
                and bool((v <= sw_surf[:, -1] + 1e-3).all())):
            raise AssertionError(f"{k} is not finite or exceeds the surface "
                                 f"sw_dn (clear sky for the clear PAR)")
    ones, unscaled = ifs(np.ones(14)), ifs(None)
    differ = [k for k, v in ones.fields()
              if not torch.equal(v, getattr(unscaled, k))]
    moved = float((flux_ifs.sw_dn_band - unscaled.sw_dn_band).abs().max())
    log(f"ifs_entry: UV {float(out.flux_uv.max()):.3f}, PAR "
        f"{float(out.flux_par.max()):.3f} W/m2 at most, below the surface "
        f"sw_dn (the clear PAR below the clear sw_dn); a scaling of ones against none: {len(differ)} of "
        f"{len(ones.fields())} fields differ {differ}; the scaling 0.8-1.2 "
        f"moves sw_dn_band by up to {moved:.3f} W/m2")
    if differ or not moved > 1.0:
        raise AssertionError("the spectral solar scaling is wrong")
    del ones, unscaled, out
    ms_ifs = path_ms(lambda: ifs(scaling))
    ms_mcica = path_ms(lambda: radiation(setup_m, *inputs_m))
    log(f"time ifs_entry: coupling.radiation_scheme {ms_ifs:.3f} ms per "
        f"{NCOL}-column call, radiation() on the McICA path {ms_mcica:.3f} "
        f"ms [{gpu}]")

    # l. the g-point profiles under SPARTACUS at full width, in the
    # original g order: summed over each band's g-points by the
    # un-reordered band map, the band profiles of the same call with
    # do_save_spectral_flux alone
    setup_gp, setup_bd = (setup_radiation(spartacus_slice_config(
        **luts_fu, do_save_spectral_flux=True, do_save_gpoint_flux=gp),
        device=dev) for gp in (True, False))
    f_gp = counted("spartacus_gpoint", lambda: radiation(setup_gp,
                                                        *inputs_sp))
    check_profiles(f_gp, "spartacus_gpoint")
    f_bd = counted("spartacus_bands", lambda: radiation(setup_bd,
                                                       *inputs_sp))
    check_profiles(f_bd, "spartacus_bands")
    worst = 0.0
    for k in f_bd:
        if "_band" not in k or "surf" in k:
            continue
        band = (setup_gp.spec.band_from_g_lw if k.startswith("lw")
                else setup_gp.spec.band_from_g_sw)
        summed = np.stack([f_gp[k][..., band == b].sum(-1)
                           for b in range(f_bd[k].shape[-1])], -1)
        err = np.abs(summed - f_bd[k]).max() / np.abs(f_bd[k]).max()
        worst = max(worst, err)
        if not err <= PROFILE_REL:
            raise AssertionError(f"g-point {k} summed by band is {err:.3e} "
                                 f"from the band profile")
    log(f"spartacus_gpoint: g-point profiles summed by the un-reordered "
        f"band map against the band profiles: worst {worst:.3e} of each "
        f"field's largest value (bound {PROFILE_REL})")
    del f_gp, f_bd
    ms_gp = path_ms(lambda: radiation(setup_gp, *inputs_sp))
    ms_sp = path_ms(lambda: radiation(setup_sp, *inputs_sp))
    log(f"time spartacus_gpoint: {ms_gp:.3f} ms per {NCOL}-column call with"
        f" the g-point profiles, {ms_sp:.3f} ms without [{gpu}]")

    # m. the monochromatic model at full width: B3, B3' and B4 at one
    # g-point (Homogeneous with LW cloud scattering, the clear sky without:
    # sw_adding, lw_adding, lw_noscat; McICA without: sw_adding, lw_noscat
    # and both B4 kernels);
    # each kernel against its plain version on the operands the paths
    # hand it
    mono = {"mono_homogeneous": setup_radiation(tripleclouds_slice_config(
                **luts_fu, **MONO, i_gas_model=GasModel.MONOCHROMATIC,
                i_solver_sw=Solver.HOMOGENEOUS,
                i_solver_lw=Solver.HOMOGENEOUS, do_lw_cloud_scattering=True,
                do_lw_aerosol_scattering=False), device=dev),
            "mono_mcica": setup_radiation(mcica_slice_config(
                **luts, **MONO, i_gas_model=GasModel.MONOCHROMATIC,
                do_lw_cloud_scattering=False,
                do_lw_aerosol_scattering=False), device=dev)}
    for name, s_mono in mono.items():
        f = counted(name, lambda: radiation(s_mono, *inputs_m))
        check_fluxes(f, cols_m, NCOL)
        cloud_effect(f, name)
    one_g = {}
    one_g_kernels = (
        ("sw_adding", adding_fused, "adding_sw_fused",
         adding.adding_sw_plain),
        ("lw_noscat", adding_fused, "lw_noscat_fused",
         adding.lw_no_scattering_fluxes_plain),
        ("lw_adding", adding_fused, "adding_lw_fused",
         adding.adding_lw_plain),
        ("mcica_sw_optics", mcica_optics, "mcica_sw_optics_fused",
         mcica_optics.sw_clear_total_reftrans_plain),
        ("mcica_lw_optics", mcica_optics, "mcica_lw_optics_fused",
         mcica_optics.lw_clear_total_noscat_plain))

    def first_args(attr, orig):
        def wrapper(*args):
            one_g.setdefault(attr, args)
            return orig(*args)
        return wrapper
    saved = [(mod, attr, getattr(mod, attr))
             for _, mod, attr, _ in one_g_kernels]
    for mod, attr, orig in saved:
        setattr(mod, attr, first_args(attr, orig))
    try:
        for s_mono in mono.values():
            radiation(s_mono, *inputs_m)
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    for name, mod, attr, plain in one_g_kernels:
        args = one_g[attr]
        got = getattr(mod, attr)(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        rel = max(rel_to_max(x, y) for x, y in zip(got, ref))
        err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        errs[name] = max(errs[name], err)
        bound = OPTICS_REL.get(name, SWEEP_REL)
        log(f"{name} at one g-point: shape {tuple(args[0].shape)} worst "
            f"|diff|/max|plain| {rel:.3e} (bound {bound}), worst abs "
            f"{err:.3e}")
        if not rel <= bound or (name in ADDING and err != 0.0):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at one g-point")
    del one_g, got, ref
    for name, s_mono in mono.items():
        log(f"time {name}: {path_ms(lambda: radiation(s_mono, *inputs_m)):.3f}"
            f" ms per {NCOL}-column call [{gpu}]")

    # n. the SPARTACUS entrapment dump on 256 columns: B8 still carries the
    # fluxes, equal to those of the call without the dump; the plain
    # sweeps give the first g-point's internals; the driver's text files
    setup_dump = setup_radiation(spartacus_slice_config(
        **luts_fu, do_print_entrapment_data=True), device=dev)
    cols_d = slice_columns(cols_sp, slice(0, NCOL_DUMP))
    inputs_d = columns_to_inputs(cols_d, device=dev)
    flux_d = count("spartacus_dump", lambda: radiation(setup_dump,
                                                       *inputs_d))
    ref_d = radiation(setup_sp, *inputs_d)
    differ = [k for k, v in ref_d.fields()
              if not torch.equal(v, getattr(flux_d, k))]
    shapes = [tuple(x.shape) for x in flux_d.entrapment_data]
    finite = all(bool(torch.isfinite(x).all())
                 for x in flux_d.entrapment_data)
    driver._dump_entrapment_data(os.path.join(DRIVER_DIR, "dump.nc"),
                                 flux_d.entrapment_data)
    lines = [sum(1 for _ in open(os.path.join(DRIVER_DIR, "dump.nc" + ext)))
             for ext in (".fort.101", ".fort.102")]
    log(f"spartacus_dump: {len(differ)} of {len(ref_d.fields())} flux fields"
        f" differ from the call without the dump {differ}; internals "
        f"{shapes}, finite {finite}, largest migration distance "
        f"{float(flux_d.entrapment_data[0].max()):.1f} m; fort.101/102 "
        f"{lines} lines")
    if differ or not finite or shapes != [(NLEV, 3, NCOL_DUMP)] * 4 or \
            lines != [NLEV * NCOL_DUMP] * 2:
        raise AssertionError("the entrapment dump is wrong")
    # (the dump's plain sweeps launch small kernels level by level: one
    # call a repetition)
    log(f"time spartacus_dump: "
        f"{path_ms(lambda: radiation(setup_dump, *inputs_d), 1):.3f} ms per "
        f"{NCOL_DUMP}-column call with the dump, "
        f"{path_ms(lambda: radiation(setup_sp, *inputs_d)):.3f} without "
        f"[{gpu}]")
    del flux_d, ref_d, inputs_d, flux_ifs, setup_gp, setup_bd, mono

    # ---- the last modules: the tiled surface through the driver, the
    # comparison of output files, the columns split over devices ----
    from ecrad_tpu_torch import analysis
    from ecrad_tpu_torch.inputs import make_surface, write_surface
    from ecrad_tpu_torch.io.output import save_surface_fluxes
    from ecrad_tpu_torch.parallel import scaling
    from ecrad_tpu_torch.surface import (calc_boundary_conditions,
                                         partition_fluxes, read_surface)
    # o. the driver on a tiled surface at full width: the 2048 x 137
    # columns with make_clouds' clouds and make_surface's mls_london1
    # tiles in one NetCDF file; Cloudless (full-spectrum LW canopies with
    # their gas absorption: B1 and B2 twice) against its golden, McICA
    # (full-spectrum SW and LW canopies) against the same steps called
    # directly on the file's inputs
    surf_in = os.path.join(DRIVER_DIR, "surface_columns.nc")
    save_inputs(surf_in, *columns_to_inputs(cols_m, device=dev), None)
    write_surface(surf_in, make_surface(NCOL, SURFACE_REPRESENTATION, SEED))
    surf_out = {}
    for solver, name in (("Cloudless", "surface_cloudless"),
                         ("McICA", "surface_mcica")):
        nam = write_namelist(os.path.join(DRIVER_DIR, f"{name}.nam"), solver,
                             luts if solver == "McICA" else {},
                             cols["solar_irradiance"],
                             SURFACE_OPTIONS[solver])
        out = (os.path.join(DRIVER_DIR, f"{name}.nc"),
               os.path.join(DRIVER_DIR, f"{name}_facets.nc"))
        code = count(name, lambda: driver.main([nam, surf_in, *out]))
        if code != 0:
            raise AssertionError(f"the {name} driver run returned {code}")
        surf_out[solver] = (nam, out)
        check_surface_file(read_nc(out[1]), read_nc(out[0]), name)
    n_sc = launches["surface_cloudless"]
    if (n_sc["taumol_lw"], n_sc["taumol_sw"], n_sc["sw_adding"],
            n_sc["lw_noscat"]) != (2, 2, 1, 1):
        raise AssertionError(f"the Cloudless surface driver launched {n_sc}:"
                             f" not B1 and B2 twice (the canopies' gas "
                             f"optics), sw_adding and lw_noscat once")
    nam, (out, out_s) = surf_out["Cloudless"]
    with np.load(GOLDEN_SURF) as z:
        golden = {k: z[k] for k in z.files}
    ff, sf = read_nc(out), read_nc(out_s)
    f = {k: ff[v].astype(np.float64) for k, v in FILE_FLUXES.items()}
    check_fluxes(f, cols, NCOL)
    check_golden(f, golden, BOUNDS, BOUNDS, what=" surface driver",
                 jax_slack=True)
    check_golden({k: sf[v].astype(np.float64)
                  for k, v in SURFACE_FILE.items()}, golden, SURFACE_FILE,
                 SURFACE_BOUNDS, what=" surface facets", jax_slack=True)
    # the boundary fields, from the driver's steps on the file's inputs
    dcfg = load_driver_config_from_namelist(nam)
    cfg_s = dataclasses.replace(load_config_from_namelist(nam),
                                do_canopy_fluxes_sw=True,
                                do_canopy_fluxes_lw=True)
    setup_s = setup_radiation(cfg_s, device=dev)
    ins = read_input(surf_in, dcfg, device=dev)
    surface = read_surface(surf_in, device=dev)
    ext_lw = driver._lowest_level_extinction(setup_s, *ins[:3])
    bc = calc_boundary_conditions(setup_s, surface, ins[0].cos_sza,
                                  ext_lw_air=ext_lw)
    check_golden_rel({k: getattr(bc, k).double().cpu().numpy() for k in
                      ("sw_albedo_diffuse", "sw_albedo_direct",
                       "lw_emissivity", "lw_emission")}, golden,
                     ("sw_albedo_diffuse", "sw_albedo_direct",
                      "lw_emissivity", "lw_emission"), BC_REL,
                     what=" surface boundary")
    flux_s = radiation(setup_s, ins[0].replace(
        sw_albedo=bc.sw_albedo_diffuse, sw_albedo_direct=bc.sw_albedo_direct,
        lw_emissivity=bc.lw_emissivity, lw_emission=bc.lw_emission), *ins[1:])
    ms_bc = path_ms(lambda: calc_boundary_conditions(
        setup_s, surface, ins[0].cos_sza, ext_lw_air=ext_lw))
    ms_pf = path_ms(lambda: partition_fluxes(surface, bc.intermediate,
                                             flux_s))
    log(f"time surface: calc_boundary_conditions {ms_bc:.3f} ms, "
        f"partition_fluxes {ms_pf:.3f} ms per {NCOL}-column call "
        f"(representation {SURFACE_REPRESENTATION}, full-spectrum LW, "
        f"canopy gases) [{gpu}]")
    del bc, flux_s, ext_lw, setup_s
    # McICA: both files against the steps called directly
    nam, (out, out_s) = surf_out["McICA"]
    cfg_s = dataclasses.replace(load_config_from_namelist(nam),
                                do_canopy_fluxes_sw=True,
                                do_canopy_fluxes_lw=True)
    setup_s = setup_radiation(cfg_s, device=dev)
    ins = read_input(surf_in, load_driver_config_from_namelist(nam),
                     device=dev)
    bc = calc_boundary_conditions(setup_s, surface, ins[0].cos_sza)
    flux_s = radiation(setup_s, ins[0].replace(
        sw_albedo=bc.sw_albedo_diffuse, sw_albedo_direct=bc.sw_albedo_direct,
        lw_emissivity=bc.lw_emissivity, lw_emission=bc.lw_emission), *ins[1:])
    ref = (os.path.join(DRIVER_DIR, "surface_mcica_radiation.nc"),
           os.path.join(DRIVER_DIR, "surface_mcica_radiation_facets.nc"))
    save_fluxes(ref[0], flux_s, ins[1])
    save_surface_fluxes(ref[1], partition_fluxes(surface, bc.intermediate,
                                                 flux_s))
    for got, want in zip((out, out_s), ref):
        got, want = read_nc(got), read_nc(want)
        differ = [k for k in want if k not in got
                  or not np.array_equal(got[k], want[k])]
        log(f"surface_mcica: {len(got)} variables, {len(differ)} differ from"
            f" the steps called directly on the file's inputs {differ}")
        if differ or set(got) != set(want):
            raise AssertionError("the McICA surface driver's files differ "
                                 "from the steps called directly")
    del bc, flux_s, setup_s, ins, surface

    # p. analysis.compare (numpy only: no jax, no matplotlib here) on the
    # McICA driver file and the radiation() file: 0 in every field, in
    # process and through its command line
    stats = analysis.compare_outputs(analysis.load_inputs(surf_in),
                                     analysis.load_fluxes(out),
                                     analysis.load_fluxes(ref[0]))
    report = analysis.format_report(stats)
    log(report)
    cli = subprocess.run(
        [sys.executable, "-m", "ecrad_tpu_torch.analysis.compare", surf_in,
         out, ref[0], "--tolerance", "0"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    log(f"analysis.compare command line: rc {cli.returncode}, last line "
        f"{cli.stdout.splitlines()[-1] if cli.stdout else cli.stderr!r}")
    if (len(stats) != 16 or any(v.get("max_abs") != 0.0
                                for v in stats.values())
            or cli.returncode != 0 or report not in cli.stdout):
        raise AssertionError("analysis.compare does not show 0 for every "
                             "field of two equal files")

    # q. parallel on one card: the driver with do_parallel = true writes
    # the files of do_parallel = false bit for bit (one device: no split);
    # the scaling benchmark at 2048 x 137 McICA (information only)
    info = scaling.init_distributed()
    nam_p = write_namelist(os.path.join(DRIVER_DIR, "surface_mcica_par.nam"),
                           "McICA", luts, cols["solar_irradiance"],
                           SURFACE_OPTIONS["McICA"], parallel=True)
    out_p = (os.path.join(DRIVER_DIR, "surface_mcica_par.nc"),
             os.path.join(DRIVER_DIR, "surface_mcica_par_facets.nc"))
    code = driver.main([nam_p, surf_in, *out_p])
    differ = []
    for got, want in zip(out_p, (out, out_s)):
        got, want = read_nc(got), read_nc(want)
        differ += [k for k in want if k not in got
                   or not np.array_equal(got[k], want[k])]
    log(f"parallel: init_distributed {info}; do_parallel = true on "
        f"{torch.cuda.device_count()} device(s): rc {code}, {len(differ)} "
        f"variables differ from do_parallel = false {differ}")
    if code != 0 or differ:
        raise AssertionError("do_parallel changed the driver's files")
    bench = scaling.scaling_benchmark(
        lambda d, *a: radiation(setup_m, *a), inputs_m, nrepeat=3)
    log(f"scaling_benchmark McICA {NCOL} x {NLEV}: "
        + "; ".join(f"{r['devices']} device(s) {r['columns_per_sec']:.1f} "
                    f"columns/s, speedup {r['speedup']:.3f}, efficiency "
                    f"{r['efficiency']:.3f}" for r in bench) + f" [{gpu}]")

    # r. the profiler and the general matrix exponentials: the native host
    # cores built from csrc/host (no quiet fallback here: the machine has
    # a C++ compiler); McICA at full width with the hooks on and the
    # program's own spans inside an outer one with a synchronise: the
    # accounting of HOOK_REPS calls, its dump read back by
    # merge_hook_profiles, one call traced; expm_g and expm_sw_g on the
    # card
    from ecrad_tpu_torch.solvers import matrix
    from ecrad_tpu_torch.utils import hooks, native
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import merge_hook_profiles
    hooks.enable(True)
    hook_lib, fort_lib = native.hook_lib(), native.fort_lib()
    log(f"native cores: {getattr(hook_lib, '_name', None)}, "
        f"{getattr(fort_lib, '_name', None)}; hooks on {hooks.LHOOK}")
    if hook_lib is None or fort_lib is None or not hooks.LHOOK:
        raise AssertionError("the native host cores did not build from "
                             "ecrad_tpu_torch/csrc/host")
    rec = np.random.RandomState(SEED).standard_normal(37)
    rec_path = os.path.join(DRIVER_DIR, "records.bin")
    with open(rec_path, "wb") as f:
        for x in (rec[:1], rec):
            frame = np.array([8 * x.size], ">i4").tobytes()
            f.write(frame + x.astype(">f8").tobytes() + frame)
    with native.FortranFile(rec_path) as f:
        native_read = f._lib is not None
        got = [f.read_f64(), f.read_f64()]
    if not native_read or not (np.array_equal(got[0], rec[:1])
                               and np.array_equal(got[1], rec)):
        raise AssertionError("FortranFile's native reader misread")

    def hooked():
        with hooks.hook(HOOK_OUTER):
            out = radiation(setup_m, *inputs_m)
            torch.cuda.synchronize()
        return out
    try:
        count("hooks_mcica", hooked)
        hooks.reset_profile()
        for _ in range(HOOK_REPS):
            hooked()
        log(f"hooks.profile_report, {HOOK_REPS} McICA calls of {NCOL} x "
            f"{NLEV} [{gpu}]:\n{hooks.profile_report()}")
        rows = {r[0]: r[1:] for r in hooks._native_rows(hook_lib)}
        calls = {k: v[0] for k, v in rows.items()}
        want = {k: HOOK_REPS * v for k, v in HOOK_CALLS.items()}
        worse = [k for k, (_, tw, sw, _, _) in rows.items() if sw > tw]
        kids = sum(rows[k][1] for k in HOOK_CHILDREN)
        depth = hook_lib.ecr_hook_stack_depth()
        plain_stages = [k for k in calls if k in PLAIN_STAGES]
        log(f"hooks: calls {calls}; self above total in {worse}; "
            f"ecrad.radiation total {rows['ecrad.radiation'][1]:.6f} s, its "
            f"children's {kids:.6f} s; hooks.counters {hooks.counters()}; "
            f"stack depth {depth}; plain generator stages {plain_stages}")
        if ({k: calls.get(k) for k in want} != want or worse or plain_stages
                or rows["ecrad.radiation"][1] < kids or depth
                or rows[HOOK_OUTER][1] < rows["ecrad.radiation"][1]):
            raise AssertionError("the hook accounting is wrong")
        prof = hooks.dump_profile(os.path.join(DRIVER_DIR, "ecrhook.prof.0"))
        wall, parsed = merge_hook_profiles.parse_profile(prof)
        acc, walls = merge_hook_profiles.merge([(wall, parsed)])
        merged = {k: v["calls"] for k, v in acc.items()}
        log(f"dump_profile {prof}: walltime {wall:.6f} s; merged calls "
            f"{merged}")
        if merged != calls or walls["nproc"] != 1:
            raise AssertionError("merge_hook_profiles misreads the dump")
        trace_dir = os.path.join(DRIVER_DIR, "trace")
        if os.path.isdir(trace_dir):
            for name in os.listdir(trace_dir):
                os.remove(os.path.join(trace_dir, name))
        hooks.start_trace(trace_dir)
        hooked()
        hooks.stop_trace()
        spans, inside, cats = trace_kernels_in_span(
            trace_dir, "ecrad.gas_optics",
            ("taumol_lw_kernel", "taumol_sw_kernel"))
        log(f"trace: {len(spans)} ecrad.gas_optics host span(s); (kernels, "
            f"launched inside the span, run inside its device range) "
            f"{inside}; event categories {cats}")
        if len(spans) != 1 or any(n != 1 or not (h == n or d == n)
                                  for n, h, d in inside.values()):
            raise AssertionError("the trace does not hold B1 and B2 in the "
                                 "ecrad.gas_optics span")
        # McICA's ms a call with the hooks off and on in turns (0, 1, 1, 0)
        turns = []
        for on in (False, True, True, False):
            hooks.enable(on)
            turns.append(path_ms(lambda: radiation(setup_m, *inputs_m), 10))
    finally:
        hooks.enable(False)
    log(f"time hooks: McICA {NCOL} x {NLEV} with the program's spans, the "
        f"hooks off, on, on, off: {', '.join(f'{t:.3f}' for t in turns)} ms "
        f"per call (best of 2 x 10) [{gpu}]")
    # expm_g on the direct block (3 x 3) and expm_sw_g on the whole
    # generator (6 x 6 + 3 x 3) at 112 x 2048, float32 on the card,
    # against float64 and float32 on the CPU
    M, C, D = sw_generators(MATRIX_G, NCOL, SEED)
    counts = matrix._squaring_count(matrix._norm1_sw(M, C, D),
                                    matrix._THETA3, matrix._MAX_SQUARINGS)[0]
    for name, fn, args in (("expm_g 3x3", matrix.expm_g, (D,)),
                           ("expm_sw_g 6x6+3x3", matrix.expm_sw_g,
                            (M, C, D))):
        ref64 = fn(*args)
        ref32 = fn(*(a.float() for a in args))
        on_card = tuple(a.to(dev, torch.float32) for a in args)
        got = fn(*on_card)
        torch.cuda.synchronize()
        if name.startswith("expm_g"):
            ref64, ref32, got = (ref64,), (ref32,), (got,)
        got = [x.cpu() for x in got]
        e64 = max(rel_to_max(x.double(), y) for x, y in zip(got, ref64))
        e32 = max(rel_to_max(x, y) for x, y in zip(got, ref32))
        ms_m = time_ms(lambda: fn(*on_card), 3)
        log(f"{name} at {MATRIX_G} x {NCOL}: float32 on the card against "
            f"float64 on the CPU, worst |diff|/max|ref| {e64:.3e}, against "
            f"float32 on the CPU {e32:.3e} (bound {MATRIX_REL}); squaring "
            f"counts {torch.bincount(counts.flatten()).tolist()}; {ms_m:.3f}"
            f" ms a call [{gpu}]")
        if not (e64 <= MATRIX_REL and e32 <= MATRIX_REL):
            raise AssertionError(f"{name} on the card is outside its bound")
    del M, C, D, ref64, ref32, got, on_card

    # ---- 4. times (information only) ----
    timing = {
        "taumol_lw": (lambda: taumol_lw.taumol_lw_kernel(fc_lw, ic_lw,
                                                         setup.gas.lw),
                      lambda: taumol_lw.taumol_lw_plain(fc_lw, ic_lw,
                                                        setup.gas.lw)),
        "taumol_sw": (lambda: taumol_sw.taumol_sw_kernel(fc_sw, ic_sw,
                                                         setup.gas.sw),
                      lambda: taumol_sw.taumol_sw_plain(fc_sw, ic_sw,
                                                        setup.gas.sw)),
        "sw_adding": (lambda: adding_fused.adding_sw_fused(*sw_args),
                      lambda: adding.adding_sw_plain(*sw_args)),
        "lw_noscat": (lambda: adding_fused.lw_noscat_fused(*lw_args),
                      lambda: adding.lw_no_scattering_fluxes_plain(
                          *lw_args)),
        "lw_adding": (lambda: adding_fused.adding_lw_fused(*lwadd_args),
                      lambda: adding.adding_lw_plain(*lwadd_args)),
        "mcica_sw_optics": (
            lambda: mcica_optics.mcica_sw_optics_fused(*b4_sw_args),
            lambda: mcica_optics.sw_clear_total_reftrans_plain(
                *b4_sw_args)),
        "mcica_lw_optics": (
            lambda: mcica_optics.mcica_lw_optics_fused(*b4_lw_args),
            lambda: mcica_optics.lw_clear_total_noscat_plain(*b4_lw_args)),
        # both generator calls of a McICA radiation call, float32
        "threefry_fields": (
            lambda: [rf.random_fields_kernel(iseed, ng, NLEV, torch.float32)
                     for (ng, _), iseed in zip(GENERATOR_CALLS, rf_seeds)],
            lambda: [rf.random_fields_plain(iseed, ng, NLEV, torch.float32)
                     for (ng, _), iseed in zip(GENERATOR_CALLS, rf_seeds)]),
        # the cloud generator: both calls of a McICA radiation call on the
        # path's cloud, float32 and float64 (the float64 path's calls)
        "mcica_generator": (
            lambda: [mg.generator_kernel(*a) for a in gen_args],
            lambda: [cloud_generator_plain(*a) for a in gen_args]),
        "mcica_generator_f64": (
            lambda: [mg.generator_kernel(*a) for a in gen_calls],
            lambda: [cloud_generator_plain(*a) for a in gen_calls]),
        "tc_sw_optics": (
            lambda: tc_optics.tc_sw_optics_fused(*path_args["tc_sw_optics"]),
            lambda: tc_optics.tc_sw_optics_plain(
                *path_args["tc_sw_optics"])),
        "aerosol_optics": (
            lambda: interface.add_aerosol_optics(
                *path_args["aerosol_optics"]),
            lambda: aerosol_module.add_aerosol_optics_plain(
                *path_args["aerosol_optics"])),
        "tc_sw_sweeps": (
            lambda: adding_fused.tc_sw_sweeps_fused(
                *path_args["tc_sw_sweeps"]),
            lambda: tripleclouds.tc_sw_sweeps_plain(
                *path_args["tc_sw_sweeps"])),
        "tc_lw_sweeps": (
            lambda: adding_fused.tc_lw_sweeps_fused(
                *path_args["tc_lw_sweeps"]),
            lambda: tripleclouds.tc_lw_sweeps_plain(
                *path_args["tc_lw_sweeps"])),
        "spartacus_sw_reftrans": (
            lambda: sr.sw_reftrans_levels_fused(
                *path_args["sw_reftrans_levels"]),
            lambda: sr.sw_reftrans_levels_plain(
                *path_args["sw_reftrans_levels"])),
        "spartacus_lw_reftrans": (
            lambda: sr.lw_reftrans_levels_fused(
                *path_args["lw_reftrans_levels"]),
            lambda: sr.lw_reftrans_levels_plain(
                *path_args["lw_reftrans_levels"])),
        "spartacus_sw_adding": (
            lambda: sa.sw_adding_sweeps_fused(*path_args["sw_adding_sweeps"]),
            lambda: sa.sw_adding_sweeps_plain(*path_args["sw_adding_sweeps"])),
        "spartacus_lw_adding": (
            lambda: sa.lw_adding_sweeps_fused(*path_args["lw_adding_sweeps"]),
            lambda: sa.lw_adding_sweeps_plain(*path_args["lw_adding_sweeps"])),
    }
    # the double forms on the first of their float64 path calls
    for name, (mod, attr, plain, _) in f64_kernels.items():
        timing[name + "_f64"] = (
            lambda k=getattr(mod, attr), a=f64_args[name][0]: k(*a),
            lambda p=plain, a=f64_args[name][0]: p(*a))
    # B10 per gas-optics call: its 30 launches on operands packed
    # beforehand, issued from Python; the same launches replayed from a
    # CUDA graph (without the host's gaps between launches) and the
    # wrapper with its packing are timed apart. The plain version's 30
    # calls, and one embedding_bag call per launch on the same flattened
    # operands (information: nothing on the path calls it)
    packed = [(gi.pack_sections(secs, n, dev), n) for secs, n in b10_calls]
    b10_out = [torch.empty((p.g, n), device=dev) for p, n in packed]

    def b10_kernel():
        for ((p, n), out), (tile, _) in zip(zip(packed, b10_out), b10_plans):
            _cuda.launch("gather_sections", p.desc, p.desc.numel(), p.ptrs,
                         p.ptrs.numel(), p.tab, n, p.g, tile, out)
    b10_kernel()
    torch.cuda.synchronize()
    b10_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(b10_graph):
        b10_kernel()
    timing["gather_sections"] = (
        b10_kernel, lambda: [gi.eval_sections_plain(secs, n)
                             for secs, n in b10_calls])
    lib_args = [flat_terms(secs, dev) for secs, _ in b10_calls]
    lib_err = max(rel_to_max(torch.nn.functional.embedding_bag(
        idx, tab, per_sample_weights=w, mode="sum").T,
        gi.eval_sections_plain(secs, n))
        for (idx, tab, w), (secs, n) in zip(lib_args, b10_calls))
    library_ms = {"gather_sections": time_ms(lambda: [
        torch.nn.functional.embedding_bag(idx, tab, per_sample_weights=w,
                                          mode="sum")
        for idx, tab, w in lib_args], 20)}
    graph_ms = time_ms(b10_graph.replay, 20)
    wrapper_ms = time_ms(lambda: [gi.eval_sections_kernel(secs, n)
                                  for secs, n in b10_calls], 20)
    log(f"time gather_sections: embedding_bag on the flattened operands "
        f"{library_ms['gather_sections']:.4f} ms per gas-optics call "
        f"(worst |diff|/max|plain| {lib_err:.3e}); the 30 launches "
        f"replayed from a CUDA graph {graph_ms:.4f} ms, the wrapper with "
        f"its packing {wrapper_ms:.4f} ms; each moves {b10_moved / 1e9:.3f} GB (each "
        f"row and weight tensor read in place once, the tables' live "
        f"columns, the outputs; {b10_bytes / 1e9:.3f} GB least) [{gpu}]")
    del lib_args
    ms = {}
    for name, (kern, plain) in timing.items():
        # the SPARTACUS plain versions take seconds per call: one timed
        ms[name] = (time_ms(kern, 20),
                    time_ms(plain, 1 if name.startswith("spartacus") else 3))
        b_ms, b_by, nbytes, ops = bounds[name]
        log(f"time {name}: kernel {ms[name][0]:.4f} ms, plain "
            f"{ms[name][1]:.4f} ms, least time {b_ms:.4f} ms by {b_by} "
            f"({nbytes / 1e9:.3f} GB, {ops / 1e9:.2f} Gop; "
            f"{b_ms / ms[name][0]:.1%} of it reached) [{gpu}]")
    # B1 runs as one pass (each warp builds a band's terms and sums its
    # outputs in turn): its rate on its least bytes (the fields read, the
    # two (N, 140) outputs written)
    b1_bytes, b1_ms = bounds["taumol_lw"][2], ms["taumol_lw"][0]
    log(f"time taumol_lw: {b1_ms:.4f} ms in one pass, {b1_bytes / 1e9:.3f} "
        f"GB least, {b1_bytes / b1_ms / 1e9:.3f} TB/s [{gpu}]")
    # B2 likewise (its least bytes are what its design moves from device
    # memory), beside the table values it gathers from L1/L2: ng_b per slot
    # of each band, 1,166 a cell
    b2_bytes, b2_ms = bounds["taumol_sw"][2], ms["taumol_sw"][0]
    gathered = fc_sw.shape[1] * sum(
        ng * (kg + kr) for ng, kg, kr in zip(taumol_sw.NG, taumol_sw.K_TAUG,
                                             taumol_sw.K_TAUR))
    log(f"time taumol_sw: {b2_ms:.4f} ms in one pass, {b2_bytes / 1e9:.3f} "
        f"GB least, {b2_bytes / b2_ms / 1e9:.3f} TB/s; {gathered / 1e9:.3f} "
        f"G table values gathered, {gathered / b2_ms / 1e6:.1f} G/s [{gpu}]")
    # B3 sw_adding and B3' lw_adding: the rate on the bytes each design
    # moves (SW: tdir, the ascent's 4 operands and the descent's 4 read, 3
    # fluxes written; LW: 4 and 3 read, 2 written; per level past the
    # window 2 floats written and read back), at the path's 137
    # levels and at ADD_SPILL_NLEV (the device-memory branch)
    for name, kern, plain, args137 in (
            ("sw_adding", adding_fused.adding_sw_fused,
             adding.adding_sw_plain, sw_args),
            ("lw_adding", adding_fused.adding_lw_fused,
             adding.adding_lw_plain, lwadd_args)):
        for args in (args137, spill_args[name]):
            nlev, ng, ncol = args[0].shape
            profiles = (9 * nlev + 3 * (nlev + 1) if name == "sw_adding"
                        else 7 * nlev + 2 * (nlev + 1))
            spilled = max(nlev - (adding_fused.SW_ONCHIP_LEVELS
                                  if name == "sw_adding"
                                  else adding_fused.LW_ONCHIP_LEVELS), 0)
            moved = 4 * ng * ncol * (profiles + 4 * spilled)
            t_k, t_p = ((ms[name][0], ms[name][1]) if nlev == NLEV else
                        (time_ms(lambda: kern(*args), 20),
                         time_ms(lambda: plain(*args), 3)))
            log(f"time {name}, {nlev} levels: kernel {t_k:.4f} ms, plain "
                f"{t_p:.4f} ms, on the {moved / 1e9:.3f} GB its design "
                f"moves {moved / t_k / 1e9:.3f} TB/s [{gpu}]")
    # B5: the rate on the bytes its design moves on this run's clear
    # sectors, beside the bytes of every region in every sector; and with
    # 2 regions (the path's operands cut to two)
    for name in ("tc_sw_sweeps", "tc_lw_sweeps"):
        kern = (adding_fused.tc_sw_sweeps_fused if name == "tc_sw_sweeps"
                else adding_fused.tc_lw_sweeps_fused)
        for args in (path_args[name], tc_two_regions(name[3:5],
                                                     path_args[name])):
            moved, full, clear_share = tc_moved_bytes(name[3:5], args)
            nreg = args[0].shape[1]
            t_k = ms[name][0] if nreg == 3 else time_ms(
                lambda: kern(*args), 20)
            log(f"time {name}, {nreg} regions: kernel {t_k:.4f} ms on the "
                f"{moved / 1e9:.3f} GB its design moves ({clear_share:.1%} "
                f"of the (level, 8-column sector) pairs clear; every region "
                f"in every sector {full / 1e9:.3f} GB), "
                f"{moved / t_k / 1e9:.3f} TB/s [{gpu}]")
    # B6's two passes apart on the path's operands: pass 1 over the 3D
    # cells (its counter zeroed first, one memset timed with it), staging
    # their rows; pass 2 over every cell, from what pass 1 left
    mgod, od, ssa, g, trd, trf, mu0_sp, use3d, clear = \
        path_args["sw_reftrans_levels"]
    nlev, nreg, ng, ncol = od.shape
    cells, rows = use3d.numel(), 5 * nreg * nreg
    cap = -(-cells // sr._STAGED_SHARE)
    out6 = torch.empty((nlev, rows, ng, ncol), device=dev)
    cnt6 = torch.empty(use3d.shape, dtype=torch.int8, device=dev)
    packed6 = torch.empty((rows, cap), device=dev)
    slot6 = torch.empty(cells, dtype=torch.int32, device=dev)
    n3d = torch.zeros(1, dtype=torch.int32, device=dev)

    def pass_3d():
        n3d.zero_()
        _cuda.launch("spartacus_sw_reftrans_3d", od, ssa, g, trd, trf,
                     mu0_sp, use3d, clear, out6, cnt6, packed6, slot6, n3d,
                     nreg, nlev, ng, ncol, cap, mgod)

    def pass_lean():
        _cuda.launch("spartacus_sw_reftrans_fallback", od, ssa, g, mu0_sp,
                     use3d, clear, packed6, slot6, out6, cnt6, nreg, nlev,
                     ng, ncol, cap)
    ms_3d, ms_lean = time_ms(pass_3d, 20), time_ms(pass_lean, 20)
    listed, n3_counts = int(n3d.item()), int((cnt6 >= 0).sum())
    staged, n_fb = min(listed, cap), cells - listed
    # pass 1's operations from the doubling counts; pass 2's bytes: use3d
    # of every cell, od/ssa/g read, the rows and a count written per
    # fallback cell, the slot and the rows read and the rows written per
    # staged cell
    ops_3d = doubling_ops("spartacus_sw_reftrans", cnt6) \
        - n_fb * SPARTACUS_OPS["spartacus_sw_reftrans"][0]
    bytes_lean = cells + n_fb * (3 * nreg * 4 + rows * 4 + 1) \
        + staged * (4 + 2 * rows * 4)
    log(f"time spartacus_sw_reftrans pass 1, 3D cells: {ms_3d:.4f} ms "
        f"({ops_3d / 1e9:.2f} Gop, {ops_3d / ms_3d / 1e9:.2f} Top/s); pass "
        f"2, every cell: {ms_lean:.4f} ms ({bytes_lean / 1e9:.3f} GB, "
        f"{bytes_lean / ms_lean / 1e9:.3f} TB/s); 3D cells listed {listed} "
        f"= {listed / cells:.4f} of the cells ({staged} staged), counts >= "
        f"0 in {n3_counts} [{gpu}]")
    if listed != n3_counts or listed != int(use3d.sum()):
        raise AssertionError("B6's 3D cells differ from its counts")
    # B8's rate on the bytes its design moves: per (level, g, column) the
    # history read twice less RD going down, the scratch albedos written
    # and read, the fluxes written (13 n^2 + 3 n floats), and per level and
    # g-tile (B8_G_TILE g-points) the per-column rows it stages
    hist8 = path_args["sw_adding_sweeps"][1]
    nlev, _, ng, ncol = hist8.shape
    n = round((hist8.shape[1] // 5) ** 0.5)
    moved = 4 * nlev * ng * ncol * (13 * n * n + 3 * n) + 4 * nlev * ncol \
        * (37 + 11) * -(-ng // B8_G_TILE)
    # and under Maximum entrapment: the same bytes with a few hundred
    # operations per (level, g, column), its floor as the design moves them
    cfg8 = path_args["sw_adding_sweeps"][0]
    cfg_max = dataclasses.replace(cfg8,
                                  i_3d_sw_entrapment=Entrapment.MAXIMUM)
    ms_max = time_ms(lambda: sa.sw_adding_sweeps_fused(
        cfg_max, *path_args["sw_adding_sweeps"][1:]), 20)
    log(f"time spartacus_sw_adding: {ms['spartacus_sw_adding'][0]:.4f} ms "
        f"({cfg8.i_3d_sw_entrapment.name}) on the {moved / 1e9:.3f} GB its "
        f"design moves, {moved / ms['spartacus_sw_adding'][0] / 1e9:.3f} "
        f"TB/s; {ms_max:.4f} ms under MAXIMUM entrapment, "
        f"{moved / ms_max / 1e9:.3f} TB/s [{gpu}]")
    del out6, cnt6, packed6, slot6, hist8
    # B7's two passes apart, likewise: pass 1 over the 3D cells, staging
    # their rows, pass 2 over every cell, from what pass 1 left
    mgod, scat, od, ssa, g, tr, se, pt, pb, fr, use3d, clear = \
        path_args["lw_reftrans_levels"]
    nlev, nreg, ng, ncol = od.shape
    cells, rows = use3d.numel(), 2 * nreg * (nreg + 1)
    cap = -(-cells // sr._STAGED_SHARE)
    out7 = torch.empty((nlev, rows, ng, ncol), device=dev)
    cnt7 = torch.empty(use3d.shape, dtype=torch.int8, device=dev)
    packed7 = torch.empty((cap, rows), device=dev)
    slot7 = torch.empty(cells, dtype=torch.int32, device=dev)

    def pass_3d_lw():
        n3d.zero_()
        _cuda.launch("spartacus_lw_reftrans_3d", od, ssa, g, tr, se, pt, pb,
                     fr, use3d, clear, out7, cnt7, packed7, slot7, n3d, nreg,
                     nlev, ng, ncol, cap, mgod)

    def pass_lean_lw():
        _cuda.launch("spartacus_lw_reftrans_fallback", od, ssa, g, pt, pb,
                     fr, use3d, clear, packed7, slot7, out7, cnt7, nreg, nlev,
                     ng, ncol, cap, int(bool(scat)))
    ms_3d, ms_lean = time_ms(pass_3d_lw, 20), time_ms(pass_lean_lw, 20)
    listed, n3_counts = int(n3d.item()), int((cnt7 >= 0).sum())
    staged, n_fb = min(listed, cap), cells - listed
    ops_3d = doubling_ops("spartacus_lw_reftrans", cnt7) \
        - n_fb * SPARTACUS_OPS["spartacus_lw_reftrans"][0]
    # pass 2: use3d of every cell; per fallback cell od (and ssa, g with
    # cloud scattering), pt and pb read, the rows and a count written; per
    # staged cell the slot and the rows read and the rows written
    bytes_lean = cells + n_fb * ((nreg * (3 if scat else 1) + 2) * 4
                                 + rows * 4 + 1) \
        + staged * (4 + 2 * rows * 4)
    log(f"time spartacus_lw_reftrans pass 1, 3D cells: {ms_3d:.4f} ms "
        f"({ops_3d / 1e9:.2f} Gop, {ops_3d / ms_3d / 1e9:.2f} Top/s); pass "
        f"2, every cell: {ms_lean:.4f} ms ({bytes_lean / 1e9:.3f} GB, "
        f"{bytes_lean / ms_lean / 1e9:.3f} TB/s); 3D cells listed {listed} "
        f"= {listed / cells:.4f} of the cells ({staged} staged), counts >= "
        f"0 in {n3_counts} [{gpu}]")
    if listed != n3_counts or listed != int(use3d.sum()):
        raise AssertionError("B7's 3D cells differ from its counts")
    del out7, cnt7, packed7, slot7
    # B9 with multilayer effects off (the path's) and on, on the path's
    # history: the rate on the bytes each design moves, per (level, g,
    # column) the history read twice less SU going down, the scratch
    # written and read, the fluxes written (4 n^2 + 5 n floats and twice
    # the scratch's n^2 + n with multilayer, 2 n without: 75 and 63 floats
    # at 3 regions), and per level and g-tile (B9_G_TILE g-points) the
    # per-column rows it stages (3 n^2 + 4)
    cfg9, use_matrix9, hist9, cols9, init9 = path_args["lw_adding_sweeps"]
    nlev, _, ng, ncol = hist9.shape
    n = {12: 2, 24: 3}[hist9.shape[1]]
    for multilayer in (False, True):
        cfg_ml = dataclasses.replace(cfg9,
                                     do_3d_lw_multilayer_effects=multilayer)
        ns = n * n + n if multilayer else 2 * n
        moved = 4 * nlev * ng * ncol * (4 * n * n + 5 * n + 2 * ns) \
            + 4 * nlev * ncol * (3 * n * n + 4) * -(-ng // B9_G_TILE)
        t9 = time_ms(lambda: sa.lw_adding_sweeps_fused(
            cfg_ml, use_matrix9, hist9, cols9, init9), 20)
        log(f"time spartacus_lw_adding, multilayer {multilayer}: {t9:.4f} ms"
            f" on the {moved / 1e9:.3f} GB its design moves "
            f"({(4 * n * n + 5 * n + 2 * ns)} floats per (level, g, column))"
            f", {moved / t9 / 1e9:.3f} TB/s [{gpu}]")
    del hist9, cols9, init9

    # the kernels' operands are not needed any more: the paths' peak
    # memory below is what a call adds to its inputs and setup
    del timing, path_args, sw_args, lw_args, lwadd_args, b4_sw_args, b4_lw_args
    del spill_args
    del go, planck, props, cloud_m, osc_lw, od_t, ssa_t, g_t, zeros_sw
    del zeros_lw, frac_mask, fc_lw, ic_lw, fc_sw, ic_sw, c, c_sf, gc, args
    del rc, b10_calls, packed, b10_out, b10_graph, secs, a, b
    del f64_args, gen_calls
    torch.cuda.empty_cache()

    # B6-B9's double forms on the float64 SPARTACUS path's operands, once
    # the other kernels' operands are freed (the float64 call and its
    # kept operands take some 50 GB): one float64 SPARTACUS call (the
    # configuration of the benchmark's float64 SPARTACUS cell) on the
    # SPARTACUS path's 2048 x 137 columns, the hooks' counters reset just
    # before it and read just after, each double form's operands kept;
    # each against its plain version in float64 and timed
    setup_sp64 = setup_radiation(spartacus_slice_config(
        **luts_fu, dtype="float64"), device=dev)
    # name: (module, wrapper, plain version, the sweeps' clear rows)
    sp64_kernels = {
        "spartacus_sw_reftrans": (sr, "sw_reftrans_levels_fused",
                                  sr.sw_reftrans_levels_plain, None),
        "spartacus_lw_reftrans": (sr, "lw_reftrans_levels_fused",
                                  sr.lw_reftrans_levels_plain, None),
        "spartacus_sw_adding": (sa, "sw_adding_sweeps_fused",
                                sa.sw_adding_sweeps_plain,
                                (sa._CLEAR, sa._CLEARP)),
        "spartacus_lw_adding": (sa, "lw_adding_sweeps_fused",
                                sa.lw_adding_sweeps_plain,
                                (sa._LCLEAR, sa._LCLEARP))}
    sp64_fns = [(mod, attr, getattr(mod, attr))
                for mod, attr, _, _ in sp64_kernels.values()]
    sp64_args = {name: [] for name in sp64_kernels}

    def kept64(name, fn):
        def wrapped(*args):
            sp64_args[name].append(args)
            return fn(*args)
        return wrapped
    for name, (mod, attr, fn) in zip(sp64_kernels, sp64_fns):
        setattr(mod, attr, kept64(name, fn))
    hooks.enable(True)
    hooks.reset_profile()
    try:
        flux_sp64 = radiation(setup_sp64, *inputs_sp)
        torch.cuda.synchronize()
        counts_sp64 = hooks.counters()
    finally:
        for mod, attr, fn in sp64_fns:
            setattr(mod, attr, fn)
        hooks.reset_profile()
        hooks.enable(False)
    launched = {k: v for k, v in counts_sp64.items()
                if k.startswith(("launch.", "plain_on_device."))}
    not_f64 = [k for k, v in flux_sp64.fields()
               if v.dtype != torch.float64]
    log(f"path spartacus_f64: launch and plain-on-device counters "
        f"{launched}; output fields not float64: {not_f64}")
    if launched != {f"launch.{k}.f64": n
                    for k, n in SPARTACUS_F64_LAUNCHES.items()}:
        raise AssertionError("the float64 SPARTACUS call did not launch "
                             "each kernel of its path in its double form "
                             "alone")
    if not_f64:
        raise AssertionError(f"float64 SPARTACUS call: {not_f64} not "
                             f"float64")
    del flux_sp64
    for name, (mod, attr, plain, clear_rows) in sp64_kernels.items():
        torch.cuda.empty_cache()
        kern, calls = getattr(mod, attr), sp64_args[name]
        if len(calls) != 1:
            raise AssertionError(f"{name}: {len(calls)} calls on the "
                                 f"float64 SPARTACUS path")
        args = calls[0]
        if clear_rows is None:
            # B6/B7 with their doubling counts, for their operations
            use3d = args[7] if name == "spartacus_sw_reftrans" else args[10]
            counts = torch.empty(use3d.shape, dtype=torch.int8, device=dev)
            got = (kern(*args, counts=counts),)
            ops = doubling_ops(name, counts)
        else:
            got = kern(*args)
            hist = args[1] if name == "spartacus_sw_adding" else args[2]
            ops = sweep_ops(name, args[-3 if name == "spartacus_sw_adding"
                                       else -2], hist.shape[2], clear_rows)
        torch.cuda.synchronize()
        want = plain(*args)
        want = (want,) if isinstance(want, torch.Tensor) else want
        if any(x.dtype != torch.float64 for x in got):
            raise AssertionError(f"{name} in float64 returned another dtype")
        # the gaps level by level: a whole output's difference would not
        # fit beside the kept operands
        gaps = [max(float((a - b).abs().max()) for a, b in zip(x, y))
                for x, y in zip(got, want)]
        rel = max(g / max(float(y.abs().max()), 1e-30)
                  for g, y in zip(gaps, want))
        errs[name + "_f64"] = max(gaps)
        bounds[name + "_f64"] = least_time(name, args, got, ops=ops,
                                           ops_per_s=F64_OPS_PER_S)
        log(f"{name} float64: shape {tuple(got[0].shape)} worst "
            f"|diff|/max|plain| {rel:.3e} (bound {F64_TAUMOL_REL}), worst "
            f"abs {errs[name + '_f64']:.3e}")
        if not rel <= F64_TAUMOL_REL:
            raise AssertionError(f"{name} in float64 disagrees with its "
                                 f"plain version")
        del got, want
        # the kernel's wrapper, and its plain version once (seconds a call)
        n64 = name + "_f64"
        ms[n64] = (time_ms(lambda: kern(*args), 10),
                   time_ms(lambda: plain(*args), 1))
        b_ms, b_by, nbytes, ops = bounds[n64]
        log(f"time {n64}: kernel {ms[n64][0]:.4f} ms, plain "
            f"{ms[n64][1]:.4f} ms, least time {b_ms:.4f} ms by {b_by} "
            f"({nbytes / 1e9:.3f} GB, {ops / 1e9:.2f} Gop at the FP64 rate; "
            f"{b_ms / ms[n64][0]:.1%} of it reached) [{gpu}]")
        del calls[:], args
    del sp64_args, setup_sp64
    torch.cuda.empty_cache()

    def per_band(run):
        def wrapped():
            os.environ["ECRAD_FUSED_TAUMOL"] = "0"
            out = run()
            del os.environ["ECRAD_FUSED_TAUMOL"]
            return out
        return wrapped
    for name, run in (("cloudless", lambda: radiation(setup, sl, th, gas)),
                      ("cloudless_per_band",
                       per_band(lambda: radiation(setup, sl, th, gas))),
                      ("mcica", lambda: radiation(setup_m, *inputs_m)),
                      ("tripleclouds",
                       lambda: radiation(setup_t, *inputs_t)),
                      ("spartacus",
                       lambda: radiation(setup_sp, *inputs_sp))):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        best = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                out = run()
            torch.cuda.synchronize()
            best.append((time.perf_counter() - t0) / 10)
        del out
        log(f"path {name}: {min(best) * 1e3:.3f} ms per {NCOL}-column call, "
            f"{NCOL / min(best):.1f} columns/s, peak memory "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB "
            f"above the inputs and setups [{gpu}]")

    # the broadband g sums (interface._gsum: the g-points added in
    # halves, the same bits in any batch) against the x.sum(1) they
    # replaced: alone on the LW operand's shape, and on the Cloudless path
    # in turns (x.sum(1), halves, halves, x.sum(1))
    from ecrad_tpu_torch import interface
    halves = interface._gsum

    def one_sum(x):
        return x.sum(1).T
    xg = torch.rand(NLEV + 1, 140, NCOL, device=dev)
    log(f"time g sums of {tuple(xg.shape)}: halves "
        f"{time_ms(lambda: halves(xg), 20):.4f} ms, x.sum(1) "
        f"{time_ms(lambda: one_sum(xg), 20):.4f} ms [{gpu}]")
    del xg
    turns = []
    for form in (one_sum, halves, halves, one_sum):
        interface._gsum = form
        turns.append(path_ms(lambda: radiation(setup, sl, th, gas), 10))
    interface._gsum = halves
    log(f"time cloudless with the g sums as x.sum(1), halves, halves, "
        f"x.sum(1): {', '.join(f'{t:.3f}' for t in turns)} ms per "
        f"{NCOL}-column call [{gpu}]")

    level_sweep = ("ecrad_tpu_torch/csrc/level_sweep.cu",
                   "ecrad_tpu/ops/adding_fused.py:125")
    tc_sweeps = "ecrad_tpu_torch/csrc/tc_sweeps.cu"
    sp_rt = "ecrad_tpu_torch/csrc/spartacus_reftrans.cu"
    sp_add = "ecrad_tpu_torch/csrc/spartacus_adding.cu"
    jrt, jadd = "ecrad_tpu/ops/spartacus_reftrans.py", \
        "ecrad_tpu/ops/spartacus_adding.py"
    src = {"taumol_lw": ("ecrad_tpu_torch/csrc/taumol_lw.cu",
                         "ecrad_tpu/optics/rrtmg/taumol_lw_fused.py:896"),
           "taumol_sw": ("ecrad_tpu_torch/csrc/taumol_sw.cu",
                         "ecrad_tpu/optics/rrtmg/taumol_sw_fused.py:400"),
           "sw_adding": level_sweep, "lw_noscat": level_sweep,
           "lw_adding": level_sweep,
           "mcica_sw_optics": ("ecrad_tpu_torch/csrc/mcica_optics.cu",
                               "ecrad_tpu/ops/mcica_optics.py:181"),
           "mcica_lw_optics": ("ecrad_tpu_torch/csrc/mcica_optics.cu",
                               "ecrad_tpu/ops/mcica_optics.py:269"),
           "tc_sw_optics": ("ecrad_tpu_torch/csrc/tc_optics.cu",
                            "none: XLA elementwise passes in ecrad_tpu/"
                            "solvers/tripleclouds.py:156-225"),
           "aerosol_optics": ("ecrad_tpu_torch/csrc/aerosol_optics.cu",
                              "none: XLA matrix products and elementwise "
                              "passes in ecrad_tpu/optics/aerosol.py"),
           "tc_sw_sweeps": (tc_sweeps, "ecrad_tpu/ops/adding_fused.py:290"),
           "tc_lw_sweeps": (tc_sweeps, "ecrad_tpu/ops/adding_fused.py:361"),
           "spartacus_sw_reftrans": (sp_rt, f"{jrt}:350"),
           "spartacus_lw_reftrans": (sp_rt, f"{jrt}:676"),
           "spartacus_sw_adding": (sp_add, f"{jadd}:399"),
           "spartacus_lw_adding": (sp_add, f"{jadd}:614"),
           "gather_sections": ("ecrad_tpu_torch/csrc/gather_sections.cu",
                               "ecrad_tpu/ops/gather_interp.py:267"),
           "threefry_fields": ("ecrad_tpu_torch/csrc/threefry.cu",
                               "none: jax.random in ecrad_tpu/solvers/"
                               "cloud_generator.py:73-85"),
           "mcica_generator": ("ecrad_tpu_torch/csrc/mcica_generator.cu",
                               "none: lax.scan and while_loop in ecrad_tpu/"
                               "solvers/cloud_generator.py, cloud_cover.py")}
    # the double forms (name_f64) come from the float forms' sources
    f64_names = [*f64_kernels, "mcica_generator"]
    src.update({n + "_f64": src[n] for n in f64_names})
    launches["mcica_f64"] = {f"{n}_f64": F64_LAUNCHES[n] for n in f64_names}
    src.update({n + "_f64": src[n] for n in sp64_kernels})
    launches["spartacus_f64"] = {f"{n}_f64": 1 for n in sp64_kernels}
    # launches: the sum over the counted path runs (per path above, the
    # double forms' on the float64 path); no single PyTorch call computes
    # B1-B9's functions (library_ms null); B10's is embedding_bag
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src[n][0],
         "replaces": src[n][1],
         "launches": sum(p.get(n, 0) for p in launches.values()),
         "max_abs_err": errs[n], "ms": ms[n][0], "plain_ms": ms[n][1],
         "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
         "library_ms": library_ms.get(n)}
        for n in src]}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
