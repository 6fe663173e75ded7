"""Offline driver of the PyTorch port:

    python -m ecrad_tpu_torch.driver config.nam input.nc output.nc \
        [surface_output.nc] [--device cpu]

Port of ecrad_tpu/driver.py (driver/ecrad_driver.F90): reads the
&radiation and &radiation_driver namelists and the NetCDF columns, crops
them to istartcol..iendcol, applies the effective-size overrides, checks
the inputs (and clamps them with do_correct_unphysical_inputs), writes
inputs.nc and radiative_properties.nc when asked, runs the scheme nrepeat
times (in column blocks of column_block_size when that is set; with
do_parallel split over the visible GPUs when there are more than one),
checks the fluxes, flips them back for height-increasing input and writes
them (HDF5 with do_write_hdf5, float64 with do_write_double_precision),
with do_print_entrapment_data also the SPARTACUS entrapment internals as
the text files <output>.fort.101 and <output>.fort.102.

An input with a tiled surface (tile_representation and tile_fraction)
turns the canopy fluxes on, folds the tiles into the effective albedo,
emissivity and emission the atmosphere sees (with do_canopy_gases_lw and
use_canopy_full_spectrum_lw, gas absorption of the lowest model level
inside the canopies), and after the atmosphere partitions the surface
fluxes onto the facets, written to surface_output.nc. As in the JAX
package, the surface is not cropped with the columns: istartcol/iendcol
with a tiled surface is refused (ROADMAP.md Queue C).

It runs on the GPU unless --device says otherwise (the CPU runs the
kernels' plain versions). The environment variable ECRAD_FUSED_TAUMOL=0
selects the per-band gas optics (kernel B10), as in the JAX package.
`--no-jit` is accepted for the JAX driver's command line and ignored
(PyTorch runs eagerly).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time

import numpy as np
import torch

from .config import (describe_config, load_config_from_namelist,
                     load_driver_config_from_namelist)
from .interface import DTYPES, radiation, resolve_device, setup_radiation
from .io.input_reader import read_input
from .io.output import save_fluxes, save_surface_fluxes
from .surface import (calc_boundary_conditions, partition_fluxes,
                      print_surface_representation, read_surface)
from .surface.properties import input_has_tiled_surface
from .utils.checks import clamp_inputs, validate_fluxes, validate_inputs


def _crop(obj, sl):
    """A dataclass with every tensor's leading (column) axis cut to sl."""
    return obj.replace(**{k: v[sl] for k, v in vars(obj).items()
                          if isinstance(v, torch.Tensor) and v.ndim > 0})


def _lowest_level_extinction(setup, single_level, thermo, gas):
    """The LW extinction (m-1) of the lowest model level per g, for gas
    absorption inside the canopies: its gas optical depth over its
    hydrostatic depth (ecrad_tpu/driver.py:28-58; the reference takes
    its first, TOA, level and passes only the LW on,
    radsurf_intermediate.F90:1027-1036; the JAX package takes the bottom
    layer). A second gas-optics call (kernels B1 and B2, or B10 with
    ECRAD_FUSED_TAUMOL=0)."""
    from .constants import ACCEL_DUE_TO_GRAVITY
    from .interface import get_albedos
    from .optics.rrtmg.gas_optics import gas_optics
    cfg = setup.config
    go = gas_optics(
        thermo.pressure_hl, thermo.temperature_hl, gas.mixing_ratio,
        single_level.skin_temperature, single_level.cos_sza,
        single_level.solar_irradiance, setup.maps, setup.gas,
        lw_albedo=get_albedos(setup, single_level)[2],
        min_gas_od_lw=cfg.min_gas_od_lw, min_gas_od_sw=cfg.min_gas_od_sw)
    r_over_g = 287.058 / ACCEL_DUE_TO_GRAVITY
    p, t = thermo.pressure_hl, thermo.temperature_hl
    layer_depth = (r_over_g * (p[:, -1] - p[:, -2])
                   * (t[:, -1] + t[:, -2]) / (p[:, -1] + p[:, -2]))
    return go.od_lw[:, -1, :] / torch.clamp(layer_depth,
                                            min=1.0e-3)[:, None]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ecrad_tpu_torch",
        description="ecRad-TPU's PyTorch port: offline radiation driver")
    ap.add_argument("namelist")
    ap.add_argument("input_nc")
    ap.add_argument("output_nc")
    ap.add_argument("surface_output_nc", nargs="?", default=None,
                    help="surface-flux output for tiled surfaces "
                         "(driver/ecrad_driver.F90:116-117, 4th arg)")
    ap.add_argument("--no-jit", action="store_true",
                    help="accepted for the JAX driver's command line; "
                         "ignored")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # no TF32 wherever a matmul could touch the fluxes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    config = load_config_from_namelist(args.namelist)
    dc = load_driver_config_from_namelist(args.namelist)
    if dc.iverbose >= 2:
        print(f"Reading {args.input_nc}")
    sl, thermo, gas, cloud, aerosol, is_reversed = read_input(
        args.input_nc, dc, return_orientation=True, device=device,
        dtype=DTYPES[config.dtype])
    if is_reversed and dc.iverbose >= 2:
        print("Input arrays ordered by increasing height: flipping "
              "(radiation_interface.F90:283-290)")
    ncol = sl.ncol
    # a complex (tiled) surface (driver/ecrad_driver.F90:184-196)
    surface = None
    if input_has_tiled_surface(args.input_nc):
        surface = read_surface(args.input_nc, device=device,
                               dtype=DTYPES[config.dtype])
        config = dataclasses.replace(config, do_canopy_fluxes_sw=True,
                                     do_canopy_fluxes_lw=True)
        if dc.iverbose >= 2:
            print(print_surface_representation(surface.representation))
    istart = max(dc.istartcol - 1, 0)
    iend = dc.iendcol if dc.iendcol > 0 else ncol
    if istart > 0 or iend < ncol:
        if surface is not None:
            # the JAX driver crops the atmosphere and not the surface
            # (ecrad_tpu/driver.py:98-109), and then fails
            raise ValueError(
                f"istartcol = {dc.istartcol} / iendcol = {dc.iendcol} with "
                f"a tiled-surface input: the surface is not cropped with "
                f"the columns (ROADMAP.md Queue C)")
        sl, thermo, gas, cloud, aerosol = (
            _crop(x, slice(istart, iend))
            for x in (sl, thermo, gas, cloud, aerosol))

    # cloud effective-size overrides (driver/ecrad_driver.F90:190-215)
    if dc.cloud_separation_scale_toa > 0.0 and \
            dc.cloud_separation_scale_surface > 0.0:
        cloud = cloud.param_cloud_effective_separation_eta(
            thermo, dc.cloud_separation_scale_surface,
            dc.cloud_separation_scale_toa, dc.cloud_separation_scale_power,
            dc.cloud_inhom_separation_factor)
    elif dc.low_inv_effective_size > 0.0 or \
            dc.middle_inv_effective_size > 0.0 or \
            dc.high_inv_effective_size > 0.0:
        cloud = cloud.create_inv_cloud_effective_size_eta(
            thermo, dc.low_inv_effective_size, dc.middle_inv_effective_size,
            dc.high_inv_effective_size, 0.8, 0.45)
    if dc.effective_size_scaling > 0.0 and \
            cloud.inv_cloud_effective_size is not None:
        cloud = cloud.replace(
            inv_cloud_effective_size=cloud.inv_cloud_effective_size
            / dc.effective_size_scaling)

    # input bounds (driver/ecrad_driver.F90:245-254)
    findings = validate_inputs(sl, thermo, gas, cloud, aerosol)
    for msg in findings:
        print(f"Warning: input {msg}")
    if findings and dc.do_correct_unphysical_inputs:
        sl, thermo, gas, cloud, aerosol = clamp_inputs(sl, thermo, gas,
                                                       cloud, aerosol)

    if dc.iverbose >= 2:
        print("Setting up radiation scheme")
    setup = setup_radiation(config, device=device)
    if config.iverbosesetup >= 3:
        print(describe_config(setup.config))
    if dc.do_save_inputs:
        from .io.output import save_inputs
        save_inputs("inputs.nc", sl, thermo, gas, cloud, aerosol)
        if dc.iverbose >= 2:
            print("Wrote inputs.nc")
    if config.do_save_radiative_properties:
        from .io.output import save_radiative_properties
        save_radiative_properties("radiative_properties.nc", setup, sl,
                                  thermo, gas)
        if dc.iverbose >= 2:
            print("Wrote radiative_properties.nc")

    if surface is not None:
        # the tiles folded into effective boundary conditions
        # (ecrad_driver.F90:290-292 -> radsurf_intermediate.F90:955-1038);
        # gas absorption in canopies needs the full-spectrum LW, and the
        # reference only uses the LW (:1027-1036)
        ext_lw = None
        if config.do_canopy_gases_lw and config.use_canopy_full_spectrum_lw:
            ext_lw = _lowest_level_extinction(setup, sl, thermo, gas)
        bc = calc_boundary_conditions(setup, surface, sl.cos_sza,
                                      ext_lw_air=ext_lw)
        sl = sl.replace(sw_albedo=bc.sw_albedo_diffuse,
                        sw_albedo_direct=bc.sw_albedo_direct,
                        lw_emissivity=bc.lw_emissivity,
                        lw_emission=bc.lw_emission)

    run = _runner(setup, config, dc, device)
    flux = None
    for _ in range(max(dc.nrepeat, 1)):
        t0 = time.perf_counter()
        flux = run(sl, thermo, gas, cloud, aerosol)
        if device.type == "cuda":
            # (a split run's blocks are copied to this device first)
            torch.cuda.synchronize(device)
        if dc.iverbose >= 1:
            print(f"Time elapsed in radiative transfer: "
                  f"{time.perf_counter() - t0:.6f} seconds")

    if surface is not None:
        # the facets' fluxes, from the TOA-first fluxes (before the flip)
        surface_flux = partition_fluxes(surface, bc.intermediate, flux)
        if args.surface_output_nc:
            save_surface_fluxes(args.surface_output_nc, surface_flux)
        elif dc.iverbose >= 1:
            print("Warning: file name for surface-flux outputs "
                  "not provided")

    for msg in validate_fluxes(flux):
        print(f"Warning: output {msg}")
    if is_reversed:
        # the fluxes back in the caller's (height-increasing) order
        # (radiation_reverse, radiation_interface.F90:475-617)
        nlev = thermo.nlev
        flux = flux.replace(**{
            k: v.flip(1) for k, v in flux.fields()
            if v.ndim >= 2 and v.shape[1] in (nlev, nlev + 1)})
        thermo = thermo.replace(pressure_hl=thermo.pressure_hl.flip(1),
                                temperature_hl=thermo.temperature_hl.flip(1))
    if dc.iverbose >= 2:
        print(f"Writing {args.output_nc}")
    save_fluxes(args.output_nc, flux, thermo, hdf5=dc.do_write_hdf5,
                double_precision=dc.do_write_double_precision)
    if flux.entrapment_data is not None:
        _dump_entrapment_data(args.output_nc, flux.entrapment_data)
    return 0


def _runner(setup, config, dc, device):
    """run(*inputs) -> Flux: radiation() on `setup`, in column blocks of
    column_block_size when that is set, and with do_parallel split over
    the visible GPUs when there are more than one (each with its own
    setup); on one GPU or the CPU do_parallel does nothing, as in the
    JAX driver on one device."""
    def block(run):
        if dc.column_block_size > 0:
            from .parallel.scaling import chunk_columns
            return chunk_columns(run, dc.column_block_size)
        return run

    if not (dc.do_parallel and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        return block(lambda *a: radiation(setup, *a))
    from .parallel.sharding import column_mesh, run_sharded, shard_columns
    mesh = column_mesh()
    runs = {d: block(functools.partial(radiation,
                                       setup_radiation(config, device=d)))
            for d in mesh}
    return lambda *a: run_sharded(lambda d, *p: runs[d](*p),
                                  shard_columns(a, mesh))


def _dump_entrapment_data(output_nc, data):
    """The reference's PRINT_ENTRAPMENT_DATA text dumps
    (radiation_spartacus_sw.F90:1007-1020, :1486-1497), byte for byte as
    ecrad_tpu/driver.py:242-264 writes them: <output_nc>.fort.101 holds
    per column and level the direct and diffuse migration distances of
    each region and a 1.0 per region, .fort.102 the direct and total
    downward fluxes of each region."""
    x_dir, x_diff, direct_dn, flux_dn = [
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in data]
    nlev, nreg, ncol = x_dir.shape

    def write(path, columns):
        with open(path, "w") as f:
            for jcol in range(ncol):
                for jlev in range(nlev):
                    f.write(f"{jcol + 1:4d}{jlev + 1:4d}" + "".join(
                        f"{v:14.6e}" for x in columns
                        for v in x[jlev, :, jcol]) + "\n")
    write(output_nc + ".fort.101", (x_dir, x_diff, np.ones_like(x_dir)))
    write(output_nc + ".fort.102", (direct_dn, flux_dn))


if __name__ == "__main__":
    sys.exit(main())
