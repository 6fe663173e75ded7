"""Offline driver of the PyTorch port:

    python -m ecrad_tpu_torch.driver config.nam input.nc output.nc [--device cpu]

Port of ecrad_tpu/driver.py:28-239 (driver/ecrad_driver.F90): reads the
&radiation and &radiation_driver namelists and the NetCDF columns, crops
them to istartcol..iendcol, applies the effective-size overrides, checks
the inputs (and clamps them with do_correct_unphysical_inputs), writes
inputs.nc and radiative_properties.nc when asked, runs the scheme nrepeat
times (in column blocks of column_block_size when that is set), checks
the fluxes, flips them back for height-increasing input and writes them
(HDF5 with do_write_hdf5, float64 with do_write_double_precision), with
do_print_entrapment_data also the SPARTACUS entrapment internals as the
text files <output>.fort.101 and <output>.fort.102.

It runs on the GPU unless --device says otherwise (the CPU runs the
kernels' plain versions). The environment variable ECRAD_FUSED_TAUMOL=0
selects the per-band gas optics (kernel B10), as in the JAX package.
`--no-jit` is accepted for the JAX driver's command line and ignored
(PyTorch runs eagerly). Not ported: a tiled-surface input (refused with
NotImplementedError until the surface slice, ROADMAP.md Queue A);
do_parallel (the port runs on one GPU, where the JAX driver's sharding
does nothing either).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .config import (describe_config, load_config_from_namelist,
                     load_driver_config_from_namelist)
from .interface import DTYPES, radiation, resolve_device, setup_radiation
from .io.input_reader import read_input
from .io.output import save_fluxes
from .utils.checks import clamp_inputs, validate_fluxes, validate_inputs


def _crop(obj, sl):
    """A dataclass with every tensor's leading (column) axis cut to sl."""
    return obj.replace(**{k: v[sl] for k, v in vars(obj).items()
                          if isinstance(v, torch.Tensor) and v.ndim > 0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ecrad_tpu_torch",
        description="ecRad-TPU's PyTorch port: offline radiation driver")
    ap.add_argument("namelist")
    ap.add_argument("input_nc")
    ap.add_argument("output_nc")
    ap.add_argument("surface_output_nc", nargs="?", default=None,
                    help="surface-flux output for tiled surfaces "
                         "(not ported yet)")
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
    from .surface.properties import input_has_tiled_surface
    if input_has_tiled_surface(args.input_nc):
        raise NotImplementedError(
            "tiled-surface input is not ported yet (ROADMAP.md Queue A, "
            "slice 8: surface)")

    if dc.iverbose >= 2:
        print(f"Reading {args.input_nc}")
    sl, thermo, gas, cloud, aerosol, is_reversed = read_input(
        args.input_nc, dc, return_orientation=True, device=device,
        dtype=DTYPES[config.dtype])
    if is_reversed and dc.iverbose >= 2:
        print("Input arrays ordered by increasing height: flipping "
              "(radiation_interface.F90:283-290)")
    ncol = sl.ncol
    istart = max(dc.istartcol - 1, 0)
    iend = dc.iendcol if dc.iendcol > 0 else ncol
    if istart > 0 or iend < ncol:
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

    run = lambda *a: radiation(setup, *a)            # noqa: E731
    if dc.column_block_size > 0:
        from .parallel.scaling import chunk_columns
        run = chunk_columns(run, dc.column_block_size)
    flux = None
    for _ in range(max(dc.nrepeat, 1)):
        t0 = time.perf_counter()
        flux = run(sl, thermo, gas, cloud, aerosol)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if dc.iverbose >= 1:
            print(f"Time elapsed in radiative transfer: "
                  f"{time.perf_counter() - t0:.6f} seconds")

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
