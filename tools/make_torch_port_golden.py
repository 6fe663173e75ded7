#!/usr/bin/env python
"""Golden fluxes for the PyTorch port, from the JAX package on the CPU.

Four goldens, each for the first 32 of the 2048 seed-0 columns of
ecrad_tpu_torch.inputs that chip_smoke.py runs (so the card's run and the
golden see identical columns):

- tests/goldens/torch_port_cloudless.npz: the Cloudless path
  (cloudless_slice_config) on make_columns(2048, 137, seed=0);
- tests/goldens/torch_port_mcica.npz: the McICA path (mcica_slice_config)
  on make_clouds(make_columns(2048, 137, 0), 0) with the SYNTHETIC LUTs of
  inputs.write_synthetic_luts(seed=0), written to a temporary directory.
  Besides the total- and clear-sky fluxes it holds both cloud covers and
  the cloudy-subcolumn masks of the SW and LW cloud generators
  (np.packbits of od_scaling > 0, (32, 137, ng) bits each);
- tests/goldens/torch_port_tripleclouds.npz: the Tripleclouds path
  (tripleclouds_slice_config: Exp-Ran, gamma PDF, 3 regions, Fu ice, 12
  aerosol types, LW derivatives) on make_aerosols(make_clouds(
  make_columns(2048, 137, 0), 0), 0) with the same synthetic LUTs (Fu
  ice) and synthetic aerosol table: total- and clear-sky fluxes, both
  cloud covers and the LW derivatives;
- tests/goldens/torch_port_spartacus.npz: the SPARTACUS path
  (spartacus_slice_config: 3D effects, Explicit entrapment, the
  Tripleclouds path's other settings) on the same columns with the
  effective sizes of inputs.add_effective_sizes (the CY47R1 namelist's
  cloud separation): the same fields as Tripleclouds.

Each flux field is stored twice: `<field>` from the JAX package at float32
and `<field>_f64` at float64 (each precision in its own process, because
jax_enable_x64 is process-global).

    python tools/make_torch_port_golden.py            # rewrite the stale
                                                      # or missing ones
    python tools/make_torch_port_golden.py --check    # compare, exit 1
                                                      # if one went stale
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = {name: os.path.join(REPO, "tests", "goldens",
                              f"torch_port_{name}.npz")
           for name in ("cloudless", "mcica", "tripleclouds", "spartacus")}
NCOL_BATCH, NCOL, NLEV, SEED = 2048, 32, 137, 0
FIELDS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct")
CLEAR_FIELDS = tuple(f + "_clear" for f in FIELDS)
MCICA_FIELDS = FIELDS + CLEAR_FIELDS + ("cloud_cover_sw", "cloud_cover_lw")
TRIPLECLOUDS_FIELDS = MCICA_FIELDS + ("lw_derivatives",)


def jax_config(config, dtype: str):
    """The JAX package's RadiationConfig with the fields of the port's
    `config` (enums matched by class and value) at `dtype`."""
    from ecrad_tpu import config as jconfig
    kw = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        if hasattr(jconfig, type(v).__name__) and type(v).__module__ \
                == type(config).__module__:
            v = getattr(jconfig, type(v).__name__)(int(v))
        kw[f.name] = v
    return jconfig.RadiationConfig(**{**kw, "dtype": dtype})


def jax_inputs(cols, dtype: str):
    """(SingleLevel, Thermodynamics, GasConcs, Cloud or None, Aerosol or
    None) of the JAX package from numpy columns (inputs.make_columns /
    make_clouds / make_aerosols; a spectral_solar_scaling where `cols`
    holds one)."""
    import jax.numpy as jnp
    from ecrad_tpu.types import (Aerosol, Cloud, GasConcs, SingleLevel,
                                 Thermodynamics)
    dt = jnp.float32 if dtype == "float32" else jnp.float64
    a = lambda k: jnp.asarray(cols[k], dt)
    cloudy = "fraction" in cols
    sl = SingleLevel(cos_sza=a("cos_sza"),
                     skin_temperature=a("skin_temperature"),
                     sw_albedo=a("sw_albedo"),
                     lw_emissivity=a("lw_emissivity"),
                     solar_irradiance=float(cols["solar_irradiance"]),
                     spectral_solar_scaling=(
                         a("spectral_solar_scaling")
                         if "spectral_solar_scaling" in cols else None),
                     iseed=(jnp.asarray(cols["iseed"], jnp.int32)
                            if cloudy else None))
    th = Thermodynamics(pressure_hl=a("pressure_hl"),
                        temperature_hl=a("temperature_hl"))
    cloud = None
    if cloudy:
        cloud = Cloud(**{k: a(k) for k in (
            "q_liq", "q_ice", "re_liq", "re_ice", "fraction",
            "fractional_std", "inv_cloud_effective_size",
            "inv_inhom_effective_size") if k in cols})
    aerosol = (Aerosol(mixing_ratio=a("aerosol_mmr"))
               if "aerosol_mmr" in cols else None)
    return sl, th, GasConcs(mixing_ratio=a("mixing_ratio")), cloud, aerosol


def jax_fluxes(dtype: str, *col_sets, fields=FIELDS, config=None,
               jit=True) -> list:
    """The JAX package's fluxes at `dtype`, one dict per set of numpy
    columns; one jitted function serves every set (with jit=False the
    operations run one by one, whose compiled forms one process shares
    between configurations). `config` is a port RadiationConfig (default:
    the Cloudless path); `fields=None` returns every flux field the run
    sets (entrapment_data stacked, (4, nlev, nreg, ncol))."""
    import jax
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu_torch.config import cloudless_slice_config

    setup = setup_radiation(jax_config(config or cloudless_slice_config(),
                                       dtype))
    fn = lambda *a: radiation(setup, *a)                # noqa: E731
    if jit:
        fn = jax.jit(fn)
    out = []
    for cols in col_sets:
        flux = fn(*jax_inputs(cols, dtype))
        names = fields or [k for k in flux.__dataclass_fields__
                           if getattr(flux, k) is not None]
        out.append({k: np.asarray(getattr(flux, k), np.float64)
                    for k in names})
    return out


def jax_subcolumn_masks(cols, config, dtype: str = "float32") -> dict:
    """od_scaling > 0 of the JAX package's SW and LW cloud generators on
    the cloud the McICA path makes of `cols` (fractional_std as given,
    overlap parameter from a 2 km decorrelation length, cropped), as
    {"mask_sw": (ncol, nlev, 112), "mask_lw": (ncol, nlev, 140)} bools."""
    import jax
    from ecrad_tpu.interface import setup_radiation
    from ecrad_tpu.solvers.cloud_generator import cloud_generator

    cfg = jax_config(config, dtype)
    setup = setup_radiation(cfg)
    _, th, _, cloud, _ = jax_inputs(cols, dtype)
    cloud = cloud.set_overlap_param(th, 2000.0).crop_cloud_fraction(
        cfg.cloud_fraction_threshold, cfg.cloud_mixing_ratio_threshold)
    iseed = np.asarray(cols["iseed"], np.int32)
    out = {}
    for name, ng, offset in (("mask_sw", 112, 0), ("mask_lw", 140, 997)):
        gen = jax.jit(lambda c, s, ng=ng: cloud_generator(
            ng, s, cfg.i_overlap_scheme, cfg.cloud_fraction_threshold,
            c.fraction, c.overlap_param, cfg.cloud_inhom_decorr_scaling,
            c.fractional_std, setup.pdf_sampler,
            is_beta_overlap=cfg.use_beta_overlap))
        od_scaling, _ = gen(cloud, iseed + offset)
        out[name] = np.asarray(od_scaling) > 0.0
    return out


def mcica_columns(aerosols=False, effective_sizes=False):
    """The golden's columns of the 2048: with clouds, with aerosols for
    Tripleclouds and SPARTACUS (drawn for all 2048 columns, as
    chip_smoke.py does), and with the effective sizes for SPARTACUS."""
    from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                        make_clouds, make_columns,
                                        slice_columns)
    cols = make_clouds(make_columns(NCOL_BATCH, NLEV, SEED), SEED)
    if aerosols:
        cols = make_aerosols(cols, SEED)
    if effective_sizes:
        cols = add_effective_sizes(cols)
    return slice_columns(cols, slice(0, NCOL))


def _child(name: str, dtype: str, out: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    from ecrad_tpu_torch.config import (mcica_slice_config,
                                        spartacus_slice_config,
                                        tripleclouds_slice_config)
    from ecrad_tpu_torch.inputs import (make_columns, slice_columns,
                                        write_synthetic_luts)
    if name == "cloudless":
        cols = slice_columns(make_columns(NCOL_BATCH, NLEV, SEED),
                             slice(0, NCOL))
        np.savez(out, **jax_fluxes(dtype, cols)[0])
        return
    if name in ("tripleclouds", "spartacus"):
        make = {"tripleclouds": tripleclouds_slice_config,
                "spartacus": spartacus_slice_config}[name]
        with tempfile.TemporaryDirectory() as luts:
            config = make(**write_synthetic_luts(luts, SEED, ice="fu"))
            cols = mcica_columns(aerosols=True,
                                 effective_sizes=name == "spartacus")
            np.savez(out, **jax_fluxes(dtype, cols,
                                       fields=TRIPLECLOUDS_FIELDS,
                                       config=config)[0])
        return
    with tempfile.TemporaryDirectory() as luts:
        config = mcica_slice_config(**write_synthetic_luts(luts, SEED))
        cols = mcica_columns()
        res = jax_fluxes(dtype, cols, fields=MCICA_FIELDS, config=config)[0]
        if dtype == "float32":
            masks = jax_subcolumn_masks(cols, config)
            res.update({k: np.packbits(v) for k, v in masks.items()})
    np.savez(out, **res)


def generate() -> dict:
    """Every golden at both precisions, each (golden, precision) in its
    own process, all run side by side. Returns {golden: {key: array}}."""
    golden = {name: {} for name in GOLDENS}
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for name in GOLDENS:
            for dtype, suffix in (("float32", ""), ("float64", "_f64")):
                out = os.path.join(tmp, f"{name}_{dtype}.npz")
                runs.append((subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--child",
                     name, dtype, out], env=env), name, out, suffix))
        for proc, name, out, suffix in runs:
            if proc.wait(timeout=900) != 0:
                raise RuntimeError(f"golden child failed: {proc.args}")
            with np.load(out) as z:
                golden[name].update({
                    k + ("" if k.startswith("mask") else suffix): z[k]
                    for k in z.files})
    return golden


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="regenerate and compare with the stored goldens")
    ap.add_argument("--child", nargs=3, metavar=("NAME", "DTYPE", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(*args.child)
        return 0
    goldens = generate()
    stale = {}
    for name, golden in goldens.items():
        stored = {}
        if os.path.exists(GOLDENS[name]):
            with np.load(GOLDENS[name]) as z:
                stored = {k: z[k] for k in z.files}
        # float32 results may move by XLA codegen (CPU vector width) at
        # the 1e-4 W/m2 level; float64 ones only by roundoff; the
        # subcolumn masks not at all
        atol = lambda k: (0 if k.startswith("mask")
                          else 1e-8 if k.endswith("_f64") else 1e-3)
        bad = [k for k in golden
               if k not in stored
               or not np.allclose(stored[k], golden[k], rtol=0,
                                  atol=atol(k))]
        if bad or set(stored) != set(golden):
            stale[name] = bad or sorted(set(stored) ^ set(golden))
    if args.check:
        if stale:
            print(f"golden is stale: {stale}")
            return 1
        print("golden matches")
        return 0
    # a golden that still matches is left as it is, byte for byte
    for name in stale:
        golden = goldens[name]
        np.savez_compressed(GOLDENS[name], **golden)
        for k in {"cloudless": FIELDS, "mcica": MCICA_FIELDS,
                  "tripleclouds": TRIPLECLOUDS_FIELDS,
                  "spartacus": TRIPLECLOUDS_FIELDS}[name]:
            err = np.abs(golden[k] - golden[k + "_f64"]).max()
            print(f"{name} {k}: JAX float32 vs float64 max abs {err:.3e}")
        print(f"wrote {GOLDENS[name]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
