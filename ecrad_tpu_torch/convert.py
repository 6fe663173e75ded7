"""Carry state across from numpy: a JAX RadiationSetup's content, the
input dataclasses, the columns of inputs.make_columns and the tiled
surface of inputs.make_surface.

Everything here takes numpy arrays (or anything np.asarray accepts), so
the JAX package's objects cross over without this package importing it.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from .config import RadiationConfig, check_supported
from .inputs import CLOUD_KEYS, EFFECTIVE_SIZE_KEYS
from .interface import RadiationSetup, make_setup, resolve_device
from .optics.aerosol import AerosolOpticsTables
from .optics.cloud import CloudOpticsTables
from .optics.rrtmg.gas_optics import spec_from_arrays
from .solvers.pdf_sampler import PdfSampler
from .surface.properties import SurfaceDescription
from .types import Aerosol, Cloud, GasConcs, SingleLevel, Thermodynamics


def _copy(cls, obj):
    """An instance of dataclass `cls` from any object with its fields
    (numpy arrays copied, scalars as they are), or None."""
    if obj is None:
        return None
    return cls(**{f.name: (np.array(v) if isinstance(v, np.ndarray) else v)
                  for f in dataclasses.fields(cls)
                  for v in [getattr(obj, f.name)]})


def setup_from_numpy(config: RadiationConfig, tables: Mapping,
                     spec_arrays, sw_albedo_map, sw_albedo_weights,
                     lw_emiss_map, lw_emiss_weights, device="cuda",
                     cloud_optics=None, pdf_sampler=None,
                     aerosol_optics=None) -> RadiationSetup:
    """The port's setup, on `device` (the GPU unless the caller asks for
    another), from a JAX RadiationSetup's numpy content: `tables` its
    `setup.tables` (empty for the monochromatic model, whose one-g spec
    and maps carry over as they are), `spec_arrays` its `setup.spec` (any
    object with the GasOpticsSpec fields; without g_from_reordered_g_* the
    g order is the identity, with them the SPARTACUS order carries over),
    the four interval maps, its `cloud_optics` (the five coefficient arrays) for a
    cloudy setup, its `pdf_sampler` (val, fsd1, inv_fsd_interval, cheb,
    z0, z1) for McICA, and its `aerosol_optics` (the AerosolOpticsTables
    fields) with use_aerosols."""
    config = config.consolidated()
    check_supported(config)
    opt = lambda x: None if x is None else np.asarray(x)
    spec = spec_from_arrays(
        spec_arrays.band_from_g_lw, spec_arrays.band_from_g_sw,
        opt(getattr(spec_arrays, "g_from_reordered_g_lw", None)),
        opt(getattr(spec_arrays, "g_from_reordered_g_sw", None)))
    return make_setup(
        config, {k: np.asarray(v) for k, v in tables.items()}, spec,
        opt(sw_albedo_map), opt(sw_albedo_weights), opt(lw_emiss_map),
        opt(lw_emiss_weights), device,
        _copy(CloudOpticsTables, cloud_optics),
        _copy(PdfSampler, pdf_sampler),
        _copy(AerosolOpticsTables, aerosol_optics))


def _build(cls, values: Optional[Mapping], device, dtype):
    if values is None:
        return None
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = values.get(f.name)
        if v is None:
            continue
        if isinstance(v, float):
            kwargs[f.name] = v
        else:
            arr = np.asarray(v)
            kwargs[f.name] = torch.as_tensor(
                arr, dtype=dtype if arr.dtype.kind == "f" else None,
                device=device)
    return cls(**kwargs)


def inputs_from_numpy(single_level: Mapping, thermodynamics: Mapping,
                      gas: Mapping, cloud: Optional[Mapping] = None,
                      aerosol: Optional[Mapping] = None, device="cuda",
                      dtype=torch.float32):
    """(SingleLevel, Thermodynamics, GasConcs, Cloud, Aerosol) from dicts
    of numpy arrays keyed by field name (unknown keys are ignored, float
    arrays take `dtype`), on `device` (the GPU unless the caller asks for
    another)."""
    device = resolve_device(device)
    return tuple(_build(cls, v, device, dtype) for cls, v in (
        (SingleLevel, single_level), (Thermodynamics, thermodynamics),
        (GasConcs, gas), (Cloud, cloud), (Aerosol, aerosol)))


def columns_to_inputs(cols: Mapping, device="cuda", dtype=torch.float32):
    """(SingleLevel, Thermodynamics, GasConcs) from inputs.make_columns,
    the Cloud as a fourth item when `cols` holds cloud fields
    (inputs.make_clouds; with the effective sizes of
    inputs.add_effective_sizes where `cols` holds them), and the Aerosol
    as a fifth when it holds aerosol_mmr (inputs.make_aerosols; the Cloud
    is then None without cloud fields); the SingleLevel takes `cols`'
    spectral_solar_scaling (14,) where it holds one. On `device`, the GPU
    unless the caller asks for another."""
    cloudy = "fraction" in cols
    aerosols = "aerosol_mmr" in cols
    sl, th, gas, cloud, aer = inputs_from_numpy(
        {k: cols[k] for k in ("cos_sza", "skin_temperature", "sw_albedo",
                              "lw_emissivity", "spectral_solar_scaling")
         + (("iseed",) * cloudy) if k in cols}
        | {"solar_irradiance": float(cols["solar_irradiance"])},
        {k: cols[k] for k in ("pressure_hl", "temperature_hl")},
        {"mixing_ratio": cols["mixing_ratio"]},
        {k: cols[k] for k in CLOUD_KEYS + EFFECTIVE_SIZE_KEYS if k in cols}
        if cloudy else None,
        {"mixing_ratio": cols["aerosol_mmr"]} if aerosols else None,
        device=device, dtype=dtype)
    if aerosols:
        return sl, th, gas, cloud, aer
    return (sl, th, gas, cloud) if cloudy else (sl, th, gas)


def surface_from_numpy(surface: Mapping, device="cuda",
                       dtype=torch.float32) -> SurfaceDescription:
    """The port's SurfaceDescription from a dict of numpy arrays keyed by
    field name and its "representation" (inputs.make_surface), float
    arrays in `dtype`, on `device` (the GPU unless the caller asks for
    another)."""
    fields = {k: v for k, v in surface.items() if k != "representation"}
    return _build(SurfaceDescription, fields, resolve_device(device),
                  dtype).replace(representation=tuple(
                      int(r) for r in surface["representation"]))
