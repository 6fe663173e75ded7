"""The aerosol stage's test cases, shared by tests/test_torch_aerosol.py
(the plain version against the JAX package on the CPU) and
tests/test_torch_kernels_gpu.py (kernel B12 against the plain version on
the card), so this module imports no jax.

Each case is a configuration override and a variant of the inputs: both
LW branches (scattering, and the absorption-only co-albedo form), SW with
and without delta scaling of the aerosol alone, fewer and more types
supplied than configured, rows without aerosol, the saturation given
rather than computed, humidities on the bins' lower edges, one level, and
the direct per-band bypass. The configured type map
(config.TRIPLECLOUDS_AEROSOL_MAP) holds hydrophilic, hydrophobic and
inactive types.
"""
import dataclasses

import numpy as np
import torch

from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.constants import GAS_INDEX
from ecrad_tpu_torch.inputs import make_aerosols, make_columns
from ecrad_tpu_torch.interface import setup_radiation
from ecrad_tpu_torch.types import Aerosol, GasConcs, Thermodynamics

NCOL, NLEV = 5, 16
#: case: configuration overrides and _inputs' keywords
CASES = {
    "lw_scattering": {},
    "lw_absorption": dict(do_lw_aerosol_scattering=False),
    "sw_delta_with_gases": dict(do_sw_delta_scaling_with_gases=True),
    "lw_absorption_sw_delta_with_gases": dict(
        do_lw_aerosol_scattering=False, do_sw_delta_scaling_with_gases=True),
    "ten_types_supplied": dict(ntypes=10),
    "fourteen_types_supplied": dict(ntypes=14),
    "rows_without_aerosol": dict(clean_rows=True),
    "saturation_given": dict(saturation="given"),
    "humidity_bin_edges": dict(saturation="edges"),
    "one_level": dict(nlev=1),
    "direct": dict(direct=True),
}
#: the keywords of CASES that are _inputs' rather than the configuration's
INPUT_KEYS = ("ntypes", "clean_rows", "saturation", "nlev", "direct")
FIELDS = ("od_lw", "ssa_lw", "g_lw", "od_sw", "ssa_sw", "g_sw")


def split(case):
    """(configuration overrides, _inputs keywords) of a case."""
    kw = dict(CASES[case])
    return ({k: v for k, v in kw.items() if k not in INPUT_KEYS},
            {k: v for k, v in kw.items() if k in INPUT_KEYS})


def config(luts, **kw):
    return pconfig.cloudless_slice_config(
        **luts, use_aerosols=True,
        n_aerosol_types=len(pconfig.TRIPLECLOUDS_AEROSOL_MAP),
        i_aerosol_type_map=pconfig.TRIPLECLOUDS_AEROSOL_MAP, **kw)


def inputs(ntypes=12, direct=False, clean_rows=False, saturation=None,
           nlev=NLEV, ncol=NCOL, ng_sw=112, ng_lw=140, seed=3,
           rh_lower=None):
    """numpy inputs of the aerosol stage: the columns' thermodynamics, gas
    and aerosol mixing ratios, and per-g gas optics (ncol, nlev, ng).
    clean_rows: the first column's top three layers (or its only one) and
    the last column's bottom one hold no aerosol. saturation "given": a
    computed-looking h2o_sat_liq handed in; "edges": h2o_sat_liq 1 and the
    water vapour on the lower edges of the humidity bins (rh_lower, the
    table's) and one float32 step above those but the first (0)."""
    rng = np.random.RandomState(seed)
    cols = make_aerosols(make_columns(ncol, nlev, 2), 2)
    mmr = cols["aerosol_mmr"]
    if ntypes > mmr.shape[-1]:
        mmr = np.concatenate([mmr, mmr[..., :ntypes - mmr.shape[-1]]], -1)
    mmr = mmr[..., :ntypes].copy()
    if clean_rows:
        mmr[0, :3] = 0.0
        mmr[-1, -1] = 0.0
    x = dict(pressure_hl=cols["pressure_hl"],
             temperature_hl=cols["temperature_hl"],
             mixing_ratio=cols["mixing_ratio"].copy(), aerosol_mmr=mmr,
             od_lw=rng.uniform(0, 3, (ncol, nlev, ng_lw)),
             ssa_lw=rng.uniform(0, 0.3, (ncol, nlev, ng_lw)),
             g_lw=rng.uniform(0, 0.5, (ncol, nlev, ng_lw)),
             od_sw=rng.uniform(0, 3, (ncol, nlev, ng_sw)),
             ssa_sw=rng.uniform(0.2, 1, (ncol, nlev, ng_sw)),
             g_sw=rng.uniform(0, 0.5, (ncol, nlev, ng_sw)))
    x["od_sw"][0, :4] = 0.0               # layers without gas extinction
    if saturation == "given":
        x["h2o_sat_liq"] = rng.uniform(2e-3, 2e-2, (ncol, nlev))
    elif saturation == "edges":
        edges = np.asarray(rh_lower, np.float64)
        above = np.nextafter(edges[1:].astype(np.float32), np.float32(1))
        q = np.resize(np.concatenate([edges, above.astype(np.float64)]),
                      ncol * nlev).reshape(ncol, nlev)
        x["h2o_sat_liq"] = np.ones((ncol, nlev))
        x["mixing_ratio"][:, :, GAS_INDEX["h2o"]] = q
    if direct:
        x["direct"] = dict(od_sw=rng.uniform(0, 0.2, (ncol, nlev, 14)),
                           ssa_sw=rng.uniform(0.8, 1, (ncol, nlev, 14)),
                           g_sw=rng.uniform(0.5, 0.8, (ncol, nlev, 14)),
                           od_lw=rng.uniform(0, 0.05, (ncol, nlev, 16)),
                           ssa_lw=rng.uniform(0.1, 0.6, (ncol, nlev, 16)))
    return x


def rh_edges(luts):
    """The lower edges of the humidity bins of the aerosol table of luts."""
    return setup_radiation(config(luts), device="cpu").aerosol_optics.rh_lower


def port_args(cfg, x, dtype, device, int32=False):
    """add_aerosol_optics' arguments on x: (setup, argument tuple), at
    dtype ("float32" or "float64") on device; the band maps int32 (the
    card's) or int64."""
    setup = setup_radiation(dataclasses.replace(cfg, dtype=dtype),
                            device=device)
    t = lambda v: torch.as_tensor(v, dtype=getattr(torch, dtype),  # noqa
                                  device=device)
    aer = Aerosol(mixing_ratio=t(x["aerosol_mmr"]),
                  **{k: t(v) for k, v in x.get("direct", {}).items()})
    sat = x.get("h2o_sat_liq")
    maps = setup.maps
    bands = ((maps.band_sw32, maps.band_lw32) if int32
             else (maps.band_sw, maps.band_lw))
    return setup, (
        setup.config, setup.aerosol_coeffs, *bands,
        Thermodynamics(pressure_hl=t(x["pressure_hl"]),
                       temperature_hl=t(x["temperature_hl"]),
                       h2o_sat_liq=None if sat is None else t(sat)),
        GasConcs(mixing_ratio=t(x["mixing_ratio"])), aer,
        *(t(x[k]) for k in FIELDS))
