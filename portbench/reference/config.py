"""The reference's configuration: the RadiationConfig fields and enums of
ecrad_tpu_torch/config.py that the McICA, Tripleclouds and SPARTACUS
paths read, with ecRad's defaults (radiation_config.F90:147-543).

`from_fields` builds one from a benchmark configuration file's `fields`
(enums by their ecRad names), and refuses a field it does not know, so a
setting the reference cannot follow is never dropped in silence.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields
from enum import IntEnum
from typing import Tuple


class Solver(IntEnum):
    CLOUDLESS = 0
    HOMOGENEOUS = 1
    MCICA = 2
    SPARTACUS = 3
    TRIPLECLOUDS = 4


class GasModel(IntEnum):
    MONOCHROMATIC = 0
    RRTMG_IFS = 1


class LiquidModel(IntEnum):
    MONOCHROMATIC = 0
    SOCRATES = 1
    SLINGO = 2


class IceModel(IntEnum):
    MONOCHROMATIC = 0
    FU = 1
    BARAN = 2
    BARAN2016 = 3
    BARAN2017 = 4
    YI = 5


class Overlap(IntEnum):
    MAXIMUM_RANDOM = 0
    EXPONENTIAL_RANDOM = 1
    EXPONENTIAL_EXPONENTIAL = 2


class PdfShape(IntEnum):
    LOGNORMAL = 0
    GAMMA = 1


class Entrapment(IntEnum):
    ZERO = 0
    EDGE_ONLY = 1
    EXPLICIT = 2
    EXPLICIT_NON_FRACTAL = 3
    MAXIMUM = 4


#: the enum of each enum-valued field, named as in ecRad's namelists
ENUM_NAMES = {
    "i_gas_model": (GasModel, {"Monochromatic": 0, "RRTMG-IFS": 1}),
    "i_liq_model": (LiquidModel, {"Monochromatic": 0, "SOCRATES": 1,
                                  "Slingo": 2}),
    "i_ice_model": (IceModel, {"Monochromatic": 0, "Fu-IFS": 1, "Baran": 2,
                               "Baran2016": 3, "Baran2017": 4, "Yi": 5}),
    "i_solver_sw": (Solver, {"Cloudless": 0, "Homogeneous": 1, "McICA": 2,
                             "SPARTACUS": 3, "Tripleclouds": 4}),
    "i_overlap_scheme": (Overlap, {"Max-Ran": 0, "Exp-Ran": 1,
                                   "Exp-Exp": 2}),
    "i_cloud_pdf_shape": (PdfShape, {"Lognormal": 0, "Gamma": 1}),
    "i_3d_sw_entrapment": (Entrapment, {"Zero": 0, "Edge-only": 1,
                                        "Explicit": 2, "Non-fractal": 3,
                                        "Maximum": 4}),
}
ENUM_NAMES["i_solver_lw"] = ENUM_NAMES["i_solver_sw"]


@dataclass(frozen=True)
class RadiationConfig:
    do_sw: bool = True
    do_lw: bool = True
    do_clear: bool = True
    do_sw_direct: bool = True
    i_gas_model: GasModel = GasModel.RRTMG_IFS
    i_liq_model: LiquidModel = LiquidModel.SOCRATES
    i_ice_model: IceModel = IceModel.BARAN
    i_solver_sw: Solver = Solver.MCICA
    i_solver_lw: Solver = Solver.MCICA
    i_overlap_scheme: Overlap = Overlap.EXPONENTIAL_RANDOM
    i_cloud_pdf_shape: PdfShape = PdfShape.GAMMA
    cloud_fraction_threshold: float = 1.0e-6
    cloud_mixing_ratio_threshold: float = 1.0e-9
    use_beta_overlap: bool = False
    cloud_inhom_decorr_scaling: float = 0.5
    nregions: int = 3
    do_lw_cloud_scattering: bool = True
    do_lw_aerosol_scattering: bool = True
    do_sw_delta_scaling_with_gases: bool = False
    # SPARTACUS's 3D settings
    do_3d_effects: bool = True
    i_3d_sw_entrapment: Entrapment = Entrapment.EXPLICIT
    do_3d_lw_multilayer_effects: bool = False
    do_lw_side_emissivity: bool = True
    clear_to_thick_fraction: float = 0.0
    overhead_sun_factor: float = 0.0
    max_gas_od_3d: float = 8.0
    max_cloud_od: float = 16.0
    max_3d_transfer_rate: float = 10.0
    min_cloud_effective_size: float = 100.0
    overhang_factor: float = 0.0
    use_expm_everywhere: bool = False
    min_gas_od_lw: float = 1.0e-15
    min_gas_od_sw: float = 0.0
    use_aerosols: bool = False
    n_aerosol_types: int = 0
    i_aerosol_type_map: Tuple[int, ...] = ()
    do_nearest_spectral_sw_albedo: bool = True
    do_nearest_spectral_lw_emiss: bool = True
    sw_albedo_wavelength_bound: Tuple[float, ...] = ()
    lw_emiss_wavelength_bound: Tuple[float, ...] = ()
    i_sw_albedo_index: Tuple[int, ...] = ()
    i_lw_emiss_index: Tuple[int, ...] = ()
    do_surface_sw_spectral_flux: bool = True
    do_lw_derivatives: bool = False
    do_fu_lw_ice_optics_bug: bool = False
    directory_name: str = "."
    ice_optics_override_file_name: str = ""
    liq_optics_override_file_name: str = ""
    aerosol_optics_override_file_name: str = ""
    cloud_pdf_override_file_name: str = ""
    dtype: str = "float32"

    def _file(self, override: str) -> str:
        return (override if override.startswith("/")
                else os.path.join(self.directory_name, override))

    @property
    def liq_optics_file(self) -> str:
        return self._file(self.liq_optics_override_file_name)

    @property
    def ice_optics_file(self) -> str:
        return self._file(self.ice_optics_override_file_name)

    @property
    def aerosol_optics_file(self) -> str:
        return self._file(self.aerosol_optics_override_file_name)

    @property
    def cloud_pdf_file(self) -> str:
        return self._file(self.cloud_pdf_override_file_name)

    @property
    def do_clouds(self) -> bool:
        return ((self.do_sw and self.i_solver_sw != Solver.CLOUDLESS)
                or (self.do_lw and self.i_solver_lw != Solver.CLOUDLESS))


def from_fields(values: dict, **overrides) -> RadiationConfig:
    """A RadiationConfig from a configuration file's `fields` (enums by
    name, lists for tuples) and `overrides` (the lookup-table files)."""
    known = {f.name for f in fields(RadiationConfig)}
    kwargs = {}
    for key, value in {**values, **overrides}.items():
        if key not in known:
            raise ValueError(f"the reference does not follow the setting "
                             f"{key!r}")
        if key in ENUM_NAMES:
            enum, names = ENUM_NAMES[key]
            value = enum(names[value])
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[key] = value
    cfg = RadiationConfig(**kwargs)
    for solver in (cfg.i_solver_sw, cfg.i_solver_lw):
        if solver not in (Solver.MCICA, Solver.TRIPLECLOUDS,
                          Solver.SPARTACUS):
            raise ValueError(f"the reference follows McICA, Tripleclouds and "
                             f"SPARTACUS only, not {solver.name}")
    if cfg.i_gas_model != GasModel.RRTMG_IFS:
        raise ValueError("the reference follows RRTMG-IFS gas optics only")
    return cfg
