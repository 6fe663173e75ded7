"""Input and output containers: dataclasses of torch tensors, copied
from ecrad_tpu_torch/types.py (the fields the McICA and Tripleclouds
paths read and write; columns first, levels next, spectral innermost).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .constants import ACCEL_DUE_TO_GRAVITY, GAS_INDEX

class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass
class SingleLevel(_Replace):
    """Surface / single-level quantities (radiation_single_level.F90)."""
    cos_sza: torch.Tensor                     # (ncol,)
    skin_temperature: torch.Tensor            # (ncol,)
    sw_albedo: torch.Tensor                   # (ncol, n_albedo_intervals)
    lw_emissivity: torch.Tensor               # (ncol, n_emiss_intervals)
    sw_albedo_direct: Optional[torch.Tensor] = None
    solar_irradiance: float = 1366.0
    iseed: Optional[torch.Tensor] = None

    @property
    def ncol(self) -> int:
        return self.cos_sza.shape[0]


@dataclass
class Thermodynamics(_Replace):
    """Pressure (Pa) and temperature (K) on half levels, (ncol, nlev+1)."""
    pressure_hl: torch.Tensor
    temperature_hl: torch.Tensor
    h2o_sat_liq: Optional[torch.Tensor] = None

    @property
    def nlev(self) -> int:
        return self.pressure_hl.shape[1] - 1

    def pressure_fl(self) -> torch.Tensor:
        """Full-level pressure, the mean of the adjacent half levels."""
        return 0.5 * (self.pressure_hl[:, :-1] + self.pressure_hl[:, 1:])

    def temperature_fl(self) -> torch.Tensor:
        return 0.5 * (self.temperature_hl[:, :-1]
                      + self.temperature_hl[:, 1:])

    def calc_saturation_wrt_liquid(self) -> "Thermodynamics":
        """Clausius-Clapeyron saturation mass mixing ratio over liquid
        water (radiation_thermodynamics.F90:118-161)."""
        t = self.temperature_fl()
        e_sat = 6.11e2 * torch.exp(17.269 * (t - 273.16) / (t - 35.86))
        mmr = torch.clamp(0.622 * e_sat / torch.clamp(self.pressure_fl(),
                                                      min=1.0), max=1.0)
        return self.replace(h2o_sat_liq=mmr)


@dataclass
class GasConcs(_Replace):
    """Mass mixing ratios, (ncol, nlev, NUM_GASES), gas order GAS_NAMES.
    The setters return a new GasConcs (ecrad_tpu/types.py:113-153); a
    volume mixing ratio is converted with the gas's molar mass."""
    mixing_ratio: torch.Tensor

    def get(self, gas: str) -> torch.Tensor:
        return self.mixing_ratio[:, :, GAS_INDEX[gas]]


@dataclass
class Cloud(_Replace):
    """Cloud fields (radiation_cloud.F90), (ncol, nlev) unless noted."""
    q_liq: torch.Tensor                 # liquid mass mixing ratio
    q_ice: torch.Tensor                 # ice mass mixing ratio
    re_liq: torch.Tensor                # effective radii (m)
    re_ice: torch.Tensor
    fraction: torch.Tensor
    fractional_std: Optional[torch.Tensor] = None
    overlap_param: Optional[torch.Tensor] = None        # (ncol, nlev-1)
    inv_cloud_effective_size: Optional[torch.Tensor] = None
    inv_inhom_effective_size: Optional[torch.Tensor] = None

    def set_overlap_param(self, thermodynamics: "Thermodynamics",
                          decorrelation_length: float) -> "Cloud":
        """alpha = exp(-dz / L), dz the hydrostatic separation of adjacent
        layer midpoints (radiation_cloud.F90:166-252;
        ecrad_tpu/types.py:176-195)."""
        p = torch.clamp(thermodynamics.pressure_hl, min=1.0)
        t = thermodynamics.temperature_hl
        r_over_g = 287.0 / ACCEL_DUE_TO_GRAVITY
        dz = r_over_g * 0.5 * (t[:, :-1] + t[:, 1:]) * torch.log(
            p[:, 1:] / p[:, :-1])
        sep = 0.5 * (dz[:, :-1] + dz[:, 1:])
        return self.replace(overlap_param=torch.exp(
            -torch.abs(sep) / decorrelation_length))

    def crop_cloud_fraction(self, cloud_fraction_threshold: float = 1.0e-6,
                            cloud_mixing_ratio_threshold: float = 1.0e-9
                            ) -> "Cloud":
        """Zero negligible clouds (radiation_cloud.F90:560+;
        ecrad_tpu/types.py:232-243)."""
        keep = ((self.fraction > cloud_fraction_threshold)
                & (self.q_liq + self.q_ice > cloud_mixing_ratio_threshold))
        zero = torch.zeros((), dtype=self.fraction.dtype,
                           device=self.fraction.device)
        return self.replace(fraction=torch.where(keep, self.fraction, zero),
                            q_liq=torch.where(keep, self.q_liq, zero),
                            q_ice=torch.where(keep, self.q_ice, zero))


@dataclass
class Aerosol(_Replace):
    """Aerosol mass mixing ratios, (ncol, nlev, ntype)
    (radiation_aerosol.F90:28-56), or per-band optical properties for the
    direct-input bypass: od/ssa/g_sw (ncol, nlev, 14), od/ssa_lw (ncol,
    nlev, 16). Unused while use_aerosols is off."""
    mixing_ratio: Optional[torch.Tensor] = None
    od_sw: Optional[torch.Tensor] = None
    ssa_sw: Optional[torch.Tensor] = None
    g_sw: Optional[torch.Tensor] = None
    od_lw: Optional[torch.Tensor] = None
    ssa_lw: Optional[torch.Tensor] = None


#: Aerosol fields with a level axis (axis 1)
AEROSOL_FIELDS = ("mixing_ratio", "od_sw", "ssa_sw", "g_sw", "od_lw",
                  "ssa_lw")


@dataclass
class Flux(_Replace):
    """Output fluxes on half levels (W m-2), (ncol, nlev+1) unless noted
    (radiation_flux.F90:34-98)."""
    lw_up: Optional[torch.Tensor] = None
    lw_dn: Optional[torch.Tensor] = None
    sw_up: Optional[torch.Tensor] = None
    sw_dn: Optional[torch.Tensor] = None
    sw_dn_direct: Optional[torch.Tensor] = None
    lw_up_clear: Optional[torch.Tensor] = None
    lw_dn_clear: Optional[torch.Tensor] = None
    sw_up_clear: Optional[torch.Tensor] = None
    sw_dn_clear: Optional[torch.Tensor] = None
    sw_dn_direct_clear: Optional[torch.Tensor] = None
    # surface band fluxes, (ncol, nbands)
    lw_dn_surf_band: Optional[torch.Tensor] = None
    lw_dn_surf_clear_band: Optional[torch.Tensor] = None
    sw_dn_surf_band: Optional[torch.Tensor] = None
    sw_dn_direct_surf_band: Optional[torch.Tensor] = None
    sw_dn_surf_clear_band: Optional[torch.Tensor] = None
    sw_dn_direct_surf_clear_band: Optional[torch.Tensor] = None
    # surface per-g fluxes, (ncol, ng)
    lw_dn_surf_g: Optional[torch.Tensor] = None
    sw_dn_diffuse_surf_g: Optional[torch.Tensor] = None
    sw_dn_direct_surf_g: Optional[torch.Tensor] = None
    # diagnostics
    cloud_cover_lw: Optional[torch.Tensor] = None    # (ncol,)
    cloud_cover_sw: Optional[torch.Tensor] = None    # (ncol,)
    lw_derivatives: Optional[torch.Tensor] = None    # (ncol, nlev+1)

    def fields(self):
        """(name, tensor) for every tensor field that is set."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]


#: Flux fields with a level axis (axis 1), flipped back for
#: reversed-orientation inputs (ecrad_tpu/interface.py _LEVEL_FLUX_FIELDS)
LEVEL_FLUX_FIELDS = (
    "lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct",
    "lw_up_clear", "lw_dn_clear", "sw_up_clear", "sw_dn_clear",
    "sw_dn_direct_clear",
    "lw_derivatives",
)
