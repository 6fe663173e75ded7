"""Input and output containers: dataclasses of torch tensors.

Field names and shapes follow ecrad_tpu/types.py (columns first, levels
next, spectral innermost), so inputs convert one-to-one
(convert.inputs_from_numpy) and tests compare like with like. `Cloud`
feeds the cloudy solvers (SPARTACUS also reads its inverse effective
sizes); `Aerosol` (mixing ratios, or per-band optical
properties for the direct-input bypass) feeds the aerosol stage when
`use_aerosols` is on.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from .constants import (ACCEL_DUE_TO_GRAVITY, GAS_INDEX, GAS_MOLAR_MASS,
                        MOLAR_MASS_DRY_AIR, NUM_GASES, SPECIFIC_HEAT_DRY_AIR)

# Gas concentration units (reference: radiation/radiation_gas.F90:60-66)
IMassMixingRatio = 0
IVolumeMixingRatio = 1


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
    # surface LW emission supplied by a tiled surface; overrides
    # Planck(Tskin) x (1 - albedo) (radiation_ifs_rrtm.F90:436-443)
    lw_emission: Optional[torch.Tensor] = None
    solar_irradiance: float = 1366.0
    spectral_solar_scaling: Optional[torch.Tensor] = None
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

    def layer_mass(self) -> torch.Tensor:
        """Mass of each layer (kg m-2), |dp| / g
        (radiation_thermodynamics.F90:164; ecrad_tpu/types.py:79-86)."""
        dp = self.pressure_hl[:, 1:] - self.pressure_hl[:, :-1]
        return torch.abs(dp) * (1.0 / ACCEL_DUE_TO_GRAVITY)

    def calc_saturation_wrt_liquid(self) -> "Thermodynamics":
        """Clausius-Clapeyron saturation mass mixing ratio over liquid
        water (radiation_thermodynamics.F90:118-161;
        ecrad_tpu/types.py:87-96)."""
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

    @classmethod
    def create(cls, ncol: int, nlev: int, dtype=torch.float32,
               device=None) -> "GasConcs":
        """No gas. float32 by default, as in the JAX package: radiation()
        casts to the configuration's dtype."""
        return cls(mixing_ratio=torch.zeros((ncol, nlev, NUM_GASES),
                                            dtype=dtype, device=device))

    def put(self, gas: str, mmr) -> "GasConcs":
        """Set one gas from a (ncol, nlev) mass mixing ratio."""
        mr = self.mixing_ratio.clone()
        mr[:, :, GAS_INDEX[gas]] = torch.as_tensor(mmr, device=mr.device)
        return self.replace(mixing_ratio=mr)

    def put_vmr(self, gas: str, vmr) -> "GasConcs":
        return self.put(gas, vmr * (GAS_MOLAR_MASS[gas]
                                    / MOLAR_MASS_DRY_AIR))

    def put_well_mixed(self, gas: str, mmr: float, ncol: int,
                       nlev: int) -> "GasConcs":
        return self.put(gas, torch.full(
            (ncol, nlev), mmr, dtype=self.mixing_ratio.dtype,
            device=self.mixing_ratio.device))

    def put_well_mixed_vmr(self, gas: str, vmr: float, ncol: int,
                           nlev: int) -> "GasConcs":
        return self.put_well_mixed(
            gas, vmr * (GAS_MOLAR_MASS[gas] / MOLAR_MASS_DRY_AIR), ncol,
            nlev)

    def scale(self, gas: str, factor: float) -> "GasConcs":
        mr = self.mixing_ratio.clone()
        mr[:, :, GAS_INDEX[gas]] *= factor
        return self.replace(mixing_ratio=mr)

    def get(self, gas: str) -> torch.Tensor:
        return self.mixing_ratio[:, :, GAS_INDEX[gas]]

    def get_vmr(self, gas: str) -> torch.Tensor:
        return self.get(gas) * (MOLAR_MASS_DRY_AIR / GAS_MOLAR_MASS[gas])


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

    @classmethod
    def create_zero(cls, ncol: int, nlev: int, dtype=torch.float32,
                    device=None) -> "Cloud":
        """No cloud, with the JAX package's placeholder radii of 10 and 50
        um (ecrad_tpu/types.py:171-175)."""
        z = torch.zeros((ncol, nlev), dtype=dtype, device=device)
        return cls(q_liq=z, q_ice=z, re_liq=z + 1.0e-5, re_ice=z + 5.0e-5,
                   fraction=z)

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

    def create_inv_cloud_effective_size_eta(
            self, thermodynamics: "Thermodynamics", inv_eff_size_low: float,
            inv_eff_size_mid: float, inv_eff_size_high: float,
            eta_low_mid: float, eta_mid_high: float) -> "Cloud":
        """Inverse effective cloud size by eta band, eta the full-level
        pressure over the surface pressure (radiation_cloud.F90:398-460;
        ecrad_tpu/types.py:197-209)."""
        p_hl = thermodynamics.pressure_hl
        eta = (p_hl[:, :-1] + p_hl[:, 1:]) * (0.5 / p_hl[:, -1:])
        full = lambda v: torch.full_like(eta, v)
        inv = torch.where(eta > eta_low_mid, full(inv_eff_size_low),
                          torch.where(eta > eta_mid_high,
                                      full(inv_eff_size_mid),
                                      full(inv_eff_size_high)))
        return self.replace(inv_cloud_effective_size=inv)

    def param_cloud_effective_separation_eta(
            self, thermodynamics: "Thermodynamics", separation_surf: float,
            separation_toa: float, power: float = 1.0,
            inhom_separation_factor: float = 1.0) -> "Cloud":
        """Inverse effective sizes of the cloud and of its inhomogeneities
        from an effective cloud separation that rises from
        `separation_surf` at the surface to `separation_toa` (m) with eta
        to the `power` (radiation_cloud.F90:476+, the namelist's
        cloud_separation_scale_* options; ecrad_tpu/types.py:211-230)."""
        p_hl = thermodynamics.pressure_hl
        eta = (p_hl[:, :-1] + p_hl[:, 1:]) * (0.5 / p_hl[:, -1:])
        coeff_e = 1.0 - math.exp(-1.0)
        coeff_b = (separation_toa - separation_surf) / coeff_e
        coeff_a = separation_toa - coeff_b
        eff_sep = coeff_a + coeff_b * torch.exp(-eta ** power)
        f = self.fraction
        inv_cloud = 1.0 / (eff_sep * torch.sqrt(torch.clamp(
            f * (1.0 - f), min=1.0e-5)))
        inv_inhom = 1.0 / (eff_sep * inhom_separation_factor * torch.sqrt(
            torch.clamp(0.5 * f * (1.0 - 0.5 * f), min=1.0e-5)))
        return self.replace(inv_cloud_effective_size=inv_cloud,
                            inv_inhom_effective_size=inv_inhom)

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
    # downwelling at canopy top (do_canopy_fluxes_*), per g with
    # use_canopy_full_spectrum_*, else per albedo / emissivity interval
    # (radiation_flux.F90:377-450), (ncol, n_canopy_bands)
    lw_dn_surf_canopy: Optional[torch.Tensor] = None
    sw_dn_diffuse_surf_canopy: Optional[torch.Tensor] = None
    sw_dn_direct_surf_canopy: Optional[torch.Tensor] = None
    # diagnostics
    cloud_cover_lw: Optional[torch.Tensor] = None    # (ncol,)
    cloud_cover_sw: Optional[torch.Tensor] = None    # (ncol,)
    lw_derivatives: Optional[torch.Tensor] = None    # (ncol, nlev+1)
    # profiles per band, or per g in the original g order with
    # do_save_gpoint_flux (do_save_spectral_flux), (ncol, nlev+1, nspec)
    lw_up_band: Optional[torch.Tensor] = None
    lw_dn_band: Optional[torch.Tensor] = None
    sw_up_band: Optional[torch.Tensor] = None
    sw_dn_band: Optional[torch.Tensor] = None
    sw_dn_direct_band: Optional[torch.Tensor] = None
    lw_up_band_clear: Optional[torch.Tensor] = None
    lw_dn_band_clear: Optional[torch.Tensor] = None
    sw_up_band_clear: Optional[torch.Tensor] = None
    sw_dn_band_clear: Optional[torch.Tensor] = None
    sw_dn_direct_band_clear: Optional[torch.Tensor] = None
    # SPARTACUS SW entrapment internals (do_print_entrapment_data):
    # (x_direct, x_diffuse, direct_dn, flux_dn), each (nlev, nreg, ncol)
    # at the solver's first g-point, TOA first
    # (radiation_spartacus_sw.F90:1007-1020, :1486-1497)
    entrapment_data: Optional[tuple] = None

    def fields(self):
        """(name, tensor) for every tensor field that is set (not
        entrapment_data, a tuple)."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def net_lw(self) -> torch.Tensor:
        return self.lw_dn - self.lw_up

    def net_sw(self) -> torch.Tensor:
        return self.sw_dn - self.sw_up

    def heating_rate_lw(self, thermodynamics: Thermodynamics
                        ) -> torch.Tensor:
        return _heating_rate(self.net_lw(), thermodynamics)

    def heating_rate_sw(self, thermodynamics: Thermodynamics
                        ) -> torch.Tensor:
        return _heating_rate(self.net_sw(), thermodynamics)


def _heating_rate(net_flux, thermo: Thermodynamics) -> torch.Tensor:
    """Heating rate in K/day, -(g / cp) dFnet / dp
    (practical/ecradplot/io.py:73-78; ecrad_tpu/types.py:338-349)."""
    dfnet = net_flux[:, 1:] - net_flux[:, :-1]
    dp = thermo.pressure_hl[:, 1:] - thermo.pressure_hl[:, :-1]
    return -(ACCEL_DUE_TO_GRAVITY / SPECIFIC_HEAT_DRY_AIR) * dfnet / dp \
        * 86400.0


#: Flux fields with a level axis (axis 1), flipped back for
#: reversed-orientation inputs (ecrad_tpu/interface.py _LEVEL_FLUX_FIELDS)
LEVEL_FLUX_FIELDS = (
    "lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct",
    "lw_up_clear", "lw_dn_clear", "sw_up_clear", "sw_dn_clear",
    "sw_dn_direct_clear",
    "lw_up_band", "lw_dn_band", "sw_up_band", "sw_dn_band",
    "sw_dn_direct_band",
    "lw_up_band_clear", "lw_dn_band_clear", "sw_up_band_clear",
    "sw_dn_band_clear", "sw_dn_direct_band_clear",
    "lw_derivatives",
)
