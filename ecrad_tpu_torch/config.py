"""Configuration for the PyTorch port of ecRad-TPU.

A copy of ecrad_tpu/config.py (that module cannot be imported without
jax): the same RadiationConfig fields, enums and namelist reader
(radiation/radiation_config.F90:147-543, :558-912), so the port reads the
same namelists, and the offline driver's DriverConfig
(driver/ecrad_driver_config.F90; ecrad_tpu/config.py:311-362, :538+).
`check_supported` rejects a region count or dtype that no solver takes;
every setting the JAX package accepts is ported.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from enum import IntEnum
from typing import Tuple


class Solver(IntEnum):
    CLOUDLESS = 0
    HOMOGENEOUS = 1
    MCICA = 2
    SPARTACUS = 3
    TRIPLECLOUDS = 4


SOLVER_NAMES = {
    "Cloudless": Solver.CLOUDLESS,
    "Homogeneous": Solver.HOMOGENEOUS,
    "McICA": Solver.MCICA,
    "SPARTACUS": Solver.SPARTACUS,
    "Tripleclouds": Solver.TRIPLECLOUDS,
}


class Entrapment(IntEnum):
    ZERO = 0
    EDGE_ONLY = 1
    EXPLICIT = 2
    EXPLICIT_NON_FRACTAL = 3
    MAXIMUM = 4


ENTRAPMENT_NAMES = {
    "Zero": Entrapment.ZERO,
    "Edge-only": Entrapment.EDGE_ONLY,
    "Explicit": Entrapment.EXPLICIT,
    "Non-fractal": Entrapment.EXPLICIT_NON_FRACTAL,
    "Maximum": Entrapment.MAXIMUM,
}

# Backwards-compatible "encroachment" names (radiation_config.F90:84-90)
ENCROACHMENT_NAMES = {
    "Zero": Entrapment.ZERO,
    "Minimum": Entrapment.EDGE_ONLY,
    "Fractal": Entrapment.EXPLICIT,
    "Computed": Entrapment.EXPLICIT_NON_FRACTAL,
    "Maximum": Entrapment.MAXIMUM,
}


class GasModel(IntEnum):
    MONOCHROMATIC = 0
    RRTMG_IFS = 1


GAS_MODEL_NAMES = {
    "Monochromatic": GasModel.MONOCHROMATIC,
    "RRTMG-IFS": GasModel.RRTMG_IFS,
}


class LiquidModel(IntEnum):
    MONOCHROMATIC = 0
    SOCRATES = 1
    SLINGO = 2


LIQUID_MODEL_NAMES = {
    "Monochromatic": LiquidModel.MONOCHROMATIC,
    "SOCRATES": LiquidModel.SOCRATES,
    "Slingo": LiquidModel.SLINGO,
}


class IceModel(IntEnum):
    MONOCHROMATIC = 0
    FU = 1
    BARAN = 2
    BARAN2016 = 3
    BARAN2017 = 4
    YI = 5


ICE_MODEL_NAMES = {
    "Monochromatic": IceModel.MONOCHROMATIC,
    "Fu-IFS": IceModel.FU,
    "Baran": IceModel.BARAN,
    "Baran2016": IceModel.BARAN2016,
    "Baran2017": IceModel.BARAN2017,
    "Yi": IceModel.YI,
}


class Overlap(IntEnum):
    MAXIMUM_RANDOM = 0
    EXPONENTIAL_RANDOM = 1
    EXPONENTIAL_EXPONENTIAL = 2


OVERLAP_NAMES = {
    "Max-Ran": Overlap.MAXIMUM_RANDOM,
    "Exp-Ran": Overlap.EXPONENTIAL_RANDOM,
    "Exp-Exp": Overlap.EXPONENTIAL_EXPONENTIAL,
}


class PdfShape(IntEnum):
    LOGNORMAL = 0
    GAMMA = 1


PDF_SHAPE_NAMES = {
    "Lognormal": PdfShape.LOGNORMAL,
    "Gamma": PdfShape.GAMMA,
}


def _lookup_enum(table: dict, name: str, what: str):
    for key, val in table.items():
        if key.lower() == name.strip().lower():
            return val
    raise ValueError(
        f"Unknown {what} '{name}'; valid values: {sorted(table)}")


@dataclass(frozen=True)
class RadiationConfig:
    """User configuration. Defaults match radiation_config.F90:147-543."""
    # What to compute
    do_sw: bool = True
    do_lw: bool = True
    do_clear: bool = True
    do_sw_direct: bool = True

    # Models & solvers
    i_gas_model: GasModel = GasModel.RRTMG_IFS
    i_liq_model: LiquidModel = LiquidModel.SOCRATES
    i_ice_model: IceModel = IceModel.BARAN
    i_solver_sw: Solver = Solver.MCICA
    i_solver_lw: Solver = Solver.MCICA
    i_overlap_scheme: Overlap = Overlap.EXPONENTIAL_RANDOM
    i_cloud_pdf_shape: PdfShape = PdfShape.GAMMA

    # Cloud / overlap parameters
    cloud_fraction_threshold: float = 1.0e-6
    cloud_mixing_ratio_threshold: float = 1.0e-9
    use_beta_overlap: bool = False
    cloud_inhom_decorr_scaling: float = 0.5
    nregions: int = 3

    # LW scattering switches
    do_lw_cloud_scattering: bool = True
    do_lw_aerosol_scattering: bool = True

    # SW delta scaling applied to the gas-cloud mix (legacy IFS behaviour)
    do_sw_delta_scaling_with_gases: bool = False

    # 3D / SPARTACUS parameters
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

    # Gas optics stability bounds
    min_gas_od_lw: float = 1.0e-15
    min_gas_od_sw: float = 0.0

    # Monochromatic model parameters
    mono_lw_wavelength: float = -1.0
    mono_lw_total_od: float = 0.0
    mono_sw_total_od: float = 0.0
    mono_sw_single_scattering_albedo: float = 0.999999
    mono_sw_asymmetry_factor: float = 0.86
    mono_lw_single_scattering_albedo: float = 0.538
    mono_lw_asymmetry_factor: float = 0.925

    # Aerosols
    use_aerosols: bool = False
    n_aerosol_types: int = 0
    i_aerosol_type_map: Tuple[int, ...] = ()

    # Surface spectral mapping
    do_nearest_spectral_sw_albedo: bool = True
    do_nearest_spectral_lw_emiss: bool = True
    sw_albedo_wavelength_bound: Tuple[float, ...] = ()
    lw_emiss_wavelength_bound: Tuple[float, ...] = ()
    i_sw_albedo_index: Tuple[int, ...] = ()
    i_lw_emiss_index: Tuple[int, ...] = ()

    # Diagnostics
    do_save_radiative_properties: bool = False
    do_save_spectral_flux: bool = False
    do_save_gpoint_flux: bool = False
    do_surface_sw_spectral_flux: bool = True
    do_lw_derivatives: bool = False
    do_canopy_fluxes_sw: bool = False
    do_canopy_fluxes_lw: bool = False
    use_canopy_full_spectrum_sw: bool = False
    use_canopy_full_spectrum_lw: bool = False
    do_canopy_gases_sw: bool = False
    do_canopy_gases_lw: bool = False
    do_fu_lw_ice_optics_bug: bool = False
    # Analogue of the reference's PRINT_ENTRAPMENT_DATA compile flag
    # (Makefile:54-60): capture SPARTACUS SW entrapment internals in
    # Flux.entrapment_data; the command-line program dumps them
    # fort.101/102-style.
    do_print_entrapment_data: bool = False
    iverbose: int = 1
    iverbosesetup: int = 2

    # Data files
    directory_name: str = "."
    ice_optics_override_file_name: str = ""
    liq_optics_override_file_name: str = ""
    aerosol_optics_override_file_name: str = ""
    cloud_pdf_override_file_name: str = ""

    use_spectral_solar_scaling: bool = False

    # Compute dtype for the RT solve ("float32" or "float64").
    dtype: str = "float32"

    # ----- consolidated (derived) paths -----
    def consolidated(self) -> "RadiationConfig":
        """Resolve data file names (reference: consolidate_config :917).

        Override names starting with '/' are absolute; otherwise they are
        relative to directory_name. Empty overrides get generated names.
        """
        def resolve(override: str, generated: str) -> str:
            name = override if override else generated
            if name.startswith("/"):
                return name
            return os.path.join(self.directory_name, name)

        liq_names = {
            LiquidModel.SOCRATES: "socrates_droplet_scattering_rrtm.nc",
            LiquidModel.SLINGO: "slingo_droplet_scattering_rrtm.nc",
            LiquidModel.MONOCHROMATIC: "",
        }
        ice_names = {
            IceModel.FU: "fu_ice_scattering_rrtm.nc",
            IceModel.BARAN: "baran_ice_scattering_rrtm.nc",
            IceModel.BARAN2016: "baran2016_ice_scattering_rrtm.nc",
            IceModel.BARAN2017: "baran2017_ice_scattering_rrtm.nc",
            IceModel.YI: "yi_ice_scattering_rrtm.nc",
            IceModel.MONOCHROMATIC: "",
        }
        pdf_names = {
            PdfShape.GAMMA: "mcica_gamma.nc",
            PdfShape.LOGNORMAL: "mcica_lognormal.nc",
        }
        object.__setattr__(self, "_liq_optics_file",
                           resolve(self.liq_optics_override_file_name,
                                   liq_names[self.i_liq_model]))
        object.__setattr__(self, "_ice_optics_file",
                           resolve(self.ice_optics_override_file_name,
                                   ice_names[self.i_ice_model]))
        object.__setattr__(self, "_aerosol_optics_file",
                           resolve(self.aerosol_optics_override_file_name,
                                   "aerosol_ifs_rrtm_45R2.nc"))
        object.__setattr__(self, "_cloud_pdf_file",
                           resolve(self.cloud_pdf_override_file_name,
                                   pdf_names[self.i_cloud_pdf_shape]))
        return self

    @property
    def liq_optics_file(self) -> str:
        return getattr(self, "_liq_optics_file", "")

    @property
    def ice_optics_file(self) -> str:
        return getattr(self, "_ice_optics_file", "")

    @property
    def aerosol_optics_file(self) -> str:
        return getattr(self, "_aerosol_optics_file", "")

    @property
    def cloud_pdf_file(self) -> str:
        return getattr(self, "_cloud_pdf_file", "")

    @property
    def do_clouds(self) -> bool:
        """Will clouds be used at all? Derived exactly as the reference
        (radiation_config.F90:531,898-900,939-941): true iff an active
        spectral region runs a non-Cloudless solver. When false, cloud
        cropping and cloud optics are skipped entirely."""
        return ((self.do_sw and self.i_solver_sw != Solver.CLOUDLESS)
                or (self.do_lw and self.i_solver_lw != Solver.CLOUDLESS))


@dataclass(frozen=True)
class DriverConfig:
    """Offline-driver options (driver/ecrad_driver_config.F90;
    ecrad_tpu/config.py:311-362)."""
    do_parallel: bool = True
    nblocksize: int = 8
    # Process columns in blocks of this size (0 = the whole batch at
    # once): the memory-bounding analogue of the reference's nblocksize
    # column blocks
    column_block_size: int = 0
    istartcol: int = 0
    iendcol: int = 0
    nrepeat: int = 1
    iverbose: int = 2
    do_save_inputs: bool = False
    do_correct_unphysical_inputs: bool = False
    # Write outputs as NetCDF4/HDF5 with deflate compression
    # (ecrad_driver_config.F90:92, easy_netcdf.F90 NF90_HDF5 mode)
    do_write_hdf5: bool = False
    do_write_double_precision: bool = False
    # Scalings / overrides
    fractional_std: float = 0.0
    overlap_decorr_length: float = 0.0
    # Scale the overlap decorrelation length by raising the overlap
    # parameter to 1/scaling (ecrad_driver_read_input.F90:213-227)
    overlap_decorr_length_scaling: float = -1.0
    high_inv_effective_size: float = 0.0
    middle_inv_effective_size: float = 0.0
    low_inv_effective_size: float = 0.0
    effective_size_scaling: float = 0.0
    cloud_separation_scale_toa: float = 0.0
    cloud_separation_scale_surface: float = 0.0
    cloud_separation_scale_power: float = 1.0
    cloud_inhom_separation_factor: float = 1.0
    cloud_fraction_override: float = -1.0
    q_liquid_scaling: float = 1.0
    q_ice_scaling: float = 1.0
    co2_scaling: float = 1.0
    ch4_scaling: float = 1.0
    n2o_scaling: float = 1.0
    o3_scaling: float = 1.0
    co_scaling: float = 1.0
    nox_scaling: float = 1.0
    cfc11_scaling: float = 1.0
    cfc12_scaling: float = 1.0
    hcfc22_scaling: float = 1.0
    ccl4_scaling: float = 1.0
    h2o_scaling: float = 1.0
    solar_irradiance_override: float = 0.0
    cos_sza_override: float = -1.0
    skin_temperature_override: float = -1.0
    sw_albedo_override: float = -1.0
    lw_emissivity_override: float = -1.0


# ---------------------------------------------------------------------------
# Fortran namelist parsing
# ---------------------------------------------------------------------------

_NML_GROUP_RE = re.compile(r"&(\w+)(.*?)(?:^\s*/\s*$|/\s*(?=&|\Z))",
                           re.DOTALL | re.MULTILINE)


def _strip_comments(text: str) -> str:
    out_lines = []
    for line in text.splitlines():
        # Remove '!' comments but respect quoted strings
        res = []
        in_sq = in_dq = False
        for ch in line:
            if ch == "'" and not in_dq:
                in_sq = not in_sq
            elif ch == '"' and not in_sq:
                in_dq = not in_dq
            elif ch == "!" and not in_sq and not in_dq:
                break
            res.append(ch)
        out_lines.append("".join(res))
    return "\n".join(out_lines)


def _parse_value(tok: str):
    tok = tok.strip()
    if not tok:
        return None
    low = tok.lower().rstrip(".").lstrip(".")
    if low in ("true", "t"):
        return True
    if low in ("false", "f"):
        return False
    if tok[0] in "'\"":
        return tok.strip("'\"")
    try:
        if re.fullmatch(r"[+-]?\d+", tok):
            return int(tok)
        return float(tok.replace("d", "e").replace("D", "E"))
    except ValueError:
        return tok


def parse_namelist(path_or_text: str) -> dict:
    """Parse a Fortran namelist file into {group: {var: value}}.

    Handles scalars, comma-separated arrays, array sections like
    `name(1:5) = a, b, c, d, e`, and quoted strings. This covers the
    subset used by ecRad configuration files.
    """
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    text = _strip_comments(text)
    groups: dict = {}
    for m in _NML_GROUP_RE.finditer(text):
        gname = m.group(1).lower()
        body = m.group(2)
        gdict = groups.setdefault(gname, {})
        # Split into "name = values" assignments
        assigns = re.findall(
            r"([\w%]+(?:\([\d:,\s]+\))?)\s*=\s*((?:[^=]|=(?=\s*[,\s]))*?)"
            r"(?=(?:[\w%]+(?:\([\d:,\s]+\))?\s*=)|\Z)",
            body, re.DOTALL)
        for name, raw in assigns:
            base = re.sub(r"\(.*\)", "", name).strip().lower()
            idx_m = re.search(r"\((.*)\)", name)
            vals = [
                _parse_value(v) for v in
                re.split(r"[,\n]+", raw.strip().rstrip(","))
                if v.strip()
            ]
            value = vals[0] if len(vals) == 1 and idx_m is None else vals
            if idx_m is not None:
                # Array section assignment: merge into existing list
                sec = idx_m.group(1)
                start = int(sec.split(":")[0]) if ":" in sec else int(sec)
                existing = gdict.get(base)
                if not isinstance(existing, list):
                    existing = [] if existing is None else [existing]
                need = start - 1 + len(vals)
                existing = existing + [None] * (need - len(existing))
                for i, v in enumerate(vals):
                    existing[start - 1 + i] = v
                gdict[base] = existing
            else:
                gdict[base] = value
    return groups


_CONFIG_ENUM_FIELDS = {
    "gas_model_name": ("i_gas_model", GAS_MODEL_NAMES),
    "liquid_model_name": ("i_liq_model", LIQUID_MODEL_NAMES),
    "ice_model_name": ("i_ice_model", ICE_MODEL_NAMES),
    "sw_solver_name": ("i_solver_sw", SOLVER_NAMES),
    "lw_solver_name": ("i_solver_lw", SOLVER_NAMES),
    "overlap_scheme_name": ("i_overlap_scheme", OVERLAP_NAMES),
    "sw_entrapment_name": ("i_3d_sw_entrapment", ENTRAPMENT_NAMES),
    "sw_encroachment_name": ("i_3d_sw_entrapment", ENCROACHMENT_NAMES),
    "cloud_pdf_shape_name": ("i_cloud_pdf_shape", PDF_SHAPE_NAMES),
}

_CONFIG_RENAMES = {
    "n_regions": "nregions",
}

_TUPLE_FIELDS = (
    "i_aerosol_type_map", "sw_albedo_wavelength_bound",
    "lw_emiss_wavelength_bound", "i_sw_albedo_index", "i_lw_emiss_index",
)


def describe_config(cfg: RadiationConfig) -> str:
    """Human-readable configuration listing (print_config,
    radiation_config.F90:1127): every field with its value, enums by
    name."""
    from dataclasses import fields as dc_fields
    lines = ["Configuration:"]
    for f in dc_fields(cfg):
        if f.name.startswith("_"):
            continue
        val = getattr(cfg, f.name)
        if hasattr(val, "name"):
            val = val.name
        lines.append(f"  {f.name:42s} = {val}")
    # derived flags (radiation_config.F90:1155 "Clouds are...")
    lines.append(f"  {'do_clouds (derived)':42s} = {cfg.do_clouds}")
    return "\n".join(lines)


def load_config_from_namelist(path_or_text: str,
                              **overrides) -> RadiationConfig:
    """Build a RadiationConfig from a reference-format namelist file.

    Reference parity: read_config_from_namelist
    (radiation_config.F90:558-912).
    """
    groups = parse_namelist(path_or_text)
    nml = groups.get("radiation", {})
    kwargs = {}
    valid = set(RadiationConfig.__dataclass_fields__)
    for key, value in nml.items():
        if key in _CONFIG_ENUM_FIELDS:
            fieldname, table = _CONFIG_ENUM_FIELDS[key]
            if value:
                kwargs[fieldname] = _lookup_enum(table, str(value), key)
        else:
            key = _CONFIG_RENAMES.get(key, key)
            if key in valid:
                if key in _TUPLE_FIELDS:
                    if not isinstance(value, list):
                        value = [value]
                    value = tuple(0 if v is None else v for v in value)
                kwargs[key] = value
    kwargs.update(overrides)
    # A relative directory_name in a namelist is relative to the namelist
    # file's directory (the reference is run from the test directory, so
    # "../../data" resolves against it).
    if ("directory_name" in kwargs and os.path.isfile(path_or_text)
            and not os.path.isabs(kwargs["directory_name"])
            and not os.path.isdir(kwargs["directory_name"])):
        candidate = os.path.normpath(os.path.join(
            os.path.dirname(os.path.abspath(path_or_text)),
            kwargs["directory_name"]))
        if os.path.isdir(candidate):
            kwargs["directory_name"] = candidate
    return RadiationConfig(**kwargs).consolidated()


def load_driver_config_from_namelist(path_or_text: str) -> DriverConfig:
    """The &radiation_driver group of a namelist (unknown keys ignored)."""
    nml = parse_namelist(path_or_text).get("radiation_driver", {})
    valid = set(DriverConfig.__dataclass_fields__)
    return DriverConfig(**{k: v for k, v in nml.items() if k in valid})


#: Options of the port's paths besides the solvers (the configuration of
#: tests/test_e2e_cloudless.py and bench.py without directory_name); the
#: golden script, the tests and chip_smoke.py use it. Aerosols are off
#: except on the Tripleclouds path.
SLICE_OPTIONS = dict(
    use_aerosols=False,
    do_nearest_spectral_sw_albedo=False,
    sw_albedo_wavelength_bound=(0.25e-6, 0.44e-6, 0.69e-6, 1.19e-6,
                                2.38e-6),
    i_sw_albedo_index=(1, 2, 3, 4, 5, 6),
    do_nearest_spectral_lw_emiss=True,
    lw_emiss_wavelength_bound=(8.0e-6, 13.0e-6),
    i_lw_emiss_index=(1, 2, 1),
)


def cloudless_slice_config(**overrides) -> RadiationConfig:
    """The configuration of the port's Cloudless path."""
    return RadiationConfig(**{**SLICE_OPTIONS,
                              "i_solver_sw": Solver.CLOUDLESS,
                              "i_solver_lw": Solver.CLOUDLESS, **overrides})


def mcica_slice_config(**overrides) -> RadiationConfig:
    """The McICA path as bench.py:49-68 sets it: McICA in SW and LW,
    Exp-Exp overlap, LW cloud scattering on, SOCRATES liquid and Baran
    ice (the defaults), no aerosols. The LUT files come from `overrides`
    (directory_name and the *_override_file_name fields, for instance
    those of inputs.write_synthetic_luts)."""
    return RadiationConfig(**{**SLICE_OPTIONS,
                              "i_solver_sw": Solver.MCICA,
                              "i_solver_lw": Solver.MCICA,
                              "i_overlap_scheme":
                                  Overlap.EXPONENTIAL_EXPONENTIAL,
                              **overrides})


def tripleclouds_slice_config(**overrides) -> RadiationConfig:
    """The Tripleclouds path: the tripleclouds variant of the reference's
    CY47R1 test matrix (tests/ifs_variants.py:18-20): Tripleclouds in SW
    and LW, Exp-Ran overlap, gamma PDF, 3 regions, Fu ice, LW cloud
    scattering off (only the matrix's lwscat variant turns it on), LW
    aerosol scattering on, the LW derivatives, and aerosols on with
    TRIPLECLOUDS_AEROSOL_MAP (12 types). The LUT files come from
    `overrides`, for instance those of inputs.write_synthetic_luts."""
    return RadiationConfig(**{**SLICE_OPTIONS,
                              "i_solver_sw": Solver.TRIPLECLOUDS,
                              "i_solver_lw": Solver.TRIPLECLOUDS,
                              "i_overlap_scheme": Overlap.EXPONENTIAL_RANDOM,
                              "i_cloud_pdf_shape": PdfShape.GAMMA,
                              "nregions": 3,
                              "i_ice_model": IceModel.FU,
                              "do_lw_cloud_scattering": False,
                              "do_lw_aerosol_scattering": True,
                              "do_lw_derivatives": True,
                              "use_aerosols": True,
                              "n_aerosol_types":
                                  len(TRIPLECLOUDS_AEROSOL_MAP),
                              "i_aerosol_type_map": TRIPLECLOUDS_AEROSOL_MAP,
                              **overrides})


#: 12 aerosol types as CY47R1 configures them: hydrophilic (negative)
#: and hydrophobic (positive) entries of the aerosol LUT, and one type
#: (0) left out
TRIPLECLOUDS_AEROSOL_MAP = (-1, -2, -3, 1, 2, 3, -4, -5, 4, 5, 6, 0)

def spartacus_slice_config(**overrides) -> RadiationConfig:
    """The SPARTACUS path: the spartacus variant of the reference's CY47R1
    test matrix (tests/ifs_variants.py:22-26) on what
    tripleclouds_slice_config sets: SPARTACUS in SW and LW with 3D effects,
    Exp-Ran overlap, no delta scaling of the gas-cloud mix, 3 regions,
    gamma PDF, Fu ice, LW cloud scattering off, LW aerosol scattering on,
    12 aerosol types, the LW derivatives, and the 3D defaults of
    ecrad_tpu/config.py:170-181 (Explicit entrapment, LW side emissivity,
    max_gas_od_3d 8, max_cloud_od 16, max_3d_transfer_rate 10,
    min_cloud_effective_size 100 m). Its 3D terms need the cloud's inverse
    effective sizes (inputs.add_effective_sizes). The LUT files come from
    `overrides`; with inputs.write_synthetic_luts they are SYNTHETIC, so
    this is a parity configuration, not an ecRad result."""
    return tripleclouds_slice_config(**{
        "i_solver_sw": Solver.SPARTACUS, "i_solver_lw": Solver.SPARTACUS,
        "do_3d_effects": True, "do_sw_delta_scaling_with_gases": False,
        "i_3d_sw_entrapment": Entrapment.EXPLICIT,
        "do_lw_side_emissivity": True, "max_gas_od_3d": 8.0,
        "max_cloud_od": 16.0, "max_3d_transfer_rate": 10.0,
        "min_cloud_effective_size": 100.0, **overrides})


def check_supported(cfg: RadiationConfig) -> None:
    """Raise ValueError for a region count or dtype that no solver takes.
    Every other setting the JAX package's setup_radiation accepts is
    ported (a tiled-surface input is the driver's to refuse)."""
    solvers = (cfg.i_solver_sw, cfg.i_solver_lw)
    for solver in (Solver.TRIPLECLOUDS, Solver.SPARTACUS):
        if solver in solvers and cfg.nregions not in (2, 3):
            raise ValueError(f"{solver.name} takes 2 or 3 regions, not "
                             f"{cfg.nregions}")
    if cfg.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64, not "
                         f"{cfg.dtype!r}")
