"""PyTorch port: the whole Homogeneous radiation() against the JAX package,
on the columns, synthetic LUTs and bounds of
tests/test_torch_tripleclouds.py (float32 under the Cloudless slice's
rule, float64 to 1e-9 of each field's range), both level orientations.

Configurations: Homogeneous with aerosols, LW cloud and aerosol
scattering and the LW derivatives (kernels B3 SW and B3' on the GPU);
and without any LW scattering, so the aerosol LW term takes the
absorption-only co-albedo form and both LW passes the no-scattering
sweep (B3 LW).
"""
import numpy as np
import pytest

from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.inputs import write_synthetic_luts

# columns and lut_overrides are read from this module by jax_runs' jobs
from test_torch_tripleclouds import (SEED, check_f32, check_f64, columns,
                                     jax_runs, lut_overrides, port_runs)

HOMOGENEOUS = dict(i_solver_sw=pconfig.Solver.HOMOGENEOUS,
                   i_solver_lw=pconfig.Solver.HOMOGENEOUS)
CONFIGS = {
    "homogeneous": lambda luts: pconfig.tripleclouds_slice_config(
        **luts, **HOMOGENEOUS, do_lw_cloud_scattering=True),
    "homogeneous_noscat": lambda luts: pconfig.tripleclouds_slice_config(
        **luts, **HOMOGENEOUS, do_lw_aerosol_scattering=False,
        do_lw_derivatives=False),
}


@pytest.fixture(scope="module")
def fluxes(tmp_path_factory):
    luts = write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED,
                                ice="fu")
    return (port_runs(CONFIGS, luts, columns()),
            jax_runs(__name__, luts, str(tmp_path_factory.mktemp("jax"))))


@pytest.mark.parametrize("orient", ["toa_first", "surface_first"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_homogeneous_f32_matches_jax(fluxes, config, orient):
    port, jax = fluxes
    got = port[config, "float32"][orient]
    assert {"cloud_cover_sw", "cloud_cover_lw"} <= set(got)
    assert ("lw_derivatives" in got) == (config == "homogeneous")
    bad = check_f32(got, jax[config, "float32"][orient],
                    port[config, "float64"][orient])
    assert not bad, bad


@pytest.mark.parametrize("orient", ["toa_first", "surface_first"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_homogeneous_f64_matches_jax(fluxes, config, orient):
    port, jax = fluxes
    bad = check_f64(port[config, "float64"][orient],
                    jax[config, "float64"][orient])
    assert not bad, bad


def test_homogeneous_cloud_cover_is_any_cloud(fluxes):
    """Homogeneous reports cloud cover 1 where any layer holds cloud, 0
    elsewhere, in both regions."""
    port = fluxes[0]["homogeneous", "float32"]["toa_first"]
    frac = columns()["toa_first"]["fraction"]
    want = (frac >= 1e-6).any(1).astype(np.float32)
    np.testing.assert_array_equal(port["cloud_cover_sw"], want)
    np.testing.assert_array_equal(port["cloud_cover_lw"], want)
