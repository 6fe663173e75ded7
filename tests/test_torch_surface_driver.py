"""PyTorch port: the offline driver's tiled-surface branch against the JAX
package's driver.

One 6 x 12 input file (make_clouds on make_columns, written by
save_inputs) with mls_london1's representation (1, 2, 3) of
inputs.make_surface (flat, vegetation, urban) added by
inputs.write_surface goes through the JAX driver (`python -m
ecrad_tpu.driver ... --no-jit`, one process per configuration, side by
side) and through the port's driver on the CPU:
  - Cloudless with use_canopy_full_spectrum_lw and do_canopy_gases_lw
    (the lowest level's gas optics in the canopies);
  - McICA on the SYNTHETIC LUTs of write_synthetic_luts with full-spectrum
    SW and LW canopies.
The flux file and the surface-flux file (the fourth argument) are held
to tests/test_torch_driver.py's bounds (_bound), the port's driver at
float64 the exact value. Besides: the column crop with a tiled surface,
which the JAX driver fails on and the port refuses (ROADMAP.md Queue C);
a height-increasing input, whose facet fluxes are those of the TOA-first
file (partition_fluxes takes the surface as the last half level before
the flip back); and the warning without a surface-flux file.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from ecrad_tpu_torch import driver
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import (make_clouds, make_columns, make_surface,
                                    reverse_levels, write_surface,
                                    write_synthetic_luts)
from ecrad_tpu_torch.io import output
from test_torch_driver import REPO, _bound, _namelist, _read_all

NCOL, NLEV, SEED = 6, 12, 0
REPRESENTATION = (1, 2, 3)
CONFIGS = {
    "cloudless": ("cloudless", " use_canopy_full_spectrum_lw = true,\n"
                               " do_canopy_gases_lw = true,\n"),
    "mcica": ("mcica", " use_canopy_full_spectrum_sw = true,\n"
                       " use_canopy_full_spectrum_lw = true,\n"),
}
SURFACE_VARS = {"flux_dn_lw_facet", "flux_up_lw_facet", "absorption_lw_canopy",
                "flux_dn_sw_facet", "flux_dn_direct_sw_facet",
                "flux_up_sw_facet", "absorption_sw_canopy"}


def _input(path, cols):
    output.save_inputs(path, *columns_to_inputs(cols, device="cpu"), None)
    write_surface(path, make_surface(NCOL, REPRESENTATION, SEED))
    return path


def _run(nam, inp, out, surf=None):
    args = [nam, inp, str(out)] + ([str(surf)] if surf else [])
    assert driver.main([*args, "--device", "cpu"]) == 0
    return _read_all(str(out)), (_read_all(str(surf)) if surf else None)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The input file, namelists, the JAX driver's two files per
    configuration (and its run on the cropped namelist), and the port's
    float64 files."""
    d = tmp_path_factory.mktemp("surface_driver")
    luts = write_synthetic_luts(str(d / "luts"), SEED)
    cols = make_clouds(make_columns(NCOL, NLEV, SEED), SEED)
    inp = _input(str(d / "in.nc"), cols)
    nam = {c: _namelist(d / f"{c}.nam", solver, luts, radiation=extra)
           for c, (solver, extra) in CONFIGS.items()}
    nam["crop"] = _namelist(d / "crop.nam", "cloudless", luts,
                            radiation=CONFIGS["cloudless"][1],
                            driver_opts=" istartcol = 2,\n iendcol = 5,\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    env.pop("ECRAD_FUSED_TAUMOL", None)
    procs = {c: subprocess.Popen(
        [sys.executable, "-m", "ecrad_tpu.driver", nam[c], inp,
         str(d / f"jax_{c}.nc"), str(d / f"jax_{c}_surface.nc"), "--no-jit"],
        cwd=str(d), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for c in nam}
    exact = {c: _run(_namelist(d / f"{c}64.nam", solver, luts,
                               radiation=extra + ' dtype = "float64",\n'),
                     inp, d / f"port64_{c}.nc", d / f"port64_{c}_surface.nc")
             for c, (solver, extra) in CONFIGS.items()}
    jax, crop = {}, None
    for c, proc in procs.items():
        out, err = proc.communicate(timeout=900)
        if c == "crop":
            crop = (proc.returncode, err)
            continue
        assert proc.returncode == 0, out[-2000:] + err[-4000:]
        jax[c] = (_read_all(str(d / f"jax_{c}.nc")),
                  _read_all(str(d / f"jax_{c}_surface.nc")))
    return dict(dir=d, luts=luts, cols=cols, input=inp, nam=nam, jax=jax,
                exact=exact, jax_crop=crop)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_surface_driver_matches_jax_driver(case, config):
    d = case["dir"]
    port = _run(case["nam"][config], case["input"], d / f"port_{config}.nc",
                d / f"port_{config}_surface.nc")
    assert set(port[1]) == SURFACE_VARS
    assert {"canopy_flux_dn_lw_surf", "canopy_flux_dn_direct_sw_surf"} \
        <= set(port[0])
    bad = {}
    for got, ref, exact in zip(port, case["jax"][config],
                               case["exact"][config]):
        assert set(got) == set(ref)
        for k, a in got.items():
            b = ref[k]
            assert a.shape == b.shape and np.isfinite(a).all(), k
            bound = _bound(k, b, exact[k], config == "mcica")
            if np.abs(a - b).max() > bound:
                bad[k] = (float(np.abs(a - b).max()), bound)
    assert not bad, bad
    flux, surf = port
    # the flat tile's ground facet sees the atmosphere's surface fluxes
    # (tests/test_surface.py:164-171)
    np.testing.assert_allclose(surf["flux_dn_sw_facet"][:, 0],
                               flux["flux_dn_sw"][:, -1], rtol=1e-5)
    np.testing.assert_allclose(surf["flux_dn_lw_facet"][:, 0],
                               flux["flux_dn_lw"][:, -1], rtol=1e-5)
    assert (surf["flux_up_sw_facet"] <= surf["flux_dn_sw_facet"]
            + 1e-3).all()


def test_column_crop_with_a_tiled_surface_is_refused(case):
    """The JAX driver crops the atmosphere to istartcol..iendcol but not
    the surface, and fails in calc_boundary_conditions on the columns'
    mismatch; the port refuses the combination by name."""
    rc, err = case["jax_crop"]
    assert rc != 0 and "incompatible shapes" in err, err[-2000:]
    with pytest.raises(ValueError, match="tiled-surface input"):
        driver.main([case["nam"]["crop"], case["input"],
                     str(case["dir"] / "crop.nc"), "--device", "cpu"])


def test_height_increasing_surface_input(case):
    """A surface-first file: the fluxes come back flipped, and the facet
    fluxes equal the TOA-first file's bit for bit."""
    d = case["dir"]
    rev = _input(str(d / "in_reversed.nc"), reverse_levels(case["cols"]))
    nam = case["nam"]["mcica"]
    fwd = _run(nam, case["input"], d / "fwd.nc", d / "fwd_surface.nc")
    back = _run(nam, rev, d / "rev.nc", d / "rev_surface.nc")
    for k, v in fwd[0].items():
        want = v[:, ::-1] if v.ndim == 2 and v.shape[1] == NLEV + 1 else v
        np.testing.assert_array_equal(back[0][k], want, err_msg=k)
    for k, v in fwd[1].items():
        np.testing.assert_array_equal(back[1][k], v, err_msg=k)


def test_surface_input_without_a_surface_file_warns(case, capsys):
    d = case["dir"]
    nam = _namelist(d / "verbose.nam", "cloudless", case["luts"],
                    radiation=CONFIGS["cloudless"][1],
                    driver_opts=" iverbose = 2,\n")
    _run(nam, case["input"], d / "nosurf.nc")
    out = capsys.readouterr().out
    assert "Warning: file name for surface-flux outputs not provided" in out
    assert "Tile 3: Urban3D" in out and "Region 2: street canyon" in out
