"""PyTorch port: analysis/ (loading driver files, derived fields, the
numeric comparison and its command line, the plots) against the JAX
package's analysis/, on a 5 x 10 input written by save_inputs (with
aerosol mixing ratios of 11 types in the readers' layout) and the port
driver's Cloudless and McICA outputs of it (the SYNTHETIC LUTs). The
port's modules import neither jax nor torch, so they run where neither
is installed. Every array must equal the JAX package's bit for bit, and
the report's text be the same.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from ecrad_tpu_torch import analysis
from ecrad_tpu_torch import driver
from ecrad_tpu_torch.analysis import compare as pcompare
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import make_clouds, make_columns, \
    write_synthetic_luts
from ecrad_tpu_torch.io import output
from test_torch_driver import REPO, _namelist, _rewrite

NCOL, NLEV, SEED = 5, 10, 0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("analysis")
    luts = write_synthetic_luts(str(d / "luts"), SEED)
    cols = make_clouds(make_columns(NCOL, NLEV, SEED), SEED)
    inp = str(d / "in.nc")
    output.save_inputs(inp, *columns_to_inputs(cols, device="cpu"), None)
    mmr = np.random.RandomState(SEED).uniform(0, 1e-8, (NCOL, 11, NLEV))
    _rewrite(inp, inp, {"aerosol_mmr": (("column", "aerosol_type",
                                         "level"), mmr)})
    out = {}
    for config in ("cloudless", "mcica"):
        nam = _namelist(d / f"{config}.nam", config, luts)
        out[config] = str(d / f"{config}.nc")
        assert driver.main([nam, inp, out[config], "--device", "cpu"]) == 0
    return d, inp, out


def _equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_load_and_derive_match_jax(files):
    from ecrad_tpu import analysis as janalysis
    _, inp, out = files
    inputs = analysis.load_inputs(inp)
    _equal(inputs, janalysis.load_inputs(inp))
    assert {"pressure_fl", "sea_salt", "dust", "organics", "black_carbon",
            "sulphate"} <= set(inputs)
    for config, path in out.items():
        flux = analysis.load_fluxes(path)
        _equal(flux, janalysis.load_fluxes(path))
        derived = analysis.derive_fields(flux, inputs)
        _equal(derived, janalysis.derive_fields(flux, inputs))
        assert {"heating_rate_lw", "flux_net_sw",
                "cloud_radiative_effect_sw"} <= set(derived)
        # no cloud in the Cloudless run: no cloud radiative effect
        cre = np.abs(derived["cloud_radiative_effect_sw"]).max()
        assert (cre == 0.0) == (config == "cloudless")
    with pytest.raises(ValueError, match="pressure_hl"):
        analysis.derive_fields({}, {})


def test_compare_outputs_and_report_match_jax(files):
    from ecrad_tpu import analysis as janalysis
    _, inp, out = files
    inputs = analysis.load_inputs(inp)
    ref, test = (analysis.load_fluxes(out[c]) for c in ("cloudless",
                                                          "mcica"))
    for a, b in ((ref, test), (test, ref), (test, test)):
        stats = analysis.compare_outputs(inputs, a, b)
        assert stats == janalysis.compare_outputs(inputs, a, b)
        assert analysis.format_report(stats) \
            == janalysis.format_report(stats)
    same = analysis.compare_outputs(inputs, test, test)
    assert same and all(s["max_abs"] == 0.0 for s in same.values())
    short = dict(test, cloud_cover_lw=test["cloud_cover_lw"][:2])
    stats = analysis.compare_outputs(inputs, test, short)
    assert stats["cloud_cover_lw"] == {"error": "shape mismatch"}
    assert analysis.format_report(stats) \
        == janalysis.format_report(stats)


@pytest.mark.parametrize("tolerance", [None, "0.001", "1000"])
def test_compare_cli_text_matches_jax(files, capsys, tolerance):
    from ecrad_tpu.analysis import compare as jcompare
    _, inp, out = files
    argv = [inp, out["cloudless"], out["mcica"]]
    if tolerance:
        argv += ["--tolerance", tolerance]
    rc = pcompare.main(argv)
    text = capsys.readouterr().out
    assert rc == jcompare.main(argv)
    assert text == capsys.readouterr().out
    assert rc == (1 if tolerance == "0.001" else 0)
    assert ("FAIL" in text) == (tolerance == "0.001")


def test_compare_module_runs_without_jax_or_torch(files):
    """`python -m ecrad_tpu_torch.analysis.compare` with jax and torch
    made unimportable: the report, every field 0 on identical files."""
    _, inp, out = files
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['torch'] = None; sys.argv = sys.argv[1:]; "
            "runpy.run_module('ecrad_tpu_torch.analysis.compare', "
            "run_name='__main__', alter_sys=True)")
    res = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", code, "compare", inp,
         out["mcica"], out["mcica"], "--tolerance", "0"],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0].split() == ["variable", "max|d|", "mean|d|", "rms",
                                "bias"]
    rows = [ln.split() for ln in lines[1:-1]]
    assert len(rows) == 16
    assert all(float(x) == 0.0 for r in rows for x in r[1:])
    assert lines[-1] == "PASS: worst flux max|d| 0.000 <= tolerance 0.0"


def test_plot_output_writes_its_file(files):
    pytest.importorskip("matplotlib")
    from ecrad_tpu_torch.analysis.plot import main, plot_output
    d, inp, out = files
    dst = d / "overview.png"
    plot_output(inp, out["mcica"], str(dst))
    assert dst.exists() and dst.stat().st_size > 10000
    assert main([inp, out["mcica"], str(d / "diff.png"), "--reference",
                 out["cloudless"]]) == 0
    assert (d / "diff.png").stat().st_size > 10000
