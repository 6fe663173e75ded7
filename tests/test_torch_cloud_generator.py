"""PyTorch port: the McICA stochastic cloud generator against the JAX
package at float32, with both PDF sampling paths (the Chebyshev fast path
and the bilinear table), the three overlap schemes and beta overlap, on
the synthetic gamma and lognormal PDF tables.

Both programs draw the same random numbers (tests/test_torch_threefry.py),
so the cloudy-subcolumn masks must be identical. od_scaling is held to
1e-5 relative per element: the quantile evaluation differs by ulps
(torch.special.ndtri against jax.scipy.special.ndtri, then exp of a
degree-16 Chebyshev series), a few 1e-7 of the value. The total cloud
cover is held to 2e-6 (tests/test_torch_cloud_cover.py).
"""
import os

import jax
import numpy as np
import pytest
import torch

from ecrad_tpu.config import Overlap as JOverlap
from ecrad_tpu.solvers import cloud_generator as jgen
from ecrad_tpu.solvers import pdf_sampler as jpdf
from ecrad_tpu_torch.config import Overlap
from ecrad_tpu_torch.inputs import (make_clouds, make_columns,
                                    write_synthetic_luts)
from ecrad_tpu_torch.solvers import cloud_generator as pgen
from ecrad_tpu_torch.solvers import pdf_sampler as ppdf
from ecrad_tpu_torch.types import Cloud, Thermodynamics

NCOL, NLEV = 6, 24


@pytest.fixture(scope="module")
def lut_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("luts"))
    write_synthetic_luts(d, 0)
    return d


@pytest.fixture(scope="module")
def cloud():
    """The cloud the McICA path hands the generator: overlap parameter
    from a 2 km decorrelation length, cropped; float32 numpy."""
    cols = make_clouds(make_columns(NCOL, NLEV, 3), 3)
    t = lambda k: torch.as_tensor(cols[k])
    c = Cloud(**{k: t(k) for k in ("q_liq", "q_ice", "re_liq", "re_ice",
                                   "fraction", "fractional_std")})
    c = c.set_overlap_param(Thermodynamics(t("pressure_hl"),
                                           t("temperature_hl")), 2000.0)
    c = c.crop_cloud_fraction()
    return {k: getattr(c, k).numpy().astype(np.float32)
            for k in ("fraction", "overlap_param", "fractional_std")}


def _samplers(lut_dir, shape, table):
    path = os.path.join(lut_dir, f"synthetic_mcica_{shape}.nc")
    cfg = type("C", (), {"cloud_pdf_file": path})
    p, j = ppdf.setup_pdf_sampler(cfg), jpdf.setup_pdf_sampler(cfg)
    np.testing.assert_array_equal(p.val, j.val)
    np.testing.assert_array_equal(p.cheb, j.cheb)
    assert (p.fsd1, p.inv_fsd_interval, p.z0, p.z1) == \
        (j.fsd1, j.inv_fsd_interval, j.z0, j.z1)
    if table:
        p.cheb = j.cheb = None
    return p, j


# overlap, beta overlap, PDF shape, table path (else Chebyshev), and the
# SW (112 g-points, seed offset 0) or LW (140, 997) generator
CASES = {
    "exp_exp_fast_sw": (Overlap.EXPONENTIAL_EXPONENTIAL, False, "gamma",
                        False, 112, 0),
    "exp_exp_fast_lw": (Overlap.EXPONENTIAL_EXPONENTIAL, False, "gamma",
                        False, 140, 997),
    "exp_ran_fast_lw": (Overlap.EXPONENTIAL_RANDOM, False, "gamma", False,
                        140, 997),
    "max_ran_fast_sw": (Overlap.MAXIMUM_RANDOM, False, "lognormal", False,
                        112, 0),
    "exp_exp_beta_table_sw": (Overlap.EXPONENTIAL_EXPONENTIAL, True,
                              "gamma", True, 112, 0),
    "exp_ran_table_lw": (Overlap.EXPONENTIAL_RANDOM, False, "lognormal",
                         True, 140, 997),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cloud_generator_matches_jax(lut_dir, cloud, case):
    overlap, beta, shape, table, ng, offset = CASES[case]
    psamp, jsamp = _samplers(lut_dir, shape, table)
    iseed = np.arange(NCOL, dtype=np.int32) + offset
    ref_scaling, ref_tcc = jax.jit(lambda s, f, a, fsd: jgen.cloud_generator(
        ng, s, JOverlap(int(overlap)), 1e-6, f, a, 0.5, fsd, jsamp,
        is_beta_overlap=beta))(iseed, cloud["fraction"],
                               cloud["overlap_param"],
                               cloud["fractional_std"])
    got_scaling, got_tcc = pgen.cloud_generator(
        ng, torch.as_tensor(iseed), overlap, 1e-6,
        torch.as_tensor(cloud["fraction"]),
        torch.as_tensor(cloud["overlap_param"]), 0.5,
        torch.as_tensor(cloud["fractional_std"]), psamp,
        is_beta_overlap=beta,
        table=ppdf.pdf_table(psamp, torch.float32, "cpu"))
    a, b = got_scaling.numpy(), np.asarray(ref_scaling)
    assert a.shape == (NCOL, NLEV, ng) and a.dtype == np.float32
    np.testing.assert_array_equal(a > 0, b > 0)
    assert (a > 0).sum() > 0.05 * a.size          # clouds were generated
    assert (np.abs(a - b) <= 1e-5 * np.abs(b)).all(), \
        np.abs(a - b).max()
    assert np.abs(got_tcc.numpy() - np.asarray(ref_tcc)).max() <= 2e-6
