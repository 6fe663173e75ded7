"""PyTorch port: tables, column densities and setcoef against the JAX
package on the same seeded columns.

The integer fields pick whole table rows, so they must be equal; the
float fields agree to float32 roundoff (rel <= 1e-6 of each field's
largest magnitude).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.constants import GAS_INDEX
from ecrad_tpu.optics.rrtmg import setcoef as jsc
from ecrad_tpu.optics.rrtmg.tables import load_tables as jax_load_tables
from ecrad_tpu_torch.inputs import make_columns
from ecrad_tpu_torch.optics.rrtmg import setcoef as psc
from ecrad_tpu_torch.optics.rrtmg.tables import load_tables

GASES = ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12", "hcfc22", "ccl4",
         "o3")


def _both(ncol, nlev, seed):
    cols = make_columns(ncol, nlev, seed)
    t = load_tables()
    phl, thl = cols["pressure_hl"], cols["temperature_hl"]
    pfl = 0.5 * (phl[:, :-1] + phl[:, 1:])
    tfl = 0.5 * (thl[:, :-1] + thl[:, 1:])
    gas = [cols["mixing_ratio"][:, :, GAS_INDEX[g]] for g in GASES]
    f32 = lambda x: np.asarray(x, np.float32)
    jgc = jsc.prepare_gases(*(jnp.asarray(f32(x)) for x in
                              (phl, pfl, tfl, *gas)))
    jc = jsc.setcoef(jgc, t["preflog"], t["tref"], t["chi_mls"])
    pgc = psc.prepare_gases(*(torch.as_tensor(f32(x)) for x in
                              (phl, pfl, tfl, *gas)))
    pc = psc.setcoef(pgc, *(torch.as_tensor(t[k], dtype=torch.float32)
                            for k in ("preflog", "tref", "chi_mls")))
    return jgc, jc, pgc, pc


def test_tables_are_the_jax_packages():
    a, b = load_tables(), jax_load_tables()
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_gases_matches_jax(seed):
    jgc, _, pgc, _ = _both(5, 16, seed)
    assert pgc._fields == jgc._fields
    for name in pgc._fields:
        a = getattr(pgc, name).numpy()
        b = np.asarray(getattr(jgc, name))
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel <= 1e-6, (name, rel)


#: The pressure-interpolation factors fac00..fac11 (and their SW copies)
#: are (1 - fp)(1 - ft)-type products with fp = 5 (preflog - log p).
#: XLA's CPU log is one ulp off the correctly rounded value for some
#: inputs (torch's is correctly rounded), and one ulp of log p for
#: |log p| < 8 (p < 2981 hPa) is at most 2**-21 = 4.8e-7; fp multiplies
#: it by 5, and |ft|, |1 - ft| <= 2.5 for these columns (ft spans about
#: -1.3 to 1), so the factors may differ by 5 * 4.8e-7 * 2.5 = 6e-6.
FAC_FIELDS = {f"fac{i}{j}{s}" for i in "01" for j in "01" for s in ("", "_sw")}
FAC_ATOL = 5 * 2.0 ** -21 * 2.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_setcoef_matches_jax(seed):
    _, jc, _, pc = _both(5, 16, seed)
    assert pc._fields == jc._fields
    tropo = pc.tropo.numpy()
    # a seeded column set reaches both the troposphere and stratosphere
    assert tropo.any() and (~tropo).any()
    for name in pc._fields:
        a = getattr(pc, name).numpy()
        b = np.asarray(getattr(jc, name))
        if name in psc.INT_FIELDS or name == "tropo":
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name in FAC_FIELDS:
            assert np.abs(a - b).max() <= FAC_ATOL, name
        else:
            rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert rel <= 1e-6, (name, rel)


def test_chi_rows_at_is_the_one_hot_gather():
    t = load_tables()
    idx = np.array([[0, 5, 58], [12, 30, 1]], np.int32)
    a = psc.chi_rows_at(torch.as_tensor(t["chi_mls"], dtype=torch.float32),
                        torch.as_tensor(idx)).numpy()
    b = np.asarray(jsc.chi_rows_at(jnp.asarray(t["chi_mls"], jnp.float32),
                                   jnp.asarray(idx)))
    np.testing.assert_array_equal(a, b)
