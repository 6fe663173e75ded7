"""PyTorch port: the plain versions of kernel B4 (the McICA clear/total
layer optics, ops/mcica_optics.py) against the JAX package's plain branch
(use_pallas=False) and its Pallas kernels in interpret mode, at
tests/test_mcica_optics.py's shapes and with its bounds: SW 2e-3 of each
output's range (the direct-beam terms amplify last-bit differences ~1e6-
fold at the k mu0 = 1 resonance, which both nudge by 1e-6), LW 1e-4.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ecrad_tpu.ops import mcica_optics as jmo
from ecrad_tpu_torch.ops import mcica_optics as pmo


@pytest.fixture(scope="module")
def case():
    """The inputs of tests/test_mcica_optics.py (same seed and shapes)."""
    rng = np.random.RandomState(3)
    ncol, nlev, ng, nb = 37, 11, 112, 14
    od = rng.gamma(0.5, 1.0, (ncol, nlev, ng)).astype(np.float32)
    ssa = rng.uniform(0.1, 0.999, (ncol, nlev, ng)).astype(np.float32)
    g = rng.uniform(0.0, 0.9, (ncol, nlev, ng)).astype(np.float32)
    odc = rng.gamma(0.5, 2.0, (ncol, nlev, nb)).astype(np.float32)
    ssac = rng.uniform(0.3, 0.999, (ncol, nlev, nb)).astype(np.float32)
    gc = rng.uniform(0.5, 0.9, (ncol, nlev, nb)).astype(np.float32)
    osc = rng.gamma(1.0, 1.0, (ncol, nlev, ng)).astype(np.float32)
    frac = rng.rand(ncol, nlev) > 0.5
    mu0 = rng.uniform(-0.1, 1.0, ncol).astype(np.float32)
    band_from_g = np.sort(rng.randint(0, nb, ng))
    planck = rng.uniform(1.0, 30.0, (ncol, nlev + 1, ng)).astype(np.float32)
    return dict(od=od, ssa=ssa, g=g, odc=odc, ssac=ssac, gc=gc, osc=osc,
                frac=frac, mu0=mu0, band_from_g=band_from_g, planck=planck)


def _band(c):
    """The case's band map as the setup holds it for kernel B4."""
    return torch.as_tensor(c["band_from_g"], dtype=torch.int32)


def _cmp(got, ref, tol):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.float32, i
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < tol, (i, rel)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("delta_all", [False, True])
def test_b4_sw_plain_matches_jax(case, delta_all, interpret):
    c = case
    keys = ("od", "ssa", "g", "odc", "ssac", "gc")
    got = pmo.sw_clear_total_reftrans(
        *(torch.as_tensor(c[k]) for k in keys), _band(c),
        torch.as_tensor(c["osc"]), torch.as_tensor(c["frac"]),
        torch.as_tensor(c["mu0"]), delta_all)
    ref = jmo.sw_clear_total_reftrans(
        *(c[k] for k in keys), c["band_from_g"], c["osc"], c["frac"],
        c["mu0"], delta_all, use_pallas=False, interpret=interpret)
    _cmp(got, ref, 2e-3)


@pytest.mark.parametrize("interpret", [False, True])
def test_b4_lw_plain_matches_jax(case, interpret):
    c = case
    got = pmo.lw_clear_total_noscat(
        torch.as_tensor(c["od"]), torch.as_tensor(c["odc"]),
        _band(c), torch.as_tensor(c["osc"]),
        torch.as_tensor(c["frac"]), torch.as_tensor(c["planck"]))
    ref = jmo.lw_clear_total_noscat(
        c["od"], c["odc"], c["band_from_g"], c["osc"], c["frac"],
        c["planck"], use_pallas=False, interpret=interpret)
    _cmp(got, ref, 1e-4)


def test_b4_total_family_reuses_clear_where_not_cloudy(case):
    c = case
    out = pmo.lw_clear_total_noscat_plain(
        torch.as_tensor(c["od"]), torch.as_tensor(c["odc"]),
        _band(c), torch.as_tensor(c["osc"]),
        torch.as_tensor(c["frac"]), torch.as_tensor(c["planck"]))
    clear_layers = torch.as_tensor(~c["frac"]).T[:, None, :]
    for i in range(3):
        assert torch.equal(torch.where(clear_layers, out[i], 0),
                           torch.where(clear_layers, out[3 + i], 0))
    assert not torch.equal(out[0], out[3])


@pytest.mark.parametrize("which", ["sw", "lw"])
def test_b4_kernel_wrappers_refuse_cpu_tensors(case, which):
    c = case
    t = lambda k: torch.as_tensor(c[k])
    before = dict(pmo.launches)
    with pytest.raises(ValueError, match="CUDA"):
        if which == "sw":
            pmo.mcica_sw_optics_fused(
                t("od"), t("ssa"), t("g"), t("odc"), t("ssac"), t("gc"),
                _band(c), t("osc"), t("frac"), t("mu0"), False)
        else:
            pmo.mcica_lw_optics_fused(t("od"), t("odc"), _band(c),
                                      t("osc"), t("frac"), t("planck"))
    assert pmo.launches == before
