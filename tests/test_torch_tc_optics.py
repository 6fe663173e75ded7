"""PyTorch port: the plain version of kernel B11 (Tripleclouds' SW layer
optics, ops/tc_optics.py), as `tripleclouds._region_props_sw_g` takes it
on CPU tensors, against the composition the solver ran before the
kernel, restated here: the region mix of the gas and the band-expanded,
od_scaling-scaled cloud, delta-Eddington where the gases are delta
scaled, then two_stream.sw_gammas and two_stream.sw_reftrans for the
regions, and sw_gammas and sw_reftrans of the gas for the clear sky.
Bit for bit, with 2 and 3 regions, the gamma and the lognormal PDF's
scalings, delta scaling on and off, in float32 and float64, on layers
cloudy, clear and below the cloud fraction threshold, a night column,
and cells placed within the float32 resonance window (0.03 of k mu0 = 1)
and within its 1e-6 nudge, in the clear sky and in a cloudy region.

`case()` is also the card's case (tests/test_torch_kernels_gpu.py holds
B11 to this plain version on the card), so this file imports no jax.
"""
import numpy as np
import pytest
import torch

from ecrad_tpu_torch.optics.cloud import delta_eddington
from ecrad_tpu_torch.solvers import tripleclouds
from ecrad_tpu_torch.solvers import two_stream as ts

THRESHOLD = 1e-6
# the window's and the nudge's offsets of k mu0 from 1
NEAR = {"window": 0.01, "nudge": 2e-7}


def _parent_props(od, ssa, g, odc, ssac, gc, band, osc, cloudy, delta_all):
    """The per-region properties g-first, (nlev, nreg, ng, ncol), and the
    gas g-first, (nlev, ng, ncol), as the solver built them."""
    gf = lambda x: x.permute(1, 2, 0).contiguous()
    od_g, ssa_g, g_g = gf(od), gf(ssa), gf(g)
    odc_g, ssac_g, gc_g = (gf(x)[:, band, :] for x in (odc, ssac, gc))
    sc_g = osc.permute(1, 2, 0)
    cmask = cloudy.T[:, None, :]
    zero = torch.zeros((), dtype=od.dtype, device=od.device)
    outs = [[od_g], [ssa_g], [g_g]]
    for r in range(1, sc_g.shape[1]):
        odc_r = odc_g * sc_g[:, r][:, None, :]
        od_t = od_g + odc_r
        scat = ssa_g * od_g + ssac_g * odc_r
        ssa_t = torch.where(od_t > 0, scat / torch.clamp(od_t, min=1e-30),
                            zero)
        g_t = torch.where(scat > 0,
                          (g_g * ssa_g * od_g + gc_g * ssac_g * odc_r)
                          / torch.clamp(scat, min=1e-30), zero)
        for out, x, base in zip(outs, (od_t, ssa_t, g_t), (od_g, ssa_g, g_g)):
            out.append(torch.where(cmask, x, base))
    od_r, ssa_r, g_r = (torch.stack(o, 1) for o in outs)
    if delta_all:
        od_r, ssa_r, g_r = delta_eddington(od_r, ssa_r, g_r)
    return (od_r, ssa_r, g_r), (od_g, ssa_g, g_g)


def parent_composition(od, ssa, g, odc, ssac, gc, band, osc, cloudy, mu0,
                       delta_all):
    (od_r, ssa_r, g_r), (od_g, ssa_g, g_g) = _parent_props(
        od, ssa, g, odc, ssac, gc, band, osc, cloudy, delta_all)
    mu0_b = mu0[None, None, None, :]
    region = tuple(x.contiguous() for x in ts.sw_reftrans(
        mu0_b, od_r, ssa_r, *ts.sw_gammas(mu0_b, ssa_r, g_r)))
    mu0_c = mu0[None, :]
    clear = ts.sw_reftrans(mu0_c, od_g, ssa_g,
                           *ts.sw_gammas(mu0_c, ssa_g, g_g))
    return region, clear


def _k(ssa, g):
    """k of the SW two-stream equations (two_stream._k_exponent)."""
    g1, g2, _ = ts.sw_gammas(torch.ones((), device=ssa.device), ssa, g)
    return torch.sqrt(torch.clamp((g1 - g2) * (g1 + g2), min=ts.KMIN))


def case(nreg, gamma, delta_all, dtype=torch.float32, ncol=12, nlev=9,
         ng=16, nb=5, seed=0, device="cpu"):
    """The arguments of _region_props_sw_g (band_from_g int32) on random
    optics: layers cloudy, clear and below THRESHOLD, the last column at
    night; columns 0 and 1 move one clear-sky cell into the resonance
    window and the nudge, columns 2 and 3 one cloudy region cell (mu0 =
    (1 + NEAR) / k, rounded to the dtype)."""
    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    od = rng.gamma(0.5, 1.0, (ncol, nlev, ng))
    od[:, 0, :3] = 0.0
    ssa = rng.uniform(0.1, 0.999, (ncol, nlev, ng))
    g = rng.uniform(0.0, 0.9, (ncol, nlev, ng))
    odc = rng.gamma(0.5, 2.0, (ncol, nlev, nb))
    ssac = rng.uniform(0.3, 0.999, (ncol, nlev, nb))
    gc = rng.uniform(0.5, 0.9, (ncol, nlev, nb))
    frac = np.where(rng.rand(ncol, nlev) < 0.4, 0.0,
                    rng.uniform(0.05, 1.0, (ncol, nlev)))
    frac[:, 1] = 0.3 * THRESHOLD          # cloudy, yet below the threshold
    frac[2:4, 4] = 0.6                    # the cloudy resonant cells'
    fsd = rng.uniform(0.2, 2.5, (ncol, nlev))
    mu0 = rng.uniform(0.05, 1.0, ncol)
    mu0[-1] = 1e-10                       # a night column, clamped
    band = np.sort(rng.randint(0, nb, ng))
    band[0], band[-1] = 0, nb - 1
    od, ssa, g, odc, ssac, gc = map(t, (od, ssa, g, odc, ssac, gc))
    cf = t(frac)
    _, osc = tripleclouds.calc_region_properties(nreg, gamma, cf, t(fsd),
                                                 THRESHOLD)
    cloudy = cf > 0.0
    b32 = torch.as_tensor(band, dtype=torch.int32, device=device)
    (od_r, ssa_r, g_r), (_, ssa_g, g_g) = _parent_props(
        od, ssa, g, odc, ssac, gc, b32.long(), osc, cloudy, delta_all)
    k_clear = _k(ssa_g, g_g)                       # (nlev, ng, ncol)
    k_region = _k(ssa_r, g_r)[:, nreg - 1]         # the last region
    for col, (k, d) in enumerate(((k_clear, NEAR["window"]),
                                  (k_clear, NEAR["nudge"]),
                                  (k_region, NEAR["window"]),
                                  (k_region, NEAR["nudge"]))):
        kc = float(k[4, 5, col])
        mu0[col] = (1.0 + d) / kc
    return (od, ssa, g, odc, ssac, gc, b32, osc, cloudy, t(mu0), delta_all)


def near_cells(args, bound):
    """The (region, clear) cells with |k mu0 - 1| < bound, k and mu0 in the
    case's dtype, as two_stream.sw_reftrans finds them."""
    (od, ssa, g, odc, ssac, gc, band, osc, cloudy, mu0, delta_all) = args
    (_, ssa_r, g_r), (_, ssa_g, g_g) = _parent_props(
        od, ssa, g, odc, ssac, gc, band.long(), osc, cloudy, delta_all)
    n_r = int((torch.abs(_k(ssa_r, g_r) * mu0 - 1.0) < bound).sum())
    n_c = int((torch.abs(_k(ssa_g, g_g) * mu0 - 1.0) < bound).sum())
    return n_r, n_c


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("delta_all", [False, True],
                         ids=["gas_delta_off", "gas_delta_on"])
@pytest.mark.parametrize("gamma", [True, False], ids=["gamma", "lognormal"])
@pytest.mark.parametrize("nreg", [3, 2])
def test_plain_version_is_the_parents_composition(nreg, gamma, delta_all,
                                                  dtype):
    args = case(nreg, gamma, delta_all, dtype)
    for bound in (ts.RESONANCE_WINDOW, 1e-6):
        n_r, n_c = near_cells(args, bound)
        assert n_r >= 1 and n_c >= 1, (bound, n_r, n_c)
    region, clear = tripleclouds._region_props_sw_g(*args)
    ref_region, ref_clear = parent_composition(
        *args[:6], args[6].long(), *args[7:])
    ncol, nlev, ng = args[0].shape
    assert len(region) == len(clear) == 5
    for got, ref, shape in ((region, ref_region, (nlev, nreg, ng, ncol)),
                            (clear, ref_clear, (nlev, ng, ncol))):
        for i, (a, b) in enumerate(zip(got, ref)):
            assert a.shape == shape and a.dtype == dtype, i
            assert torch.equal(a, b), i
    # a layer that is not cloudy gives every region the gas's values
    clear_layer = ~args[8].T                       # (nlev, ncol)
    for a in region:
        for r in range(1, nreg):
            assert torch.equal(a[:, r].permute(0, 2, 1)[clear_layer],
                               a[:, 0].permute(0, 2, 1)[clear_layer])
    if not delta_all:
        for a, b in zip(region, clear):
            assert torch.equal(a[:, 0], b)
