"""PyTorch port on a CUDA GPU: each hand-written kernel against its plain
PyTorch version on the card, the wrappers' refusals, and the launch
counts of the Cloudless, McICA, Tripleclouds, Homogeneous and SPARTACUS
paths and of the per-band gas optics (ECRAD_FUSED_TAUMOL=0, kernel B10).
The McICA generator's random-fields kernel (csrc/threefry.cu) is held to
the plain utils/threefry.py path on the CPU bit for bit.

Marked `gpu`; every test decides inside itself whether there is a card
and skips without one. The file imports no jax, so it runs on a machine
without it (from the repository root, bypassing tests/conftest.py, which
imports jax):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_kernels_gpu.py

Bounds: B1/B2 the JAX package's fused-taumol bound (rel 1e-5 where
tau > 1e-6, pfrac atol 1e-6), B3/B3'/B5 its fused-sweep bound (2e-6 of
the range), B4 its McICA-optics bounds (tests/test_mcica_optics.py: SW 2e-3,
LW 1e-4 of the range), B6-B9 its SPARTACUS kernel-vs-fallback bound (2e-5
of the plain output's largest value, tools/check_kernel_equivalence.py),
B10 its gather-interp bound (5e-6 of the largest value, the same tool),
B12 (the aerosol optics) bit for bit in float32 and float64.
The kernels build with -fmad=false, so only summation order separates
them from the plain versions. The double forms of B1-B4 (the float64
path's) against their plain versions in float64 on the path's operands
at 2048 x 137: B1 and B2 within 1e-13 of each output's largest value
(their sums run in slot order, the plain versions' in PyTorch's: up to
21 double terms reassociated; measured 4.8e-16 and 2.7e-16), B3, B3' and
B4's SW form bit for bit (the same operations in the same order, with
CUDA's double exp, sqrt and division on both sides); the whole float64
McICA call within 1e-9 of each field's largest value of the plain path
on the CPU (measured below 1e-12 against the float64 reference).
"""
import numpy as np
import pytest
import torch

from ecrad_tpu_torch.config import (TRIPLECLOUDS_AEROSOL_MAP, Entrapment,
                                    GasModel, Overlap, PdfShape, Solver,
                                    cloudless_slice_config,
                                    mcica_slice_config,
                                    spartacus_slice_config,
                                    tripleclouds_slice_config)
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                    make_clouds, make_columns,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import (_cloud_stage, radiation,
                                       setup_radiation)
from ecrad_tpu_torch.ops import (adding_fused, aerosol_optics,
                                 gather_interp, mcica_generator,
                                 mcica_optics, spartacus_adding,
                                 spartacus_reftrans, tc_optics)
from ecrad_tpu_torch.ops import random_fields as fields
from ecrad_tpu_torch.optics import aerosol as aerosol_module
from ecrad_tpu_torch.optics.rrtmg import taumol_lw, taumol_sw
from ecrad_tpu_torch.optics.rrtmg.setcoef import prepare_gases, setcoef
from ecrad_tpu_torch.solvers import adding, tripleclouds
from ecrad_tpu_torch.solvers.cloud_generator import cloud_generator_plain
from ecrad_tpu_torch.utils import hooks

import aerosol_cases as aer_cases
import test_torch_mcica_generator as gen_cases
import test_torch_tc_optics as tc_cases

pytestmark = pytest.mark.gpu

GASES = ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12", "hcfc22", "ccl4",
         "o3")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def slice_state(cuda):
    setup = setup_radiation(cloudless_slice_config(), device=cuda)
    cols = make_columns(96, 137, 0)
    sl, th, gas = columns_to_inputs(cols, device=cuda)
    phl, thl = th.pressure_hl, th.temperature_hl
    t = setup.gas
    gc = prepare_gases(phl, 0.5 * (phl[:, :-1] + phl[:, 1:]),
                       0.5 * (thl[:, :-1] + thl[:, 1:]),
                       *(gas.get(g) for g in GASES))
    c = setcoef(gc, t.preflog, t.tref, t.chi_mls).flip_levels()
    return setup, (sl, th, gas), c


def _tau_close(a, b):
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    mask = np.abs(b) > 1e-6
    assert (np.abs(a - b) / np.maximum(np.abs(b), 1e-30))[mask].max() \
        <= 1e-5


def test_b1_kernel_matches_plain(slice_state):
    setup, _, c = slice_state
    fc, ic = taumol_lw.pack_coeffs(c, setup.gas.chi_mls)
    n0 = taumol_lw.launches
    tau, pf = taumol_lw.taumol_lw_kernel(fc, ic, setup.gas.lw)
    torch.cuda.synchronize()
    assert taumol_lw.launches == n0 + 1
    tau0, pf0 = taumol_lw.taumol_lw_plain(fc, ic, setup.gas.lw)
    _tau_close(tau, tau0)
    assert float((pf - pf0).abs().max()) <= 1e-6


def test_b2_kernel_matches_plain(slice_state):
    setup, _, c = slice_state
    fc, ic = taumol_sw.pack_coeffs(c)
    n0 = taumol_sw.launches
    taug, taur = taumol_sw.taumol_sw_kernel(fc, ic, setup.gas.sw)
    torch.cuda.synchronize()
    assert taumol_sw.launches == n0 + 1
    g0, r0 = taumol_sw.taumol_sw_plain(fc, ic, setup.gas.sw)
    _tau_close(taug, g0)
    _tau_close(taur, r0)


@pytest.mark.parametrize("cells", ["n1", "n137", "n4099", "troposphere",
                                   "stratosphere"])
def test_b1_ragged_and_regime_cells(slice_state, cells):
    """B1 on 1, 137 and 4,099 cells (no multiple of its 32-cell tile: the
    last tile's lanes past the end), and on the tropospheric and the
    stratospheric cells of the slice apart: within its bound of the plain
    version."""
    setup, _, c = slice_state
    fc, ic = taumol_lw.pack_coeffs(c, setup.gas.chi_mls)
    if cells.startswith("n"):
        sel = torch.arange(int(cells[1:]), device=fc.device)
    else:
        tropo = fc[0] > 0
        sel = torch.nonzero(tropo if cells == "troposphere" else ~tropo)[:, 0]
    assert sel.numel() > 0
    fc, ic = fc[:, sel].contiguous(), ic[:, sel].contiguous()
    tau, pf = taumol_lw.taumol_lw_kernel(fc, ic, setup.gas.lw)
    torch.cuda.synchronize()
    tau0, pf0 = taumol_lw.taumol_lw_plain(fc, ic, setup.gas.lw)
    if bool((tau0.abs() > 1e-6).any()):
        _tau_close(tau, tau0)
    assert float((pf - pf0).abs().max()) <= 1e-6


@pytest.mark.parametrize("cells", ["n1", "n31", "n33", "n4099",
                                   "troposphere", "stratosphere"])
def test_b2_ragged_and_regime_cells(slice_state, cells):
    """B2 on 1, 31, 33 and 4,099 cells (around and past its 32-cell tile:
    the last tile's lanes past the end), and on the tropospheric and the
    stratospheric cells of the slice apart: within its bound of the plain
    version, taur equal."""
    setup, _, c = slice_state
    fc, ic = taumol_sw.pack_coeffs(c)
    if cells.startswith("n"):
        sel = torch.arange(int(cells[1:]), device=fc.device)
    else:
        tropo = fc[0] > 0
        sel = torch.nonzero(tropo if cells == "troposphere" else ~tropo)[:, 0]
    assert sel.numel() > 0
    fc, ic = fc[:, sel].contiguous(), ic[:, sel].contiguous()
    taug, taur = taumol_sw.taumol_sw_kernel(fc, ic, setup.gas.sw)
    torch.cuda.synchronize()
    g0, r0 = taumol_sw.taumol_sw_plain(fc, ic, setup.gas.sw)
    if bool((g0.abs() > 1e-6).any()):
        _tau_close(taug, g0)
    assert torch.equal(taur, r0)


def _rand(gen, *shape, lo=0.0, hi=1.0, device):
    return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                       device=device)


@pytest.mark.parametrize("nlev, ng, ncol", [(17, 12, 67), (137, 112, 300)])
def test_b3_sw_kernel_matches_plain(cuda, nlev, ng, ncol):
    gen = torch.Generator(device=cuda).manual_seed(3)
    r = lambda *s, lo=0.0, hi=1.0: _rand(gen, *s, lo=lo, hi=hi, device=cuda)
    args = (r(nlev, ng, ncol, hi=0.4), r(nlev, ng, ncol, lo=0.3, hi=0.6),
            r(nlev, ng, ncol, hi=0.3), r(nlev, ng, ncol, hi=0.4),
            r(nlev, ng, ncol, lo=0.2, hi=0.9), r(ng, ncol, hi=1300.0),
            r(ng, ncol, hi=0.8), r(ng, ncol, hi=0.8), r(ncol, lo=0.05))
    got = adding.adding_sw(*args)           # dispatches to the kernel
    torch.cuda.synchronize()
    ref = adding.adding_sw_plain(*args)
    for x, y in zip(got, ref):
        assert float((x - y).abs().max() / y.abs().max()) <= 2e-6


@pytest.mark.parametrize("nlev, ng, ncol", [(17, 12, 67), (137, 140, 300)])
def test_b3_lw_kernel_matches_plain(cuda, nlev, ng, ncol):
    gen = torch.Generator(device=cuda).manual_seed(4)
    r = lambda *s, lo=0.0, hi=1.0: _rand(gen, *s, lo=lo, hi=hi, device=cuda)
    args = (r(nlev, ng, ncol, lo=0.2, hi=0.99), r(nlev, ng, ncol, hi=50.0),
            r(nlev, ng, ncol, hi=50.0), r(ng, ncol, hi=400.0),
            r(ng, ncol, hi=0.2))
    got = adding.lw_no_scattering_fluxes(*args)
    torch.cuda.synchronize()
    ref = adding.lw_no_scattering_fluxes_plain(*args)
    for x, y in zip(got, ref):
        assert float((x - y).abs().max() / y.abs().max()) <= 2e-6


@pytest.mark.parametrize("nlev, ng, ncol", [(17, 12, 67), (137, 140, 300)])
def test_b3prime_lw_adding_kernel_matches_plain(cuda, nlev, ng, ncol):
    gen = torch.Generator(device=cuda).manual_seed(5)
    r = lambda *s, lo=0.0, hi=1.0: _rand(gen, *s, lo=lo, hi=hi, device=cuda)
    args = (r(nlev, ng, ncol, hi=0.3), r(nlev, ng, ncol, lo=0.2, hi=0.7),
            r(nlev, ng, ncol, hi=50.0), r(nlev, ng, ncol, hi=50.0),
            r(ng, ncol, hi=400.0), r(ng, ncol, hi=0.2))
    n0 = adding_fused.launches["lw_adding"]
    got = adding.adding_lw(*args)
    torch.cuda.synchronize()
    assert adding_fused.launches["lw_adding"] == n0 + 1
    ref = adding.adding_lw_plain(*args)
    for x, y in zip(got, ref):
        assert float((x - y).abs().max() / y.abs().max()) <= 2e-6


@pytest.mark.parametrize("nlev", [1, 2, 137, 200, 300])
@pytest.mark.parametrize("kind", ["sw", "lw"])
def test_b3_adding_ragged_levels_bit_identical(cuda, kind, nlev):
    """B3 sw_adding and B3' lw_adding on 15 g x 133 columns (no multiple
    of their 32-thread blocks) with 1, 2, 137, 200 and 300 levels: up to
    their windows (adding_fused.SW_ONCHIP_LEVELS, LW_ONCHIP_LEVELS, 256
    and 160) every level's values stay on chip, above them the top levels'
    go to the device-memory scratch (LW at 200, both at 300). Equal bit
    for bit to the plain versions."""
    assert 137 <= adding_fused.LW_ONCHIP_LEVELS < 200
    assert 200 <= adding_fused.SW_ONCHIP_LEVELS < 300
    gen = torch.Generator(device=cuda).manual_seed(nlev)
    r = lambda *s, lo=0.0, hi=1.0: _rand(gen, *s, lo=lo, hi=hi, device=cuda)
    ng, ncol = 15, 133
    if kind == "sw":
        args = (r(nlev, ng, ncol, hi=0.4), r(nlev, ng, ncol, lo=0.3, hi=0.6),
                r(nlev, ng, ncol, hi=0.3), r(nlev, ng, ncol, hi=0.4),
                r(nlev, ng, ncol, lo=0.2, hi=0.9), r(ng, ncol, hi=1300.0),
                r(ng, ncol, hi=0.8), r(ng, ncol, hi=0.8), r(ncol, lo=0.05))
        kern, plain = adding_fused.adding_sw_fused, adding.adding_sw_plain
    else:
        args = (r(nlev, ng, ncol, hi=0.3), r(nlev, ng, ncol, lo=0.2, hi=0.7),
                r(nlev, ng, ncol, hi=50.0), r(nlev, ng, ncol, hi=50.0),
                r(ng, ncol, hi=400.0), r(ng, ncol, hi=0.2))
        kern, plain = adding_fused.adding_lw_fused, adding.adding_lw_plain
    got = kern(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    assert len(got) == len(ref)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_b1_b3_resources(cuda):
    """B1 at 3 blocks (12 warps) per SM with at most 170 registers and at
    most 32 bytes of local memory (the compiler keeps a few per-thread
    values there, stored once and reloaded once per band, outside the slot
    loops); sw_adding and lw_adding at 5 blocks per SM at 137 levels,
    resident at 300, without spills (the compiler's report)."""
    from ecrad_tpu_torch.ops import _cuda
    b1 = _cuda.kernel_info("taumol_lw_info")
    assert b1["blocks_per_sm"] >= 3 and b1["registers"] <= 170
    assert b1["local_bytes"] <= 32
    for which in (0, 1):
        assert _cuda.kernel_info("level_sweep_info", which,
                                 137)["blocks_per_sm"] >= 5
        assert _cuda.kernel_info("level_sweep_info", which,
                                 300)["blocks_per_sm"] >= 1
    report = _cuda.ptxas_report()
    hits = [v for k, v in report.items() if "taumol_lw_kernelIf" in k]
    assert len(hits) == 1
    assert hits[0]["spill_stores"] <= 32 and hits[0]["spill_loads"] <= 64
    for kernel in ("sw_adding_kernelIfLb0E", "sw_adding_kernelIfLb1E",
                   "lw_adding_kernelIfLb0E", "lw_adding_kernelIfLb1E"):
        hits = [v for k, v in report.items() if kernel in k]
        assert len(hits) == 1, kernel
        assert hits[0]["spill_stores"] == 0, kernel
        assert hits[0]["spill_loads"] == 0, kernel


def _b4_args(cuda, ncol, nlev, ng, nb, seed):
    """Random layer optics in the ranges of tests/test_mcica_optics.py."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s, lo=0.0, hi=1.0: _rand(gen, *s, lo=lo, hi=hi, device=cuda)
    band_from_g = torch.as_tensor(
        np.sort(np.random.RandomState(seed).randint(0, nb, ng)),
        dtype=torch.int32, device=cuda)
    return dict(od=r(ncol, nlev, ng, hi=3.0), ssa=r(ncol, nlev, ng, lo=0.1,
                                                    hi=0.999),
                g=r(ncol, nlev, ng, hi=0.9), odc=r(ncol, nlev, nb, hi=8.0),
                ssac=r(ncol, nlev, nb, lo=0.3, hi=0.999),
                gc=r(ncol, nlev, nb, lo=0.5, hi=0.9),
                osc=r(ncol, nlev, ng, hi=3.0),
                mask=r(ncol, nlev) > 0.5, mu0=r(ncol, lo=-0.1),
                band=band_from_g, planck=r(ncol, nlev + 1, ng, lo=1.0,
                                           hi=30.0))


def _rel_all(got, ref):
    return max(float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
               for x, y in zip(got, ref))


@pytest.mark.parametrize("shape", [(37, 11, 112), (300, 137, 112)])
@pytest.mark.parametrize("delta_all", [False, True])
def test_b4_sw_kernel_matches_plain(cuda, shape, delta_all):
    a = _b4_args(cuda, *shape, 14, 6)
    args = (a["od"], a["ssa"], a["g"], a["odc"], a["ssac"], a["gc"],
            a["band"], a["osc"], a["mask"], a["mu0"], delta_all)
    n0 = mcica_optics.launches["mcica_sw_optics"]
    got = mcica_optics.sw_clear_total_reftrans(*args)
    torch.cuda.synchronize()
    assert mcica_optics.launches["mcica_sw_optics"] == n0 + 1
    assert _rel_all(got, mcica_optics.sw_clear_total_reftrans_plain(
        *args)) <= 2e-3


@pytest.mark.parametrize("shape", [(37, 11, 140), (300, 137, 140)])
def test_b4_lw_kernel_matches_plain(cuda, shape):
    a = _b4_args(cuda, *shape, 16, 7)
    args = (a["od"], a["odc"], a["band"], a["osc"], a["mask"], a["planck"])
    n0 = mcica_optics.launches["mcica_lw_optics"]
    got = mcica_optics.lw_clear_total_noscat(*args)
    torch.cuda.synchronize()
    assert mcica_optics.launches["mcica_lw_optics"] == n0 + 1
    assert _rel_all(got, mcica_optics.lw_clear_total_noscat_plain(
        *args)) <= 1e-4


def test_new_kernels_refuse_float64_and_strided_tensors(cuda):
    """B3' and B4's SW form take float64 (their double forms) and still
    refuse strided tensors, half tensors and operands of mixed dtypes;
    B4's LW form has no double form and refuses float64."""
    a = _b4_args(cuda, 5, 4, 12, 3, 8)
    x = torch.rand(3, 4, 10, device=cuda)
    e = torch.rand(4, 10, device=cuda)
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        adding_fused.adding_lw_fused(x, x, x, strided, e, e)
    with pytest.raises(ValueError, match="contiguous"):
        adding_fused.adding_lw_fused(*(t.double() for t in (x, x, x,
                                                            strided, e, e)))
    for half in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            adding_fused.adding_lw_fused(*(t.to(half) for t in (x, x, x, x,
                                                                e, e)))
    with pytest.raises(TypeError):
        adding_fused.adding_lw_fused(x.double(), x, x, x, e, e)
    up, dn = adding_fused.adding_lw_fused(*(t.double() for t in (x, x, x, x,
                                                                 e, e)))
    assert up.dtype == dn.dtype == torch.float64
    sw = lambda **kw: mcica_optics.mcica_sw_optics_fused(
        *(kw.get(k, a[k]) for k in ("od", "ssa", "g", "odc", "ssac", "gc")),
        a["band"], a["osc"], a["mask"], kw.get("mu0", a["mu0"]), False)
    lw = lambda **kw: mcica_optics.mcica_lw_optics_fused(
        kw.get("od", a["od"]), a["odc"], a["band"], a["osc"], a["mask"],
        kw.get("planck", a["planck"]))
    od_strided = a["od"].transpose(0, 1).contiguous().transpose(0, 1)
    for fn in (sw, lw):
        with pytest.raises(TypeError):
            fn(od=a["od"].half())
        with pytest.raises(TypeError):
            fn(od=a["od"].double())        # the other operands float32
        with pytest.raises(ValueError, match="contiguous"):
            fn(od=od_strided)
    with pytest.raises(TypeError):
        lw(planck=a["planck"].double())
    d = {k: a[k].double() for k in ("od", "ssa", "g", "odc", "ssac", "gc",
                                     "osc", "mu0")}
    out = mcica_optics.mcica_sw_optics_fused(
        d["od"], d["ssa"], d["g"], d["odc"], d["ssac"], d["gc"], a["band"],
        d["osc"], a["mask"], d["mu0"], False)
    assert all(t.dtype == torch.float64 for t in out)
    with pytest.raises(TypeError):
        mcica_optics.mcica_lw_optics_fused(d["od"], d["odc"], a["band"],
                                           d["osc"], a["mask"],
                                           a["planck"].double())


FIELDS = ("rand_top", "rand_cloud", "u1", "u2")


def _fields_match_plain(iseed, ng, nlev, dtype, offset=0):
    """One launch of the random-fields kernel; each of its four outputs
    contiguous and equal bit for bit to the plain path's on the CPU."""
    n0 = fields.launches
    got = fields.random_fields(iseed, ng, nlev, dtype, offset)
    torch.cuda.synchronize()
    assert fields.launches == n0 + 1
    want = fields.random_fields_plain(iseed.cpu(), ng, nlev, dtype, offset)
    for name, a, b in zip(FIELDS, got, want):
        assert a.is_cuda and a.is_contiguous() and a.dtype == dtype, name
        assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ng, shift", [(112, 0), (140, 997)])
def test_threefry_kernel_at_the_cells_shapes(cuda, dtype, ng, shift):
    """The SW (iseed) and LW (iseed + 997) generator calls of a 2048 x 137
    McICA call, on the cells' int32 seeds."""
    iseed = torch.arange(2048, dtype=torch.int32, device=cuda) + shift
    _fields_match_plain(iseed, ng, 137, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ncol, nlev, ng", [
    (5, 137, 1), (3, 1, 140), (2049, 1, 112), (1000, 2, 3), (7, 13, 19),
    (1, 1, 1)])
def test_threefry_kernel_ragged_shapes(cuda, dtype, ncol, nlev, ng):
    """One g-point, one level, a column count that is no multiple of a
    block's span, blocks that span many columns."""
    iseed = (torch.arange(ncol, dtype=torch.int64, device=cuda) * 7919
             - 50)
    _fields_match_plain(iseed, ng, nlev, dtype)


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("seed_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_threefry_kernel_edge_seeds(cuda, offset, seed_dtype, dtype):
    """Seeds at the edges of 32 bits and a negative one, taken mod 2**32
    as fold_in takes them."""
    info = torch.iinfo(seed_dtype)
    seeds = [s for s in (0, 2**31 - 1, 2**32 - 1, 2**32 + 5, -3)
             if info.min <= s <= info.max]
    iseed = torch.tensor(seeds, dtype=seed_dtype, device=cuda)
    _fields_match_plain(iseed, 13, 7, dtype, offset)


def test_threefry_kernel_makes_no_sync(cuda, monkeypatch):
    """The generator's random stage on the card: one launch, counted as
    `threefry.kernel` and, by dtype, `launch.threefry_fields.f32`, and no
    statement that blocks the host (no upload of the key)."""
    from ecrad_tpu_torch.solvers.cloud_generator import random_fields
    iseed = torch.arange(64, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    monkeypatch.setattr(hooks, "LHOOK", True)
    hooks.reset_profile()
    torch.cuda.set_sync_debug_mode("error")
    try:
        random_fields(iseed, 112, 137, torch.float32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = hooks.counters()
    hooks.reset_profile()
    torch.cuda.synchronize()
    assert counts == {"threefry.kernel": 1,
                      "launch.threefry_fields.f32": 1}, counts


def test_threefry_kernel_refuses_what_it_does_not_take(cuda):
    iseed = torch.arange(8, dtype=torch.int32, device=cuda)
    n0 = fields.launches
    for dtype in (torch.int32, torch.int64, torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            fields.random_fields(iseed, 4, 3, dtype)
    with pytest.raises(TypeError):
        fields.random_fields(iseed.float(), 4, 3, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fields.random_fields(torch.arange(16, device=cuda)[::2], 4, 3,
                             torch.float32)
    assert fields.launches == n0


def _on(dev, args):
    return [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]


@pytest.fixture(scope="module")
def gen_luts(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gen_luts"))
    write_synthetic_luts(d, 0)
    return d


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(gen_cases.CASES))
def test_generator_kernel_matches_plain(cuda, gen_luts, case, dtype):
    """The cloud generator kernel against its plain version on the same
    uniforms, on the card and on the CPU: the three overlap schemes and
    beta overlap, both sample forms, ng 1, 112 and 140, 24 and 137
    levels, on make_clouds' columns (7) and the edge columns (5; a
    ragged count)."""
    args_cpu = gen_cases.case_args(gen_luts, case, dtype)
    args = _on(cuda, args_cpu)
    n0 = mcica_generator.launches
    got = mcica_generator.generator_kernel(*args)
    torch.cuda.synchronize()
    assert mcica_generator.launches == n0 + 1
    assert all(t.is_cuda and t.is_contiguous() for t in got)
    got = tuple(t.cpu() for t in got)
    for plain_args in (args, args_cpu):
        want = tuple(t.cpu() for t in cloud_generator_plain(*plain_args))
        gen_cases.assert_generator_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_generator_kernel_at_the_cells_size(cuda, gen_luts, dtype):
    """Both generator calls of a McICA radiation call at 2048 x 137 (SW:
    iseed, 112 g-points; LW: iseed + 997, 140) on the path's cloud: the
    kernel against the plain path on the same uniforms. A cloudy mask
    may differ only in a column whose cover the card's plain path (its
    cumulative sums scanned in float) gives otherwise than the CPU's
    (summed in order in double, as the kernel sums), in at most 1 of
    10**6 cells; od_scaling elsewhere and the total cover within the
    contract's bounds."""
    from ecrad_tpu_torch.solvers import cloud_cover
    cfg = mcica_slice_config(**write_synthetic_luts(gen_luts, 0))
    setup = setup_radiation(cfg, device=cuda)
    sl, th, _, cloud = columns_to_inputs(
        make_clouds(make_columns(2048, 137, 0), 0), device=cuda)
    cloud, _ = _cloud_stage(setup, th, cloud, lambda x: x)
    frac, op, fsd = (x.to(dtype).contiguous() for x in (
        cloud.fraction, cloud.overlap_param, cloud.fractional_std))
    cover = {Overlap.EXPONENTIAL_EXPONENTIAL:
             cloud_cover.cum_cloud_cover_exp_exp,
             Overlap.EXPONENTIAL_RANDOM: cloud_cover.cum_cloud_cover_exp_ran,
             }[cfg.i_overlap_scheme]
    rel, tcc_abs = gen_cases.BOUNDS[dtype]
    for ng, shift in ((112, 0), (140, 997)):
        uniforms = fields.random_fields(sl.iseed + shift, ng, 137, dtype)
        args = (cfg.i_overlap_scheme, cfg.cloud_fraction_threshold, frac,
                op, cfg.cloud_inhom_decorr_scaling, fsd, setup.pdf_sampler,
                cfg.use_beta_overlap, setup.pdf_table, *uniforms)
        od, tcc = mcica_generator.generator_kernel(*args)
        od_ref, tcc_ref = cloud_generator_plain(*args)
        torch.cuda.synchronize()
        assert float((tcc - tcc_ref).abs().max()) <= tcc_abs
        differ = (od > 0) != (od_ref > 0)
        n = int(differ.sum())
        assert n <= 1e-6 * differ.numel(), n
        if n:
            cols = differ.flatten(1).any(1).cpu()
            card = cover(frac, op, cfg.use_beta_overlap)[0].cpu()
            host = cover(frac.cpu(), op.cpu(), cfg.use_beta_overlap)[0]
            assert bool((card != host)[cols].any(1).all()), n
        both = (od > 0) & (od_ref > 0)
        err = ((od - od_ref).abs() / od_ref.abs().clamp(min=1e-30))[both]
        assert float(err.max()) <= rel


def test_generator_kernel_makes_no_sync(cuda, gen_luts, monkeypatch):
    """A generator call on the card: the random fields and the generator,
    one launch each, counted by dtype, and no statement that blocks the
    host (the plain path's cover syncs before each merge pass)."""
    from ecrad_tpu_torch.solvers.cloud_generator import cloud_generator
    args = _on(cuda, gen_cases.case_args(gen_luts, "exp_exp_fast_lw_137",
                                         torch.float32))
    overlap, threshold, frac, op, decorr, fsd, sampler = args[:7]
    iseed = torch.arange(frac.shape[0], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    monkeypatch.setattr(hooks, "LHOOK", True)
    hooks.reset_profile()
    n0 = mcica_generator.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        cloud_generator(140, iseed, overlap, threshold, frac, op, decorr,
                        fsd, sampler, table=args[8])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = hooks.counters()
    hooks.reset_profile()
    torch.cuda.synchronize()
    assert mcica_generator.launches == n0 + 1
    assert counts == {"threefry.kernel": 1,
                      "launch.threefry_fields.f32": 1,
                      "launch.mcica_generator.f32": 1}, counts


def test_generator_kernel_refuses_what_it_does_not_take(cuda, gen_luts):
    args = _on(cuda, gen_cases.case_args(gen_luts, "exp_exp_fast_sw",
                                         torch.float32))
    n0 = mcica_generator.launches
    for dtype in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            mcica_generator.generator_kernel(
                *[a.to(dtype) if isinstance(a, torch.Tensor) else a
                  for a in args])
    strided = list(args)
    strided[10] = strided[10].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mcica_generator.generator_kernel(*strided)
    with pytest.raises(TypeError, match="cheb"):
        mcica_generator.generator_kernel(
            *args[:8], torch.as_tensor(args[6].cheb, device=cuda).double(),
            *args[9:])
    assert mcica_generator.launches == n0


def test_kernels_refuse_float64_and_strided_tensors(cuda, slice_state):
    """B1 and B3 take float64 (their double forms) and still refuse half
    tensors, strided tensors and a float64 field block over float32
    tables; B3 lw_noscat likewise."""
    setup, _, c = slice_state
    fc, ic = taumol_lw.pack_coeffs(c, setup.gas.chi_mls)
    for dtype in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            taumol_lw.taumol_lw_kernel(fc.to(dtype), ic, setup.gas.lw)
    with pytest.raises(TypeError):
        taumol_lw.taumol_lw_kernel(fc.double(), ic, setup.gas.lw)
    with pytest.raises(ValueError, match="contiguous"):
        taumol_lw.taumol_lw_kernel(fc.t().contiguous().t(), ic,
                                   setup.gas.lw)
    x = torch.rand(3, 4, 10, device=cuda)
    e = torch.rand(4, 10, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        adding_fused.lw_noscat_fused(x, x, x.transpose(1, 2).contiguous()
                                     .transpose(1, 2), e, e)
    with pytest.raises(ValueError, match="contiguous"):
        adding_fused.lw_noscat_fused(
            *(t.double() for t in (x, x, x.transpose(1, 2).contiguous()
                                   .transpose(1, 2), e, e)))
    with pytest.raises(TypeError):
        adding_fused.lw_noscat_fused(*(t.half() for t in (x, x, x, e, e)))
    up, dn = adding_fused.lw_noscat_fused(x.double(), x.double(), x.double(),
                                          e.double(), e.double())
    assert up.dtype == dn.dtype == torch.float64


def _reset_counts():
    taumol_lw.launches = taumol_sw.launches = fields.launches = 0
    mcica_generator.launches = 0
    for d in (adding_fused.launches, mcica_optics.launches,
              spartacus_reftrans.launches, spartacus_adding.launches,
              gather_interp.launches, gather_interp.copies,
              tc_optics.launches, aerosol_optics.launches):
        for k in d:
            d[k] = 0


def _to_cpu(inputs):
    return [x.replace(**{f: getattr(x, f).cpu() for f in
                         x.__dataclass_fields__
                         if isinstance(getattr(x, f), torch.Tensor)})
            for x in inputs]


def test_slice_launches_every_kernel(slice_state):
    setup, inputs, _ = slice_state
    _reset_counts()
    flux = radiation(setup, *inputs)
    torch.cuda.synchronize()
    assert taumol_lw.launches == 1 and taumol_sw.launches == 1
    assert adding_fused.launches == {"sw_adding": 1, "lw_noscat": 1,
                                     "lw_adding": 0, "tc_sw_sweeps": 0,
                                     "tc_lw_sweeps": 0}
    assert mcica_optics.launches == {"mcica_sw_optics": 0,
                                     "mcica_lw_optics": 0}
    assert aerosol_optics.launches == {"aerosol_optics": 0}
    for k, v in flux.fields():
        assert bool(torch.isfinite(v).all()), k
    # the same columns through the plain path on the CPU
    cpu = radiation(setup_radiation(cloudless_slice_config(), device="cpu"),
                    *_to_cpu(inputs))
    # the clear-sky float32 contract (tests/test_f64_validation.py):
    # 0.01 W/m2 for LW fields, 0.2 W/m2 for SW ones
    for k, v in flux.fields():
        bound = 0.01 if k.startswith("lw") else 0.2
        assert float((v.cpu() - getattr(cpu, k)).abs().max()) <= bound, k


def _masks(setup, inputs):
    """Cloudy-subcolumn masks of the SW and LW generators per column."""
    from ecrad_tpu_torch.solvers.cloud_generator import cloud_generator
    cfg = setup.config
    sl, th, _, cloud = inputs
    cloud, _ = _cloud_stage(setup, th, cloud, lambda x: x)
    return [(cloud_generator(
        ng, sl.iseed + offset, cfg.i_overlap_scheme,
        cfg.cloud_fraction_threshold, cloud.fraction, cloud.overlap_param,
        cfg.cloud_inhom_decorr_scaling, cloud.fractional_std,
        setup.pdf_sampler, table=setup.pdf_table)[0] > 0).cpu()
        for ng, offset in ((112, 0), (140, 997))]


@pytest.mark.parametrize("variant", ["mcica", "mcica_noscat"])
def test_mcica_path_launches_its_kernels(cuda, tmp_path, variant):
    """The McICA path on the card: bench.py's configuration (B3 SW, B3'
    and B4 SW), and without LW scattering on Exp-Ran (B3 LW and B4 LW);
    its fluxes against the plain path on the CPU on every column whose
    subcolumns came out the same (a float32 cover can straddle a
    random number on one device and not the other)."""
    kw = {} if variant == "mcica" else dict(
        do_lw_cloud_scattering=False, do_lw_aerosol_scattering=False,
        i_overlap_scheme=Overlap.EXPONENTIAL_RANDOM)
    cfg = mcica_slice_config(**write_synthetic_luts(str(tmp_path)), **kw)
    setup = setup_radiation(cfg, device=cuda)
    inputs = columns_to_inputs(make_clouds(make_columns(96, 137, 0)),
                               device=cuda)
    _reset_counts()
    flux = radiation(setup, *inputs)
    torch.cuda.synchronize()
    assert taumol_lw.launches == 1 and taumol_sw.launches == 1
    if variant == "mcica":
        assert adding_fused.launches == {"sw_adding": 2, "lw_noscat": 0,
                                         "lw_adding": 2, "tc_sw_sweeps": 0,
                                         "tc_lw_sweeps": 0}
        assert mcica_optics.launches == {"mcica_sw_optics": 1,
                                         "mcica_lw_optics": 0}
    else:
        assert adding_fused.launches == {"sw_adding": 2, "lw_noscat": 2,
                                         "lw_adding": 0, "tc_sw_sweeps": 0,
                                         "tc_lw_sweeps": 0}
        assert mcica_optics.launches == {"mcica_sw_optics": 1,
                                         "mcica_lw_optics": 1}
    # the random fields and the generator of the SW and the LW call; no
    # aerosols in these columns
    assert fields.launches == 2 and mcica_generator.launches == 2
    assert aerosol_optics.launches == {"aerosol_optics": 0}
    for k, v in flux.fields():
        assert bool(torch.isfinite(v).all()), k
    setup_cpu = setup_radiation(cfg, device="cpu")
    cpu_inputs = _to_cpu(inputs)
    cpu = radiation(setup_cpu, *cpu_inputs)
    same = torch.ones(96, dtype=torch.bool)
    for a, b in zip(_masks(setup, inputs), _masks(setup_cpu, cpu_inputs)):
        same &= (a == b).flatten(1).all(1)
    assert int((~same).sum()) <= 3
    # the clear-sky float32 contract for clear fields (0.01 LW, 0.2 SW)
    # and the deterministic solvers' total-sky one (0.02 LW, 0.3 SW)
    for k, v in flux.fields():
        ref = getattr(cpu, k)
        if k.startswith("cloud_cover"):
            bound = 1e-5
        elif k == "lw_derivatives":
            bound = 1e-5
        else:
            bound = {(True, True): 0.01, (True, False): 0.2,
                     (False, True): 0.02, (False, False): 0.3}[
                ("clear" in k, k.startswith("lw"))]
        assert float((v.cpu() - ref)[same].abs().max()) <= bound, k


def _b5_args(cuda, nreg, nlev, ng, ncol, seed, pattern="random"):
    """Random region optics (the ranges of tests/test_adding_fused.py),
    overlap matrices and clear layers (random, all clear, all cloudy or
    alternating in level and column), as the sweeps take them."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s, lo=0.0, hi=1.0: _rand(gen, *s, lo=lo, hi=hi, device=cuda)
    lay = (nlev, nreg, ng, ncol)
    clear = torch.rand(nlev, ncol, generator=gen, device=cuda) < 0.4
    lev = torch.arange(nlev, device=cuda)[:, None]
    col = torch.arange(ncol, device=cuda)[None, :]
    clear = {"random": clear, "all_clear": torch.ones_like(clear),
             "all_cloudy": torch.zeros_like(clear),
             "alternating": (lev + col) % 2 == 0}[pattern]
    v, u = r(nlev + 1, nreg, nreg, ncol), r(nlev, nreg, nreg, ncol)
    frac = r(nreg, ncol, lo=0.05, hi=0.6)
    sw = (r(*lay, hi=0.4), r(*lay, lo=0.3, hi=0.6), r(*lay, hi=0.3),
          r(*lay, hi=0.4), r(*lay, lo=0.2, hi=0.9), v, clear,
          r(ng, ncol, hi=0.8), r(ng, ncol, hi=0.8), r(ncol, lo=0.05),
          r(ng, ncol, hi=1300.0), frac)
    lw = (r(*lay, hi=0.3), r(*lay, lo=0.3, hi=0.6), r(*lay, hi=20.0),
          r(*lay, hi=20.0), v, u, clear, r(ng, ncol, hi=400.0),
          r(ng, ncol, hi=0.2), frac)
    return sw, lw


@pytest.mark.parametrize("nreg, nlev, ng, ncol", [
    (3, 17, 12, 67), (2, 17, 12, 67), (3, 137, 112, 300),
    (2, 137, 140, 300)])
def test_b5_kernels_match_plain(cuda, nreg, nlev, ng, ncol):
    sw, lw = _b5_args(cuda, nreg, nlev, ng, ncol, 9)
    for name, fn, plain, args in (
            ("tc_sw_sweeps", tripleclouds.tc_sw_sweeps,
             tripleclouds.tc_sw_sweeps_plain, sw),
            ("tc_lw_sweeps", tripleclouds.tc_lw_sweeps,
             tripleclouds.tc_lw_sweeps_plain, lw)):
        n0 = adding_fused.launches[name]
        got = fn(*args)                      # dispatches to the kernel
        torch.cuda.synchronize()
        assert adding_fused.launches[name] == n0 + 1
        assert _rel_all(got, plain(*args)) <= 2e-6, name


@pytest.mark.parametrize("ncol", [133, 132])
@pytest.mark.parametrize("pattern", ["all_clear", "all_cloudy",
                                     "alternating"])
@pytest.mark.parametrize("nlev", [1, 2, 7, 137, 300])
@pytest.mark.parametrize("nreg", [3, 2])
def test_b5_clear_patterns_bit_identical(cuda, nreg, nlev, pattern, ncol):
    """B5 skips the cloudy regions' loads and history in clear layers: on
    all-clear, all-cloudy and alternating layers, at 1, 2, 7, 137 and 300
    levels x 15 g-points x 133 columns (its 4-byte copies) and 132 columns
    (its 16-byte copies), neither a multiple of its 32-column x 4-g-point
    blocks, equal to the plain versions bit for bit."""
    sw, lw = _b5_args(cuda, nreg, nlev, 15, ncol, nlev, pattern)
    for fn, plain, args in (
            (adding_fused.tc_sw_sweeps_fused,
             tripleclouds.tc_sw_sweeps_plain, sw),
            (adding_fused.tc_lw_sweeps_fused,
             tripleclouds.tc_lw_sweeps_plain, lw)):
        got = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        assert len(got) == len(ref)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


def test_b2_b5_resources(cuda):
    """B2 at 4 blocks (16 warps) per SM with at most 32 bytes of local
    memory (at its 128-register cap the compiler keeps a few values
    there, as in B1); B5 with 3 regions resident at the 7 (SW) and 6 (LW)
    blocks of 4 warps per SM it is compiled for, at 137 and 300 levels,
    without spills; with 2 regions at most 32 bytes of local memory (the
    compiler's report)."""
    from ecrad_tpu_torch.ops import _cuda
    b2 = _cuda.kernel_info("taumol_sw_info")
    assert b2["blocks_per_sm"] >= 4 and b2["local_bytes"] <= 32
    for which, at137, at300 in ((0, 7, 7), (1, 6, 6)):
        k = _cuda.kernel_info("tc_sweeps_info", which, 3, 137)
        assert k["threads"] == 128 and k["blocks_per_sm"] >= at137
        assert k["local_bytes"] == 0
        assert _cuda.kernel_info("tc_sweeps_info", which, 3,
                                 300)["blocks_per_sm"] >= at300
        assert _cuda.kernel_info("tc_sweeps_info", which, 2,
                                 137)["local_bytes"] <= 32
    report = _cuda.ptxas_report()
    for kernel, spills in (("taumol_sw_kernelIf", 32),
                           ("tc_sw_kernelILi3ELb1E", 0),
                           ("tc_lw_kernelILi3ELb1E", 0),
                           ("tc_sw_kernelILi3ELb0E", 0),
                           ("tc_lw_kernelILi3ELb0E", 0)):
        hits = [v for k, v in report.items() if kernel in k]
        assert len(hits) == 1, kernel
        assert hits[0]["spill_stores"] <= spills, kernel


def test_b5_refuses_what_it_does_not_take(cuda):
    sw, lw = _b5_args(cuda, 3, 5, 4, 10, 10)
    strided = sw[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        adding_fused.tc_sw_sweeps_fused(strided, *sw[1:])
    with pytest.raises(TypeError):
        adding_fused.tc_lw_sweeps_fused(lw[0].double(), *lw[1:])
    with pytest.raises(TypeError):                  # clear must be bool
        adding_fused.tc_lw_sweeps_fused(*lw[:6], lw[6].float(), *lw[7:])
    sw4, _ = _b5_args(cuda, 4, 5, 4, 10, 10)
    with pytest.raises(ValueError, match="2 or 3 regions"):
        adding_fused.tc_sw_sweeps_fused(*sw4)


# ---- B11: Tripleclouds' SW layer optics ----

@pytest.mark.parametrize("ncol, nlev, ng", [(2048, 137, 112), (133, 7, 15)])
@pytest.mark.parametrize("delta_all", [False, True])
@pytest.mark.parametrize("nreg, gamma", [(3, True), (2, False)])
def test_b11_kernel_matches_plain(cuda, nreg, gamma, delta_all, ncol, nlev,
                                  ng):
    """B11 against its plain version on the card, on test_torch_tc_optics'
    case at the cells' 2048 x 137 x 112 and at 133 columns x 7 levels x
    15 g-points (neither a multiple of its 32 x 32 tiles): layers cloudy,
    clear and below the threshold, a night column and cells within the
    resonance window and its 1e-6 nudge, in the clear sky and a cloudy
    region. Every output of both families bit for bit: the same float
    operations in the same order (-fmad=false), CUDA's exp, sqrt and
    division on both sides, the window's cells in double on both."""
    args = tc_cases.case(nreg, gamma, delta_all, ncol=ncol, nlev=nlev,
                         ng=ng, nb=14, seed=ncol + nreg, device=cuda)
    n_window = tc_cases.near_cells(args, 0.03)
    n_nudge = tc_cases.near_cells(args, 1e-6)
    assert min(n_window) >= 1 and min(n_nudge) >= 1
    n0 = tc_optics.launches["tc_sw_optics"]
    got = tripleclouds._region_props_sw_g(*args)   # dispatches to B11
    torch.cuda.synchronize()
    assert tc_optics.launches["tc_sw_optics"] == n0 + 1
    ref = tc_optics.tc_sw_optics_plain(*args)
    for fam, (a_fam, b_fam) in zip(("region", "clear"), zip(got, ref)):
        assert len(a_fam) == len(b_fam) == 5
        for i, (a, b) in enumerate(zip(a_fam, b_fam)):
            assert a.shape == b.shape and a.is_contiguous(), (fam, i)
            assert torch.equal(a, b), (
                fam, i, int((a != b).sum()),
                float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()))


def test_b11_resources(cuda):
    """B11's launch: 256 threads, its 21 KB tile, at least 3 blocks (24
    warps) per SM, no spills (the compiler's report)."""
    from ecrad_tpu_torch.ops import _cuda
    k = _cuda.kernel_info("tc_sw_optics_info")
    assert k["threads"] == 256 and k["static_smem"] == 5 * 32 * 33 * 4
    assert k["blocks_per_sm"] >= 3, k
    hits = [v for name, v in _cuda.ptxas_report().items()
            if "tc_sw_optics_kernel" in name]
    assert len(hits) == 1
    assert hits[0]["spill_stores"] == 0 and hits[0]["spill_loads"] == 0


def test_b11_refuses_what_it_does_not_take(cuda):
    args = list(tc_cases.case(3, True, False, ncol=5, nlev=6, ng=7, nb=3,
                              device=cuda))
    strided = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    for at, bad, err in (
            (0, strided, ValueError),                  # strided
            (0, args[0].double(), TypeError),          # float64
            (6, args[6].long(), TypeError),            # an int64 map
            (8, args[8].float(), TypeError),           # a float mask
            (4, args[4][..., :2].contiguous(), ValueError),  # a band short
            (0, args[0].cpu(), ValueError)):           # a CPU operand
        call = list(args)
        call[at] = bad
        with pytest.raises(err):
            tc_optics.tc_sw_optics_fused(*call)
    with pytest.raises(TypeError):
        tripleclouds._region_props_sw_g(*(
            a.double() if isinstance(a, torch.Tensor) and a.is_floating_point()
            else a for a in args))


TC_VARIANTS = {
    # (config overrides, B3 sw_adding, lw_noscat, lw_adding, B5 per call)
    "tripleclouds": ({}, 1, 0, 1, 1),
    "tripleclouds_2reg": (dict(nregions=2, use_beta_overlap=True,
                               i_cloud_pdf_shape=PdfShape.LOGNORMAL,
                               do_lw_cloud_scattering=True,
                               do_lw_aerosol_scattering=False,
                               use_aerosols=False), 1, 1, 0, 1),
    "homogeneous": (dict(i_solver_sw=Solver.HOMOGENEOUS,
                         i_solver_lw=Solver.HOMOGENEOUS), 2, 1, 1, 0),
}


@pytest.mark.parametrize("variant", list(TC_VARIANTS))
def test_tripleclouds_and_homogeneous_paths_launch_their_kernels(
        cuda, tmp_path, variant):
    """The Tripleclouds path on the card (B1, B2, B3 SW, B3', B11 and both
    B5 kernels), its two-region variant (B5 at NREG=2, B3 LW) and
    Homogeneous with aerosols (B3 SW and LW, B3'); their fluxes against the
    plain path on the CPU within the float32 contracts (clear sky lw 0.01,
    sw 0.2; total sky lw 0.02, sw 0.3; cloud covers and derivatives
    1e-5). Neither solver draws random numbers, so every column counts."""
    kw, n_sw, n_noscat, n_lw, n_tc = TC_VARIANTS[variant]
    cfg = tripleclouds_slice_config(
        **write_synthetic_luts(str(tmp_path), ice="fu"), **kw)
    cols = make_aerosols(make_clouds(make_columns(96, 137, 0)))
    inputs = columns_to_inputs(cols, device=cuda)
    setup = setup_radiation(cfg, device=cuda)
    _reset_counts()
    flux = radiation(setup, *inputs)
    torch.cuda.synchronize()
    assert taumol_lw.launches == 1 and taumol_sw.launches == 1
    assert adding_fused.launches == {
        "sw_adding": n_sw, "lw_noscat": n_noscat, "lw_adding": n_lw,
        "tc_sw_sweeps": n_tc, "tc_lw_sweeps": n_tc}
    # Tripleclouds' SW layer optics, regions and clear sky: one B11 launch
    assert tc_optics.launches == {"tc_sw_optics": n_tc}
    # the aerosol optics, both spectra: one B12 launch where configured
    assert aerosol_optics.launches == {"aerosol_optics": int(
        cfg.use_aerosols)}
    cpu = radiation(setup_radiation(cfg, device="cpu"), *_to_cpu(inputs))
    for k, v in flux.fields():
        assert bool(torch.isfinite(v).all()), k
        if k.startswith("cloud_cover") or k == "lw_derivatives":
            bound = 1e-5
        else:
            bound = {(True, True): 0.01, (True, False): 0.2,
                     (False, True): 0.02, (False, False): 0.3}[
                ("clear" in k, k.startswith("lw"))]
        assert float((v.cpu() - getattr(cpu, k)).abs().max()) <= bound, k


# ---- B12: the aerosol optics ----

@pytest.fixture(scope="module")
def aer_luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("aer_luts")), 0)


def _b12_args(luts, case, dtype, device, **kw):
    """add_aerosol_optics' arguments on aerosol_cases' case, with the
    card's int32 band maps; kw overrides the case's inputs (ncol, nlev,
    ng_sw, ng_lw, seed)."""
    overrides, inputs_kw = aer_cases.split(case)
    inputs_kw = {**inputs_kw, **kw}
    x = aer_cases.inputs(**inputs_kw, rh_lower=aer_cases.rh_edges(luts))
    cfg = aer_cases.config(luts, **overrides)
    return list(aer_cases.port_args(cfg, x, dtype, device, int32=True)[1])


def _b12_equal(args):
    """B12 through add_aerosol_optics, one launch, against the plain
    version on the same arguments: every output bit for bit, fresh and
    contiguous where the kernel writes it."""
    n0 = aerosol_optics.launches["aerosol_optics"]
    got = aerosol_module.add_aerosol_optics(*args)
    torch.cuda.synchronize()
    assert aerosol_optics.launches["aerosol_optics"] == n0 + 1
    want = aerosol_module.add_aerosol_optics_plain(*args)
    for name, a, b in zip(aer_cases.FIELDS, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert a.is_contiguous(), name
        assert torch.equal(a, b), (
            name, int((a != b).sum()),
            float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()))
    return got


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", [c for c in aer_cases.CASES
                                  if c != "direct"])
def test_b12_kernel_matches_plain(cuda, aer_luts, case, dtype):
    """B12 against its plain version on the card on every aerosol_cases
    branch (LW scattering on and off, SW delta scaling of the aerosol
    alone or with the gases, 10 and 14 types for 12 configured, rows
    without aerosol, the saturation given, humidities on the bins' edges,
    one level) at 37 columns, no multiple of its 32-row blocks: bit for
    bit (-fmad=false; CUDA's exp and division on both sides)."""
    _b12_equal(_b12_args(aer_luts, case, dtype, cuda, ncol=37))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["lw_scattering", "saturation_given"])
def test_b12_at_the_cells_size(cuda, aer_luts, case, dtype):
    """2048 x 137, the cells' shape, with the saturation computed (as the
    cells run it) and given."""
    _b12_equal(_b12_args(aer_luts, case, dtype, cuda, ncol=2048, nlev=137))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("layout", ["odd_g", "unaligned", "band_clear"])
def test_b12_other_layouts(cuda, aer_luts, layout, dtype):
    """The kernel's branches the cells do not take: g counts that are no
    multiple of a 16-byte run (15 SW, 17 LW g-points, random band maps)
    and per-g operands 4 or 8 bytes past a 16-byte boundary (one value a
    thread), and an LW band whose table holds no aerosol (per g, some
    runs mixed), each bit for bit against the plain version."""
    if layout == "odd_g":
        args = _b12_args(aer_luts, "lw_scattering", dtype, cuda, ncol=37,
                         ng_sw=15, ng_lw=17)
        gen = torch.Generator().manual_seed(5)
        args[2] = torch.randint(0, 14, (15,), generator=gen,
                                dtype=torch.int32).to(cuda)
        args[3] = torch.randint(0, 16, (17,), generator=gen,
                                dtype=torch.int32).to(cuda)
    else:
        args = _b12_args(aer_luts, "lw_scattering", dtype, cuda, ncol=37)
    if layout == "unaligned":
        for i in range(7, 13):
            x = args[i]
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
            args[i] = buf[1:].view(x.shape).copy_(x)
            assert args[i].data_ptr() % 16 != 0
    if layout == "band_clear":
        tabs = dict(args[1])
        lw = tabs["lw"].clone()
        lw[..., 3::16] = 0.0                     # band 3's three columns
        tabs["lw"] = lw
        args[1] = tabs
    _b12_equal(args)


def test_b12_resources(cuda):
    """B12's launches at the cells' shapes: 256 threads, the rows' band
    values and the band maps in dynamic shared memory (about 12 KB in
    float, 24 KB in double), the blocks per SM its launch bounds ask for
    (6 in float, 4 in double), and no spills in its 16-byte forms (the
    compiler's report)."""
    from ecrad_tpu_torch.ops import _cuda
    for f64, size, blocks in ((0, 4, 6), (1, 8, 4)):
        k = _cuda.kernel_info("aerosol_optics_info", f64)
        assert k["threads"] == 256, k
        assert k["dynamic_smem"] == (size * 32 * (3 * 14 + 3 * 16 + 1)
                                     + 4 * (32 + 112 + 140)), k
        assert k["blocks_per_sm"] >= blocks, k
    hits = [v for name, v in _cuda.ptxas_report().items()
            if "aerosol_optics_kernel" in name
            and ("IfLi4E" in name or "IdLi2E" in name)]
    assert len(hits) == 2
    assert all(h["spill_stores"] == 0 and h["spill_loads"] == 0
               for h in hits), hits


def test_b12_refuses_what_it_does_not_take(cuda, aer_luts):
    """The wrapper refuses CPU operands, half precision, mixed dtypes,
    a wrong shape, a strided operand and an int64 band map, before any
    launch; optics given per band stay with the plain version (no
    launch)."""
    args = _b12_args(aer_luts, "lw_scattering", "float32", cuda, ncol=5,
                     nlev=6)
    th, gas = args[4], args[5]
    strided = args[10].transpose(0, 1).contiguous().transpose(0, 1)
    n0 = aerosol_optics.launches["aerosol_optics"]
    for at, bad, err in (
            (10, args[10].cpu(), ValueError),             # a CPU operand
            (10, args[10].half(), TypeError),             # half precision
            (11, args[11].double(), TypeError),           # mixed dtypes
            (7, args[7][:, :, :139].contiguous(), ValueError),   # shape
            (10, strided, ValueError),                    # strided
            (2, args[2].long(), TypeError),               # int64 map
            (4, th.replace(pressure_hl=th.pressure_hl[:, :-1]), ValueError),
            (5, gas.replace(mixing_ratio=gas.mixing_ratio.transpose(
                0, 1).contiguous().transpose(0, 1)), ValueError)):
        call = list(args)
        call[at] = bad
        with pytest.raises(err):
            aerosol_optics.aerosol_optics_fused(*call)
    assert aerosol_optics.launches["aerosol_optics"] == n0
    direct = _b12_args(aer_luts, "direct", "float32", cuda, ncol=5)
    aerosol_module.add_aerosol_optics(*direct)
    assert aerosol_optics.launches["aerosol_optics"] == n0


# ---- SPARTACUS: B6, B7, B8, B9 ----

def _spartacus_case(cuda, nreg, nlev=7, ng=16, ncol=133, seed=7,
                    share3d=None, dtype=np.float32):
    """Inputs as tools/check_kernel_equivalence.py:143-163 builds them:
    mu0 at the 1e-10 clamp in every 17th column, clear layers, and a level
    with no 3D cell, or else each cell 3D with probability share3d; and
    random per-column rows for the sweeps; in float32, or in float64 for
    the double forms."""
    rng = np.random.RandomState(seed)
    r = lambda *s, lo=0.0, hi=1.0: torch.as_tensor(
        (lo + (hi - lo) * rng.rand(*s)).astype(dtype), device=cuda)
    c = dict(od=r(nlev, nreg, ng, ncol, hi=6.0),
             ssa=r(nlev, nreg, ng, ncol, lo=0.05, hi=0.999),
             g=r(nlev, nreg, ng, ncol, hi=0.8),
             trd=r(nlev, nreg, nreg, ncol, hi=0.5),
             trf=r(nlev, nreg, nreg, ncol, hi=0.5))
    mu0 = (0.05 + 0.95 * rng.rand(ncol)).astype(dtype)
    mu0[::17] = 1e-10
    c["mu0"] = torch.as_tensor(mu0, device=cuda)
    u = rng.rand(nlev, ng, ncol)
    if share3d is None:
        use3d = u > 0.4
        use3d[0] = False
    else:
        use3d = u < share3d
    c["use3d"] = torch.as_tensor(use3d, device=cuda)
    c["clear"] = torch.as_tensor(rng.rand(nlev, ncol) > 0.7, device=cuda)
    c.update(se=r(nlev, ng, ncol, lo=0.5, hi=1.0), pt=r(nlev, ng, ncol,
                                                        hi=40.0),
             pb=r(nlev, ng, ncol, hi=40.0), fr=r(nlev, nreg, ncol))
    prev = torch.roll(c["clear"], 1, 0)
    nxt = torch.roll(c["clear"], -1, 0)
    um, vm = r(nlev + 1, nreg, nreg, ncol), r(nlev + 1, nreg, nreg, ncol)
    c["cols"] = spartacus_adding.pack_cols(
        um, vm, r(nlev, ncol), r(nlev, ncol, hi=500), r(nlev, ncol, hi=300),
        r(nlev, ncol, hi=300), r(nlev, 3, ncol, hi=1e-3),
        r(nlev, ncol, hi=1e-3), r(nlev, ncol), r(nlev, nreg, ncol),
        r(nlev, nreg, ncol), c["clear"], prev, nxt, r(ncol))
    c["lcols"] = spartacus_adding.lw_pack_cols(um, vm, c["clear"], prev, nxt)
    c["init"] = r(2 * nreg * nreg, ng, ncol, hi=0.3)
    c["d0"] = r(nreg, ng, ncol, hi=100.0)
    c["linit"] = torch.cat([r(nreg * nreg, ng, ncol, hi=0.2),
                            r(nreg, ng, ncol, hi=50.0)])
    return c


SW_RT = ("od", "ssa", "g", "trd", "trf", "mu0", "use3d", "clear")
LW_RT = ("od", "ssa", "g", "trd", "se", "pt", "pb", "fr", "use3d", "clear")


@pytest.mark.parametrize("nreg", [3, 2])
def test_b6_b7_kernels_match_plain(cuda, nreg):
    c = _spartacus_case(cuda, nreg)
    counts = torch.empty(c["use3d"].shape, dtype=torch.int8, device=cuda)
    n0 = dict(spartacus_reftrans.launches)
    got = spartacus_reftrans.sw_reftrans_levels(
        8.0, *(c[k] for k in SW_RT), counts=counts)
    torch.cuda.synchronize()
    ref = spartacus_reftrans.sw_reftrans_levels_plain(
        8.0, *(c[k] for k in SW_RT))
    assert _rel_all([got], [ref]) <= 2e-5
    assert bool(((counts < 0) == ~c["use3d"]).all())
    assert int(counts.max()) >= 4
    for scattering in (True, False):
        got = spartacus_reftrans.lw_reftrans_levels(
            8.0, scattering, *(c[k] for k in LW_RT))
        torch.cuda.synchronize()
        ref = spartacus_reftrans.lw_reftrans_levels_plain(
            8.0, scattering, *(c[k] for k in LW_RT))
        assert _rel_all([got], [ref]) <= 2e-5, scattering
    assert spartacus_reftrans.launches == {
        "spartacus_sw_reftrans": n0["spartacus_sw_reftrans"] + 1,
        "spartacus_lw_reftrans": n0["spartacus_lw_reftrans"] + 2}


@pytest.mark.parametrize("share3d, ng", [(0.0, 16), (1.0, 16), (0.14, 16),
                                         (0.14, 15)])
@pytest.mark.parametrize("nreg", [3, 2])
def test_b6_passes_match_plain(cuda, nreg, share3d, ng):
    """B6's 3D pass and its pass over every cell: no 3D cell (the 3D pass
    stages nothing), every cell 3D (past its staged share the 3D pass
    writes in place), the SPARTACUS path's share (about 0.14), and ng x
    ncol odd. Counts < 0 exactly where use3d is false; a second call
    equal bit for bit (the order of the staged cells is free); one count
    per wrapper call."""
    c = _spartacus_case(cuda, nreg, ng=ng, share3d=share3d)
    args = [c[k] for k in SW_RT]
    counts = torch.empty(c["use3d"].shape, dtype=torch.int8, device=cuda)
    n0 = spartacus_reftrans.launches["spartacus_sw_reftrans"]
    got = spartacus_reftrans.sw_reftrans_levels(8.0, *args, counts=counts)
    again = spartacus_reftrans.sw_reftrans_levels(8.0, *args)
    torch.cuda.synchronize()
    assert spartacus_reftrans.launches["spartacus_sw_reftrans"] == n0 + 2
    ref = spartacus_reftrans.sw_reftrans_levels_plain(8.0, *args)
    assert _rel_all([got], [ref]) <= 2e-5
    assert torch.equal(got, again)
    assert bool(((counts < 0) == ~c["use3d"]).all())


@pytest.mark.parametrize("nreg", [3, 2])
def test_b6_b8_resources(cuda, nreg):
    """B6's pass over every cell at most 80 registers (at least 24 warps
    per SM), its 3D pass resident, B8's stages within the SM's shared
    memory and two of its blocks per SM; no spills (the compiler's report)
    in either pass of B6, and in B8 at most the 8 bytes (one 64-bit value
    at 3 regions) that its 128-register bound for two blocks per SM
    costs."""
    from ecrad_tpu_torch.ops import _cuda
    lean = _cuda.kernel_info("spartacus_sw_reftrans_info", 0, nreg)
    full = _cuda.kernel_info("spartacus_sw_reftrans_info", 1, nreg)
    b8 = _cuda.kernel_info("spartacus_sw_adding_info", nreg)
    assert lean["registers"] <= 80
    assert lean["blocks_per_sm"] * lean["threads"] >= 24 * 32
    assert b8["blocks_per_sm"] >= 2
    assert full["blocks_per_sm"] >= 1
    assert b8["dynamic_smem"] <= 227 * 1024
    report = _cuda.ptxas_report()
    # the float forms (T = float, the template's last argument)
    for kernel, spill in (("sw_fallback_kernel", 0), ("sw_3d_kernel", 0),
                          ("sw_adding_kernel", 8)):
        hits = [v for k, v in report.items()
                if f"{kernel}ILi{nreg}EfE" in k]
        assert len(hits) == 1, kernel
        assert hits[0]["spill_stores"] <= spill, kernel
        assert hits[0]["spill_loads"] <= spill, kernel


@pytest.mark.parametrize("scattering", [True, False])
@pytest.mark.parametrize("share3d", [0.0, 1.0, 0.14])
@pytest.mark.parametrize("nreg", [3, 2])
def test_b7_passes_match_plain(cuda, nreg, share3d, scattering):
    """B7's 3D pass and its pass over every cell: no 3D cell, every cell
    3D (past the staged share the 3D pass writes in place), the SPARTACUS
    path's share; cloud scattering on and off. Equal to the plain version
    bit for bit (the kernel keeps its expressions, built with
    -fmad=false), counts < 0 exactly where use3d is false, one count per
    wrapper call."""
    c = _spartacus_case(cuda, nreg, share3d=share3d)
    args = [8.0, scattering] + [c[k] for k in LW_RT]
    counts = torch.empty(c["use3d"].shape, dtype=torch.int8, device=cuda)
    n0 = spartacus_reftrans.launches["spartacus_lw_reftrans"]
    got = spartacus_reftrans.lw_reftrans_levels(*args, counts=counts)
    again = spartacus_reftrans.lw_reftrans_levels(*args)
    torch.cuda.synchronize()
    assert spartacus_reftrans.launches["spartacus_lw_reftrans"] == n0 + 2
    ref = spartacus_reftrans.lw_reftrans_levels_plain(*args)
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert bool(((counts < 0) == ~c["use3d"]).all())


@pytest.mark.parametrize("nreg", [3, 2])
def test_b7_b9_resources(cuda, nreg):
    """B7's pass over every cell at most 80 registers (at least 24 warps
    per SM), its 3D pass resident; B9's stages within the SM's shared
    memory and four of its blocks per SM, multilayer effects on and off;
    no spills (the compiler's report) in any of them."""
    from ecrad_tpu_torch.ops import _cuda
    lean = _cuda.kernel_info("spartacus_lw_reftrans_info", 0, nreg)
    full = _cuda.kernel_info("spartacus_lw_reftrans_info", 1, nreg)
    assert lean["registers"] <= 80
    assert lean["blocks_per_sm"] * lean["threads"] >= 24 * 32
    assert full["blocks_per_sm"] >= 1
    for ml in (0, 1):
        b9 = _cuda.kernel_info("spartacus_lw_adding_info", ml, nreg)
        assert b9["dynamic_smem"] <= 227 * 1024
        assert b9["blocks_per_sm"] >= 4
    report = _cuda.ptxas_report()
    # the float forms (T = float, the template's last argument)
    for kernel in (f"lw_fallback_kernelILi{nreg}EfE",
                   f"lw_3d_kernelILi{nreg}EfE",
                   f"lw_adding_kernelILi{nreg}ELb0EfE",
                   f"lw_adding_kernelILi{nreg}ELb1EfE"):
        hits = [v for k, v in report.items() if kernel in k]
        assert len(hits) == 1, kernel
        assert hits[0]["spill_stores"] == 0, kernel
        assert hits[0]["spill_loads"] == 0, kernel


@pytest.mark.parametrize("nlev", [1, 2, 7])
@pytest.mark.parametrize("use_matrix, multilayer", [
    (True, False), (True, True), (False, False)])
@pytest.mark.parametrize("nreg", [3, 2])
def test_b9_ragged_shapes_match_plain(cuda, nreg, use_matrix, multilayer,
                                      nlev):
    """B9 with fewer levels than (or about) its stage ring, 15 g-points
    (no multiple of its g-tile) and 133 columns (no multiple of its
    column strip), and a full random albedo matrix at the surface, which
    the diagonal scratch without multilayer effects must not lose. Equal
    to the plain version bit for bit."""
    c = _spartacus_case(cuda, nreg, nlev=nlev, ng=15)
    hist = spartacus_reftrans.lw_reftrans_levels(8.0, True,
                                                 *(c[k] for k in LW_RT))
    cfg = spartacus_slice_config(do_3d_lw_multilayer_effects=multilayer)
    args = (hist, c["lcols"], c["linit"])
    got = spartacus_adding.lw_adding_sweeps(cfg, use_matrix, *args)
    torch.cuda.synchronize()
    ref = spartacus_adding.lw_adding_sweeps_plain(cfg, use_matrix, *args)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))


@pytest.mark.parametrize("nlev", [1, 2, 7])
@pytest.mark.parametrize("entrap", list(Entrapment), ids=lambda e: e.name)
@pytest.mark.parametrize("nreg", [3, 2])
def test_b8_ragged_shapes_match_plain(cuda, nreg, entrap, nlev):
    """B8 with fewer levels than (or about) its stage ring, 15 g-points
    (not a multiple of its g-tile) and 133 columns (not a multiple of its
    column strip)."""
    c = _spartacus_case(cuda, nreg, nlev=nlev, ng=15)
    hist = spartacus_reftrans.sw_reftrans_levels(8.0, *(c[k] for k in SW_RT))
    cfg = spartacus_slice_config(i_3d_sw_entrapment=entrap)
    args = (hist, c["cols"], c["init"], c["d0"])
    got = spartacus_adding.sw_adding_sweeps(cfg, *args)
    torch.cuda.synchronize()
    assert _rel_all(got, spartacus_adding.sw_adding_sweeps_plain(cfg, *args)
                    ) <= 2e-5


@pytest.mark.parametrize("do_3d", [True, False])
@pytest.mark.parametrize("entrap", list(Entrapment), ids=lambda e: e.name)
@pytest.mark.parametrize("nreg", [3, 2])
def test_b8_kernel_matches_plain(cuda, nreg, entrap, do_3d):
    c = _spartacus_case(cuda, nreg)
    hist = spartacus_reftrans.sw_reftrans_levels(8.0, *(c[k] for k in SW_RT))
    cfg = spartacus_slice_config(i_3d_sw_entrapment=entrap,
                                 do_3d_effects=do_3d)
    args = (hist, c["cols"], c["init"], c["d0"])
    n0 = spartacus_adding.launches["spartacus_sw_adding"]
    got = spartacus_adding.sw_adding_sweeps(cfg, *args)
    torch.cuda.synchronize()
    assert spartacus_adding.launches["spartacus_sw_adding"] == n0 + 1
    assert _rel_all(got, spartacus_adding.sw_adding_sweeps_plain(cfg, *args)
                    ) <= 2e-5


@pytest.mark.parametrize("use_matrix, multilayer", [
    (True, False), (True, True), (False, False)])
@pytest.mark.parametrize("nreg", [3, 2])
def test_b9_kernel_matches_plain(cuda, nreg, use_matrix, multilayer):
    c = _spartacus_case(cuda, nreg)
    hist = spartacus_reftrans.lw_reftrans_levels(8.0, False,
                                                 *(c[k] for k in LW_RT))
    cfg = spartacus_slice_config(do_3d_lw_multilayer_effects=multilayer)
    args = (hist, c["lcols"], c["linit"])
    n0 = spartacus_adding.launches["spartacus_lw_adding"]
    got = spartacus_adding.lw_adding_sweeps(cfg, use_matrix, *args)
    torch.cuda.synchronize()
    assert spartacus_adding.launches["spartacus_lw_adding"] == n0 + 1
    assert _rel_all(got, spartacus_adding.lw_adding_sweeps_plain(
        cfg, use_matrix, *args)) <= 2e-5


def test_spartacus_kernels_refuse_float64_and_strided_tensors(cuda):
    """B6-B9 take float32 or float64 since their double forms: each still
    refuses a strided operand, a half-precision one, operands of mixed
    dtypes (a float64 operand among float32 ones, and the other way) and,
    called directly, a CPU tensor."""
    c = _spartacus_case(cuda, 3, nlev=3, ng=4, ncol=10)
    sw = [c[k] for k in SW_RT]
    strided = sw[0].transpose(2, 3).contiguous().transpose(2, 3)
    fused = spartacus_reftrans.sw_reftrans_levels_fused
    with pytest.raises(ValueError, match="contiguous"):
        fused(8.0, strided, *sw[1:])
    with pytest.raises(TypeError):
        fused(8.0, sw[0].double(), *sw[1:])
    with pytest.raises(TypeError):
        fused(8.0, sw[0].half(), *sw[1:])
    with pytest.raises(TypeError):
        fused(8.0, *[x.double() if x.is_floating_point() else x
                     for x in sw[:5]], sw[5], *sw[6:])
    with pytest.raises(ValueError, match="CUDA"):
        fused(8.0, *[x.cpu() for x in sw])
    lw = [c[k] for k in LW_RT]
    with pytest.raises(TypeError):
        spartacus_reftrans.lw_reftrans_levels_fused(8.0, True, *lw[:4],
                                                    lw[4].double(), *lw[5:])
    with pytest.raises(TypeError):
        spartacus_reftrans.lw_reftrans_levels_fused(8.0, True,
                                                    lw[0].bfloat16(),
                                                    *lw[1:])
    hist = spartacus_reftrans.sw_reftrans_levels(8.0, *sw)
    cfg = spartacus_slice_config()
    with pytest.raises(TypeError):
        spartacus_adding.sw_adding_sweeps_fused(cfg, hist.double(), c["cols"],
                                                c["init"], c["d0"])
    with pytest.raises(TypeError):
        spartacus_adding.sw_adding_sweeps_fused(cfg, hist.half(), c["cols"],
                                                c["init"], c["d0"])
    with pytest.raises(ValueError, match="contiguous"):
        spartacus_adding.sw_adding_sweeps_fused(
            cfg, hist, c["cols"].transpose(1, 2).contiguous().transpose(1, 2),
            c["init"], c["d0"])
    with pytest.raises(ValueError, match="CUDA"):
        spartacus_adding.sw_adding_sweeps_fused(cfg, hist.cpu(), c["cols"],
                                                c["init"], c["d0"])
    lhist = spartacus_reftrans.lw_reftrans_levels(8.0, True, *lw)
    with pytest.raises(TypeError):
        spartacus_adding.lw_adding_sweeps_fused(cfg, True, lhist,
                                                c["lcols"].double(),
                                                c["linit"])
    with pytest.raises(TypeError):
        spartacus_adding.lw_adding_sweeps_fused(cfg, True, lhist.double(),
                                                c["lcols"], c["linit"])
    with pytest.raises(ValueError, match="contiguous"):
        spartacus_adding.lw_adding_sweeps_fused(
            cfg, True, lhist.transpose(2, 3).contiguous().transpose(2, 3),
            c["lcols"], c["linit"])


def _f64_within(got, want, label):
    """Each output of a double form within 1e-13 of the largest value of
    its plain version's (the summation-order allowance of B1's and B2's
    double forms)."""
    assert len(got) == len(want), label
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == torch.float64, label
        scale = float(y.abs().max())
        assert float((x - y).abs().max()) <= 1e-13 * scale, label


@pytest.mark.parametrize("share3d", [None, 0.0, 1.0, 0.14])
@pytest.mark.parametrize("nreg", [3, 2])
def test_b6_b7_double_forms_match_plain_float64(cuda, nreg, share3d):
    """B6's and B7's double forms (cloud scattering on and off) on float64
    operands: no 3D cell, every cell 3D (past the staged share the 3D
    passes write in place), the path's share and the mixed case; each
    within 1e-13 of its plain version's largest value, counts < 0 exactly
    where use3d is false, one `.f64` launch of each pass a call."""
    c = _spartacus_case(cuda, nreg, share3d=share3d, dtype=np.float64)
    counts = torch.empty(c["use3d"].shape, dtype=torch.int8, device=cuda)
    hooks.enable(True)
    hooks.reset_profile()
    try:
        got = spartacus_reftrans.sw_reftrans_levels(
            8.0, *(c[k] for k in SW_RT), counts=counts)
        lw = {s: spartacus_reftrans.lw_reftrans_levels(
            8.0, s, *(c[k] for k in LW_RT)) for s in (True, False)}
        torch.cuda.synchronize()
        launched = {k: v for k, v in hooks.counters().items()
                    if k.startswith("launch.")}
    finally:
        hooks.enable(False)
        hooks.reset_profile()
    assert launched == {f"launch.spartacus_{b}_reftrans_{p}.f64": n
                        for b, n in (("sw", 1), ("lw", 2))
                        for p in ("3d", "fallback")}
    _f64_within([got], [spartacus_reftrans.sw_reftrans_levels_plain(
        8.0, *(c[k] for k in SW_RT))], "B6")
    assert bool(((counts < 0) == ~c["use3d"]).all())
    for s, x in lw.items():
        _f64_within([x], [spartacus_reftrans.lw_reftrans_levels_plain(
            8.0, s, *(c[k] for k in LW_RT))], f"B7 scattering={s}")


@pytest.mark.parametrize("nlev, ng", [(7, 16), (1, 15), (2, 15)])
@pytest.mark.parametrize("do_3d", [True, False])
@pytest.mark.parametrize("entrap", list(Entrapment), ids=lambda e: e.name)
@pytest.mark.parametrize("nreg", [3, 2])
def test_b8_double_form_matches_plain_float64(cuda, nreg, entrap, do_3d,
                                              nlev, ng):
    """B8's double form under each entrapment treatment, 3D effects on and
    off, and with fewer levels than its ring, 15 g-points and 133 columns
    (no multiple of its tiles): each output within 1e-13 of its plain
    version's largest value."""
    c = _spartacus_case(cuda, nreg, nlev=nlev, ng=ng, dtype=np.float64)
    hist = spartacus_reftrans.sw_reftrans_levels(8.0, *(c[k] for k in SW_RT))
    cfg = spartacus_slice_config(i_3d_sw_entrapment=entrap,
                                 do_3d_effects=do_3d)
    args = (hist, c["cols"], c["init"], c["d0"])
    got = spartacus_adding.sw_adding_sweeps(cfg, *args)
    torch.cuda.synchronize()
    _f64_within(got, spartacus_adding.sw_adding_sweeps_plain(cfg, *args),
                f"B8 {entrap.name}")


@pytest.mark.parametrize("nlev, ng", [(7, 16), (1, 15), (2, 15)])
@pytest.mark.parametrize("use_matrix, multilayer", [
    (True, False), (True, True), (False, False)])
@pytest.mark.parametrize("nreg", [3, 2])
def test_b9_double_form_matches_plain_float64(cuda, nreg, use_matrix,
                                              multilayer, nlev, ng):
    """B9's double form, multilayer effects on and off, the matrix and the
    diagonal forms, a full albedo matrix at the surface, and ragged
    shapes: each output within 1e-13 of its plain version's largest
    value."""
    c = _spartacus_case(cuda, nreg, nlev=nlev, ng=ng, dtype=np.float64)
    hist = spartacus_reftrans.lw_reftrans_levels(8.0, True,
                                                 *(c[k] for k in LW_RT))
    cfg = spartacus_slice_config(do_3d_lw_multilayer_effects=multilayer)
    args = (hist, c["lcols"], c["linit"])
    got = spartacus_adding.lw_adding_sweeps(cfg, use_matrix, *args)
    torch.cuda.synchronize()
    _f64_within(got, spartacus_adding.lw_adding_sweeps_plain(
        cfg, use_matrix, *args), "B9")


@pytest.mark.parametrize("nreg", [3, 2])
def test_spartacus_double_forms_resources(cuda, nreg):
    """The double forms' launches (kernel_info): B6's and B7's passes over
    every cell at least LEAN_MIN_BLOCKS (6) blocks per SM, their 3D passes
    resident; B8's stages within 227 KB and F64_SW_MIN_BLOCKS blocks per
    SM, B9's F64_LW_MIN_BLOCKS, multilayer effects on and off (the bounds
    of csrc/spartacus_reftrans.cu and spartacus_adding.cu)."""
    from ecrad_tpu_torch.ops import _cuda
    info = _cuda.kernel_info
    for name in ("spartacus_sw_reftrans_info_f64",
                 "spartacus_lw_reftrans_info_f64"):
        assert info(name, 0, nreg)["blocks_per_sm"] >= 6, name
        assert info(name, 1, nreg)["blocks_per_sm"] >= 1, name
    b8 = info("spartacus_sw_adding_info_f64", nreg)
    assert b8["dynamic_smem"] <= 227 * 1024 and b8["blocks_per_sm"] >= 2
    for ml in (0, 1):
        b9 = info("spartacus_lw_adding_info_f64", ml, nreg)
        assert b9["dynamic_smem"] <= 227 * 1024
        assert b9["blocks_per_sm"] >= 3


# the float64 SPARTACUS call's launches: B1, B2, B3 sw_adding and B3'
# lw_adding for the clear sky, both passes of B6 and B7, B8 and B9, and
# B12 (the aerosol optics), once each and all in their double forms
SPARTACUS_F64_LAUNCHES = {
    f"launch.{k}.f64": 1 for k in (
        "taumol_lw", "taumol_sw", "sw_adding", "lw_adding",
        "spartacus_sw_reftrans_3d", "spartacus_sw_reftrans_fallback",
        "spartacus_lw_reftrans_3d", "spartacus_lw_reftrans_fallback",
        "spartacus_sw_adding", "spartacus_lw_adding", "aerosol_optics")}


def test_float64_spartacus_call_on_the_card(cuda, tmp_path, monkeypatch):
    """The whole float64 SPARTACUS call (the cell's configuration: 3
    regions, Explicit entrapment, aerosols, LW derivatives) on 96 x 137
    columns with effective cloud sizes: exactly the expected `.f64`
    launches and none in float, no layer plain on the card, every output
    float64 and within 1e-9 of each field's largest value of the plain
    path on the CPU."""
    cfg = spartacus_slice_config(
        **write_synthetic_luts(str(tmp_path), ice="fu"), dtype="float64")
    cols = add_effective_sizes(make_aerosols(make_clouds(make_columns(
        96, 137, 4), 4), 4))
    setup = setup_radiation(cfg, device=cuda)
    inputs = columns_to_inputs(cols, device=cuda)
    monkeypatch.setattr(hooks, "LHOOK", True)
    hooks.reset_profile()
    flux = radiation(setup, *inputs)
    torch.cuda.synchronize()
    counts = hooks.counters()
    hooks.reset_profile()
    monkeypatch.setattr(hooks, "LHOOK", False)
    assert {k: v for k, v in counts.items()
            if k.startswith("launch.")} == SPARTACUS_F64_LAUNCHES
    assert not [k for k in counts if k.startswith("plain_on_device.")]
    cpu = radiation(setup_radiation(cfg, device="cpu"),
                    *columns_to_inputs(cols, device="cpu"))
    for k, v in flux.fields():
        ref = getattr(cpu, k)
        assert v.dtype == ref.dtype == torch.float64, k
        scale = max(float(ref.abs().max()), 1.0)
        assert float((v.cpu() - ref).abs().max()) <= 1e-9 * scale, k


SPARTACUS_VARIANTS = {
    # (config overrides, B3 sw_adding, lw_noscat, lw_adding)
    "spartacus": ({}, 1, 0, 1),
    "spartacus_maxentr": (dict(i_3d_sw_entrapment=Entrapment.MAXIMUM), 1, 0,
                          1),
    "spartacus_2reg": (dict(nregions=2, i_cloud_pdf_shape=PdfShape.LOGNORMAL,
                            i_3d_sw_entrapment=Entrapment.ZERO,
                            do_lw_cloud_scattering=True,
                            do_lw_aerosol_scattering=False,
                            use_aerosols=False), 1, 1, 0),
}


@pytest.mark.parametrize("variant", list(SPARTACUS_VARIANTS))
def test_spartacus_path_launches_its_kernels(cuda, tmp_path, variant):
    """The SPARTACUS path on the card launches B1, B2, B3/B3' for its
    clear sky and B6-B9 once each; its fluxes against the plain path on
    the CPU within the float32 contracts (clear sky lw 0.01, sw 0.2; total
    sky lw 0.02, sw 0.3; cloud covers and derivatives 1e-5)."""
    kw, n_sw, n_noscat, n_lw = SPARTACUS_VARIANTS[variant]
    cfg = spartacus_slice_config(
        **write_synthetic_luts(str(tmp_path), ice="fu"), **kw)
    cols = add_effective_sizes(make_aerosols(make_clouds(make_columns(
        96, 137, 0))))
    inputs = columns_to_inputs(cols, device=cuda)
    setup = setup_radiation(cfg, device=cuda)
    _reset_counts()
    flux = radiation(setup, *inputs)
    torch.cuda.synchronize()
    assert taumol_lw.launches == 1 and taumol_sw.launches == 1
    assert adding_fused.launches == {
        "sw_adding": n_sw, "lw_noscat": n_noscat, "lw_adding": n_lw,
        "tc_sw_sweeps": 0, "tc_lw_sweeps": 0}
    assert spartacus_reftrans.launches == {"spartacus_sw_reftrans": 1,
                                           "spartacus_lw_reftrans": 1}
    assert spartacus_adding.launches == {"spartacus_sw_adding": 1,
                                         "spartacus_lw_adding": 1}
    assert aerosol_optics.launches == {"aerosol_optics": int(
        cfg.use_aerosols)}
    cpu = radiation(setup_radiation(cfg, device="cpu"), *_to_cpu(inputs))
    for k, v in flux.fields():
        assert bool(torch.isfinite(v).all()), k
        if k.startswith("cloud_cover") or k == "lw_derivatives":
            bound = 1e-5
        else:
            bound = {(True, True): 0.01, (True, False): 0.2,
                     (False, True): 0.02, (False, False): 0.3}[
                ("clear" in k, k.startswith("lw"))]
        assert float((v.cpu() - getattr(cpu, k)).abs().max()) <= bound, k


# ---- B10: the per-band path's table-row interpolation ----

B10_CASES = ["plain", "eta_lw_absa", "eta_lw_absb", "mixed", "out_of_range",
             "ev2_halves", "zero_section"]


def _b10_sections(cuda, name, n, seed=0, dtype=np.float32):
    """Random section lists built like tools/check_kernel_equivalence.py
    (plain, the two LW eta shapes, mixed), one with plain and flattened
    eta rows past both ends of their tables, the LW bands' tau and pfrac
    tables side by side with each zero on the other half (10 columns
    each), and an all-zero table between two others (one with a zero
    column inside its live range); the last two with weights of both
    signs and one weight a view 4 bytes into its storage."""
    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(x, device=cuda)           # noqa: E731

    def weight(signed):
        x = rng.rand(n) - (0.5 if signed else 0.0)
        return t(x.astype(dtype))

    def plain(r, k, g, lo=0, hi=None, signed=False):
        return gather_interp.Section(
            rng.rand(r, g).astype(dtype),
            [t(rng.randint(lo, r if hi is None else hi, n).astype(np.int32))
             for _ in range(k)],
            [weight(signed) for _ in range(k)])

    def eta(r1, r2, g, gos, eos, grid=(0, None), etas=(1, None),
            signed=False):
        return gather_interp.EtaSection(
            rng.rand(r1, r2, g).astype(dtype),
            [t(rng.randint(grid[0], grid[1] or r1 - 1, n).astype(np.int32))
             for _ in range(2)],
            [[(o, weight(signed)) for o in gos] for _ in range(2)],
            [t(rng.randint(etas[0], etas[1] or r2 - 2, n).astype(np.int32))
             for _ in range(2)],
            [[(o, weight(signed)) for o in eos] for _ in range(2)])

    def half(sec, tau):
        tab = sec.table.copy()
        h = tab.shape[-1] // 2
        tab[..., h:] = 0.0
        return sec._replace(table=tab if tau else np.roll(tab, h, -1))

    def ev2_halves():
        secs = [half(eta(65, 9, 20, (0, 1), (-1, 0, 1, 2), signed=True),
                     True),
                half(eta(235, 5, 20, (0, 1), (0, 1), signed=True), True),
                half(plain(10, 2, 20, signed=True), True),
                half(plain(9, 2, 20, signed=True), False),
                half(plain(5, 2, 20, signed=True), False)]
        w = t(np.zeros(n + 1, dtype))
        w[1:] = secs[2].weights[0]
        secs[2].weights[0] = w[1:]
        return secs

    def zero_section():
        first = plain(20, 3, 12, lo=-7, hi=26, signed=True)
        first.table[:, 5] = 0.0
        zero = plain(7, 2, 12, signed=True)
        return [first, zero._replace(table=np.zeros_like(zero.table)),
                eta(13, 9, 12, (0, 1), (0, 1), signed=True)]

    return {
        "plain": lambda: [plain(65, 4, 12)],
        "eta_lw_absa": lambda: [eta(65, 9, 12, (0, 1), (-1, 0, 1, 2))],
        "eta_lw_absb": lambda: [eta(235, 5, 12, (0, 1), (0, 1))],
        "mixed": lambda: [plain(10, 2, 12), eta(19, 9, 12, (0, 1), (0, 1)),
                          plain(300, 4, 12)],
        "out_of_range": lambda: [plain(20, 3, 12, lo=-7, hi=26),
                                 eta(13, 9, 12, (-1, 0, 1), (-3, 0, 1, 4),
                                     grid=(-2, 15), etas=(-4, 12))],
        "ev2_halves": ev2_halves,
        "zero_section": zero_section,
    }[name]()


@pytest.mark.parametrize("name", B10_CASES)
def test_b10_kernel_matches_plain(cuda, name):
    n = 2048 * 9 + 133            # not a multiple of the block
    secs = _b10_sections(cuda, name, n)
    n0 = gather_interp.launches["gather_sections"]
    got = gather_interp.eval_sections(secs, n)      # dispatches to B10
    torch.cuda.synchronize()
    assert gather_interp.launches["gather_sections"] == n0 + 1
    ref = gather_interp.eval_sections_plain(secs, n)
    g = 20 if name == "ev2_halves" else 12
    assert got.shape == ref.shape == (g, n)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 5e-6


@pytest.mark.parametrize("n", [1, 31, 33, 2048 * 9 + 133])
@pytest.mark.parametrize("name", B10_CASES)
def test_b10_equals_plain_by_value(cuda, name, n):
    """Each (cell, g) summed in the plain version's order from 0, the
    zero columns skipped: equal by value (-0 == +0) on ragged N, through
    the wrapper (its planned tile) and launched at other tiles on the
    same packed operands."""
    from ecrad_tpu_torch.ops import _cuda
    secs = _b10_sections(cuda, name, n, seed=n)
    ref = gather_interp.eval_sections_plain(secs, n)
    c0 = gather_interp.copies["gather_sections"]
    assert torch.equal(gather_interp.eval_sections_kernel(secs, n), ref)
    p = gather_interp.pack_sections(secs, n, cuda)
    for tile in (32, 100, 512):
        got = torch.empty((p.g, n), device=cuda)
        _cuda.launch("gather_sections", p.desc, p.desc.numel(), p.ptrs,
                     p.ptrs.numel(), p.tab, n, p.g, tile, got)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), tile
    assert gather_interp.copies["gather_sections"] == c0


def test_b10_copies_int64_and_strided_operands(cuda):
    n = 4099
    secs = _b10_sections(cuda, "mixed", n)
    rows64 = secs[0].rows[0].long()
    strided = torch.stack([secs[0].weights[1]] * 2, 1)[:, 1]
    secs[0] = secs[0]._replace(rows=[rows64, rows64],
                               weights=[secs[0].weights[0], strided])
    c0 = gather_interp.copies["gather_sections"]
    got = gather_interp.eval_sections_kernel(secs, n)
    torch.cuda.synchronize()
    assert gather_interp.copies["gather_sections"] == c0 + 2
    assert torch.equal(got, gather_interp.eval_sections_plain(secs, n))


def test_b10_resources(cuda):
    """The largest call of the path (LW band 3: 40 terms, 55 operands,
    G = 32) and the smallest: no local memory, the shared memory the
    wrapper counts, resident at the planned tile."""
    from ecrad_tpu_torch.ops import _cuda
    for nterms, nptr, g in ((40, 55, 32), (3, 6, 8)):
        tile = gather_interp._plan_on_card(2048 * 137, nterms, nptr, g)
        k = _cuda.kernel_info("gather_sections_info", tile, nterms, nptr, g)
        assert k["local_bytes"] == 0 and k["threads"] == gather_interp.BLOCK
        assert k["dynamic_smem"] == gather_interp.smem_bytes(tile, nterms,
                                                             nptr, g)
        assert k["blocks_per_sm"] >= 1 and tile % 32 == 0


def test_b10_refuses_float64_and_cpu_tensors(cuda):
    n0 = gather_interp.launches["gather_sections"]
    with pytest.raises(TypeError, match="float32"):
        gather_interp.eval_sections(
            _b10_sections(cuda, "mixed", 300, dtype=np.float64), 300)
    with pytest.raises(ValueError, match="CUDA"):
        gather_interp.eval_sections_kernel(
            _b10_sections("cpu", "mixed", 300), 300)
    assert gather_interp.launches["gather_sections"] == n0


def test_per_band_gas_optics_launch_b10_only(cuda, monkeypatch):
    """ECRAD_FUSED_TAUMOL=0 on 64 x 137 columns: 30 B10 launches (16 LW
    bands, 13 SW bands and band 24's Rayleigh term), no B1 or B2, and the
    optical depths of the all-band kernels within their bound."""
    from ecrad_tpu_torch.interface import get_albedos
    from ecrad_tpu_torch.optics.rrtmg.gas_optics import gas_optics
    setup = setup_radiation(cloudless_slice_config(), device=cuda)
    sl, th, gas = columns_to_inputs(make_columns(64, 137, 1), device=cuda)

    def run():
        return gas_optics(th.pressure_hl, th.temperature_hl,
                          gas.mixing_ratio, sl.skin_temperature, sl.cos_sza,
                          sl.solar_irradiance, setup.maps, setup.gas,
                          lw_albedo=get_albedos(setup, sl)[2])
    fused = run()
    monkeypatch.setenv("ECRAD_FUSED_TAUMOL", "0")
    _reset_counts()
    per_band = run()
    torch.cuda.synchronize()
    assert gather_interp.launches["gather_sections"] == 30
    assert gather_interp.copies["gather_sections"] == 0
    assert taumol_lw.launches == taumol_sw.launches == 0
    _tau_close(per_band.od_lw, fused.od_lw)
    _tau_close(per_band.od_sw, fused.od_sw)


# ---- one g-point (the monochromatic model) and the IFS entry point ----

@pytest.mark.parametrize("kernel", ["sw_adding", "lw_noscat", "lw_adding",
                                    "mcica_sw_optics", "mcica_lw_optics"])
def test_kernels_at_one_g_point_match_plain(cuda, kernel):
    """B3 (sw_adding, lw_noscat), B3' and B4 at ng = 1, the monochromatic
    model's, on 137 levels x 2048 columns: the sweeps bit for bit, B4
    within its bounds (SW 2e-3, LW 1e-4 of the range)."""
    nlev, ncol = 137, 2048
    gen = torch.Generator(device=cuda).manual_seed(11)
    r = lambda *s, lo=0.0, hi=1.0: _rand(gen, *s, lo=lo, hi=hi, device=cuda)
    if kernel == "sw_adding":
        args = (r(nlev, 1, ncol, hi=0.4), r(nlev, 1, ncol, lo=0.3, hi=0.6),
                r(nlev, 1, ncol, hi=0.3), r(nlev, 1, ncol, hi=0.4),
                r(nlev, 1, ncol, lo=0.2, hi=0.9), r(1, ncol, hi=1300.0),
                r(1, ncol, hi=0.8), r(1, ncol, hi=0.8), r(ncol, lo=0.05))
        kern, plain = adding_fused.adding_sw_fused, adding.adding_sw_plain
    elif kernel == "lw_noscat":
        args = (r(nlev, 1, ncol, lo=0.2, hi=0.99), r(nlev, 1, ncol, hi=50.0),
                r(nlev, 1, ncol, hi=50.0), r(1, ncol, hi=400.0),
                r(1, ncol, hi=0.2))
        kern = adding_fused.lw_noscat_fused
        plain = adding.lw_no_scattering_fluxes_plain
    elif kernel == "lw_adding":
        args = (r(nlev, 1, ncol, hi=0.3), r(nlev, 1, ncol, lo=0.2, hi=0.7),
                r(nlev, 1, ncol, hi=50.0), r(nlev, 1, ncol, hi=50.0),
                r(1, ncol, hi=400.0), r(1, ncol, hi=0.2))
        kern, plain = adding_fused.adding_lw_fused, adding.adding_lw_plain
    else:
        a = _b4_args(cuda, ncol, nlev, 1, 1, 12)
        if kernel == "mcica_sw_optics":
            args = (a["od"], a["ssa"], a["g"], a["odc"], a["ssac"], a["gc"],
                    a["band"], a["osc"], a["mask"], a["mu0"], False)
            kern = mcica_optics.mcica_sw_optics_fused
            plain = mcica_optics.sw_clear_total_reftrans_plain
        else:
            args = (a["od"], a["odc"], a["band"], a["osc"], a["mask"],
                    a["planck"])
            kern = mcica_optics.mcica_lw_optics_fused
            plain = mcica_optics.lw_clear_total_noscat_plain
    launches = (mcica_optics.launches if kernel.startswith("mcica")
                else adding_fused.launches)
    n0 = launches[kernel]
    got = kern(*args)
    torch.cuda.synchronize()
    assert launches[kernel] == n0 + 1
    ref = plain(*args)
    if kernel.startswith("mcica"):
        assert _rel_all(got, ref) <= (2e-3 if kernel == "mcica_sw_optics"
                                      else 1e-4)
    else:
        assert all(torch.equal(x, y) for x, y in zip(got, ref))


MONO = dict(i_gas_model=GasModel.MONOCHROMATIC, mono_lw_total_od=2.0,
            mono_sw_total_od=0.5, use_aerosols=False)


# the kernels each monochromatic path launches at one g-point
MONO_KERNELS = {
    "homogeneous": ("sw_adding", "lw_adding"),
    "mcica": ("sw_adding", "lw_adding", "mcica_sw_optics"),
    "mcica_noscat": ("sw_adding", "lw_noscat", "mcica_sw_optics",
                     "mcica_lw_optics"),
    "tripleclouds": ("sw_adding", "lw_adding", "tc_sw_sweeps",
                     "tc_lw_sweeps"),
    "spartacus": ("sw_adding", "lw_adding", "spartacus_sw_reftrans",
                  "spartacus_lw_reftrans", "spartacus_sw_adding",
                  "spartacus_lw_adding"),
}


@pytest.mark.parametrize("variant", list(MONO_KERNELS))
def test_monochromatic_paths_launch_their_kernels(cuda, tmp_path, variant):
    """The monochromatic model on 64 x 137 columns: no taumol, and the
    solvers' kernels at one g-point (B3, B3', B4, B5, B6-B9); the fluxes
    against the plain path on the CPU (the contracts of
    test_mcica_path_launches_its_kernels; one g-point leaves McICA no
    subcolumn to differ in but its cover)."""
    solver = Solver[variant.split("_")[0].upper()]
    kw = (dict(do_lw_cloud_scattering=False, do_lw_aerosol_scattering=False)
          if variant == "mcica_noscat" else {})
    cfg = mcica_slice_config(**write_synthetic_luts(str(tmp_path)), **MONO,
                             i_solver_sw=solver, i_solver_lw=solver, **kw)
    cols = add_effective_sizes(make_clouds(make_columns(64, 137, 0)))
    inputs = columns_to_inputs(cols, device=cuda)
    _reset_counts()
    flux = radiation(setup_radiation(cfg, device=cuda), *inputs)
    torch.cuda.synchronize()
    assert taumol_lw.launches == taumol_sw.launches == 0
    assert fields.launches == (2 if variant.startswith("mcica") else 0)
    counts = {**adding_fused.launches, **mcica_optics.launches,
              **spartacus_reftrans.launches, **spartacus_adding.launches}
    assert all(counts[k] >= 1 for k in MONO_KERNELS[variant]), counts
    cpu = radiation(setup_radiation(cfg, device="cpu"), *_to_cpu(inputs))
    for k, v in flux.fields():
        assert v.shape[-1] != 0 and bool(torch.isfinite(v).all()), k
        bound = 1e-5 if k.startswith(("cloud_cover", "lw_deriv")) else {
            (True, True): 0.01, (True, False): 0.2, (False, True): 0.02,
            (False, False): 0.3}[("clear" in k, k.startswith("lw"))]
        assert float((v.cpu() - getattr(cpu, k)).abs().max()) <= bound, k


def test_radiation_scheme_on_the_card(cuda, tmp_path, monkeypatch):
    """coupling.radiation_scheme on 64 x 137 columns with McICA, the band
    profiles, canopy fluxes and a solar scaling: B1, B2, B3, B3' and B4
    launch, and the fluxes and host outputs meet the plain path's on the
    CPU on every column whose subcolumns came out the same (the bounds of
    test_mcica_path_launches_its_kernels)."""
    from ecrad_tpu_torch import coupling
    from ecrad_tpu_torch.constants import GAS_INDEX
    cfg = mcica_slice_config(
        **write_synthetic_luts(str(tmp_path)), do_save_spectral_flux=True,
        do_canopy_fluxes_sw=True, do_canopy_fluxes_lw=True,
        use_spectral_solar_scaling=True)
    c = make_clouds(make_columns(64, 137, 0))
    host = dict(
        pressure_hl=c["pressure_hl"], temperature_hl=c["temperature_hl"],
        cos_sza=c["cos_sza"], skin_temperature=c["skin_temperature"],
        sw_albedo=c["sw_albedo"], lw_emissivity=c["lw_emissivity"],
        q=c["mixing_ratio"][:, :, GAS_INDEX["h2o"]],
        o3_mmr=c["mixing_ratio"][:, :, GAS_INDEX["o3"]], q_liq=c["q_liq"],
        q_ice=c["q_ice"], cloud_frac=c["fraction"],
        sin_latitude=np.linspace(-0.9, 0.9, 64),
        land_frac=np.tile([0.0, 1.0], 32),
        spectral_solar_scaling=np.linspace(0.9, 1.1, 14))
    seen = []
    run = coupling.radiation
    monkeypatch.setattr(coupling, "radiation",
                        lambda s, *a: seen.append((s, a)) or run(s, *a))
    results = []
    for device in (cuda, "cpu"):
        setup = setup_radiation(cfg, device=device)
        _reset_counts()
        flux = coupling.radiation_scheme(setup, **host)
        if device == cuda:
            torch.cuda.synchronize()
            assert taumol_lw.launches == taumol_sw.launches == 1
            assert adding_fused.launches["sw_adding"] == 2
            assert adding_fused.launches["lw_adding"] == 2
            assert mcica_optics.launches["mcica_sw_optics"] == 1
            assert fields.launches == 2
        out = coupling.unpack_host_outputs(
            setup, flux, cos_sza=host["cos_sza"],
            skin_temperature=host["skin_temperature"],
            lw_emissivity=host["lw_emissivity"])
        results.append({**{k: v.cpu() for k, v in flux.fields()},
                        **{f"host_{k}": getattr(out, k).cpu()
                           for k in out._fields
                           if getattr(out, k) is not None}})
    same = torch.ones(64, dtype=torch.bool)
    for a, b in zip(*(_masks(s, a[:4]) for s, a in seen)):
        same &= (a == b).flatten(1).all(1)
    assert int((~same).sum()) <= 3
    gpu, cpu = results
    for k, v in gpu.items():
        assert bool(torch.isfinite(v).all()), k
        if k.startswith(("cloud_cover", "lw_derivative", "host_emis",
                         "host_lw_derivative")):
            bound = 1e-5
        else:
            bound = {(True, True): 0.01, (True, False): 0.2,
                     (False, True): 0.02, (False, False): 0.3}[
                ("clear" in k, "lw" in k)]
        assert float((v - cpu[k])[same].abs().max()) <= bound, k


@pytest.mark.parametrize("dtype, rel", [("float64", 1e-6),
                                        ("float32", 1e-5)])
@pytest.mark.parametrize("rep", [(1,), (1, 2), (1, 2, 3), (3,)])
def test_surface_scheme_on_the_card(cuda, rep, dtype, rel):
    """calc_boundary_conditions and partition_fluxes (plain PyTorch, no
    kernel) on the card against the same call on the CPU: full-spectrum
    SW and LW canopies with the lowest level's LW extinction, cos_sza
    0 to 1; every field within `rel` of its largest magnitude. float64
    within 1e-6; float32 within 1e-5, the port's float32 cross-program
    bound: the two devices' float32 exp and sums differ by up to 1.6e-6
    of a field's largest value where terms cancel (trans_dir_diff, the
    canopies' LW absorption)."""
    import dataclasses
    import types

    from ecrad_tpu_torch.convert import surface_from_numpy
    from ecrad_tpu_torch.inputs import make_surface
    from ecrad_tpu_torch.surface import (calc_boundary_conditions,
                                         partition_fluxes)
    ncol = 64
    rng = np.random.RandomState(3)
    cos_sza = np.linspace(0.0, 1.0, ncol)
    day = cos_sza[:, None]
    extra = {"ext_lw_air": rng.uniform(1e-5, 5e-3, (ncol, 140))}
    flux = {"lw_dn_surf_canopy": rng.uniform(0, 6, (ncol, 140)),
            "sw_dn_diffuse_surf_canopy": rng.uniform(0, 4, (ncol, 112)),
            "sw_dn_direct_surf_canopy": day * rng.uniform(0, 12,
                                                          (ncol, 112))}
    for k in ("lw_dn", "lw_up", "sw_dn", "sw_up", "sw_dn_direct"):
        flux[k] = rng.uniform(0, 500, (ncol, 3)) * (
            day if k.startswith("sw") else 1.0)
    cfg = cloudless_slice_config(
        do_canopy_fluxes_sw=True, do_canopy_fluxes_lw=True,
        use_canopy_full_spectrum_sw=True, use_canopy_full_spectrum_lw=True)
    results = []
    dt = getattr(torch, dtype)
    for device in (cuda, "cpu"):
        setup = setup_radiation(dataclasses.replace(cfg, dtype=dtype),
                                device=device)
        t = lambda x: torch.as_tensor(x, dtype=dt,  # noqa: E731
                                      device=device)
        surf = surface_from_numpy(make_surface(ncol, rep, 0), device=device,
                                  dtype=dt)
        bc = calc_boundary_conditions(setup, surf, t(cos_sza),
                                      ext_lw_air=t(extra["ext_lw_air"]))
        sflux = partition_fluxes(surf, bc.intermediate, types.SimpleNamespace(
            **{k: t(v) for k, v in flux.items()}))
        out = {k: getattr(bc, k) for k in ("sw_albedo_diffuse",
                                           "sw_albedo_direct",
                                           "lw_emissivity", "lw_emission")}
        out.update({f"inter_{k}": v for k, v in vars(bc.intermediate).items()
                    if v is not None})
        out.update({f"flux_{k}": v for k, v in sflux.fields()})
        assert all(v.device.type == torch.device(device).type
                   for v in out.values())
        results.append({k: v.double().cpu() for k, v in out.items()})
    gpu, cpu = results
    assert set(gpu) == set(cpu)
    bad = {}
    for k, v in gpu.items():
        assert bool(torch.isfinite(v).all()), k
        scale = float(cpu[k].abs().max().clamp(min=1e-30))
        err = (v - cpu[k]).abs()
        if float(err.max()) > rel * scale:
            at = np.unravel_index(int(err.argmax()), tuple(err.shape))
            bad[k] = (float(err.max()) / scale, at, float(cpu[k][at]),
                      float(v[at]))
    assert not bad, bad


def test_native_host_cores_build_on_the_card_machine(cuda, tmp_path):
    """The profiler and record-reader cores build with the machine's g++
    from ecrad_tpu_torch/csrc/host; a record reads back through the native
    reader bit for bit."""
    from ecrad_tpu_torch.utils import native
    assert native.hook_lib() is not None and native.fort_lib() is not None
    rec = np.random.RandomState(3).standard_normal(4800)
    frame = np.array([rec.nbytes], ">i4").tobytes()
    path = tmp_path / "records.bin"
    path.write_bytes(frame + rec.astype(">f8").tobytes() + frame)
    with native.FortranFile(str(path)) as f:
        assert f._lib is not None
        np.testing.assert_array_equal(f.read_f64(), rec)
        with pytest.raises(EOFError):
            f.read_f64()


def test_traced_call_holds_its_kernels_in_its_span(cuda, tmp_path,
                                                   slice_state,
                                                   monkeypatch):
    """One Cloudless call between hooks.start_trace and stop_trace, inside
    a hook span with the host accounting on: the accounting holds the
    span and the program's own (`ecrad.radiation`, `ecrad.gas_optics`),
    and the trace the B1 and B2 launches, each launched inside the host
    range of both the outer span and `ecrad.gas_optics`."""
    import glob
    import json

    from ecrad_tpu_torch.utils import hooks
    monkeypatch.setattr(hooks, "LHOOK", True)
    setup, inputs, _ = slice_state
    radiation(setup, *inputs)
    hooks.reset_profile()
    hooks.start_trace(str(tmp_path))
    with hooks.hook("traced_radiation"):
        radiation(setup, *inputs)
    hooks.stop_trace()
    rows = dict(r[:2] for r in hooks.profile_rows())
    assert rows["traced_radiation"] == rows["ecrad.radiation"] == 1
    assert rows["ecrad.gas_optics"] == 1
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (span,), (gas,) = ([(e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("name") == name
                        and e.get("cat") == "user_annotation"]
                       for name in ("traced_radiation", "ecrad.gas_optics"))
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    for name in ("taumol_lw_kernel", "taumol_sw_kernel"):
        ks = [e for e in events if e.get("cat") == "kernel"
              and name in e["name"]]
        assert len(ks) == 1, name
        t = launch[ks[0]["args"]["correlation"]]
        assert span[0] <= t <= span[1] and gas[0] <= t <= gas[1], name


# ---- the float64 path: the double forms of B1-B4 ----

# the cells' CY47R1 McICA in float64: LW aerosol scattering on and cloud
# scattering off, so the clear sky takes B3' and the total sky B3 lw_noscat
MCICA_F64 = dict(dtype="float64", do_lw_cloud_scattering=False,
                 use_aerosols=True,
                 n_aerosol_types=len(TRIPLECLOUDS_AEROSOL_MAP),
                 i_aerosol_type_map=TRIPLECLOUDS_AEROSOL_MAP,
                 do_lw_derivatives=True)
# label: (module, wrapper, plain version, bit for bit, launches a call)
F64_KERNELS = {
    "B1 taumol_lw": (taumol_lw, "taumol_lw_kernel",
                     taumol_lw.taumol_lw_plain, False, 1),
    "B2 taumol_sw": (taumol_sw, "taumol_sw_kernel",
                     taumol_sw.taumol_sw_plain, False, 1),
    "B3 sw_adding": (adding_fused, "adding_sw_fused",
                     adding.adding_sw_plain, True, 2),
    "B3 lw_noscat": (adding_fused, "lw_noscat_fused",
                     adding.lw_no_scattering_fluxes_plain, True, 1),
    "B3' lw_adding": (adding_fused, "adding_lw_fused",
                      adding.adding_lw_plain, True, 1),
    "B4 mcica_sw_optics": (mcica_optics, "mcica_sw_optics_fused",
                           mcica_optics.sw_clear_total_reftrans_plain,
                           True, 1),
}


@pytest.fixture(scope="module")
def f64_path(cuda, tmp_path_factory):
    """The operands each double form is handed in one float64 McICA call
    on 2048 x 137 columns, by kernel."""
    tmp = str(tmp_path_factory.mktemp("f64_luts"))
    setup = setup_radiation(
        mcica_slice_config(**write_synthetic_luts(tmp), **MCICA_F64),
        device=cuda)
    inputs = columns_to_inputs(
        make_aerosols(make_clouds(make_columns(2048, 137, 1), 1), 1),
        device=cuda)
    calls = {}
    patch = pytest.MonkeyPatch()
    for label, (module, name, _, _, _) in F64_KERNELS.items():
        def record(*args, _real=getattr(module, name), _label=label):
            calls.setdefault(_label, []).append(args)
            return _real(*args)
        patch.setattr(module, name, record)
    try:
        radiation(setup, *inputs)
        torch.cuda.synchronize()
    finally:
        patch.undo()
    return calls


@pytest.mark.parametrize("label", list(F64_KERNELS))
def test_double_forms_match_plain_on_the_path(f64_path, label):
    module, name, plain, exact, n = F64_KERNELS[label]
    assert len(f64_path[label]) == n
    for args in f64_path[label]:
        got = getattr(module, name)(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype == torch.float64
            if exact:
                assert torch.equal(x, y), label
            else:
                assert float((x - y).abs().max()) <= \
                    1e-13 * float(y.abs().max()), label


@pytest.mark.parametrize("nlev", [1, 2, 96, 97, 137, 300])
@pytest.mark.parametrize("kind", ["sw", "lw"])
def test_b3_double_forms_ragged_levels_bit_identical(cuda, kind, nlev):
    """The double forms of B3 sw_adding and B3' lw_adding on 15 g x 133
    columns with 1 to 300 levels: up to their windows
    (adding_fused.F64_ONCHIP_LEVELS, 256 and 96) every level's values on
    chip, above them the top levels' in the device-memory scratch (LW from
    97 levels, SW at 300). Equal bit for bit to the plain versions in
    float64."""
    assert adding_fused.F64_ONCHIP_LEVELS == (256, 96)
    gen = torch.Generator(device=cuda).manual_seed(nlev + 1000)
    r = lambda *s, lo=0.0, hi=1.0: _rand(gen, *s, lo=lo, hi=hi,
                                         device=cuda).double()
    ng, ncol = 15, 133
    if kind == "sw":
        args = (r(nlev, ng, ncol, hi=0.4), r(nlev, ng, ncol, lo=0.3, hi=0.6),
                r(nlev, ng, ncol, hi=0.3), r(nlev, ng, ncol, hi=0.4),
                r(nlev, ng, ncol, lo=0.2, hi=0.9), r(ng, ncol, hi=1300.0),
                r(ng, ncol, hi=0.8), r(ng, ncol, hi=0.8), r(ncol, lo=0.05))
        kern, plain = adding_fused.adding_sw_fused, adding.adding_sw_plain
    else:
        args = (r(nlev, ng, ncol, hi=0.3), r(nlev, ng, ncol, lo=0.2, hi=0.7),
                r(nlev, ng, ncol, hi=50.0), r(nlev, ng, ncol, hi=50.0),
                r(ng, ncol, hi=400.0), r(ng, ncol, hi=0.2))
        kern, plain = adding_fused.adding_lw_fused, adding.adding_lw_plain
    got = kern(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    assert len(got) == len(ref)
    for x, y in zip(got, ref):
        assert x.dtype == torch.float64 and torch.equal(x, y)


def test_double_forms_resources(cuda):
    """The double forms' launches (kernel_info): B1 one block (4 warps)
    per SM, B2 two (8 warps), B3 sw_adding 2 and B3' lw_adding 3 blocks
    per SM at 137 levels, B3 lw_noscat 8 (64 warps), B4's SW form 2 (16
    warps); B1, B2 and the sweeps without spills (the compiler's
    report)."""
    from ecrad_tpu_torch.ops import _cuda
    blocks = lambda *a: _cuda.kernel_info(*a)["blocks_per_sm"]
    assert blocks("taumol_lw_info_f64") >= 1
    assert blocks("taumol_sw_info_f64") >= 2
    assert blocks("level_sweep_info_f64", 0, 137) >= 2
    assert blocks("level_sweep_info_f64", 1, 137) >= 3
    assert blocks("level_sweep_info_f64", 2, 137) >= 8
    assert blocks("mcica_optics_info", 2) >= 2
    assert blocks("mcica_optics_info", 0) >= 4
    report = _cuda.ptxas_report()
    for frag in ("taumol_lw_kernelId", "taumol_sw_kernelId",
                 "sw_adding_kernelIdLb0E", "lw_adding_kernelIdLb1E",
                 "lw_noscat_kernelId"):
        hits = [v for k, v in report.items() if frag in k]
        assert len(hits) == 1, frag
        assert hits[0]["spill_stores"] == 0, frag
        assert hits[0]["spill_loads"] == 0, frag


def test_float64_mcica_call_on_the_card(cuda, tmp_path, monkeypatch):
    """The whole float64 McICA call (the cells' configuration) on 96 x 137
    columns: B1, B2, B3 (SW twice, LW once), B3', B4's SW form, the
    generator's random fields and the generator (twice each) and B12 (the
    aerosol optics) each launched in its double form and
    nothing in float (the hooks' launch.<kernel>.<dtype> counters), no
    layer plain on the card, every
    output float64 and within 1e-9 of each field's largest value of the
    plain path on the CPU."""
    cfg = mcica_slice_config(**write_synthetic_luts(str(tmp_path)),
                             **MCICA_F64)
    cols = make_aerosols(make_clouds(make_columns(96, 137, 2), 2), 2)
    setup = setup_radiation(cfg, device=cuda)
    inputs = columns_to_inputs(cols, device=cuda)
    monkeypatch.setattr(hooks, "LHOOK", True)
    hooks.reset_profile()
    flux = radiation(setup, *inputs)
    torch.cuda.synchronize()
    counts = hooks.counters()
    hooks.reset_profile()
    monkeypatch.setattr(hooks, "LHOOK", False)
    assert {k: v for k, v in counts.items() if k.startswith("launch.")} == {
        "launch.taumol_lw.f64": 1, "launch.taumol_sw.f64": 1,
        "launch.sw_adding.f64": 2, "launch.lw_noscat.f64": 1,
        "launch.lw_adding.f64": 1, "launch.mcica_sw_optics.f64": 1,
        "launch.threefry_fields.f64": 2, "launch.mcica_generator.f64": 2,
        "launch.aerosol_optics.f64": 1}
    assert not [k for k in counts if k.startswith("plain_on_device.")]
    cpu = radiation(setup_radiation(cfg, device="cpu"),
                    *columns_to_inputs(cols, device="cpu"))
    for k, v in flux.fields():
        ref = getattr(cpu, k)
        assert v.dtype == ref.dtype == torch.float64, k
        scale = max(float(ref.abs().max()), 1.0)
        assert float((v.cpu() - ref).abs().max()) <= 1e-9 * scale, k


@pytest.mark.parametrize("variant", ["cloudless", "homogeneous"])
def test_float64_cloudless_and_homogeneous_on_the_card(cuda, tmp_path,
                                                        variant):
    """The other paths whose kernels all have double forms, in float64 on
    96 x 137 columns: Cloudless (B1, B2, B3 SW and LW) and Homogeneous
    with aerosols (B1, B2, B3 SW twice, B3 LW, B3'); every kernel in its
    double form, every output float64 and within 1e-9 of each field's
    largest value of the plain path on the CPU."""
    if variant == "cloudless":
        cfg = cloudless_slice_config(dtype="float64")
        cols = make_columns(96, 137, 0)
    else:
        cfg = tripleclouds_slice_config(
            **write_synthetic_luts(str(tmp_path), ice="fu"),
            **TC_VARIANTS["homogeneous"][0], dtype="float64")
        cols = make_aerosols(make_clouds(make_columns(96, 137, 0)))
    setup = setup_radiation(cfg, device=cuda)
    inputs = columns_to_inputs(cols, device=cuda)
    hooks.enable(True)
    hooks.reset_profile()
    try:
        flux = radiation(setup, *inputs)
        torch.cuda.synchronize()
        counts = hooks.counters()
    finally:
        hooks.enable(False)
        hooks.reset_profile()
    launched = {k for k in counts if k.startswith("launch.")}
    assert launched and all(k.endswith(".f64") for k in launched), counts
    cpu = radiation(setup_radiation(cfg, device="cpu"),
                    *columns_to_inputs(cols, device="cpu"))
    for k, v in flux.fields():
        ref = getattr(cpu, k)
        assert v.dtype == ref.dtype == torch.float64, k
        scale = max(float(ref.abs().max()), 1.0)
        assert float((v.cpu() - ref).abs().max()) <= 1e-9 * scale, k
