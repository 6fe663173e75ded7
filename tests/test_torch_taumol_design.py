"""PyTorch port: what the design of kernels B1 (ecrad_tpu_torch/csrc/
taumol_lw.cu) and B2 (csrc/taumol_sw.cu) relies on, checked on the CPU
against their plain versions (optics/rrtmg/taumol_lw.py, taumol_sw.py).

- The band tables of the .cu file (c_ng, c_goff, c_ktau, c_kpf) are the
  plain module's, and its per-warp band lists (c_warp_bands) take every
  band exactly once and split the work as the source says; a re-laid
  split that drops or doubles a band fails here, not only on the card.
- Each warp's slots hold the largest band's terms (K_BAND_MAX), and the
  phase-2 instantiations (ECRAD_BAND_OUTPUTS) cover every band width in
  whole chunks.
- The kernel's arithmetic, restated in PyTorch: per output the sum over
  the band's slots in slot order, acc = acc + w_k * tab[row_k + g] with
  one rounding per operation (the kernel builds with -fmad=false). It
  stays within B1's bound of the plain version (rel 1e-5 where
  |tau| > 1e-6, pfrac atol 1e-6, the JAX package's fused-taumol bound),
  on every cell and on the tropospheric and stratospheric cells apart.
  (The kernel's own weights come from CUDA's expf, logf and divisions,
  which may differ from PyTorch's in the last bit, so on the card
  tests/test_torch_kernels_gpu.py holds it to the plain version's bound.)
- B2 likewise: its SW band tables and warp band lists (the 14 bands
  split by ng_b (K_TAUG_b + K_TAUR_b)), its slots and phase-2
  instantiations, and its phase 2 restated, the slot-order sums within
  B2's bound of taumol_sw_plain (rel 1e-5 where |tau| > 1e-6; taur, one
  or two terms a band, equal), on every cell and on the tropospheric and
  stratospheric cells apart.

Inputs: 4 columns x 137 levels of ecrad_tpu_torch.inputs (seed 0).
"""
import os
import re

import numpy as np
import pytest
import torch

from ecrad_tpu_torch.config import cloudless_slice_config
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import make_columns
from ecrad_tpu_torch.interface import setup_radiation
from ecrad_tpu_torch.optics.rrtmg import taumol_lw, taumol_sw
from ecrad_tpu_torch.optics.rrtmg.setcoef import prepare_gases, setcoef

GASES = ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12", "hcfc22", "ccl4",
         "o3")
TAU_REL, PF_ATOL = 1e-5, 1e-6


def _cu(name="taumol_lw.cu"):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ecrad_tpu_torch", "csrc", name)
    with open(path) as f:
        return f.read()


def _ints(src, name):
    body = re.search(r"%s(?:\[\w+\])+ = \{(.*?)\};" % name, src,
                     re.S).group(1)
    return [int(x) for x in re.findall(r"-?\d+", body)]


def _const(src, name):
    return int(re.search(r"\b%s = (\d+)" % name, src).group(1))


def _work(b):
    """The split's work of band b (1-based) per cell, as the .cu says:
    ng_b (K_TAU_b + K_PF_b) + 4 (K_TAU_b + K_PF_b)."""
    k = taumol_lw.K_TAU[b - 1] + taumol_lw.K_PF[b - 1]
    return taumol_lw.NG[b - 1] * k + 4 * k


def test_band_tables_match_the_plain_module():
    s = _cu()
    assert _ints(s, "c_ng") == taumol_lw.NG
    assert _ints(s, "c_goff") == taumol_lw.G_OFF
    assert _ints(s, "c_ktau") == [0] + list(np.cumsum(taumol_lw.K_TAU))
    assert _ints(s, "c_kpf") == [0] + list(np.cumsum(taumol_lw.K_PF))


def test_warp_band_lists_take_every_band_once():
    s = _cu()
    nwarp, per_warp = _const(s, "NWARP_LW"), _const(s, "BANDS_PER_WARP")
    flat = _ints(s, "c_warp_bands")
    assert len(flat) == nwarp * per_warp
    rows = [flat[w * per_warp:(w + 1) * per_warp] for w in range(nwarp)]
    taken = []
    for row in rows:
        n = row.index(0) if 0 in row else per_warp
        assert all(b == 0 for b in row[n:]), row     # 0 ends a row
        taken += row[:n]
    assert sorted(taken) == list(range(1, 17))


def test_warp_work_split_is_the_stated_one():
    s = _cu()
    nwarp, per_warp = _const(s, "NWARP_LW"), _const(s, "BANDS_PER_WARP")
    flat = _ints(s, "c_warp_bands")
    work = [sum(_work(b) for b in flat[w * per_warp:(w + 1) * per_warp]
                if b) for w in range(nwarp)]
    assert work == [880, 896, 862, 856]
    assert sum(work) == sum(_work(b) for b in range(1, 17)) == 3494
    assert max(work) <= 1.05 * sum(work) / nwarp


def test_slots_and_phase2_instantiations_cover_every_band():
    s = _cu()
    k_band = [t + p for t, p in zip(taumol_lw.K_TAU, taumol_lw.K_PF)]
    assert _const(s, "K_BAND_MAX") == max(k_band)
    widths = {int(x) for x in re.findall(r"ECRAD_BAND_OUTPUTS\((\d+)\)",
                                         s)}
    assert set(taumol_lw.NG) <= widths
    # CHUNK = NGB <= 12 ? NGB : NGB / 2 divides every width it is used for
    assert re.search(r"CHUNK = NGB <= 12 \? NGB : NGB / 2;", s)
    for ng in taumol_lw.NG:
        chunk = ng if ng <= 12 else ng // 2
        assert ng % chunk == 0 and chunk <= 12


@pytest.fixture(scope="module")
def cells():
    setup = setup_radiation(cloudless_slice_config(), device="cpu")
    sl, th, gas = columns_to_inputs(make_columns(4, 137, 0), device="cpu")
    t = setup.gas
    phl, thl = th.pressure_hl, th.temperature_hl
    gc = prepare_gases(phl, 0.5 * (phl[:, :-1] + phl[:, 1:]),
                       0.5 * (thl[:, :-1] + thl[:, 1:]),
                       *(gas.get(g) for g in GASES))
    c = setcoef(gc, t.preflog, t.tref, t.chi_mls).flip_levels()
    fc, ic = taumol_lw.pack_coeffs(c, t.chi_mls)
    fc_sw, ic_sw = taumol_sw.pack_coeffs(c)
    return fc.float(), ic, setup.gas.lw, fc_sw.float(), ic_sw, setup.gas.sw


def slot_order_sums(fc, ic, tables):
    """B1's arithmetic restated: for every band and output, the sum over
    the band's slots in slot order, one rounding per multiply and add.
    (tau, pfrac), each (N, 140)."""
    tau_terms, pf_terms = taumol_lw.lw_terms(fc, ic, tables.flat,
                                             tables.flat.consts)
    outs = []
    for terms in (tau_terms, pf_terms):
        bands = []
        for b in range(16):
            g = torch.arange(taumol_lw.NG[b], device=tables.tab.device)
            acc = torch.zeros((fc.shape[1], taumol_lw.NG[b]),
                              dtype=tables.tab.dtype,
                              device=tables.tab.device)
            for base, w in terms[b]:
                acc = acc + w[:, None] * tables.tab[base[:, None] + g]
            bands.append(acc)
        outs.append(torch.cat(bands, 1))
    return tuple(outs)


@pytest.mark.parametrize("regime", ["all", "troposphere", "stratosphere"])
def test_slot_order_sums_within_b1_bound_of_plain(cells, regime):
    fc, ic, tables = cells[:3]
    tropo = fc[0] > 0
    sel = {"all": torch.ones_like(tropo), "troposphere": tropo,
           "stratosphere": ~tropo}[regime]
    assert bool(sel.any())
    fc, ic = fc[:, sel].contiguous(), ic[:, sel].contiguous()
    tau, pf = slot_order_sums(fc, ic, tables)
    tau0, pf0 = taumol_lw.taumol_lw_plain(fc, ic, tables)
    mask = tau0.abs() > 1e-6
    rel = ((tau - tau0).abs() / tau0.abs().clamp(min=1e-30))[mask]
    assert float(rel.max()) <= TAU_REL
    # where tau is tiny the difference stays tiny too
    assert float(torch.where(mask, 0.0, (tau - tau0).abs()).max()) <= 1e-10
    assert float((pf - pf0).abs().max()) <= PF_ATOL


# ---- B2 ----

def _sw_work(bi):
    """The split's work of band index bi (0-based) per cell, as the .cu
    says: ng_b (K_TAUG_b + K_TAUR_b)."""
    return taumol_sw.NG[bi] * (taumol_sw.K_TAUG[bi] + taumol_sw.K_TAUR[bi])


def test_sw_band_tables_match_the_plain_module():
    s = _cu("taumol_sw.cu")
    assert _ints(s, "c_ng") == taumol_sw.NG
    assert _ints(s, "c_goff") == taumol_sw.G_OFF
    assert _ints(s, "c_ktaug") == [0] + list(np.cumsum(taumol_sw.K_TAUG))
    assert _ints(s, "c_ktaur") == [0] + list(np.cumsum(taumol_sw.K_TAUR))


def test_sw_warp_band_lists_take_every_band_once_split_by_work():
    s = _cu("taumol_sw.cu")
    nwarp = _const(s, "NWARP_SW")
    per_warp = _const(s, "BANDS_PER_WARP_SW")
    flat = _ints(s, "c_warp_bands")
    assert len(flat) == nwarp * per_warp
    taken, work = [], []
    for w in range(nwarp):
        row = flat[w * per_warp:(w + 1) * per_warp]
        n = row.index(0) if 0 in row else per_warp
        assert all(b == 0 for b in row[n:]), row     # 0 ends a row
        taken += row[:n]
        work.append(sum(_sw_work(b - 16) for b in row[:n]))
    assert sorted(taken) == list(range(16, 30))
    assert work == [286, 294, 292, 294]
    assert sum(work) == sum(_sw_work(b) for b in range(14)) == 1166
    assert max(work) <= 1.05 * sum(work) / nwarp


def test_sw_slots_and_phase2_instantiations_cover_every_band():
    s = _cu("taumol_sw.cu")
    k_band = [g + r for g, r in zip(taumol_sw.K_TAUG, taumol_sw.K_TAUR)]
    assert _const(s, "K_BAND_MAX_SW") == max(k_band)
    # a band's live slots are one bit each of a 32-bit mask
    assert max(k_band) <= 32
    widths = {int(x) for x in re.findall(r"ECRAD_SW_BAND_OUTPUTS\((\d+)\)",
                                         s)}
    assert set(taumol_sw.NG) <= widths
    # a lane sums all its ng_b outputs of a band at once
    assert max(taumol_sw.NG) <= 12


def sw_slot_sums(fc, ic, tables):
    """B2's phase 2 restated: for every band and output, the sum over the
    band's slots in slot order, one rounding per multiply and add.
    (taug, taur), each (N, 112)."""
    g_terms, r_terms = taumol_sw.sw_terms(fc, ic, tables.flat,
                                          tables.flat.consts)
    outs = []
    for terms in (g_terms, r_terms):
        bands = []
        for b in range(14):
            g = torch.arange(taumol_sw.NG[b])
            acc = torch.zeros((fc.shape[1], taumol_sw.NG[b]),
                              dtype=tables.tab.dtype)
            for base, w in terms[b]:
                acc = acc + w[:, None] * tables.tab[base[:, None] + g]
            bands.append(acc)
        outs.append(torch.cat(bands, 1))
    return tuple(outs)


@pytest.mark.parametrize("regime", ["all", "troposphere", "stratosphere"])
def test_sw_slot_sums_within_b2_bound_of_plain(cells, regime):
    fc, ic, tables = cells[3:]
    tropo = fc[0] > 0
    sel = {"all": torch.ones_like(tropo), "troposphere": tropo,
           "stratosphere": ~tropo}[regime]
    assert bool(sel.any())
    fc, ic = fc[:, sel].contiguous(), ic[:, sel].contiguous()
    got = sw_slot_sums(fc, ic, tables)
    ref = taumol_sw.taumol_sw_plain(fc, ic, tables)
    for x, x0 in zip(got, ref):
        mask = x0.abs() > 1e-6
        rel = ((x - x0).abs() / x0.abs().clamp(min=1e-30))[mask]
        assert float(rel.max()) <= TAU_REL
        assert float(torch.where(mask, 0.0, (x - x0).abs()).max()) <= 1e-10
    # taur: one or two terms a band, summed in the plain version's order
    assert torch.equal(got[1], ref[1])
