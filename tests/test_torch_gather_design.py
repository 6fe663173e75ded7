"""PyTorch port: what kernel B10's design (ecrad_tpu_torch/csrc/
gather_sections.cu, the per-band path's table-row interpolation) relies
on, checked on the CPU against its plain version (ops/gather_interp.py
eval_sections_plain). No JAX.

- `live_columns` finds the range of columns outside which a table is all
  zero: none for an all-zero table, a left or a right zero pad cut off,
  zero columns inside the range kept. On the per-band path every LW
  band's tau tables live in the first half of g and its pfrac tables in
  the second (ev2 in optics/rrtmg/taumol_lw_sections.py), and the 30
  calls of a gas-optics call need 5,116 term x g products a cell of the
  8,680 they would take over every column (5,544 in whole groups of the
  kernel's VEC columns).
- The descriptor and the operand table name each term's table, row,
  weight and offsets in section and term order, each tensor once.
- The wrapper copies no contiguous (N,) int32 row or float32 weight, and
  copies an int64 row tensor and a strided weight once each.
- A restatement of the kernel in PyTorch, read from the descriptor (each
  (cell, g) summed from 0 over the terms of the sections whose live
  groups hold g, in section and term order, gw*ew rounded first, a float4
  of table values a term), equals the plain version by value: on the
  path's 30 calls, and on random lists shaped like ev2's with weights of
  both signs, an all-zero table and rows past both ends.
- The .cu constants agree with the wrapper's; the descriptor and the
  operand pointers fit the launch's 4 KB of parameters; `plan` picks
  the tiles the H100 measured best (PERF.md).
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
from ecrad_tpu_torch.ops import gather_interp as gi
from ecrad_tpu_torch.optics.rrtmg import (taumol_lw_sections,
                                          taumol_sw_sections)
from ecrad_tpu_torch.optics.rrtmg.setcoef import prepare_gases, setcoef

GASES = ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12", "hcfc22", "ccl4",
         "o3")
# the H100 SXM: SMs, shared memory an SM holds and what each block
# reserves of it, and B10's blocks per SM at its 40 registers (65,536 /
# (40 x 256) = 6), as the card reported them for every call of the path
H100_SMS, SMEM_SM, SMEM_RESERVED, REG_BLOCKS = 132, 233472, 1024, 6


def _cu():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ecrad_tpu_torch", "csrc",
        "gather_sections.cu")
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def path_calls():
    """The 30 eval_sections calls of one per-band gas-optics call on 2
    columns of 137 levels, and the band widths of the LW calls."""
    setup = setup_radiation(cloudless_slice_config(), device="cpu")
    _, th, gas = columns_to_inputs(make_columns(2, 137, 0), device="cpu")
    t = setup.gas
    phl, thl = th.pressure_hl, th.temperature_hl
    gc = prepare_gases(phl, 0.5 * (phl[:, :-1] + phl[:, 1:]),
                       0.5 * (thl[:, :-1] + thl[:, 1:]),
                       *(gas.get(g) for g in GASES))
    c = setcoef(gc, t.preflog, t.tref, t.chi_mls)
    calls = []

    def keep(secs, n):
        calls.append((secs, n))
        return gi.eval_sections_plain(secs, n)
    mods = (taumol_lw_sections, taumol_sw_sections)
    saved = [m.eval_sections for m in mods]
    try:
        for m in mods:
            m.eval_sections = keep
        taumol_lw_sections.taumol_lw_sections(c, t.t)
        n_lw = len(calls)
        taumol_sw_sections.taumol_sw_sections(c, t)
    finally:
        for m, f in zip(mods, saved):
            m.eval_sections = f
    return calls, n_lw


def emulate(p: gi.Packed, n: int) -> torch.Tensor:
    """csrc/gather_sections.cu in PyTorch, read from the descriptor."""
    d = p.desc.tolist()
    nsec, nseg, nterms, nptr = d[:gi.HDR]
    assert nptr == p.ptrs.numel() == len(p.operands)
    at = gi.HDR

    def take(count, size):
        nonlocal at
        recs = [d[at + size * i:at + size * (i + 1)] for i in range(count)]
        at += size * count
        return recs
    segs, secs = take(nseg, gi.SEG), take(nsec, gi.SEC)
    terms = take(nterms, gi.TERM)
    assert at == len(d)
    ops = p.operands
    offs, ws = [], []
    for off, nrow, stride, rp, wp, ep, ewp, r2, st in terms:
        row, w = ops[rp].long(), ops[wp]
        if ep >= 0:
            row, w = row * r2 + st + ops[ep].long(), w * ops[ewp]
        offs.append(off + row.clamp(0, nrow - 1) * stride)
        ws.append(w)
    out = torch.full((p.g, n), float("nan"))
    groups = [q for a, b in segs for q in range(a, b)]
    assert groups == list(range(-(-p.g // gi.VEC)))
    for q in groups:
        acc = [torch.zeros(n) for _ in range(gi.VEC)]
        for first, end, k0, k1 in secs:
            if first <= q < end:
                for k in range(k0, k1):
                    for j in range(gi.VEC):
                        acc[j] = acc[j] + ws[k] * p.tab[offs[k] + gi.VEC * q
                                                        + j]
        for j in range(min(gi.VEC, p.g - gi.VEC * q)):
            out[gi.VEC * q + j] = acc[j]
    return out


def _random_case(g, n, seed, halves=True, zero=False, out_of_range=False):
    """An ev2-shaped list (the first half of g tau sections, the second
    pfrac ones, each zero on the other half) or, without halves, one over
    the whole of g; weights of both signs."""
    rng = np.random.RandomState(seed)
    h = g // 2

    def tab(*shape, part):
        x = rng.randn(*shape, g).astype(np.float32)
        if halves:
            x[..., h:] = 0.0 if part == "tau" else x[..., h:]
            x[..., :h] = x[..., :h] if part == "tau" else 0.0
        return x

    def rows(lo, hi):
        return torch.as_tensor(rng.randint(lo, hi, n).astype(np.int32))

    def w():
        return torch.as_tensor(rng.randn(n).astype(np.float32))
    lo = -3 if out_of_range else 0
    secs = [gi.EtaSection(tab(65, 9, part="tau"),
                          [rows(lo, 64 - lo) for _ in range(2)],
                          [[(0, w()), (1, w())] for _ in range(2)],
                          [rows(1 + lo, 7 - lo) for _ in range(2)],
                          [[(o, w()) for o in (-1, 0, 1, 2)]
                           for _ in range(2)]),
            gi.Section(tab(10, part="tau"), [rows(lo, 10 - lo)
                                              for _ in range(2)],
                       [w(), w()]),
            gi.Section(tab(9, part="pfrac"), [rows(lo, 9 - lo)
                                               for _ in range(2)],
                       [w(), w()])]
    if zero:
        secs.insert(1, gi.Section(np.zeros((7, g), np.float32),
                                  [rows(0, 7)], [w()]))
    return secs


# ---- live columns ----

@pytest.mark.parametrize("case, want", [
    ("all_zero", (0, 0)), ("left_pad", (3, 10)), ("right_pad", (0, 7)),
    ("both_pads", (2, 6)), ("interior_zero", (0, 10)),
    ("eta_last_axis", (4, 8))])
def test_live_columns(case, want):
    rng = np.random.RandomState(0)
    x = rng.rand(5, 10).astype(np.float32) + 0.5
    if case == "all_zero":
        x[:] = 0.0
    elif case == "left_pad":
        x[:, :3] = 0.0
    elif case == "right_pad":
        x[:, 7:] = 0.0
    elif case == "both_pads":
        x[:, :2] = 0.0
        x[:, 6:] = 0.0
    elif case == "interior_zero":
        x[:, 4] = 0.0
    else:
        x = rng.rand(4, 3, 12).astype(np.float32)
        x[..., :4] = 0.0
        x[..., 8:] = 0.0
        x[1, 2, 4] = 0.0
    assert gi.live_columns(x) == want


def test_live_groups_are_the_live_range_widened_and_zero_past_g():
    x = np.zeros((3, 10), np.float32)
    x[:, 5:10] = 1.0
    ent = gi._entry(x, torch.float32, "cpu")
    assert (ent.lo, ent.hi, ent.first) == (5, 10, 4)
    assert ent.live.shape == (3, 8)
    np.testing.assert_array_equal(ent.live.numpy(),
                                  np.pad(x, ((0, 0), (0, 2)))[:, 4:12])


def test_path_lw_halves_and_live_products(path_calls):
    calls, n_lw = path_calls
    assert (len(calls), n_lw) == (30, 16)
    full = live = grouped = 0
    for i, (secs, n) in enumerate(calls):
        g = np.asarray(secs[0].table).shape[-1]
        if i < n_lw:
            tau = [s for s in secs if gi.live_columns(s.table)[1] <= g // 2]
            assert 0 < len(tau) < len(secs)
            assert tau == secs[:len(tau)]
            for s in secs[len(tau):]:
                assert gi.live_columns(s.table)[0] >= g // 2
        p = gi.pack_sections(secs, n, "cpu")
        assert len(p.desc) <= gi.MAX_DESC and len(p.operands) <= 56
        d = p.desc.tolist()
        at = gi.HDR + gi.SEG * d[1]
        for s, (first, end, k0, k1) in zip(
                secs, [d[at + gi.SEC * i:at + gi.SEC * (i + 1)]
                       for i in range(d[0])]):
            lo, hi = gi.live_columns(s.table)
            full += (k1 - k0) * g
            live += (k1 - k0) * (hi - lo)
            grouped += (k1 - k0) * gi.VEC * (end - first)
    assert (full, live, grouped) == (8680, 5116, 5544)


# ---- descriptor and operands ----

def test_descriptor_and_operand_order():
    n = 7
    rng = np.random.RandomState(1)
    r = [torch.as_tensor(rng.randint(0, 4, n).astype(np.int32))
         for _ in range(4)]
    w = [torch.as_tensor(rng.rand(n).astype(np.float32)) for _ in range(8)]
    t1 = rng.rand(5, 10).astype(np.float32)
    t1[:, 6:] = 0.0                         # live [0, 6): groups 0, 1
    t2 = rng.rand(3, 4, 10).astype(np.float32)
    t2[..., :5] = 0.0                       # live [5, 10): groups 1, 2
    secs = [gi.Section(t1, [r[0], r[1]], [w[0], w[0]]),
            gi.EtaSection(t2, [r[2]], [[(0, w[1]), (1, w[2])]], [r[3]],
                          [[(-1, w[3]), (0, w[4]), (2, w[0])]])]
    p = gi.pack_sections(secs, n, "cpu")
    d = p.desc.tolist()
    # operands in order of first use, w[0] once
    want = [r[0], w[0], r[1], r[2], r[3], w[1], w[2], w[3], w[4]]
    assert len(p.operands) == len(want)
    assert all(a is b for a, b in zip(p.operands, want))
    assert p.ptrs.tolist() == [t.data_ptr() for t in want]
    assert d[:gi.HDR] == [2, 1, 2 + 2 * 3, 9]
    assert d[4:6] == [0, 3]                 # one segment: groups 0-2
    assert d[6:10] == [0, 2, 0, 2]          # t1: groups [0, 2), terms 0-1
    assert d[10:14] == [1, 3, 2, 8]         # t2: groups [1, 3), terms 2-7
    terms = [d[14 + gi.TERM * k:14 + gi.TERM * (k + 1)] for k in range(8)]
    assert terms[0] == [0, 5, 8, 0, 1, -1, 0, 0, 0]
    assert terms[1] == [0, 5, 8, 2, 1, -1, 0, 0, 0]
    off = 5 * 8 - 4                         # t1's columns, less t2's first
    eta = [[off, 12, 8, 3, gw, 4, ew, 4, go * 4 + eo]
           for go, gw in ((0, 5), (1, 6))
           for eo, ew in ((-1, 7), (0, 8), (2, 1))]
    assert terms[2:] == eta
    assert p.tab.numel() == 5 * 8 + 12 * 8 and (p.g, p.nterms) == (10, 8)
    np.testing.assert_array_equal(p.tab[:40].numpy(), t1[:, :8].ravel())
    np.testing.assert_array_equal(
        p.tab[40:].numpy(),
        np.pad(t2.reshape(12, 10), ((0, 0), (0, 2)))[:, 4:12].ravel())


def test_operands_read_in_place_or_copied_once():
    n = 9
    rng = np.random.RandomState(2)
    tab = rng.rand(6, 4).astype(np.float32)
    rows32 = torch.as_tensor(rng.randint(0, 6, n).astype(np.int32))
    rows64 = torch.as_tensor(rng.randint(0, 6, n))
    w = torch.as_tensor(rng.rand(n).astype(np.float32))
    strided = torch.as_tensor(rng.rand(n, 2).astype(np.float32))[:, 1]
    before = gi.copies["gather_sections"]
    p = gi.pack_sections([gi.Section(tab, [rows32, rows32], [w, w])], n,
                         "cpu")
    assert gi.copies["gather_sections"] == before
    assert p.operands[0] is rows32 and p.operands[1] is w
    secs = [gi.Section(tab, [rows64, rows64, rows32], [strided, w, strided])]
    p = gi.pack_sections(secs, n, "cpu")
    assert gi.copies["gather_sections"] == before + 2
    assert p.operands[0].dtype == torch.int32 and \
        p.operands[1].is_contiguous()
    assert len(p.operands) == 4
    assert torch.equal(emulate(p, n), gi.eval_sections_plain(secs, n))
    with pytest.raises(ValueError, match="shape"):
        gi.pack_sections([gi.Section(tab, [rows32[:5]], [w[:5]])], n, "cpu")


# ---- the kernel's order, restated ----

def test_path_calls_equal_plain_by_value(path_calls):
    for secs, n in path_calls[0]:
        got = emulate(gi.pack_sections(secs, n, "cpu"), n)
        assert torch.equal(got, gi.eval_sections_plain(secs, n))


@pytest.mark.parametrize("g, halves, zero, out_of_range", [
    (20, True, False, False), (28, True, True, False),
    (32, True, False, True), (12, False, True, True), (6, False, False,
                                                       False)])
@pytest.mark.parametrize("n", [1, 33])
def test_random_lists_equal_plain_by_value(g, halves, zero, out_of_range, n):
    secs = _random_case(g, n, g + n, halves, zero, out_of_range)
    got = emulate(gi.pack_sections(secs, n, "cpu"), n)
    want = gi.eval_sections_plain(secs, n)
    assert torch.equal(got, want)
    assert bool((want < 0).any())


def test_all_zero_list_gives_zeros():
    n = 5
    sec = gi.Section(np.zeros((3, 6), np.float32),
                     [torch.zeros(n, dtype=torch.int32)],
                     [torch.full((n,), -2.0)])
    p = gi.pack_sections([sec], n, "cpu")
    assert p.desc.tolist()[:gi.HDR + gi.SEG + gi.SEC] == \
        [1, 1, 1, 2, 0, 2, 0, 0, 0, 1]
    assert torch.equal(emulate(p, n), torch.zeros(6, n))


# ---- constants, parameters, plan ----

def test_cuda_constants_match_the_wrapper():
    src = _cu()
    for name in ("MAX_DESC", "MAX_PTR", "HDR", "SEG", "SEC", "TERM", "VEC",
                 "BLOCK", "SMEM_MAX"):
        got = int(re.search(r"constexpr int %s = (\d+);" % name,
                            src).group(1))
        assert got == getattr(gi, name), name
    # the descriptor and the pointers, then tab, n, g, tile and out
    assert 4 * gi.MAX_DESC + 8 * gi.MAX_PTR + 8 + 3 * 4 + 8 <= 4096


def _h100_blocks(nterms, nptr, g):
    return lambda tile: min(REG_BLOCKS, SMEM_SM // (
        gi.smem_bytes(tile, nterms, nptr, g) + SMEM_RESERVED))


@pytest.mark.parametrize("nterms, nptr, g, want", [
    (40, 55, 32, 64),     # LW band 3, the largest call
    (3, 6, 8, 384),       # the smallest (SW band 24's Rayleigh term)
    (13, 26, 16, 128),
    (9, 18, 4, 192)])
def test_plan_on_the_h100(nterms, nptr, g, want):
    n = 2048 * 137
    tile = gi.plan(n, nterms, nptr, g, _h100_blocks(nterms, nptr, g),
                   H100_SMS)
    assert tile == want and tile % 32 == 0
    assert gi.smem_bytes(tile, nterms, nptr, g) <= gi.SMEM_MAX
