"""Kernel B10: weighted table-row interpolation (csrc/gather_sections.cu),
beside its plain PyTorch version.

Replaces ecrad_tpu/ops/gather_interp.py::_eval_sections_pallas (:191,
pallas_call :267, body `_pallas_kernel` :115). The per-band taumol path
(optics/rrtmg/taumol_lw_sections.py, taumol_sw_sections.py) writes each
band's k-table lookups as `sections`, and one `eval_sections` call sums
them:

    out[g, n] = sum over sections, over terms k:  w_k[n] * T_s[row_k[n], g]

A `Section` is a (R, G) table with K per-cell rows and weights. An
`EtaSection` is a (R1, R2, G) table read at the flat row
grid*R2 + go*R2 + eta + eo with the weight gw*ew, for every family, grid
offset go and eta offset eo (the separable binary-species lookups).

Semantics are those of `_eval_sections_reference` (:100-112), which the
plain version here ports: an EtaSection is flattened first
(`_eta_to_plain` :86-97, `eta_to_plain` here), every row (for an
EtaSection the FLAT row) is clipped to the table, and the output is the
first term plus each later term, in section order and term order
(family, grid offset, eta offset). `eval_sections` runs the plain version
on CPU tensors and the kernel on any other (which raises unless it is
CUDA float32).

The kernel reads only each table's live columns: `live_columns` finds,
once per table content, the range [lo, hi) outside which a table is all
zero (for an EtaSection along the last axis of its (R1, R2, G) table),
and the kernel sums a section's terms only on that range, widened to
whole groups of VEC columns. The LW path's bands stack their tau and
pfrac tables side by side, each zero-padded on the other half, so about
40 % of the path's gathers go. A skipped term would add w * 0: while the
weights are finite, which the path's are, the kernel's sum equals the
plain version's by value (at most the sign of an exact zero differs, and
-0 == +0); a non-finite weight times a zero column is NaN in the plain
version and skipped by the kernel. A table given as a tensor is read
whole (finding its range would wait for the device).

Each (cell, g) is summed from 0.0 in one thread in the plain version's
order, with -fmad=false and gw*ew rounded before the product, so the two
agree by value. The kernel is bound by bytes: it reads each row and
weight tensor in place, once (`pack_sections` passes their device
pointers by value beside an int descriptor, and copies only an operand
that is not a contiguous (N,) int32 row or float32 weight on the device,
counting it in `copies`), and writes each output once. It is one launch
per call; `plan` picks the cells a block takes.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

#: launches of the CUDA kernel (incremented only where it is launched)
launches = {"gather_sections": 0}
#: operands the kernel's wrapper copied because they were not contiguous
#: (N,) int32 rows or float32 weights on the kernel's device
copies = {"gather_sections": 0}

# csrc/gather_sections.cu: the by-value descriptor's and operand table's
# lengths, the descriptor's record sizes (header; segment; section; term),
# the output columns a lane sums (one float4 load a term), the threads of
# a block and a block's shared-memory limit
MAX_DESC, MAX_PTR = 640, 128
HDR, SEG, SEC, TERM = 4, 2, 4, 9
VEC = 4
BLOCK, SMEM_MAX = 256, 232448
#: `plan`'s tiles: multiples of 32 cells up to TILE_MAX; a block's time
#: taken as TILE_COST cells' worth plus its cells (fitted to the path's
#: 30 calls on an H100 with tools/b10_tiles.py, PERF.md)
TILE_MAX, TILE_COST = 512, 64


class Section(NamedTuple):
    """One lookup table plus its per-cell rows and weights.

    table: (R, G) numpy array or tensor; rows: (N,) int tensors (0-based
    rows, clipped to the table); weights: (N,) tensors, as many as rows."""
    table: Union[np.ndarray, torch.Tensor]
    rows: Sequence[torch.Tensor]
    weights: Sequence[torch.Tensor]


class EtaSection(NamedTuple):
    """A separable lookup in a (R1, R2, G) table. Per family f: grids[f]
    (N,) the base grid row, grid_terms[f] a list of (static offset,
    weight (N,)), etas[f] (N,) the base eta row, eta_terms[f] a list of
    (static offset, weight (N,))."""
    table: Union[np.ndarray, torch.Tensor]
    grids: Sequence[torch.Tensor]
    grid_terms: Sequence[Sequence[Tuple[int, torch.Tensor]]]
    etas: Sequence[torch.Tensor]
    eta_terms: Sequence[Sequence[Tuple[int, torch.Tensor]]]


class _Table(NamedTuple):
    full: torch.Tensor     # the table, (..., G)
    lo: int                # its live columns [lo, hi)
    hi: int
    first: int             # lo rounded down to a multiple of VEC
    live: torch.Tensor     # columns [first, first + width) as (rows,
    #                        width) float32, width a multiple of VEC,
    #                        zero past G (`full` itself, not a copy, where
    #                        that is all of a float32 table)


def _table(full: torch.Tensor, lo: int, hi: int) -> _Table:
    g = full.shape[-1]
    first, end = lo // VEC * VEC, -(-hi // VEC) * VEC
    flat = full.reshape(-1, g).to(torch.float32)
    if end > g:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[0], end - g)], 1)
    return _Table(full, lo, hi, first, flat[:, first:end].contiguous())


_TABLES = {}


def live_columns(table) -> Tuple[int, int]:
    """(lo, hi): the range of last-axis columns outside which the numpy
    `table` is all zero ((0, 0) for an all-zero table). Zero columns
    inside the range stay in it."""
    arr = np.asarray(table)
    cols = np.flatnonzero(np.any(arr.reshape(-1, arr.shape[-1]) != 0,
                                 axis=0))
    return (int(cols[0]), int(cols[-1]) + 1) if cols.size else (0, 0)


def _entry(table, dtype, device) -> _Table:
    """`table` on device in dtype with its live columns. A numpy table is
    copied to the device, and its range found, once per content (the
    per-band path rebuilds its numpy tables on every call, as the JAX
    package does); a tensor is taken whole."""
    if isinstance(table, torch.Tensor):
        full = table.to(device=device, dtype=dtype)
        return _table(full, 0, full.shape[-1])
    arr = np.ascontiguousarray(table)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, str(device))
    ent = _TABLES.get(key)
    if ent is None:
        ent = _TABLES[key] = _table(
            torch.as_tensor(arr, dtype=dtype, device=device),
            *live_columns(arr))
    return ent


def table_tensor(table, dtype, device) -> torch.Tensor:
    """`table` as a tensor of dtype on device (a numpy table copied once
    per content)."""
    return _entry(table, dtype, device).full


def eta_to_plain(sec: EtaSection, dtype, device) -> Section:
    """An EtaSection as the equivalent plain Section (the flat rows and
    the products gw * ew), ecrad_tpu/ops/gather_interp.py:86-97."""
    tab = table_tensor(sec.table, dtype, device)
    r1, r2, g = tab.shape
    rows, weights = [], []
    for fam in range(len(sec.grids)):
        base = sec.grids[fam] * r2
        for go, gw in sec.grid_terms[fam]:
            for eo, ew in sec.eta_terms[fam]:
                rows.append(base + go * r2 + sec.etas[fam] + eo)
                weights.append(gw * ew)
    return Section(tab.reshape(r1 * r2, g), rows, weights)


def _first_weight(sections) -> torch.Tensor:
    sec = sections[0]
    return (sec.weights[0] if isinstance(sec, Section)
            else sec.grid_terms[0][0][1])


def eval_sections_plain(sections: List, n: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B10: (G, N) in the weights' dtype
    (ecrad_tpu/ops/gather_interp.py::_eval_sections_reference)."""
    w0 = _first_weight(sections)
    dtype, device = w0.dtype, w0.device
    out = None
    for sec in sections:
        if isinstance(sec, EtaSection):
            sec = eta_to_plain(sec, dtype, device)
        tab = table_tensor(sec.table, dtype, device)
        nrow = tab.shape[0]
        for r, w in zip(sec.rows, sec.weights):
            term = tab[r.clamp(0, nrow - 1).long()].T * w[None, :]
            out = term if out is None else out + term
    return out.contiguous()


def column_segments(ranges, ngroups: int) -> List[Tuple[int, int]]:
    """[0, ngroups) cut into the kernel's segments: each disjoint union of
    overlapping live ranges (first, end), and each gap between them
    (whose outputs are 0), in order."""
    merged = []
    for lo, hi in sorted(r for r in ranges if r[1] > r[0]):
        if merged and lo < merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    segs, a = [], 0
    for lo, hi in merged:
        if lo > a:
            segs.append((a, lo))
        segs.append((lo, hi))
        a = hi
    if a < ngroups:
        segs.append((a, ngroups))
    return segs


class Packed(NamedTuple):
    """The kernel's operands for one call."""
    desc: torch.Tensor       # int32 descriptor (host)
    ptrs: torch.Tensor       # int64 device addresses of `operands` (host)
    operands: List[torch.Tensor]
    tab: torch.Tensor        # the sections' live columns, flat float32
    g: int
    nterms: int


def pack_sections(sections: List, n: int, device) -> Packed:
    """The kernel's operands. The descriptor: HDR ints (sections,
    segments, terms, operands), then per segment of column groups (first
    group, end group; group q holds columns [VEC q, VEC q + VEC)), per
    section (first group, end group of its live columns, first term, end
    term), per term (element offset in `tab` of the section's row 0 less
    its first column, rows in the table, row stride, row or grid operand,
    weight or gw operand, eta operand (-1 for a plain term), ew operand,
    R2, go*R2 + eo). Terms run in section order, then (plain) row order
    or (eta) family, grid offset, eta offset. Operands are indices into
    `ptrs`, in order of first use: a plain section's row and weight of
    each term, an eta family's grid, eta, grid weights and eta weights;
    each tensor once. An operand that is not a contiguous (N,) int32 row
    or float32 weight on `device` is copied (counted in `copies`); one of
    another shape raises."""
    device = torch.device(device)
    f32, i32 = torch.float32, torch.int32
    operands, index = [], {}

    def ptr(t, dtype):
        key = (id(t), dtype)
        if key not in index:
            if t.shape != (n,):
                raise ValueError(f"gather_sections: an operand of shape "
                                 f"{tuple(t.shape)}, not ({n},)")
            if t.dtype != dtype or t.device != device \
                    or not t.is_contiguous():
                t = t.to(device=device, dtype=dtype).contiguous()
                copies["gather_sections"] += 1
            index[key] = len(operands)
            operands.append(t)
        return index[key]

    ents, secs, terms, off, g = [], [], [], 0, None
    for sec in sections:
        ent = _entry(sec.table, f32, device)
        g = ent.full.shape[-1] if g is None else g
        if ent.full.shape[-1] != g:
            raise ValueError("every section's table needs the same G")
        nrow, width = ent.live.shape
        head = [off - ent.first, nrow, width]
        k0 = len(terms)
        if isinstance(sec, EtaSection):
            r2 = ent.full.shape[1]
            for fam in range(len(sec.grids)):
                gp, ep = ptr(sec.grids[fam], i32), ptr(sec.etas[fam], i32)
                gws = [(o, ptr(w, f32)) for o, w in sec.grid_terms[fam]]
                ews = [(o, ptr(w, f32)) for o, w in sec.eta_terms[fam]]
                terms += [head + [gp, gw, ep, ew, r2, int(go) * r2 + int(eo)]
                          for go, gw in gws for eo, ew in ews]
        else:
            for r, w in zip(sec.rows, sec.weights):
                terms.append(head + [ptr(r, i32), ptr(w, f32), -1, 0, 0, 0])
        secs.append([ent.first // VEC, (ent.first + width) // VEC, k0,
                     len(terms)])
        ents.append(ent)
        off += nrow * width
    segs = column_segments([(a, b) for a, b, _, _ in secs], -(-g // VEC))
    desc = [len(secs), len(segs), len(terms), len(operands)]
    for rec in segs + secs + terms:
        desc += list(rec)
    if len(desc) > MAX_DESC or len(operands) > MAX_PTR:
        raise ValueError(f"section list too long for the kernel's "
                         f"parameters ({len(desc)} > {MAX_DESC} ints or "
                         f"{len(operands)} > {MAX_PTR} operands)")
    return Packed(torch.tensor(desc, dtype=torch.int32),
                  torch.tensor([t.data_ptr() for t in operands],
                               dtype=torch.int64),
                  operands, torch.cat([e.live.reshape(-1) for e in ents]),
                  g, len(terms))


def smem_bytes(tile: int, nterms: int, nptr: int, g: int) -> int:
    """A block's shared memory (csrc/gather_sections.cu smem_bytes): the
    terms, then the rows and weights / outputs."""
    return 8 * nterms * tile + 4 * tile * max(nptr, g | 1)


def plan(n: int, nterms: int, nptr: int, g: int,
         blocks_per_sm: Callable[[int], int], sms: int) -> int:
    """The cells of a block: of the multiples of 32 up to TILE_MAX whose
    block fits an SM (blocks_per_sm(tile) >= 1), the one with the fewest
    rounds of resident blocks times (tile + TILE_COST); the smaller on a
    tie. Few rounds keep small calls from ending on a nearly empty one;
    large ones want small tiles, for more blocks an SM."""
    best = None
    for tile in range(32, TILE_MAX + 1, 32):
        if smem_bytes(tile, nterms, nptr, g) > SMEM_MAX:
            break
        b = blocks_per_sm(tile)
        if b < 1:
            break
        cost = math.ceil(math.ceil(n / tile) / (b * sms)) * (tile + TILE_COST)
        if best is None or cost < best[0]:
            best = (cost, tile)
    return best[1]


_PLANS = {}


def _plan_on_card(n: int, nterms: int, nptr: int, g: int) -> int:
    """`plan` with the card's own occupancy, once per call shape."""
    key = (n, nterms, nptr, g)
    if key not in _PLANS:
        from . import _cuda

        def info(tile):
            return _cuda.kernel_info("gather_sections_info", tile, nterms,
                                     nptr, g)
        _PLANS[key] = plan(n, nterms, nptr, g,
                           lambda t: info(t)["blocks_per_sm"],
                           info(32)["sms"])
    return _PLANS[key]


def eval_sections_kernel(sections: List, n: int) -> torch.Tensor:
    """Kernel B10 (csrc/gather_sections.cu) on CUDA float32 tensors:
    (G, N) float32."""
    from . import _cuda
    w0 = _first_weight(sections)
    _cuda.check(w0, torch.float32, (n,), "weights")
    p = pack_sections(sections, n, w0.device)
    nptr = p.ptrs.numel()
    tile = _plan_on_card(n, p.nterms, nptr, p.g)
    out = torch.empty((p.g, n), dtype=torch.float32, device=w0.device)
    # p.operands (and any copy in it) stays referenced until the launch is
    # queued; the caching allocator is stream-ordered, so freeing them
    # afterwards is safe
    _cuda.launch("gather_sections", p.desc, p.desc.numel(), p.ptrs, nptr,
                 p.tab, n, p.g, tile, out)
    launches["gather_sections"] += 1
    return out


def eval_sections(sections: List, n: int) -> torch.Tensor:
    """The sum of the sections' weighted row lookups, (G, N) in the
    weights' dtype: the plain version on CPU tensors, kernel B10 on any
    other (which raises unless it is CUDA float32)."""
    if _first_weight(sections).device.type == "cpu":
        return eval_sections_plain(sections, n)
    return eval_sections_kernel(sections, n)
