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
(family, grid offset, eta offset). The kernel sums
in the same order, builds with -fmad=false and rounds gw*ew before the
product, so it matches its plain version bit for bit. `eval_sections`
runs the plain version on CPU tensors and the kernel on any other (which
raises unless it is CUDA float32).

On the H100 the kernel is bound by bytes: it reads each row and weight
once and writes each output once; the tables (at most 256 KiB per call)
stay in L1/L2. One thread per cell stages its terms (table offset,
weight) in shared memory and sums them for each g, storing the (G, N)
output coalesced along N. It is one launch per call, the sections' tables
concatenated into one buffer and described by a small int32 descriptor
passed by value. Not done yet (a later PR): staging small tables in
shared memory, fusing the LW path's two zero-padded halves, and the
separable contraction of an EtaSection.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

#: launches of the CUDA kernel (incremented only where it is launched)
launches = {"gather_sections": 0}

#: length of the kernel's by-value descriptor (csrc/gather_sections.cu)
MAX_DESC = 512
PLAIN, ETA = 0, 1


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


_TABLES = {}


def table_tensor(table, dtype, device) -> torch.Tensor:
    """`table` as a tensor of dtype on device. A numpy table is copied
    to the device once per content (the per-band path rebuilds its numpy
    tables on every call, as the JAX package does)."""
    if isinstance(table, torch.Tensor):
        return table.to(device=device, dtype=dtype)
    arr = np.ascontiguousarray(table)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, str(device))
    tab = _TABLES.get(key)
    if tab is None:
        tab = _TABLES[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return tab


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


def pack_sections(sections: List, n: int, device):
    """The kernel's operands: (descriptor (int32, host), rows (KR, N)
    int32, weights (KW, N) float32, flat float32 table, G, number of
    terms). Descriptor: the number of sections, then per section
      plain: PLAIN, table offset, R, K, first row, first weight;
      eta:   ETA, table offset, R1*R2, R2, number of families, then per
             family: grid row, eta row, n_go, first gw, n_eo, first ew,
             the n_go grid offsets, the n_eo eta offsets;
    "row"/"weight" index the stacked rows/weights, table offsets count
    elements of the flat table."""
    f32 = torch.float32
    desc, rows, weights, tabs = [len(sections)], [], [], []
    off, g, nterms = 0, None, 0
    for sec in sections:
        tab = table_tensor(sec.table, f32, device)
        g = tab.shape[-1] if g is None else g
        if tab.shape[-1] != g:
            raise ValueError("every section's table needs the same G")
        if isinstance(sec, EtaSection):
            r1, r2, _ = tab.shape
            desc += [ETA, off, r1 * r2, r2, len(sec.grids)]
            for fam in range(len(sec.grids)):
                gts, ets = sec.grid_terms[fam], sec.eta_terms[fam]
                desc += [len(rows), len(rows) + 1, len(gts), len(weights),
                         len(ets), len(weights) + len(gts)]
                desc += [int(o) for o, _ in gts] + [int(o) for o, _ in ets]
                rows += [sec.grids[fam], sec.etas[fam]]
                weights += [w for _, w in gts] + [w for _, w in ets]
                nterms += len(gts) * len(ets)
        else:
            k = len(sec.rows)
            desc += [PLAIN, off, tab.shape[0], k, len(rows), len(weights)]
            rows += list(sec.rows)
            weights += list(sec.weights)
            nterms += k
        tabs.append(tab.reshape(-1))
        off += tabs[-1].numel()
    if len(desc) > MAX_DESC:
        raise ValueError(f"section list too long for the kernel's "
                         f"descriptor ({len(desc)} > {MAX_DESC} ints)")
    rows_t = torch.stack([r.to(device=device, dtype=torch.int32)
                          for r in rows]).contiguous()
    w_t = torch.stack([w.to(device=device, dtype=f32)
                       for w in weights]).contiguous()
    return (torch.tensor(desc, dtype=torch.int32), rows_t, w_t,
            torch.cat(tabs), g, nterms)


def eval_sections_kernel(sections: List, n: int) -> torch.Tensor:
    """Kernel B10 (csrc/gather_sections.cu) on CUDA float32 tensors:
    (G, N) float32."""
    from . import _cuda
    w0 = _first_weight(sections)
    _cuda.check(w0, torch.float32, (n,), "weights")
    desc, rows, w, tab, g, nterms = pack_sections(sections, n, w0.device)
    _cuda.check(rows, torch.int32, (rows.shape[0], n), "rows")
    _cuda.check(w, torch.float32, (w.shape[0], n), "weights")
    out = torch.empty((g, n), dtype=torch.float32, device=w0.device)
    _cuda.launch("gather_sections", desc, rows, w, tab, n, g, nterms,
                 desc.numel(), out)
    launches["gather_sections"] += 1
    return out


def eval_sections(sections: List, n: int) -> torch.Tensor:
    """The sum of the sections' weighted row lookups, (G, N) in the
    weights' dtype: the plain version on CPU tensors, kernel B10 on any
    other (which raises unless it is CUDA float32)."""
    if _first_weight(sections).device.type == "cpu":
        return eval_sections_plain(sections, n)
    return eval_sections_kernel(sections, n)
