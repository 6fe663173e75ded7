"""Shared pieces of the LW and SW taumol plain versions.

Copied from ecrad_tpu_torch/optics/rrtmg/taumol_common.py. Both work in
two phases:
  1. per cell and band, a fixed number of TERMS: (base, weight) pairs,
     where base is the flat-table element offset of one table row;
  2. per (cell, g): out = sum_k weight_k * tab[base_k + g - g_off(band)].
A band's tropospheric and stratospheric lookups never both apply to one
cell, so they share term slots: slot k holds the tropospheric term in a
tropospheric cell and the stratospheric one otherwise. A term whose row
falls outside its table gets weight 0 (the one-hot semantics of the JAX
fused kernels).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .fused_tables import FlatTables

ONEMINUS = 1.0 - 1.0e-6

Term = Tuple[torch.Tensor, torch.Tensor]       # (base int64, weight)


class DeviceTables(NamedTuple):
    """A FlatTables buffer on a device in the compute dtype."""
    tab: torch.Tensor        # (total,)
    meta: torch.Tensor       # (2, ntables) int32: offsets, row counts
    consts: torch.Tensor     # (nconsts,)
    flat: FlatTables


def device_tables(flat: FlatTables, dtype, device) -> DeviceTables:
    return DeviceTables(
        tab=torch.as_tensor(flat.tab, dtype=dtype, device=device),
        meta=torch.as_tensor(np.stack([flat.off, flat.nrows]),
                             dtype=torch.int32, device=device),
        consts=torch.as_tensor(flat.consts, dtype=dtype, device=device),
        flat=flat)


class Terms:
    """Builds phase-1 terms over all cells of a flat (N,) batch."""

    def __init__(self, flat: FlatTables, like: torch.Tensor):
        self.flat = flat
        self.like = like
        self.zero = (torch.zeros_like(like, dtype=torch.int64),
                     torch.zeros_like(like))

    def term(self, name: str, ng: int, row, w, ok=None) -> Term:
        i = self.flat.index(name)
        valid = (row >= 0) & (row < int(self.flat.nrows[i]))
        if ok is not None:
            valid = valid & ok
        base = int(self.flat.off[i]) + torch.where(
            valid, row, torch.zeros_like(row)).to(torch.int64) * ng
        return base, torch.where(valid, w, torch.zeros_like(w))

    def const(self, name: str, ng: int, w) -> Term:
        return self.term(name, ng, torch.zeros_like(w, dtype=torch.int32),
                         w)

    def pair(self, name, ng, row0, w, frac, ok=None) -> List[Term]:
        """Linear interpolation between rows row0 and row0 + 1."""
        return [self.term(name, ng, row0, w * (1.0 - frac), ok),
                self.term(name, ng, row0 + 1, w * frac, ok)]

    def merge(self, tropo: torch.Tensor, t_terms: List[Term],
              s_terms: List[Term], nslots: int) -> List[Term]:
        """Slot k: t_terms[k] in tropospheric cells, s_terms[k] in the
        others; missing entries are zero terms."""
        assert len(t_terms) <= nslots and len(s_terms) <= nslots
        out = []
        for k in range(nslots):
            bt, wt = t_terms[k] if k < len(t_terms) else self.zero
            bs, ws = s_terms[k] if k < len(s_terms) else self.zero
            out.append((torch.where(tropo, bt, bs),
                        torch.where(tropo, wt, ws)))
        return out


def eta_index(col1, speccomb, mult):
    """(specparm, js, fs) of an eta interpolation with `mult` intervals
    (rrtm_taumol*.F90)."""
    specparm = torch.clamp(col1 / speccomb, max=ONEMINUS)
    specmult = mult * specparm
    js = torch.floor(specmult).to(torch.int32)
    return specparm, js, specmult - js.to(specmult.dtype)


def gather_sum(tab: torch.Tensor, terms: List[Term], ng: int, n: int
               ) -> torch.Tensor:
    """Phase 2 for one band: (n, ng) = sum_k w_k * tab[base_k + g]."""
    if not terms:
        return tab.new_zeros((n, ng))
    base = torch.stack([b for b, _ in terms], 1)            # (n, K)
    w = torch.stack([x for _, x in terms], 1)
    g = torch.arange(ng, device=tab.device)
    vals = tab[base[:, :, None] + g]                        # (n, K, ng)
    return (w[:, :, None] * vals).sum(1)
