"""Flat k-table buffers for the all-band taumol kernels (numpy only).

Port of build_lw_fused (ecrad_tpu/optics/rrtmg/taumol_lw_fused.py:129-365)
and build_sw_fused (taumol_sw_fused.py:91-193) for a row-gather kernel
rather than one-hot matmuls. Every table of a band is stored as its
native (rows, ng_band) block, the g values of one row contiguous, and all
blocks are concatenated into ONE flat float64 buffer. The kernel (and its
plain version) reads element `offset[table] + row * ng_band + g`.

Values follow what the JAX package feeds its own taumol, so the port
agrees with it at float64 too:
  - LW: every table rounded to float32 (the JAX per-band path pads its
    tables as float32; the fused path is float32 throughout). The
    per-g stratospheric factors of bands 4 and 7 (STRAT_G_SCALE) are
    folded into absb and kbo_mco2 as the exact product f32(table) *
    f32(factor); parity depends on them.
  - SW: k-tables, continua and Rayleigh coefficients in float64, the
    constant cross-sections and band-24 Rayleigh tables rounded to
    float32, as the JAX per-band path does.
Not ported: the bf16 [hi|lo|hi] `*_fold` tables (a TPU MXU trick) and
the ECRAD_TAUMOL_ETA_FOLD experiment tables.

Table ids: band tables sit at fixed slots (LW: absa, absb, self, for,
pfa, pfb at 16 * kind + band - 1; SW: absa, absb, self, for, rayl at
14 * kind + band - 16), followed by the named tables of LW_NAMED /
SW_NAMED. Copied from ecrad_tpu_torch/optics/rrtmg/fused_tables.py.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

F32 = np.float32

# ---- longwave --------------------------------------------------------
NG_LW_BAND = [10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2]
G_OFF_LW = [int(x) for x in np.concatenate([[0], np.cumsum(NG_LW_BAND)])]
ABSB_LW = (1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 14, 16)
PFB_LW = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 16)
STRAT_G_SCALE = {   # 1-based g within the band -> factor
    4: dict(zip(range(8, 15), (0.92, 0.88, 1.07, 1.1, 0.99, 0.88, 0.943))),
    7: dict(zip(range(6, 12), (0.92, 0.88, 1.07, 1.1, 0.99, 0.855))),
}
LW_KINDS = ("absa", "absb", "self", "for", "pfa", "pfb")
LW_NAMED = [
    "lw1_kao_mn2", "lw1_kbo_mn2", "lw3_kao_mn2o", "lw3_kbo_mn2o",
    "lw5_kao_mo3", "lw6_kao_mco2", "lw7_kao_mco2", "lw7_kbo_mco2",
    "lw8_kao_mco2", "lw8_kbo_mco2", "lw8_kao_mo3", "lw8_kao_mn2o",
    "lw8_kbo_mn2o", "lw9_kao_mn2o", "lw9_kbo_mn2o", "lw11_kao_mo2",
    "lw11_kbo_mo2", "lw13_kao_mco2", "lw13_kbo_mo3", "lw15_kao_mn2",
    "lw5_ccl4", "lw6_cfc11adj", "lw6_cfc12", "lw8_cfc12", "lw8_cfc22adj",
]
#: chi_mls ratios used by the LW body (taumol_lw_fused.py:296-316)
LW_CONSTS = [
    ("b3_refm_a", (1, 3), (2, 3)), ("b3_refm_b", (1, 13), (2, 13)),
    ("b5_refm_a", (1, 7), (2, 7)), ("b7_refm_a", (1, 3), (3, 3)),
    ("b9_refm_a", (1, 3), (6, 3)), ("b13_refm_a", (1, 1), (4, 1)),
    ("b15_refm_a", (4, 1), (2, 1)),
    ("pf3_a", (1, 9), (2, 9)), ("pf3_b", (1, 13), (2, 13)),
    ("pf4_a", (1, 11), (2, 11)), ("pf4_b", (3, 13), (2, 13)),
    ("pf5_a", (1, 5), (2, 5)), ("pf5_b", (3, 43), (2, 43)),
    ("pf7_a", (1, 3), (3, 3)), ("pf9_a", (1, 9), (6, 9)),
    ("pf12_a", (1, 10), (2, 10)), ("pf13_a", (1, 5), (4, 5)),
    ("pf15_a", (4, 1), (2, 1)), ("pf16_a", (1, 6), (6, 6)),
]

# ---- shortwave -------------------------------------------------------
SW_BANDS = list(range(16, 30))
NG_SW_BAND = [6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12]
G_OFF_SW = [int(x) for x in np.concatenate([[0], np.cumsum(NG_SW_BAND)])]
ETA_STRAT_SW = (17, 21, 28)
NOETA_STRAT_SW = (16, 18, 19, 20, 22, 24, 27, 29)
HAS_SELF_SW = (16, 17, 18, 19, 20, 21, 22, 23, 24, 29)
FOR_UNGATED_SW = (17, 20, 21)
SW_KINDS = ("absa", "absb", "self", "for", "rayl")
SW_NAMED = [
    "sw20_absch4", "sw22_ones", "sw24_abso3a", "sw24_abso3b",
    "sw25_abso3a", "sw25_abso3b", "sw29_absco2", "sw29_absh2o",
    "sw24_raylb",
]
#: SW body constants: strrat per band (0 where unused), then givfac23
SW_CONSTS = [f"strrat{b}" for b in SW_BANDS] + ["givfac23"]


class FlatTables(NamedTuple):
    """One flat float64 buffer plus per-table offsets (elements) and row
    counts, indexed by table id. An absent table has offset 0 and no
    rows, so any term on it has weight 0."""
    tab: np.ndarray          # (total,) float64
    off: np.ndarray          # (ntables,) int64
    nrows: np.ndarray        # (ntables,) int64
    names: List[str]         # table id -> name
    consts: np.ndarray       # body constants (LW_CONSTS / SW_CONSTS)

    def index(self, name: str) -> int:
        return self.names.index(name)


def _flatten(blocks: Dict[str, np.ndarray], names: List[str],
             consts) -> FlatTables:
    off = np.zeros(len(names), np.int64)
    nrows = np.zeros(len(names), np.int64)
    parts, pos = [], 0
    for i, name in enumerate(names):
        blk = blocks.get(name)
        if blk is None:
            continue
        blk = np.ascontiguousarray(blk, np.float64)
        off[i], nrows[i] = pos, blk.shape[0]
        parts.append(blk.reshape(-1))
        pos += blk.size
    return FlatTables(np.concatenate(parts), off, nrows, list(names),
                      np.asarray(consts, np.float64))


def lw_table_names() -> List[str]:
    return ([f"{kind}{b}" for kind in LW_KINDS for b in range(1, 17)]
            + LW_NAMED)


def sw_table_names() -> List[str]:
    return ([f"{kind}{b}" for kind in SW_KINDS for b in SW_BANDS]
            + SW_NAMED)


def _f32(x):
    return np.asarray(x, F32).astype(np.float64)


def _scaled(tab, band):
    """float32 table with the band's per-g strat factors folded in, kept
    as the exact float64 product."""
    tab = _f32(tab)
    for g_1b, f in STRAT_G_SCALE.get(band, {}).items():
        tab[..., g_1b - 1] *= np.float64(F32(f))
    return tab


def build_lw(t) -> FlatTables:
    blocks = {}
    for b in range(1, 17):
        ng = NG_LW_BAND[b - 1]
        blocks[f"absa{b}"] = _f32(t[f"lw{b}_absa"]).reshape(-1, ng)
        if b in ABSB_LW:
            blocks[f"absb{b}"] = _scaled(t[f"lw{b}_absb"], b).reshape(-1, ng)
        blocks[f"self{b}"] = _f32(t[f"lw{b}_selfref"])
        blocks[f"for{b}"] = _f32(t[f"lw{b}_forref"])
        fa = _f32(t[f"lw{b}_fracrefa"])
        blocks[f"pfa{b}"] = fa.T if fa.ndim == 2 else fa[None, :]
        if b == 6:
            blocks["pfb6"] = fa[None, :]     # band 6: A used everywhere
        elif b in PFB_LW:
            fb = _f32(t[f"lw{b}_fracrefb"])
            blocks[f"pfb{b}"] = fb.T if fb.ndim == 2 else fb[None, :]
    for name in LW_NAMED:
        tab = t[name]
        tab = _scaled(tab, 7) if name == "lw7_kbo_mco2" else _f32(tab)
        if tab.ndim == 1:                    # cross-section vector
            tab = tab[None, :]
        blocks[name] = tab.reshape(-1, tab.shape[-1])
    chi = np.asarray(t["chi_mls"], np.float64)
    consts = [chi[a[0] - 1, a[1] - 1] / chi[b[0] - 1, b[1] - 1]
              for _, a, b in LW_CONSTS]
    return _flatten(blocks, lw_table_names(), consts)


def build_sw(t) -> FlatTables:
    blocks = {}
    for b in SW_BANDS:
        ng = NG_SW_BAND[b - 16]
        if b != 26:
            blocks[f"absa{b}"] = np.asarray(t[f"sw{b}_absa"]).reshape(-1, ng)
        if b in ETA_STRAT_SW or b in NOETA_STRAT_SW:
            blocks[f"absb{b}"] = np.asarray(t[f"sw{b}_absb"]).reshape(-1, ng)
        if b in HAS_SELF_SW:
            blocks[f"self{b}"] = np.asarray(t[f"sw{b}_selfref"])
            blocks[f"for{b}"] = np.asarray(t[f"sw{b}_forref"])
        if b == 24:
            blocks["rayl24"] = _f32(t["sw24_rayla"]).T       # (9, ng)
        else:
            r = np.asarray(t[f"sw{b}_rayl"], np.float64)
            blocks[f"rayl{b}"] = np.broadcast_to(r, (ng,))[None, :]
    blocks["sw22_ones"] = np.ones((1, 2))
    for name in SW_NAMED:
        if name != "sw22_ones":
            blocks[name] = _f32(t[name])[None, :]
    strrat = {16: t["sw16_strrat1"]}
    for b in (17, 18, 19, 21, 22, 24, 28):
        strrat[b] = t[f"sw{b}_strrat"]
    consts = [float(strrat.get(b, 0.0)) for b in SW_BANDS]
    consts.append(float(t["sw23_givfac"]))
    return _flatten(blocks, sw_table_names(), consts)
