"""PyTorch port: what kernels B7 and B9's designs rely on, pinned on their
plain versions (ecrad_tpu_torch/ops/spartacus_reftrans.py
lw_reftrans_levels_plain, ops/spartacus_adding.py lw_up_step,
lw_dn_step, lw_adding_sweeps_plain), on the CPU.

- B9 without multilayer effects stores only the diagonal of the albedo
  that enters each level going up. That is exact because every carry
  lw_up_step makes then has off-diagonals of exactly +0.0 (the carry
  entering at the surface, the caller's init_up, excluded).
- So the downward sweep, fed the albedos rebuilt from their diagonals
  above the bottom level and the caller's init_up below it, gives the
  plain sweeps' result bit for bit.
- B7's pass over every cell writes literal zeros where the plain version
  holds them: the off-diagonals of a fallback cell's R and T, and the
  cloudy regions' rows of a clear layer.

Inputs: the random case of tests/test_torch_spartacus_reftrans.py (7
levels, 16 g-points, 133 columns, clear layers, a 3D share of about 0.5),
random per-column rows (lw_pack_cols) and a full random albedo matrix and
source at the surface.
"""
import numpy as np
import pytest
import torch

from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.ops import spartacus_adding as pad
from ecrad_tpu_torch.ops import spartacus_reftrans as prt

from test_torch_spartacus_reftrans import case


def _inputs(nreg, dtype, scattering=False):
    """The LW history, the per-column rows and init_up of `nreg` regions."""
    c = case(nreg)
    t = lambda k: torch.as_tensor(c[k] if c[k].dtype == bool
                                  else c[k].astype(dtype))
    hist = prt.lw_reftrans_levels(8.0, scattering, t("od"), t("ssa"),
                                  t("g"), t("trd")[..., 0, :], t("se"),
                                  t("pt"), t("pb"), t("fr")[:, :, 0],
                                  t("use3d"), t("clear"))
    nlev, _, ng, ncol = hist.shape
    rng = np.random.RandomState(5)
    f = lambda *s: torch.as_tensor(rng.rand(*s).astype(dtype))
    clear = t("clear")
    cols = pad.lw_pack_cols(f(nlev + 1, nreg, nreg, ncol),
                            f(nlev + 1, nreg, nreg, ncol), clear,
                            torch.roll(clear, 1, 0), torch.roll(clear, -1, 0))
    init_up = torch.cat([f(nreg * nreg, ng, ncol) * 0.2,
                         f(nreg, ng, ncol) * 50])
    return c, hist, cols, init_up


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _offdiag(m, n):
    return torch.stack([m[i, j] for i in range(n) for j in range(n)
                        if i != j])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("use_matrix", [True, False])
@pytest.mark.parametrize("nreg", [3, 2])
def test_lw_up_step_carries_are_diagonal(nreg, use_matrix, dtype):
    """Without multilayer effects every carry an up step makes is diagonal,
    its off-diagonals +0.0, whatever the carry it was given."""
    cfg = pconfig.spartacus_slice_config(do_3d_lw_multilayer_effects=False)
    _, hist, cols, init_up = _inputs(nreg, dtype)
    n2 = nreg * nreg
    assert bool((_offdiag(pad._mats(init_up, 0, nreg), nreg) != 0).any())
    carry = init_up
    for l in range(hist.shape[0] - 1, -1, -1):
        carry, _ = pad.lw_up_step(cfg, use_matrix, nreg, carry, hist[l],
                                  cols[l])
        off = _offdiag(carry[:n2].reshape((nreg, nreg) + carry.shape[1:]),
                       nreg)
        assert bool((off == 0).all()), l
        assert not bool(torch.signbit(off).any()), l


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("use_matrix", [True, False])
@pytest.mark.parametrize("nreg", [3, 2])
def test_lw_sweeps_from_diagonal_scratch_are_bit_identical(nreg, use_matrix,
                                                           dtype):
    """B9's design without multilayer effects, on the plain steps: the
    downward sweep reads each level's albedo from its diagonal (literal
    +0.0 off the diagonal) and, below the bottom layer, the caller's full
    init_up. Equal bit for bit to lw_adding_sweeps_plain."""
    cfg = pconfig.spartacus_slice_config(do_3d_lw_multilayer_effects=False)
    _, hist, cols, init_up = _inputs(nreg, dtype)
    nlev, n, n2 = hist.shape[0], nreg, nreg * nreg
    carry, ys = init_up, [None] * nlev
    for l in range(nlev - 1, -1, -1):
        carry, ys[l] = pad.lw_up_step(cfg, use_matrix, n, carry, hist[l],
                                      cols[l])
    fdn = init_up.new_zeros((n,) + init_up.shape[1:])
    out = []
    for l in range(nlev):
        if l == nlev - 1:
            below = init_up
        else:
            diag = pad._diag(pad._mats(ys[l], 0, n))
            below = torch.cat([pad._flat(pad._diag_mat(diag)), ys[l][n2:]])
        fdn, o = pad.lw_dn_step(use_matrix, n, fdn, hist[l], below, cols[l])
        out.append(o)
    src_ref, out_ref = pad.lw_adding_sweeps_plain(cfg, use_matrix, hist,
                                                  cols, init_up)
    assert torch.equal(_bits(carry[n2:]), _bits(src_ref))
    assert torch.equal(_bits(torch.stack(out)), _bits(out_ref))


@pytest.mark.parametrize("scattering", [True, False])
@pytest.mark.parametrize("nreg", [3, 2])
def test_lw_reftrans_zeros_are_literal(nreg, scattering):
    """B7's plain version: the cloudy regions' rows of clear layers (R and
    T but (0, 0), SU and SD of regions 1..), and the off-diagonals of R
    and T in fallback cells, are exactly zero."""
    c, hist, _, _ = _inputs(nreg, "float32", scattering)
    n, n2 = nreg, nreg * nreg
    R = hist[:, :n2].reshape((-1, n, n) + hist.shape[2:])
    T = hist[:, n2:2 * n2].reshape((-1, n, n) + hist.shape[2:])
    su, sd = hist[:, 2 * n2:2 * n2 + n], hist[:, 2 * n2 + n:]
    clear = torch.as_tensor(c["clear"])[:, None, :]      # (nlev, 1, ncol)
    fallback = ~torch.as_tensor(c["use3d"])               # (nlev, ng, ncol)
    assert bool(clear.any()) and bool(fallback.any())
    for i in range(n):
        for j in range(n):
            if (i, j) != (0, 0):
                for M in (R, T):
                    assert bool((M[:, i, j][clear.expand_as(fallback)]
                                 == 0).all()), (i, j)
            if i != j:
                for M in (R, T):
                    assert bool((M[:, i, j][fallback] == 0).all()), (i, j)
    for r in range(1, n):
        for x in (su, sd):
            assert bool((x[:, r][clear.expand_as(fallback)] == 0).all()), r
    # and the rest is not zero: the 3D cells' off-diagonals
    assert bool((R[:, 0, 1][~fallback & ~clear.expand_as(fallback)]
                 != 0).any())
