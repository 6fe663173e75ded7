"""Cumulative cloud cover under the three overlap schemes.

Port of ecrad_tpu/solvers/cloud_cover.py:28-239 (radiation_cloud_cover.F90:
beta->alpha :49, Max-Ran :121, Exp-Ran :181, Exp-Exp :283). frac is
(ncol, nlev), overlap_param (ncol, nlev-1); each scheme returns
(cum_cloud_cover (ncol, nlev), pair_cloud_cover (ncol, nlev-1)).

Exp-Exp finds cloud "objects" (a run of cloudy layers, split where the
fraction rises again after falling) and merges neighbouring objects in
order of decreasing overlap. The JAX package vmaps a per-column scan and
while-loop; here every column runs at once: the object labelling and the
within-object cover are Python loops over levels of (ncol,) tensors, the
per-object extents are scatter_reduce's over (ncol, nobj_max) slots, and
the ordered merges loop until no column has more than one active object,
each pass merging one pair in every column that still has two.
"""
from __future__ import annotations

import torch

from ..utils import hooks

MAX_CLOUD_FRAC = 1.0 - 1.2e-6  # float32 counterpart of 1-10*eps
MIN_FRAC = 1.0e-6


def beta2alpha(beta, frac1, frac2):
    """Shonk et al. beta -> Hogan-Illingworth alpha (:49)."""
    frac_diff = torch.abs(frac1 - frac2)
    alpha = beta + (1.0 - beta) * frac_diff / (
        frac_diff + 1.0 / torch.clamp(beta, min=1e-12) - 1.0)
    return torch.where(beta < 1.0, alpha, torch.ones_like(alpha))


def _pair_cloud_cover(frac, overlap_param, is_beta):
    f1, f2 = frac[:, :-1], frac[:, 1:]
    alpha = beta2alpha(overlap_param, f1, f2) if is_beta else overlap_param
    pcc = (alpha * torch.maximum(f1, f2)
           + (1.0 - alpha) * (f1 + f2 - f1 * f2))
    return pcc, alpha


def _cum_from_pair(frac, pcc):
    """cum(1) = frac(1); cum(l+1) = 1 - (1-cum(l))(1-pcc(l))/(1-frac(l)),
    saturating at overcast layers."""
    fa = frac[:, :-1]
    ratio = torch.where(fa >= MAX_CLOUD_FRAC, torch.zeros_like(fa),
                        (1.0 - pcc) / torch.clamp(1.0 - fa, min=1e-12))
    start = 1.0 - frac[:, :1]
    return 1.0 - torch.cat([start, start * torch.cumprod(ratio, dim=1)], 1)


def cum_cloud_cover_max_ran(frac):
    """Maximum-random overlap (:121): pair cover max(f1, f2)."""
    pcc = torch.maximum(frac[:, :-1], frac[:, 1:])
    return _cum_from_pair(frac, pcc), pcc


def cum_cloud_cover_exp_ran(frac, overlap_param, is_beta=False):
    """Exponential-random overlap (:181)."""
    pcc, _ = _pair_cloud_cover(frac, overlap_param, is_beta)
    return _cum_from_pair(frac, pcc), pcc


def _more_to_merge(n_active) -> bool:
    """Whether a column still holds two objects to merge: read on the
    host (a sync) before each merge pass and once after the last."""
    return hooks.sync("cover_merge", bool, (n_active > 1).any())


def cum_cloud_cover_exp_exp(frac, overlap_param, is_beta=False):
    """Exponential-exponential overlap (:283), all columns at once."""
    pcc, alpha = _pair_cloud_cover(frac, overlap_param, is_beta)
    ncol, nlev = frac.shape
    dev, dt = frac.device, frac.dtype
    nobj_max = (nlev + 1) // 2 + 1
    big = nlev + 10
    levels = torch.arange(nlev, device=dev)
    slot = torch.arange(nobj_max, device=dev)[None, :]
    zero_b = torch.zeros((ncol,), dtype=torch.bool, device=dev)

    cloudy = frac > MIN_FRAC
    prev_frac = torch.cat([torch.zeros_like(frac[:, :1]), frac[:, :-1]], 1)

    # label the objects: a new one at cloud onset, or where the fraction
    # rises again after a descent within a run
    in_obj, desc = zero_b, zero_b
    obj_id = torch.full((ncol,), -1, dtype=torch.long, device=dev)
    ids, descs = [], []
    for lev in range(nlev):
        c, f, fp = cloudy[:, lev], frac[:, lev], prev_frac[:, lev]
        was = cloudy[:, lev - 1] if lev > 0 else zero_b
        new_obj = c & (~was | ~in_obj | (desc & (f > fp)))
        obj_id = torch.where(new_obj, obj_id + 1, obj_id)
        desc = torch.where(new_obj, zero_b,
                           torch.where(c & in_obj & (f < fp),
                                       torch.ones_like(desc), desc))
        in_obj = c
        ids.append(obj_id)
        descs.append(desc)
    obj_id_lev, desc_lev = torch.stack(ids, 1), torch.stack(descs, 1)
    obj_of_lev = torch.where(cloudy, obj_id_lev, nobj_max)
    nobj = torch.where(cloudy, obj_id_lev, -1).max(1).values + 1   # (ncol,)

    lev2 = levels.expand(ncol, nlev)

    def segment(values, init, reduce):
        out = torch.full((ncol, nobj_max + 1), init, dtype=torch.long,
                         device=dev)
        return out.scatter_reduce(1, obj_of_lev, values, reduce)[:, :nobj_max]

    valid_obj = slot < nobj[:, None]
    neg = torch.full_like(lev2, -1)
    i_top = segment(lev2, big, "amin")
    i_base = segment(torch.where(cloudy, lev2, neg), -1, "amax")
    # i_max: the last ascending level of the object
    i_max = segment(torch.where(cloudy & ~desc_lev, lev2, neg), -1, "amax")
    bigt = torch.full_like(i_top, big)
    i_top = torch.where(valid_obj, i_top, bigt)
    i_base = torch.where(valid_obj, i_base, bigt)
    i_max = torch.where(valid_obj, i_max, bigt)

    # overlap of each object with the next: the product of alpha over
    # [i_max(j), i_max(j+1)) (alpha[l] couples levels l and l+1)
    safe = torch.clamp(alpha, min=1e-35)
    logcum = torch.cat([torch.zeros_like(frac[:, :1]),
                        torch.cumsum(torch.log(safe), 1)], 1)
    zerocum = torch.cat([torch.zeros((ncol, 1), dtype=torch.long,
                                     device=dev),
                         torch.cumsum((alpha <= 0).long(), 1)], 1)
    i_max_next = torch.cat([i_max[:, 1:], bigt[:, :1]], 1)
    a_c = torch.clamp(i_max, 0, nlev - 1)
    b_c = torch.clamp(i_max_next, 0, nlev - 1)
    lp = logcum.gather(1, b_c) - logcum.gather(1, a_c)
    nz = zerocum.gather(1, b_c) - zerocum.gather(1, a_c)
    alpha_obj = torch.where(i_max_next <= i_max, torch.ones_like(lp),
                            torch.where(nz > 0, torch.zeros_like(lp),
                                        torch.exp(lp)))
    alpha_obj = torch.where(valid_obj, alpha_obj, torch.full_like(lp, -1.0))

    # within-object cumulative cover: the Exp-Ran recurrence restarting
    # at each object top
    at_top_lev = torch.zeros((ncol, nlev + 11), dtype=torch.bool,
                             device=dev)
    at_top_lev.scatter_(1, torch.where(valid_obj, i_top, bigt),
                        torch.ones_like(valid_obj))
    cum_prev = torch.zeros((ncol,), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    cums = []
    for lev in range(nlev):
        f_prev = prev_frac[:, lev]
        pcc_prev = pcc[:, lev - 1] if lev > 0 else torch.zeros_like(f_prev)
        cum_rec = torch.where(
            f_prev >= MAX_CLOUD_FRAC, one,
            1.0 - (1.0 - cum_prev) * (1.0 - pcc_prev)
            / torch.clamp(1.0 - f_prev, min=1e-12))
        cum_prev = torch.where(at_top_lev[:, lev], frac[:, lev],
                               torch.where(cloudy[:, lev], cum_rec, zero))
        cums.append(cum_prev)
    cum_cc = torch.stack(cums, 1)

    cc_obj = torch.where(valid_obj,
                         cum_cc.gather(1, torch.clamp(i_base, 0, nlev - 1)),
                         zero)

    # ---- ordered merging ----
    i_base_s = i_base
    i_next = (slot + 1).expand(ncol, nobj_max).clone()
    active = valid_obj.clone()
    n_active = nobj.clone()
    neg_inf = torch.full_like(alpha_obj, float("-inf"))
    col = torch.arange(ncol, device=dev)
    while _more_to_merge(n_active):
        hooks.count("cloud_cover.merge_passes")
        m = n_active > 1                                      # (ncol,)
        # the reference walks its linked list while the 1-based slot
        # index < remaining object count, so only active slots with
        # index + 1 < n_active are candidates
        candidate = active & valid_obj & (slot < (n_active - 1)[:, None])
        j = torch.where(candidate, alpha_obj, neg_inf).argmax(1)
        k = torch.clamp(i_next[col, j], max=nobj_max - 1)
        base_j, top_k, base_k = i_base_s[col, j], i_top[col, k], \
            i_base_s[col, k]
        cc_j, cc_k, a = cc_obj[col, j], cc_obj[col, k], alpha_obj[col, j]
        cc_base_j = cum_cc[col, torch.clamp(base_j, 0, nlev - 1)][:, None]
        gap = (lev2 > base_j[:, None]) & (lev2 < top_k[:, None])
        cum_new = torch.where(gap, cc_base_j, cum_cc)
        cc_pair = (a * torch.maximum(cc_j, cc_k)
                   + (1.0 - a) * (cc_j + cc_k - cc_j * cc_k))
        scaling = torch.clamp((cc_pair - cc_j)
                              / torch.clamp(cc_k, min=MIN_FRAC), 0.0, 1.0)
        inobj2 = (lev2 >= top_k[:, None]) & (lev2 <= base_k[:, None])
        cum_new = torch.where(inobj2, cc_base_j + cum_cc * scaling[:, None],
                              cum_new)
        cum_cc = torch.where(m[:, None], cum_new, cum_cc)
        at_j = (slot == j[:, None]) & m[:, None]
        at_k = (slot == k[:, None]) & m[:, None]
        cc_obj = torch.where(at_j, cc_pair[:, None], cc_obj)
        i_base_s = torch.where(at_j, base_k[:, None], i_base_s)
        alpha_obj = torch.where(at_j, alpha_obj[col, k][:, None], alpha_obj)
        i_next = torch.where(at_j, i_next[col, k][:, None], i_next)
        active = active & ~at_k
        n_active = torch.where(m, n_active - 1, n_active)

    # fill below the final base
    final_base = i_base_s[:, 0]
    has_cloud = (nobj > 0)[:, None]
    cc_final = cum_cc[col, torch.clamp(final_base, 0, nlev - 1)][:, None]
    cum_cc = torch.where(has_cloud & (lev2 > final_base[:, None]), cc_final,
                         cum_cc)
    cum_cc = torch.where(has_cloud, torch.clamp(cum_cc, max=1.0), zero)
    pcc_out = torch.maximum(pcc, frac[:, :-1] + cum_cc[:, 1:]
                            - cum_cc[:, :-1])
    return cum_cc, torch.where(has_cloud, pcc_out, zero)
