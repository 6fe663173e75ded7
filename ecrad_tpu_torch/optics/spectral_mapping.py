"""Mapping of user albedo/emissivity intervals to spectral bands.

Port of ecrad_tpu/optics/spectral_mapping.py
(radiation_config.F90:1374-1560, radiation_single_level.F90:204-330):
`interval_mapping` is numpy at setup time, `expand_to_g` maps
(ncol, nintervals) values to (ncol, ng) tensors; `single_g_mapping` is the
monochromatic model's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .rrtmg.gas_optics import GasOpticsSpec, spec_from_arrays


def interval_mapping(wavelength_bound: Tuple[float, ...],
                     i_intervals: Tuple[int, ...],
                     wavenumber1: np.ndarray, wavenumber2: np.ndarray,
                     do_nearest: bool
                     ) -> Tuple[Optional[np.ndarray],
                                Optional[np.ndarray]]:
    """Returns (i_mapping, weights): nearest-neighbour band->interval map
    (0-based) or overlap weights (nvalue, nband); the unused one is None.
    """
    nband = len(wavenumber1)
    ninterval = 0
    for idx in i_intervals:
        if idx and idx > 0:
            ninterval += 1
        else:
            break
    if ninterval < 2:
        return np.zeros(nband, dtype=int), None

    bounds = np.asarray(wavelength_bound[:ninterval - 1], dtype=float)
    idxs = np.asarray(i_intervals[:ninterval], dtype=int)
    if not np.all(np.diff(bounds) > 0):
        raise ValueError("wavelength bounds must be increasing")
    nvalue = int(idxs.max())

    if do_nearest:
        mapping = np.zeros(nband, dtype=int)
        for jband in range(nband):
            wn_mid = 0.5 * (wavenumber1[jband] + wavenumber2[jband])
            iint = 0
            wn_bound = 0.01 / bounds[iint]
            while wn_bound >= wn_mid and iint < ninterval - 1:
                iint += 1
                wn_bound = 0.01 / bounds[iint] if iint < ninterval - 1 \
                    else 0.0
            mapping[jband] = idxs[iint] - 1
        return mapping, None

    weights = np.zeros((nvalue, nband))
    for jband in range(nband):
        recip_dwn = 1.0 / (wavenumber2[jband] - wavenumber1[jband])
        iint = 0
        wn1_alb = 0.01 / bounds[iint]
        while wn1_alb >= wavenumber2[jband] and iint < ninterval - 1:
            iint += 1
            wn1_alb = (0.01 / bounds[iint] if iint < ninterval - 1
                       else 0.0)
        wn2_alb = wavenumber2[jband]
        while wn2_alb > wavenumber1[jband] and iint <= ninterval - 1:
            weights[idxs[iint] - 1, jband] += recip_dwn * (
                min(wn2_alb, wavenumber2[jband])
                - max(wn1_alb, wavenumber1[jband]))
            wn2_alb = wn1_alb
            iint += 1
            if iint < ninterval - 1:
                wn1_alb = 0.01 / bounds[iint]
            else:
                wn1_alb = 0.0
    return None, weights


def expand_to_g(values: torch.Tensor, mapping: Optional[torch.Tensor],
                weights: Optional[torch.Tensor],
                band_from_g: torch.Tensor) -> torch.Tensor:
    """Map interval values (ncol, nintervals) to per-g (ncol, ng), by
    nearest interval (mapping: band -> interval) or overlap weights
    (weights: (nvalue, nband) in values' dtype), each on values' device.
    The weighted sum is an explicit multiply-add, not a matmul, so TF32
    can never round the albedos."""
    if weights is not None:
        band_vals = (values[:, :weights.shape[0], None]
                     * weights[None]).sum(1)
    else:
        band_vals = values[:, mapping]
    return band_vals[:, band_from_g]


def single_g_mapping() -> Tuple[GasOpticsSpec, np.ndarray]:
    """(spec, interval map) of the monochromatic model
    (ecrad_tpu/interface.py:52-63): one band and one g-point in each
    spectral region, in the identity order, and the first albedo or
    emissivity interval mapped to it (the same map serves both
    regions)."""
    one = np.zeros(1, dtype=int)
    return spec_from_arrays(one, one), one
