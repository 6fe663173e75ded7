"""Look-up-table sampling of the cloud water PDF for McICA.

Port of ecrad_tpu/solvers/pdf_sampler.py:51-143 (radiation_pdf_sampler.F90):
a 2-D table (cdf x fractional standard deviation -> optical-depth
scaling), sampled bilinearly (`sample_pdf`), and the JAX package's fast
path, which refits each fsd row's quantile curve at setup as a Chebyshev
series of ln(x) in z = ndtri(cdf) and evaluates it with Clenshaw's
recurrence (`sample_pdf_fast`). The fit is the same numpy/scipy code, so
both packages hold the same coefficients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import RadiationConfig
from ..io.netcdf import NetcdfFile

CHEB_DEGREE = 16
CDF_MIN = 1.0e-4  # fitted/clamped cdf range; the uniforms lie in [0, 1)
CDF_MAX = 1.0 - 1.0e-4


@dataclass
class PdfSampler:
    val: np.ndarray            # (ncdf, nfsd)
    fsd1: float
    inv_fsd_interval: float
    cheb: Optional[np.ndarray] = None   # (nfsd, CHEB_DEGREE+1) float32
    z0: float = 0.0
    z1: float = 0.0

    @property
    def ncdf(self):
        return self.val.shape[0]

    @property
    def nfsd(self):
        return self.val.shape[1]


def _fit_chebyshev(val: np.ndarray) -> tuple:
    """ln(x_row(cdf)) as a Chebyshev series in z = ndtri(cdf) per fsd row,
    fitted to the table's own linear interpolation on u_i = i/(ncdf-1),
    weighted by sqrt(max(x, 1e-4)) (ecrad_tpu/solvers/pdf_sampler.py:51)."""
    from scipy.special import ndtr, ndtri
    ncdf, nfsd = val.shape
    u_grid = np.linspace(0.0, 1.0, ncdf)
    z0, z1 = float(ndtri(CDF_MIN)), float(ndtri(CDF_MAX))
    z = np.linspace(z0, z1, 4001)
    u = ndtr(z)
    t = (2.0 * z - (z0 + z1)) / (z1 - z0)
    cheb = np.zeros((nfsd, CHEB_DEGREE + 1))
    for j in range(nfsd):
        x = np.interp(u, u_grid, val[:, j])
        lnx = np.log(np.maximum(x, 1e-12))
        w = np.sqrt(np.maximum(x, 1e-4))
        cheb[j] = np.polynomial.chebyshev.chebfit(t, lnx, CHEB_DEGREE, w=w)
    return cheb.astype(np.float32), z0, z1


def setup_pdf_sampler(config: RadiationConfig) -> PdfSampler:
    with NetcdfFile(config.cloud_pdf_file) as f:
        fsd = f.read("fsd")
        val = f.read("x")
    if val.shape[0] == len(fsd):      # stored (nfsd, ncdf)
        val = val.T
    cheb, z0, z1 = _fit_chebyshev(val)
    return PdfSampler(val=val, fsd1=float(fsd[0]),
                      inv_fsd_interval=float(1.0 / (fsd[1] - fsd[0])),
                      cheb=cheb, z0=z0, z1=z1)


def pdf_table(sampler: PdfSampler, dtype, device) -> torch.Tensor:
    """The table the sampler reads on the device: the Chebyshev table
    (float32) where the sampler has one, else `val` in `dtype`."""
    if sampler.cheb is not None:
        return torch.as_tensor(sampler.cheb, device=device)
    return torch.as_tensor(sampler.val, dtype=dtype, device=device)


def sample_pdf(sampler: PdfSampler, fsd, cdf, val):
    """Bilinear table sample (radiation_pdf_sampler.F90:123-155); fsd and
    cdf broadcast against each other; val the pdf_table, in their
    dtype."""
    ncdf, nfsd = sampler.val.shape
    wcdf = cdf * (ncdf - 1) + 1.0
    icdf = torch.clamp(torch.floor(wcdf).to(torch.int32), 1, ncdf - 1)
    wcdf = torch.clamp(wcdf - icdf, 0.0, 1.0)
    wfsd = (fsd - sampler.fsd1) * sampler.inv_fsd_interval + 1.0
    ifsd = torch.clamp(torch.floor(wfsd).to(torch.int32), 1, nfsd - 1)
    wfsd = torch.clamp(wfsd - ifsd, 0.0, 1.0)
    flat = val.reshape(-1)
    i00 = ((icdf - 1) * nfsd + (ifsd - 1)).long()
    v00, v01 = flat[i00], flat[i00 + 1]
    v10, v11 = flat[i00 + nfsd], flat[i00 + nfsd + 1]
    return ((1.0 - wcdf) * (1.0 - wfsd) * v00
            + (1.0 - wcdf) * wfsd * v01
            + wcdf * (1.0 - wfsd) * v10
            + wcdf * wfsd * v11)


def sample_pdf_fast(sampler: PdfSampler, fsd, cdf, cheb):
    """Chebyshev-in-z evaluation of the PDF quantile. fsd (ncol, nlev),
    constant over g; cdf (ncol, nlev, ng); cheb the pdf_table. Returns
    (ncol, nlev, ng)."""
    cheb = cheb.to(cdf.dtype)
    nfsd = sampler.nfsd
    z = torch.special.ndtri(torch.clamp(cdf, CDF_MIN, CDF_MAX))
    t = torch.clamp((2.0 * z - (sampler.z0 + sampler.z1))
                    / (sampler.z1 - sampler.z0), -1.0, 1.0)
    wfsd = (fsd - sampler.fsd1) * sampler.inv_fsd_interval
    ifsd = torch.clamp(torch.floor(wfsd).to(torch.int32), 0, nfsd - 2)
    w = torch.clamp(wfsd - ifsd, 0.0, 1.0)[..., None]
    ifsd = ifsd.long()
    c0, c1 = cheb[ifsd], cheb[ifsd + 1]            # (ncol, nlev, D+1)

    def clenshaw(c):
        b1 = torch.zeros_like(t)
        b2 = torch.zeros_like(t)
        for k in range(CHEB_DEGREE, 0, -1):
            b1, b2 = c[..., k, None] + 2.0 * t * b1 - b2, b1
        return c[..., 0, None] + t * b1 - b2

    return (1.0 - w) * torch.exp(clenshaw(c0)) + w * torch.exp(clenshaw(c1))
