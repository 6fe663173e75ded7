"""Plots of a driver output (matplotlib, imported only when a plot is
made).

Port of ecrad_tpu/analysis/plot.py (practical/ecradplot/plot.py
plot_output, plot_CRE, plot_heating_rate, plot_output_scalar and their
difference forms; practical/plot_output*.py): TOA and surface fluxes,
heating-rate cross-sections and the cloud radiative effect, each with an
optional reference to difference against.

    python -m ecrad_tpu_torch.analysis.plot input.nc output.nc out.png \
        [--reference ref_out.nc]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np

from .io import derive_fields, load_fluxes, load_inputs


def _latitude(inputs: Dict) -> np.ndarray:
    for key in ("latitude", "lat"):
        if key in inputs:
            return np.asarray(inputs[key])
    ncol = inputs["pressure_hl"].shape[0]
    return np.arange(ncol)


def plot_output(input_nc: str, output_nc: str, dstfile: str,
                reference_nc: Optional[str] = None) -> None:
    """Multi-panel overview: TOA/surface fluxes, heating rates, CRE
    (ecradplot/plot.py:1146 plot_output / :1303 compare_output)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    inputs = load_inputs(input_nc)
    ds = derive_fields(load_fluxes(output_nc), inputs)
    ref = (derive_fields(load_fluxes(reference_nc), inputs)
           if reference_nc else None)
    lat = _latitude(inputs)
    p_fl = inputs["pressure_fl"] / 100.0  # hPa

    fig, axes = plt.subplots(3, 2, figsize=(11, 10), sharex=True)

    # --- scalar panels: TOA and surface broadband fluxes ----------------
    ax = axes[0, 0]
    for var, style in (("flux_up_sw", "-"), ("flux_up_lw", "--")):
        if var in ds:
            ax.plot(lat, ds[var][:, 0], style, label=f"TOA {var}")
            if ref is not None:
                ax.plot(lat, ref[var][:, 0], style, alpha=0.4)
    ax.set_ylabel("TOA upwelling (W m$^{-2}$)")
    ax.legend(fontsize=7)

    ax = axes[0, 1]
    for var, style in (("flux_dn_sw", "-"), ("flux_dn_lw", "--")):
        if var in ds:
            ax.plot(lat, ds[var][:, -1], style, label=f"surface {var}")
            if ref is not None:
                ax.plot(lat, ref[var][:, -1], style, alpha=0.4)
    ax.set_ylabel("Surface downwelling (W m$^{-2}$)")
    ax.legend(fontsize=7)

    # --- zonal cross-sections: heating rates ----------------------------
    for j, band in enumerate(("lw", "sw")):
        ax = axes[1, j]
        var = f"heating_rate_{band}"
        if var in ds:
            field = ds[var] - (ref[var] if ref is not None else 0.0)
            vmax = max(np.abs(field).max(), 1e-6)
            pc = ax.pcolormesh(lat, p_fl[0], field.T, cmap="RdBu_r",
                               vmin=-vmax, vmax=vmax, shading="auto")
            fig.colorbar(pc, ax=ax, label="K day$^{-1}$")
        ax.invert_yaxis()
        ax.set_ylabel("Pressure (hPa)")
        suffix = " difference" if ref is not None else ""
        ax.set_title(f"{band.upper()} heating rate{suffix}", fontsize=9)

    # --- CRE -------------------------------------------------------------
    for j, band in enumerate(("lw", "sw")):
        ax = axes[2, j]
        var = f"cloud_radiative_effect_{band}"
        if var in ds:
            ax.plot(lat, ds[var][:, -1], label="surface")
            ax.plot(lat, ds[var][:, 0], label="TOA")
            if ref is not None:
                ax.plot(lat, ref[var][:, -1], alpha=0.4)
                ax.plot(lat, ref[var][:, 0], alpha=0.4)
        ax.set_title(f"{band.upper()} cloud radiative effect", fontsize=9)
        ax.set_ylabel("W m$^{-2}$")
        ax.set_xlabel("latitude / column")
        ax.legend(fontsize=7)

    fig.tight_layout()
    fig.savefig(dstfile, dpi=110)
    plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ecrad_tpu_torch.analysis.plot")
    ap.add_argument("input_nc")
    ap.add_argument("output_nc")
    ap.add_argument("dstfile")
    ap.add_argument("--reference", default=None)
    args = ap.parse_args(argv)
    plot_output(args.input_nc, args.output_nc, args.dstfile,
                reference_nc=args.reference)
    print(f"Wrote {args.dstfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
