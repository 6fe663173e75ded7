"""Numeric comparison of two driver outputs on the same input.

Port of ecrad_tpu/analysis/compare.py (practical/compare_output.py and
practical/ecradplot/plot.py:1303 compare_output), numpy only: per flux
variable and heating rate the largest, mean absolute and RMS differences
and the bias, with an optional tolerance gate for regression checks.

    python -m ecrad_tpu_torch.analysis.compare input.nc reference_out.nc \
        test_out.nc [--tolerance 1.0]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np

from .io import derive_fields, load_fluxes, load_inputs

DEFAULT_VARS = (
    "flux_up_lw", "flux_dn_lw", "flux_up_sw", "flux_dn_sw",
    "flux_dn_direct_sw", "flux_up_lw_clear", "flux_dn_lw_clear",
    "flux_up_sw_clear", "flux_dn_sw_clear", "flux_dn_direct_sw_clear",
    "heating_rate_lw", "heating_rate_sw",
    "cloud_radiative_effect_lw", "cloud_radiative_effect_sw",
    "cloud_cover_lw", "cloud_cover_sw",
)


def compare_outputs(inputs: Dict, ref: Dict, test: Dict,
                    variables=DEFAULT_VARS) -> Dict[str, Dict[str, float]]:
    """Per-variable difference statistics of test vs ref."""
    ref_d = derive_fields(ref, inputs)
    test_d = derive_fields(test, inputs)
    stats = {}
    for var in variables:
        if var not in ref_d or var not in test_d:
            continue
        a = np.asarray(ref_d[var], np.float64)
        b = np.asarray(test_d[var], np.float64)
        if a.shape != b.shape:
            stats[var] = {"error": "shape mismatch"}
            continue
        d = b - a
        stats[var] = {
            "max_abs": float(np.abs(d).max()),
            "mean_abs": float(np.abs(d).mean()),
            "rms": float(np.sqrt((d ** 2).mean())),
            "bias": float(d.mean()),
            "ref_range": float(np.abs(a).max()),
        }
    return stats


def format_report(stats: Dict[str, Dict[str, float]]) -> str:
    lines = [f"{'variable':34s} {'max|d|':>10s} {'mean|d|':>10s} "
             f"{'rms':>10s} {'bias':>11s}"]
    for var, s in stats.items():
        if "error" in s:
            lines.append(f"{var:34s} {s['error']}")
            continue
        lines.append(f"{var:34s} {s['max_abs']:10.4f} "
                     f"{s['mean_abs']:10.4f} {s['rms']:10.4f} "
                     f"{s['bias']:11.5f}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ecrad_tpu_torch.analysis.compare",
        description="Compare two radiation outputs on the same input")
    ap.add_argument("input_nc")
    ap.add_argument("reference_nc")
    ap.add_argument("test_nc")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="fail (exit 1) if any flux max|d| exceeds this")
    args = ap.parse_args(argv)
    inputs = load_inputs(args.input_nc)
    ref = load_fluxes(args.reference_nc)
    test = load_fluxes(args.test_nc)
    stats = compare_outputs(inputs, ref, test)
    print(format_report(stats))
    if args.tolerance is not None:
        worst = max((s.get("max_abs", 0.0) for k, s in stats.items()
                     if k.startswith("flux_")), default=0.0)
        if worst > args.tolerance:
            print(f"FAIL: worst flux max|d| {worst:.3f} "
                  f"> tolerance {args.tolerance}")
            return 1
        print(f"PASS: worst flux max|d| {worst:.3f} "
              f"<= tolerance {args.tolerance}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
