"""Comparing and plotting driver outputs (numpy; matplotlib for the
plots), without the JAX package."""
from .compare import compare_outputs, format_report
from .io import derive_fields, load_fluxes, load_inputs

__all__ = ["load_fluxes", "load_inputs", "derive_fields",
           "compare_outputs", "format_report"]
