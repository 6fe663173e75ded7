"""PyTorch port of ecRad-TPU for NVIDIA Hopper GPUs.

A second package beside the JAX reference `ecrad_tpu`: the same config,
namelists, inputs and flux fields, with every Pallas kernel on the
ported path replaced by a CUDA kernel written for sm_90a (csrc/), each
beside a plain PyTorch version of the same function. It imports torch
and numpy, never jax. It runs the Cloudless, McICA, Homogeneous,
Tripleclouds and SPARTACUS solvers on RRTMG-IFS gas optics (all-band, or
per-band with ECRAD_FUSED_TAUMOL=0) or the monochromatic model, with
aerosols, the spectral and canopy outputs, from Python, from a host
model through `coupling.radiation_scheme`, or from NetCDF files through
the offline driver (`python -m ecrad_tpu_torch.driver`); see ROADMAP.md
for what follows.
"""
