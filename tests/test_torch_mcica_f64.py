"""PyTorch port: the McICA path at float64 against the JAX package at
float64.

At float64 both programs draw the same 64-bit uniforms
(tests/test_torch_threefry.py), so the cloud generators make identical
subcolumns and every flux field must agree to 1e-9 of its range, as the
Cloudless slice does (tests/test_torch_f64.py): the configurations of
tests/test_torch_mcica_slice.py on the same columns and synthetic LUTs
(both level orientations). `jax_enable_x64` is process-global, so the
JAX side runs in subprocesses (test_torch_mcica_slice.jax_runs).
"""
import dataclasses

import numpy as np
import pytest
import torch

from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.interface import (_cloud_stage, radiation,
                                       setup_radiation)
from ecrad_tpu_torch.solvers.cloud_generator import cloud_generator

from test_torch_mcica_slice import CONFIGS, columns, jax_runs

TOL = 1e-9


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    from test_torch_mcica_slice import SEED, write_synthetic_luts
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED)


@pytest.fixture(scope="module")
def jax64(luts, tmp_path_factory):
    return jax_runs("float64", luts, str(tmp_path_factory.mktemp("jax")))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("orient", ["toa_first", "surface_first"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mcica_f64_matches_jax(jax64, luts, name, orient):
    cfg = dataclasses.replace(CONFIGS[name](luts), dtype="float64")
    flux = radiation(setup_radiation(cfg, device="cpu"), *columns_to_inputs(
        columns()[orient], device="cpu", dtype=torch.float64))
    ref = {k.split("/")[1]: v for k, v in jax64[name].items()
           if k.startswith(orient + "/")}
    got = dict(flux.fields())
    assert set(got) == set(ref)
    bad = {k: _rel(v.numpy(), ref[k]) for k, v in got.items()
           if not (v.dtype == torch.float64
                   and _rel(v.numpy(), ref[k]) <= TOL)}
    assert not bad, bad


def test_mcica_f64_subcolumns_are_jaxs(jax64, luts):
    """The port's SW and LW cloud generators at float64, on the cloud
    the McICA path makes, give the JAX package's cloudy subcolumns."""
    setup = setup_radiation(dataclasses.replace(CONFIGS["mcica"](luts),
                                                dtype="float64"),
                            device="cpu")
    cfg = setup.config
    sl, th, _, cloud = columns_to_inputs(columns()["toa_first"],
                                         device="cpu", dtype=torch.float64)
    cloud, _ = _cloud_stage(setup, th, cloud, lambda x: x)
    for key, ng, offset in (("mask_sw", 112, 0), ("mask_lw", 140, 997)):
        od_scaling, _ = cloud_generator(
            ng, sl.iseed + offset, cfg.i_overlap_scheme,
            cfg.cloud_fraction_threshold, cloud.fraction,
            cloud.overlap_param, cfg.cloud_inhom_decorr_scaling,
            cloud.fractional_std, setup.pdf_sampler,
            table=setup.pdf_table)
        np.testing.assert_array_equal((od_scaling > 0).numpy(),
                                      jax64["mcica"][f"masks/{key}"],
                                      err_msg=key)
