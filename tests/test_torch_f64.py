"""PyTorch port at float64 against the JAX package at float64.

At float64 the conditioning that limits the float32 comparisons (thin
layers, log and exp ulps) sits far below the bounds, so the port must
reproduce the JAX package to 1e-9 of each output's range: the two-stream
layer optics, the plain B3 sweeps, and the whole Cloudless slice in both
level orientations. `jax_enable_x64` is process-global, so the JAX side
runs once, in a subprocess (as tests/test_f64_validation.py does).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

from test_torch_adding import (_layers, _lw_args, _sw_args,  # noqa: E402
                               two_stream_cases)
from ecrad_tpu_torch.config import cloudless_slice_config  # noqa: E402
from ecrad_tpu_torch.convert import columns_to_inputs  # noqa: E402
from ecrad_tpu_torch.inputs import make_columns, reverse_levels  # noqa: E402
from ecrad_tpu_torch.interface import radiation, setup_radiation  # noqa: E402
from ecrad_tpu_torch.solvers import adding, two_stream  # noqa: E402

NCOL, NLEV, SEED = 6, 20, 0
TOL = 1e-9

SCRIPT = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
repo, out_path = sys.argv[1], sys.argv[2]
for p in (repo, os.path.join(repo, "tests"), os.path.join(repo, "tools")):
    sys.path.insert(0, p)
from test_torch_adding import _layers, _lw_args, _sw_args, two_stream_cases
from test_torch_f64 import NCOL, NLEV, SEED
from ecrad_tpu.solvers import adding, two_stream
from ecrad_tpu_torch.inputs import make_columns, reverse_levels
import make_torch_port_golden as golden

f64 = lambda v: jnp.asarray(v, jnp.float64)
out = {}
for name, vals in two_stream_cases(_layers(0), two_stream, f64).items():
    for i, v in enumerate(vals):
        out[f"ts/{name}/{i}"] = np.asarray(v)
sw = _sw_args(3)
res = adding._adding_sw_sequential(*map(f64, sw[:-1]), f64(sw[-1])[None, :],
                                   gfirst=True)
out.update({f"sw_adding/{i}": np.asarray(v) for i, v in enumerate(res)})
res = adding.lw_no_scattering_fluxes(*map(f64, _lw_args(3)), gfirst=True)
out.update({f"lw_noscat/{i}": np.asarray(v) for i, v in enumerate(res)})
cols = make_columns(NCOL, NLEV, SEED)
for orient, flux in zip(("toa_first", "surface_first"), golden.jax_fluxes(
        "float64", cols, reverse_levels(cols), fields=None)):
    out.update({f"radiation_{orient}/{k}": v for k, v in flux.items()})
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("f64") / "jax64.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", SCRIPT, REPO, out],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("name", ["sw_gammas", "sw_reftrans", "lw_gammas",
                                  "lw_reftrans",
                                  "lw_no_scattering_transmittance"])
def test_two_stream_f64(jax64, name):
    got = two_stream_cases(
        _layers(0), two_stream,
        lambda v: torch.as_tensor(v, dtype=torch.float64))[name]
    for i, g in enumerate(got):
        ref = jax64[f"ts/{name}/{i}"]
        assert g.dtype == torch.float64 and ref.dtype == np.float64
        assert _rel(g.numpy(), ref) <= TOL, (name, i)


@pytest.mark.parametrize("name, fn, args", [
    ("sw_adding", adding.adding_sw, _sw_args(3)),
    ("lw_noscat", adding.lw_no_scattering_fluxes, _lw_args(3))])
def test_b3_plain_f64(jax64, name, fn, args):
    got = fn(*(torch.as_tensor(a, dtype=torch.float64) for a in args))
    for i, g in enumerate(got):
        assert _rel(g.numpy(), jax64[f"{name}/{i}"]) <= TOL, (name, i)


@pytest.mark.parametrize("orient", ["toa_first", "surface_first"])
def test_slice_f64(jax64, orient):
    cols = make_columns(NCOL, NLEV, SEED)
    if orient == "surface_first":
        cols = reverse_levels(cols)
    setup = setup_radiation(cloudless_slice_config(dtype="float64"),
                            device="cpu")
    flux = radiation(setup, *columns_to_inputs(cols, device="cpu",
                                               dtype=torch.float64))
    prefix = f"radiation_{orient}/"
    ref = {k[len(prefix):]: v for k, v in jax64.items()
           if k.startswith(prefix)}
    got = dict(flux.fields())
    assert set(got) == set(ref)
    bad = {k: _rel(v.numpy(), ref[k]) for k, v in got.items()
           if not (v.dtype == torch.float64
                   and _rel(v.numpy(), ref[k]) <= TOL)}
    assert not bad, bad
