"""PyTorch port: the McICA generator's random numbers are jax.random's, bit
for bit.

ecrad_tpu/solvers/cloud_generator.py draws per column with the chain
fold_in(PRNGKey(seed_offset), iseed) -> split(4) -> uniform((ng,)) and
uniform((nlev, ng)); ecrad_tpu_torch/utils/threefry.py reproduces it in
jax's threefry_partitionable mode (pinned below). Float32 runs here;
float64 (64 random bits per value) in a subprocess with jax_enable_x64,
which is process-global.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu_torch.solvers.cloud_generator import random_fields
from ecrad_tpu_torch.utils import threefry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ISEEDS = np.array([0, 1, 2, 3, 31, 997, 998, 1028, 12345, 2**31 - 1,
                   2**31 + 5, 2**32 - 1], np.int64)
NG, NLEV = 13, 7


def jax_chain(iseeds, offset, ng, nlev, dtype):
    """The JAX package's key chain and draws (cloud_generator.py:73-85)."""
    keys = jax.vmap(lambda s: jax.random.fold_in(
        jax.random.PRNGKey(offset), s))(jnp.asarray(iseeds, jnp.uint32))
    sub = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    draw = lambda i, shape: np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype))(sub[:, i]))
    return {"keys": np.asarray(keys).astype(np.int64),
            "sub": np.asarray(sub).astype(np.int64),
            "rand_top": draw(0, (ng,)), "rand_cloud": draw(1, (nlev, ng)),
            "u1": draw(2, (nlev, ng)), "u2": draw(3, (nlev, ng))}


def port_chain(iseeds, offset, ng, nlev, dtype):
    iseed = torch.as_tensor(iseeds)
    keys = threefry.fold_in(threefry.prng_key(offset), iseed)
    out = dict(zip(("rand_top", "rand_cloud", "u1", "u2"),
                   (x.numpy() for x in random_fields(iseed, ng, nlev, dtype,
                                                     offset))))
    return {"keys": keys.numpy(), "sub": threefry.split(keys, 4).numpy(),
            **out}


@pytest.mark.parametrize("offset", [0, 5])
def test_threefry_f32_is_bit_identical(offset):
    with jax.threefry_partitionable(True):
        ref = jax_chain(ISEEDS, offset, NG, NLEV, jnp.float32)
    got = port_chain(ISEEDS, offset, NG, NLEV, torch.float32)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_uniforms_are_in_unit_interval_and_differ_per_column():
    u = threefry.uniform(threefry.split(threefry.fold_in(
        threefry.prng_key(0), torch.arange(64)), 2)[:, 1], (50, 20))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert len({float(x) for x in u[:, 0, 0]}) == 64
    assert abs(float(u.mean()) - 0.5) < 0.01


SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[1])
from test_torch_threefry import ISEEDS, NG, NLEV, jax_chain
np.savez(sys.argv[2], **jax_chain(ISEEDS, 0, NG, NLEV, jnp.float64))
"""


def test_threefry_f64_is_bit_identical(tmp_path):
    out = str(tmp_path / "chain64.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", SCRIPT,
                          os.path.join(REPO, "tests"), out], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    got = port_chain(ISEEDS, 0, NG, NLEV, torch.float64)
    with np.load(out) as ref:
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
