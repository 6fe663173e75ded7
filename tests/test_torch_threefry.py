"""PyTorch port: the McICA generator's random numbers are jax.random's, bit
for bit.

ecrad_tpu/solvers/cloud_generator.py draws per column with the chain
fold_in(PRNGKey(seed_offset), iseed) -> split(4) -> uniform((ng,)) and
uniform((nlev, ng)); ecrad_tpu_torch/utils/threefry.py reproduces it in
jax's threefry_partitionable mode (pinned below). Float32 runs here;
float64 (64 random bits per value) in a subprocess with jax_enable_x64,
which is process-global. The card's kernel (ops/random_fields.py) is held
to the plain path in tests/test_torch_kernels_gpu.py; here, the key words
and seed words it is handed and the wrapper's choice of path.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu_torch.ops import random_fields as fields
from ecrad_tpu_torch.solvers.cloud_generator import random_fields
from ecrad_tpu_torch.utils import threefry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ISEEDS = np.array([0, 1, 2, 3, 31, 997, 998, 1028, 12345, 2**31 - 1,
                   2**31 + 5, 2**32 - 1], np.int64)
NG, NLEV = 13, 7
# seeds at the edges of 32 bits, for the key words and the seed words
EDGES = [0, 5, 2**31 - 1, 2**32 - 1, 2**32 + 5, -3]


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


@pytest.mark.parametrize("seed_offset", EDGES)
def test_kernel_key_words_are_prng_key(seed_offset):
    """The two unsigned words the kernel takes for PRNGKey(seed_offset)
    are threefry.prng_key's, and fit 32 bits."""
    words = fields.key_words(seed_offset)
    assert list(words) == threefry.prng_key(seed_offset).tolist()
    assert all(0 <= w <= threefry.MASK for w in words)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("seed_offset", [0, 5])
def test_kernel_seed_words_are_fold_in(dtype, seed_offset):
    """The kernel folds in each seed cast to uint32 (mod 2**32, as numpy's
    astype casts); from its key words that gives fold_in's keys."""
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    iseed = torch.tensor([e for e in EDGES if info.min <= e <= info.max],
                         dtype=dtype)
    words = torch.as_tensor(iseed.numpy().astype(np.uint32).astype(np.int64))
    assert torch.equal(words, iseed.to(torch.int64) & threefry.MASK)
    hi, lo = (torch.tensor(w) for w in fields.key_words(seed_offset))
    y0, y1 = threefry.threefry2x32(hi, lo, torch.zeros_like(words), words)
    assert torch.equal(torch.stack([y0, y1], -1), threefry.fold_in(
        threefry.prng_key(seed_offset), iseed))


@pytest.mark.parametrize("offset", [0, 5])
def test_cpu_random_fields_take_the_plain_path(offset):
    """On CPU tensors the wrapper launches nothing and draws jax.random's
    bits."""
    n0 = fields.launches
    got = fields.random_fields(torch.as_tensor(ISEEDS), NG, NLEV,
                               torch.float32, offset)
    assert fields.launches == n0 == 0
    with jax.threefry_partitionable(True):
        ref = jax_chain(ISEEDS, offset, NG, NLEV, jnp.float32)
    for k, v in zip(("rand_top", "rand_cloud", "u1", "u2"), got):
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fields.random_fields_kernel(torch.arange(4), NG, NLEV, torch.float32)
    with pytest.raises(TypeError):
        fields.random_fields(torch.arange(4), NG, NLEV, torch.int32)
    assert fields.launches == 0
