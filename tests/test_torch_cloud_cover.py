"""PyTorch port: cumulative cloud cover (Max-Ran, Exp-Ran, Exp-Exp, beta
overlap) against the JAX package at float32.

The profiles mix make_clouds' decks (several objects per column, overcast
layers, cloud-free columns) with hand-made edge cases: a column with
many alternating objects, a rise after a descent inside one run, a
single cloudy layer at the top and at the surface, overcast runs.

Bound: 2e-6 absolute on covers in [0, 1]. Both programs run the same
float32 recurrences; the cumulative products and sums (XLA's cumsum and
cumprod against torch's sequential ones) may round differently by a few
ulps over ~30 levels.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ecrad_tpu.solvers import cloud_cover as jcc
from ecrad_tpu_torch.inputs import make_clouds, make_columns
from ecrad_tpu_torch.solvers import cloud_cover as pcc
from ecrad_tpu_torch.types import Cloud, Thermodynamics

NLEV = 30
TOL = 2e-6


def _profiles():
    cols = make_clouds(make_columns(12, NLEV, 2), 2)
    frac = cols["fraction"]
    rng = np.random.RandomState(8)
    edge = np.zeros((6, NLEV))
    edge[0, ::3] = rng.uniform(0.1, 0.9, NLEV)[::3]       # many objects
    edge[1, 5:15] = [0.2, 0.5, 0.3, 0.1, 0.4, 0.9, 0.6, 0.2, 0.7, 0.3]
    edge[2, 0] = 0.5                                       # top layer
    edge[2, -1] = 0.6                                      # surface layer
    edge[3, 10:20] = 1.0                                   # overcast run
    edge[3, 22:25] = [0.3, 1.0, 0.4]
    edge[4] = rng.uniform(0.0, 1.0, NLEV) * (rng.rand(NLEV) > 0.3)
    frac = np.concatenate([frac, edge]).astype(np.float32)
    th = Thermodynamics(
        pressure_hl=torch.as_tensor(np.concatenate(
            [cols["pressure_hl"], cols["pressure_hl"][:6]])),
        temperature_hl=torch.as_tensor(np.concatenate(
            [cols["temperature_hl"], cols["temperature_hl"][:6]])))
    z = torch.zeros(frac.shape, dtype=torch.float64)
    alpha = Cloud(q_liq=z, q_ice=z, re_liq=z, re_ice=z,
                  fraction=z).set_overlap_param(th, 2000.0).overlap_param
    return frac, alpha.numpy().astype(np.float32)


@pytest.fixture(scope="module")
def profiles():
    return _profiles()


def _check(got, ref):
    for a, b in zip(got, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.abs(a - b).max() <= TOL, np.abs(a - b).max()


@pytest.mark.parametrize("scheme, beta", [
    ("max_ran", False), ("exp_ran", False), ("exp_ran", True),
    ("exp_exp", False), ("exp_exp", True)])
def test_cloud_cover_matches_jax(profiles, scheme, beta):
    frac, alpha = profiles
    if scheme == "max_ran":     # takes no overlap parameter
        got = pcc.cum_cloud_cover_max_ran(torch.as_tensor(frac))
        ref = jcc.cum_cloud_cover_max_ran(jnp.asarray(frac))
    else:
        got = getattr(pcc, f"cum_cloud_cover_{scheme}")(
            torch.as_tensor(frac), torch.as_tensor(alpha), beta)
        ref = getattr(jcc, f"cum_cloud_cover_{scheme}")(
            jnp.asarray(frac), jnp.asarray(alpha), beta)
    _check(got, ref)
    cum = got[0].numpy()
    assert (np.diff(cum, axis=1) >= -1e-6).all()          # monotonic
    assert (cum[frac.max(1) == 0] == 0).all()
    np.testing.assert_allclose(cum[:, -1] >= frac.max(1) - 1e-6, True)


def test_beta2alpha_matches_jax(profiles):
    frac, alpha = profiles
    got = pcc.beta2alpha(torch.as_tensor(alpha), torch.as_tensor(
        frac[:, :-1]), torch.as_tensor(frac[:, 1:]))
    ref = jcc.beta2alpha(jnp.asarray(alpha), jnp.asarray(frac[:, :-1]),
                         jnp.asarray(frac[:, 1:]))
    _check([got], [ref])


def test_exp_exp_merges_objects_in_every_column(profiles):
    """The profiles do hold columns with several objects to merge: the
    Exp-Exp cover lies between maximum and random overlap of them."""
    frac, alpha = profiles
    cloudy = frac > 1e-6
    starts = (cloudy[:, 1:] & ~cloudy[:, :-1]).sum(1) + cloudy[:, 0]
    assert (starts >= 3).sum() >= 3
    cum = pcc.cum_cloud_cover_exp_exp(torch.as_tensor(frac),
                                      torch.as_tensor(alpha))[0].numpy()
    total = cum[:, -1]
    assert (total >= frac.max(1) - 1e-6).all()
    assert (total <= 1.0 - np.prod(1.0 - frac, axis=1) + 1e-6).all()
