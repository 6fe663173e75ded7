"""PyTorch port: kernels B8 and B9's plain versions
(ecrad_tpu_torch/ops/spartacus_adding.py) against the JAX package's
SPARTACUS adding sweeps (ecrad_tpu/ops/spartacus_adding.py), on the CPU.

- The plain steps (sw_up_step, sw_dn_step, lw_up_step, lw_dn_step) against
  the JAX package's kernel-form steps, level by level, at float64 (bound
  1e-10 of each output's largest value): all five entrapment treatments
  with 3D effects on and off, the LW matrix, diagonal and multilayer
  forms. 3 regions: the JAX kernel form has no other (2 regions run
  through the whole slice in tests/test_torch_spartacus.py).
- The plain sweeps against the JAX package's Pallas sweeps run in
  interpret mode (ECRAD_SPARTACUS_ADDING=interpret's path), at float32
  (2e-5 of each output's largest value, tests/test_spartacus_adding.py:63).

The histories are the port's plain reftrans of the random case of
tests/test_torch_spartacus_reftrans.py; the per-column rows are random
with the layout of pack_cols / lw_pack_cols.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecrad_tpu.ops import spartacus_adding as jad
from ecrad_tpu_torch import config as pconfig
from ecrad_tpu_torch.ops import spartacus_adding as pad
from ecrad_tpu_torch.ops import spartacus_reftrans as prt

from test_torch_spartacus_reftrans import case

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_torch_port_golden as golden  # noqa: E402

NREG = 3
ENTRAPMENTS = list(pconfig.Entrapment)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def inputs(dtype):
    """SW and LW histories, per-column rows and boundary values."""
    c = case(NREG)
    t = lambda k: torch.as_tensor(c[k] if c[k].dtype == bool
                                  else c[k].astype(dtype))
    hist = prt.sw_reftrans_levels(8.0, t("od"), t("ssa"), t("g"),
                                  t("trd")[..., 0, :], t("trf")[..., 0, :],
                                  t("mu0"), t("use3d"), t("clear"))
    lhist = prt.lw_reftrans_levels(8.0, False, t("od"), t("ssa"), t("g"),
                                   t("trd")[..., 0, :], t("se"), t("pt"),
                                   t("pb"), t("fr")[:, :, 0], t("use3d"),
                                   t("clear"))
    nlev, _, ng, ncol = hist.shape
    rng = np.random.RandomState(3)
    f = lambda *s: torch.as_tensor(rng.rand(*s).astype(dtype))
    um, vm = f(nlev + 1, NREG, NREG, ncol), f(nlev + 1, NREG, NREG, ncol)
    clear = t("clear")
    prev, nxt = torch.roll(clear, 1, 0), torch.roll(clear, -1, 0)
    cf = f(nlev, ncol)
    cf[:, :5] = 1.0                               # overcast layers
    cols = pad.pack_cols(um, vm, cf, f(nlev, ncol) * 500,
                         f(nlev, ncol) * 300, f(nlev, ncol) * 300,
                         f(nlev, 3, ncol) * 1e-3, f(nlev, ncol) * 1e-3,
                         f(nlev, ncol), f(nlev, NREG, ncol),
                         f(nlev, NREG, ncol), clear, prev, nxt, f(ncol))
    return dict(hist=hist, cols=cols,
                init=f(2 * NREG * NREG, ng, ncol) * 0.3,
                d0=f(NREG, ng, ncol) * 100, lhist=lhist,
                lcols=pad.lw_pack_cols(um, vm, clear, prev, nxt),
                linit=torch.cat([f(NREG * NREG, ng, ncol) * 0.2,
                                 f(NREG, ng, ncol) * 50]),
                carry=torch.cat([f(2 * NREG * NREG, ng, ncol) * 0.3,
                                 f(2 * NREG, ng, ncol) * 2000]))


@pytest.fixture(scope="module")
def f64():
    return inputs("float64")


@pytest.fixture(scope="module")
def f32():
    return inputs("float32")


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("do_3d", [True, False])
@pytest.mark.parametrize("entrap", ENTRAPMENTS, ids=lambda e: e.name)
def test_sw_steps_match_jax_f64(f64, entrap, do_3d):
    cfg = pconfig.spartacus_slice_config(i_3d_sw_entrapment=entrap,
                                         do_3d_effects=do_3d)
    nlev = f64["hist"].shape[0]
    with jax.enable_x64(True):
        jcfg = golden.jax_config(cfg, "float64")
        for l in range(nlev):
            carry, ys = pad.sw_up_step(cfg, NREG, f64["carry"],
                                       f64["hist"][l], f64["cols"][l])
            jcarry, jys = jad.sw_up_step(jcfg, _j(f64["carry"]),
                                         _j(f64["hist"][l]),
                                         _j(f64["cols"][l]))
            assert _rel(carry.numpy(), jcarry) <= 1e-10, (l, "up")
            assert _rel(ys.numpy(), jys) <= 1e-10, (l, "ys")
            dcarry = torch.cat([f64["d0"] * 0.5, f64["d0"]])
            dc, out = pad.sw_dn_step(NREG, dcarry, f64["hist"][l], ys,
                                     f64["cols"][l])
            jdc, jout = jad.sw_dn_step(jcfg, _j(dcarry), _j(f64["hist"][l]),
                                       jys, _j(f64["cols"][l]))
            assert _rel(dc.numpy(), jdc) <= 1e-10, (l, "dn carry")
            assert _rel(out.numpy(), jout) <= 1e-10, (l, "dn out")


@pytest.mark.parametrize("use_matrix, multilayer", [
    (True, False), (True, True), (False, False)])
def test_lw_steps_match_jax_f64(f64, use_matrix, multilayer):
    cfg = pconfig.spartacus_slice_config(
        do_3d_lw_multilayer_effects=multilayer)
    nlev = f64["lhist"].shape[0]
    with jax.enable_x64(True):
        jcfg = golden.jax_config(cfg, "float64")
        for l in range(nlev):
            carry = f64["linit"]
            new, ys = pad.lw_up_step(cfg, use_matrix, NREG, carry,
                                     f64["lhist"][l], f64["lcols"][l])
            jnew, jys = jad.lw_up_step(jcfg, use_matrix, _j(carry),
                                       _j(f64["lhist"][l]),
                                       _j(f64["lcols"][l]))
            assert _rel(new.numpy(), jnew) <= 1e-10, (l, "up")
            fdn = f64["d0"]
            dn, out = pad.lw_dn_step(use_matrix, NREG, fdn, f64["lhist"][l],
                                     ys, f64["lcols"][l])
            jdn, jout = jad.lw_dn_step(jcfg, use_matrix, _j(fdn),
                                       _j(f64["lhist"][l]), jys,
                                       _j(f64["lcols"][l]))
            assert _rel(dn.numpy(), jdn) <= 1e-10, (l, "dn")
            assert _rel(out.numpy(), jout) <= 1e-10, (l, "out")


@pytest.mark.parametrize("entrap, do_3d", [
    (e, True) for e in ENTRAPMENTS] + [(pconfig.Entrapment.EXPLICIT, False)],
    ids=lambda v: getattr(v, "name", str(v)))
def test_sw_sweeps_match_pallas_interpret(f32, entrap, do_3d):
    cfg = pconfig.spartacus_slice_config(i_3d_sw_entrapment=entrap,
                                         do_3d_effects=do_3d)
    got = pad.sw_adding_sweeps(cfg, f32["hist"], f32["cols"], f32["init"],
                               f32["d0"])
    ref = jad.sw_adding_sweeps(golden.jax_config(cfg, "float32"),
                               _j(f32["hist"]), _j(f32["cols"]),
                               _j(f32["init"]), _j(f32["d0"]),
                               interpret=True)
    for name, a, b in zip(("alb_top", "albdir_top", "fluxes"), got,
                          (ref[0], ref[1], ref[3])):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        assert _rel(a.numpy(), b) <= 2e-5, (name, _rel(a.numpy(), b))


@pytest.mark.parametrize("use_matrix, multilayer", [
    (True, False), (True, True), (False, False)])
def test_lw_sweeps_match_pallas_interpret(f32, use_matrix, multilayer):
    cfg = pconfig.spartacus_slice_config(
        do_3d_lw_multilayer_effects=multilayer)
    got = pad.lw_adding_sweeps(cfg, use_matrix, f32["lhist"], f32["lcols"],
                               f32["linit"])
    ref = jad.lw_adding_sweeps(golden.jax_config(cfg, "float32"),
                               use_matrix, _j(f32["lhist"]),
                               _j(f32["lcols"]), _j(f32["linit"]),
                               interpret=True)
    for name, a, b in zip(("src_top", "fluxes"), got, (ref[0], ref[2])):
        assert _rel(a.numpy(), np.asarray(b)) <= 2e-5, name


def test_pack_cols_matches_jax(f32):
    """The port's per-column rows are the JAX package's, 3 x 3 padding
    included (rows 0-26 hold um, vm and vm below as 3 x 3)."""
    rng = np.random.RandomState(4)
    nlev, ncol = 5, 9
    a = lambda *s: rng.rand(*s).astype(np.float32)
    um, vm = a(nlev + 1, 3, 3, ncol), a(nlev + 1, 3, 3, ncol)
    scal = [a(nlev, ncol) for _ in range(6)]
    edge, rf, rfp = a(nlev, ncol, 3), a(nlev, ncol, 3), a(nlev, ncol, 3)
    cl = [rng.rand(nlev, ncol) > 0.5 for _ in range(3)]
    tan = a(ncol)
    ref = jad.pack_cols(jnp.asarray(um)[..., None, :],
                        jnp.asarray(vm)[..., None, :], *scal[:4], edge,
                        *scal[4:], rf, rfp, *cl, np.arange(nlev) > 0, tan)
    got = pad.pack_cols(*(torch.as_tensor(x) for x in (um, vm, *scal[:4])),
                        torch.as_tensor(edge).permute(0, 2, 1),
                        *(torch.as_tensor(x) for x in scal[4:]),
                        torch.as_tensor(rf).permute(0, 2, 1),
                        torch.as_tensor(rfp).permute(0, 2, 1),
                        *(torch.as_tensor(x) for x in cl),
                        torch.as_tensor(tan))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
