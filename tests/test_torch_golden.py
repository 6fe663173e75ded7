"""PyTorch port: its golden files stay current, and the package runs where
jax is not installed.

tests/goldens/torch_port_{cloudless,mcica,tripleclouds,spartacus}.npz
hold the JAX package's fluxes (at float32 and float64) for the first 32
of the 2048 seed-0 columns that chip_smoke.py runs on the GPU, the
cloudy ones also the cloud covers (McICA also its cloudy-subcolumn masks,
Tripleclouds and SPARTACUS their LW derivatives), on the synthetic LUTs
of inputs.write_synthetic_luts; tools/make_torch_port_golden.py --check
regenerates all four from JAX and compares. The port package must import
neither jax nor flax nor the JAX package (the GPU machine has none of
them): a subprocess blocks all three, imports every module of the port
and runs its paths (Cloudless, McICA, Tripleclouds, Homogeneous,
SPARTACUS) on the CPU. Its entry points run on the GPU unless asked for
the CPU: without a GPU they raise.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "torch_port_cloudless.npz")
GOLDEN_MCICA = os.path.join(REPO, "tests", "goldens", "torch_port_mcica.npz")
GOLDEN_TRIPLECLOUDS = os.path.join(REPO, "tests", "goldens",
                                   "torch_port_tripleclouds.npz")
GOLDEN_SPARTACUS = os.path.join(REPO, "tests", "goldens",
                                "torch_port_spartacus.npz")


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return env


def test_golden_matches_a_fresh_jax_run():
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "make_torch_port_golden.py"),
         "--check"], env=_env(), capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "golden matches" in res.stdout


def test_golden_meets_the_port_on_the_cpu():
    """The first two golden columns against the port's plain path: the
    bounds chip_smoke.py applies on the GPU hold on the CPU as well."""
    from ecrad_tpu_torch.config import cloudless_slice_config
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.inputs import make_columns, slice_columns
    from ecrad_tpu_torch.interface import radiation, setup_radiation

    cols = slice_columns(make_columns(2048, 137, 0), slice(0, 2))
    flux = radiation(setup_radiation(cloudless_slice_config(), device="cpu"),
                     *columns_to_inputs(cols, device="cpu"))
    bounds = {"lw_up": 0.01, "lw_dn": 0.01, "sw_up": 0.2, "sw_dn": 0.2,
              "sw_dn_direct": 0.02}
    with np.load(GOLDEN) as z:
        for k, bound in bounds.items():
            got = getattr(flux, k).double().numpy()
            assert z[k].shape == (32, 138)
            assert np.abs(got - z[k][:2]).max() <= bound, k
            assert np.abs(got - z[k + "_f64"][:2]).max() <= bound, k


def test_mcica_golden_meets_the_port_on_the_cpu(tmp_path):
    """The first two McICA golden columns against the port's plain path:
    the bounds chip_smoke.py applies on the GPU (clear sky against JAX
    float32 and float64; total sky and cloud covers against JAX float32;
    identical subcolumn masks) hold on the CPU as well."""
    from ecrad_tpu_torch.config import mcica_slice_config
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.inputs import (make_clouds, make_columns,
                                        slice_columns, write_synthetic_luts)
    from ecrad_tpu_torch.interface import (_cloud_stage, radiation,
                                           setup_radiation)
    from ecrad_tpu_torch.solvers.cloud_generator import cloud_generator

    cols = slice_columns(make_clouds(make_columns(2048, 137, 0), 0),
                         slice(0, 2))
    setup = setup_radiation(mcica_slice_config(
        **write_synthetic_luts(str(tmp_path), 0)), device="cpu")
    inputs = columns_to_inputs(cols, device="cpu")
    flux = radiation(setup, *inputs)
    clear = {"lw_up": 0.01, "lw_dn": 0.01, "sw_up": 0.2, "sw_dn": 0.2,
             "sw_dn_direct": 0.02}
    total = {"lw_up": 0.02, "lw_dn": 0.02, "sw_up": 0.3, "sw_dn": 0.3,
             "sw_dn_direct": 0.3}
    with np.load(GOLDEN_MCICA) as z:
        for k, bound in clear.items():
            got = getattr(flux, k + "_clear").double().numpy()
            assert z[k + "_clear"].shape == (32, 138)
            assert np.abs(got - z[k + "_clear"][:2]).max() <= bound, k
            assert np.abs(got - z[k + "_clear_f64"][:2]).max() <= bound, k
        for k, bound in total.items():
            got = getattr(flux, k).double().numpy()
            assert np.abs(got - z[k][:2]).max() <= bound, k
        for k in ("cloud_cover_sw", "cloud_cover_lw"):
            assert np.abs(getattr(flux, k).numpy() - z[k][:2]).max() <= 1e-5
        cfg = setup.config
        cloud, _ = _cloud_stage(setup, inputs[1], inputs[3], lambda x: x)
        for key, ng, offset in (("mask_sw", 112, 0), ("mask_lw", 140, 997)):
            od_scaling, _ = cloud_generator(
                ng, inputs[0].iseed + offset, cfg.i_overlap_scheme,
                cfg.cloud_fraction_threshold, cloud.fraction,
                cloud.overlap_param, cfg.cloud_inhom_decorr_scaling,
                cloud.fractional_std, setup.pdf_sampler,
                table=setup.pdf_table)
            ref = np.unpackbits(z[key])[:32 * 137 * ng].reshape(32, 137, ng)
            np.testing.assert_array_equal((od_scaling > 0).numpy(),
                                          ref[:2], err_msg=key)


NO_JAX = r"""
import sys
for name in ("jax", "jaxlib", "flax", "ecrad_tpu"):
    sys.modules[name] = None        # any import of them now fails
sys.path.insert(0, sys.argv[1])
import importlib, pkgutil
import ecrad_tpu_torch
for m in pkgutil.walk_packages(ecrad_tpu_torch.__path__, "ecrad_tpu_torch."):
    importlib.import_module(m.name)
import tempfile
import torch
from ecrad_tpu_torch.config import (Solver, cloudless_slice_config,
                                    mcica_slice_config,
                                    spartacus_slice_config,
                                    tripleclouds_slice_config)
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                    make_clouds, make_columns,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
cpu = lambda cfg: setup_radiation(cfg, device="cpu")
flux = radiation(cpu(cloudless_slice_config()),
                 *columns_to_inputs(make_columns(2, 10, 0), device="cpu"))
assert flux.lw_up.shape == (2, 11) and bool(torch.isfinite(flux.sw_dn).all())
cols = add_effective_sizes(make_aerosols(make_clouds(make_columns(3, 10, 0))))
with tempfile.TemporaryDirectory() as luts:
    setups = [cpu(mcica_slice_config(**write_synthetic_luts(luts)))] + [
        cpu(make(**write_synthetic_luts(luts, ice="fu"), **kw))
        for make, kw in ((tripleclouds_slice_config, {}),
                         (tripleclouds_slice_config,
                          {"i_solver_sw": Solver.HOMOGENEOUS,
                           "i_solver_lw": Solver.HOMOGENEOUS}),
                         (spartacus_slice_config, {}))]
for setup in setups:
    flux = radiation(setup, *columns_to_inputs(cols, device="cpu"))
    assert flux.cloud_cover_sw.shape == (3,)
    assert bool(torch.isfinite(flux.lw_dn).all())
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "ecrad_tpu") and sys.modules[m]]
assert not loaded, loaded
print("ok")
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", NO_JAX, REPO], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert res.stdout.strip().endswith("ok")


def test_tripleclouds_golden_meets_the_port_on_the_cpu(tmp_path):
    """The first two Tripleclouds golden columns against the port's
    plain path: the bounds chip_smoke.py applies on the GPU (clear sky
    lw 0.01, sw 0.2, sw_dn_direct 0.02; total sky lw 0.02, sw 0.3;
    cloud covers 1e-5; LW derivatives 1e-4; against JAX float32 and
    float64: Tripleclouds is deterministic) hold on the CPU as well."""
    from ecrad_tpu_torch.config import tripleclouds_slice_config
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.inputs import (make_aerosols, make_clouds,
                                        make_columns, slice_columns,
                                        write_synthetic_luts)
    from ecrad_tpu_torch.interface import radiation, setup_radiation

    cols = slice_columns(make_aerosols(make_clouds(
        make_columns(2048, 137, 0), 0), 0), slice(0, 2))
    setup = setup_radiation(tripleclouds_slice_config(
        **write_synthetic_luts(str(tmp_path), 0, ice="fu")), device="cpu")
    flux = radiation(setup, *columns_to_inputs(cols, device="cpu"))
    bounds = {"lw_up": 0.02, "lw_dn": 0.02, "sw_up": 0.3, "sw_dn": 0.3,
              "sw_dn_direct": 0.3, "lw_up_clear": 0.01, "lw_dn_clear": 0.01,
              "sw_up_clear": 0.2, "sw_dn_clear": 0.2,
              "sw_dn_direct_clear": 0.02, "cloud_cover_sw": 1e-5,
              "cloud_cover_lw": 1e-5, "lw_derivatives": 1e-4}
    with np.load(GOLDEN_TRIPLECLOUDS) as z:
        for k, bound in bounds.items():
            got = getattr(flux, k).double().numpy()
            assert z[k].shape[0] == 32
            assert np.abs(got - z[k][:2]).max() <= bound, k
            assert np.abs(got - z[k + "_f64"][:2]).max() <= bound, k


def test_spartacus_golden_meets_the_port_on_the_cpu(tmp_path):
    """The first two SPARTACUS golden columns against the port's plain
    path: the bounds chip_smoke.py applies on the GPU (bench.py's
    SPARTACUS_F64_BOUNDS against JAX float64, and against JAX float32
    within them plus JAX's own float32 error; cloud covers 1e-5; LW
    derivatives 1e-4) hold on the CPU as well."""
    from ecrad_tpu_torch.config import spartacus_slice_config
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                        make_clouds, make_columns,
                                        slice_columns, write_synthetic_luts)
    from ecrad_tpu_torch.interface import radiation, setup_radiation

    cols = slice_columns(add_effective_sizes(make_aerosols(make_clouds(
        make_columns(2048, 137, 0), 0), 0)), slice(0, 2))
    setup = setup_radiation(spartacus_slice_config(
        **write_synthetic_luts(str(tmp_path), 0, ice="fu")), device="cpu")
    flux = radiation(setup, *columns_to_inputs(cols, device="cpu"))
    bounds = {"lw_up": 0.01, "lw_dn": 0.01, "sw_up": 0.2, "sw_dn": 0.2,
              "sw_dn_direct": 0.01, "lw_up_clear": 0.01, "lw_dn_clear": 0.01,
              "sw_up_clear": 0.2, "sw_dn_clear": 0.2,
              "cloud_cover_sw": 1e-5, "cloud_cover_lw": 1e-5,
              "lw_derivatives": 1e-4}
    with np.load(GOLDEN_SPARTACUS) as z:
        for k, bound in bounds.items():
            got = getattr(flux, k).double().numpy()
            f32, f64 = z[k][:2], z[k + "_f64"][:2]
            assert z[k].shape[0] == 32
            assert np.abs(got - f64).max() <= bound, k
            assert (np.abs(got - f32).max()
                    <= bound + np.abs(f32 - f64).max()), k


@pytest.mark.parametrize("entry", ["setup_radiation", "setup_from_numpy",
                                   "inputs_from_numpy", "columns_to_inputs"])
def test_entry_points_default_to_the_gpu(monkeypatch, entry):
    """Without device= every entry point asks for CUDA; with no card it
    raises instead of running on the CPU."""
    from ecrad_tpu_torch import convert, interface
    from ecrad_tpu_torch.config import cloudless_slice_config
    from ecrad_tpu_torch.inputs import make_columns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = make_columns(2, 5, 0)
    calls = {
        "setup_radiation": lambda: interface.setup_radiation(
            cloudless_slice_config()),
        "setup_from_numpy": lambda: convert.setup_from_numpy(
            cloudless_slice_config(), {}, SimpleNamespace(
                band_from_g_lw=np.zeros(140, int),
                band_from_g_sw=np.zeros(112, int)), None, None, None, None),
        "inputs_from_numpy": lambda: convert.inputs_from_numpy(
            {}, {}, {"mixing_ratio": cols["mixing_ratio"]}),
        "columns_to_inputs": lambda: convert.columns_to_inputs(cols)}
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        calls[entry]()
    assert interface.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports torch, numpy and the port, never jax or the
    JAX package (the GPU machine has neither)."""
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "ecrad_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "ecrad_tpu"}, roots


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run for real")
    res = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
