"""PyTorch port: parallel/ (columns split over devices, several processes,
the scaling benchmark) against the JAX package's parallel/.

- shard_columns + run_sharded over two CPU "devices" give the one run's
  fluxes bit for bit: Cloudless and McICA (the SYNTHETIC LUTs) on 8
  columns, and on 7, which do not split in two and go to every device
  whole, as the JAX package replicates such arrays;
- host_column_slice is the JAX package's slice for every (ncol, nproc,
  pid) tried, and init_distributed's single-process dict has its keys;
- scaling_benchmark reports what the JAX package's does;
- two processes in a gloo group (children with no CUDA device, a free
  port, a time limit), each reading its own 4 columns of an 8-column file
  with read_input_sharded, give the fluxes of one process reading all 8,
  bit for bit, concatenated and through all_gather: the port's form of
  tests/test_distributed.py, which needs the reference data.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecrad_tpu_torch.config import cloudless_slice_config, mcica_slice_config
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import (make_clouds, make_columns,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.io.output import save_inputs
from ecrad_tpu_torch.parallel import scaling
from ecrad_tpu_torch.parallel.sharding import (column_mesh, run_sharded,
                                               shard_columns)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NLEV, SEED = 10, 0


@pytest.fixture(scope="module")
def luts(tmp_path_factory):
    return write_synthetic_luts(str(tmp_path_factory.mktemp("luts")), SEED)


@pytest.mark.parametrize("ncol", [8, 7])
@pytest.mark.parametrize("config", ["cloudless", "mcica"])
def test_sharded_run_equals_one_run(luts, config, ncol):
    cfg = (cloudless_slice_config() if config == "cloudless"
           else mcica_slice_config(**luts))
    setup = setup_radiation(cfg, device="cpu")
    inputs = columns_to_inputs(make_clouds(make_columns(ncol, NLEV, SEED),
                                           SEED), device="cpu")
    if config == "cloudless":
        inputs = inputs[:3]
    one = radiation(setup, *inputs)
    shards = shard_columns(inputs, column_mesh(["cpu", "cpu"]))
    assert [(b.start, b.stop) for b in shards.blocks] == (
        [(0, 4), (4, 8)] if ncol == 8 else [(0, 7), (0, 7)])
    assert shards.pieces[0][0].cos_sza.shape[0] == (4 if ncol == 8 else 7)
    # what has no column axis goes to every piece whole
    assert all(p[0].solar_irradiance == inputs[0].solar_irradiance
               for p in shards.pieces)
    calls = []

    def run(dev, *piece):
        calls.append(dev)
        return radiation(setup, *piece)

    split = run_sharded(run, shards)
    assert len(calls) == (2 if ncol == 8 else 1)
    assert [k for k, _ in split.fields()] == [k for k, _ in one.fields()]
    for k, v in one.fields():
        assert torch.equal(getattr(split, k), v), k


def test_column_mesh_defaults_to_the_gpus():
    assert column_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    if torch.cuda.is_available():
        assert len(column_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            column_mesh()


@pytest.mark.parametrize("ncol, nproc", [(8, 1), (8, 2), (7, 2), (10, 3),
                                         (2, 4), (137, 4)])
def test_host_column_slice_matches_jax(monkeypatch, ncol, nproc):
    import jax

    from ecrad_tpu.parallel import scaling as jscaling
    got = []
    for pid in range(nproc):
        monkeypatch.setattr(jax, "process_count", lambda: nproc)
        monkeypatch.setattr(jax, "process_index", lambda: pid)
        want = jscaling.host_column_slice(ncol)
        got.append(scaling.host_column_slice(ncol, pid, nproc))
        assert got[-1] == want
    # every column read once
    assert sum(max(s.stop - s.start, 0) for s in got) == ncol
    assert scaling.host_column_slice(ncol) == slice(0, ncol)


def test_init_distributed_single_process(monkeypatch):
    from ecrad_tpu.parallel import scaling as jscaling
    for k in ("ECRAD_COORDINATOR", "ECRAD_NUM_PROCESSES",
              "ECRAD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    info = scaling.init_distributed()
    assert set(info) == set(jscaling.init_distributed())
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["global_devices"] == info["local_devices"] >= 1
    assert not torch.distributed.is_initialized()


def test_scaling_benchmark_reports_as_jax():
    import jax.numpy as jnp

    from ecrad_tpu.parallel import scaling as jscaling
    want = jscaling.scaling_benchmark(lambda x: x * 2.0,
                                      (jnp.ones((8, 3)),),
                                      device_counts=[1, 2], nrepeat=1)
    seen = []

    def run(dev, x):
        seen.append((dev, x.shape[0]))
        return x * 2.0

    got = scaling.scaling_benchmark(run, (torch.ones(8, 3),),
                                    device_counts=[1, 2], nrepeat=2,
                                    devices=["cpu", "cpu"])
    assert [set(r) for r in got] == [set(r) for r in want]
    assert [r["devices"] for r in got] == [1, 2]
    assert got[0]["speedup"] == got[0]["efficiency"] == 1.0
    assert all(r["columns_per_sec"] > 0 for r in got)
    # a warm-up and 2 timed runs: 3 one-block runs, then 3 x 2 blocks
    assert [n for _, n in seen] == [8] * 3 + [4] * 6


WORKER = r"""
import sys
repo, path, luts, out = sys.argv[1:5]
sys.path.insert(0, repo)
import numpy as np
import torch
import torch.distributed as dist
from ecrad_tpu_torch.config import mcica_slice_config
from ecrad_tpu_torch.inputs import synthetic_lut_names
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.parallel.scaling import (host_column_slice,
                                              init_distributed,
                                              read_input_sharded)
from ecrad_tpu_torch.parallel.sharding import column_mesh, run_sharded
info = init_distributed()
setup = setup_radiation(mcica_slice_config(
    directory_name=luts, **synthetic_lut_names()), device="cpu")
shards = read_input_sharded(path, mesh=column_mesh(["cpu"]))
flux = run_sharded(lambda d, *a: radiation(setup, *a), shards)
res = {k: v.numpy() for k, v in flux.fields()}
res.update({k: np.int64(v) for k, v in info.items()})
res["row0"] = np.int64(host_column_slice(8).start)
if dist.is_initialized():
    res["backend"] = np.array(dist.get_backend())
    parts = [torch.empty_like(flux.sw_dn)
             for _ in range(info["process_count"])]
    dist.all_gather(parts, flux.sw_dn)
    res["gathered_sw_dn"] = torch.cat(parts).numpy()
    dist.destroy_process_group()
np.savez(out, **res)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_one(tmp_path, luts):
    path = str(tmp_path / "in.nc")
    save_inputs(path, *columns_to_inputs(make_clouds(
        make_columns(8, NLEV, SEED), SEED), device="cpu"), None)
    port = _free_port()
    runs = []
    for nproc, pid in ((1, 0), (2, 0), (2, 1)):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO, ECRAD_NUM_PROCESSES=str(nproc),
                   ECRAD_PROCESS_ID=str(pid),
                   ECRAD_COORDINATOR=f"127.0.0.1:{port}")
        out = str(tmp_path / f"out_{nproc}_{pid}.npz")
        runs.append((out, subprocess.Popen(
            [sys.executable, "-c", WORKER, REPO, path,
             luts["directory_name"], out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    results = []
    try:
        for out, proc in runs:
            log, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, log[-4000:]
            results.append(dict(np.load(out)))
    finally:
        for _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    single, duo = results[0], results[1:]
    assert [int(d["process_index"]) for d in duo] == [0, 1]
    assert all(int(d["process_count"]) == 2 and str(d["backend"]) == "gloo"
               for d in duo)
    assert [int(d["row0"]) for d in duo] == [0, 4]
    fields = [k for k in single if k not in (
        "process_index", "process_count", "local_devices", "global_devices",
        "row0")]
    assert "lw_up" in fields and "cloud_cover_sw" in fields
    for k in fields:
        got = np.concatenate([d[k] for d in duo])
        np.testing.assert_array_equal(got, single[k], err_msg=k)
    for d in duo:
        np.testing.assert_array_equal(d["gathered_sw_dn"], single["sw_dn"])
