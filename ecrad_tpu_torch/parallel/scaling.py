"""Column blocks, several processes, and the scaling over devices.

Port of ecrad_tpu/parallel/scaling.py:
 - `chunk_columns` (:78-123), the memory-bounding analogue of the
   reference driver's nblocksize column blocks
   (driver/ecrad_driver.F90:277): peak memory scales with the block, not
   the batch. The JAX version maps the blocks with lax.map; here a
   Python loop runs them one after another. As there, the columns are
   padded to a whole number of blocks by repeating the last column, and
   the outputs are cropped back.
 - `init_distributed` (:37-49) on torch.distributed, from the same
   ECRAD_COORDINATOR / ECRAD_NUM_PROCESSES / ECRAD_PROCESS_ID variables.
 - `host_column_slice` and `read_input_sharded` (:52-75): each process
   reads its own contiguous slice of the input's columns (the reference's
   rank-local NetCDF reads, ifs/easy_netcdf_read_mpi.F90) and splits it
   over its devices.
 - `scaling_benchmark` (:126-160): columns/s and parallel efficiency
   against the number of devices.
The computation needs no collective: the columns are independent and
each column's iseed makes any block reproducible alone (the reference's
MPI-count invariance, CHANGELOG:17-19).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch


def _map(fn, x):
    """fn applied to every tensor in x (tensors, tuples, lists and
    dataclasses of them); anything else is kept."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, y) for y in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def _tensors(x):
    out = []
    _map(out.append, x)
    return out


def chunk_columns(run_fn: Callable, block_size: int) -> Callable:
    """run_fn over blocks of block_size columns. A tensor whose leading
    axis has the batch's column count (that of the inputs' first tensor)
    is cut into blocks; every other value goes to each block as it is.
    Every output tensor is concatenated over the blocks and cropped."""

    def wrapped(*inputs):
        ncol = _tensors(inputs)[0].shape[0]

        def block(x, start):
            if x.ndim == 0 or x.shape[0] != ncol:
                return x
            xb = x[start:start + block_size]
            pad = block_size - xb.shape[0]
            return (torch.cat([xb, x[-1:].expand(pad, *x.shape[1:])])
                    if pad else xb)

        outs = [run_fn(*_map(lambda x: block(x, start), inputs))
                for start in range(0, ncol, block_size)]
        parts = [_tensors(o) for o in outs]
        cat = iter([torch.cat(p)[:ncol] for p in zip(*parts)])
        return _map(lambda _: next(cat), outs[0])

    return wrapped


def init_distributed() -> Dict[str, int]:
    """Join the process group that ECRAD_COORDINATOR (host:port of rank
    0), ECRAD_NUM_PROCESSES and ECRAD_PROCESS_ID describe: gloo for CPU
    tensors and, where there is a CUDA device, nccl for CUDA ones. A
    single process (or a group already joined) does nothing. Returns
    process_index, process_count, local_devices (this process's CUDA
    devices, or 1, its CPU) and global_devices."""
    import torch.distributed as dist
    coord = os.environ.get("ECRAD_COORDINATOR")
    nproc = int(os.environ.get("ECRAD_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("ECRAD_PROCESS_ID", "0"))
    if coord and nproc > 1 and not dist.is_initialized():
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=nproc, rank=pid)
    index, count = _rank_and_size()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": index, "process_count": count,
            "local_devices": local, "global_devices": count * local}


def _rank_and_size():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_column_slice(ncol: int, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """The contiguous columns this process reads: ceil(ncol / nproc) per
    process, the last one the remainder (ecrad_tpu/parallel/
    scaling.py:52-58). The rank and world size default to the process
    group's (0 and 1 without one)."""
    rank, size = _rank_and_size()
    pid = rank if process_index is None else process_index
    nproc = size if process_count is None else process_count
    per = -(-ncol // nproc)
    return slice(pid * per, min((pid + 1) * per, ncol))


def read_input_sharded(path: str, driver_config=None,
                       mesh: Optional[Sequence] = None):
    """This process's columns of the driver input (host_column_slice),
    split over the devices of `mesh` (by default every visible CUDA
    device): a sharding.ColumnShards of (SingleLevel, Thermodynamics,
    GasConcs, Cloud, Aerosol). The file is read on the CPU and each
    block moved to its device."""
    from ..io.input_reader import read_input
    from .sharding import column_mesh, shard_columns
    mesh = column_mesh(mesh)
    parts = read_input(path, driver_config, device="cpu")
    ncol = parts[0].ncol
    sl = host_column_slice(ncol)
    parts = _map(lambda x: x[sl] if x.ndim > 0 and x.shape[0] == ncol
                 else x, parts)
    return shard_columns(parts, mesh, local_columns=sl.stop - sl.start)


def scaling_benchmark(run_fn: Callable, inputs, device_counts=None,
                      nrepeat: int = 3,
                      devices: Optional[Sequence] = None) -> List[Dict]:
    """Columns/s and parallel efficiency against the number of devices:
    for each count n, `inputs` (a tuple of input dataclasses, columns
    leading; the column count should divide by every n) split over the
    first n of `devices` (by default the visible CUDA devices; counts
    1, 2, 4, 8, 16, 32 up to their number), run_fn(device, *piece) run
    on every piece through sharding.run_sharded once to warm up and then
    nrepeat times, each waited for (torch.cuda.synchronize on every CUDA
    device); the best time counts. Returns one dict per count: devices,
    columns_per_sec, speedup, efficiency."""
    from .sharding import column_mesh, run_sharded, shard_columns
    devices = column_mesh(devices)
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32)
                         if d <= len(devices)]
    ncol = _tensors(inputs)[0].shape[0]

    def wait(mesh):
        for d in mesh:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    results, base_rate = [], None
    for ndev in device_counts:
        shards = shard_columns(inputs, devices[:ndev])
        run_sharded(run_fn, shards)
        wait(shards.devices)
        times = []
        for _ in range(nrepeat):
            t0 = time.perf_counter()
            run_sharded(run_fn, shards)
            wait(shards.devices)
            times.append(time.perf_counter() - t0)
        rate = ncol / min(times)
        base_rate = base_rate or rate
        results.append({"devices": ndev, "columns_per_sec": rate,
                        "speedup": rate / base_rate,
                        "efficiency": rate / (base_rate * ndev)})
    return results
