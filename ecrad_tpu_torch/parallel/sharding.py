"""Columns split over devices.

Port of ecrad_tpu/parallel/sharding.py. The radiation problem is
independent column by column, and each column's iseed makes its cloud
subcolumns the same in any block, so a batch splits into contiguous
blocks of columns, one per device, each run on its device with plain
tensors (no DTensor: the CUDA kernels take plain tensors), and the
blocks' outputs are put back together in column order. No collective is
needed in the computation. Where the column count does not divide by the
number of devices, every device gets all the columns, as the JAX package
replicates such arrays (ecrad_tpu/parallel/sharding.py:52-56), and the
first device's run gives the result.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..interface import resolve_device
from .scaling import _map, _tensors


def column_mesh(devices: Optional[Sequence] = None) -> Tuple[torch.device,
                                                             ...]:
    """The devices the columns are split over: `devices` (anything
    torch.device takes), by default every visible CUDA device; raises
    without a CUDA device unless the caller names others."""
    if devices is None:
        resolve_device("cuda")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    return tuple(resolve_device(d) for d in devices)


@dataclass
class ColumnShards:
    """Per-device pieces of a batch: pieces[i] is the batch's trees with
    its column tensors cut to blocks[i] and every tensor on devices[i]."""
    devices: Tuple[torch.device, ...]
    pieces: List[tuple]
    blocks: List[slice]


def shard_columns(trees, mesh: Optional[Sequence] = None,
                  local_columns: Optional[int] = None) -> ColumnShards:
    """`trees` (a tuple of input dataclasses, tensors or tuples of them)
    cut into one piece per device of `mesh` (column_mesh() by default):
    every tensor whose leading axis has `local_columns` entries (by
    default the leading axis of the trees' first tensor) is cut into
    contiguous equal blocks, any other value goes to every device whole.
    A column count that does not divide by the device count goes to
    every device whole."""
    mesh = column_mesh(mesh)
    ncol = (local_columns if local_columns is not None
            else _tensors(trees)[0].shape[0])
    ndev = len(mesh)
    if ncol % ndev:
        blocks = [slice(0, ncol)] * ndev
    else:
        per = ncol // ndev
        blocks = [slice(i * per, (i + 1) * per) for i in range(ndev)]

    def piece(dev, block):
        def place(x):
            if x.ndim > 0 and x.shape[0] == ncol:
                x = x[block]
            return x.to(dev)
        return _map(place, tuple(trees))

    return ColumnShards(devices=mesh,
                        pieces=[piece(d, b) for d, b in zip(mesh, blocks)],
                        blocks=blocks)


def run_sharded(fn: Callable, shards: ColumnShards):
    """fn(device, *piece) on every piece, the outputs put back together
    in column order on the first device: each output tensor is
    concatenated over the blocks along its leading axis. A batch whose
    blocks all hold every column (an uneven split) is run once, on the
    first device. The devices' launches overlap: nothing here waits for
    a device before the concatenation."""
    runs, seen = [], set()
    for dev, piece, block in zip(shards.devices, shards.pieces,
                                 shards.blocks):
        key = (block.start, block.stop)
        if key not in seen:
            seen.add(key)
            runs.append(fn(dev, *piece))
    first = shards.devices[0]
    if len(runs) == 1:
        return runs[0]
    parts = [_tensors(r) for r in runs]
    cat = iter([torch.cat([p.to(first) for p in ps]) for ps in zip(*parts)])
    return _map(lambda _: next(cat), runs[0])
