"""Column blocks for the offline driver.

Port of ecrad_tpu/parallel/scaling.py:78-123 (`chunk_columns`), the
memory-bounding analogue of the reference driver's nblocksize column
blocks (driver/ecrad_driver.F90:277): peak memory scales with the block,
not the batch. The JAX version maps the blocks with lax.map; here a
Python loop runs them one after another. As there, the columns are
padded to a whole number of blocks by repeating the last column, and the
outputs are cropped back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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
