#!/usr/bin/env python3
"""Kernel B12 (the aerosol optics, csrc/aerosol_optics.cu) under each
candidate block design, timed on one aerosol call's operands of the
cells' shape on one GPU, in float32 and float64.

    python3 tools/b12_designs.py [--ncol 2048] [--nlev 137] [--reps 50]

Runs one call of the Cloudless path with the cells' aerosol settings (12
types of config.TRIPLECLOUDS_AEROSOL_MAP, LW aerosol scattering, the
saturation computed) on the columns of ecrad_tpu_torch.inputs with
clouds and aerosols, seed 0, in each dtype, and keeps the arguments
add_aerosol_optics is handed. Then, for each candidate (CANDIDATES: AER_ROWS, AER_THREADS and the float and
double forms' AER_MIN_BLOCKS of the source rewritten), builds the source into a library of its own,
runs the kernel on the kept arguments through its wrapper with that
library in place of the port's, checks its outputs equal bit for bit to
the source's design (a design changes no value), and times it with CUDA
events (the mean of `--reps` after a warm-up), beside the plain version
and the least time of the operands' bytes at 3.35 TB/s. One line per
candidate and dtype, with its registers, spills and blocks per SM. Exits
1 without a GPU.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: (AER_ROWS, AER_THREADS, AER_MIN_BLOCKS, AER_MIN_BLOCKS_F64): the
#: source's first
NAMES = ("AER_ROWS", "AER_THREADS", "AER_MIN_BLOCKS", "AER_MIN_BLOCKS_F64")
CANDIDATES = [(32, 256, 6, 4), (32, 256, 1, 1), (32, 256, 5, 3),
              (32, 256, 7, 5), (64, 256, 6, 4), (16, 256, 6, 4),
              (16, 128, 12, 8), (32, 128, 12, 8)]
HBM_BYTES_PER_S = 3.35e12


def build(consts, workdir):
    """(library path, compiler process) of the source with consts."""
    from ecrad_tpu_torch.ops import _cuda
    with open(os.path.join(_cuda.CSRC, "aerosol_optics.cu")) as f:
        src = f.read()
    for key, value in zip(NAMES, consts):
        src, n = re.subn(rf"\b{key} = \d+", f"{key} = {value}", src)
        if n != 1:
            raise ValueError(f"{key}: {n} definitions")
    path = os.path.join(workdir, "aerosol_%d_%d_%d_%d.cu" % consts)
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    flags = [f for f in _cuda.NVCC_FLAGS if f != "-lineinfo"]
    return lib, subprocess.Popen(
        [_cuda._nvcc(), *flags, "-I", _cuda.CSRC, "-shared", "-o", lib,
         path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(lib):
    """ctypes library with the argument types of B12's entries."""
    from ecrad_tpu_torch.ops import _cuda
    cdll = ctypes.CDLL(lib)
    for table in (_cuda._SIGS, _cuda._INFO_SIGS):
        for name, sig in table.items():
            if name.startswith("aerosol_optics"):
                fn = getattr(cdll, name)
                fn.argtypes = [_cuda._CTYPES[s] for s in sig] + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
    return cdll


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def operand_bytes(args, outs):
    """Bytes of the distinct tensors among args and outs (each storage
    once): what the call reads and writes at least."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            key = (x.data_ptr(), x.numel())
            if key not in seen:
                seen.add(key)
                total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))
    walk((args, outs))
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ncol", type=int, default=2048)
    ap.add_argument("--nlev", type=int, default=137)
    ap.add_argument("--reps", type=int, default=50)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    from ecrad_tpu_torch import interface
    from ecrad_tpu_torch.config import (TRIPLECLOUDS_AEROSOL_MAP,
                                        cloudless_slice_config)
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.inputs import (make_aerosols, make_clouds,
                                        make_columns, write_synthetic_luts)
    from ecrad_tpu_torch.ops import _cuda
    from ecrad_tpu_torch.optics import aerosol

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    work = tempfile.mkdtemp(prefix="b12-designs-")
    builds = {c: build(c, work) for c in CANDIDATES}
    luts = write_synthetic_luts(work, 0)
    cols = make_aerosols(make_clouds(make_columns(opts.ncol, opts.nlev, 0)))
    inputs = columns_to_inputs(cols, device="cuda")
    kept = {}
    real = interface.add_aerosol_optics
    for dtype in ("float32", "float64"):
        setup = interface.setup_radiation(cloudless_slice_config(
            **luts, dtype=dtype, use_aerosols=True,
            n_aerosol_types=len(TRIPLECLOUDS_AEROSOL_MAP),
            i_aerosol_type_map=TRIPLECLOUDS_AEROSOL_MAP), device="cuda")
        interface.add_aerosol_optics = lambda *a, _d=dtype: (
            kept.__setitem__(_d, a), real(*a))[1]
        try:
            interface.radiation(setup, *inputs)
        finally:
            interface.add_aerosol_optics = real
    del inputs
    torch.cuda.synchronize()
    base = _cuda.library()
    want = {d: real(*a) for d, a in kept.items()}
    for d, a in kept.items():
        nbytes = operand_bytes(a, want[d])
        plain_ms = events_ms(
            lambda: aerosol.add_aerosol_optics_plain(*a), 3)
        print(f"{d}: plain {plain_ms:.4f} ms; operands "
              f"{nbytes / 1e9:.3f} GB, least "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms [{gpu}]")
    try:
        for consts, (lib, proc) in builds.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                print(f"{consts}: build failed\n{log}")
                continue
            rep = _cuda.ptxas_report(log)
            cdll = load(lib)
            _cuda._lib = cdll
            for f64, d in ((0, "float32"), (1, "float64")):
                a = kept[d]
                got = real(*a)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, want[d]))
                ms = events_ms(lambda: real(*a), opts.reps)
                info = (ctypes.c_int * len(_cuda.INFO_FIELDS))()
                cdll.aerosol_optics_info(f64, info)
                k = dict(zip(_cuda.INFO_FIELDS, info))
                tag = "IdLi2E" if f64 else "IfLi4E"
                r = [v for n, v in rep.items() if tag in n]
                r = r[0] if r else {}
                nbytes = operand_bytes(a, got)
                print(f"rows {consts[0]}, threads {consts[1]}, min blocks "
                      f"{consts[2 + f64]}, {d}: {ms:.4f} ms ("
                      f"{nbytes / HBM_BYTES_PER_S * 1e3 / ms:.1%} of the "
                      f"bytes bound), equal {same}; {k['registers']} "
                      f"registers, spills {r.get('spill_stores')}/"
                      f"{r.get('spill_loads')} B, {k['blocks_per_sm']} "
                      f"blocks per SM [{gpu}]")
                del got
    finally:
        _cuda._lib = base
    return 0


if __name__ == "__main__":
    sys.exit(main())
