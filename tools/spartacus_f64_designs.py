#!/usr/bin/env python3
"""The double forms of kernels B6-B9 under each candidate design, timed
on the float64 SPARTACUS path's operands on one GPU.

    python3 tools/spartacus_f64_designs.py [--ncol 2048] [--nlev 137]
        [--reps 5]

Runs one float64 SPARTACUS call (config.spartacus_slice_config in
float64, the columns of ecrad_tpu_torch.inputs with clouds, aerosols and
effective sizes, seed 0) and keeps the operands each of B6-B9's wrappers
is handed. Then, for each candidate of the double forms' bounds and
windows (CANDIDATES: constants of csrc/spartacus_reftrans.cu and
csrc/spartacus_adding.cu), builds the source with those constants
rewritten into a library of its own, runs each kernel on the kept
operands through its wrapper with that library in place of the port's,
checks its output equal bit for bit to the design in the source's
(the designs change no value), and times each launch with CUDA events
(the mean of `--reps`, after one warm-up): B6's and B7's two passes
apart, B8, and B9. Prints one line per candidate and kernel, with the
candidate's registers, spills and blocks per SM. Exits 1 without a GPU.
"""
import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: candidates: the constants of each source that a candidate rewrites
#: (each a design the source's static_asserts admit)
CANDIDATES = {
    # LEAN_MIN_BLOCKS binds the float forms too, which are not timed here
    "spartacus_reftrans": [
        dict(LEAN_MIN_BLOCKS=lean, F64_LW_3D_MIN_BLOCKS=lw3d)
        for lean, lw3d in ((6, 1), (4, 2), (3, 3), (2, 1))],
    "spartacus_adding": [
        dict(F64_G_TILE=g, F64_C_TILE=c, F64_STAGES=2, F64_SW_MIN_BLOCKS=sb,
             F64_LW_G_TILE=lg, F64_LW_STAGES=ls, F64_LW_MIN_BLOCKS=lb)
        for (g, c, sb), (lg, ls, lb) in (
            ((8, 16, 2), (4, 2, 3)), ((16, 8, 2), (4, 3, 2)),
            ((4, 16, 3), (2, 2, 5)), ((8, 16, 2), (2, 3, 3)))],
}


def build(name, consts, workdir):
    """The library of csrc/<name>.cu with `consts` rewritten."""
    from ecrad_tpu_torch.ops import _cuda
    with open(os.path.join(_cuda.CSRC, name + ".cu")) as f:
        src = f.read()
    for key, value in consts.items():
        src, n = re.subn(rf"\b{key} = \d+", f"{key} = {value}", src)
        if n != 1:
            raise ValueError(f"{key}: {n} definitions in {name}.cu")
    tag = "_".join(str(v) for v in consts.values())
    path = os.path.join(workdir, f"{name}_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    flags = [f for f in _cuda.NVCC_FLAGS if f != "-lineinfo"]
    return lib, subprocess.Popen(
        [_cuda._nvcc(), *flags, "-I", _cuda.CSRC, "-shared", "-o", lib,
         path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(lib):
    """ctypes library with the argument types of every entry it holds."""
    from ecrad_tpu_torch.ops import _cuda
    cdll = ctypes.CDLL(lib)
    for table in (_cuda._SIGS, _cuda._INFO_SIGS):
        for name, sig in table.items():
            if hasattr(cdll, name):
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


def reftrans_passes(kind, args):
    """(pass 1, pass 2, out) of B6 (kind "sw") or B7 ("lw") on a wrapper's
    arguments, as ops/spartacus_reftrans.py launches them."""
    from ecrad_tpu_torch.ops import _cuda
    from ecrad_tpu_torch.ops import spartacus_reftrans as sr
    f64 = torch.float64
    if kind == "sw":
        (gas, od, ssa, g, trd, trf, mu0, use3d, clear) = args[:9]
        rows = 5 * od.shape[1] ** 2
    else:
        (gas, scat, od, ssa, g, tr, se, pt, pb, fr, use3d, clear) = args[:12]
        rows = 2 * od.shape[1] * (od.shape[1] + 1)
    nlev, nreg, ng, ncol = od.shape
    cells = nlev * ng * ncol
    cap = -(-cells // sr._STAGED_SHARE)
    dev = od.device
    out = torch.empty((nlev, rows, ng, ncol), dtype=f64, device=dev)
    packed = torch.empty((rows, cap) if kind == "sw" else (cap, rows),
                         dtype=f64, device=dev)
    slot_of = torch.empty(cells, dtype=torch.int32, device=dev)
    n3d = torch.zeros(1, dtype=torch.int32, device=dev)
    dims = (nreg, nlev, ng, ncol, cap)
    if kind == "sw":
        def one():
            n3d.zero_()
            _cuda.launch("spartacus_sw_reftrans_3d", od, ssa, g, trd, trf,
                         mu0, use3d, clear, out, None, packed, slot_of, n3d,
                         *dims, gas, dtype=f64)

        def two():
            _cuda.launch("spartacus_sw_reftrans_fallback", od, ssa, g, mu0,
                         use3d, clear, packed, slot_of, out, None, *dims,
                         dtype=f64)
    else:
        def one():
            n3d.zero_()
            _cuda.launch("spartacus_lw_reftrans_3d", od, ssa, g, tr, se, pt,
                         pb, fr, use3d, clear, out, None, packed, slot_of,
                         n3d, *dims, gas, dtype=f64)

        def two():
            _cuda.launch("spartacus_lw_reftrans_fallback", od, ssa, g, pt, pb,
                         fr, use3d, clear, packed, slot_of, out, None, *dims,
                         int(bool(scat)), dtype=f64)
    return one, two, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ncol", type=int, default=2048)
    ap.add_argument("--nlev", type=int, default=137)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    from ecrad_tpu_torch.config import spartacus_slice_config
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                        make_clouds, make_columns,
                                        write_synthetic_luts)
    from ecrad_tpu_torch.interface import radiation, setup_radiation
    from ecrad_tpu_torch.ops import _cuda
    from ecrad_tpu_torch.ops import spartacus_adding as sa
    from ecrad_tpu_torch.ops import spartacus_reftrans as sr

    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    work = tempfile.mkdtemp(prefix="spartacus-f64-")
    try:
        # the candidates build while the operands are made
        builds = {(name, i): build(name, consts, work)
                  for name, cands in CANDIDATES.items()
                  for i, consts in enumerate(cands)}
        cfg = spartacus_slice_config(
            **write_synthetic_luts(work, 0, ice="fu"), dtype="float64")
        setup = setup_radiation(cfg, device=dev)
        cols = add_effective_sizes(make_aerosols(make_clouds(make_columns(
            args.ncol, args.nlev, 0))))
        kept = {}
        wrappers = {"sw_reftrans": (sr, "sw_reftrans_levels_fused"),
                    "lw_reftrans": (sr, "lw_reftrans_levels_fused"),
                    "sw_adding": (sa, "sw_adding_sweeps_fused"),
                    "lw_adding": (sa, "lw_adding_sweeps_fused")}
        real = {k: getattr(m, a) for k, (m, a) in wrappers.items()}
        for k, (m, a) in wrappers.items():
            setattr(m, a, lambda *x, _k=k, **kw: (
                kept.__setitem__(_k, x), real[_k](*x, **kw))[1])
        try:
            radiation(setup, *columns_to_inputs(cols, device=dev))
            torch.cuda.synchronize()
        finally:
            for k, (m, a) in wrappers.items():
                setattr(m, a, real[k])
        want = {k: real[k](*kept[k]) for k in wrappers}
        torch.cuda.synchronize()
        base = _cuda._lib
        for (name, i), (lib, proc) in builds.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                print(log)
                raise RuntimeError(f"{name} candidate {i} failed to build")
            consts = CANDIDATES[name][i]
            _cuda._lib = load(lib)
            try:
                if name == "spartacus_reftrans":
                    rows = []
                    for kind in ("sw", "lw"):
                        one, two, out = reftrans_passes(kind,
                                                        kept[kind +
                                                             "_reftrans"])
                        t1 = events_ms(one, args.reps)
                        one()
                        t2 = events_ms(two, args.reps)
                        torch.cuda.synchronize()
                        same = torch.equal(out, want[kind + "_reftrans"])
                        info = [_cuda.kernel_info(
                            f"spartacus_{kind}_reftrans_info_f64", p, 3)
                            for p in (1, 0)]
                        rows.append(
                            f"{kind} 3D pass {t1:.4f} ms ({info[0]['registers']}"
                            f" regs, {info[0]['local_bytes']} B local, "
                            f"{info[0]['blocks_per_sm']} blocks/SM), every "
                            f"cell {t2:.4f} ms ({info[1]['registers']} regs, "
                            f"{info[1]['local_bytes']} B local, "
                            f"{info[1]['blocks_per_sm']} blocks/SM), "
                            f"equal {same}")
                else:
                    rows = []
                    for kind, k in (("B8", "sw_adding"), ("B9", "lw_adding")):
                        fn = getattr(sa, wrappers[k][1])
                        a = kept[k]
                        t = events_ms(lambda: fn(*a), args.reps)
                        got = fn(*a)
                        torch.cuda.synchronize()
                        same = all(torch.equal(x, y)
                                   for x, y in zip(got, want[k]))
                        info = (_cuda.kernel_info(
                            "spartacus_sw_adding_info_f64", 3)
                            if kind == "B8" else _cuda.kernel_info(
                                "spartacus_lw_adding_info_f64", int(bool(
                                    a[0].do_3d_lw_multilayer_effects)), 3))
                        rows.append(
                            f"{kind} {t:.4f} ms ({info['registers']} regs, "
                            f"{info['local_bytes']} B local, "
                            f"{info['dynamic_smem']} B shared, "
                            f"{info['blocks_per_sm']} blocks of "
                            f"{info['threads']}/SM), equal {same}")
            finally:
                _cuda._lib = base
            print(f"{name} {consts}: " + "; ".join(rows) + f" [{gpu}]",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
