#!/usr/bin/env python3
"""Kernel B10's time on each of the per-band path's 30 calls at every
tile `gather_interp.plan` may pick, on one GPU.

    python3 tools/b10_tiles.py [--ncol 2048] [--nlev 137] [--reps 20]

Builds the 30 eval_sections calls of one per-band gas-optics call on the
columns of ecrad_tpu_torch.inputs (seed 0), packs each once, and times
its launch at every multiple of 32 cells up to gather_interp.TILE_MAX
whose block fits an SM (CUDA events over `--reps` replays of a CUDA
graph, so no host gap is counted), checking each output equal to the
plain version by value. Prints, per call, G, terms, operands, the best
tile and its ms, and plan's tile and its ms; then the sums over the 30
calls of the best tiles, of plan's, and of a fixed tile of 64 and of
128 cells. These fit the plan's TILE_COST. Exits 1 without a GPU.
"""
import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

GASES = ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12", "hcfc22", "ccl4",
         "o3")


def graph_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ncol", type=int, default=2048)
    ap.add_argument("--nlev", type=int, default=137)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    from ecrad_tpu_torch.config import cloudless_slice_config
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.inputs import make_columns
    from ecrad_tpu_torch.interface import setup_radiation
    from ecrad_tpu_torch.ops import _cuda, gather_interp as gi
    from ecrad_tpu_torch.optics.rrtmg import (taumol_lw_sections,
                                              taumol_sw_sections)
    from ecrad_tpu_torch.optics.rrtmg.setcoef import prepare_gases, setcoef
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    setup = setup_radiation(cloudless_slice_config(), device=dev)
    _, th, gas = columns_to_inputs(make_columns(args.ncol, args.nlev, 0),
                                   device=dev)
    t = setup.tables
    phl, thl = th.pressure_hl, th.temperature_hl
    gc = prepare_gases(phl, 0.5 * (phl[:, :-1] + phl[:, 1:]),
                       0.5 * (thl[:, :-1] + thl[:, 1:]),
                       *(gas.get(g) for g in GASES))
    c = setcoef(gc, setup.gas.preflog, setup.gas.tref, setup.gas.chi_mls)
    calls = []

    def keep(secs, n):
        calls.append((secs, n))
        return gi.eval_sections_plain(secs, n)
    for mod in (taumol_lw_sections, taumol_sw_sections):
        mod.eval_sections = keep
    taumol_lw_sections.taumol_lw_sections(c, t, toa_first=True)
    taumol_sw_sections.taumol_sw_sections(c, setup.gas, toa_first=True)

    sums = {"best": 0.0, "plan": 0.0, 64: 0.0, 128: 0.0}
    for i, (secs, n) in enumerate(calls):
        p = gi.pack_sections(secs, n, dev)
        nptr = p.ptrs.numel()
        ref = gi.eval_sections_plain(secs, n)
        out = torch.empty((p.g, n), device=dev)
        times = {}
        for tile in range(32, gi.TILE_MAX + 1, 32):
            if gi.smem_bytes(tile, p.nterms, nptr, p.g) > gi.SMEM_MAX \
                    or _cuda.kernel_info("gather_sections_info", tile,
                                         p.nterms, nptr,
                                         p.g)["blocks_per_sm"] < 1:
                break
            times[tile] = graph_ms(lambda: _cuda.launch(
                "gather_sections", p.desc, p.desc.numel(), p.ptrs, nptr,
                p.tab, n, p.g, tile, out), args.reps)
            if not torch.equal(out, ref):
                raise AssertionError(f"call {i} differs at tile {tile}")
        best = min(times, key=times.get)
        plan = gi._plan_on_card(n, p.nterms, nptr, p.g)
        print(f"call {i:2d}: G {p.g:2d}, {p.nterms:2d} terms, {nptr:2d} "
              f"operands; best tile {best} {times[best]:.4f} ms, plan's "
              f"{plan} {times[plan]:.4f} ms")
        sums["best"] += times[best]
        sums["plan"] += times[plan]
        for tile in (64, 128):
            sums[tile] += times.get(tile, float("nan"))
    print(f"sum over the {len(calls)} calls, ms: best tiles "
          f"{sums['best']:.4f}, plan's {sums['plan']:.4f}, 64 cells "
          f"{sums[64]:.4f}, 128 cells {sums[128]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
