#!/usr/bin/env python3
"""The readings that set a cell's limits: the port's and the control's.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3
        [--device cuda] [--columns N] [--levels L] [--no-program]
        [--no-control]

For each seed: the lookup tables and the pool's first batch of the cell,
at the cell's own size unless --columns/--levels say otherwise; one call
of the port (the timed path's entry, interface.radiation, after a
warm-up call), the plain reference in float64, and the control: the
reference in the port's place computed in bfloat16
(reference/lowprec.py). Prints one JSON line per seed with the compared
numbers (check.py) of the port ("lower") and of the control ("upper"),
each against the float64 reference; --no-program and --no-control leave
one of the two out. The benchmark's runs do not run this: it is how the
limits of limits/<cell>.json were read.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import check, columns, harness  # noqa: E402


def readings(bench, workload, seed, device, ncol=None, levels=None,
             program=True, lowprec=True):
    """{"lower": numbers of the port, "upper": numbers of the control}
    of one seed's first batch."""
    import torch

    from portbench.reference import config as ref_config
    from portbench.reference import interface as ref
    from portbench.reference.lowprec import bfloat16_rounding

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = harness.load_json(harness.HERE, "configs", f"{cell['config']}.json")
    traffic = dict(harness.load_json(harness.HERE, "traffic",
                                     f"{cell['traffic']}.json"))
    traffic["pool"] = 1
    if levels:
        traffic["levels"] = levels
    dev = torch.device(device)
    lut_dir = tempfile.mkdtemp(prefix="portbench-luts-")
    out = {}
    try:
        columns.write_synthetic_luts(lut_dir, seed)
        rcfg = ref_config.from_fields(conf["fields"], directory_name=lut_dir)
        aerosols = rcfg.use_aerosols
        batch = harness.make_pool(traffic, seed, aerosols, ncol,
                                  conf.get("cloud_geometry"))[0]
        if program:
            from ecrad_tpu_torch import convert, interface
            setup = interface.setup_radiation(
                harness.program_config(conf["fields"], lut_dir), device=dev)
            inputs = convert.columns_to_inputs(batch, device=dev)
            interface.radiation(setup, *inputs)
            got = {k: v.detach().to("cpu") for k, v in
                   interface.radiation(setup, *inputs).fields()}
            del setup, inputs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        rsetup = ref.setup(rcfg, dev, dtype=torch.float64)
        truth = dict(ref.radiation(
            rsetup, *ref.columns_to_inputs(batch, dev)).fields())
        del rsetup
        if program:
            got = {k: v.to(dev) for k, v in got.items()}
            out["lower"] = check.numbers(got, truth)
            out["lower_widest"] = check.widest_gap(got, truth)
        if not lowprec:
            return out
        csetup = ref.setup(rcfg, dev, dtype=torch.float32)
        with bfloat16_rounding():
            low = dict(ref.radiation(
                csetup, *ref.columns_to_inputs(batch, dev)).fields())
        out["upper"] = check.numbers(low, truth)
    finally:
        shutil.rmtree(lut_dir, ignore_errors=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--columns", type=int)
    ap.add_argument("--levels", type=int)
    ap.add_argument("--no-program", action="store_true")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args()
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        r = readings(bench, args.workload, seed, args.device, args.columns,
                     args.levels, not args.no_program,
                     not args.no_control)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
