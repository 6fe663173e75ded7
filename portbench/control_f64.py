#!/usr/bin/env python3
"""The readings that set the float64 cell's limits: the port's in
float64 and the control's one precision below.

    python3 portbench/control_f64.py --seeds 1 2 3 [--workload
        mcica_f64.cols2048] [--device cuda] [--columns N] [--levels L]
        [--no-program]

For each seed, on the pool's first batch of the cell (at the cell's own
size unless --columns/--levels say otherwise): the lower reading, one
call of the port after a warm-up call against the plain reference in
float64 (control.readings); and the upper one, the control: the
reference set up in float32 on the cell's float64 configuration, so
that its cloud generator still draws float64 subcolumns
(reference/interface.py gen_dtype) while every flux is float32, against
the same float64 reference. Prints one JSON line per seed with the
compared numbers (check.py) of both. The benchmark's runs do not run
this: it is how limits/mcica_f64.cols2048.json was set.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import check, columns, control, harness  # noqa: E402

CELL = "mcica_f64.cols2048"


def float32_control(bench, workload, seed, device, ncol=None, levels=None):
    """The float32 reference on the float64 configuration against the
    float64 reference: check.numbers of one seed's first batch."""
    import torch

    from portbench.reference import config as ref_config
    from portbench.reference import interface as ref

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = harness.load_json(harness.HERE, "configs", f"{cell['config']}.json")
    traffic = dict(harness.load_json(harness.HERE, "traffic",
                                     f"{cell['traffic']}.json"))
    traffic["pool"] = 1
    if levels:
        traffic["levels"] = levels
    dev = torch.device(device)
    lut_dir = tempfile.mkdtemp(prefix="portbench-luts-")
    try:
        columns.write_synthetic_luts(lut_dir, seed)
        rcfg = ref_config.from_fields(conf["fields"], directory_name=lut_dir)
        batch = harness.make_pool(traffic, seed, rcfg.use_aerosols, ncol,
                                  conf.get("cloud_geometry"))[0]
        low = {}
        for dtype in (torch.float64, torch.float32):
            rsetup = ref.setup(rcfg, dev, dtype=dtype)
            low[dtype] = dict(ref.radiation(
                rsetup, *ref.columns_to_inputs(batch, dev)).fields())
            del rsetup
        return check.numbers(low[torch.float32], low[torch.float64])
    finally:
        shutil.rmtree(lut_dir, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--columns", type=int)
    ap.add_argument("--levels", type=int)
    ap.add_argument("--no-program", action="store_true")
    args = ap.parse_args()
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        out = {}
        if not args.no_program:
            out = control.readings(bench, args.workload, seed, args.device,
                                   args.columns, args.levels, True, False)
        out["upper"] = float32_control(bench, args.workload, seed,
                                       args.device, args.columns,
                                       args.levels)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
