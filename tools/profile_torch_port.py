#!/usr/bin/env python3
"""Where the time of the PyTorch port's Cloudless, McICA, Tripleclouds or
SPARTACUS path goes, on one GPU.

    python3 tools/profile_torch_port.py
        [--solver cloudless|mcica|tripleclouds|spartacus] [--ncol 2048]
        [--nlev 137] [--calls 3] [--out-dir profile_out] [--multilayer]
        [--no-trace]

Runs setup_radiation + radiation on the columns of
ecrad_tpu_torch.inputs (seed 0; for McICA and Tripleclouds with
make_clouds' clouds and the SYNTHETIC LUTs of write_synthetic_luts,
written into --out-dir; for Tripleclouds also make_aerosols' aerosols) on
cuda:0, warms up, then traces `--calls` back-to-back calls with
torch.profiler. Prints the device time by kernel name (the 25 longest
kernels and every kernel of the port's csrc/), the device-busy
share of the traced window (union of kernel and copy intervals over the
window's wall time) and the wall time per call; for each stage span
(gas optics, the cloud stage, each solver; inside the McICA solvers the
cloud generator with its threefry draws and its cumulative cloud cover;
for Tripleclouds the aerosol stage, the region properties and overlap
matrices, every two-stream reflectance/transmittance call, the two B5
sweeps and the LW derivatives; for SPARTACUS, on the same columns with
add_effective_sizes, also the B6/B7 reftrans and B8/B9 adding calls) its
host time and the device time of the kernels it launched.
Writes the full table and a gzipped Chrome trace into --out-dir (file
names carry the solver). --multilayer turns SPARTACUS's LW multilayer 3D
effects on (kernel B9 then keeps its full albedo scratch). --no-trace
runs no profiler: it times the `--calls` back-to-back calls on the host
clock, with a synchronise, and prints only the JSON line {"solver",
"wall_ms", "card"}; run from two checkouts in turn, it compares their
paths on one card. With ECRAD_HOOK=1 the spans also keep the host
accounting of ecrad_tpu_torch.utils.hooks, and the script prints its
profile_report of the traced calls (host wall and CPU time per span)
beside the device-busy share. Exits 1 without a GPU.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def busy_share(events, t0, t1):
    """Union of device intervals (us) inside [t0, t1] over its length."""
    spans = sorted((max(s, t0), min(e, t1)) for s, e in events
                   if e > t0 and s < t1)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / max(t1 - t0, 1e-9)


def add_spans(solver, replaced):
    """Wrap the stages in hooks.hook spans (torch.profiler spans; with
    ECRAD_HOOK=1 also the profiler's host accounting) by replacing the
    module attributes the path calls them through. Returns the span
    names; each (module, attribute, original) replaced is appended to
    the list `replaced`, for remove_spans."""
    from ecrad_tpu_torch import interface
    from ecrad_tpu_torch.solvers import (cloud_generator, mcica,
                                         spartacus_lw, spartacus_sw,
                                         tripleclouds, two_stream)
    from ecrad_tpu_torch.utils.hooks import hook

    def span(module, attr, name):
        fn = getattr(module, attr)

        def wrapped(*a, **k):
            with hook(name):
                return fn(*a, **k)
        replaced.append((module, attr, fn))
        setattr(module, attr, wrapped)
        return name

    names = [span(interface, "gas_optics", "gas_optics")]
    if solver == "cloudless":
        return names + [span(interface, "solver_cloudless_lw", "solver_lw"),
                        span(interface, "solver_cloudless_sw", "solver_sw")]
    if solver == "spartacus":
        return names + [
            span(interface, "add_aerosol_optics", "aerosol"),
            span(interface, "_cloud_stage", "cloud_stage"),
            span(interface, "solve_lw", "solver_lw"),
            span(interface, "solve_sw", "solver_sw"),
            *{span(m, "regions_and_overlap", "region_props")
              for m in (spartacus_sw, spartacus_lw)},
            *{span(two_stream, f, "reftrans") for f in (
                "sw_reftrans", "lw_reftrans",
                "lw_no_scattering_transmittance")},
            *{span(m, f, "spartacus_reftrans") for m, f in (
                (spartacus_sw, "sw_reftrans_levels"),
                (spartacus_lw, "lw_reftrans_levels"))},
            *{span(m, f, "spartacus_adding") for m, f in (
                (spartacus_sw, "sw_adding_sweeps"),
                (spartacus_lw, "lw_adding_sweeps"))},
            span(spartacus_lw, "lw_derivatives_matrix", "lw_derivatives")]
    if solver == "tripleclouds":
        return names + [
            span(interface, "add_aerosol_optics", "aerosol"),
            span(interface, "_cloud_stage", "cloud_stage"),
            span(interface, "solve_lw", "solver_lw"),
            span(interface, "solve_sw", "solver_sw"),
            span(tripleclouds, "_regions", "region_props"),
            *{span(two_stream, f, "reftrans") for f in (
                "sw_reftrans", "lw_reftrans",
                "lw_no_scattering_transmittance")},
            *{span(tripleclouds, f, "tc_sweeps")
              for f in ("tc_sw_sweeps", "tc_lw_sweeps")},
            span(tripleclouds, "lw_derivatives_region", "lw_derivatives")]
    return names + [
        span(interface, "_cloud_stage", "cloud_stage"),
        span(interface, "solve_lw", "solver_lw"),
        span(interface, "solve_sw", "solver_sw"),
        span(mcica, "_generate", "cloud_generator"),
        span(cloud_generator, "random_fields", "threefry"),
        *{span(cloud_generator, f"cum_cloud_cover_{o}", "cloud_cover")
          for o in ("exp_exp", "exp_ran", "max_ran")}]


def remove_spans(replaced):
    """Put back the attributes add_spans replaced, last first."""
    while replaced:
        module, attr, fn = replaced.pop()
        setattr(module, attr, fn)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--solver", choices=("cloudless", "mcica",
                                         "tripleclouds", "spartacus"),
                    default="cloudless")
    ap.add_argument("--ncol", type=int, default=2048)
    ap.add_argument("--nlev", type=int, default=137)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out-dir", default=os.path.join(REPO, "profile_out"))
    ap.add_argument("--multilayer", action="store_true")
    ap.add_argument("--no-trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script profiles the port on a GPU only")
        return 1
    from torch.profiler import ProfilerActivity, profile

    from ecrad_tpu_torch.config import (cloudless_slice_config,
                                        mcica_slice_config,
                                        spartacus_slice_config,
                                        tripleclouds_slice_config)
    from ecrad_tpu_torch.convert import columns_to_inputs
    from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                        make_clouds, make_columns,
                                        write_synthetic_luts)
    from ecrad_tpu_torch.interface import radiation, setup_radiation
    from ecrad_tpu_torch.utils import hooks

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    cols = make_columns(args.ncol, args.nlev, 0)
    lut_dir = os.path.join(out_dir, "synthetic_luts")
    if args.solver == "cloudless":
        config = cloudless_slice_config()
    elif args.solver == "mcica":
        config = mcica_slice_config(**write_synthetic_luts(lut_dir, 0))
        cols = make_clouds(cols, 0)
    else:
        luts = write_synthetic_luts(lut_dir, 0, ice="fu")
        config = (spartacus_slice_config(
            do_3d_lw_multilayer_effects=args.multilayer, **luts)
            if args.solver == "spartacus" else
            tripleclouds_slice_config(**luts))
        cols = make_aerosols(make_clouds(cols, 0), 0)
        if args.solver == "spartacus":
            cols = add_effective_sizes(cols)
    setup = setup_radiation(config, device=dev)
    inputs = columns_to_inputs(cols, device=dev)
    span_names = [] if args.no_trace else add_spans(args.solver, [])
    for _ in range(2):
        radiation(setup, *inputs)
    torch.cuda.synchronize()
    if args.no_trace:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            radiation(setup, *inputs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.calls
        print(json.dumps({"solver": args.solver, "wall_ms": wall * 1e3,
                          "card": gpu}))
        return 0

    hooks.reset_profile()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            radiation(setup, *inputs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.calls
    tag = "" if args.solver == "cloudless" else "_" + args.solver
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"torch_port_trace{tag}.json.gz"))

    events = list(prof.events())
    # device work only: the spans' own device-side annotations are not
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in span_names]
    spans = [(e.time_range.start, e.time_range.end) for e in dev_events]
    share = busy_share(spans, min(e.time_range.start for e in events),
                       max(e.time_range.end for e in events))

    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (e.time_range.end
                                        - e.time_range.start))
    total_us = sum(us for _, us in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    with open(os.path.join(out_dir, f"torch_port_profile{tag}.txt"),
              "w") as f:
        f.write(table)
    # the spans' host-side events; their device time is that of the
    # kernels launched inside them
    avg = {e.key: e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU}
    dev_us = lambda e: getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0))
    print(f"card: {gpu}")
    print(f"{args.solver} {args.ncol} x {args.nlev}, {args.calls} traced "
          f"calls: wall "
          f"{wall * 1e3:.3f} ms per call, device time {total_us / 1e3 / args.calls:.3f} ms per call, "
          f"device busy {share:.1%} of the traced window [{gpu}]")
    print(f"device kernels: {len(dev_events) // args.calls} per call")
    # the 25 longest kernels, and the port's own (csrc/) below that cut
    for k, (name, (n, us)) in enumerate(rows):
        if k < 25 or "ecrad::" in name:
            print(f"  {us / 1e3 / args.calls:9.4f} ms/call "
                  f"{n // args.calls:5d}x {us / total_us:6.1%}  {name[:90]}")
    stages = {}
    for name in span_names:
        e = avg.get(name)
        if e is None:
            continue
        host, devt = e.cpu_time_total / 1e3 / args.calls, \
            dev_us(e) / 1e3 / args.calls
        stages[name] = {"host_ms": host, "device_ms": devt}
        print(f"  span {name:16s} host {host:9.3f} ms/call "
              f"({host / (wall * 1e3):6.1%} of wall), device {devt:9.4f} "
              f"ms/call ({devt * 1e3 * args.calls / max(total_us, 1e-9):6.1%}"
              f" of device time), {e.count // args.calls} per call")
    if hooks.LHOOK:
        # host accounting of the traced calls (ECRAD_HOOK=1): wall and CPU
        # time around the launches, not device time
        print(f"hooks.profile_report, {args.calls} traced calls [{gpu}]:")
        print(hooks.profile_report())
    print(json.dumps({"solver": args.solver, "wall_ms": wall * 1e3,
                      "device_ms": total_us / 1e3 / args.calls,
                      "device_busy": share, "stages": stages,
                      "card": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
