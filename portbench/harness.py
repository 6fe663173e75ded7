"""One run of one benchmark cell of ecrad_tpu_torch.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A run:
  1. reads the cell from BENCHMARK.json, its configuration from
     configs/<config>.json and its traffic from traffic/<traffic>.json;
  2. writes the lookup tables of the seed (columns.write_synthetic_luts)
     into a directory under TMPDIR, builds the port's setup
     (`interface.setup_radiation`) and a pool of `pool` batches made from
     the seeds seed .. seed + pool - 1, on the card;
  3. warms up with `warmup_calls` calls of the cell's own shape: that is
     set-up, with the kernel library's build on a checkout's first run;
  4. runs the window: one caller in a closed loop, each call
     `interface.radiation(...)` on the next batch of the pool and a
     `torch.cuda.synchronize()`, until `--seconds` have passed, with
     Python's garbage collector frozen and off (with `--trace 1`,
     `trace_calls` calls timed on the host's clock with the spans that
     the cell's per-layer metrics name, then as many under
     torch.profiler);
  5. copies the outputs of a sample of the window's calls, drawn from the
     seed, and of its last call to the host;
  6. reads the peak memory, frees the port's state, runs the plain
     reference (reference/, float64) on each sampled call's batch and
     compares every output field (check.py) against the limits of
     limits/<cell>.json;
  7. prints each compared number beside its limit on standard error, and
     one JSON line on standard output.

Metrics are files of their own, metrics/<name>.py: an end-to-end metric
reads the window (`read(window)`), a per-layer one the trace
(`read(trace)`, with the spans it needs in SPANS). A reader that finds
nothing to read returns None and the metric is left out of the line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from . import check, columns, roofline
from . import trace as trace_mod
from .trace import PREFIX

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "ecrad_tpu")
#: the port's table of ecRad names of each enum-valued field
ENUM_TABLES = {"i_gas_model": "GAS_MODEL_NAMES",
               "i_liq_model": "LIQUID_MODEL_NAMES",
               "i_ice_model": "ICE_MODEL_NAMES",
               "i_solver_sw": "SOLVER_NAMES", "i_solver_lw": "SOLVER_NAMES",
               "i_overlap_scheme": "OVERLAP_NAMES",
               "i_cloud_pdf_shape": "PDF_SHAPE_NAMES",
               "i_3d_sw_entrapment": "ENTRAPMENT_NAMES"}


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    """The module of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, workload: str, kind: str) -> List[dict]:
    """The metrics of `kind` (end_to_end, per_layer) this cell reports."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def program_config(fields: dict, lut_dir: str):
    """The port's RadiationConfig of a configuration file's fields."""
    from ecrad_tpu_torch import config as pc
    kwargs = {}
    for key, value in fields.items():
        if key in ENUM_TABLES:
            value = getattr(pc, ENUM_TABLES[key])[value]
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[key] = value
    return pc.RadiationConfig(directory_name=lut_dir, **kwargs)


def make_pool(traffic: dict, seed: int, aerosols: bool,
              ncol: Optional[int] = None,
              geometry: Optional[dict] = None) -> List[dict]:
    """The traffic's batches from seed .. seed + pool - 1, with the
    cloud's inverse effective sizes of `geometry` (a configuration's
    cloud_geometry) where it is given, float arrays rounded to float32
    (the precision both the port and the reference are handed)."""
    ncol = ncol or traffic["columns"]
    pool = []
    for s in range(seed, seed + traffic["pool"]):
        cols = columns.make_columns(ncol, traffic["levels"], s)
        cols = columns.make_clouds(cols, s, **traffic["clouds"])
        if geometry is not None:
            cols = columns.add_effective_sizes(cols, **geometry)
        if aerosols:
            cols = columns.make_aerosols(cols, s)
        pool.append({k: v.astype(np.float32)
                     if isinstance(v, np.ndarray) and v.dtype == np.float64
                     else v for k, v in cols.items()})
    return pool


class Spans:
    """The benchmark's spans around the port's functions: each
    "module:attribute" named by a per-layer metric is replaced by a
    wrapper that opens a record_function span `portbench.<label>`; while
    `timing`, adds the host seconds of the label's outermost calls to
    `host_s`, and while `recording`, adds the call's boundary work
    (roofline.py) to its label; work counted from the call's tensors is
    added when `settle()` is called, after the window."""

    def __init__(self, wanted: Dict[str, List[str]]):
        import torch
        self._replaced = []
        self.missing = set()
        self.recording = False
        self.timing = False
        self.work = {}
        self.host_s = {}
        self._depth = {}
        for label, targets in wanted.items():
            self.work[label] = {"least_s": 0.0, "ops": 0.0, "unknown": False,
                                "later": []}
            self.host_s[label] = 0.0
            self._depth[label] = 0
            for target in targets:
                module_name, attr = target.split(":")
                try:
                    module = importlib.import_module(module_name)
                    fn = getattr(module, attr)
                except (ImportError, AttributeError):
                    self.missing.add(label)
                    print(f"note: span {label}: {target} not found; the "
                          f"metrics that read it are left out",
                          file=sys.stderr)
                    continue
                setattr(module, attr, self._wrap(fn, label, target, torch))
                self._replaced.append((module, attr, fn))

    def _wrap(self, fn, label, target, torch):
        def wrapped(*args, **kwargs):
            self._depth[label] += 1
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(PREFIX + label):
                    out = fn(*args, **kwargs)
            finally:
                self._depth[label] -= 1
            if self.timing and self._depth[label] == 0:
                self.host_s[label] += time.perf_counter() - t0
            if self.recording and self._depth[label] == 0:
                nbytes, ops = roofline.call_work(target, args, kwargs, out)
                w = self.work[label]
                if ops is None:
                    w["unknown"] = True
                elif callable(ops):
                    w["later"].append((nbytes, ops))
                else:
                    w["least_s"] += roofline.least_time_s(nbytes, ops)
                    w["ops"] += ops
            return out
        return wrapped

    def settle(self):
        """Count the work that was left to be read from the calls'
        tensors, and let go of them."""
        for w in self.work.values():
            while w["later"]:
                nbytes, count = w["later"].pop()
                ops = float(count())
                w["least_s"] += roofline.least_time_s(nbytes, ops)
                w["ops"] += ops

    def remove(self):
        while self._replaced:
            module, attr, fn = self._replaced.pop()
            setattr(module, attr, fn)


@dataclasses.dataclass
class Window:
    """What the end-to-end readers read."""
    calls: List[tuple]          # (start, end) of each call, host seconds
    columns: int                # columns per call
    setup_s: float
    peak_bytes: int             # allocated above what was before the window


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             ncol: Optional[int] = None, levels: Optional[int] = None
             ) -> dict:
    """One run; returns the result line's dict. `ncol` and `levels`
    shrink the traffic for the CPU tests only."""
    import torch

    from ecrad_tpu_torch import convert, interface

    t_start = time.perf_counter() if t_start is None else t_start
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = dict(load_json(HERE, "traffic", f"{cell['traffic']}.json"))
    if levels:
        traffic["levels"] = levels
    limits = load_json(HERE, "limits", f"{workload}.json")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    stamps = [("start", t_start)]

    def stamp(name):
        stamps.append((name, time.perf_counter()))

    lut_dir = tempfile.mkdtemp(prefix="portbench-luts-")
    try:
        stamp("imports")
        columns.write_synthetic_luts(lut_dir, seed)
        stamp("luts")
        config = program_config(conf["fields"], lut_dir)
        setup = interface.setup_radiation(config, device=dev)
        stamp("setup_radiation")
        pool = make_pool(traffic, seed, config.use_aerosols, ncol,
                         conf.get("cloud_geometry"))
        ncols = pool[0]["pressure_hl"].shape[0]
        inputs = [convert.columns_to_inputs(c, device=dev) for c in pool]
        stamp("pool")

        readers = {}
        wanted: Dict[str, List[str]] = {}
        if trace:
            for m in cell_metrics(bench, workload, "per_layer"):
                readers[m["name"]] = load_reader(m["name"])
                for label, targets in readers[m["name"]].SPANS.items():
                    wanted.setdefault(label, [])
                    wanted[label] += [t for t in targets
                                      if t not in wanted[label]]
        spans = Spans(wanted)
        try:
            for i in range(traffic["warmup_calls"]):
                interface.radiation(setup, *inputs[i % len(inputs)])
            sync()
            stamp("warmup")
            if cuda:
                setup_peak = torch.cuda.max_memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            setup_s = time.perf_counter() - t_start

            rng = np.random.default_rng(seed)
            calls, kept = [], []
            prof = None
            host = None
            if trace:
                # the spans' host times and the calls' wall, untraced
                spans.timing = True
                host_calls = []
                for i in range(traffic["trace_calls"]):
                    t0 = time.perf_counter()
                    interface.radiation(setup, *inputs[i % len(inputs)])
                    sync()
                    host_calls.append(time.perf_counter() - t0)
                spans.timing = False
                host = trace_mod.HostTimes(host_calls, dict(spans.host_s))
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA] if cuda
                      else [])])
                prof.start()
                # the profiler's own first-call costs stay out of the window
                interface.radiation(setup, *inputs[0])
                sync()
                spans.recording = True
            gc.collect()
            gc.freeze()
            gc.disable()
            deadline = time.perf_counter() + seconds
            i = 0
            while True:
                batch = i % len(inputs)
                t0 = time.perf_counter()
                with torch.profiler.record_function(PREFIX + "call"):
                    flux = interface.radiation(setup, *inputs[batch])
                    sync()
                t1 = time.perf_counter()
                calls.append((t0, t1))
                i += 1
                last = t1 >= deadline or (trace
                                          and i >= traffic["trace_calls"])
                if last or rng.random() < traffic["check_share"]:
                    kept.append((batch, {k: v.detach().to("cpu")
                                         for k, v in flux.fields()}))
                del flux
                if last:
                    break
            gc.enable()
            gc.unfreeze()
            spans.recording = False
            stamp("window")
            trace_path = None
            if trace:
                prof.stop()
                spans.settle()
                trace_dir = tempfile.mkdtemp(prefix="portbench-trace-")
                trace_path = os.path.join(trace_dir, "trace.json")
                prof.export_chrome_trace(trace_path)
                del prof
            peak = (torch.cuda.max_memory_allocated(dev) - base
                    if cuda else 0)
            memory_peak = (max(setup_peak, torch.cuda.max_memory_allocated(dev))
                           if cuda else 0)
            print(f"note: the window's calls took {peak / 2 ** 20:.1f} MiB "
                  f"at their peak above the {base / 2 ** 20 if cuda else 0:.1f}"
                  f" MiB before it", file=sys.stderr)
        finally:
            spans.remove()
        del setup, inputs
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        result = {"attempted": len(calls)}
        window = Window(calls=calls, columns=ncols, setup_s=setup_s,
                        peak_bytes=peak)
        metrics = {}
        breakdown = None
        if trace:
            t = trace_mod.load(trace_path, spans.work, host)
            shutil.rmtree(os.path.dirname(trace_path), ignore_errors=True)
            for m in cell_metrics(bench, workload, "per_layer"):
                reader = readers[m["name"]]
                value = (None if set(reader.SPANS) & spans.missing
                         else reader.read(t))
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = {"device_ops": [list(x) for x in t.top_ops()],
                         "idle_gaps": [list(x) for x in t.top_gaps()]}
            busy_s, window_s = t.busy_s, t.window_s
        else:
            for m in cell_metrics(bench, workload, "end_to_end"):
                value = load_reader(m["name"]).read(window)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        stamp("trace" if trace else "metrics")
        # the reference, once the window is closed and the port's state
        # freed: one run per distinct batch of the checked calls
        from .reference import config as ref_config
        from .reference import interface as ref

        rcfg = ref_config.from_fields(conf["fields"], directory_name=lut_dir)
        rsetup = ref.setup(rcfg, dev, dtype=torch.float64)
        per_call = []
        for batch in sorted({b for b, _ in kept}):
            flux = ref.radiation(rsetup,
                                 *ref.columns_to_inputs(pool[batch], dev))
            expect = dict(flux.fields())
            del flux
            for b, out in kept:
                if b == batch:
                    got = {k: v.to(dev) for k, v in out.items()}
                    per_call.append(check.numbers(got, expect))
                    print(f"note: batch {b}: widest flux gap at "
                          f"{check.widest_gap(got, expect)}",
                          file=sys.stderr)
                    del got
            del expect
        del rsetup
        stamp("reference")
    finally:
        shutil.rmtree(lut_dir, ignore_errors=True)
    for (_, a), (name, b) in zip(stamps, stamps[1:]):
        print(f"time {name} {b - a:.3f} s", file=sys.stderr)

    nums = check.worst(per_call)
    failed = sum(bool(check.failures(n, limits)) for n in per_call)
    result.update(
        correct=bool(per_call) and failed == 0,
        failed=failed,
        metrics=metrics,
        device={"platform": "gpu" if cuda else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if cuda
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(memory_peak)})
    if trace:
        result["device"].update(busy_s=busy_s, window_s=window_s)
        result["breakdown"] = breakdown
        result["traced_call_s"] = window_s / max(len(calls), 1)
    result["checked_calls"] = len(per_call)
    result["check"] = {k: {"value": v, "limit": limits[k]}
                       for k, v in nums.items()}
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no module of JAX or of the JAX "
              f"package may run here", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
