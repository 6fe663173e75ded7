"""The program's own spans and counters, beside the benchmark's.

The port names its layer boundaries, the cloud generator's stages and
each statement of a call that blocks the host on the device itself
(ecrad_tpu_torch/utils/hooks.py): `ecrad.*` record_function spans while
a trace runs, `sync.*` and `cloud_cover.merge_passes` counters while its
hooks are on. Two uses here:

- Helpers for the per-layer readers, on the harness's Trace, whose
  spans are the benchmark's own `portbench.<label>` wrappers around the
  port's functions (a reader names them in SPANS): how many spans of a
  label began inside the window's calls (`span_count`), and the device
  idle time in gaps that began inside a label's spans (`idle_in_s`).
- `ProgramTrace`, a Trace that also reads the `ecrad.*` spans, and the
  command below, which runs a cell's calls with both span systems on and
  prints what each sees:

    python3 -m portbench.program --workload <cell> --seed <n> \\
        [--calls 8] [--out <file.json>]

  It times a scope's entry with the hooks off and on, and the calls with
  the program's hooks off and on in turns (off, on, on, off; the
  counters, the scopes' entries and their host self time a call come
  from the calls with the hooks on), runs one call under
  torch.cuda.set_sync_debug_mode("warn") and compares the warnings with
  the sync counters, then traces `--calls` calls with the hooks off and
  every `portbench/spans.py` layer wrapped: the device ms of each layer
  by either span system, the generator's stages, the five readers'
  values, and the ten longest idle gaps with the innermost program span
  open at each one's start and the CUDA runtime calls the host made
  inside it.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import warnings
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from .trace import LAUNCH_CATS, Trace, _inside, merge

#: the prefix of the program's span names
PROGRAM = "ecrad."


def _starts_in(merged, t) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t < merged[i][1]


def _window_spans(raw, calls) -> List[Tuple[float, float]]:
    """The spans of `raw` [(start, end)] that began inside a call."""
    return [(s, e) for s, e in raw if _starts_in(calls, s)]


def gaps(t: Trace) -> List[Tuple[float, float]]:
    """The stretches of the window in which the device ran nothing,
    (start, end) in trace microseconds, in order."""
    w0, w1 = t._w
    edges = [w0] + [x for s, e in t._busy for x in (s, e)] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def _idle_in(t: Trace, merged) -> float:
    """Seconds of the window's gaps that began inside `merged`."""
    return sum(e - s for s, e in gaps(t) if _starts_in(merged, s)) * 1e-6


def span_count(t: Trace, label: str) -> int:
    """Spans of the benchmark's `label` that began inside the window's
    calls."""
    raw = [(s, e) for s, e, k in t._raw_spans if k == label]
    return len(_window_spans(raw, t._spans.get("call", [])))


def idle_in_s(t: Trace, label: str) -> float:
    """Device idle seconds in the window's gaps that began inside the
    benchmark's `label` spans."""
    return _idle_in(t, t._spans.get(label, []))


class ProgramTrace(Trace):
    """A Trace that also holds the program's `ecrad.*` spans, by name
    without the prefix, the host's CUDA runtime calls and its PyTorch
    operators."""

    def __init__(self, events: List[dict], work: Optional[dict] = None,
                 host=None):
        super().__init__(events, work, host)
        spans = defaultdict(list)
        runtime, host_ops = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            name, cat = str(e.get("name", "")), e.get("cat")
            s = float(e["ts"])
            if cat == "user_annotation" and name.startswith(PROGRAM):
                spans[name[len(PROGRAM):]].append((s, s + float(e["dur"])))
            elif cat in LAUNCH_CATS:
                runtime.append((s, s + float(e["dur"]), name))
            elif cat == "cpu_op":
                host_ops.append((s, s + float(e["dur"]), name))
        self._program = {k: merge(v) for k, v in spans.items()}
        self._program_raw = spans
        self._runtime = sorted(runtime)
        self._host_ops = sorted(host_ops)
        self._sync = merge([x for k, v in spans.items()
                            if k.startswith("sync.") for x in v])

    def program_labels(self) -> List[str]:
        return sorted(self._program)

    def _launched_in_program(self, labels):
        merged = merge([x for k in labels for x in self._program.get(k, [])])
        return [op for op in self.ops
                if op[3] is not None and _inside(merged, op[3])]

    def program_device_s(self, *labels: str) -> float:
        """Device seconds of the work launched inside the union of the
        program's spans of `labels`."""
        return sum(e - s for s, e, _, _ in
                   self._launched_in_program(labels)) * 1e-6

    def program_launches(self, *labels: str) -> int:
        return len(self._launched_in_program(labels))

    def program_count(self, label: str) -> int:
        """Entries of the program's `label` that began inside a call."""
        return len(_window_spans(self._program_raw.get(label, []),
                                 self._spans.get("call", [])))

    def program_sync_idle_s(self) -> float:
        """Device idle seconds in gaps that began inside an
        `ecrad.sync.*` span."""
        return _idle_in(self, self._sync)

    def gap_notes(self, n: int = 10) -> List[dict]:
        """The n longest gaps: length, the innermost program span open at
        the start (the latest begun), the benchmark's label, the CUDA
        runtime calls the host made inside the gap, by name, and the three
        PyTorch operators that took most of its host time (ms, nested
        operators counted in each)."""
        out = []
        for s, e in sorted(gaps(self), key=lambda g: g[0] - g[1])[:n]:
            open_ = [(a, k) for k, v in self._program_raw.items()
                     for a, b in v if a <= s < b]
            bench = [(a, k) for a, b, k in self._raw_spans if a <= s < b]
            calls = Counter(name for a, _, name in self._runtime
                            if s <= a < e)
            ops = Counter()
            for a, b, name in self._host_ops:
                if a < e and b > s:
                    ops[name] += (min(b, e) - max(a, s)) * 1e-3
            out.append({"ms": (e - s) * 1e-3,
                        "program": max(open_)[1] if open_ else None,
                        "benchmark": max(bench)[1] if bench else None,
                        "runtime": dict(calls.most_common()),
                        "host_ops": dict(ops.most_common(3))})
        return out


#: labels both span systems have: the benchmark's label, the program's
#: spans whose union it is compared with
SHARED = {"call": ("radiation",), "gas_optics": ("gas_optics",),
          "aerosol": ("aerosol",), "cloud_optics": ("cloud_optics",),
          "solvers": ("solver_lw", "solver_sw"),
          "cloud_generator": ("cloud_generator",), "regions": ("regions",),
          "layer_optics": ("layer_optics",), "sweeps": ("sweeps",),
          "lw_derivatives": ("lw_derivatives",)}
STAGES = ("cover", "random", "walk", "sample")
#: the per-layer metrics that read what the program's hooks expose
READERS = ("host_syncs_per_call", "sync_idle_ms", "cover_merge_passes",
           "generator_random_ms", "generator_walk_kernels")


def _per_entry_us(hooks, n=200_000) -> float:
    """Host microseconds of one `with hooks.hook(name):` with no profiler,
    the best of 5 loops of n."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with hooks.hook("ecrad.probe"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e6


def measure(workload: str, seed: int, calls: int, device: str = "cuda",
            ncol: Optional[int] = None, levels: Optional[int] = None
            ) -> dict:
    """Everything the module docstring lists, for one cell. `ncol` and
    `levels` shrink the traffic for a CPU rehearsal."""
    import torch

    from ecrad_tpu_torch import convert, interface
    from ecrad_tpu_torch.utils import hooks

    from . import columns, harness, spans
    from .trace import PREFIX

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = harness.load_json(harness.HERE, "configs", f"{cell['config']}.json")
    traffic = dict(harness.load_json(harness.HERE, "traffic",
                                     f"{cell['traffic']}.json"))
    if levels:
        traffic["levels"] = levels
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {"workload": workload, "seed": seed, "calls": calls,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    # the set-up reads every table it needs from the files
    lut_dir = tempfile.mkdtemp(prefix="portbench-luts-")
    try:
        columns.write_synthetic_luts(lut_dir, seed)
        config = harness.program_config(conf["fields"], lut_dir)
        setup = interface.setup_radiation(config, device=dev)
    finally:
        shutil.rmtree(lut_dir, ignore_errors=True)
    pool = harness.make_pool(traffic, seed, config.use_aerosols, ncol)
    inputs = [convert.columns_to_inputs(c, device=dev) for c in pool]

    def call(i):
        flux = interface.radiation(setup, *inputs[i % len(inputs)])
        sync()
        return flux

    for i in range(traffic["warmup_calls"]):
        call(i)
    hooks.enable(False)
    out["hook_entry_us"] = _per_entry_us(hooks)
    hooks.enable(True)
    out["hook_entry_us_accounting"] = _per_entry_us(hooks, 20_000)
    hooks.enable(False)

    # the calls' wall with the hooks off and on, in turns, the collector
    # frozen and off as in the harness's window; the counters and the
    # scopes' entries of the calls with the hooks on
    walls = {False: [], True: []}
    hooks.enable(True)
    hooks.reset_profile()
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        for on in (False, True, True, False):
            hooks.enable(on)
            for i in range(calls):
                t0 = time.perf_counter()
                call(i)
                walls[on].append((time.perf_counter() - t0) * 1e3)
    finally:
        gc.enable()
        gc.unfreeze()
    hooks.enable(True)
    on_calls = len(walls[True])
    out["counters_per_call"] = {k: v / on_calls for k, v in
                                sorted(hooks.counters().items())}
    out["entries_per_call"] = {name: n / on_calls for name, n, _ in
                               sorted(hooks.profile_rows())}
    out["host_self_ms_per_call"] = {name: s * 1e3 / on_calls for name, _, s
                                    in sorted(hooks.profile_rows())}
    hooks.enable(False)
    out["call_ms"] = {"hooks_off": statistics.median(walls[False]),
                      "hooks_on": statistics.median(walls[True]),
                      "hooks_off_runs": walls[False],
                      "hooks_on_runs": walls[True]}

    # one call's syncs: the counters against the synchronising operations
    hooks.enable(True)
    hooks.reset_profile()
    warned = []
    if cuda:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call(0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        warned = [f"{os.path.relpath(w.filename, harness.ROOT)}:{w.lineno}"
                  for w in caught if "synchronizing CUDA operation"
                  in str(w.message)]
    else:
        call(0)
    counts = hooks.counters()
    hooks.enable(False)
    out["one_call"] = {"counters": counts,
                       "syncs": sum(v for k, v in counts.items()
                                    if k.startswith("sync.")),
                       "sync_warnings": len(warned) if cuda else None,
                       "warning_sites": dict(Counter(warned))}

    # the traced calls: both span systems, the hooks off (their host
    # accounting would stretch the gaps), the collector frozen and off
    wanted: Dict[str, List[str]] = {k: list(v)
                                    for k, v in spans.LAYERS.items()}
    for name in READERS:
        for label, targets in harness.load_reader(name).SPANS.items():
            wanted.setdefault(label, [])
            wanted[label] += [x for x in targets if x not in wanted[label]]
    wrapped = harness.Spans(wanted)
    try:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            *([torch.profiler.ProfilerActivity.CUDA] if cuda else [])])
        prof.start()
        call(0)
        gc.collect()
        gc.freeze()
        gc.disable()
        t0 = time.perf_counter()
        for i in range(calls):
            with torch.profiler.record_function(PREFIX + "call"):
                call(i)
        traced_ms = (time.perf_counter() - t0) * 1e3 / calls
        gc.enable()
        gc.unfreeze()
        prof.stop()
        path = os.path.join(tempfile.mkdtemp(prefix="portbench-trace-"),
                            "trace.json")
        prof.export_chrome_trace(path)
        del prof
    finally:
        wrapped.remove()
    with open(path) as f:
        data = json.load(f)
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    t = ProgramTrace(data["traceEvents"] if isinstance(data, dict)
                     else data)
    out["traced_call_ms"] = traced_ms
    out["shared_device_ms"] = {
        label: {"benchmark": t.device_s(label) * 1e3 / t.calls,
                "program": t.program_device_s(*labels) * 1e3 / t.calls}
        for label, labels in SHARED.items()
        if t.has(label) or any(k in t._program for k in labels)}
    out["generator_stages"] = {
        s: {"device_ms": t.program_device_s("cloud_generator." + s)
            * 1e3 / t.calls,
            "launches": t.program_launches("cloud_generator." + s) / t.calls,
            "entries": t.program_count("cloud_generator." + s) / t.calls}
        for s in STAGES if "cloud_generator." + s in t._program}
    out["program_entries_per_call"] = {
        k: t.program_count(k) / t.calls for k in t.program_labels()}
    out["program_sync_idle_ms"] = t.program_sync_idle_s() * 1e3 / t.calls
    out["readers"] = {}
    for name in READERS:
        reader = harness.load_reader(name)
        if set(reader.SPANS) & wrapped.missing:
            continue
        value = reader.read(t)
        if value is not None:
            out["readers"][name] = value
    out["device_idle_pct"] = (100.0 * (1.0 - t.busy_s / t.window_s)
                              if t.busy_s > 0 else None)
    out["kernels_per_call"] = t.device_ops / t.calls
    out["gaps"] = t.gap_notes(10)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.program")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = measure(args.workload, args.seed, args.calls)
    for g in out["gaps"]:
        print(f"gap {g['ms']:.3f} ms in {g['program']} "
              f"({g['benchmark']}): {g['runtime']}; host {g['host_ops']}",
              file=sys.stderr)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
