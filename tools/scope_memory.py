#!/usr/bin/env python3
"""Peak device memory inside each of the port's named scopes, for one
radiation call of a benchmark cell on a CUDA card.

    python3 tools/scope_memory.py --workload mcica.cols2048 --seed 1 \\
        [--calls 2] [--out scope_memory.json]

Builds the cell's set-up and its first batch as portbench/harness.py
does, makes the traffic's warm-up calls, then runs `--calls` calls with
utils/hooks.hook replaced by a scope that reads the caching allocator:
each scope's peak of torch.cuda.max_memory_allocated() while it is open
(nested scopes pass their peaks up), less the memory allocated just
before the calls, the quantity the benchmark's `peak_mem_mib` reads over
a window. Prints one line per scope path (the SW and the LW solver's
stages apart), largest first; `call` is the calls' peak.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from ecrad_tpu_torch import convert, interface  # noqa: E402
from ecrad_tpu_torch.utils import hooks  # noqa: E402
from portbench import columns, harness  # noqa: E402

MIB = 2.0 ** 20


class PeakScopes:
    """A stand-in for hooks.hook: the peak allocation (bytes) of each
    scope, keyed by its path of enclosing scopes ("a/b/c")."""

    def __init__(self):
        self.peak = {}
        self._stack = []     # [name, peak seen in the scope so far]

    def __call__(self, name):
        return _Scope(self, name)


class _Scope:
    __slots__ = ("owner", "name")

    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        stack = self.owner._stack
        if stack:   # what the enclosing scope reached before this one
            stack[-1][1] = max(stack[-1][1], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        stack.append([self.name, 0])
        return self

    def __exit__(self, *exc):
        stack = self.owner._stack
        path = "/".join(name for name, _ in stack)
        _, seen = stack.pop()
        peak = max(seen, torch.cuda.max_memory_allocated())
        self.owner.peak[path] = max(self.owner.peak.get(path, 0), peak)
        if stack:
            stack[-1][1] = max(stack[-1][1], peak)
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this tool reads the card's allocator",
              file=sys.stderr)
        return 1
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = harness.load_json(harness.HERE, "configs", f"{cell['config']}.json")
    traffic = harness.load_json(harness.HERE, "traffic",
                                f"{cell['traffic']}.json")
    dev = torch.device("cuda", 0)
    lut_dir = tempfile.mkdtemp(prefix="scope-memory-luts-")
    try:
        columns.write_synthetic_luts(lut_dir, args.seed)
        config = harness.program_config(conf["fields"], lut_dir)
        setup = interface.setup_radiation(config, device=dev)
    finally:
        shutil.rmtree(lut_dir, ignore_errors=True)
    pool = harness.make_pool(traffic, args.seed, config.use_aerosols)
    inputs = convert.columns_to_inputs(pool[0], device=dev)
    for _ in range(traffic["warmup_calls"]):
        interface.radiation(setup, *inputs)
    torch.cuda.synchronize()

    scopes = PeakScopes()
    plain_hook = hooks.hook
    hooks.hook = scopes
    try:
        base = torch.cuda.memory_allocated()
        with scopes("call"):
            for _ in range(args.calls):
                interface.radiation(setup, *inputs)
        torch.cuda.synchronize()
    finally:
        hooks.hook = plain_hook
    rows = {k: (v - base) / MIB for k, v in scopes.peak.items()}
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev),
           "base_mib": base / MIB, "peak_mib_over_base": rows}
    for name, mib in sorted(rows.items(), key=lambda kv: -kv[1]):
        print(f"{mib:12.1f} MiB  {name}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
