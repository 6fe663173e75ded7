"""Profiling scopes: the Dr Hook analogue.

Port of ecrad_tpu/utils/hooks.py (reference drhook/: the IFS profiler
that brackets every routine with dr_hook(name, 0/1, handle), zero-cost
when off; C core drhook/drhook/drhook.c). Two layers:

 - torch.profiler.record_function (always on): labels the scope in a
   torch.profiler trace, the counterpart of jax.named_scope; the trace
   shows the scope on the host and the device time of the kernels
   launched inside it.
 - the native C++ core (csrc/host/ecrhook.cc via utils/native.py) when
   ECRAD_HOOK=1: per-thread call-stack accounting with wall and CPU self
   and total time, peak RSS, and fatal-signal hook-stack dumps, matching
   Dr Hook's profile output. Without a compiler, a pure-Python wall-time
   accumulator.

The accounted times are host wall and CPU time around asynchronous
kernel launches: a scope ends when its launches are queued, not when the
device has run them (the eager twin of the JAX package's trace-time-only
scopes under jit). They are not device time; read device time from the
trace (start_trace / stop_trace), or synchronise inside the scope.

Controlled by ECRAD_HOOK=1, read at import.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.profiler import record_function

LHOOK = os.environ.get("ECRAD_HOOK", "0") == "1"

_accum: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_trace = None

# rows the native report returns at most, and its name field's width
_CAP, _NAME = 512, 64


def _native():
    if not LHOOK:
        return None
    from .native import hook_lib
    return hook_lib()


@contextlib.contextmanager
def hook(name: str):
    """Named scope for traces; accumulates host time when ECRAD_HOOK=1."""
    if not LHOOK:
        with record_function(name):
            yield
        return
    lib = _native()
    if lib is not None:
        lib.ecr_hook_enter(name.encode())
        try:
            with record_function(name):
                yield
        finally:
            lib.ecr_hook_exit(name.encode())
        return
    t0 = time.perf_counter()
    with record_function(name):
        yield
    _accum[name] += time.perf_counter() - t0
    _counts[name] += 1


def install_signal_handlers() -> bool:
    """Install Dr Hook-style fatal-signal handlers that dump the active
    hook stack (drhook.c signal machinery); they replace the process's
    SIGSEGV, SIGFPE, SIGBUS, SIGILL and SIGABRT handlers. Returns True if
    the native core is available."""
    from .native import hook_lib
    lib = hook_lib()
    if lib is None:
        return False
    lib.ecr_hook_install_signals()
    return True


def _native_rows(lib):
    """[(name, calls, total_s, self_s, cpu_s, maxrss_kb)], by total wall
    time, across threads."""
    names = ctypes.create_string_buffer(_CAP * _NAME)
    calls = (ctypes.c_long * _CAP)()
    tw = (ctypes.c_double * _CAP)()
    sw = (ctypes.c_double * _CAP)()
    tc = (ctypes.c_double * _CAP)()
    rss = (ctypes.c_long * _CAP)()
    n = lib.ecr_hook_report(names, calls, tw, sw, tc, rss, _CAP)
    return [(names.raw[i * _NAME:(i + 1) * _NAME].split(b"\0")[0].decode(),
             int(calls[i]), float(tw[i]), float(sw[i]), float(tc[i]),
             int(rss[i])) for i in range(n)]


def profile_report() -> str:
    """Dr Hook-style profile summary (drhook_merge_walltime analogue)."""
    lib = _native()
    if lib is not None:
        lines = ["name                                     calls"
                 "   total(s)    self(s)     cpu(s)  maxrss(MB)"]
        for nm, calls, tw, sw, tc, rss in _native_rows(lib):
            lines.append(f"{nm:40s} {calls:6d} {tw:10.4f} {sw:10.4f} "
                         f"{tc:10.4f} {rss / 1024.0:10.1f}")
        return "\n".join(lines)
    lines = ["name                                      calls   walltime"]
    for name, t in sorted(_accum.items(), key=lambda kv: -kv[1]):
        lines.append(f"{name:40s} {_counts[name]:7d} {t:10.4f}s")
    return "\n".join(lines)


def profile_rows():
    """Profile data as rows of (name, calls, self_seconds)."""
    lib = _native()
    if lib is not None:
        return [(nm, calls, sw) for nm, calls, _, sw, _, _ in
                _native_rows(lib)]
    return [(name, _counts[name], t) for name, t in _accum.items()]


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def dump_profile(path: str | None = None) -> str:
    """Write this process's profile to `ecrhook.prof.<rank>` (the rank of
    the torch.distributed process group, 0 without one; the per-rank
    `drhook.prof.N` files of DR_HOOK_OPT=prof); merge across processes
    with tools/merge_hook_profiles.py, the bin/drhook_merge_walltime.pl
    analogue. Returns the path written."""
    if path is None:
        path = f"ecrhook.prof.{_rank()}"
    rows = profile_rows()
    total = sum(r[2] for r in rows)
    with open(path, "w") as f:
        f.write(f"# ecrhook profile process={path.rsplit('.', 1)[-1]} "
                f"walltime={total:.6f}\n")
        f.write("# name calls self_seconds\n")
        for name, calls, self_s in rows:
            f.write(f"{name} {calls} {self_s:.6f}\n")
    return path


def reset_profile() -> None:
    lib = _native()
    if lib is not None:
        lib.ecr_hook_reset()
    _accum.clear()
    _counts.clear()


def start_trace(logdir: str) -> None:
    """Start a torch.profiler trace of the host and, where there is a GPU,
    the device; stop_trace writes it under `logdir` for TensorBoard or
    Perfetto (`<worker>.<time>.pt.trace.json`)."""
    global _trace
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _trace = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    _trace.start()


def stop_trace() -> None:
    global _trace
    prof, _trace = _trace, None
    if prof is None:
        raise RuntimeError("no trace started")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
