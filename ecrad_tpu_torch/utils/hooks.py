"""Profiling scopes and counters: the Dr Hook analogue.

Port of ecrad_tpu/utils/hooks.py (reference drhook/: the IFS profiler
that brackets every routine with dr_hook(name, 0/1, handle), zero-cost
when off; C core drhook/drhook/drhook.c). A scope, `with hook(name):`,
has two layers, each on only while its switch is:

 - torch.profiler.record_function, while a torch.profiler trace runs:
   labels the scope in the trace, the counterpart of jax.named_scope;
   the trace shows the scope on the host and the device time of the
   kernels launched inside it.
 - the native C++ core (csrc/host/ecrhook.cc via utils/native.py) while
   LHOOK is on (ECRAD_HOOK=1 at import, or `enable(True)`): per-thread
   call-stack accounting with wall and CPU self and total time, peak RSS,
   and fatal-signal hook-stack dumps, matching Dr Hook's profile output.
   Without a compiler, a pure-Python wall-time accumulator.

With neither on, `hook(name)` returns a shared scope that does nothing
(well under a microsecond an entry), so the scopes stay in the path.

The program's scopes are named `ecrad.<layer>[.<stage>]`, one at each
layer boundary (`with hook(name):` or the decorator `hooked(name)`) and
around each stage of the cloud generator, never inside a loop over
levels. Each statement of a radiation() call that
blocks the host on the device runs through `sync(site, fn, ...)`: a
scope `ecrad.sync.<site>` and, while LHOOK is on, the counter
`sync.<site>`. `count(name)` adds to a counter while LHOOK is on;
`counters()` reads them, `reset_profile()` clears them with the
accounting.

The accounted times are host wall and CPU time around asynchronous
kernel launches: a scope ends when its launches are queued, not when the
device has run them (the eager twin of the JAX package's trace-time-only
scopes under jit). They are not device time; read device time from the
trace (start_trace / stop_trace), or synchronise inside the scope.
"""
from __future__ import annotations

import ctypes
import functools
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

LHOOK = os.environ.get("ECRAD_HOOK", "0") == "1"

_accum: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_counters: Dict[str, int] = defaultdict(int)
_trace = None

# rows the native report returns at most, and its name field's width
_CAP, _NAME = 512, 64


def _native():
    if not LHOOK:
        return None
    from .native import hook_lib
    return hook_lib()


def _profiling() -> bool:
    """Whether a torch.profiler (or autograd profiler) trace runs."""
    return _autograd_profiler._is_profiler_enabled


def enable(on: bool) -> None:
    """Turn the host accounting and the counters on or off (LHOOK)."""
    global LHOOK
    LHOOK = bool(on)


class _Scope:
    """One entry of a named scope: a record_function while a trace runs,
    the native core's (or the Python accumulator's) enter and exit while
    LHOOK is on, as each stood when the scope was entered."""
    __slots__ = ("name", "_span", "_lib", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._span = None
        self._lib = None
        self._t0 = None

    def __enter__(self):
        if LHOOK:
            self._lib = _native()
            if self._lib is not None:
                self._lib.ecr_hook_enter(self.name.encode())
            else:
                self._t0 = time.perf_counter()
        if _profiling():
            self._span = record_function(self.name)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.__exit__(*exc)
        if self._lib is not None:
            self._lib.ecr_hook_exit(self.name.encode())
        elif self._t0 is not None:
            _accum[self.name] += time.perf_counter() - self._t0
            _counts[self.name] += 1
        return False


class _Off:
    """The scope of `hook` with the profiler and LHOOK both off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def hook(name: str):
    """Named scope (`with hook(name):`): a span while a trace runs, host
    accounting while LHOOK is on, nothing otherwise."""
    if LHOOK or _profiling():
        return _Scope(name)
    return _OFF


def hooked(name: str):
    """Decorator: every call of the function in the scope `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            with hook(name):
                return fn(*args, **kwargs)
        return scoped
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while LHOOK is on."""
    if LHOOK:
        _counters[name] += n


def counters() -> Dict[str, int]:
    """A snapshot of the counters."""
    return dict(_counters)


def sync(site: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), a call that blocks the host until the device
    has run what was queued before it (a device value read on the host, a
    copy from pageable host memory, an index whose size depends on device
    data), in the scope `ecrad.sync.<site>`; counted as `sync.<site>`
    while LHOOK is on. Returns what fn returns."""
    if LHOOK:
        _counters["sync." + site] += 1
    if LHOOK or _profiling():
        with _Scope("ecrad.sync." + site):
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)


def upload(site: str, array, device, dtype=None):
    """torch.as_tensor(array, dtype, device) of a host (numpy) array: a
    copy from pageable memory, which waits for the device's queue when the
    device is a GPU; a sync at `upload.<site>`."""
    return sync("upload." + site, torch.as_tensor, array, dtype=dtype,
                device=device)


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
    """Clear the accounting and the counters."""
    lib = _native()
    if lib is not None:
        lib.ecr_hook_reset()
    _accum.clear()
    _counts.clear()
    _counters.clear()


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
