"""Reduction of a profiler trace to what the per-layer metrics read.

The trace is torch.profiler's Chrome trace (kineto's JSON): host spans
(`user_annotation`), the runtime calls that launch device work
(`cuda_runtime`, `cuda_driver`) and the device's kernels, copies and
memsets, tied to their launches by the `correlation` id. Host and device
timestamps share one clock (microseconds).

- The window runs from the start of the first "call" span to the end of
  the last; every call ends in a synchronise inside its span, so the
  device work of the window lies inside it.
- Busy time is the union of the device intervals over the window
  (tools/profile_torch_port.py `busy_share`).
- A span's device time is the time of the device work launched while
  the span was open on the host (its launch call's start inside one of
  the span's intervals), which is the work the layer asked for, however
  it overlaps with others on the device.
- An idle gap is a stretch of the window in which the device ran
  nothing; it is labelled by the innermost benchmark span open on the
  host when it began.

Beside the trace, `HostTimes` holds the wall of calls made just before
it without the profiler, and the host seconds of the spans in them: what
the profiler's own cost would inflate.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

#: the prefix of the benchmark's span names
PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class HostTimes(NamedTuple):
    """Untraced calls: each call's wall and each span's total, seconds."""
    call_s: List[float]
    span_s: Dict[str, float]


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(merged, t) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


class Trace:
    """The device and span record of one traced window. Times in
    seconds; per-call values divide by `calls`."""

    def __init__(self, events: List[dict], work: Optional[dict] = None,
                 host: Optional[HostTimes] = None):
        xs = [e for e in events if e.get("ph") == "X"]
        spans = defaultdict(list)
        for e in xs:
            if e.get("cat") == "user_annotation" and \
                    str(e.get("name", "")).startswith(PREFIX):
                spans[e["name"][len(PREFIX):]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        calls = sorted(spans.get("call", []))
        if not calls:
            raise ValueError("the trace holds no call span")
        self.calls = len(calls)
        w0, w1 = calls[0][0], max(e for _, e in calls)
        self.window_s = (w1 - w0) * 1e-6
        launch = {}
        for e in xs:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launch[corr] = float(e["ts"])
        # device work started inside the window, with its launch time
        self.ops = []              # (start, end, name, launch time)
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                s = float(e["ts"])
                if w0 <= s <= w1:
                    corr = (e.get("args") or {}).get("correlation")
                    self.ops.append((s, s + float(e["dur"]), e["name"],
                                     launch.get(corr)))
        self._spans = {k: merge(v) for k, v in spans.items()}
        self._raw_spans = [(s, e, k) for k, v in spans.items()
                           for s, e in v]
        busy = merge([(max(s, w0), min(e, w1)) for s, e, _, _ in self.ops])
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self._busy, self._w = busy, (w0, w1)
        self.work = work or {}
        self.host = host

    # ---- what the readers use ----
    @property
    def device_ops(self) -> int:
        return len(self.ops)

    def has(self, label: str) -> bool:
        return label in self._spans

    def _launched_in(self, label):
        merged = self._spans.get(label, [])
        return [op for op in self.ops
                if op[3] is not None and _inside(merged, op[3])]

    def device_s(self, label: str) -> float:
        """Device seconds of the work launched inside `label`'s spans."""
        return sum(e - s for s, e, _, _ in self._launched_in(label)) * 1e-6

    def launches(self, label: str) -> int:
        return len(self._launched_in(label))

    def wall_s(self, label: str) -> float:
        """Host seconds inside `label`'s spans."""
        return sum(e - s for s, e in self._spans.get(label, [])) * 1e-6

    def host_call_s(self) -> Optional[float]:
        """Mean wall of an untraced call, or None without them."""
        h = self.host
        return sum(h.call_s) / len(h.call_s) if h and h.call_s else None

    def host_span_s(self, label: str) -> Optional[float]:
        """Host seconds per untraced call inside `label`'s outermost
        spans, or None where no call entered the span."""
        h = self.host
        if not h or not h.call_s or not h.span_s.get(label):
            return None
        return h.span_s[label] / len(h.call_s)

    def least_s(self, label: str) -> Optional[float]:
        """The label's least time over the window (the sum of each call's
        own), or None where a call's operations are not counted."""
        w = self.work.get(label)
        return None if w is None or w["unknown"] else w["least_s"]

    def operations(self, label: str) -> Optional[float]:
        w = self.work.get(label)
        return None if w is None or w["unknown"] else w["ops"]

    # ---- the breakdown ----
    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by = defaultdict(float)
        for s, e, name, _ in self.ops:
            by[name] += (e - s) * 1e-6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        w0, w1 = self._w
        edges = [w0] + [x for s, e in self._busy for x in (s, e)] + [w1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for length, start in gaps:
            open_ = [(s, label) for s, e, label in self._raw_spans
                     if s <= start < e]
            out.append((max(open_)[1] if open_ else "between calls",
                        length * 1e-6))
        return out


def load(path: str, work: Optional[dict] = None,
         host: Optional[HostTimes] = None) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events, work, host)

