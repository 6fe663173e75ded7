"""The readers of what the port's hooks expose, on planted traces: the
five per-layer metrics on the benchmark's spans around the port's
functions, ProgramTrace on the program's own `ecrad.*` spans, and the
frozen trace arithmetic unmoved by program spans in its trace."""
import hashlib

import numpy as np
import pytest

from portbench import harness, roofline
from portbench.program import (READERS, ProgramTrace, gaps, idle_in_s,
                               span_count)
from portbench.trace import Trace


def _span(name, s, e):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": float(s),
            "dur": float(e - s)}


class _Planted:
    """A two-call trace: calls [0, 1000] and [1000, 2000] microseconds."""

    def __init__(self):
        self.ev = [_span("portbench.call", 0, 1000),
                   _span("portbench.call", 1000, 2000)]
        self.corr = 0

    def kernel(self, launch, start, end, name="k"):
        self.corr += 1
        self.ev += [{"ph": "X", "cat": "cuda_runtime",
                     "name": "cudaLaunchKernel", "ts": float(launch),
                     "dur": 1.0, "args": {"correlation": self.corr}},
                    {"ph": "X", "cat": "kernel", "name": name,
                     "ts": float(start), "dur": float(end - start),
                     "args": {"correlation": self.corr}}]

    def spans(self, name, *intervals):
        self.ev += [_span(name, s, e) for s, e in intervals]


def _planted(prefix, sync="sync"):
    """Busy [0, 120], [160, 610], [700, 1120], [1200, 1900]; gaps begin at
    120, 610 and 1120 inside the syncs [100, 150], [600, 620], [1100,
    1150] (40 + 90 + 80 us), and at 1900 outside any; one sync before the
    window. The generator's random stage launches 50 + 30 us of work, its
    walk 3 launches; the merge checks 5 and the covers 2."""
    p = _Planted()
    for launch, s, e in ((0, 0, 120), (155, 160, 610), (650, 700, 1120),
                         (1190, 1200, 1900)):
        p.kernel(launch, s, e)
    p.kernel(210, 215, 265)
    p.kernel(300, 305, 335)
    for launch in (1310, 1320, 1330):
        p.kernel(launch, launch + 5, launch + 6)
    p.spans(prefix + sync, (-50, -40), (100, 150), (600, 620), (1100, 1150))
    p.spans(prefix + "cover_merge", (20, 30), (40, 50), (60, 70),
            (1020, 1030), (1040, 1050))
    p.spans(prefix + "cover_exp_exp", (10, 80), (1010, 1060))
    p.spans(prefix + "generator_random", (200, 400))
    p.spans(prefix + "generator_walk", (1300, 1500))
    # a runtime call and a host operator inside the gap [610, 700]
    p.ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
                 "ts": 640.0, "dur": 5.0})
    p.ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
                 "ts": 600.0, "dur": 50.0})
    return p.ev


PLANTED = {"host_syncs_per_call": 1.5, "sync_idle_ms": 0.105,
           "cover_merge_passes": 1.5, "generator_random_ms": 0.04,
           "generator_walk_kernels": 1.5}


def test_the_readers_read_their_planted_values():
    t = Trace(_planted("portbench."))
    assert t.calls == 2
    assert span_count(t, "sync") == 3
    assert idle_in_s(t, "sync") == pytest.approx(210e-6)
    assert [g for g in gaps(t)] == [(120.0, 160.0), (610.0, 700.0),
                                    (1120.0, 1200.0), (1900.0, 2000.0)]
    for name in READERS:
        assert harness.load_reader(name).read(t) == \
            pytest.approx(PLANTED[name]), name


def test_the_readers_say_nothing_without_their_spans():
    t = Trace([_span("portbench.call", 0, 10)])
    for name in READERS:
        assert harness.load_reader(name).read(t) is None, name


def test_program_spans_read_their_planted_values():
    t = ProgramTrace(_planted("ecrad.", sync="sync.cover_merge")
                     + [_span("ecrad.radiation", 1, 999)])
    assert t.program_count("sync.cover_merge") == 3
    assert t.program_launches("generator_walk") == 3
    assert t.program_device_s("generator_random") == pytest.approx(80e-6)
    assert t.program_sync_idle_s() == pytest.approx(210e-6)
    notes = t.gap_notes(2)
    assert [round(n["ms"], 6) for n in notes] == [0.1, 0.09]
    assert notes[0]["program"] is None and notes[0]["benchmark"] == "call"
    assert notes[1]["program"] == "sync.cover_merge"
    # the copy, and the launch of the work that ends the gap
    assert notes[1]["runtime"] == {"cudaMemcpyAsync": 1,
                                   "cudaLaunchKernel": 1}
    assert notes[1]["host_ops"] == {"aten::copy_": pytest.approx(0.04)}


def test_program_spans_leave_the_frozen_arithmetic_as_it_was():
    """The frozen digest test's trace, with program spans, sync spans and
    runtime calls of no launch added, gives its digest unchanged."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.call",
           "ts": 0.0, "dur": 1000.0}]
    rng = np.random.RandomState(0)
    for i in range(50):
        s = float(rng.uniform(0, 950))
        ev += [{"ph": "X", "cat": "cuda_runtime", "name": "launch",
                "ts": s, "dur": 1.0, "args": {"correlation": i}},
               {"ph": "X", "cat": "kernel", "name": f"k{i % 3}", "ts": s,
                "dur": float(rng.uniform(1, 40)),
                "args": {"correlation": i}}]
    ev += [_span("ecrad.radiation", 1, 999), _span("ecrad.gas_optics", 5, 90),
           _span("ecrad.sync.orientation", 2, 4),
           _span("ecrad.cloud_generator.random", 300, 500),
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
            "ts": 3.0, "dur": 1.0}]
    for t in (Trace(ev), ProgramTrace(ev)):
        got = [t.busy_s, t.window_s, *[s for _, s in t.top_gaps(3)],
               roofline.least_time_s(1e9, 1e12),
               roofline.least_time_s(1e6, 1e12)]
        assert hashlib.sha256(np.asarray(got).tobytes()).hexdigest()[:16] \
            == "b3b776455bdf5e8e"


def test_the_tool_runs_a_cell_on_the_cpu():
    """portbench.program's measurement at a tiny size on the CPU: the
    hooks count the call's syncs (two merge checks at least, one in each
    generator call) and the program's spans are entered as often as the
    layers are."""
    from portbench import program
    out = program.measure("mcica.cols2048", 5, 1, "cpu", ncol=4, levels=12)
    assert out["one_call"]["syncs"] > 0
    assert out["one_call"]["counters"]["sync.cover_merge"] >= 2
    assert out["counters_per_call"]["sync.orientation"] == 1
    assert out["program_entries_per_call"]["radiation"] == 1
    assert out["program_entries_per_call"]["cloud_generator"] == 2
    assert set(out["generator_stages"]) == set(program.STAGES)
    assert out["call_ms"]["hooks_on"] > 0 and out["hook_entry_us"] > 0
