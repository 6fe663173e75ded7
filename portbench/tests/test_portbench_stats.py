"""The end-to-end statistics and the trace reduction, on planted data."""
import pytest

from portbench import harness
from portbench.roofline import F32_OPS_PER_S
from portbench.trace import HostTimes, Trace, merge


def _window(times, columns=256):
    t, calls = 0.0, []
    for d in times:
        calls.append((t, t + d))
        t += d + 1e-4
    return harness.Window(calls=calls, columns=columns, setup_s=12.0,
                          peak_bytes=3 * 2 ** 20)


def _read(name, w):
    return harness.load_reader(name).read(w)


def test_a_planted_stall_moves_rate_and_tail():
    steady = [0.030] * 400
    stalled = list(steady)
    for i in range(0, 400, 20):        # 20 calls, 5 % of them, stall
        stalled[i] = 0.090
    a, b = _window(steady), _window(stalled)
    assert _read("columns_per_s", b) < 0.95 * _read("columns_per_s", a)
    assert _read("call_ms_p95", b) > 1.5 * _read("call_ms_p95", a)
    assert _read("call_ms_p95", a) == pytest.approx(30.0)
    assert _read("peak_mem_mib", a) == 3.0
    assert _read("setup_s", a) == 12.0


def test_the_rate_takes_the_whole_window():
    w = _window([0.1] * 10, columns=2048)
    span = w.calls[-1][1] - w.calls[0][0]
    assert _read("columns_per_s", w) == pytest.approx(10 * 2048 / span)


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """Two calls of 100 us, 100 us apart; in each a gas_optics span
    launching two kernels, and a sweeps span launching a copy and a
    kernel, with an idle gap of 20 us in each span."""
    ev = []
    for c, t0 in enumerate((0.0, 200.0)):
        k = 10 * c
        ev += [_x("user_annotation", "portbench.call", t0, 100.0),
               _x("user_annotation", "portbench.gas_optics", t0 + 1, 40.0),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 2, 1, k + 1),
               _x("kernel", "taumol_lw", t0 + 5, 20.0, k + 1),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 3, 1, k + 2),
               _x("kernel", "taumol_sw", t0 + 25, 10.0, k + 2),
               _x("user_annotation", "portbench.sweeps", t0 + 45, 50.0),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 70, 1, k + 3),
               _x("gpu_memcpy", "Memcpy DtoH", t0 + 55, 5.0, k + 4),
               _x("cuda_runtime", "cudaMemcpyAsync", t0 + 50, 1, k + 4),
               _x("kernel", "tc_sw_sweeps", t0 + 80, 15.0, k + 3)]
    # device work outside the window is not counted
    ev.append(_x("kernel", "warmup", -50.0, 10.0, 99))
    return ev


def test_trace_reduction():
    t = Trace(_events(), {"sweeps": {"least_s": 6e-6, "ops": 1.0,
                                     "unknown": False}})
    assert t.calls == 2 and t.window_s == pytest.approx(300e-6)
    assert t.device_ops == 8
    assert t.busy_s == pytest.approx(2 * 50e-6)
    assert t.device_s("gas_optics") == pytest.approx(2 * 30e-6)
    assert t.device_s("sweeps") == pytest.approx(2 * 20e-6)
    assert t.device_s("call") == pytest.approx(2 * 50e-6)
    assert t.launches("gas_optics") == 4
    assert t.wall_s("sweeps") == pytest.approx(100e-6)
    assert t.least_s("sweeps") == 6e-6 and t.least_s("regions") is None
    gaps = t.top_gaps(10)
    assert gaps[0] == ("call", pytest.approx(110e-6))
    assert {label for label, s in gaps if abs(s - 20e-6) < 1e-9} == {
        "gas_optics", "sweeps"}
    assert t.top_ops(1) == [("taumol_lw", pytest.approx(40e-6))]


@pytest.mark.parametrize("name,value", [
    ("device_idle_pct", 100.0 * (1 - 100 / 300)),
    ("kernels_per_call", 4.0),
    ("gas_optics_ms", 0.030),
    ("sweeps_ms", 0.020),
    ("sweeps_roofline", 100.0 * 6e-6 / 40e-6),
    ("entry_other_ms", 0.020),
])
def test_readers_on_a_planted_trace(name, value):
    t = Trace(_events(), {"sweeps": {"least_s": 6e-6, "ops": 1.0,
                                     "unknown": False}})
    assert harness.load_reader(name).read(t) == pytest.approx(value)


def test_readers_leave_out_what_they_cannot_read():
    t = Trace(_events())
    for name in ("aerosol_ms", "regions_ms", "cloud_generator_ms",
                 "cloud_generator_kernels", "layer_optics_roofline",
                 "step_mfu"):
        assert harness.load_reader(name).read(t) is None


def test_untraced_calls_feed_the_generator_and_the_mfu():
    work = {k: {"least_s": 1e-6, "ops": 3e9, "unknown": False}
            for k in ("gas_optics", "layer_optics", "sweeps")}
    host = HostTimes([0.5, 0.7], {"cloud_generator": 0.8})
    t = Trace(_events(), work, host)
    assert harness.load_reader("cloud_generator_ms").read(t) == \
        pytest.approx(400.0)
    # 9e9 operations over the trace's 2 calls, in a 0.6 s untraced call
    assert harness.load_reader("step_mfu").read(t) == pytest.approx(
        100.0 * 4.5e9 / (F32_OPS_PER_S * 0.6))


def test_merge():
    assert merge([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]
