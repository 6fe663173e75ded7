"""The float64 cell, mcica_f64.cols2048: on the CPU at 6 x 20, a run of
the port's float64 plain path is correct under the cell's limits, while
the control one precision below (the reference in float32 on float64
subcolumns, control_f64.py) and each planted float32 stage (B4's SW
optics or B3's SW sweep computed in float32 and cast back) are not; the
cell's four new readers read numbers from a traced run. Marked gpu: the
planted stages at the cell's size on the card, through the float forms
of the same kernels."""
import json

import pytest
import torch

from portbench import check, control_f64, harness
from portbench import trace as trace_mod
from portbench.trace import PREFIX, Trace
from ecrad_tpu_torch.solvers import mcica

CELL = "mcica_f64.cols2048"
SMALL = dict(ncol=6, levels=20)
NEW_READERS = ("f64_gas_optics_roofline", "f64_layer_optics_roofline",
               "f64_sweeps_roofline", "plain_on_card_per_call")
#: the McICA solver's attributes of the two stages that may be planted
STAGES = ("sw_clear_total_reftrans", "adding_sw")


def _run(bench, seed, trace=False, **size):
    return harness.run_cell(bench, CELL, seed, 0.3, trace, "cpu",
                            **(size or SMALL))


def _limits():
    return harness.load_json(harness.HERE, "limits", f"{CELL}.json")


def float32_stage(real):
    """`real` computed in float32 and its outputs cast back: the float
    operands cast down (the masks, band maps and flags as they are)."""
    def stage(*args):
        down = [a.float() if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a for a in args]
        return tuple(x.double() for x in real(*down))
    return stage


@pytest.mark.parametrize("seed", (11, 2_000_000_011))
def test_a_float64_run_is_correct(bench, seed):
    r = _run(bench, seed)
    assert r["correct"] and r["failed"] == 0 and r["checked_calls"] >= 1
    assert set(r["check"]) >= {"flux_mean", "column_lw", "column_sw"}


@pytest.mark.parametrize("seed", (11, 12))
def test_the_float32_control_is_not_correct(bench, seed):
    """The reference in float32 on the float64 configuration (its
    generator draws float64 subcolumns) fails the cell's limits by
    flux_mean and column_lw at least."""
    upper = control_f64.float32_control(bench, CELL, seed, "cpu", **{
        "ncol": SMALL["ncol"], "levels": SMALL["levels"]})
    assert {"flux_mean", "column_lw"} <= set(check.failures(upper,
                                                            _limits()))


@pytest.mark.parametrize("stage", STAGES)
def test_a_float32_stage_is_not_correct(bench, monkeypatch, stage):
    monkeypatch.setattr(mcica, stage, float32_stage(getattr(mcica, stage)))
    r = _run(bench, 12)
    assert not r["correct"] and r["failed"] >= 1
    assert r["check"]["flux_mean"]["value"] > _limits()["flux_mean"]


def _with_device_work():
    """trace.load with a kernel of 10 us planted at the start of every
    benchmark span but the call's: a run on the CPU records no device
    work for the readers to divide by."""
    def load(path, work=None, host=None):
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(PREFIX)
                 and e["name"] != PREFIX + "call"]
        for i, e in enumerate(spans):
            corr = 10 ** 9 + i
            events += [
                {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                 "ts": float(e["ts"]), "dur": 0.0,
                 "args": {"correlation": corr}},
                {"ph": "X", "cat": "kernel", "name": "planted",
                 "ts": float(e["ts"]), "dur": 10.0,
                 "args": {"correlation": corr}}]
        return Trace(events, work, host)
    return load


def test_the_new_readers_read_a_traced_run(bench, monkeypatch):
    """A traced run on the CPU with device work planted under its spans:
    each new reader gives a number; the FP64 shares are the float64 least
    times (bytes of float64 tensors, the operations at 34 TFLOP/s) over
    that work, and no layer ran a plain version on a device."""
    monkeypatch.setattr(trace_mod, "load", _with_device_work())
    r = _run(bench, 13, trace=True)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW_READERS) <= set(got)
    for name in NEW_READERS[:3]:
        assert 0.0 < got[name] < float("inf"), name
    assert got["plain_on_card_per_call"] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("stage", STAGES)
def test_a_float32_stage_fails_on_the_card(bench, cuda, monkeypatch, stage):
    """At the cell's size on the card, the stage through its float kernel
    (B4's SW form, B3 sw_adding) and cast back: not correct."""
    monkeypatch.setattr(mcica, stage, float32_stage(getattr(mcica, stage)))
    r = harness.run_cell(bench, CELL, 2_000_000_071, 3.0, False, "cuda")
    assert not r["correct"] and r["failed"] >= 1
    print(json.dumps({"stage": stage, "check": r["check"]}))
