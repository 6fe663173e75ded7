"""The float64 SPARTACUS cell, spartacus_f64.cols2048: on the CPU at 6 x
20, a run of the port's float64 plain path is correct under the cell's
limits, while the control one precision below (the reference in float32,
control_f64.py) and each planted float32 stage (B6's SW layer optics or
B8's SW sweeps computed in float32 and cast back) are not; the cell's two
new readers read numbers from a traced run. Marked gpu: the planted
stages at the cell's size on the card, through the float forms of the
same kernels."""
import json

import pytest
import torch

from portbench import check, control_f64, harness
from portbench import trace as trace_mod
from portbench.tests.test_portbench_f64 import _with_device_work
from ecrad_tpu_torch.solvers import spartacus_sw

CELL = "spartacus_f64.cols2048"
SMALL = dict(ncol=6, levels=20)
NEW_READERS = ("f64_spartacus_reftrans_roofline",
               "f64_spartacus_adding_roofline")
#: the SW SPARTACUS solver's attributes of the two stages that may be
#: planted: B6 and B8
STAGES = ("sw_reftrans_levels", "sw_adding_sweeps")


def _run(bench, seed, trace=False, **size):
    return harness.run_cell(bench, CELL, seed, 0.3, trace, "cpu",
                            **(size or SMALL))


def _limits():
    return harness.load_json(harness.HERE, "limits", f"{CELL}.json")


def float32_stage(real):
    """`real` computed in float32 and its outputs cast back: the float
    operands cast down (the masks, the configuration and the counts as
    they are)."""
    def stage(*args, **kwargs):
        down = [a.float() if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a for a in args]
        out = real(*down, **kwargs)
        if isinstance(out, torch.Tensor):
            return out.double()
        return tuple(x.double() for x in out)
    return stage


def test_the_cell_runs_spartacus_in_float64(bench):
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    conf = harness.load_json(harness.HERE, "configs",
                             f"{cell['config']}.json")
    base = harness.load_json(harness.HERE, "configs", "ifs_spartacus.json")
    assert conf["fields"] == dict(base["fields"], dtype="float64")
    assert conf["cloud_geometry"] == base["cloud_geometry"]
    assert conf["changed_from_source"] == base["changed_from_source"]
    assert conf["reduced"] == [] and cell["chips"] == 1
    # the double build's own source: no other configuration shares it
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    assert entry["source"] == conf["source"] != base["source"]
    assert all((c["source"], c["reduced"]) != (entry["source"], [])
               for c in bench["configs"] if c is not entry)


@pytest.mark.parametrize("seed", (21, 2_000_000_021))
def test_a_float64_run_is_correct(bench, seed):
    r = _run(bench, seed)
    assert r["correct"] and r["failed"] == 0 and r["checked_calls"] >= 1
    assert set(r["check"]) >= {"flux_mean", "column_lw", "column_sw"}


@pytest.mark.parametrize("seed", (21, 22))
def test_the_float32_control_is_not_correct(bench, seed):
    """The reference in float32 on the float64 configuration fails the
    cell's limits by flux_mean and column_lw at least."""
    upper = control_f64.float32_control(bench, CELL, seed, "cpu", **{
        "ncol": SMALL["ncol"], "levels": SMALL["levels"]})
    assert {"flux_mean", "column_lw"} <= set(check.failures(upper,
                                                            _limits()))


@pytest.mark.parametrize("stage", STAGES)
def test_a_float32_stage_is_not_correct(bench, monkeypatch, stage):
    monkeypatch.setattr(spartacus_sw, stage,
                        float32_stage(getattr(spartacus_sw, stage)))
    r = _run(bench, 22)
    assert not r["correct"] and r["failed"] >= 1
    assert r["check"]["flux_mean"]["value"] > _limits()["flux_mean"]


def test_the_new_readers_read_a_traced_run(bench, monkeypatch):
    """A traced run on the CPU with device work planted under its spans:
    each new reader gives a share above 0, the float64 least times of B6
    and B7, B8 and B9 (bytes of float64 tensors, the operations at 34
    TFLOP/s) over that work; no layer ran a plain version on a device."""
    monkeypatch.setattr(trace_mod, "load", _with_device_work())
    r = _run(bench, 23, trace=True)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW_READERS) <= set(got)
    for name in NEW_READERS:
        assert 0.0 < got[name] < float("inf"), name
    assert got["plain_on_card_per_call"] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("stage", STAGES)
def test_a_float32_stage_fails_on_the_card(bench, cuda, monkeypatch, stage):
    """At the cell's size on the card, the stage through its float kernel
    (B6, B8) and cast back: not correct."""
    monkeypatch.setattr(spartacus_sw, stage,
                        float32_stage(getattr(spartacus_sw, stage)))
    r = harness.run_cell(bench, CELL, 2_000_000_073, 3.0, False, "cuda")
    assert not r["correct"] and r["failed"] >= 1
    print(json.dumps({"stage": stage, "check": r["check"]}))
