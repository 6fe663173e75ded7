"""Whole runs of the harness on the CPU at a tiny size: the port's plain
path against the reference, `correct` false with the timed path broken,
and the control (the reference in bfloat16) outside every limit."""
import dataclasses

import pytest
import torch

from portbench import check, control, harness
from ecrad_tpu_torch import interface

SMALL = dict(ncol=6, levels=20)
CELLS = ("mcica.cols2048", "tripleclouds.cols2048", "spartacus.cols2048")


def _run(bench, cell, trace=False, seed=11):
    return harness.run_cell(bench, cell, seed, 0.3, trace, "cpu", **SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct(bench, cell):
    r = _run(bench, cell)
    assert r["correct"] and r["failed"] == 0 and r["checked_calls"] >= 1
    assert r["attempted"] >= 1
    assert list(r)[-1] == "check"
    e2e = {m["name"] for m in harness.cell_metrics(bench, cell,
                                                   "end_to_end")}
    assert {"columns_per_s", "setup_s"} <= set(r["metrics"]) <= e2e
    assert set(r["check"]) >= {"flux_max", "flux_mean", "cover_max"}


def test_a_traced_run_is_correct(bench):
    r = _run(bench, "tripleclouds.cols2048", trace=True)
    assert r["correct"] and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _stale(real):
    """A call that returns its first answer again: its state unchanged."""
    first = []

    def radiation(*args, **kwargs):
        if not first:
            first.append(real(*args, **kwargs))
        return first[0]
    return radiation


def _half(real):
    """Half of the columns left out, their fluxes the mean of the rest."""
    def radiation(*args, **kwargs):
        flux = real(*args, **kwargs)
        out = {}
        for name, x in flux.fields():
            half = x.shape[0] // 2
            x = x.clone()
            x[half:] = x[:half].mean(0)
            out[name] = x
        return flux.replace(**out)
    return radiation


def _altered(real):
    """One column's LW upward profile assembled from its downward one."""
    def lw_fields(*args, **kwargs):
        out = real(*args, **kwargs)
        out["lw_up"] = out["lw_up"].clone()
        out["lw_up"][0] = out["lw_dn"][0]
        return out
    return lw_fields


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault,attr,make", [
    ("state unchanged", "radiation", _stale),
    ("half the batch left out", "radiation", _half),
    ("an answer altered", "_lw_fields", _altered)])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, cell, fault,
                                            attr, make):
    monkeypatch.setattr(interface, attr, make(getattr(interface, attr)))
    r = _run(bench, cell, seed=12)
    assert not r["correct"], fault
    assert r["failed"] >= 1


def flat_config(real):
    """The port's configuration with SPARTACUS's 3D terms dropped: every
    layer takes the 1D fallback on the timed side alone."""
    def program_config(*args, **kwargs):
        return dataclasses.replace(real(*args, **kwargs),
                                   do_3d_effects=False)
    return program_config


@pytest.mark.parametrize("seed", (12, 13))
def test_the_3d_terms_dropped_are_not_correct(bench, monkeypatch, seed):
    monkeypatch.setattr(harness, "program_config",
                        flat_config(harness.program_config))
    r = _run(bench, "spartacus.cols2048", seed=seed)
    assert not r["correct"] and r["failed"] >= 1
    limits = harness.load_json(harness.HERE, "limits",
                               "spartacus.cols2048.json")
    assert r["check"]["column_lw"]["value"] > limits["column_lw"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_port_passes(bench, cell):
    limits = harness.load_json(harness.HERE, "limits", f"{cell}.json")
    got = control.readings(bench, cell, 5, "cpu", **SMALL)
    assert check.failures(got["lower"], limits) == []
    assert check.failures(got["upper"], limits)


def test_a_missing_field_fails_every_number():
    ref = {"lw_up": torch.zeros(2, 3), "cloud_cover_lw": torch.zeros(2)}
    nums = check.numbers({"lw_up": torch.zeros(2, 3)}, ref)
    assert set(nums.values()) == {check.NOT_FINITE}


def test_a_nan_fails():
    ref = {k: torch.zeros(2, 3) for k in check.PROFILES}
    ref.update(cloud_cover_lw=torch.zeros(2), cloud_cover_sw=torch.zeros(2))
    lw_up = torch.zeros(2, 3)
    lw_up[0, 1], lw_up[1, 2] = float("nan"), 5.0
    nums = check.numbers(dict(ref, lw_up=lw_up), ref)
    assert nums["nonfinite"] == 1 and nums["flux_max"] == 5.0
    assert check.failures(nums, dict.fromkeys(nums, 0.0)) == [
        "flux_max", "flux_mean", "column_lw", "nonfinite"]
