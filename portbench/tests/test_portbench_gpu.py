"""On the card: one short run of the smallest cell, which has to build
the port's kernels, run them and come out correct; and the SPARTACUS
cell at its own size with the 3D terms dropped on the timed side, which
has to come out not correct."""
import json

import pytest

from portbench import harness
from portbench.tests.test_portbench_run import flat_config


@pytest.mark.gpu
def test_a_short_run_on_the_card(bench, cuda):
    r = harness.run_cell(bench, "tripleclouds.cols2048", 3, 1.0, False,
                         "cuda")
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["metrics"]["columns_per_s"]["value"] > 0


@pytest.mark.gpu
def test_the_3d_terms_dropped_fail_on_the_card(bench, cuda, monkeypatch):
    monkeypatch.setattr(harness, "program_config",
                        flat_config(harness.program_config))
    r = harness.run_cell(bench, "spartacus.cols2048", 2_000_000_061, 5.0,
                         False, "cuda")
    print("3D terms dropped:", json.dumps(r["check"]))
    assert not r["correct"] and r["failed"] >= 1
