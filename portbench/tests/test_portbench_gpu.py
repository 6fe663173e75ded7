"""On the card: one short run of the smallest cell, which has to build
the port's kernels, run them and come out correct."""
import pytest

from portbench import harness


@pytest.mark.gpu
def test_a_short_run_on_the_card(bench, cuda):
    r = harness.run_cell(bench, "tripleclouds.cols2048", 3, 1.0, False,
                         "cuda")
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["metrics"]["columns_per_s"]["value"] > 0
