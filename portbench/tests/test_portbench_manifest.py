"""BENCHMARK.json against the benchmark's contract, and each name it
uses against the files the harness finds by that name."""
import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= bench["run_seconds"] <= 51
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and ONE_LINE.match(w["why"])
        assert NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and ONE_LINE.match(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(open(os.path.join(harness.ROOT, "BENCHMARK.json")).read()
               ) <= 64 * 1024


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for cell in cells:
        reported = {m["name"] for m in harness.cell_metrics(
            bench, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(bench, cell, "per_layer")
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_every_configuration_has_a_cell(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_every_name_has_its_files(bench):
    for c in bench["configs"]:
        conf = harness.load_json(harness.ROOT, c["file"])
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["fields"]["dtype"] == "float32"
    for w in bench["workloads"]:
        for part, name in (("configs", w["config"]),
                           ("traffic", w["traffic"]),
                           ("limits", w["name"])):
            assert os.path.exists(os.path.join(harness.HERE, part,
                                               f"{name}.json"))
    for m in bench["end_to_end"]:
        assert callable(harness.load_reader(m["name"]).read)
    for m in bench["per_layer"]:
        reader = harness.load_reader(m["name"])
        assert callable(reader.read)
        for targets in reader.SPANS.values():
            for t in targets:
                assert re.fullmatch(r"[\w.]+:\w+", t)


@pytest.mark.parametrize("cells", [3, 24])
def test_run_seconds_fits_the_check(bench, cells):
    """2 + 14 x cells runs of run_seconds + 60 s, 180 s a cell to compile
    and 1200 s spare fit into 43200 s, up to the full 24 cells."""
    runs = 2 + 14 * cells
    assert (runs * (bench["run_seconds"] + 60) + 180 * cells + 1200
            <= 43200)
