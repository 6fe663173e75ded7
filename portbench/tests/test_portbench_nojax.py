"""No run loads JAX or the JAX package, and the reference loads nothing
of the port: top-level module names compared whole, so that
ecrad_tpu_torch is not taken for ecrad_tpu."""
import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import ROOT

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
r = harness.run_cell(bench, {cell!r}, 7, 0.2, False, "cpu", ncol=4,
                     levels=12)
print(json.dumps({{"correct": r["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _child(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _child(RUN.format(root=ROOT, cell="tripleclouds.cols2048"))
    assert got["correct"]
    assert "ecrad_tpu_torch" in got["top"]
    assert not set(got["top"]) & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    got = _child(f"""
import json, sys
sys.path.insert(0, {ROOT!r})
import portbench.reference.interface, portbench.reference.lowprec
import portbench.check, portbench.columns, portbench.roofline
import portbench.trace
print(json.dumps({{"top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
""")
    assert not set(got["top"]) & {"ecrad_tpu_torch", *harness.FORBIDDEN}


def test_names_compare_whole(monkeypatch):
    for name in ("ecrad_tpu_torch_extra", "jaxlike", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ecrad_tpu.config", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["ecrad_tpu", "jax"]
