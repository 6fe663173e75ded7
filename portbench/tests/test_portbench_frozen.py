"""The benchmark's frozen copies, pinned by digests of what they make:
the traffic generator (columns.py, from ecrad_tpu_torch/inputs.py), the
trace arithmetic (trace.py, from tools/profile_torch_port.py) and the
least-time arithmetic (roofline.py, from chip_smoke.py). A digest that
moves means the yardstick moved."""
import hashlib
import os

import numpy as np
import pytest

from portbench import columns, roofline
from portbench.trace import Trace


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        v = np.ascontiguousarray(np.asarray(arrays[k], dtype=np.float64))
        h.update(k.encode() + v.tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("seed,digest", [
    (0, "c056d77925d92235"), (2 ** 31 + 5, "9c291965327ce1a0")])
def test_columns_clouds_aerosols(seed, digest):
    cols = columns.make_aerosols(columns.make_clouds(
        columns.make_columns(6, 16, seed), seed), seed)
    assert _digest(cols) == digest


@pytest.mark.parametrize("seed,digest", [
    (0, "071080014443a902"), (2 ** 31 + 5, "d5465d20158d924c")])
def test_effective_sizes(seed, digest):
    cols = columns.add_effective_sizes(columns.make_clouds(
        columns.make_columns(6, 16, seed), seed))
    assert _digest({k: cols[k] for k in ("inv_cloud_effective_size",
                                         "inv_inhom_effective_size")}) \
        == digest


def test_lookup_tables(tmp_path):
    names = columns.write_synthetic_luts(str(tmp_path), 3, ice="fu")
    assert names["ice_optics_override_file_name"] == "synthetic_fu_ice.nc"
    h = hashlib.sha256()
    for f in sorted(os.listdir(tmp_path)):
        h.update(f.encode() + (tmp_path / f).read_bytes())
    assert h.hexdigest()[:16] == "b70aa8dd79eae247"


def test_trace_and_least_time_arithmetic():
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
    t = Trace(ev)
    got = [t.busy_s, t.window_s, *[s for _, s in t.top_gaps(3)],
           roofline.least_time_s(1e9, 1e12), roofline.least_time_s(1e6,
                                                                    1e12)]
    assert hashlib.sha256(np.asarray(got).tobytes()).hexdigest()[:16] == \
        "b3b776455bdf5e8e"
