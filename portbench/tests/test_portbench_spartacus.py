"""The reference's SPARTACUS path (reference/solvers/spartacus_*.py, a
frozen copy) against the port's plain path, both in float64 on the CPU,
and the frozen effective cloud sizes against the port's: the copies
follow the port to rounding."""
import numpy as np
import pytest
import torch

from ecrad_tpu_torch import convert, inputs, interface
from portbench import columns, harness
from portbench.reference import config as ref_config
from portbench.reference import interface as ref

GEOMETRY = {"cloud_separation_scale_surface": 2500.0,
            "cloud_separation_scale_toa": 14000.0,
            "cloud_separation_scale_power": 3.5,
            "cloud_inhom_separation_factor": 0.75}


def test_effective_sizes_follow_the_port():
    cols = columns.make_clouds(columns.make_columns(6, 20, 3), 3)
    got = columns.add_effective_sizes(cols, **GEOMETRY)
    want = inputs.add_effective_sizes(cols, 2500.0, 14000.0, 3.5, 0.75)
    for k in ref.EFFECTIVE_SIZE_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-13, atol=0)


@pytest.mark.parametrize("seed", (5, 2 ** 31 + 9))
def test_the_reference_follows_the_port(bench, tmp_path, seed):
    conf = harness.load_json(harness.HERE, "configs", "ifs_spartacus.json")
    assert conf["cloud_geometry"] == GEOMETRY
    fields = dict(conf["fields"], dtype="float64")
    assert (fields["nregions"], fields["i_3d_sw_entrapment"]) == \
        (3, "Explicit")
    names = columns.write_synthetic_luts(str(tmp_path), seed)
    traffic = dict(harness.load_json(harness.HERE, "traffic",
                                     "cols2048.json"), levels=20, pool=1)
    batch = harness.make_pool(traffic, seed, True, 6,
                              conf["cloud_geometry"])[0]
    cpu = torch.device("cpu")
    setup = interface.setup_radiation(
        harness.program_config(fields, names["directory_name"]), device=cpu)
    got = dict(interface.radiation(setup, *convert.columns_to_inputs(
        batch, device=cpu, dtype=torch.float64)).fields())
    rsetup = ref.setup(ref_config.from_fields(
        fields, directory_name=names["directory_name"]), cpu,
        dtype=torch.float64)
    want = dict(ref.radiation(rsetup,
                              *ref.columns_to_inputs(batch, cpu)).fields())
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(w.abs().max().clamp(min=1.0))
        assert float((got[k] - w).abs().max()) <= 1e-12 * scale, k
    # the 3D terms were taken: without the effective sizes the fluxes move
    flat = dict(batch)
    for k in ref.EFFECTIVE_SIZE_KEYS:
        del flat[k]
    one_d = dict(ref.radiation(rsetup,
                               *ref.columns_to_inputs(flat, cpu)).fields())
    assert float((one_d["sw_up"] - want["sw_up"]).abs().max()) > 1.0
