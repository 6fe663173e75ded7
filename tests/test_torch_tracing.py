"""PyTorch port: the program's own spans and counters (utils/hooks.py).

`hook()` costs nothing past a flag test with the profiler and LHOOK off
(no record_function is opened); `enable`, `count`, `counters`, `sync`
and `reset_profile`; one small McICA (Exp-Exp) call and one Tripleclouds
call with LHOOK on, under torch.profiler: the `ecrad.*` spans nest as the
layers do, the merge passes and the host syncs are counted, and the
fluxes are the same bits with the hooks on and off.

The test marked `gpu` runs one call of each on the card under
torch.cuda.set_sync_debug_mode("warn"): every synchronising operation
of the call goes through hooks.sync, so the warnings equal the sync
counters. The file imports no jax; on the card:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_tracing.py
"""
import warnings

import pytest
import torch

from ecrad_tpu_torch.config import (TRIPLECLOUDS_AEROSOL_MAP,
                                    mcica_slice_config,
                                    tripleclouds_slice_config)
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import (make_aerosols, make_clouds, make_columns,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.utils import hooks

# the McICA call with the cells' aerosols and LW derivatives
MCICA_EXTRA = dict(use_aerosols=True,
                   n_aerosol_types=len(TRIPLECLOUDS_AEROSOL_MAP),
                   i_aerosol_type_map=TRIPLECLOUDS_AEROSOL_MAP,
                   do_lw_derivatives=True)

SOLVERS = ("ecrad.solver_lw", "ecrad.solver_sw")
# child: parents; each span of the child lies inside a span of a parent
NESTING = {
    "mcica": {
        "ecrad.gas_optics": ("ecrad.radiation",),
        "ecrad.aerosol": ("ecrad.radiation",),
        "ecrad.cloud_optics": ("ecrad.radiation",),
        "ecrad.solver_lw": ("ecrad.radiation",),
        "ecrad.solver_sw": ("ecrad.radiation",),
        "ecrad.sync.orientation": ("ecrad.radiation",),
        "ecrad.cloud_generator": SOLVERS,
        "ecrad.cloud_generator.cover": ("ecrad.cloud_generator",),
        "ecrad.cloud_generator.random": ("ecrad.cloud_generator",),
        "ecrad.cloud_generator.walk": ("ecrad.cloud_generator",),
        "ecrad.cloud_generator.sample": ("ecrad.cloud_generator",),
        "ecrad.sync.cover_merge": ("ecrad.cloud_generator.cover",),
        "ecrad.sync.upload.threefry": ("ecrad.cloud_generator.random",),
        "ecrad.layer_optics": SOLVERS,
        "ecrad.sweeps": SOLVERS,
        "ecrad.lw_derivatives": ("ecrad.solver_lw",)},
    "tripleclouds": {
        "ecrad.gas_optics": ("ecrad.radiation",),
        "ecrad.aerosol": ("ecrad.radiation",),
        "ecrad.cloud_optics": ("ecrad.radiation",),
        "ecrad.solver_lw": ("ecrad.radiation",),
        "ecrad.solver_sw": ("ecrad.radiation",),
        "ecrad.sync.orientation": ("ecrad.radiation",),
        "ecrad.regions": SOLVERS,
        "ecrad.layer_optics": SOLVERS,
        "ecrad.sweeps": SOLVERS,
        "ecrad.lw_derivatives": ("ecrad.solver_lw",),
        "ecrad.sync.upload.tripleclouds": SOLVERS},
}


@pytest.fixture(autouse=True)
def _hooks_restored(monkeypatch):
    """Each test starts with the hooks off and no counts, and leaves
    LHOOK as it found it."""
    monkeypatch.setattr(hooks, "LHOOK", False)
    hooks.reset_profile()
    yield
    hooks.reset_profile()


def _state(kind, device, ncol=5, nlev=24, tmp=None):
    if kind == "mcica":
        config = mcica_slice_config(**write_synthetic_luts(tmp, 0),
                                    **MCICA_EXTRA)
    else:
        config = tripleclouds_slice_config(**write_synthetic_luts(
            tmp, 0, ice="fu"))
    setup = setup_radiation(config, device=device)
    cols = make_aerosols(make_clouds(make_columns(ncol, nlev, 3), 3), 3)
    return setup, columns_to_inputs(cols, device=device)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = {}
    for e in prof.events():
        if e.name.startswith("ecrad."):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out, spans


def test_hooks_off_open_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")
    monkeypatch.setattr(hooks, "record_function", refuse)
    with hooks.hook("ecrad.off"):
        with hooks.hook("ecrad.off.inner"):
            pass
    assert hooks.sync("off", int, "7") == 7
    assert hooks.hooked("ecrad.off")(lambda x: 2 * x)(4) == 8
    hooks.count("off")
    assert hooks.counters() == {} and hooks.profile_rows() == []


def test_enable_count_sync_and_reset():
    hooks.enable(True)
    assert hooks.LHOOK
    hooks.count("passes")
    hooks.count("passes", 4)
    assert hooks.sync("site", sum, [1, 2]) == 3
    assert hooks.upload("table", [1.0, 2.0], "cpu").tolist() == [1.0, 2.0]
    snap = hooks.counters()
    assert snap == {"passes": 5, "sync.site": 1, "sync.upload.table": 1}
    snap["passes"] = 0
    assert hooks.counters()["passes"] == 5
    hooks.reset_profile()
    assert hooks.counters() == {}
    hooks.enable(False)
    hooks.count("passes")
    hooks.sync("site", int, 1)
    assert hooks.counters() == {}


def test_sync_is_a_span_under_the_profiler():
    """With LHOOK off a sync still opens its span under a trace, and
    counts nothing."""
    x = torch.arange(6.0)
    got, spans = _profiled(lambda: hooks.sync("probe", bool, (x > 4).any()))
    assert got is True
    assert len(spans["ecrad.sync.probe"]) == 1 and hooks.counters() == {}


@pytest.mark.parametrize("kind", ["mcica", "tripleclouds"])
def test_a_call_holds_its_spans_and_counts(kind, tmp_path):
    setup, inputs = _state(kind, "cpu", tmp=str(tmp_path))
    off = dict(radiation(setup, *inputs).fields())
    hooks.enable(True)
    on, spans = _profiled(lambda: radiation(setup, *inputs))
    counts = hooks.counters()
    hooks.enable(False)
    on = dict(on.fields())
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert len(spans["ecrad.radiation"]) == 1
    for child, parents in NESTING[kind].items():
        outer = [x for p in parents for x in spans[p]]
        for s, e in spans[child]:
            assert any(ps <= s and e <= pe for ps, pe in outer), child
    syncs = {k: v for k, v in counts.items() if k.startswith("sync.")}
    assert syncs and all(v > 0 for v in syncs.values())
    # each counted sync is one span
    for site, n in syncs.items():
        assert len(spans["ecrad." + site]) == n, site
    if kind == "mcica":
        assert len(spans["ecrad.cloud_generator"]) == 2
        # one merge check before each pass and one after the last, in
        # each of the two generator calls
        assert counts["cloud_cover.merge_passes"] > 0
        assert counts["sync.cover_merge"] == \
            counts["cloud_cover.merge_passes"] + 2
    else:
        assert "cloud_cover.merge_passes" not in counts
        assert "ecrad.cloud_generator" not in spans


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mcica", "tripleclouds"])
def test_every_sync_of_a_call_is_counted(kind, tmp_path):
    """One call on the card under set_sync_debug_mode("warn"): as many
    synchronising operations as the sync counters hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    setup, inputs = _state(kind, "cuda", ncol=256, nlev=137,
                           tmp=str(tmp_path))
    radiation(setup, *inputs)
    torch.cuda.synchronize()
    hooks.enable(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            radiation(setup, *inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    hooks.enable(False)
    torch.cuda.synchronize()
    warned = [w for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    counted = sum(v for k, v in hooks.counters().items()
                  if k.startswith("sync."))
    assert counted > 0 and len(warned) == counted, (
        len(warned), hooks.counters(),
        sorted({f"{w.filename}:{w.lineno}" for w in warned}))
