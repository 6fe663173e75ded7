"""PyTorch port: the program's own spans and counters (utils/hooks.py).

`hook()` costs nothing past a flag test with the profiler and LHOOK off
(no record_function is opened); `enable`, `count`, `counters`, `sync`
and `reset_profile`; one small McICA (Exp-Exp) call and one Tripleclouds
call with LHOOK on, under torch.profiler: the `ecrad.*` spans nest as the
layers do, the merge passes and the host syncs are counted, and the
fluxes are the same bits with the hooks on and off.

A call on the CPU of each solver with torch.as_tensor, torch.tensor and
torch.from_numpy refusing numpy arrays: setup_radiation put every static
array on the device, so the call turns no host array into a tensor and
counts no upload but the McICA generator's key (`sync.upload.threefry`).

The test marked `gpu` runs one call of McICA, Tripleclouds and SPARTACUS
on the card under torch.cuda.set_sync_debug_mode("warn"): every
synchronising operation of the call goes through hooks.sync, so the
warnings equal the sync counters, and the sites left are the level
orientation and float32 SW layer optics' resonance window outside
kernels B4 and B11; McICA's random fields and generator are two kernel
launches each and no sync, Tripleclouds' SW layer optics one launch
of B11, every kind's aerosol optics one launch of B12, and SPARTACUS's
adding sweeps (B8, B9) two `ecrad.sweeps` spans beside the clear sky's.
The file imports no jax; on the card:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_tracing.py
"""
import warnings

import numpy as np
import pytest
import torch

from ecrad_tpu_torch.config import (TRIPLECLOUDS_AEROSOL_MAP, Solver,
                                    cloudless_slice_config,
                                    mcica_slice_config,
                                    spartacus_slice_config,
                                    tripleclouds_slice_config)
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                    make_clouds, make_columns,
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
        "ecrad.lw_derivatives": ("ecrad.solver_lw",)},
}

# the sync sites of one call on the card, with how often each runs: the
# level orientation, and the resonance window of each float32 SW layer
# optics pass outside kernels B4 and B11 (SPARTACUS's clear sky), which
# evaluate the window in double themselves
CARD_SYNCS = {
    "mcica": {"sync.orientation": 1},
    "tripleclouds": {"sync.orientation": 1},
    "spartacus": {"sync.orientation": 1, "sync.resonance": 1},
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
    if kind == "cloudless":
        config = cloudless_slice_config()
    elif kind in ("mcica", "homogeneous"):
        solver = {"mcica": {}, "homogeneous": dict(
            i_solver_sw=Solver.HOMOGENEOUS, i_solver_lw=Solver.HOMOGENEOUS)}
        config = mcica_slice_config(**write_synthetic_luts(tmp, 0),
                                    **MCICA_EXTRA, **solver[kind])
    else:
        make = {"tripleclouds": tripleclouds_slice_config,
                "spartacus": spartacus_slice_config}[kind]
        config = make(**write_synthetic_luts(tmp, 0, ice="fu"))
    setup = setup_radiation(config, device=device)
    cols = make_aerosols(make_clouds(make_columns(ncol, nlev, 3), 3), 3)
    if kind == "spartacus":
        cols = add_effective_sizes(cols)
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
    snap = hooks.counters()
    assert snap == {"passes": 5, "sync.site": 1}
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


@pytest.mark.parametrize("kind", ["cloudless", "homogeneous", "mcica",
                                  "tripleclouds", "spartacus"])
def test_a_call_turns_no_host_array_into_a_tensor(kind, tmp_path,
                                                  monkeypatch):
    """One call on the CPU with torch.as_tensor, torch.tensor and
    torch.from_numpy refusing numpy arrays, the hooks on: every static
    array a call reads is on the device from setup_radiation, so nothing
    is converted and no upload is counted but the generator's key."""
    setup, inputs = _state(kind, "cpu", tmp=str(tmp_path))

    def refusing(fn):
        def guarded(data, *args, **kwargs):
            if isinstance(data, (np.ndarray, np.generic)):
                raise AssertionError(f"{fn.__name__} of a numpy array")
            return fn(data, *args, **kwargs)
        return guarded
    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refusing(getattr(torch, name)))
    hooks.enable(True)
    radiation(setup, *inputs)
    counts = hooks.counters()
    hooks.enable(False)
    uploads = {k for k in counts if k.startswith("sync.upload.")}
    assert uploads <= {"sync.upload.threefry"}, uploads
    assert ("sync.upload.threefry" in uploads) == (kind == "mcica")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mcica", "tripleclouds", "spartacus"])
def test_every_sync_of_a_call_is_counted(kind, tmp_path):
    """One call on the card under set_sync_debug_mode("warn"): as many
    synchronising operations as the sync counters hold, at the sites of
    CARD_SYNCS alone."""
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
    # McICA's two generator calls draw in one kernel launch each, with no
    # upload of the key, and run the generator in one more each, with no
    # sync of the cover's merge loop
    counts = hooks.counters()
    assert {k: v for k, v in counts.items() if k.startswith("sync.")} \
        == CARD_SYNCS[kind]
    calls = 2 if kind == "mcica" else 0
    assert counts.get("threefry.kernel", 0) == calls
    assert counts.get("launch.mcica_generator.f32", 0) == calls
    assert counts.get("launch.tc_sw_optics.f32", 0) == int(
        kind == "tripleclouds")
    # the aerosol optics of both spectra: one launch of B12 a call, in
    # every solver kind
    assert counts.get("launch.aerosol_optics.f32", 0) == 1
    assert "sync.upload.threefry" not in counts
    assert "sync.cover_merge" not in counts
    assert "cloud_cover.merge_passes" not in counts
    if kind == "spartacus":
        # B8 and B9 (sw/lw_adding_sweeps) each in an `ecrad.sweeps` span
        # of its own, beside the clear sky's two sweeps
        _, spans = _profiled(lambda: radiation(setup, *inputs))
        torch.cuda.synchronize()
        assert len(spans["ecrad.sweeps"]) == 4


def test_plain_on_device_counts_only_while_the_hooks_are_on():
    """hooks.plain_on_device(site) counts `plain_on_device.<site>` through
    hooks.count while LHOOK is on, and nothing while it is off."""
    hooks.plain_on_device("probe")
    assert hooks.counters() == {}
    hooks.enable(True)
    hooks.plain_on_device("probe")
    hooks.plain_on_device("probe")
    hooks.plain_on_device("other")
    assert hooks.counters() == {"plain_on_device.probe": 2,
                                "plain_on_device.other": 1}
    hooks.enable(False)
    hooks.plain_on_device("probe")
    assert hooks.counters()["plain_on_device.probe"] == 2


def test_a_float64_mcica_call_on_the_cpu_runs_nothing_plain_on_a_device(
        tmp_path, monkeypatch):
    """A float64 call of the McICA path (the cells' aerosols and LW
    derivatives) on the CPU with LHOOK on: every layer takes its plain
    version on CPU tensors, which is no plain version on a device, so
    hooks.plain_on_device is called zero times; no kernel is launched, so
    no launch is counted; every output is float64."""
    seen = []
    real = hooks.plain_on_device
    monkeypatch.setattr(hooks, "plain_on_device",
                        lambda site: (seen.append(site), real(site)))
    config = mcica_slice_config(**write_synthetic_luts(str(tmp_path), 0),
                                **MCICA_EXTRA, dtype="float64")
    setup = setup_radiation(config, device="cpu")
    cols = make_aerosols(make_clouds(make_columns(4, 16, 3), 3), 3)
    hooks.enable(True)
    flux = radiation(setup, *columns_to_inputs(cols, device="cpu"))
    counts = hooks.counters()
    hooks.enable(False)
    assert seen == []
    assert not [k for k in counts if k.startswith(("plain_on_device.",
                                                   "launch."))]
    for k, v in flux.fields():
        assert v.dtype == torch.float64, k


@pytest.mark.parametrize("dtype, entry, tag", [
    (torch.float32, "sw_adding", "f32"),
    (torch.float64, "sw_adding_f64", "f64")])
def test_a_launch_takes_the_entry_of_its_dtype_and_counts_it(
        monkeypatch, dtype, entry, tag):
    """_cuda.launch(name, ..., dtype=) calls the C entry point of that
    dtype (the double form's name ends in _f64) and counts
    `launch.<name>.<f32|f64>` while LHOOK is on; a kernel without a double
    form, or a dtype without a form, is refused before any call."""
    from ecrad_tpu_torch.ops import _cuda
    called = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: called.append(name) or 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_cuda, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    x = torch.zeros(3, dtype=dtype)
    args = [x] * 9 + [1, 1, 3] + [x] * 4
    hooks.enable(True)
    _cuda.launch("sw_adding", *args, dtype=dtype)
    _cuda.launch("sw_adding", *args)
    assert called == [entry, "sw_adding"]
    assert hooks.counters() == {f"launch.sw_adding.{tag}": 1}
    with pytest.raises(TypeError):
        _cuda.launch("tc_sw_sweeps", *args, dtype=dtype)
    with pytest.raises(TypeError):
        _cuda.launch("sw_adding", *args, dtype=torch.float16)
    hooks.enable(False)
    assert called == [entry, "sw_adding"]


def test_a_float_only_kernel_is_launched_and_counted_in_float32_only(
        monkeypatch):
    """Kernel B11 (tc_sw_optics) has a float form only (F32_FORMS):
    _cuda.launch(..., dtype=torch.float32) calls its one entry point and
    counts `launch.tc_sw_optics.f32` while LHOOK is on; float64 is
    refused before any call."""
    from ecrad_tpu_torch.ops import _cuda
    called = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: called.append(name) or 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_cuda, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    x = torch.zeros(3)
    args = [x] * 10 + [1] * 6 + [x] * 2
    hooks.enable(True)
    _cuda.launch("tc_sw_optics", *args, dtype=torch.float32)
    with pytest.raises(TypeError):
        _cuda.launch("tc_sw_optics", *args, dtype=torch.float64)
    hooks.enable(False)
    assert called == ["tc_sw_optics"]
    assert hooks.counters() == {"launch.tc_sw_optics.f32": 1}
    assert "tc_sw_optics_f64" not in _cuda._SIGS


def test_the_dtype_check_takes_float32_and_float64_only():
    """_cuda.scalar: a kernel with a double form takes a float32 or
    float64 leading operand; a CPU tensor or any other dtype raises. The
    double form takes the float form's arguments with double in place of
    float, its scalar arguments too."""
    from ecrad_tpu_torch.ops import _cuda
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.scalar(torch.zeros(2, dtype=torch.float64), "x")
    assert set(_cuda._DTYPES) == {torch.float32, torch.float64}
    assert {n + "_f64" for n in _cuda.F64_FORMS} <= set(_cuda._SIGS)
    # B12, the aerosol optics, has both forms; B11 the float form alone
    assert "aerosol_optics" in _cuda.F64_FORMS
    assert "tc_sw_optics" not in _cuda.F64_FORMS
    for n in _cuda.F64_FORMS:
        assert _cuda._SIGS[n + "_f64"] == _cuda._SIGS[n].replace("f", "d")
        assert "f" not in _cuda._SIGS[n + "_f64"]
