"""PyTorch port: the double forms of kernels B6-B9 (the float64
SPARTACUS path's), checked on the CPU without a card.

- `_cuda.launch(name, ..., dtype=torch.float64)` takes each new `_f64`
  entry point (B6-B9's, and B12's, the aerosol optics, which the float64
  SPARTACUS call launches too), its scalar arguments as doubles, and
  counts `launch.<name>.f64`; float32 takes the float entry and counts
  `.f32`. B12's wrapper launches the form of its operands' dtype.
- Each wrapper of B6-B9 (ops/spartacus_reftrans.py, spartacus_adding.py)
  handed float64 operands launches its passes' double forms alone and
  allocates its outputs, staging and scratch in float64; float32 ones the
  float forms. (A stand-in library records the calls, and tensors on the
  CPU pass the device check.)
- The wrappers still refuse half-precision, mixed-dtype, strided and,
  without the stand-in, CPU tensors.
- Each double form's stages keep its blocks per SM (the F64_* constants
  of csrc/spartacus_adding.cu and spartacus_reftrans.cu) at 2 and 3
  regions, within the H100's 228 KB of shared memory and 64 K registers.
- A SPARTACUS call puts its adding sweeps (B8, B9) in `ecrad.sweeps`
  spans of their own, inside the solvers' spans.

The double forms against their plain versions, and the float64 call on
the card, are tests/test_torch_kernels_gpu.py's (marked gpu).
"""
import os
import re

import numpy as np
import pytest
import torch

from ecrad_tpu_torch.config import spartacus_slice_config
from ecrad_tpu_torch.convert import columns_to_inputs
from ecrad_tpu_torch.inputs import (add_effective_sizes, make_aerosols,
                                    make_clouds, make_columns,
                                    write_synthetic_luts)
from ecrad_tpu_torch.interface import radiation, setup_radiation
from ecrad_tpu_torch.ops import _cuda
from ecrad_tpu_torch.ops import aerosol_optics as ao
from ecrad_tpu_torch.ops import spartacus_adding as sa
from ecrad_tpu_torch.ops import spartacus_reftrans as sr
from ecrad_tpu_torch.utils import hooks

import aerosol_cases as aer_cases

NEW = ("spartacus_sw_reftrans_3d", "spartacus_sw_reftrans_fallback",
       "spartacus_lw_reftrans_3d", "spartacus_lw_reftrans_fallback",
       "spartacus_sw_adding", "spartacus_lw_adding")


@pytest.fixture(autouse=True)
def _hooks_restored(monkeypatch):
    monkeypatch.setattr(hooks, "LHOOK", False)
    hooks.reset_profile()
    yield
    hooks.reset_profile()


@pytest.fixture
def library(monkeypatch):
    """A stand-in for the kernel library that records each entry point
    called and its arguments, and CPU tensors that pass as CUDA tensors."""
    called = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: called.append((name, args)) or 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_cuda, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    return called


@pytest.mark.parametrize("dtype, suffix, tag", [
    (torch.float32, "", "f32"), (torch.float64, "_f64", "f64")])
@pytest.mark.parametrize("name", NEW + ("aerosol_optics",))
def test_launch_takes_each_double_entry_and_counts_it(library, name, dtype,
                                                      suffix, tag):
    sig = _cuda._SIGS[name]
    args = [torch.zeros(2, dtype=dtype) if s == "p" else
            1 if s == "i" else 0.5 for s in sig]
    hooks.enable(True)
    _cuda.launch(name, *args, dtype=dtype)
    hooks.enable(False)
    assert [c[0] for c in library] == [name + suffix]
    assert hooks.counters() == {f"launch.{name}.{tag}": 1}
    # the float form takes a float scalar, the double form a double
    assert _cuda._SIGS[name + suffix] == (sig.replace("f", "d")
                                          if suffix else sig)
    if "f" in sig:
        assert "d" in _cuda._SIGS[name + "_f64"]


def _case(nreg=3, nlev=3, ng=4, ncol=5, dtype=np.float64, seed=3):
    """Operands of B6-B9 (shapes and dtypes only matter here)."""
    rng = np.random.RandomState(seed)
    r = lambda *s: torch.as_tensor(rng.rand(*s).astype(dtype))  # noqa: E731
    c = dict(od=r(nlev, nreg, ng, ncol), ssa=r(nlev, nreg, ng, ncol),
             g=r(nlev, nreg, ng, ncol), trd=r(nlev, nreg, nreg, ncol),
             trf=r(nlev, nreg, nreg, ncol), mu0=r(ncol) + 0.1,
             use3d=torch.as_tensor(rng.rand(nlev, ng, ncol) > 0.5),
             clear=torch.as_tensor(rng.rand(nlev, ncol) > 0.5),
             se=r(nlev, ng, ncol), pt=r(nlev, ng, ncol),
             pb=r(nlev, ng, ncol), fr=r(nlev, nreg, ncol))
    c["hist"] = r(nlev, 5 * nreg * nreg, ng, ncol)
    c["cols"] = r(nlev, sa.NCOLROWS, ncol)
    c["init"] = r(2 * nreg * nreg, ng, ncol)
    c["d0"] = r(nreg, ng, ncol)
    c["lhist"] = r(nlev, 2 * nreg * (nreg + 1), ng, ncol)
    c["lcols"] = r(nlev, sa.LW_NCOLROWS, ncol)
    c["linit"] = r(nreg * nreg + nreg, ng, ncol)
    return c


SW_RT = ("od", "ssa", "g", "trd", "trf", "mu0", "use3d", "clear")
LW_RT = ("od", "ssa", "g", "trd", "se", "pt", "pb", "fr", "use3d", "clear")


def _calls(kernel, c):
    """(wrapper call, its entry points) of each kernel on operands c."""
    cfg = spartacus_slice_config()
    return {
        "B6": (lambda: sr.sw_reftrans_levels_fused(
            8.0, *(c[k] for k in SW_RT)),
            ["spartacus_sw_reftrans_3d", "spartacus_sw_reftrans_fallback"]),
        "B7": (lambda: sr.lw_reftrans_levels_fused(
            8.0, False, *(c[k] for k in LW_RT)),
            ["spartacus_lw_reftrans_3d", "spartacus_lw_reftrans_fallback"]),
        "B8": (lambda: sa.sw_adding_sweeps_fused(
            cfg, c["hist"], c["cols"], c["init"], c["d0"]),
            ["spartacus_sw_adding"]),
        "B9": (lambda: sa.lw_adding_sweeps_fused(
            cfg, True, c["lhist"], c["lcols"], c["linit"]),
            ["spartacus_lw_adding"]),
    }[kernel]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nreg", [3, 2])
@pytest.mark.parametrize("kernel", ["B6", "B7", "B8", "B9"])
def test_the_wrappers_launch_the_form_of_their_dtype(library, monkeypatch,
                                                     kernel, nreg, dtype):
    """A wrapper handed operands of one dtype calls that dtype's entry
    points alone, with its outputs and every buffer it hands a kernel
    (staging, scratch) in that dtype."""
    c = _case(nreg, dtype=dtype)
    call, entries = _calls(kernel, c)
    handed = []
    real = _cuda.launch
    monkeypatch.setattr(_cuda, "launch", lambda name, *args, **kw: (
        handed.append(args), real(name, *args, **kw))[1])
    out = call()
    f64 = dtype == np.float64
    assert [n for n, _ in library] == [e + ("_f64" if f64 else "")
                                       for e in entries]
    want = torch.float64 if f64 else torch.float32
    outs = [out] if isinstance(out, torch.Tensor) else list(out)
    assert all(o.dtype == want for o in outs)
    assert len(handed) == len(entries)
    for args in handed:
        floats = [a for a in args if isinstance(a, torch.Tensor)
                  and a.is_floating_point()]
        assert floats and all(a.dtype == want for a in floats)


@pytest.mark.parametrize("dtype, tag", [("float32", "f32"),
                                        ("float64", "f64")])
def test_the_aerosol_kernel_launches_the_form_of_its_dtype(
        library, tmp_path, dtype, tag):
    """Kernel B12's wrapper (ops/aerosol_optics.py), handed one float
    dtype, calls that dtype's entry point once, counts
    `launch.aerosol_optics.<f32|f64>`, and returns its six outputs in that
    dtype: so a float64 SPARTACUS or McICA call on the card launches B12
    in its double form, one `.f64` launch more than its solver's."""
    luts = write_synthetic_luts(str(tmp_path), 0)
    x = aer_cases.inputs(ncol=3, nlev=4)
    _, args = aer_cases.port_args(aer_cases.config(luts), x, dtype, "cpu",
                                  int32=True)
    hooks.enable(True)
    out = ao.aerosol_optics_fused(*args)
    hooks.enable(False)
    suffix = "_f64" if tag == "f64" else ""
    assert [n for n, _ in library] == ["aerosol_optics" + suffix]
    assert hooks.counters() == {f"launch.aerosol_optics.{tag}": 1}
    assert len(out) == 6
    assert all(o.dtype == getattr(torch, dtype) for o in out)


@pytest.mark.parametrize("kernel", ["B6", "B7", "B8", "B9"])
@pytest.mark.parametrize("fault", ["half", "mixed", "strided"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(library, kernel,
                                                          fault):
    """Half-precision operands, a float32 operand among float64 ones and a
    strided operand are refused before any launch."""
    c = _case()
    first = {"B6": "od", "B7": "od", "B8": "hist", "B9": "lhist"}[kernel]
    other = {"B6": "mu0", "B7": "fr", "B8": "cols", "B9": "lcols"}[kernel]
    if fault == "half":
        c = {k: v.half() if v.is_floating_point() else v
             for k, v in c.items()}
    elif fault == "mixed":
        c[other] = c[other].float()
    else:
        x = c[first]
        c[first] = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    error = ValueError if fault == "strided" else TypeError
    with pytest.raises(error):
        _calls(kernel, c)[0]()
    assert library == []


@pytest.mark.parametrize("kernel", ["B6", "B7", "B8", "B9"])
def test_the_wrappers_refuse_cpu_tensors(kernel):
    with pytest.raises(ValueError, match="CUDA"):
        _calls(kernel, _case())[0]()


def _constants(path):
    with open(os.path.join(_cuda.CSRC, path)) as f:
        src = f.read()
    return {k: int(v) for k, v in re.findall(
        r"\b((?:F64_)?[A-Z][A-Z0-9_]*) = (\d+)\b", src)}


@pytest.mark.parametrize("nreg", [3, 2])
def test_double_windows_keep_their_blocks_on_an_sm(nreg):
    """B8's and B9's double stages (8-byte values) within the 227 KB a
    block may have, F64_SW_MIN_BLOCKS and F64_LW_MIN_BLOCKS blocks (1 KB
    reserved each) within an SM's 228 KB and, at 255 or fewer registers a
    thread, its 64 K registers, with multilayer effects on and off; a ring
    of at least 2 stages; the passes of B6 and B7 over every cell and
    B7's 3D pass likewise within the registers their bounds leave."""
    k = _constants("spartacus_adding.cu")
    nn = nreg * nreg
    threads = k["F64_G_TILE"] * k["F64_C_TILE"]
    up = 5 * nn * threads + k["UP_COLROWS"] * k["F64_C_TILE"]
    dn = 6 * nn * threads + k["DN_COLROWS"] * k["F64_C_TILE"]
    b8 = k["F64_STAGES"] * max(up, dn) * 8
    assert b8 <= 227 * 1024
    assert k["F64_SW_MIN_BLOCKS"] * (b8 + 1024) <= 228 * 1024
    assert threads % 32 == 0 and k["F64_STAGES"] >= 2
    assert 65536 // (threads * k["F64_SW_MIN_BLOCKS"]) >= 255
    lw_threads = k["F64_LW_G_TILE"] * k["C_TILE"]
    for ml in (True, False):
        ns = nn + nreg if ml else 2 * nreg
        up = (2 * nn + 2 * nreg) * lw_threads + (2 * nn + 2) * k["C_TILE"]
        dn = (2 * nn + nreg + ns) * lw_threads + (nn + 2) * k["C_TILE"]
        b9 = k["F64_LW_STAGES"] * max(up, dn) * 8
        assert k["F64_LW_MIN_BLOCKS"] * (b9 + 1024) <= 228 * 1024, ml
    assert k["F64_LW_STAGES"] >= 2 and lw_threads % 32 == 0
    assert 65536 // (lw_threads * k["F64_LW_MIN_BLOCKS"]) >= 128
    r = _constants("spartacus_reftrans.cu")
    assert 65536 // (r["LEAN_THREADS"] * r["LEAN_MIN_BLOCKS"]) >= 64
    assert 65536 // (r["THREADS"] * r["F64_LW_3D_MIN_BLOCKS"]) >= 255


def test_a_spartacus_call_spans_its_adding_sweeps(tmp_path):
    """One SPARTACUS call on the CPU under torch.profiler: four
    `ecrad.sweeps` spans, B8's and B9's (sw/lw_adding_sweeps) beside the
    clear sky's two, each inside a solver's span."""
    setup = setup_radiation(spartacus_slice_config(
        **write_synthetic_luts(str(tmp_path), 0, ice="fu"),
        dtype="float64"), device="cpu")
    cols = add_effective_sizes(make_aerosols(make_clouds(make_columns(
        4, 12, 3), 3), 3))
    inputs = columns_to_inputs(cols, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        radiation(setup, *inputs)
    spans = {}
    for e in prof.events():
        if e.name.startswith("ecrad."):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    solvers = spans["ecrad.solver_lw"] + spans["ecrad.solver_sw"]
    assert len(spans["ecrad.sweeps"]) == 4
    for s, e in spans["ecrad.sweeps"]:
        assert any(ps <= s and e <= pe for ps, pe in solvers)
