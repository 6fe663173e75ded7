"""The C entry points of the port's CUDA sources against the ctypes
signatures that ops/_cuda.py gives them.

A mismatch (a missing argument, an int passed where the kernel takes a
pointer) shows on the card only as a fault or a wrong result, and the
kernels build only there; these checks read the sources, so they run
here. Each `extern "C"` function of ecrad_tpu_torch/csrc/*.cu must have a
signature in `_cuda._SIGS` (launches: the stream last) or
`_cuda._INFO_SIGS` (resource queries: an int array last), and each
signature a function.
"""
import glob
import os
import re

import pytest

from ecrad_tpu_torch.ops import _cuda, random_fields

_DECL = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _c_signatures():
    """name -> the 'p'/'i'/'u'/'f'/'d' letters of its parameters."""
    out = {}
    for path in glob.glob(os.path.join(_cuda.CSRC, "*.cu")):
        with open(path) as f:
            for name, params in _DECL.findall(f.read()):
                letters = ""
                for p in params.split(","):
                    p = " ".join(p.split())
                    if "*" in p:
                        letters += "p"
                    elif p.startswith("int "):
                        letters += "i"
                    elif p.startswith("unsigned "):
                        letters += "u"
                    elif p.startswith("float "):
                        letters += "f"
                    elif p.startswith("double "):
                        letters += "d"
                    else:
                        raise AssertionError(f"{name}: parameter {p!r}")
                out[name] = letters
    return out


SIGS = _c_signatures()


def test_every_entry_point_has_a_signature():
    assert set(SIGS) == set(_cuda._SIGS) | set(_cuda._INFO_SIGS)


@pytest.mark.parametrize("name", sorted(_cuda._SIGS))
def test_launch_signature_matches_source(name):
    # the ctypes call appends the stream, a pointer
    assert SIGS.get(name) == _cuda._SIGS[name] + "p"


@pytest.mark.parametrize("name", sorted(_cuda._INFO_SIGS))
def test_info_signature_matches_source(name):
    # the query's last argument receives len(INFO_FIELDS) ints
    assert SIGS.get(name) == _cuda._INFO_SIGS[name] + "p"


def _constants(path, names):
    """The int values of `constexpr int` names in a source of csrc/."""
    with open(os.path.join(_cuda.CSRC, path)) as f:
        src = f.read()
    out = {}
    for name in names:
        m = re.search(rf"\b{name}\s*=\s*(\d+)", src)
        assert m, name
        out[name] = int(m.group(1))
    return out


@pytest.mark.parametrize("nreg", [3, 2])
def test_b8_stage_ring_fits_an_sm(nreg):
    """B8's shared-memory stages (spartacus_adding.cu SwStage) within the
    227 KB a block may have, and its blocks per SM (the launch bound's
    minimum) within the SM's 228 KB and 64 K registers at 255 or fewer
    per thread. The stage size depends on no shape: each level of any
    nlev, ng and ncol goes through the same ring."""
    k = _constants("spartacus_adding.cu", ("G_TILE", "C_TILE", "STAGES",
                                           "SW_MIN_BLOCKS", "UP_COLROWS",
                                           "DN_COLROWS"))
    threads = k["G_TILE"] * k["C_TILE"]
    nn = nreg * nreg
    floats = max(5 * nn * threads + k["UP_COLROWS"] * k["C_TILE"],
                 6 * nn * threads + k["DN_COLROWS"] * k["C_TILE"])
    stage_bytes = k["STAGES"] * floats * 4
    assert stage_bytes <= 227 * 1024
    # the SM reserves 1 KB of shared memory per resident block
    assert k["SW_MIN_BLOCKS"] * (stage_bytes + 1024) <= 228 * 1024
    regs = 65536 // (threads * k["SW_MIN_BLOCKS"])
    assert min(regs, 255) >= 64
    assert threads % 32 == 0 and k["STAGES"] >= 2


def test_threefry_block_span_matches_the_wrapper():
    """The values a block of the random-fields kernel owns (threefry.cu
    SPAN = THREADS * VEC * GROUPS), which the wrapper's bound on a draw's
    size keeps the kernel's 32-bit indices under 2**31; a thread's VEC
    floats make one 16-byte store."""
    k = _constants("threefry.cu", ("THREADS", "VEC", "GROUPS"))
    assert k["THREADS"] * k["VEC"] * k["GROUPS"] == random_fields.SPAN
    assert k["VEC"] * 4 == 16 and k["THREADS"] % 32 == 0
