"""PyTorch port: the Fortran sequential-record reader and the native host
cores (ecrad_tpu_torch/utils/native.py, csrc/host/*.cc) against the JAX
package's (ecrad_tpu/utils/native.py), on the CPU.

The port builds its own copies of the C++ cores with g++ into
ecrad_tpu_torch/_build/ at first use; without a compiler both packages
read through numpy. Every reader must give the JAX native reader's
values bit for bit.
"""
import os
import shutil
import struct

import numpy as np
import pytest

from ecrad_tpu.utils import native as jnative
from ecrad_tpu_torch.utils import native as pnative

# record lengths in float64 values
RECORDS = (1, 37, 4800)

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ compiler")


def _write(path, records, trailer_delta=0):
    """Big-endian Fortran sequential records; the last record's trailer
    off by trailer_delta bytes."""
    with open(path, "wb") as f:
        for i, rec in enumerate(records):
            payload = rec.astype(">f8").tobytes()
            f.write(struct.pack(">i", len(payload)))
            f.write(payload)
            bad = trailer_delta if i == len(records) - 1 else 0
            f.write(struct.pack(">i", len(payload) + bad))


@pytest.fixture
def records():
    rng = np.random.RandomState(11)
    recs = [rng.standard_normal(n) * 10.0 ** rng.uniform(-30, 30, n)
            for n in RECORDS]
    recs[1][:3] = (0.0, -0.0, np.finfo(np.float64).tiny)
    return recs


def _reader(kind, monkeypatch):
    """The FortranFile class of `kind`, with its native core built, or
    with the core forced off (the numpy path)."""
    if kind.endswith("numpy"):
        mod = jnative if kind.startswith("jax") else pnative
        monkeypatch.setattr(mod, "fort_lib", lambda: None)
        return mod.FortranFile
    mod = jnative if kind == "jax" else pnative
    assert mod.fort_lib() is not None
    return mod.FortranFile


READERS = ["jax", "port", "port_numpy", "jax_numpy"]


@needs_gxx
@pytest.mark.parametrize("kind", READERS)
def test_reader_matches_the_jax_reader_bit_for_bit(tmp_path, monkeypatch,
                                                   records, kind):
    path = str(tmp_path / "records.bin")
    _write(path, records)
    with jnative.FortranFile(path) as f:
        want = [f.read_f64() for _ in RECORDS]
    cls = _reader(kind, monkeypatch)
    with cls(path) as f:
        assert (f._lib is None) == kind.endswith("numpy")
        got = [f.read_f64() for _ in RECORDS]
        with pytest.raises(EOFError):
            f.read_f64()
    for g, w, r in zip(got, want, records):
        assert g.dtype == np.float64 and g.shape == r.shape
        np.testing.assert_array_equal(g.view(np.uint64), w.view(np.uint64))
        np.testing.assert_array_equal(g.view(np.uint64), r.view(np.uint64))


@needs_gxx
@pytest.mark.parametrize("kind", READERS)
def test_reader_refuses_a_trailer_unlike_its_header(tmp_path, monkeypatch,
                                                    records, kind):
    path = str(tmp_path / "bad.bin")
    _write(path, records, trailer_delta=8)
    cls = _reader(kind, monkeypatch)
    with cls(path) as f:
        f.read_f64()
        f.read_f64()
        with pytest.raises(IOError):
            f.read_f64()


@needs_gxx
def test_port_builds_its_own_cores_into_its_build_directory():
    """Both libraries come from the port's csrc/host sources, named by a
    hash of the source, under ecrad_tpu_torch/_build/."""
    for lib, stem in ((pnative.hook_lib(), "libecrhook_"),
                      (pnative.fort_lib(), "libfortread_")):
        assert lib is not None
        path = os.path.realpath(lib._name)
        assert os.path.dirname(path) == os.path.realpath(pnative.BUILD_DIR)
        assert os.path.basename(path).startswith(stem)
    for src in ("ecrhook.cc", "fortread.cc"):
        assert os.path.exists(os.path.join(pnative.HOST_SRC, src))
