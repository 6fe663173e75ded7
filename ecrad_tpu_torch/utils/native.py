"""ctypes bindings for the port's native host cores (csrc/host/*.cc).

Port of ecrad_tpu/utils/native.py. Two shared libraries, built with g++
at first use into ecrad_tpu_torch/_build/ (listed in .gitignore), each
named by a hash of its source so that an edited source is rebuilt:
 - libecrhook: the Dr Hook-analogue profiler core (per-thread call
   stacks, wall/CPU self and total time, peak RSS, fatal-signal stack
   dump; reference drhook/drhook/drhook.c), csrc/host/ecrhook.cc.
 - libfortread: the big-endian Fortran sequential-unformatted reader
   (the data loader of the RRTMG coefficient files RADRRTM / RADSRTM;
   reference ifsrrtm/rrtm_kgb*.F90 READ path), csrc/host/fortread.cc.

Both are optional, as in the JAX package: without a compiler `hook_lib`
and `fort_lib` return None, and every consumer has a pure-Python path.
Both are host code: no tensor and no device is involved.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def _build_if_possible(stem: str, source: str,
                       libs=()) -> Optional[str]:
    """Compile csrc/host/<source> into _build/lib<stem>_<hash>.so unless
    it is there; None if the compiler is missing or fails."""
    src = os.path.join(HOST_SRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            CXX_FLAGS + list(libs)).encode()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src, *libs],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    # concurrent builds (test workers) each write their own file
    os.replace(tmp, path)
    return path


def _declare(lib, name, argtypes, restype=None):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = restype


_hook_lib = None
_hook_tried = False


def hook_lib() -> Optional[ctypes.CDLL]:
    """The profiler core (built on the first call), or None."""
    global _hook_lib, _hook_tried
    if _hook_tried:
        return _hook_lib
    _hook_tried = True
    path = _build_if_possible("ecrhook", "ecrhook.cc", ["-lpthread"])
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    _declare(lib, "ecr_hook_install_signals", [])
    _declare(lib, "ecr_hook_enter", [ctypes.c_char_p])
    _declare(lib, "ecr_hook_exit", [ctypes.c_char_p])
    _declare(lib, "ecr_hook_report", [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long),
        ctypes.c_int], ctypes.c_int)
    _declare(lib, "ecr_hook_reset", [])
    _declare(lib, "ecr_hook_stack_depth", [], ctypes.c_int)
    _hook_lib = lib
    return _hook_lib


_fort_lib = None
_fort_tried = False


def fort_lib() -> Optional[ctypes.CDLL]:
    """The Fortran record reader (built on the first call), or None."""
    global _fort_lib, _fort_tried
    if _fort_tried:
        return _fort_lib
    _fort_tried = True
    path = _build_if_possible("fortread", "fortread.cc")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    _declare(lib, "fort_open", [ctypes.c_char_p], ctypes.c_void_p)
    _declare(lib, "fort_close", [ctypes.c_void_p])
    _declare(lib, "fort_next_record_bytes", [ctypes.c_void_p],
             ctypes.c_long)
    _declare(lib, "fort_read_f64", [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long],
        ctypes.c_long)
    _declare(lib, "fort_skip", [ctypes.c_void_p], ctypes.c_int)
    _fort_lib = lib
    return _fort_lib


class FortranFile:
    """Sequential big-endian unformatted reader (native when available).

    Each record is [4-byte big-endian length][payload][the same length]
    (the framing of Fortran `READ` on a big-endian unformatted unit).
    `read_f64` returns the next record as float64 values; it raises
    EOFError past the last record and IOError on a bad frame."""

    def __init__(self, path: str):
        self.path = path
        self._lib = fort_lib()
        self._handle = None
        self._fp = None
        if self._lib is not None:
            self._handle = self._lib.fort_open(path.encode())
            if not self._handle:
                self._lib = None
        if self._lib is None:
            self._fp = open(path, "rb")

    def read_f64(self):
        """Read the next record as a float64 numpy array."""
        import numpy as np
        if self._lib is not None:
            nbytes = self._lib.fort_next_record_bytes(self._handle)
            if nbytes < 0:
                raise EOFError(self.path)
            n = nbytes // 8
            out = np.empty(n, np.float64)
            got = self._lib.fort_read_f64(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
            if got != n:
                raise IOError(f"short record in {self.path}")
            return out
        import struct
        hdr = self._fp.read(4)
        if len(hdr) < 4:
            raise EOFError(self.path)
        nbytes = struct.unpack(">i", hdr)[0]
        payload = self._fp.read(nbytes)
        trailer = struct.unpack(">i", self._fp.read(4))[0]
        if trailer != nbytes:
            raise IOError(f"bad record framing in {self.path}")
        return np.frombuffer(payload, ">f8").astype(np.float64)

    def close(self):
        if self._lib is not None and self._handle:
            self._lib.fort_close(self._handle)
            self._handle = None
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
