"""Build, load and call the port's CUDA kernels.

The sources under ecrad_tpu_torch/csrc/ compile for sm_90a, one `nvcc`
per source, all started together, and link into a shared library with a
plain C interface, loaded with ctypes (no PyTorch headers: seconds to
build rather than minutes). The build happens at first use, into
ecrad_tpu_torch/_build/ (listed in .gitignore), under a name that hashes
the sources, so an edited kernel is rebuilt. Nothing here runs at import time.

Every C entry point launches on the stream it is given, returns
cudaGetLastError() as an int, and allocates nothing: the wrappers
allocate outputs and scratch with torch.empty.

The kernels of the McICA path (B1, B2, B3, B3', B4's SW form and the
cloud generator), of the SPARTACUS path (B6-B9) and the aerosol optics
(B12) are templates on their scalar type with a float and a double entry
point, the double one's name ending in `_f64`:
`launch(name, ..., dtype=)` picks the entry of the operands' dtype
(`scalar` checks it) and counts
`launch.<name>.f32` or `.f64` (hooks.count; ops/random_fields.py counts
the threefry kernel, which takes its dtype as a flag, the same way).
Kernel B11, float only, is launched with dtype=float32 so that it is
counted too (F32_FORMS).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
from typing import Optional

import torch

from ..utils import hooks

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# -fmad=false: no contraction of a*b+c into one FMA, so a kernel rounds
# like its plain version's separate tensor ops and the two agree to the
# order of summation. No --use_fast_math: the exact expf/logf are needed
# (an approximate exp biased clear-sky SW by ~1.2 W/m2 on the TPU).
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v", "-lineinfo"]

# C signatures: p = device pointer, i = int, u = unsigned 32-bit int,
# f = float, d = double; the stream is appended
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint32,
           "f": ctypes.c_float, "d": ctypes.c_double}
_SIGS = {
    "taumol_lw": "pppppipp",
    "taumol_sw": "pppppipp",
    "sw_adding": "pppppppppiiipppp",
    "lw_noscat": "pppppiiipp",
    "lw_adding": "ppppppiiippp",
    "mcica_sw_optics": "ppppppppppiiiiip",
    "mcica_lw_optics": "ppppppiiiip",
    "tc_sw_sweeps": "ppppppppppppiiiipppp",
    "tc_lw_sweeps": "ppppppppppiiiippp",
    "spartacus_sw_reftrans_3d": "pppppppppppppiiiiif",
    "spartacus_sw_reftrans_fallback": "ppppppppppiiiii",
    "spartacus_lw_reftrans_3d": "pppppppppppppppiiiiif",
    "spartacus_lw_reftrans_fallback": "ppppppppppppiiiiii",
    "spartacus_sw_adding": "ppppiiiiiiffffpppp",
    "spartacus_lw_adding": "pppiiiiiippp",
    "gather_sections": "pipipiiip",
    "threefry_fields": "piuuiiiipppp",
    "mcica_generator": "ppppppppp" "iiiiiii" "dddddd" "pp",
    "tc_sw_optics": "pppppppppp" "iiiiii" "pp",
    "aerosol_optics": "p" * 22 + "i" * 13,
}
#: the kernels with a double form: its entry point, name + "_f64", takes
#: the same arguments with double in place of float (its scalar
#: arguments too: "f" becomes "d")
F64_FORMS = ("taumol_lw", "taumol_sw", "sw_adding", "lw_noscat",
             "lw_adding", "mcica_sw_optics", "mcica_generator",
             "spartacus_sw_reftrans_3d", "spartacus_sw_reftrans_fallback",
             "spartacus_lw_reftrans_3d", "spartacus_lw_reftrans_fallback",
             "spartacus_sw_adding", "spartacus_lw_adding",
             "aerosol_optics")
_SIGS.update({name + "_f64": _SIGS[name].replace("f", "d")
              for name in F64_FORMS})
#: kernels with a float form only that are launched with dtype= all the
#: same, so that their launches are counted
F32_FORMS = ("tc_sw_optics",)
#: the scalar types of those kernels: entry point suffix and counter tag
_DTYPES = {torch.float32: ("", "f32"), torch.float64: ("_f64", "f64")}

# queries of a kernel's compiled resources (no stream): the leading int
# arguments, then an int[len(INFO_FIELDS)] that receives them
_INFO_SIGS = {"level_sweep_info": "ii",
              "level_sweep_info_f64": "ii",
              "taumol_lw_info": "",
              "taumol_lw_info_f64": "",
              "taumol_sw_info": "",
              "taumol_sw_info_f64": "",
              "mcica_optics_info": "i",
              "tc_sweeps_info": "iii",
              "spartacus_sw_adding_info": "i",
              "spartacus_sw_adding_info_f64": "i",
              "spartacus_sw_reftrans_info": "ii",
              "spartacus_sw_reftrans_info_f64": "ii",
              "spartacus_lw_reftrans_info": "ii",
              "spartacus_lw_reftrans_info_f64": "ii",
              "spartacus_lw_adding_info": "ii",
              "spartacus_lw_adding_info_f64": "ii",
              "gather_sections_info": "iiii",
              "threefry_fields_info": "i",
              "mcica_generator_info": "iii",
              "tc_sw_optics_info": "",
              "aerosol_optics_info": "i"}
INFO_FIELDS = ("registers", "local_bytes", "static_smem", "dynamic_smem",
               "threads", "blocks_per_sm", "sms")

_lib: Optional[ctypes.CDLL] = None
#: compiler report of the last build (registers, shared memory, spills)
build_log = ""


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (set CUDA_HOME)")


def build() -> str:
    """Compile csrc/*.cu into the shared library (if not built yet) and
    return its path. Raises with the compiler output on failure."""
    global build_log
    h = hashlib.sha256()
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"libecrad_kernels_{h.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        if not build_log and os.path.exists(lib + ".log"):
            with open(lib + ".log") as f:
                build_log = f.read()
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    objdir = f"{tmp}.objs"
    os.makedirs(objdir, exist_ok=True)
    nvcc = _nvcc()
    cus = [p for p in sources() if p.endswith(".cu")]
    objs = [os.path.join(objdir, os.path.basename(p) + ".o") for p in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cus, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [src for src, p in zip(cus, procs) if p.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        failed = ["link"] if res.returncode != 0 else []
    shutil.rmtree(objdir, ignore_errors=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{build_log}")
    with open(lib + ".log", "w") as f:
        f.write(build_log)
    os.replace(tmp, lib)
    return lib


def ptxas_report(log: Optional[str] = None) -> dict:
    """Each compiled function's (registers, stack frame, spill stores,
    spill loads) from the compiler's report of the build (`build_log`):
    {mangled name: dict}."""
    out, name = {}, None
    for line in (build_log if log is None else log).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, m.groups())))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, sig in _SIGS.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[s] for s in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name, sig in _INFO_SIGS.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[s] for s in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(t: torch.Tensor, dtype, shape, name: str) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def scalar(t: torch.Tensor, name: str) -> torch.dtype:
    """The dtype of t, a kernel's leading operand: raise unless t is a
    CUDA tensor of float32 or float64, the dtypes of the kernels with a
    double form (F64_FORMS). The call's other operands are then checked
    against it."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or float64, got "
                        f"{t.dtype}")
    return t.dtype


def tag(dtype: torch.dtype) -> str:
    """The counter tag of a kernel's scalar type: "f32" or "f64"."""
    return _DTYPES[dtype][1]


def launch(name: str, *args, dtype: Optional[torch.dtype] = None) -> None:
    """Call C entry point `name` on the current stream; raise if the
    launch was refused (cudaGetLastError() != 0). With `dtype`, `name` is
    one of F64_FORMS, or with float32 one of F32_FORMS: the entry point of
    that dtype is called and the launch counted as
    `launch.<name>.<f32|f64>`."""
    if dtype is not None:
        forms = (_DTYPES if name in F64_FORMS else (torch.float32,)
                 if name in F32_FORMS else ())
        if dtype not in forms:
            raise TypeError(f"{name} has no {dtype} form")
        kernel = name
        name += _DTYPES[dtype][0]
    fn = getattr(library(), name)
    sig = _SIGS[name]
    if len(args) != len(sig):
        raise TypeError(f"{name} takes {len(sig)} arguments")
    # a pointer argument may be None (NULL) where the kernel allows it
    conv = [(None if a is None else a.data_ptr()) if s == "p"
            else int(a) if s in "iu" else float(a)
            for s, a in zip(sig, args)]
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    # the counter's name is built only while the hooks count
    if dtype is not None and hooks.LHOOK:
        hooks.count(f"launch.{kernel}.{tag(dtype)}")


def kernel_info(name: str, *args: int) -> dict:
    """A kernel's registers, local memory (spills), shared memory and the
    blocks per SM its launch gets, from C entry point `name` (csrc/
    kernel_info.cuh)."""
    out = (ctypes.c_int * len(INFO_FIELDS))()
    err = getattr(library(), name)(*args, out)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return dict(zip(INFO_FIELDS, out))
